"""Adaptive (selective) mesh refinement with hanging-node constraints.

- selective refinement driven by per-element flags: flagged elements are
  split into 2^dim children, unflagged ones are copied to the fine level
  unchanged (``child_slot = -1``), giving a mixed-level mesh;
- flags from a per-element error indicator (absolute threshold or worst
  fraction), closed so that no element neighbours one 2+ levels finer;
- conformity across refinement boundaries through a constraint operator C
  per FE family: u_all = C @ u_free, where each hanging dof row
  interpolates the coarse neighbour's trace.  The conforming operator is
  C^T A C, computed on the device by the PtAP schedule of
  ``algebra/transfer.py``.

All construction is host-side numpy at set-up (static sparsity).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

from ..fe.basis import get_basis
from ..fe.geom import GEOMS
from .mesh import BoundaryFaces, Mesh
from .refine import _child_face_table, _child_phi, _face_planes


def _elem_level(mesh: Mesh) -> np.ndarray:
    if getattr(mesh, "elem_level", None) is not None:
        return mesh.elem_level
    return np.zeros(mesh.n_elems, np.int32)


def close_flags(mesh: Mesh, flags: np.ndarray) -> np.ndarray:
    """Enforce 1-irregularity: if refining would make an element 2+ levels
    finer than any node-sharing neighbor, the neighbor must refine too.
    Node-sharing (not just face-sharing) adjacency is used so coarse/fine
    neighbors across existing refinement boundaries — whose faces do not
    match key-for-key — are seen; this is conservative (vertex-adjacent
    irregularity also forces refinement). Iterates to a fixed point."""
    lev = _elem_level(mesh)
    # Node-sharing adjacency without materializing element pairs (the pair
    # set is O(n_elems * valence^2)): per node, the max post-refinement
    # level of incident elements; per element, the max over its nodes.
    # An element's own tgt never exceeds tgt+1, so including self in the
    # node max is harmless.
    n_nodes = int(mesh.conn.max()) + 1
    flat = mesh.conn.ravel()
    flags = flags.astype(bool).copy()
    while True:
        tgt = lev + flags                      # level after refinement
        node_max = np.full(n_nodes, -(2 ** 30), np.int64)
        np.maximum.at(node_max, flat,
                      np.repeat(tgt, mesh.conn.shape[1]))
        nbr_max = node_max[mesh.conn].max(axis=1)
        add = ((nbr_max - tgt) > 1) & ~flags
        if not np.any(add):
            return flags
        flags |= add


def flag_by_error(error: np.ndarray, threshold: float,
                  mode: str = "absolute") -> np.ndarray:
    """Per-element refinement flags from an error indicator: error >
    threshold.  With mode="fraction", threshold is a quantile: refine the
    worst fraction."""
    if mode == "fraction":
        k = max(1, int(np.ceil(threshold * len(error))))
        cut = np.partition(error, -k)[-k]
        return error >= cut
    return error > threshold


def refine_selective(mesh: Mesh, flags: np.ndarray) -> Mesh:
    """Refine flagged elements (after :func:`close_flags`); copy the rest.
    Returns a mixed-level fine mesh with lineage (parent_elem; child_slot
    = -1 for copied elements)."""
    flags = close_flags(mesh, np.asarray(flags, bool))
    g = GEOMS[mesh.geom]
    nk = g.children.shape[0]
    CP = _child_phi(mesh.geom)
    lev = _elem_level(mesh)

    ref_ids = np.where(flags)[0]
    cop_ids = np.where(~flags)[0]
    kid_pos = np.einsum("kab,ebd->ekad", CP, mesh.coords[mesh.conn[ref_ids]])
    cop_pos = mesh.coords[mesh.conn[cop_ids]]            # (nc, n_bq, dim)
    allpos = np.concatenate([kid_pos.reshape(-1, mesh.dim),
                             cop_pos.reshape(-1, mesh.dim)])
    scale = max(float(np.abs(mesh.coords).max()), 1.0)
    keys = np.rint(allpos / (1e-9 * scale)).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    first = np.full(len(uniq), len(keys), np.int64)
    np.minimum.at(first, inv, np.arange(len(keys)))
    coords = allpos[first]
    n_ref_rows = len(ref_ids) * nk
    conn = inv[: n_ref_rows * g.n_nodes_bq].reshape(n_ref_rows, g.n_nodes_bq)
    conn_cop = inv[n_ref_rows * g.n_nodes_bq:].reshape(len(cop_ids),
                                                       g.n_nodes_bq)
    conn_all = np.concatenate([conn, conn_cop]).astype(np.int32)

    parent = np.concatenate([np.repeat(ref_ids, nk), cop_ids]).astype(np.int32)
    slot = np.concatenate([np.tile(np.arange(nk, dtype=np.int32), len(ref_ids)),
                           np.full(len(cop_ids), -1, np.int32)])
    group = np.concatenate([np.repeat(mesh.elem_group[ref_ids], nk),
                            mesh.elem_group[cop_ids]])
    mat = None
    if mesh.elem_material is not None:
        mat = np.concatenate([np.repeat(mesh.elem_material[ref_ids], nk),
                              mesh.elem_material[cop_ids]]).astype(np.int32)
    level = np.concatenate([np.repeat(lev[ref_ids] + 1, nk), lev[cop_ids]])

    fine = Mesh(dim=mesh.dim, geom=mesh.geom, coords=coords, conn=conn_all,
                elem_group=group.astype(np.int32), parent_elem=parent,
                child_slot=slot, elem_level=level.astype(np.int32),
                elem_material=mat)
    _propagate_boundary(mesh, fine, flags, nk, ref_ids, cop_ids)
    return fine


def _propagate_boundary(coarse: Mesh, fine: Mesh, flags, nk, ref_ids,
                        cop_ids) -> None:
    g = GEOMS[coarse.geom]
    table = _child_face_table(coarse.geom)
    # fine element id of child k of coarse e / of a copied coarse e
    ref_pos = {int(e): i for i, e in enumerate(ref_ids)}
    cop_pos = {int(e): i for i, e in enumerate(cop_ids)}
    n_ref_rows = len(ref_ids) * nk
    by_geom: Dict[str, list] = {}
    for bf in coarse.boundary.values():
        for r in range(len(bf.elem)):
            e, ifc, grp = int(bf.elem[r]), int(bf.iface[r]), int(bf.group[r])
            if flags[e]:
                for (k, jf) in table[ifc]:
                    fe = ref_pos[e] * nk + k
                    fg, f_bq = g.faces[jf]
                    by_geom.setdefault(fg, []).append(
                        (fe, jf, grp, fine.conn[fe][np.asarray(f_bq)]))
            else:
                fe = n_ref_rows + cop_pos[e]
                fg, f_bq = g.faces[ifc]
                by_geom.setdefault(fg, []).append(
                    (fe, ifc, grp, fine.conn[fe][np.asarray(f_bq)]))
    fine.boundary = {}
    for fg, items in by_geom.items():
        items.sort(key=lambda t: (t[0], t[1]))
        fine.boundary[fg] = BoundaryFaces(
            face_geom=fg,
            elem=np.array([t[0] for t in items], np.int32),
            iface=np.array([t[1] for t in items], np.int32),
            group=np.array([t[2] for t in items], np.int32),
            conn=np.stack([t[3] for t in items]).astype(np.int32))


# ---------------------------------------------------------------------------
# Hanging-node constraints
# ---------------------------------------------------------------------------

def _inverse_map(geom: str, elem_coords: np.ndarray, pts: np.ndarray,
                 iters: int = 8) -> np.ndarray:
    """Newton inverse of the biquadratic geometric map for a batch of points
    (host side)."""
    b = get_basis(geom, "biquadratic")
    g = GEOMS[geom]
    xi = np.repeat(g.ref_nodes.mean(axis=0)[None, :], len(pts), axis=0)
    for _ in range(iters):
        phi = np.asarray(b.eval(xi))                     # (m, n_bq)
        dphi = np.asarray(b.eval_grad(xi))               # (m, n_bq, dim)
        x = phi @ elem_coords                            # (m, dim)
        J = np.einsum("mnd,nx->mxd", dphi, elem_coords)  # (m, dim(x), dim(xi))
        r = pts - x
        try:
            dxi = np.linalg.solve(J, r[..., None])[..., 0]
        except np.linalg.LinAlgError:
            break
        xi = xi + dxi
    return xi


def hanging_constraints(mesh: Mesh, family: str):
    """Constraint operator C (n_dofs x n_free) for one FE family plus the
    free-dof index array: identity on free dofs; each hanging dof (a
    fine-side dof on a refinement boundary that the coarse side does not
    carry) is the coarse element's trace interpolation of its masters.
    Returns (C, free_idx)."""
    g = GEOMS[mesh.geom]
    dm = mesh.dofmap(family)
    n = dm.n_dofs
    if family in ("disc_constant", "disc_linear"):
        return sp.identity(n, format="csr"), np.arange(n)
    lev = _elem_level(mesh)
    fam_local = g.family_nodes[family]

    # faces whose sorted-corner key appears once per side: an element face is
    # "unmatched" if no other element shares the identical full face.
    keys, elems, ifaces = [], [], []
    for fi, (fg, f_bq) in enumerate(g.faces):
        nvf = GEOMS[fg].n_verts
        keys.append(np.sort(mesh.conn[:, np.asarray(f_bq[:nvf])], axis=1))
        elems.append(np.arange(mesh.n_elems))
        ifaces.append(np.full(mesh.n_elems, fi))
    keys = np.concatenate(keys)
    elems = np.concatenate(elems)
    ifaces = np.concatenate(ifaces)
    uq, inv_k, cnt = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    unmatched = cnt[inv_k] == 1

    # boundary faces (domain boundary) are unmatched but not hanging
    bnd_keys = set()
    for bf in mesh.boundary.values():
        nvf = GEOMS[bf.face_geom].n_verts
        for row in bf.conn:
            bnd_keys.add(tuple(sorted(int(v) for v in row[:nvf])))

    # node -> elements adjacency for candidate search
    node_elems: Dict[int, List[int]] = {}
    for e in range(mesh.n_elems):
        for v in mesh.conn[e]:
            node_elems.setdefault(int(v), []).append(e)

    fam_basis = get_basis(mesh.geom, family)
    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    hanging: Dict[int, List[Tuple[int, float]]] = {}

    planes = _ref_face_planes(mesh.geom)
    for idx in np.where(unmatched)[0]:
        e, fi = int(elems[idx]), int(ifaces[idx])
        key = tuple(int(v) for v in keys[idx])
        if key in bnd_keys:
            continue
        # only the COARSE side of a refinement boundary defines constraints:
        # the fine side has smaller faces (its own keys don't match either,
        # but its level is higher than the neighbor's)
        fg, f_bq = g.faces[fi]
        face_nodes = mesh.conn[e][np.asarray(f_bq)]
        # candidate fine nodes: nodes of elements adjacent to this face's
        # nodes, at a finer level than e
        cand = set()
        for v in face_nodes:
            for e2 in node_elems[int(v)]:
                if lev[e2] > lev[e]:
                    cand.update(int(u) for u in mesh.conn[e2])
        # exclude only the nodes that carry a dof of THIS family on the
        # coarse element: e.g. for the linear family the coarse element's
        # edge-midpoint nodes carry no dof, but the fine side's corner
        # there does — it hangs
        cand -= set(int(v) for v in mesh.conn[e][fam_local])
        if not cand:
            continue
        cand = sorted(cand)
        xi = _inverse_map(mesh.geom, mesh.coords[mesh.conn[e]],
                          mesh.coords[cand])
        nrm, d = planes[fi]
        on_face = np.abs(xi @ nrm - d) < 1e-8
        inside = _inside_ref(mesh.geom, xi, tol=1e-8)
        sel = on_face & inside
        if not np.any(sel):
            continue
        W = np.asarray(fam_basis.eval(xi[sel]))          # (m, nd_fam)
        master_dofs = dm.node_to_dof[mesh.conn[e][fam_local]]
        for j, node in enumerate(np.asarray(cand)[sel]):
            hd = int(dm.node_to_dof[node])
            if hd < 0 or hd in hanging:
                continue
            ws = [(int(md), float(w)) for md, w in zip(master_dofs, W[j])
                  if md >= 0 and abs(w) > 1e-12]
            hanging[hd] = ws

    # resolve constraint chains: a master may itself hang on a third, coarser
    # face (3-D edge/corner configurations) — substitute until all masters
    # are free (terminates: each substitution moves to a coarser level)
    for _ in range(32):
        dirty = False
        for hd, ws in list(hanging.items()):
            if any(md in hanging for md, _ in ws):
                out: Dict[int, float] = {}
                for md, w in ws:
                    if md in hanging:
                        for md2, w2 in hanging[md]:
                            out[md2] = out.get(md2, 0.0) + w * w2
                    else:
                        out[md] = out.get(md, 0.0) + w
                hanging[hd] = [(m, w) for m, w in out.items() if abs(w) > 1e-12]
                dirty = True
        if not dirty:
            break
    else:
        raise RuntimeError("hanging-constraint chain did not resolve")

    free = np.setdiff1d(np.arange(n), np.fromiter(hanging.keys(), int,
                                                  len(hanging)))
    new_id = np.full(n, -1, np.int64)
    new_id[free] = np.arange(len(free))
    rows = list(free)
    cols = list(new_id[free])
    vals = [1.0] * len(free)
    for hd, ws in hanging.items():
        for md, w in ws:
            rows.append(hd)
            cols.append(int(new_id[md]))
            vals.append(w)
    C = sp.csr_matrix((vals, (rows, cols)), shape=(n, len(free)))
    C.sum_duplicates()
    return C, free


@functools.lru_cache(maxsize=None)
def _ref_face_planes(geom: str):
    return _face_planes(geom)


def _inside_ref(geom: str, xi: np.ndarray, tol: float = 1e-8) -> np.ndarray:
    g = GEOMS[geom]
    if geom in ("quad", "hex", "edge"):
        return np.all(np.abs(xi) <= 1 + tol, axis=1)
    if geom == "tri":
        return ((xi[:, 0] >= -tol) & (xi[:, 1] >= -tol)
                & (xi.sum(axis=1) <= 1 + tol))
    if geom == "tet":
        return np.all(xi >= -tol, axis=1) & (xi.sum(axis=1) <= 1 + tol)
    if geom == "wedge":
        return ((xi[:, 0] >= -tol) & (xi[:, 1] >= -tol)
                & (xi[:, 0] + xi[:, 1] <= 1 + tol)
                & (np.abs(xi[:, 2]) <= 1 + tol))
    raise ValueError(geom)
