"""Midpoint mesh refinement (uniform).

Equivalent of the reference's ``MeshRefinement::RefineMesh``
(MeshRefinement.hpp:40, .cpp:188-624): each element is split into 2^dim
children using the per-geometry embedding tables (geom.py ``children``),
with new nodes de-duplicated across neighboring parents.  Node positions are
evaluated through the parent's biquadratic geometric map, so curved
boundaries refine consistently.

Also provides the per-family local prolongation blocks used to build the
coarse->fine interpolation matrices (reference fe_prolongation_matrices.hpp:22).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

from ..fe.basis import get_basis
from ..fe.geom import GEOMS
from .mesh import BoundaryFaces, Mesh, build_boundary_faces


@functools.lru_cache(maxsize=None)
def _child_phi(geom: str) -> np.ndarray:
    """(n_child, n_bq, n_bq): biquadratic basis of the parent evaluated at each
    child's biquadratic node ref positions — maps parent node coords to child
    node coords."""
    g = GEOMS[geom]
    b = get_basis(geom, "biquadratic")
    kids = g.children                                   # (nk, n_bq, dim)
    return np.asarray(b.eval(kids.reshape(-1, g.dim))).reshape(
        kids.shape[0], g.n_nodes_bq, g.n_nodes_bq)


@functools.lru_cache(maxsize=None)
def _face_planes(geom: str) -> List[Tuple[np.ndarray, float]]:
    """Reference-coordinate plane (normal, offset) per face: n·x = d on the
    face; used to locate child faces lying on a parent face."""
    g = GEOMS[geom]
    planes = []
    for fg, f_bq in g.faces:
        nvf = GEOMS[fg].n_verts
        pts = g.ref_nodes[np.asarray(f_bq[:nvf])]
        ctr = pts.mean(axis=0)
        if g.dim == 1:
            n = np.ones(1)
        else:
            # normal = null-space of centered points
            _, _, vt = np.linalg.svd(pts - ctr)
            n = vt[-1]
        planes.append((n, float(n @ ctr)))
    return planes


@functools.lru_cache(maxsize=None)
def _child_face_table(geom: str) -> Dict[int, List[Tuple[int, int]]]:
    """parent face -> [(child index, child face index)] of the child faces
    covering it."""
    g = GEOMS[geom]
    planes = _face_planes(geom)
    out: Dict[int, List[Tuple[int, int]]] = {i: [] for i in range(len(g.faces))}
    for ip, (n, d) in enumerate(planes):
        for k in range(g.children.shape[0]):
            kid_nodes = g.children[k]                   # (n_bq, dim) in parent frame
            for jf, (fg, f_bq) in enumerate(g.faces):
                nvf = GEOMS[fg].n_verts
                pts = kid_nodes[np.asarray(f_bq[:nvf])]
                if np.allclose(pts @ n, d, atol=1e-9):
                    out[ip].append((k, jf))
    return out


def refine(mesh: Mesh) -> Mesh:
    """Uniformly refine a mesh level; returns the fine mesh with lineage."""
    g = GEOMS[mesh.geom]
    nk = g.children.shape[0]
    CP = _child_phi(mesh.geom)                          # (nk, n_bq, n_bq)
    parent_coords = mesh.coords[mesh.conn]              # (ne, n_bq, dim)
    # fine node positions: (ne, nk, n_bq, dim)
    kid_pos = np.einsum("kab,ebd->ekad", CP, parent_coords)
    scale = max(float(np.abs(mesh.coords).max()), 1.0)
    keys = np.rint(kid_pos / (1e-9 * scale)).astype(np.int64)
    flat = keys.reshape(-1, mesh.dim)
    uniq_keys, inv = np.unique(flat, axis=0, return_inverse=True)
    conn = inv.reshape(-1, g.n_nodes_bq).astype(np.int32)
    # representative coordinates: first occurrence of each unique key
    first_idx = np.full(len(uniq_keys), flat.shape[0], np.int64)
    np.minimum.at(first_idx, inv, np.arange(flat.shape[0]))
    coords = kid_pos.reshape(-1, mesh.dim)[first_idx]

    parent_elem = np.repeat(np.arange(mesh.n_elems, dtype=np.int32), nk)
    child_slot = np.tile(np.arange(nk, dtype=np.int32), mesh.n_elems)
    fine = Mesh(dim=mesh.dim, geom=mesh.geom, coords=coords, conn=conn,
                elem_group=np.repeat(mesh.elem_group, nk),
                parent_elem=parent_elem, child_slot=child_slot,
                elem_material=(np.repeat(mesh.elem_material, nk)
                               if mesh.elem_material is not None else None))
    _refine_boundary(mesh, fine, nk)
    return fine


def _refine_boundary(coarse: Mesh, fine: Mesh, nk: int) -> None:
    """Propagate boundary faces (with group labels) to the fine mesh."""
    g = GEOMS[coarse.geom]
    table = _child_face_table(coarse.geom)
    by_geom: Dict[str, list] = {}
    for bf in coarse.boundary.values():
        for r in range(len(bf.elem)):
            e, ifc, grp = int(bf.elem[r]), int(bf.iface[r]), int(bf.group[r])
            for (k, jf) in table[ifc]:
                fe = e * nk + k
                fg, f_bq = g.faces[jf]
                conn = fine.conn[fe][np.asarray(f_bq)]
                by_geom.setdefault(fg, []).append((fe, jf, grp, conn))
    fine.boundary = {}
    for fg, items in by_geom.items():
        items.sort(key=lambda t: (t[0], t[1]))
        fine.boundary[fg] = BoundaryFaces(
            face_geom=fg,
            elem=np.array([t[0] for t in items], np.int32),
            iface=np.array([t[1] for t in items], np.int32),
            group=np.array([t[2] for t in items], np.int32),
            conn=np.stack([t[3] for t in items]).astype(np.int32),
        )


@functools.lru_cache(maxsize=None)
def local_prolongation(geom: str, family: str) -> np.ndarray:
    """(n_child, nd_fine, nd_coarse) per-child interpolation blocks:
    fine dof values of child k = block[k] @ coarse element dof values.

    Lagrange: rows = coarse basis at the fine node's position in the parent.
    disc_constant: identity injection.  disc_linear: affine change of frame
    of the {1, xi} coefficient basis."""
    g = GEOMS[geom]
    kids = g.children
    nk = kids.shape[0]
    if family == "disc_constant":
        return np.ones((nk, 1, 1))
    if family == "disc_linear":
        out = np.zeros((nk, 1 + g.dim, 1 + g.dim))
        lin = get_basis(geom, "linear")
        for k in range(nk):
            corners = kids[k, :g.n_verts]               # parent-frame positions
            # affine map: xi_parent = A xi_child + b; fit from corner pairs
            Xc = np.hstack([g.ref_nodes[:g.n_verts][:, :], np.ones((g.n_verts, 1))])
            sol, *_ = np.linalg.lstsq(Xc, corners, rcond=None)   # (dim+1, dim)
            A = sol[:-1].T                               # (dim, dim)
            b = sol[-1]
            # u(xi_p) = c0 + c . xi_p = (c0 + c.b) + (A^T c) . xi_c
            out[k, 0, 0] = 1.0
            out[k, 0, 1:] = b
            out[k, 1:, 1:] = A.T
        return out
    bas = get_basis(geom, family)
    fam_nodes = g.family_nodes[family]
    out = np.zeros((nk, len(fam_nodes), len(fam_nodes)))
    for k in range(nk):
        fine_pos = kids[k, fam_nodes]                    # (nd, dim) parent frame
        out[k] = np.asarray(bas.eval(fine_pos))          # (nd_fine, nd_coarse)
    return out
