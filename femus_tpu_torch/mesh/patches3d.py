"""3-D (hex) patch-coherent refinement — the volumetric companion of
mesh/patches.py (see its docstring for the design rationale).  The port's
own copy of the JAX package's module (host numpy; the plans equal its
plans).

A coarse hex mesh refined L times is a set of (2^L)^3-element lattice
patches glued along coarse FACES (quad lattices, 8 possible relative
orientations = the dihedral group D4), coarse EDGES (arbitrary valence) and
coarse VERTICES.  Node numbering produced by :func:`refine_patched_hex`
(biquadratic family):

- patch-interior nodes: position-major / patch-minor
  ``id = (((i-1)*E + (j-1))*E + (k-1)) * P + p``, E = H-2;
- coarse-face interior nodes in each face's CANONICAL frame:
  ``id = n_int + ((cu-1)*E + (cv-1)) * n_faces + f``;
- coarse-edge interior nodes: ``id = ... + t * n_edges + e`` (t from the
  edge's lower-id endpoint);
- coarse-vertex nodes last.

Canonical face frame: origin = the face's smallest corner-vertex id; the
canonical u-axis points to the smaller of the origin's two in-face
neighbours.  Both sides of a face agree on this frame, so face dofs are
stored once and each patch side carries a D4 transform index.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..fe.geom import GEOMS
from .mesh import BoundaryFaces, Mesh
from .refine import refine, _child_phi

# hex corner lattice positions (unit scale; multiply by M = H-1)
C8 = np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
               (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int64)
# 12 edges as corner pairs (bottom ring, top ring, verticals)
E12 = [(0, 1), (1, 2), (2, 3), (3, 0),
       (4, 5), (5, 6), (6, 7), (7, 4),
       (0, 4), (1, 5), (2, 6), (3, 7)]
# 6 faces as corner quads (from GEOMS['hex'].faces traversal order)
F6 = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
      (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7)]

# D4 transforms sigma_t: (u, v) -> (cu, cv) over [0, M]^2, encoded as
# (axis_of_cu, mirror_cu, mirror_cv); axis_of_cv = 1 - axis_of_cu
D4 = [(au, mu, mv) for au in (0, 1) for mu in (0, 1) for mv in (0, 1)]


def d4_apply(t: int, u, v, M):
    au, mu, mv = D4[t]
    a = u if au == 0 else v
    b = v if au == 0 else u
    cu = (M - a) if mu else a
    cv = (M - b) if mv else b
    return cu, cv


def d4_inverse(t: int) -> int:
    """Index of sigma_t^{-1}."""
    au, mu, mv = D4[t]
    if au == 0:
        return D4.index((0, mu, mv))
    # swap case: inverse swaps back with mirrors exchanged
    return D4.index((1, mv, mu))


@dataclasses.dataclass
class PatchPlan3D:
    levels: int
    H: int
    P: int
    E: int
    n_int: int
    n_faces: int
    n_edges: int
    n_verts: int
    elem_patch: np.ndarray          # (ne,)
    elem_node_lat: np.ndarray       # (ne, 27, 3)
    patch_faces: np.ndarray         # (P, 6) face id per local face
    patch_face_tf: np.ndarray       # (P, 6) D4 transform patch->canonical
    patch_edges: np.ndarray         # (P, 12)
    patch_edge_flip: np.ndarray     # (P, 12) bool
    patch_verts: np.ndarray         # (P, 8) vertex id per corner
    face_sides: np.ndarray          # (n_faces, 2, 3) (patch, local face, tf)
    edge_sides: np.ndarray          # (n_edges, max_ev, 3) (patch, le, flip)
    vert_sides: np.ndarray          # (n_verts, max_vv, 2) (patch, corner)

    # local-face frames in lattice axes: origin corner index, u axis, v axis
    def face_frame(self, f: int, M: int):
        q = F6[f]
        O = C8[q[0]] * M
        U = C8[q[1]] - C8[q[0]]
        V = C8[q[3]] - C8[q[0]]
        return O, U, V


def _face_uv(O, U, V, pos):
    """Face-local (u, v) of lattice points on the face plane."""
    d = pos - O
    u = (d * U).sum(axis=-1)
    v = (d * V).sum(axis=-1)
    return u, v


def refine_patched_hex(coarse: Mesh, levels: int) -> Tuple[Mesh, PatchPlan3D]:
    assert coarse.geom == "hex", "3-D patch lattices: hex geometry"
    assert levels >= 1
    g = GEOMS["hex"]
    CP = _child_phi("hex")
    n_bq = g.n_nodes_bq                                  # 27

    mesh = coarse
    patch = np.arange(coarse.n_elems, dtype=np.int64)
    enp = np.broadcast_to(g.ref_nodes, (coarse.n_elems, n_bq, 3)).copy()
    for _ in range(levels):
        mesh = refine(mesh)
        patch = patch[mesh.parent_elem]
        enp = np.einsum("eab,ebd->ead", CP[mesh.child_slot],
                        enp[mesh.parent_elem])
    m = 2 ** levels
    H = 2 * m + 1
    M = H - 1
    P = coarse.n_elems
    E = H - 2

    lat_f = (enp + 1.0) * m
    lat = np.rint(lat_f).astype(np.int64)
    assert np.abs(lat_f - lat).max() < 1e-6
    nodes = mesh.conn.astype(np.int64)
    nn = mesh.n_nodes

    # representative (patch, i, j, k) per node
    rep = np.full((nn, 4), -1, np.int64)
    flat = nodes.ravel()
    order = np.argsort(flat, kind="stable")
    first = np.ones(len(order), bool)
    first[1:] = flat[order][1:] != flat[order][:-1]
    sel = order[first]
    rep[flat[sel], 0] = np.repeat(patch, n_bq)[sel]
    for d in range(3):
        rep[flat[sel], 1 + d] = lat[:, :, d].ravel()[sel]
    assert (rep[:, 0] >= 0).all()

    pos = rep[:, 1:]
    nb = ((pos == 0) | (pos == M)).sum(axis=1)           # boundary coords
    is_vert = nb == 3
    is_edge = nb == 2
    is_face = nb == 1
    is_int = nb == 0

    # ---- coarse topology straight from the coarse mesh -----------------
    cconn = coarse.conn[:, :8].astype(np.int64)          # corner node ids
    uniq_v, vid_of_cnode = np.unique(cconn, return_inverse=True)
    patch_verts = vid_of_cnode.reshape(P, 8)
    n_verts = len(uniq_v)

    ekeys = np.stack([np.minimum(patch_verts[:, [a for a, b in E12]],
                                 patch_verts[:, [b for a, b in E12]]),
                      np.maximum(patch_verts[:, [a for a, b in E12]],
                                 patch_verts[:, [b for a, b in E12]])],
                     axis=2)                             # (P, 12, 2)
    ekflat = ekeys[:, :, 0] * (n_verts + 1) + ekeys[:, :, 1]
    uniq_e, patch_edges = np.unique(ekflat, return_inverse=True)
    patch_edges = patch_edges.reshape(P, 12)
    n_edges = len(uniq_e)
    # flip: edge runs lower->higher vertex id; local edge runs a->b
    va = patch_verts[:, [a for a, b in E12]]
    vb = patch_verts[:, [b for a, b in E12]]
    patch_edge_flip = va > vb

    fquads = patch_verts[:, np.array(F6)]                # (P, 6, 4)
    fkeys = np.sort(fquads, axis=2)
    fkflat = ((fkeys[:, :, 0] * (n_verts + 1) + fkeys[:, :, 1])
              * (n_verts + 1) + fkeys[:, :, 2]) * (n_verts + 1) + fkeys[:, :, 3]
    uniq_f, patch_faces = np.unique(fkflat, return_inverse=True)
    patch_faces = patch_faces.reshape(P, 6)
    n_faces = len(uniq_f)

    # canonical frame per face + per-(patch, local face) D4 transform
    patch_face_tf = np.zeros((P, 6), np.int64)
    for p in range(P):
        for f in range(6):
            quad = fquads[p, f]                          # cyclic traversal
            o = int(np.argmin(quad))
            nxt, prv = quad[(o + 1) % 4], quad[(o - 1) % 4]
            # canonical u-axis toward the smaller neighbour
            u_to_next = nxt < prv
            # patch-local face frame: u = c0->c1, v = c0->c3; corner o sits
            # at (u,v) = uvpos[o]
            uvpos = [(0, 0), (1, 0), (1, 1), (0, 1)]
            ou, ov = uvpos[o]
            # direction (in patch uv) toward quad[(o+1)%4] and quad[(o-1)%4]
            nu, nv = uvpos[(o + 1) % 4]
            pu, pv = uvpos[(o - 1) % 4]
            tu = (nu - ou, nv - ov) if u_to_next else (pu - ou, pv - ov)
            tv = (pu - ou, pv - ov) if u_to_next else (nu - ou, nv - ov)
            # sigma: cu = coordinate along tu measured from origin corner
            # cu = tu . ((u,v) - (ou,ov)*M)  -> axis = nonzero component
            au = 0 if tu[0] != 0 else 1
            mu = 1 if (tu[au] < 0 or (ou, ov)[au] == 1) else 0
            av = 0 if tv[0] != 0 else 1
            mv = 1 if (tv[av] < 0 or (ou, ov)[av] == 1) else 0
            assert av == 1 - au
            patch_face_tf[p, f] = D4.index((au, mu, mv))

    # face/edge/vert side lists
    face_sides = np.full((n_faces, 2, 3), -1, np.int64)
    for p in range(P):
        for f in range(6):
            fid = patch_faces[p, f]
            s = 0 if face_sides[fid, 0, 0] < 0 else 1
            face_sides[fid, s] = (p, f, patch_face_tf[p, f])
    ecount = np.zeros(n_edges, np.int64)
    np.add.at(ecount, patch_edges.ravel(), 1)
    max_ev = int(ecount.max())
    edge_sides = np.full((n_edges, max_ev, 3), -1, np.int64)
    efill = np.zeros(n_edges, np.int64)
    for p in range(P):
        for le in range(12):
            e = patch_edges[p, le]
            edge_sides[e, efill[e]] = (p, le, int(patch_edge_flip[p, le]))
            efill[e] += 1
    vcount = np.zeros(n_verts, np.int64)
    np.add.at(vcount, patch_verts.ravel(), 1)
    max_vv = int(vcount.max())
    vert_sides = np.full((n_verts, max_vv, 2), -1, np.int64)
    vfill = np.zeros(n_verts, np.int64)
    for p in range(P):
        for c in range(8):
            v = patch_verts[p, c]
            vert_sides[v, vfill[v]] = (p, c)
            vfill[v] += 1

    plan = PatchPlan3D(levels=levels, H=H, P=P, E=E, n_int=P * E ** 3,
                       n_faces=n_faces, n_edges=n_edges, n_verts=n_verts,
                       elem_patch=patch, elem_node_lat=lat,
                       patch_faces=patch_faces, patch_face_tf=patch_face_tf,
                       patch_edges=patch_edges,
                       patch_edge_flip=patch_edge_flip,
                       patch_verts=patch_verts, face_sides=face_sides,
                       edge_sides=edge_sides, vert_sides=vert_sides)

    # ---- node numbering -------------------------------------------------
    new_id = np.full(nn, -1, np.int64)
    n_int = plan.n_int
    si = np.nonzero(is_int)[0]
    pi = rep[si]
    new_id[si] = (((pi[:, 1] - 1) * E + (pi[:, 2] - 1)) * E
                  + (pi[:, 3] - 1)) * P + pi[:, 0]

    sf = np.nonzero(is_face)[0]
    if len(sf):
        pf = rep[sf]
        # which local face: the boundary coordinate
        fpos = pf[:, 1:]
        # face index from (axis at boundary, low/high)
        axb = np.argmax((fpos == 0) | (fpos == M), axis=1)
        high = fpos[np.arange(len(sf)), axb] == M
        # map (axis, side) -> local face from F6 geometry: find face whose
        # plane matches
        loc_face = np.empty(len(sf), np.int64)
        for f in range(6):
            O, U, V = plan.face_frame(f, M)
            Wn = np.cross(U, V)
            ax = int(np.argmax(np.abs(Wn)))
            side_high = O[ax] == M
            selm = (axb == ax) & (high == side_high)
            loc_face[selm] = f
        cu = np.empty(len(sf), np.int64)
        cv = np.empty(len(sf), np.int64)
        for f in range(6):
            selm = loc_face == f
            if not selm.any():
                continue
            O, U, V = plan.face_frame(f, M)
            u, v = _face_uv(O, U, V, fpos[selm])
            tfi = patch_face_tf[pf[selm, 0], f]
            cuu = np.empty(selm.sum(), np.int64)
            cvv = np.empty(selm.sum(), np.int64)
            for t in range(8):
                tsel = tfi == t
                if tsel.any():
                    a, b = d4_apply(t, u[tsel], v[tsel], M)
                    cuu[tsel] = a
                    cvv[tsel] = b
            cu[selm] = cuu
            cv[selm] = cvv
        fid = patch_faces[pf[:, 0], loc_face]
        new_id[sf] = n_int + ((cu - 1) * E + (cv - 1)) * n_faces + fid

    se = np.nonzero(is_edge)[0]
    if len(se):
        pe = rep[se]
        epos = pe[:, 1:]
        # free axis = the non-boundary coordinate
        free = np.argmin((epos == 0) | (epos == M), axis=1)
        t = epos[np.arange(len(se)), free]
        # local edge: match endpoint corner pair
        le = np.empty(len(se), np.int64)
        tt = np.empty(len(se), np.int64)
        for li, (a, b) in enumerate(E12):
            A, B = C8[a] * M, C8[b] * M
            d = B - A
            ax = int(np.argmax(np.abs(d)))
            on = (free == ax)
            for dd in range(3):
                if dd != ax:
                    on &= epos[:, dd] == A[dd]
            le[on] = li
            # param from corner a toward b
            tt[on] = np.where(d[ax] > 0, epos[on, ax], M - epos[on, ax])
        eid = patch_edges[pe[:, 0], le]
        fl = patch_edge_flip[pe[:, 0], le]
        tloc = np.where(fl, M - tt, tt)                   # from lower vertex
        n_face_dofs = E * E * n_faces
        new_id[se] = n_int + n_face_dofs + (tloc - 1) * n_edges + eid

    sv = np.nonzero(is_vert)[0]
    if len(sv):
        pv = rep[sv]
        vpos = pv[:, 1:]
        corner = np.zeros(len(sv), np.int64)
        for c in range(8):
            cc = C8[c] * M
            selm = (vpos == cc).all(axis=1)
            corner[selm] = c
        vids = patch_verts[pv[:, 0], corner]
        new_id[sv] = n_int + E * E * n_faces + E * n_edges + vids

    assert (new_id >= 0).all()
    assert len(np.unique(new_id)) == nn, "numbering collision"

    inv = np.empty(nn, np.int64)
    inv[new_id] = np.arange(nn)
    coords = mesh.coords[inv]
    conn = new_id[mesh.conn].astype(np.int32)
    out = Mesh(dim=mesh.dim, geom=mesh.geom, coords=coords, conn=conn,
               elem_group=mesh.elem_group, parent_elem=mesh.parent_elem,
               child_slot=mesh.child_slot, elem_material=mesh.elem_material)
    out.boundary = {}
    for fg, bf in mesh.boundary.items():
        out.boundary[fg] = BoundaryFaces(
            face_geom=fg, elem=bf.elem, iface=bf.iface, group=bf.group,
            conn=new_id[bf.conn].astype(np.int32))
    return out, plan


def node_of_3d(plan: PatchPlan3D, p: int, i: int, j: int, k: int) -> int:
    """Renumbered node id at lattice (i, j, k) of patch p (test helper)."""
    H, E, P, M = plan.H, plan.E, plan.P, plan.H - 1
    pos = np.array([i, j, k])
    nb = int(((pos == 0) | (pos == M)).sum())
    if nb == 0:
        return (((i - 1) * E + (j - 1)) * E + (k - 1)) * P + p
    if nb == 3:
        for c in range(8):
            if (pos == C8[c] * M).all():
                return plan.n_int + E * E * plan.n_faces + E * plan.n_edges \
                    + plan.patch_verts[p, c]
    if nb == 2:
        for li, (a, b) in enumerate(E12):
            A, B = C8[a] * M, C8[b] * M
            d = B - A
            ax = int(np.argmax(np.abs(d)))
            if all(pos[dd] == A[dd] for dd in range(3) if dd != ax):
                t = pos[ax] if d[ax] > 0 else M - pos[ax]
                if plan.patch_edge_flip[p, li]:
                    t = M - t
                return plan.n_int + E * E * plan.n_faces \
                    + (t - 1) * plan.n_edges + plan.patch_edges[p, li]
        raise AssertionError("edge not found")
    for f in range(6):
        O, U, V = plan.face_frame(f, M)
        Wn = np.cross(U, V)
        ax = int(np.argmax(np.abs(Wn)))
        if pos[ax] == O[ax] and ((pos == 0) | (pos == M))[ax]:
            u, v = _face_uv(O, U, V, pos[None])
            cu, cv = d4_apply(int(plan.patch_face_tf[p, f]),
                              int(u[0]), int(v[0]), M)
            return plan.n_int + ((cu - 1) * E + (cv - 1)) * plan.n_faces \
                + plan.patch_faces[p, f]
    raise AssertionError("face not found")
