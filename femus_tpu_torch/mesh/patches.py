"""Patch-coherent refinement: semi-structured lattices for the stencil SpMV.

A coarse unstructured mesh uniformly refined L times is a collection of
STRUCTURED patches — one (2^L x 2^L)-element lattice per coarse element —
glued along coarse edges.  With a patch-coherent dof numbering the fine
operator becomes a batched variable-coefficient lattice stencil per patch
(algebra/patchstencil.py): SpMV = contiguous reshapes + small edge/vertex
routing + shifted multiply-adds, with no per-nonzero column index.

Only the COARSE mesh is unstructured (coarse file + uniform refinement, the
usual multigrid workflow).

Node numbering produced by :func:`refine_patched` (biquadratic family,
2-D quad geometry):

- patch-interior nodes first, POSITION-major / patch-minor:
  ``id = ((i-1)*(H-2) + (j-1)) * P + p`` for lattice position (i, j),
  patch p — so ``x[:n_int].reshape(H-2, H-2, P)`` is the batched interior
  lattice with the patch axis innermost (consecutive threads of the kernel);
- coarse-edge interior nodes next, position-major / edge-minor:
  ``id = n_int + t * n_edges + e`` for the t-th node along edge e
  (ordered from the edge's lower-id endpoint);
- coarse-vertex nodes last.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..fe.geom import GEOMS
from .mesh import BoundaryFaces, Mesh
from .refine import _child_phi, refine


@dataclasses.dataclass
class PatchPlan:
    """Host tables describing the patch lattice structure of a refined mesh.

    All node ids refer to the RENUMBERED fine mesh returned alongside.
    Lattice convention: position (i, j) = (x-like, y-like) index in
    [0, H) x [0, H); H = 2*2^L + 1 biquadratic nodes per side.
    """

    levels: int
    H: int                        # nodes per patch side (biquadratic)
    P: int                        # number of patches (= coarse elements)
    n_int: int                    # P * (H-2)^2 interior nodes
    n_edges: int
    n_verts: int
    E: int                        # interior nodes per edge = H-2
    elem_patch: np.ndarray        # (ne,) patch of each fine element
    elem_lat: np.ndarray          # (ne, 2) cell coords of each fine element
    elem_node_lat: np.ndarray     # (ne, n_bq, 2) lattice position of each
                                  # element node in its patch frame (children
                                  # of refine() carry rotated local frames)
    # faces in lattice terms: 0: j=0 row, 1: i=H-1 col, 2: j=H-1 row, 3: i=0 col
    patch_edges: np.ndarray       # (P, 4) edge id per face
    patch_edge_flip: np.ndarray   # (P, 4) bool: True if edge order reversed
    patch_verts: np.ndarray       # (P, 4) vertex id at lattice corners
                                  # [(0,0), (H-1,0), (H-1,H-1), (0,H-1)]
    edge_sides: np.ndarray        # (n_edges, 2, 3) (patch, face, flip) or -1
    vert_sides_idx: np.ndarray    # (n_verts, maxval, 2) (patch, corner) or -1

    def node_of(self, p: int, i: int, j: int) -> int:
        """Renumbered node id at lattice (i, j) of patch p."""
        H, E, P = self.H, self.E, self.P
        if 0 < i < H - 1 and 0 < j < H - 1:
            return ((i - 1) * E + (j - 1)) * P + p
        corner = {(0, 0): 0, (H - 1, 0): 1, (H - 1, H - 1): 2, (0, H - 1): 3}
        if (i, j) in corner:
            return self.n_int + self.E * self.n_edges + \
                self.patch_verts[p, corner[(i, j)]]
        f, t = _face_pos(H, i, j)
        e = self.patch_edges[p, f]
        tt = (self.E - 1 - t) if self.patch_edge_flip[p, f] else t
        return self.n_int + tt * self.n_edges + e


def _face_pos(H: int, i: int, j: int) -> Tuple[int, int]:
    """(face, position-along-face) of a boundary lattice node (not corner).

    Face-local order runs with increasing i (horizontal faces 0/2) or
    increasing j (vertical faces 1/3); positions exclude the two corners."""
    if j == 0:
        return 0, i - 1
    if i == H - 1:
        return 1, j - 1
    if j == H - 1:
        return 2, i - 1
    if i == 0:
        return 3, j - 1
    raise ValueError("interior node")


def refine_patched(coarse: Mesh, levels: int) -> Tuple[Mesh, PatchPlan]:
    """Refine ``levels`` times and renumber fine nodes patch-coherently.

    2-D quad meshes, biquadratic node set.  Returns (fine mesh, PatchPlan).

    Children of :func:`refine` carry ROTATED local frames (the embedding
    tables permute child axes), so per-element lattice positions are tracked
    numerically: each element stores its 9 node positions in the PATCH
    reference frame [-1,1]^2, propagated by the same parent-basis
    interpolation refine() uses for physical coordinates.
    """
    if coarse.geom != "quad":
        raise NotImplementedError("patch lattices: 2-D quad geometry only")
    assert levels >= 1
    g = GEOMS["quad"]
    CP = _child_phi("quad")                                   # (nk, n_bq, n_bq)
    n_bq = g.n_nodes_bq

    mesh = coarse
    patch = np.arange(coarse.n_elems, dtype=np.int64)
    # per-element node positions in the patch frame (ne, n_bq, 2)
    enp = np.broadcast_to(g.ref_nodes, (coarse.n_elems, n_bq, 2)).copy()
    for _ in range(levels):
        mesh = refine(mesh)
        patch = patch[mesh.parent_elem]
        enp = np.einsum("eab,ebd->ead", CP[mesh.child_slot],
                        enp[mesh.parent_elem])
    m = 2 ** levels                                           # elems per side
    H = 2 * m + 1
    P = coarse.n_elems
    E = H - 2

    # lattice positions (integers in [0, 2m]) of every (elem, local node)
    lat_f = (enp + 1.0) * m
    lat_i = np.rint(lat_f).astype(np.int64)
    assert np.abs(lat_f - lat_i).max() < 1e-6, "non-lattice node position"
    ei = lat_i[:, :, 0]                                       # (ne, n_bq)
    ej = lat_i[:, :, 1]
    nodes = mesh.conn.astype(np.int64)                        # (ne, n_bq)
    elem_lat = lat_i[:, :, :].min(axis=1) // 2                # element cell coords

    nn = mesh.n_nodes
    # one representative (patch, i, j) per node (first occurrence)
    rep = np.full((nn, 3), -1, np.int64)
    flat_nodes = nodes.ravel()
    order = np.argsort(flat_nodes, kind="stable")
    first = np.ones(len(order), bool)
    first[1:] = flat_nodes[order][1:] != flat_nodes[order][:-1]
    sel = order[first]
    rep[flat_nodes[sel], 0] = np.repeat(patch, n_bq)[sel]
    rep[flat_nodes[sel], 1] = ei.ravel()[sel]
    rep[flat_nodes[sel], 2] = ej.ravel()[sel]
    assert (rep[:, 0] >= 0).all(), "orphan fine nodes"

    ri, rj = rep[:, 1], rep[:, 2]
    on_b = (ri == 0) | (ri == H - 1) | (rj == 0) | (rj == H - 1)
    # a node is a COARSE VERTEX iff it sits at a lattice corner in its
    # representative patch (corners are corners in every adjacent patch)
    is_vert = ((ri == 0) | (ri == H - 1)) & ((rj == 0) | (rj == H - 1))
    is_edge = on_b & ~is_vert
    is_int = ~on_b

    # ---- coarse vertices ------------------------------------------------
    vert_nodes = np.nonzero(is_vert)[0]
    n_verts = len(vert_nodes)
    vert_id = np.full(nn, -1, np.int64)
    vert_id[vert_nodes] = np.arange(n_verts)

    # patch corner nodes: element at lattice corner contributes its corner
    patch_verts = np.full((P, 4), -1, np.int64)
    corner_lat = {(0, 0): 0, (H - 1, 0): 1, (H - 1, H - 1): 2, (0, H - 1): 3}
    for a in range(n_bq):
        ii, jj = ei[:, a], ej[:, a]
        for (ci, cj), c in corner_lat.items():
            sel_e = (ii == ci) & (jj == cj)
            patch_verts[patch[sel_e], c] = vert_id[nodes[sel_e, a]]
    assert (patch_verts >= 0).all()

    # ---- coarse edges ---------------------------------------------------
    # identify each patch face by its (sorted) endpoint vertex pair
    # face f endpoints in corner order: 0:(c0,c1) 1:(c1,c2) 2:(c3,c2) 3:(c0,c3)
    face_ends = np.stack([
        patch_verts[:, [0, 1]], patch_verts[:, [1, 2]],
        patch_verts[:, [3, 2]], patch_verts[:, [0, 3]]], axis=1)  # (P, 4, 2)
    lo = face_ends.min(axis=2)
    hi = face_ends.max(axis=2)
    keys = lo * (n_verts + 1) + hi                             # (P, 4)
    uniq, edge_of_face = np.unique(keys, return_inverse=True)
    patch_edges = edge_of_face.reshape(P, 4)
    n_edges = len(uniq)
    # orientation: edge runs lower->higher endpoint id; the face-local order
    # runs from its first corner to its second
    patch_edge_flip = face_ends[:, :, 0] > face_ends[:, :, 1]

    edge_sides = np.full((n_edges, 2, 3), -1, np.int64)
    for p in range(P):
        for f in range(4):
            e = patch_edges[p, f]
            s = 0 if edge_sides[e, 0, 0] < 0 else 1
            edge_sides[e, s] = (p, f, int(patch_edge_flip[p, f]))

    # vertex adjacency (patch, corner) lists
    counts = np.zeros(n_verts, np.int64)
    np.add.at(counts, patch_verts.ravel(), 1)
    maxval = int(counts.max())
    vert_sides_idx = np.full((n_verts, maxval, 2), -1, np.int64)
    fill = np.zeros(n_verts, np.int64)
    for p in range(P):
        for c in range(4):
            v = patch_verts[p, c]
            vert_sides_idx[v, fill[v]] = (p, c)
            fill[v] += 1

    # ---- new node numbering --------------------------------------------
    n_int = P * E * E
    new_id = np.full(nn, -1, np.int64)
    si = np.nonzero(is_int)[0]
    new_id[si] = ((rep[si, 1] - 1) * E + (rep[si, 2] - 1)) * P + rep[si, 0]
    se = np.nonzero(is_edge)[0]
    fpos = np.empty((len(se), 2), np.int64)
    for k, nidx in enumerate(se):
        fpos[k] = _face_pos(H, int(rep[nidx, 1]), int(rep[nidx, 2]))
    pe = rep[se, 0]
    eids = patch_edges[pe, fpos[:, 0]]
    t = np.where(patch_edge_flip[pe, fpos[:, 0]], E - 1 - fpos[:, 1], fpos[:, 1])
    new_id[se] = n_int + t * n_edges + eids
    sv = vert_nodes
    new_id[sv] = n_int + E * n_edges + vert_id[sv]
    assert (new_id >= 0).all()
    assert len(np.unique(new_id)) == nn, "numbering collision"

    # ---- permute the mesh ----------------------------------------------
    inv = np.empty(nn, np.int64)
    inv[new_id] = np.arange(nn)                               # new -> old
    out = Mesh(dim=mesh.dim, geom=mesh.geom, coords=mesh.coords[inv],
               conn=new_id[mesh.conn].astype(np.int32),
               elem_group=mesh.elem_group,
               parent_elem=mesh.parent_elem, child_slot=mesh.child_slot,
               elem_material=mesh.elem_material)
    out.boundary = {}
    for fg, bf in mesh.boundary.items():
        out.boundary[fg] = BoundaryFaces(
            face_geom=fg, elem=bf.elem, iface=bf.iface, group=bf.group,
            conn=new_id[bf.conn].astype(np.int32))

    plan = PatchPlan(levels=levels, H=H, P=P, n_int=n_int, n_edges=n_edges,
                     n_verts=n_verts, E=E,
                     elem_patch=patch, elem_lat=elem_lat,
                     elem_node_lat=lat_i,
                     patch_edges=patch_edges,
                     patch_edge_flip=patch_edge_flip,
                     patch_verts=patch_verts, edge_sides=edge_sides,
                     vert_sides_idx=vert_sides_idx)
    return out, plan
