"""Structured box mesh generation (1/2/3-D, all element types).

Equivalent of the reference's ``MeshTools::Generation::BuildBox``
(MeshGeneration.hpp:36-42, .cpp 1389 LoC) including biquadratic node
placement, re-designed as vectorized numpy construction: every biquadratic
node is a fixed linear combination of element corners (weights = linear basis
evaluated at the node's reference position), so node positions for all
elements are produced by one einsum and de-duplicated with ``np.unique``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..fe.basis import get_basis
from ..fe.geom import GEOMS
from .mesh import Mesh, build_boundary_faces


def _corner_weights(geom: str) -> np.ndarray:
    """(n_bq, n_verts) weights: biquadratic node = weights @ corners."""
    g = GEOMS[geom]
    return np.asarray(get_basis(geom, "linear").eval(g.ref_nodes), np.float64)


def _cells(ns: Sequence[int]) -> np.ndarray:
    """Integer corner offsets of all cells: (n_cells, dim) lower corners (in
    cell units)."""
    grids = np.meshgrid(*[np.arange(n) for n in ns], indexing="ij")
    return np.stack([gg.ravel() for gg in grids], axis=1)


def _cell_corner_coords(lower: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """(n_cells, n_verts, dim) fine-grid (x2) integer corner coords."""
    return 2 * lower[:, None, :] + 2 * offsets[None, :, :]


# corner offsets (cell units) per geometry, matching geom.py vertex order
_QUAD_OFF = np.array([[0, 0], [1, 0], [1, 1], [0, 1]])
_HEX_OFF = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])


def _kuhn_tets() -> np.ndarray:
    """6 positively-oriented tets per unit cube (Kuhn triangulation)."""
    import itertools
    cube = {tuple(v): i for i, v in enumerate(_HEX_OFF.tolist())}
    tets = []
    for perm in itertools.permutations(range(3)):
        p = [np.zeros(3, int)]
        for ax in perm:
            q = p[-1].copy()
            q[ax] = 1
            p.append(q)
        ids = [cube[tuple(v)] for v in p]
        # orientation: det of edge matrix must be > 0
        M = (_HEX_OFF[ids[1:]] - _HEX_OFF[ids[0]]).astype(float)
        if np.linalg.det(M) < 0:
            ids[1], ids[2] = ids[2], ids[1]
        tets.append(ids)
    return np.array(tets)


def box(ns: Sequence[int],
        bounds: Sequence[Tuple[float, float]],
        geom: str = None) -> Mesh:
    """Build a structured box mesh.

    ns: cells per axis; bounds: (lo, hi) per axis; geom: element type
    (default: edge/quad/hex by dimension; also "tri", "tet", "wedge").
    """
    dim = len(ns)
    if geom is None:
        geom = {1: "edge", 2: "quad", 3: "hex"}[dim]
    lower = _cells(ns)
    if geom == "edge":
        vert_sets = np.array([[[0], [1]]])
        off = np.array([[0], [1]])
        corner = _cell_corner_coords(lower, off)            # (nc, 2, 1)
        elems = corner[:, None, :, :]
    elif geom == "quad":
        elems = _cell_corner_coords(lower, _QUAD_OFF)[:, None, :, :]
    elif geom == "hex":
        elems = _cell_corner_coords(lower, _HEX_OFF)[:, None, :, :]
    elif geom == "tri":
        c = _cell_corner_coords(lower, _QUAD_OFF)           # (nc, 4, 2)
        elems = np.stack([c[:, [0, 1, 2]], c[:, [0, 2, 3]]], axis=1)
    elif geom == "tet":
        c = _cell_corner_coords(lower, _HEX_OFF)
        tets = _kuhn_tets()
        elems = np.stack([c[:, t] for t in tets], axis=1)
    elif geom == "wedge":
        c = _cell_corner_coords(lower, _HEX_OFF)
        # bottom tris (0,1,2) and (0,2,3); tops are +z counterparts (4,5,6),(4,6,7)
        elems = np.stack([c[:, [0, 1, 2, 4, 5, 6]], c[:, [0, 2, 3, 4, 6, 7]]], axis=1)
    else:
        raise KeyError(geom)

    n_cells, epc, nverts, _ = elems.shape
    corners = elems.reshape(-1, nverts, dim).astype(np.float64)
    W = _corner_weights(geom)                               # (n_bq, nv)
    node_pos = np.einsum("bv,evd->ebd", W, corners)         # (ne, n_bq, dim)
    # integer keys: fine-grid units are even ints; x3 makes thirds integral
    keys = np.rint(node_pos * 3).astype(np.int64)
    flat = keys.reshape(-1, dim)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    conn = inv.reshape(-1, node_pos.shape[1]).astype(np.int32)
    # physical coordinates
    coords = uniq.astype(np.float64) / 6.0                  # cell units
    for d in range(dim):
        lo, hi = bounds[d]
        coords[:, d] = lo + coords[:, d] * (hi - lo) / ns[d]
    mesh = Mesh(dim=dim, geom=geom, coords=coords, conn=conn,
                elem_group=np.zeros(conn.shape[0], np.int32))
    build_boundary_faces(mesh)
    return mesh


def unit_box(ns: Sequence[int], geom: str = None) -> Mesh:
    return box(ns, [(0.0, 1.0)] * len(ns), geom)
