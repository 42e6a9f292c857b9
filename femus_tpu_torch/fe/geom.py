"""Reference geometric elements.

Defines the canonical reference-element zoo: topology, biquadratic node
coordinates, per-FE-family local node subsets, face maps, and midpoint
refinement embeddings.  This is the analogue of the reference library's
``src/02_reference_geom_elements/00_definition`` layer (GeomElemBase.hpp:16 and
its 17 concrete subclasses), re-designed as plain data tables consumed by
host-side setup code; nothing here runs on device.

Conventions (ours, self-consistent across generation/refinement/readers):

- ``edge``:  xi in [-1, 1].                 Nodes: 0,1 ends; 2 midpoint.
- ``quad``:  [-1, 1]^2.                     Corners 0-3 CCW; edge mids 4-7
             (01,12,23,30); center 8.
- ``hex``:   [-1, 1]^3.                     Corners 0-3 bottom CCW, 4-7 top;
             edge mids 8-19; face centers 20-25; center 26.
- ``tri``:   x,y >= 0, x+y <= 1.            Corners 0-2; mids 3(01),4(12),5(20);
             centroid 6 (biquadratic bubble).
- ``tet``:   x,y,z >= 0, x+y+z <= 1.        Corners 0-3; mids 4(01),5(12),6(20),
             7(03),8(13),9(23).
- ``wedge``: tri(x,y) x z in [-1,1].        Corners 0-2 bottom, 3-5 top; bottom
             mids 6-8, top mids 9-11, vertical mids 12-14, quad-face centers
             15-17 (tensor tri6 x edge3 = 18 nodes).

FE families follow FElemTypeEnum_list.hpp:10-24 of the reference:
``linear`` (continuous Lagrange P1/Q1), ``serendipity`` (quadratic
serendipity: quad8/hex20/tri6/tet10/wedge15/edge3), ``biquadratic``
(quad9/hex27/tri7/tet10/wedge18/edge3), ``disc_constant`` (P0 per element),
``disc_linear`` (per-element {1, xi, eta, zeta} coefficients).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

FAMILIES = ("linear", "serendipity", "biquadratic", "disc_constant", "disc_linear")
LAGRANGE_FAMILIES = ("linear", "serendipity", "biquadratic")


@dataclasses.dataclass(frozen=True)
class GeomElem:
    """Reference geometric element description (pure topology + coordinates)."""

    name: str
    dim: int
    n_verts: int                       # corner count
    ref_nodes: np.ndarray              # (n_bq, dim) biquadratic node ref coords
    family_nodes: Dict[str, np.ndarray]  # family -> local indices into ref_nodes
    # faces: tuples (face_geom_name, local biquadratic node ids of the face, in
    # the face geom's own node order).  Vertices of the face are the leading
    # entries (matching face_geom.n_verts).
    faces: Tuple[Tuple[str, Tuple[int, ...]], ...]
    # children: (n_children, n_bq, dim) ref coords of each child's biquadratic
    # nodes expressed in the PARENT reference frame (midpoint refinement).
    children: np.ndarray
    center: np.ndarray                 # (dim,) centroid in ref coords

    @property
    def n_nodes_bq(self) -> int:
        return self.ref_nodes.shape[0]

    def n_nodes(self, family: str) -> int:
        if family == "disc_constant":
            return 1
        if family == "disc_linear":
            return 1 + self.dim
        return len(self.family_nodes[family])


def _mid(a, b):
    return tuple((np.asarray(a, float) + np.asarray(b, float)) / 2.0)


def _child_nodes_from_corners(geom_corner_fn, corners: np.ndarray) -> np.ndarray:
    """Given child corner positions (in parent frame), produce the child's full
    biquadratic node set by applying the same corner->node interpolation the
    reference element uses (multilinear in corners; quadratic nodes are
    midpoints/centroids of corners, exact for affine child maps)."""
    return geom_corner_fn(corners)


# ---------------------------------------------------------------------------
# Per-geometry construction helpers: node sets from corner coords.  All
# quadratic nodes are averages of corners (midpoint refinement preserves them).
# ---------------------------------------------------------------------------

def _edge_nodes(c):
    c = np.asarray(c, float)
    return np.array([c[0], c[1], (c[0] + c[1]) / 2])


def _quad_nodes(c):
    c = np.asarray(c, float)
    mids = [(c[i] + c[(i + 1) % 4]) / 2 for i in range(4)]
    center = c.mean(axis=0)
    return np.vstack([c, mids, center[None]])


def _tri_nodes(c):
    c = np.asarray(c, float)
    mids = [(c[i] + c[(i + 1) % 3]) / 2 for i in range(3)]
    centroid = c.mean(axis=0)
    return np.vstack([c, mids, centroid[None]])


_HEX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
              (4, 5), (5, 6), (6, 7), (7, 4),
              (0, 4), (1, 5), (2, 6), (3, 7)]
# faces in (vertex loop) order: bottom, top, front(y=-1), right(x=1), back(y=1), left(x=-1)
_HEX_FACES = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
              (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7)]


def _hex_nodes(c):
    c = np.asarray(c, float)
    edges = [(c[a] + c[b]) / 2 for a, b in _HEX_EDGES]
    faces = [c[list(f)].mean(axis=0) for f in _HEX_FACES]
    center = c.mean(axis=0)
    return np.vstack([c, edges, faces, center[None]])


_TET_EDGES = [(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)]


def _tet_nodes(c):
    c = np.asarray(c, float)
    edges = [(c[a] + c[b]) / 2 for a, b in _TET_EDGES]
    return np.vstack([c, edges])


_WEDGE_EDGES_BOT = [(0, 1), (1, 2), (2, 0)]
_WEDGE_EDGES_TOP = [(3, 4), (4, 5), (5, 3)]
_WEDGE_EDGES_VER = [(0, 3), (1, 4), (2, 5)]
_WEDGE_QFACES = [(0, 1, 4, 3), (1, 2, 5, 4), (2, 0, 3, 5)]


def _wedge_nodes(c):
    c = np.asarray(c, float)
    bot = [(c[a] + c[b]) / 2 for a, b in _WEDGE_EDGES_BOT]
    top = [(c[a] + c[b]) / 2 for a, b in _WEDGE_EDGES_TOP]
    ver = [(c[a] + c[b]) / 2 for a, b in _WEDGE_EDGES_VER]
    qf = [c[list(f)].mean(axis=0) for f in _WEDGE_QFACES]
    return np.vstack([c, bot, top, ver, qf])


_NODES_FROM_CORNERS = {
    "edge": _edge_nodes, "quad": _quad_nodes, "tri": _tri_nodes,
    "hex": _hex_nodes, "tet": _tet_nodes, "wedge": _wedge_nodes,
}


def nodes_from_corners(geom_name: str, corners: np.ndarray) -> np.ndarray:
    """Full biquadratic node set from corner coordinates (affine placement)."""
    return _NODES_FROM_CORNERS[geom_name](corners)


# ---------------------------------------------------------------------------
# Element definitions
# ---------------------------------------------------------------------------

def _make_edge() -> GeomElem:
    ref = _edge_nodes(np.array([[-1.0], [1.0]]))
    fam = {
        "linear": np.array([0, 1]),
        "serendipity": np.array([0, 1, 2]),
        "biquadratic": np.array([0, 1, 2]),
    }
    faces = (("point", (0,)), ("point", (1,)))
    kids = np.stack([
        _edge_nodes(np.array([[-1.0], [0.0]])),
        _edge_nodes(np.array([[0.0], [1.0]])),
    ])
    return GeomElem("edge", 1, 2, ref, fam, faces, kids, np.zeros(1))


def _make_quad() -> GeomElem:
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], float)
    ref = _quad_nodes(corners)
    fam = {
        "linear": np.array([0, 1, 2, 3]),
        "serendipity": np.arange(8),
        "biquadratic": np.arange(9),
    }
    # faces: edge (v0, v1, mid)
    faces = tuple(("edge", (i, (i + 1) % 4, 4 + i)) for i in range(4))
    kids = []
    # 4 children around center; child c has its corner c at parent corner c
    ctr = np.zeros(2)
    for i in range(4):
        a = corners[i]
        b = (corners[i] + corners[(i + 1) % 4]) / 2
        d = (corners[i] + corners[(i + 3) % 4]) / 2
        kid_corners = np.array([a, b, ctr, d]) if i % 2 == 0 else np.array([a, b, ctr, d])
        kids.append(_quad_nodes(kid_corners))
    return GeomElem("quad", 2, 4, ref, fam, faces, np.stack(kids), np.zeros(2))


def _make_tri() -> GeomElem:
    corners = np.array([[0, 0], [1, 0], [0, 1]], float)
    ref = _tri_nodes(corners)
    fam = {
        "linear": np.array([0, 1, 2]),
        "serendipity": np.arange(6),
        "biquadratic": np.arange(7),
    }
    faces = tuple(("edge", (i, (i + 1) % 3, 3 + i)) for i in range(3))
    m01, m12, m20 = (corners[0] + corners[1]) / 2, (corners[1] + corners[2]) / 2, (corners[2] + corners[0]) / 2
    kids = np.stack([
        _tri_nodes(np.array([corners[0], m01, m20])),
        _tri_nodes(np.array([m01, corners[1], m12])),
        _tri_nodes(np.array([m20, m12, corners[2]])),
        _tri_nodes(np.array([m12, m20, m01])),  # center child (inverted)
    ])
    return GeomElem("tri", 2, 3, ref, fam, faces, kids, np.full(2, 1.0 / 3.0))


def _make_hex() -> GeomElem:
    corners = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                        [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], float)
    ref = _hex_nodes(corners)
    fam = {
        "linear": np.arange(8),
        "serendipity": np.arange(20),
        "biquadratic": np.arange(27),
    }
    # faces as quad9: 4 verts, 4 edge mids, 1 center (local bq ids)
    def hex_face(verts):
        vs = list(verts)
        mids = []
        for k in range(4):
            e = frozenset((vs[k], vs[(k + 1) % 4]))
            mids.append(8 + _HEX_EDGES.index(tuple(sorted(e))) if tuple(sorted(e)) in _HEX_EDGES
                        else 8 + [frozenset(x) for x in _HEX_EDGES].index(e))
        fc = 20 + [frozenset(f) for f in _HEX_FACES].index(frozenset(verts))
        return ("quad", tuple(vs) + tuple(mids) + (fc,))
    faces = tuple(hex_face(f) for f in _HEX_FACES)
    # 8 children: one per corner, spanning corner->center in each axis
    kids = []
    for i in range(8):
        a = corners[i]
        kid_corners = np.stack([(a + corners[j]) / 2 + (corners[j] - corners[j]) for j in range(8)])
        # child corner j = midpoint of segment corner_i .. corner_j? No:
        # octant child of corner i has corners = {(a+v)/2 for v in hex corners}
        # arranged so that child corner j corresponds to parent corner j.
        kid_corners = (a[None, :] + corners) / 2
        kids.append(_hex_nodes(kid_corners))
    return GeomElem("hex", 3, 8, ref, fam, faces, np.stack(kids), np.zeros(3))


def _make_tet() -> GeomElem:
    corners = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    ref = _tet_nodes(corners)
    fam = {
        "linear": np.arange(4),
        "serendipity": np.arange(10),
        "biquadratic": np.arange(10),
    }
    # faces as tri6 (verts + mids); tet has no tri7 bubble on faces
    def edge_mid(a, b):
        e = (min(a, b), max(a, b))
        return 4 + _TET_EDGES.index(e) if e in _TET_EDGES else 4 + _TET_EDGES.index((e[1], e[0]))
    def tet_face(v):
        return ("tri", (v[0], v[1], v[2], edge_mid(v[0], v[1]), edge_mid(v[1], v[2]), edge_mid(v[2], v[0])))
    faces = tuple(tet_face(v) for v in [(0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2)])
    # 8 children: 4 corner tets + 4 octahedron tets (standard midpoint split)
    m = {e: (corners[e[0]] + corners[e[1]]) / 2 for e in _TET_EDGES}
    m01, m12, m20, m03, m13, m23 = (m[e] for e in _TET_EDGES)
    c = corners
    kids_corners = [
        [c[0], m01, m20, m03], [m01, c[1], m12, m13],
        [m20, m12, c[2], m23], [m03, m13, m23, c[3]],
        # octahedron split along diagonal m01-m23
        [m01, m12, m20, m23], [m01, m12, m23, m13],
        [m01, m20, m03, m23], [m01, m03, m13, m23],
    ]
    kids = np.stack([_tet_nodes(np.array(k)) for k in kids_corners])
    return GeomElem("tet", 3, 4, ref, fam, faces, kids, np.full(3, 0.25))


def _make_wedge() -> GeomElem:
    tri = np.array([[0, 0], [1, 0], [0, 1]], float)
    corners = np.array([[x, y, z] for z in (-1.0, 1.0) for x, y in tri])
    ref = _wedge_nodes(corners)
    fam = {
        "linear": np.arange(6),
        "serendipity": np.arange(15),
        "biquadratic": np.arange(18),
    }
    def wedge_qface(k):
        v = _WEDGE_QFACES[k]
        # quad face: verts, edge mids (bottom, vertical, top, vertical), center
        b = 6 + k            # bottom mid of edge (v0,v1)
        t = 9 + k            # top mid
        ver0 = 12 + v[0]
        ver1 = 12 + v[1]
        return ("quad", (v[0], v[1], v[2], v[3], b, ver1, t, ver0, 15 + k))
    faces = (
        ("tri", (0, 2, 1, 8, 7, 6)),       # bottom (outward normal -z)
        ("tri", (3, 4, 5, 9, 10, 11)),     # top
        wedge_qface(0), wedge_qface(1), wedge_qface(2),
    )
    # 8 children: split tri into 4, each x 2 z-halves
    t = tri
    m01, m12, m20 = (t[0] + t[1]) / 2, (t[1] + t[2]) / 2, (t[2] + t[0]) / 2
    subtris = [np.array([t[0], m01, m20]), np.array([m01, t[1], m12]),
               np.array([m20, m12, t[2]]), np.array([m12, m20, m01])]
    kids = []
    for z0, z1 in ((-1.0, 0.0), (0.0, 1.0)):
        for st in subtris:
            kc = np.array([[x, y, z0] for x, y in st] + [[x, y, z1] for x, y in st])
            kids.append(_wedge_nodes(kc))
    return GeomElem("wedge", 3, 6, ref, fam, faces, np.stack(kids),
                    np.array([1.0 / 3.0, 1.0 / 3.0, 0.0]))


def _make_point() -> GeomElem:
    ref = np.zeros((1, 0))
    one = np.array([0])
    fam = {"linear": one, "serendipity": one, "biquadratic": one}
    return GeomElem("point", 0, 1, ref, fam, (), np.zeros((1, 1, 0)), np.zeros(0))


GEOMS: Dict[str, GeomElem] = {
    g.name: g for g in (_make_point(), _make_edge(), _make_quad(), _make_tri(),
                        _make_hex(), _make_tet(), _make_wedge())
}


def get_geom(name: str) -> GeomElem:
    return GEOMS[name]


def n_children(name: str) -> int:
    return GEOMS[name].children.shape[0]
