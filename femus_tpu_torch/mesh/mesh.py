"""Struct-of-arrays mesh (single level).

The reference stores mesh connectivity in pointer-heavy ``MyVector``/
``MyMatrix`` containers (Mesh.hpp:61, Elem.hpp:45).  Here a mesh level is a
set of dense numpy arrays — element->node connectivity at biquadratic order,
element metadata, and boundary faces — batched so element kernels run over
all elements at once (SURVEY.md §7 "Struct-of-arrays mesh").  All
construction is host-side setup; the assembler uploads the arrays once.

Dof maps for all 5 FE families (reference ``_dofOffset``/``GetSolutionDof``,
Mesh.hpp:496-543) are realized as per-family element->dof connectivity arrays
plus node subsets; see dofmap.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..fe.geom import GEOMS
from .dofmap import DofMap, build_dofmap

# boundary groups for generated box meshes: 1:x-, 2:x+, 3:y-, 4:y+, 5:z-, 6:z+
BOX_GROUPS = {0: (1, 2), 1: (3, 4), 2: (5, 6)}


@dataclasses.dataclass
class BoundaryFaces:
    """Boundary faces of one mesh level (single face-geom type).

    elem: (nf,) owning element; iface: (nf,) local face id within the element;
    group: (nf,) user/bc group label; conn: (nf, n_face_bq) global node ids in
    the face geometry's own biquadratic node order.
    """

    face_geom: str
    elem: np.ndarray
    iface: np.ndarray
    group: np.ndarray
    conn: np.ndarray


@dataclasses.dataclass
class Mesh:
    """One mesh level: single geometric element type, biquadratic nodes."""

    dim: int
    geom: str
    coords: np.ndarray               # (n_nodes, dim) float64
    conn: np.ndarray                 # (n_elem, n_bq) int32
    elem_group: np.ndarray           # (n_elem,) int32 material/group labels
    boundary: Dict[str, BoundaryFaces] = dataclasses.field(default_factory=dict)
    # refinement lineage (filled by refine): parent elem id and child slot
    parent_elem: Optional[np.ndarray] = None
    child_slot: Optional[np.ndarray] = None
    # per-element refinement level for mixed-level AMR meshes (None = uniform)
    elem_level: Optional[np.ndarray] = None
    # per-element material id (reference SetElementMaterial; None = use
    # elem_group, which mesh constructors without materials default to)
    elem_material: Optional[np.ndarray] = None
    _dofmaps: Dict[str, DofMap] = dataclasses.field(default_factory=dict)
    # element partition (filled by parallel setup): elem -> shard id
    elem_shard: Optional[np.ndarray] = None

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elems(self) -> int:
        return self.conn.shape[0]

    def dofmap(self, family: str) -> DofMap:
        if family not in self._dofmaps:
            self._dofmaps[family] = build_dofmap(self, family)
        return self._dofmaps[family]

    def node_coords_of(self, family: str) -> np.ndarray:
        """Physical coordinates of each dof carrier for a Lagrange family
        (for disc families: the element centroid repeated per dof)."""
        dm = self.dofmap(family)
        if family in ("disc_constant", "disc_linear"):
            cent = self.coords[self.conn].mean(axis=1)     # approx centroid
            reps = 1 if family == "disc_constant" else 1 + self.dim
            return np.repeat(cent, reps, axis=0)
        return self.coords[dm.nodes]

    def char_length(self) -> float:
        """Characteristic element length (reference Mesh.hpp:302)."""
        c = self.coords[self.conn[:, : GEOMS[self.geom].n_verts]]
        return float(np.linalg.norm(c.max(axis=1) - c.min(axis=1), axis=1).mean())


# orientation-reversing node permutation per geometry (mirror): applied to
# elements whose geometric map has negative Jacobian. Derived from the node
# role layout in fe/geom.py (corners, edge mids, face centers, body center).
_FLIP = {
    "edge": [1, 0, 2],
    "tri": [0, 2, 1, 5, 4, 3, 6],
    "quad": [0, 3, 2, 1, 7, 6, 5, 4, 8],
    "tet": [0, 2, 1, 3, 6, 5, 4, 7, 9, 8],
    "wedge": [0, 2, 1, 3, 5, 4, 8, 7, 6, 11, 10, 9, 12, 14, 13, 17, 16, 15],
    # hex: swap corners 1<->3 (reflect across x=y); faces ordered
    # bottom,top,front,right,back,left
    "hex": [0, 3, 2, 1, 4, 7, 6, 5, 11, 10, 9, 8, 15, 14, 13, 12,
            16, 19, 18, 17, 20, 21, 25, 24, 23, 22, 26],
}


def fix_orientation(geom: str, conn: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Flip elements with negative corner-Jacobian so all geometric maps are
    positively oriented (mesh generators — e.g. SALOME .med — emit mixed or
    clockwise orientations; the reference tolerates them via |detJ|, we
    normalize at read time instead)."""
    g = GEOMS[geom]
    dim = g.ref_nodes.shape[1]
    if coords.shape[1] != dim:
        return conn                        # surface mesh: no signed volume
    from ..fe.basis import get_basis
    b = get_basis(geom, "linear")
    center = g.ref_nodes.mean(axis=0, keepdims=True)
    dphi = np.asarray(b.eval_grad(center))[0]              # (n_verts, dim)
    c = coords[conn[:, :g.n_verts]]        # corners come first in our layout
    J = np.einsum("nd,enx->edx", dphi, c)
    neg = np.linalg.det(J) < 0
    if np.any(neg):
        conn = conn.copy()
        conn[neg] = conn[neg][:, np.array(_FLIP[geom][:conn.shape[1]], int)]
    return conn


def _face_corner_key(conn_row: np.ndarray, verts: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(sorted(int(conn_row[v]) for v in verts))


def build_boundary_faces(mesh: Mesh, group_fn=None) -> None:
    """Find boundary faces (faces owned by exactly one element) and label them.

    group_fn(face_centroid: (dim,) array) -> int group label; defaults to the
    box convention (closest domain bounding-box side).
    """
    g = GEOMS[mesh.geom]
    # vectorized: per face-arity group, build sorted-corner key arrays and
    # keep faces whose key appears exactly once
    found = []      # (elem, iface) pairs
    by_arity: Dict[int, list] = {}
    for i, (fg, f_bq) in enumerate(g.faces):
        by_arity.setdefault(GEOMS[fg].n_verts, []).append((i, f_bq))
    for nvf, faces in by_arity.items():
        keys_all, elems_all, ifaces_all = [], [], []
        for i, f_bq in faces:
            corners = mesh.conn[:, np.asarray(f_bq[:nvf])]
            keys_all.append(np.sort(corners, axis=1))
            elems_all.append(np.arange(mesh.n_elems, dtype=np.int64))
            ifaces_all.append(np.full(mesh.n_elems, i, np.int64))
        keys = np.concatenate(keys_all)
        elems = np.concatenate(elems_all)
        ifaces = np.concatenate(ifaces_all)
        uniq, inv, cnt = np.unique(keys, axis=0, return_inverse=True,
                                   return_counts=True)
        sel = cnt[inv] == 1
        for e, i in zip(elems[sel], ifaces[sel]):
            found.append((int(e), int(i)))
    face_count = {j: ei for j, ei in enumerate(found)}
    if not face_count:
        mesh.boundary = {}
        return
    if group_fn is None:
        lo = mesh.coords.min(axis=0)
        hi = mesh.coords.max(axis=0)
        tol = 1e-8 * max(float(np.max(hi - lo)), 1.0)

        def group_fn(c):
            for d in range(mesh.dim):
                if abs(c[d] - lo[d]) < tol:
                    return BOX_GROUPS[d][0]
                if abs(c[d] - hi[d]) < tol:
                    return BOX_GROUPS[d][1]
            return 0

    by_geom: Dict[str, list] = {}
    for (e, i) in face_count.values():
        fg, f_bq = g.faces[i]
        conn = mesh.conn[e][np.asarray(f_bq)]
        centroid = mesh.coords[conn[:GEOMS[fg].n_verts]].mean(axis=0)
        by_geom.setdefault(fg, []).append((e, i, group_fn(centroid), conn))
    mesh.boundary = {}
    for fg, items in by_geom.items():
        items.sort(key=lambda t: (t[0], t[1]))
        mesh.boundary[fg] = BoundaryFaces(
            face_geom=fg,
            elem=np.array([t[0] for t in items], np.int32),
            iface=np.array([t[1] for t in items], np.int32),
            group=np.array([t[2] for t in items], np.int32),
            conn=np.stack([t[3] for t in items]).astype(np.int32),
        )


def boundary_node_groups(mesh: Mesh) -> Dict[int, np.ndarray]:
    """group label -> array of node ids lying on faces of that group.

    A node on several groups appears in each; BC generation resolves priority
    (Dirichlet wins) like the reference's min-combine of Bdc codes
    (NumericVector::closeWithMinValues, MultiLevelSolution.cpp:725-835)."""
    out: Dict[int, set] = {}
    for bf in mesh.boundary.values():
        for k in range(len(bf.elem)):
            out.setdefault(int(bf.group[k]), set()).update(bf.conn[k].tolist())
    return {grp: np.array(sorted(s), np.int32) for grp, s in out.items()}


def elem_neighbors(mesh: Mesh) -> np.ndarray:
    """(n_elems, n_faces) element id across each face, -1 on the boundary
    (reference ``_elementNearFace``, Elem.hpp:463) — built once on host via
    sorted-corner face keys."""
    g = GEOMS[mesh.geom]
    nf = len(g.faces)
    keys_all, elems_all, ifaces_all = [], [], []
    for i, (fg, f_bq) in enumerate(g.faces):
        nvf = GEOMS[fg].n_verts
        corners = np.sort(mesh.conn[:, np.asarray(f_bq[:nvf])], axis=1)
        keys_all.append(corners)
        elems_all.append(np.arange(mesh.n_elems, dtype=np.int64))
        ifaces_all.append(np.full(mesh.n_elems, i, np.int64))
    keys = np.concatenate(keys_all)
    elems = np.concatenate(elems_all)
    ifaces = np.concatenate(ifaces_all)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    out = np.full((mesh.n_elems, nf), -1, np.int32)
    order = np.argsort(inv, kind="stable")
    si, se, sf = inv[order], elems[order], ifaces[order]
    # pairs: consecutive equal face keys
    a = np.where(si[:-1] == si[1:])[0]
    b = a + 1
    out[se[a], sf[a]] = se[b]
    out[se[b], sf[b]] = se[a]
    return out
