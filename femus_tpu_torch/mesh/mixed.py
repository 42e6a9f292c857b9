"""Mixed element-type meshes (hybrid quad+tri / hex+wedge domains).

The reference carries an element type PER ELEMENT (``Elem.hpp:45``; MED and
Gambit readers accept hybrid cell lists, e.g. the shipped SALOME meshes under
``00_salome/2d/zzz_hybrid_meshes``).  Each element kernel stays batched
over one geometry: the mesh splits into per-geometry BLOCKS that share one
global node array and one global dof numbering (SURVEY.md §7 hard part 4:
"pad per-type batches and run one kernel per geom type per level"):

- :class:`MixedMesh`: list of single-geom :class:`Mesh` blocks over shared
  ``coords``;
- :func:`build_global_dofmaps`: one dof numbering per FE family spanning all
  blocks (Lagrange families number the union of carrier nodes — conforming
  across blocks because tri/quad and wedge/hex share face node layouts;
  discontinuous families number per-element with block offsets), injected
  into each block so a standard per-block ``Assembler`` emits GLOBAL dof ids;
- :func:`merge_meshes`: glue two conforming single-geom meshes (interface
  nodes deduplicated by coordinate, interface faces dropped from the
  boundary lists).

Assembly over a MixedMesh = one batched kernel per block feeding one union
ELL pattern; see assembly/mixed.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from ..fe.geom import GEOMS
from .dofmap import DofMap
from .mesh import BoundaryFaces, Mesh


@dataclasses.dataclass
class MixedMesh:
    dim: int
    blocks: List[Mesh]                 # all share the SAME coords array

    @property
    def coords(self) -> np.ndarray:
        return self.blocks[0].coords

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elems(self) -> int:
        return sum(b.n_elems for b in self.blocks)

    @property
    def geoms(self) -> List[str]:
        return [b.geom for b in self.blocks]


def build_global_dofmaps(mm: MixedMesh, family: str) -> int:
    """Build one global dof numbering for ``family`` across all blocks and
    inject the per-block :class:`DofMap`s (GLOBAL dof ids in ``conn``) into
    each block.  Returns the global dof count."""
    if family in ("disc_constant", "disc_linear"):
        nd = 1 if family == "disc_constant" else 1 + mm.dim
        n = mm.n_elems * nd
        e0 = 0
        for b in mm.blocks:
            conn = ((e0 + np.arange(b.n_elems, dtype=np.int32))[:, None] * nd
                    + np.arange(nd, dtype=np.int32)[None, :])
            b._dofmaps[family] = DofMap(family, n, conn,
                                        np.full(n, -1, np.int32),
                                        np.full(mm.n_nodes, -1, np.int32))
            e0 += b.n_elems
        return n
    subs = [b.conn[:, GEOMS[b.geom].family_nodes[family]] for b in mm.blocks]
    used = np.unique(np.concatenate([s.ravel() for s in subs]))
    node_to_dof = np.full(mm.n_nodes, -1, np.int32)
    node_to_dof[used] = np.arange(len(used), dtype=np.int32)
    for b, s in zip(mm.blocks, subs):
        b._dofmaps[family] = DofMap(family, int(len(used)),
                                    node_to_dof[s].astype(np.int32),
                                    used.astype(np.int32), node_to_dof)
    return int(len(used))


def _face_key(conn_row: np.ndarray, fgeom: str) -> tuple:
    nv = GEOMS[fgeom].n_verts
    return tuple(sorted(int(v) for v in conn_row[:nv]))


def merge_meshes(a: Mesh, b: Mesh, decimals: int = 9) -> MixedMesh:
    """Glue two conforming single-geom meshes into a MixedMesh.

    Nodes coinciding to ``decimals`` digits are merged; boundary faces whose
    corner sets appear in BOTH meshes' boundary lists (the glue interface)
    are dropped from both."""
    assert a.dim == b.dim
    coords = np.vstack([a.coords, b.coords])
    keys = np.round(coords, decimals)
    uniq, idx, inv = np.unique(keys, axis=0, return_index=True,
                               return_inverse=True)
    new_coords = coords[idx]
    remap = inv.astype(np.int32)
    ra = remap[:a.n_nodes]
    rb = remap[a.n_nodes:]

    def reblock(m: Mesh, r: np.ndarray) -> Mesh:
        bnd = {}
        for fg, bf in m.boundary.items():
            bnd[fg] = BoundaryFaces(fg, bf.elem.copy(), bf.iface.copy(),
                                    bf.group.copy(),
                                    r[bf.conn].astype(np.int32))
        return Mesh(dim=m.dim, geom=m.geom, coords=new_coords,
                    conn=r[m.conn].astype(np.int32),
                    elem_group=m.elem_group.copy(), boundary=bnd)

    na, nb = reblock(a, ra), reblock(b, rb)
    # drop interface faces: corner-key present in both blocks' boundaries
    keys_a = {(_face_key(c, fg)) for fg, bf in na.boundary.items()
              for c in bf.conn}
    keys_b = {(_face_key(c, fg)) for fg, bf in nb.boundary.items()
              for c in bf.conn}
    shared = keys_a & keys_b
    for m in (na, nb):
        for fg in list(m.boundary):
            bf = m.boundary[fg]
            keep = np.array([_face_key(c, fg) not in shared
                             for c in bf.conn], bool)
            if keep.all():
                continue
            m.boundary[fg] = BoundaryFaces(fg, bf.elem[keep], bf.iface[keep],
                                           bf.group[keep], bf.conn[keep])
    return MixedMesh(dim=a.dim, blocks=[na, nb])


def mixed_unit_box(ns: Sequence[int], geoms=("quad", "tri")) -> MixedMesh:
    """[0,1]^d split at x = 1/2: left half ``geoms[0]``, right ``geoms[1]``
    (quad+tri in 2-D, hex+wedge in 3-D) — the reference's hybrid-mesh
    capability on a generated domain."""
    from .generation import box
    dim = len(ns)
    bounds_l = [(0.0, 0.5)] + [(0.0, 1.0)] * (dim - 1)
    bounds_r = [(0.5, 1.0)] + [(0.0, 1.0)] * (dim - 1)
    a = box(ns, bounds_l, geoms[0])
    b = box(ns, bounds_r, geoms[1])
    return merge_meshes(a, b)
