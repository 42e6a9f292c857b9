"""Per-FE-family dof maps.

Reference semantics: a mesh carries dof numberings for all 5 FE families at
once (``_dofOffset[NFE_FAMS][nprocs]`` Mesh.hpp:534, ``GetSolutionDof``
Mesh.hpp:496).  Lagrange families number a subset of the biquadratic nodes
(linear: corners; serendipity: corners+edges; biquadratic: all); discontinuous
families number per-element dofs (P0: 1, P1: 1+dim).

Here a DofMap is two arrays: ``conn`` (n_elem, nd) element->dof ids used by
batched gathers/scatters on device, and ``nodes`` (n_dofs,) the global mesh
node carrying each dof (-1 for element-interior disc dofs).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..fe.geom import GEOMS


@dataclasses.dataclass(frozen=True)
class DofMap:
    family: str
    n_dofs: int
    conn: np.ndarray          # (n_elem, nd) int32: element-local -> global dof
    nodes: np.ndarray         # (n_dofs,) int32: global mesh node per dof (-1 = none)
    node_to_dof: np.ndarray   # (n_nodes,) int32: mesh node -> dof (-1 = none)


def build_dofmap(mesh, family: str) -> DofMap:
    g = GEOMS[mesh.geom]
    if family == "disc_constant":
        n = mesh.n_elems
        conn = np.arange(n, dtype=np.int32)[:, None]
        return DofMap(family, n, conn, np.full(n, -1, np.int32),
                      np.full(mesh.n_nodes, -1, np.int32))
    if family == "disc_linear":
        nd = 1 + mesh.dim
        n = mesh.n_elems * nd
        conn = (np.arange(mesh.n_elems, dtype=np.int32)[:, None] * nd
                + np.arange(nd, dtype=np.int32)[None, :])
        return DofMap(family, n, conn, np.full(n, -1, np.int32),
                      np.full(mesh.n_nodes, -1, np.int32))
    local = g.family_nodes[family]
    sub_conn = mesh.conn[:, local]                       # (n_elem, nd) node ids
    used = np.unique(sub_conn)
    node_to_dof = np.full(mesh.n_nodes, -1, np.int32)
    node_to_dof[used] = np.arange(len(used), dtype=np.int32)
    conn = node_to_dof[sub_conn].astype(np.int32)
    return DofMap(family, int(len(used)), conn, used.astype(np.int32), node_to_dof)
