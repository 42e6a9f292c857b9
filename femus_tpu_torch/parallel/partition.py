"""Element partitioning for SPMD sharding.

The port's own copy of the JAX package's partitioner (host numpy; the
arrays equal its arrays).  Equivalent of the reference's METIS partition + reorder pipeline
(``Mesh::PartitionElements_and_FillDofMapAllFEFamilies`` Mesh.hpp:451,
MeshMetisPartitioning.cpp:41-99): elements get a shard id, then elements
AND nodes are permuted so every shard owns contiguous ranges — which is
exactly what the row-sharded dof layout (parallel/spmd.py, parallel/halo.py)
wants: contiguous slabs with minimal cross-shard (halo) columns.

Partitioners (``femus_tpu_torch.native``, C++ with the numpy recursions
where no C++ toolchain is present; ``PartitionInfo.impl`` records which
ran):
- "graph": BFS region growing + refinement over the element dual graph
- "rcb":   recursive coordinate bisection of centroids
- "contiguous": keep file order (the implicit default elsewhere)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..fe.geom import GEOMS
from ..mesh.mesh import BoundaryFaces, Mesh, elem_neighbors
from .. import native


@dataclasses.dataclass
class PartitionInfo:
    n_shards: int
    elem_shard: np.ndarray      # (ne,) shard of each (reordered) element
    elem_offsets: np.ndarray    # (n_shards+1,) contiguous element ranges
    node_shard: np.ndarray      # (nn,) owning shard of each (reordered) node
    edge_cut: int
    # hierarchical (DCN x ICI) partitions only: dual-graph edges crossing a
    # host (DCN) boundary vs crossing chips within a host (ICI)
    dcn_cut: int = -1
    ici_cut: int = -1
    # which implementation of the partitioner ran: "native" (g++ library)
    # or "numpy" (no C++ toolchain); the contiguous split needs neither
    impl: str = "native"


def _compute_part(mesh: Mesh, n_shards: int, method: str,
                  subset: np.ndarray = None) -> np.ndarray:
    """Shard id per element (optionally of a subset of elements)."""
    if subset is None:
        subset = np.arange(mesh.n_elems)
    ne = len(subset)
    if method == "contiguous" or n_shards == 1:
        return (np.arange(ne) * n_shards // ne).astype(np.int32)
    if method == "rcb":
        cent = mesh.coords[mesh.conn[subset, :GEOMS[mesh.geom].n_verts]].mean(axis=1)
        return native.rcb_partition(cent, n_shards)
    if method == "graph":
        nbr = elem_neighbors(mesh)[subset]
        if len(subset) != mesh.n_elems:
            # relabel neighbor ids into the subset; outside -> -1
            lookup = np.full(mesh.n_elems, -1, np.int64)
            lookup[subset] = np.arange(ne)
            nbr = np.where(nbr >= 0, lookup[np.maximum(nbr, 0)], -1)
        return native.greedy_graph_partition(nbr.astype(np.int32), n_shards)
    raise ValueError(f"unknown method '{method}'")


def partition_mesh(mesh: Mesh, n_shards: int, method: str = "rcb",
                   renumber_nodes: bool = True,
                   part: np.ndarray = None) -> Tuple[Mesh, PartitionInfo]:
    """Returns a reordered copy of ``mesh`` plus partition info.

    Elements are permuted shard-major; nodes (optionally) are renumbered by
    owning shard (owner = smallest shard of any adjacent element) so dof
    slabs are shard-contiguous like the reference's FillISvector node
    reorder (Mesh.hpp:504).  ``part`` overrides the computed shard ids
    (used by :func:`partition_mesh_hierarchical`)."""
    ne = mesh.n_elems
    if part is None:
        part = _compute_part(mesh, n_shards, method)

    perm = np.argsort(part, kind="stable")          # elements shard-major
    part_sorted = part[perm]
    offsets = np.searchsorted(part_sorted, np.arange(n_shards + 1))

    conn = mesh.conn[perm]
    group = mesh.elem_group[perm]
    lev = mesh.elem_level[perm] if mesh.elem_level is not None else None
    inv_perm = np.empty(ne, np.int64)
    inv_perm[perm] = np.arange(ne)

    coords = mesh.coords
    node_map = None
    if renumber_nodes:
        # owner shard of a node = smallest shard among adjacent elements
        nn = mesh.n_nodes
        owner = np.full(nn, n_shards, np.int32)
        for s in range(n_shards - 1, -1, -1):
            nodes_s = conn[offsets[s]:offsets[s + 1]].ravel()
            owner[nodes_s] = s
        node_map = np.argsort(owner, kind="stable")  # new order
        inv_node = np.empty(nn, np.int64)
        inv_node[node_map] = np.arange(nn)
        coords = mesh.coords[node_map]
        conn = inv_node[conn].astype(np.int32)
        node_shard = owner[node_map]
    else:
        node_shard = np.zeros(mesh.n_nodes, np.int32)

    out = Mesh(dim=mesh.dim, geom=mesh.geom, coords=coords, conn=conn,
               elem_group=group,
               parent_elem=(mesh.parent_elem[perm]
                            if mesh.parent_elem is not None else None),
               child_slot=(mesh.child_slot[perm]
                           if mesh.child_slot is not None else None),
               elem_level=lev,
               elem_material=(mesh.elem_material[perm]
                              if mesh.elem_material is not None else None))
    out.elem_shard = part_sorted.copy()
    # boundary faces: remap element ids and node ids
    out.boundary = {}
    for fg, bf in mesh.boundary.items():
        bconn = bf.conn
        if node_map is not None:
            bconn = inv_node[bconn].astype(np.int32)
        e_new = inv_perm[bf.elem].astype(np.int32)
        order = np.argsort(e_new, kind="stable")
        out.boundary[fg] = BoundaryFaces(
            face_geom=fg, elem=e_new[order], iface=bf.iface[order],
            group=bf.group[order], conn=bconn[order])

    cut = native.edge_cut(elem_neighbors(out), out.elem_shard)
    return out, PartitionInfo(n_shards=n_shards, elem_shard=out.elem_shard,
                              elem_offsets=offsets,
                              node_shard=node_shard, edge_cut=cut,
                              impl=native.impl())


def partition_mesh_hierarchical(mesh: Mesh, n_hosts: int, n_chips: int,
                                outer_method: str = "graph",
                                inner_method: str = "rcb",
                                renumber_nodes: bool = True,
                                ) -> Tuple[Mesh, PartitionInfo]:
    """Two-level ICI/DCN-aware partition (SURVEY.md §2.4 multi-host row).

    The reference scales with flat ``mpirun -n N`` over a homogeneous MPI
    world; a GPU cluster is not homogeneous: the cards of one node talk over
    NVLink (fast), nodes over the network (slow).  Elements are first split
    into ``n_hosts`` node groups minimizing the dual-graph cut (these edges
    become inter-node halo traffic, ``dcn_cut``), then each group is split
    into ``n_chips`` sub-shards, one per card of the node (intra-node halo,
    ``ici_cut``; the names are the JAX package's).  Final shard id =
    host * n_chips + chip is the global rank of a launch that numbers the
    cards of a node consecutively, so the halo plan's heavy exchanges stay
    inside a node.

    Returns the reordered mesh and PartitionInfo with ``dcn_cut``/``ici_cut``
    (dual-graph edges crossing nodes vs crossing cards within a node).
    """
    outer = _compute_part(mesh, n_hosts, outer_method)
    part = np.empty(mesh.n_elems, np.int32)
    for h in range(n_hosts):
        subset = np.nonzero(outer == h)[0]
        inner = _compute_part(mesh, n_chips, inner_method, subset=subset)
        part[subset] = h * n_chips + inner
    out, info = partition_mesh(mesh, n_hosts * n_chips,
                               renumber_nodes=renumber_nodes, part=part)
    nbr = elem_neighbors(out)
    ei, fi = np.nonzero(nbr >= 0)
    a = out.elem_shard[ei]
    b = out.elem_shard[nbr[ei, fi]]
    diff = a != b
    dcn = diff & (a // n_chips != b // n_chips)
    info.dcn_cut = int(dcn.sum()) // 2
    info.ici_cut = int((diff & ~dcn).sum()) // 2
    return out, info
