"""Locality-restoring mesh renumbering (host, setup time).

The reference gets dof locality implicitly: METIS partitioning plus
per-rank contiguous node renumbering (Mesh.hpp:504 FillISvector) keeps each
rank's rows adjacent.  Here locality is worth much more — the blocked-ELL
SpMV (algebra/bell.py) converts sparsity into dense (tile x 128-lane)
blocks, and its slab density is set entirely by how close a node's
neighbors sit in the numbering.  ``rcm_reorder`` renumbers mesh NODES by
reverse Cuthill-McKee over the node-adjacency graph and reorders ELEMENTS
by their first (lowest-numbered) node, so every downstream dof map
(dofmap.py numbers Lagrange dofs in node order) inherits the locality with
zero runtime cost — no permutation gathers in any kernel.

Composes with refinement (lineage arrays are carried through) and with
partitioning (partition_mesh reorders shard-major afterwards; RCM then
still orders nodes *within* each shard's slab since the shard reorder is a
stable sort).
"""
from __future__ import annotations

import numpy as np

from .mesh import BoundaryFaces, Mesh


def node_rcm_permutation(mesh: Mesh) -> np.ndarray:
    """(n_nodes,) RCM ordering of the node graph: perm[new] = old node."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    ne, nbq = mesh.conn.shape
    # node-node adjacency: all pairs within an element (biquadratic conn
    # covers every family's couplings)
    r = np.repeat(mesh.conn, nbq, axis=1).ravel()
    c = np.tile(mesh.conn, (1, nbq)).ravel()
    a = sp.csr_matrix((np.ones(len(r), np.int8), (r, c)),
                      shape=(mesh.n_nodes, mesh.n_nodes))
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True),
                      dtype=np.int64)


def reorder_mesh(mesh: Mesh, node_perm: np.ndarray,
                 elem_perm: np.ndarray = None,
                 return_perms: bool = False):
    """Renumbered copy of ``mesh``: node i_new = node_perm[i_new] (old id);
    elements optionally permuted (default: sorted by lowest new node id).
    With ``return_perms`` also returns (elem_perm, node_perm)."""
    inv_node = np.empty(mesh.n_nodes, np.int64)
    inv_node[node_perm] = np.arange(mesh.n_nodes)
    conn = inv_node[mesh.conn].astype(np.int32)
    if elem_perm is None:
        elem_perm = np.argsort(conn.min(axis=1), kind="stable")
    conn = conn[elem_perm]
    inv_elem = np.empty(mesh.n_elems, np.int64)
    inv_elem[elem_perm] = np.arange(mesh.n_elems)

    out = Mesh(
        dim=mesh.dim, geom=mesh.geom, coords=mesh.coords[node_perm],
        conn=conn, elem_group=mesh.elem_group[elem_perm],
        parent_elem=(mesh.parent_elem[elem_perm]
                     if mesh.parent_elem is not None else None),
        child_slot=(mesh.child_slot[elem_perm]
                    if mesh.child_slot is not None else None),
        elem_level=(mesh.elem_level[elem_perm]
                    if mesh.elem_level is not None else None),
        elem_material=(mesh.elem_material[elem_perm]
                       if mesh.elem_material is not None else None))
    if mesh.elem_shard is not None:
        out.elem_shard = mesh.elem_shard[elem_perm]
    for fg, bf in mesh.boundary.items():
        e_new = inv_elem[bf.elem].astype(np.int32)
        order = np.argsort(e_new, kind="stable")
        out.boundary[fg] = BoundaryFaces(
            face_geom=fg, elem=e_new[order], iface=bf.iface[order],
            group=bf.group[order],
            conn=inv_node[bf.conn].astype(np.int32)[order])
    if return_perms:
        return out, elem_perm, node_perm
    return out


def rcm_reorder(mesh: Mesh) -> Mesh:
    """Mesh with RCM-local node numbering (see module docstring)."""
    return reorder_mesh(mesh, node_rcm_permutation(mesh))


def rcm_reorder_hierarchy(ml_mesh) -> None:
    """RCM-renumber every level of a :class:`MultiLevelMesh` IN PLACE,
    keeping refinement lineage consistent: level l+1's ``parent_elem``
    references are rewritten through level l's element permutation before
    l+1 itself is reordered, so prolongation (algebra/transfer.py) sees the
    same parent/child pairing.  Call after ``MultiLevelMesh`` construction
    and before any MultiLevelSolution / System setup."""
    import dataclasses as _dc

    prev_inv_elem = None
    for i, mesh in enumerate(ml_mesh.levels):
        if prev_inv_elem is not None and mesh.parent_elem is not None:
            mesh = _dc.replace(
                mesh,
                parent_elem=prev_inv_elem[mesh.parent_elem].astype(np.int32))
        new, eperm, _ = reorder_mesh(mesh, node_rcm_permutation(mesh),
                                     return_perms=True)
        prev_inv_elem = np.empty(mesh.n_elems, np.int64)
        prev_inv_elem[eperm] = np.arange(mesh.n_elems)
        ml_mesh.levels[i] = new
