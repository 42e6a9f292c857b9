"""Inter-mesh FE projection (interpolation) matrices for postprocessing.

Reference: ``fe_projection_matrices_Lagrange_continuous``
(src/06_mesh/00_single_level/01_input/fe_projection_matrices_Lagrange_
continuous.*, SURVEY.md §2.1 FE_Prolongation row) — projection of a solution
between two UNRELATED meshes (no refinement lineage), e.g. sampling a
solution onto a postprocessing grid or transferring between independently
generated discretizations.

Design: each destination dof carrier point is located in the source mesh
with the marker machinery on the device (nearest-centroid guess + neighbor
walk + inverse isoparametric Newton — particles/markers.locate, the
reference's ``Marker::GetElementSerial`` / ``InverseMappingTEST``), then the
source basis is evaluated at the local coordinates on the device: row i of
the matrix holds the source element's shape values.  The matrix itself is
assembled once on the host (scipy CSR, set-up time) and applied as an
ordinary SpMV.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from .. import resolve_device
from .mesh import Mesh


def projection_matrix(src_mesh: Mesh, src_family: str,
                      dst_mesh: Mesh, dst_family: Optional[str] = None,
                      outside: str = "zero", device="cuda") -> sp.csr_matrix:
    """(n_dst_dofs, n_src_dofs) interpolation matrix between two meshes.

    ``outside``: "zero" leaves rows of destination points that fall outside
    the source mesh empty; "nearest" keeps the nearest element's clamped
    evaluation (the walk's final element).  Lagrange (continuous) families
    only — element-wise (disc) fields have no point values to interpolate.
    The point location and the basis evaluation run on ``device`` in
    float64."""
    from ..particles.markers import GeoTables, MarkerCloud, PointBasis, locate

    device = resolve_device(device)
    dst_family = dst_family or src_family
    assert not src_family.startswith("disc"), "Lagrange families only"
    dm_src = src_mesh.dofmap(src_family)
    dm_dst = dst_mesh.dofmap(dst_family)
    pts = dst_mesh.node_coords_of(dst_family)

    cloud = MarkerCloud(src_mesh, np.asarray(pts, np.float64).copy(),
                        np.zeros(len(pts), np.int64))
    locate(cloud, device=device)
    inside = cloud.elem >= 0
    e_safe = np.maximum(cloud.elem, 0)

    geo = GeoTables(src_mesh, device, torch.float64)
    e = torch.as_tensor(e_safe, device=device)
    xi = geo.inverse(geo.elem_coords(e),
                     torch.as_tensor(cloud.x, dtype=torch.float64,
                                     device=device), iters=10)
    phi = PointBasis(src_mesh.geom, src_family, device, torch.float64
                     ).eval(xi).cpu().numpy()
    nd = phi.shape[1]
    rows = np.repeat(np.arange(dm_dst.n_dofs), nd)
    cols = dm_src.conn[e_safe].ravel()
    vals = phi.ravel()
    if outside == "zero":
        keep = np.repeat(inside, nd)
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    M = sp.csr_matrix((vals, (rows, cols)),
                      shape=(dm_dst.n_dofs, dm_src.n_dofs))
    M.sum_duplicates()
    M.eliminate_zeros()
    return M


def project(src_mesh: Mesh, src_family: str, values: np.ndarray,
            dst_mesh: Mesh, dst_family: Optional[str] = None,
            outside: str = "zero", device="cuda") -> np.ndarray:
    """Interpolate a nodal field onto another mesh's dof carriers."""
    M = projection_matrix(src_mesh, src_family, dst_mesh, dst_family,
                          outside=outside, device=device)
    return np.asarray(M @ np.asarray(values))
