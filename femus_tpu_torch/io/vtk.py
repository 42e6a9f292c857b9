"""VTK XML output (.vtu, .pvtu).

Equivalent of the reference's ``VTKWriter`` (VTKWriter.cpp:459-500: per-rank
base64 binary .vtu + master .pvtu; Writer factory Writer.hpp:44-61), writing
base64 payloads so files stay compact.  Linear, serendipity and
biquadratic output meshes: the standard VTK quadratic cell types are
emitted when the family is quadratic.

Host numpy, byte for byte the files of ``femus_tpu.io.vtk``; every array
argument may also be a torch tensor on any device (it is copied to the
host first).
"""
from __future__ import annotations

import base64
import os
import struct
import types
from typing import Dict, Optional, Sequence

import numpy as np

from ..convert import to_numpy

# VTK cell types: (geom, family-order) -> type id + node pick order (ours -> VTK)
_VTK_LINEAR = {
    "edge": (3, [0, 1]),
    "tri": (5, [0, 1, 2]),
    "quad": (9, [0, 1, 2, 3]),
    "tet": (10, [0, 1, 2, 3]),
    "hex": (12, [0, 1, 2, 3, 4, 5, 6, 7]),
    "wedge": (13, [0, 1, 2, 3, 4, 5]),
}
_VTK_QUADRATIC = {
    "edge": (21, [0, 1, 2]),
    "tri": (22, [0, 1, 2, 3, 4, 5]),
    "quad": (23, [0, 1, 2, 3, 4, 5, 6, 7]),            # quad8
    "tet": (24, [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]),
    "hex": (25, [0, 1, 2, 3, 4, 5, 6, 7,               # hex20
                 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19]),
    "wedge": (26, [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14]),  # wedge15
}
_VTK_BIQUADRATIC = {
    "quad": (28, [0, 1, 2, 3, 4, 5, 6, 7, 8]),         # biquadratic quad9
    "hex": (29, list(range(20)) + [22, 24, 21, 23, 20, 25, 26]),  # triquadratic hex27
}


def _b64(arr: np.ndarray) -> str:
    raw = arr.tobytes()
    header = struct.pack("<I", len(raw))
    return base64.b64encode(header + raw).decode("ascii")


def _data_array(name: str, arr: np.ndarray, n_comp: int = 1) -> str:
    typ = {np.dtype(np.float32): "Float32", np.dtype(np.float64): "Float64",
           np.dtype(np.int32): "Int32", np.dtype(np.int64): "Int64",
           np.dtype(np.uint8): "UInt8"}[arr.dtype]
    comp = f' NumberOfComponents="{n_comp}"' if n_comp > 1 else ""
    return (f'<DataArray type="{typ}" Name="{name}"{comp} format="binary">\n'
            f"{_b64(arr)}\n</DataArray>\n")


def write_vtu(path: str, mesh, point_data: Optional[Dict] = None,
              cell_data: Optional[Dict] = None,
              order: str = "biquadratic") -> str:
    """Write one mesh level + nodal fields to a .vtu file.

    point_data values must be per-biquadratic-node (use
    ``nodal_field`` to lift a dof vector of any family to nodes).
    """
    geom = mesh.geom
    if order == "linear" or geom not in _VTK_QUADRATIC:
        ctype, pick = _VTK_LINEAR[geom]
    elif order == "biquadratic" and geom in _VTK_BIQUADRATIC:
        ctype, pick = _VTK_BIQUADRATIC[geom]
    else:
        ctype, pick = _VTK_QUADRATIC[geom]
    conn = mesh.conn[:, pick].astype(np.int64)
    npts, ncell = mesh.n_nodes, mesh.n_elems
    pts = np.zeros((npts, 3))
    pts[:, :mesh.dim] = mesh.coords
    offsets = np.arange(1, ncell + 1, dtype=np.int64) * conn.shape[1]
    cell_types = np.full(ncell, ctype, np.uint8)

    parts = [f'<?xml version="1.0"?>\n'
             f'<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n'
             f'<UnstructuredGrid>\n<Piece NumberOfPoints="{npts}" NumberOfCells="{ncell}">\n']
    parts.append("<Points>\n" + _data_array("Points", pts.astype(np.float32).ravel(), 3)
                 + "</Points>\n")
    parts.append("<Cells>\n"
                 + _data_array("connectivity", conn.ravel())
                 + _data_array("offsets", offsets)
                 + _data_array("types", cell_types)
                 + "</Cells>\n")
    if point_data:
        parts.append("<PointData>\n")
        for name, arr in point_data.items():
            arr = to_numpy(arr)
            nc = 1 if arr.ndim == 1 else arr.shape[1]
            parts.append(_data_array(name, arr.astype(np.float32).ravel(), nc))
        parts.append("</PointData>\n")
    if cell_data:
        parts.append("<CellData>\n")
        for name, arr in cell_data.items():
            parts.append(_data_array(name, to_numpy(arr).astype(np.float32).ravel()))
        parts.append("</CellData>\n")
    parts.append("</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("".join(parts))
    return path


def write_pvtu(path: str, piece_files: Sequence[str],
               point_fields: Sequence[str]) -> str:
    """Master file referencing per-shard pieces (reference VTKWriter .pvtu)."""
    parts = ['<?xml version="1.0"?>\n'
             '<VTKFile type="PUnstructuredGrid" version="0.1" byte_order="LittleEndian">\n'
             '<PUnstructuredGrid GhostLevel="0">\n'
             '<PPoints><PDataArray type="Float32" NumberOfComponents="3"/></PPoints>\n'
             '<PPointData>\n']
    for name in point_fields:
        parts.append(f'<PDataArray type="Float32" Name="{name}"/>\n')
    parts.append("</PPointData>\n")
    for pf in piece_files:
        parts.append(f'<Piece Source="{os.path.basename(pf)}"/>\n')
    parts.append("</PUnstructuredGrid>\n</VTKFile>\n")
    with open(path, "w") as f:
        f.write("".join(parts))
    return path


def write_parallel(prefix: str, mesh, elem_shard,
                   point_data: Optional[Dict] = None,
                   cell_data: Optional[Dict] = None,
                   order: str = "biquadratic") -> str:
    """Per-shard ``<prefix>_<s>.vtu`` pieces + master ``<prefix>.pvtu``.

    The reference writes one .vtu per MPI rank plus a master .pvtu from
    proc 0 (VTKWriter.cpp:459-500); here the decomposition is an element
    shard array, such as ``PartitionInfo.elem_shard`` of
    :func:`femus_tpu_torch.parallel.partition.partition_mesh`.  Interface
    nodes shared by two shards are duplicated into each piece
    (GhostLevel=0, standard VTK practice).  Returns the .pvtu path.
    """
    elem_shard = to_numpy(elem_shard)
    point_data = {k: to_numpy(v) for k, v in (point_data or {}).items()}
    cell_data = {k: to_numpy(v) for k, v in (cell_data or {}).items()}
    pieces = []
    for s in np.unique(elem_shard):
        sel = elem_shard == s
        conn_s = mesh.conn[sel]
        nodes, conn_local = np.unique(conn_s, return_inverse=True)
        piece = types.SimpleNamespace(
            geom=mesh.geom, dim=mesh.dim,
            coords=mesh.coords[nodes],
            conn=conn_local.reshape(conn_s.shape).astype(np.int32),
            n_nodes=len(nodes), n_elems=int(sel.sum()))
        pd = {k: v[nodes] for k, v in point_data.items()} or None
        cd = {k: v[sel] for k, v in cell_data.items()} or None
        pieces.append(write_vtu(f"{prefix}_{int(s):04d}.vtu", piece,
                                pd, cd, order=order))
    return write_pvtu(f"{prefix}.pvtu", pieces, list(point_data))


def nodal_field(mesh, family: str, dofs) -> np.ndarray:
    """Lift a dof vector of any FE family to per-biquadratic-node values for
    output (lower-order Lagrange: interpolate; disc: paint element value)."""
    from ..fe.basis import get_basis
    from ..fe.geom import GEOMS
    dofs = to_numpy(dofs)
    g = GEOMS[mesh.geom]
    out = np.zeros(mesh.n_nodes)
    dm = mesh.dofmap(family)
    if family == "biquadratic":
        out[dm.nodes] = dofs
        return out
    if family in ("linear", "serendipity"):
        # evaluate the family's basis at all biquadratic ref nodes
        b = get_basis(mesh.geom, family)
        W = np.asarray(b.eval(g.ref_nodes))                # (n_bq, nd_fam)
        vals = np.einsum("bn,en->eb", W, dofs[dm.conn])    # (ne, n_bq)
        out[mesh.conn.ravel()] = vals.ravel()              # last write wins
        return out
    if family == "disc_constant":
        vals = np.repeat(dofs[:, None], g.n_nodes_bq, axis=1)
        out[mesh.conn.ravel()] = vals.ravel()
        return out
    # disc_linear: coefficients at element frame
    b = get_basis(mesh.geom, family)
    W = np.asarray(b.eval(g.ref_nodes))                    # (n_bq, 1+dim)
    vals = np.einsum("bn,en->eb", W, dofs.reshape(mesh.n_elems, -1))
    out[mesh.conn.ravel()] = vals.ravel()
    return out


class VTKWriter:
    """Writer facade bound to a MultiLevelSolution (reference Writer::build +
    VTKWriter::Write)."""

    def __init__(self, ml_sol):
        self.ml_sol = ml_sol

    def write(self, out_dir: str, *var_names: str, level: int = -1,
              step: Optional[int] = None, order: str = "biquadratic") -> str:
        mesh = self.ml_sol.ml_mesh.levels[level]
        names = var_names or tuple(self.ml_sol.vars)
        pd = {n: nodal_field(mesh, self.ml_sol.vars[n].family,
                             self.ml_sol.sol[level][n]) for n in names}
        tag = f"_{step:05d}" if step is not None else ""
        path = os.path.join(out_dir, f"sol{tag}.vtu")
        return write_vtu(path, mesh, point_data=pd, order=order)
