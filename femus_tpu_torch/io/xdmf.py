"""XDMF + HDF5 output (light XML metadata, heavy arrays in .h5).

Equivalent of the reference ``XDMFWriter`` (XDMFWriter.hpp:42; 3091 LoC of
XML+HDF5 plumbing): topology/geometry/attributes live in an HDF5 file, the
.xmf XML describes shapes and dtypes so ParaView/VisIt stream the heavy data.
Supports time series via a temporal Grid collection (one Grid per step
appended by :meth:`XDMFWriter.write_series`).

Host numpy, the files of ``femus_tpu.io.xdmf``; array arguments may also be
torch tensors on any device.  ``h5py`` is imported by the functions that
write or read the heavy data, never by importing this module (a machine
without h5py imports the package and uses the other writers).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..convert import to_numpy
from .gmv import _solution_fields

# XDMF TopologyType per geometry at linear / quadratic(serendipity) /
# biquadratic order; node count per cell.
_XDMF_TOPO = {
    "edge": [("Polyline", 2), ("Edge_3", 3), ("Edge_3", 3)],
    "tri": [("Triangle", 3), ("Triangle_6", 6), ("Triangle_6", 6)],
    "quad": [("Quadrilateral", 4), ("Quadrilateral_8", 8),
             ("Quadrilateral_9", 9)],
    "tet": [("Tetrahedron", 4), ("Tetrahedron_10", 10),
            ("Tetrahedron_10", 10)],
    "hex": [("Hexahedron", 8), ("Hexahedron_20", 20), ("Hexahedron_27", 27)],
    "wedge": [("Wedge", 6), ("Wedge_15", 15), ("Wedge_15", 15)],
}
_ORDER_IDX = {"linear": 0, "serendipity": 1, "quadratic": 1, "biquadratic": 2}


def _grid_xml(name: str, h5name: str, mesh, fields: Dict[str, str],
              order: str, time: Optional[float] = None) -> str:
    topo, npick = _XDMF_TOPO[mesh.geom][_ORDER_IDX[order]]
    gdim = 3 if mesh.dim == 3 else 2
    geom_type = "XYZ" if gdim == 3 else "XY"
    lines = [f'<Grid Name="{name}">']
    if time is not None:
        lines.append(f'<Time Value="{time}"/>')
    lines += [
        f'<Topology TopologyType="{topo}" NumberOfElements="{mesh.n_elems}">',
        f'<DataItem Dimensions="{mesh.n_elems} {npick}" NumberType="Int" '
        f'Format="HDF">{h5name}:/{name}/connectivity</DataItem>',
        '</Topology>',
        f'<Geometry GeometryType="{geom_type}">',
        f'<DataItem Dimensions="{mesh.n_nodes} {gdim}" Format="HDF">'
        f'{h5name}:/{name}/coords</DataItem>',
        '</Geometry>',
    ]
    for fname, center in fields.items():
        n = mesh.n_nodes if center == "Node" else mesh.n_elems
        lines += [
            f'<Attribute Name="{fname}" AttributeType="Scalar" Center="{center}">',
            f'<DataItem Dimensions="{n}" Format="HDF">'
            f'{h5name}:/{name}/{fname}</DataItem>',
            '</Attribute>',
        ]
    lines.append('</Grid>')
    return "\n".join(lines)


def _write_h5_grid(h5, name: str, mesh, order: str,
                   point_data: Dict, cell_data: Dict) -> None:
    _, npick = _XDMF_TOPO[mesh.geom][_ORDER_IDX[order]]
    g = h5.create_group(name)
    gdim = 3 if mesh.dim == 3 else 2
    coords = np.zeros((mesh.n_nodes, gdim))
    coords[:, :mesh.dim] = mesh.coords
    g.create_dataset("coords", data=coords)
    g.create_dataset("connectivity", data=mesh.conn[:, :npick].astype(np.int64))
    for fname, vals in point_data.items():
        g.create_dataset(fname, data=to_numpy(vals).astype(float))
    for fname, vals in cell_data.items():
        g.create_dataset(fname, data=to_numpy(vals).astype(float))


def write_xdmf(path: str, mesh, point_data: Optional[Dict] = None,
               cell_data: Optional[Dict] = None,
               order: str = "biquadratic") -> str:
    """Write ``path``.xmf + ``path``.h5 for a single grid."""
    import h5py
    point_data = point_data or {}
    cell_data = cell_data or {}
    base = path[:-4] if path.endswith(".xmf") else path
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    h5path = base + ".h5"
    with h5py.File(h5path, "w") as h5:
        _write_h5_grid(h5, "mesh0", mesh, order, point_data, cell_data)
    fields = {k: "Node" for k in point_data}
    fields.update({k: "Cell" for k in cell_data})
    xml = ('<?xml version="1.0"?>\n<Xdmf Version="3.0">\n<Domain>\n'
           + _grid_xml("mesh0", os.path.basename(h5path), mesh, fields, order)
           + '\n</Domain>\n</Xdmf>\n')
    with open(base + ".xmf", "w") as f:
        f.write(xml)
    return base + ".xmf"


def read_xdmf_h5(path: str):
    """Read back the heavy data (round-trip testing / restart)."""
    import h5py
    base = path[:-4] if path.endswith(".xmf") else path
    out = {}
    with h5py.File(base + ".h5", "r") as h5:
        for gname in h5:
            out[gname] = {k: np.asarray(h5[gname][k]) for k in h5[gname]}
    return out


class XDMFWriter:
    """Writer facade + time-series support (reference XDMFWriter transient
    prints, one Grid per step in a temporal collection)."""

    def __init__(self, ml_sol):
        self.ml_sol = ml_sol
        self._steps: List[str] = []

    def write(self, out_dir: str, *var_names: str, level: int = -1,
              step: Optional[int] = None, order: str = "biquadratic") -> str:
        mesh = self.ml_sol.ml_mesh.levels[level]
        names = var_names or tuple(self.ml_sol.vars)
        pd, cd = _solution_fields(self.ml_sol, mesh, level, names)
        tag = f"_{step:05d}" if step is not None else ""
        return write_xdmf(os.path.join(out_dir, f"sol{tag}.xmf"), mesh,
                          point_data=pd, cell_data=cd, order=order)

    def write_series(self, out_dir: str, *var_names: str, level: int = -1,
                     time: float = 0.0, order: str = "biquadratic") -> str:
        """Append one timestep grid and rewrite the temporal master .xmf."""
        import h5py
        mesh = self.ml_sol.ml_mesh.levels[level]
        names = var_names or tuple(self.ml_sol.vars)
        pd, cd = _solution_fields(self.ml_sol, mesh, level, names)
        os.makedirs(out_dir, exist_ok=True)
        h5path = os.path.join(out_dir, "series.h5")
        gname = f"t{len(self._steps):05d}"
        with h5py.File(h5path, "a") as h5:
            _write_h5_grid(h5, gname, mesh, order, pd, cd)
        fields = {k: "Node" for k in pd}
        fields.update({k: "Cell" for k in cd})
        self._steps.append(_grid_xml(gname, "series.h5", mesh, fields, order,
                                     time=time))
        master = os.path.join(out_dir, "series.xmf")
        with open(master, "w") as f:
            f.write('<?xml version="1.0"?>\n<Xdmf Version="3.0">\n<Domain>\n'
                    '<Grid Name="TimeSeries" GridType="Collection" '
                    'CollectionType="Temporal">\n'
                    + "\n".join(self._steps)
                    + '\n</Grid>\n</Domain>\n</Xdmf>\n')
        return master
