"""GMV binary output.

Equivalent of the reference ``GMVWriter`` (GMVWriter.cpp:130-300): the
"ieeei4r8" binary GMV layout — 8-char keyword records, uint32 counts,
float64 payloads; cells written per element with 1-based connectivity;
node-centered variables (flag 1) for Lagrange families and cell-centered
(flag 0) for discontinuous families; a "METIS_DD" cell field records the
partition (here: the element shard id).

Host numpy, byte for byte the files of ``femus_tpu.io.gmv``; array
arguments may also be torch tensors on any device.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Optional

import numpy as np

from ..convert import to_numpy

# (linear cell name, quadratic cell name, n_lin, n_quad) per geometry —
# GMVWriter.cpp:175-215 (eltp table {8,4,6,4,3,2}/{20,10,15,8,6,3})
_GMV_CELLS = {
    "hex": ("phex8", "phex20", 8, 20),
    "tet": ("ptet4", "ptet10", 4, 10),
    "wedge": ("pprism6", "pprism15", 6, 15),
    "quad": ("quad", "8quad", 4, 8),
    "tri": ("tri", "6tri", 3, 6),
    "edge": ("line", "3line", 2, 3),
}


def _kw(f, word: str) -> None:
    f.write(struct.pack("8s", word.encode("ascii")))


def write_gmv(path: str, mesh, point_data: Optional[Dict] = None,
              cell_data: Optional[Dict] = None,
              order: str = "quadratic", partition=None) -> str:
    """Write one binary GMV file. ``point_data`` values are per-biquadratic-
    node arrays (use io.vtk.nodal_field to lift dof vectors)."""
    lin_name, quad_name, n_lin, n_quad = _GMV_CELLS[mesh.geom]
    use_quad = order != "linear"
    cname = quad_name if use_quad else lin_name
    npick = n_quad if use_quad else n_lin
    nvt = mesh.n_nodes
    nel = mesh.n_elems
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        _kw(f, "gmvinput")
        _kw(f, "ieeei4r8")
        # nodes: x-block, y-block, z-block of doubles (GMVWriter.cpp:139-169)
        _kw(f, "nodes")
        f.write(struct.pack("<I", nvt))
        for i in range(3):
            col = (mesh.coords[:, i] if i < mesh.dim
                   else np.zeros(nvt))
            f.write(np.ascontiguousarray(col, "<f8").tobytes())
        # cells: per-element keyword + nverts + 1-based ids (cpp:173-228)
        _kw(f, "cells")
        f.write(struct.pack("<I", nel))
        conn = (mesh.conn[:, :npick].astype("<u4") + 1)
        for e in range(nel):
            _kw(f, cname)
            f.write(struct.pack("<I", npick))
            f.write(conn[e].tobytes())
        # variables (cpp:230-300)
        _kw(f, "variable")
        _kw(f, "METIS_DD")
        f.write(struct.pack("<I", 0))
        part = to_numpy(partition) if partition is not None else np.zeros(nel)
        f.write(np.ascontiguousarray(part, "<f8").tobytes())
        for name, vals in (point_data or {}).items():
            _kw(f, name[:8])
            f.write(struct.pack("<I", 1))
            f.write(np.ascontiguousarray(to_numpy(vals), "<f8").tobytes())
        for name, vals in (cell_data or {}).items():
            _kw(f, name[:8])
            f.write(struct.pack("<I", 0))
            f.write(np.ascontiguousarray(to_numpy(vals), "<f8").tobytes())
        _kw(f, "endvars")
        _kw(f, "endgmv")
    return path


def read_gmv(path: str):
    """Minimal reader (round-trip testing): returns (coords, conn,
    point_data, cell_data)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != b"gmvinput":
        raise ValueError(f"{path}: not a GMV file")
    pos = 16  # skip gmvinput + ieeei4r8

    def kw(p):
        return raw[p:p + 8].rstrip(b"\x00 ").decode(), p + 8

    def expect(p, word):
        got, p = kw(p)
        if got != word:
            raise ValueError(f"{path}: expected {word!r}, found {got!r}")
        return p

    pos = expect(pos, "nodes")
    nvt = struct.unpack_from("<I", raw, pos)[0]
    pos += 4
    coords = np.frombuffer(raw, "<f8", 3 * nvt, pos).reshape(3, nvt).T.copy()
    pos += 3 * nvt * 8
    pos = expect(pos, "cells")
    nel = struct.unpack_from("<I", raw, pos)[0]
    pos += 4
    conn = []
    for _ in range(nel):
        _, pos = kw(pos)
        nv = struct.unpack_from("<I", raw, pos)[0]
        pos += 4
        conn.append(np.frombuffer(raw, "<u4", nv, pos).astype(np.int64) - 1)
        pos += 4 * nv
    pos = expect(pos, "variable")
    pd, cd = {}, {}
    while True:
        name, pos = kw(pos)
        if name in ("endvars", "endgmv"):
            break
        flag = struct.unpack_from("<I", raw, pos)[0]
        pos += 4
        n = nvt if flag == 1 else nel
        vals = np.frombuffer(raw, "<f8", n, pos).copy()
        pos += 8 * n
        (pd if flag == 1 else cd)[name] = vals
    return coords, np.asarray(conn), pd, cd


def _solution_fields(ml_sol, mesh, level: int, names):
    """(point data, cell data) of a MultiLevelSolution's variables at
    ``level``: disc_constant variables as cell data, every other family
    lifted to the biquadratic nodes (:func:`~.vtk.nodal_field`)."""
    from .vtk import nodal_field
    pd, cd = {}, {}
    for n in names:
        fam = ml_sol.vars[n].family
        sol = ml_sol.sol[level][n]
        if fam == "disc_constant":
            cd[n] = sol
        else:
            pd[n] = nodal_field(mesh, fam, sol)
    return pd, cd


class GMVWriter:
    """Writer facade bound to a MultiLevelSolution (Writer.hpp:44 factory)."""

    def __init__(self, ml_sol):
        self.ml_sol = ml_sol

    def write(self, out_dir: str, *var_names: str, level: int = -1,
              step: Optional[int] = None, order: str = "quadratic") -> str:
        mesh = self.ml_sol.ml_mesh.levels[level]
        names = var_names or tuple(self.ml_sol.vars)
        pd, cd = _solution_fields(self.ml_sol, mesh, level, names)
        tag = f"_{step:05d}" if step is not None else ""
        return write_gmv(os.path.join(out_dir, f"sol{tag}.gmv"), mesh,
                         point_data=pd, cell_data=cd, order=order)
