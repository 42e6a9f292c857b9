"""Debug aids: matrix dumps, per-iteration field dumps, element-Jacobian
printer.

Reference equivalents:
- ``SparseMatrix::print_matlab / PrintMatlab`` (SparseMatrix.hpp /
  PetscMatrix.cpp matrix viewers) -> :func:`save_matrix_market` /
  :func:`op_to_scipy` (inspect in scipy, spy-plot, condition-number checks).
- ``assemble_jacobian::print_element_jacobian / print_element_residual``
  (Assemble_jacobian.hpp:78-107) -> :func:`element_jacobian` /
  :func:`print_element_jacobian` — one element's local residual and exact
  forward-mode Jacobian from the batched engine, for eyeball comparison.
- the reference's per-nonlinear-iteration solution printing
  (``mlSol.GetWriter()->Write(...)`` inside assembly debug branches) ->
  :class:`FieldDumper`, a System hook writing numbered VTK snapshots.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..convert import to_numpy


# ---------------------------------------------------------------------------
# matrix dumps
# ---------------------------------------------------------------------------

def op_to_scipy(pattern, data, n: Optional[int] = None):
    """ELL (pattern, data) -> scipy CSR, trimmed to the first n rows/cols
    (drop padding).  Works on any assembler's pattern + assembled data
    (a tensor on any device, or a host array)."""
    import scipy.sparse as sp
    w = pattern.width
    rows = np.repeat(np.arange(pattern.n_rows), w)
    cols = np.asarray(pattern.cols).ravel()
    vals = to_numpy(data).ravel()
    valid = np.asarray(pattern.valid).ravel()
    m = sp.csr_matrix((vals[valid], (rows[valid], cols[valid])),
                      shape=(pattern.n_rows, pattern.n_rows))
    if n is not None:
        m = m[:n, :n]
    return m


def save_matrix_market(path: str, pattern, data,
                       n: Optional[int] = None) -> str:
    """Dump an assembled operator to MatrixMarket .mtx (the portable
    analogue of the reference's PETSc matrix viewers)."""
    import scipy.io as sio
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sio.mmwrite(path, op_to_scipy(pattern, data, n))
    return path if path.endswith(".mtx") else path + ".mtx"


# ---------------------------------------------------------------------------
# element Jacobian / residual printer
# ---------------------------------------------------------------------------

def element_jacobian(assembler, u, elem: int, aux_fields=None,
                     aux_scalars=None):
    """(local residual, local Jacobian, global dof ids) of one element.

    The exact element Jacobian the batched engine integrates — the
    analogue of the reference's adept-tape per-element printout
    (Assemble_jacobian.hpp:78-107): ``torch.func.jacfwd`` of the engine's
    element residual (``Assembler._element_fn``, element-last or
    batch-first as the form says) on that element's gathered dofs, run as
    a batch of one element.  ``u`` and the ``aux_fields`` are global
    vectors (tensors or host arrays); the results are host arrays."""
    dev, dt = assembler.device, assembler.dtype
    t = dict(assembler.device_tables_cached())
    sel = torch.tensor([elem], dtype=torch.int64, device=dev)
    for key in ("elem_group", "edofs", "coords_e"):
        t[key] = t[key][sel]
    t["aux_conn"] = {k: v[sel] for k, v in t["aux_conn"].items()}
    aux = {name: torch.as_tensor(to_numpy(v), dtype=dt, device=dev)
           for name, v in (aux_fields or {}).items()}
    all_elems = assembler._element_fn(t, aux_scalars or {}, aux)
    edofs = np.asarray(assembler.edofs)[elem]           # (ndt,)

    def local_residual(ul):
        return all_elems(ul[:, None])[:, 0]

    ul = torch.as_tensor(to_numpy(u), dtype=dt, device=dev)[
        torch.as_tensor(edofs, device=dev)]
    r = local_residual(ul)
    J = torch.func.jacfwd(local_residual)(ul)
    return to_numpy(r), to_numpy(J), edofs


def print_element_jacobian(assembler, u, elem: int, aux_fields=None,
                           aux_scalars=None, precision: int = 3) -> str:
    r, J, edofs = element_jacobian(assembler, u, elem, aux_fields, aux_scalars)
    with np.printoptions(precision=precision, suppress=True, linewidth=200):
        txt = (f"element {elem}: dofs {edofs.tolist()}\n"
               f"residual:\n{r}\njacobian:\n{J}\n")
    print(txt)
    return txt


# ---------------------------------------------------------------------------
# per-iteration field dumps
# ---------------------------------------------------------------------------

class FieldDumper:
    """Writes a numbered VTK snapshot of every unknown each time ``dump`` is
    called (attach around nonlinear iterations / time steps); files land as
    ``<dir>/<name>.<k:04d>.vtu``."""

    def __init__(self, system, out_dir: str, name: str = "iter"):
        self.system = system
        self.dir = out_dir
        self.name = name
        self.k = 0
        os.makedirs(out_dir, exist_ok=True)

    def dump(self, level: int = -1) -> str:
        from ..io.vtk import nodal_field, write_vtu
        mesh = self.system.ml_mesh.levels[level]
        ml_sol = self.system.ml_sol
        pd: Dict[str, np.ndarray] = {}
        for n in self.system.unknown_names:
            fam = ml_sol.vars[n].family
            pd[n] = nodal_field(mesh, fam, ml_sol.sol[level][n])
        path = os.path.join(self.dir, f"{self.name}.{self.k:04d}.vtu")
        self.k += 1
        return write_vtu(path, mesh, pd)
