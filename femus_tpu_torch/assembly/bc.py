"""Boundary-condition bookkeeping.

Reference semantics (MultiLevelSolution::GenerateBdc, MultiLevelSolution.cpp:
725-835): every dof gets a Bdc code — 2 interior, 1 on a non-essential
(Neumann) face, 0 essential/Dirichlet with the value written into the
solution vector; rows with code < 1.5 are eliminated in the solver
(LinearEquationSolverPetsc BuildBdcIndex).  Here the same codes live in a
small host-side struct per unknown; the assembler consumes the combined
Dirichlet mask, and Dirichlet values are written into the solution vector
before each solve.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

from ..fe.geom import GEOMS
from .engine import Assembler

INTERIOR, NEUMANN_FACE, DIRICHLET = 2, 1, 0


def generate_bdc(assembler: Assembler, bc_fn: Callable, time: float = 0.0):
    """Fill Bdc codes + Dirichlet values for all unknowns of an assembler.

    bc_fn(var_name, x (dim,), group:int, time) -> (is_dirichlet: bool,
    value: float) — mirroring the reference's SetBoundaryCondition callback
    signature (MultiLevelSolution.cpp:640).

    Returns dict var -> (codes (n_dofs_var,), values (n_dofs_var,)); also sets
    assembler.dirichlet_mask.
    """
    mesh = assembler.mesh
    out: Dict[str, tuple] = {}
    mask = np.zeros(assembler.n_dofs, bool)
    values = np.zeros(assembler.n_dofs)
    _finalize = assembler.set_dirichlet
    for unk in assembler.unknowns:
        dm = assembler.dofmaps[unk.name]
        codes = np.full(dm.n_dofs, INTERIOR, np.int8)
        vals = np.zeros(dm.n_dofs)
        if unk.family in ("disc_constant", "disc_linear"):
            out[unk.name] = (codes, vals)
            continue
        off = assembler.offsets[unk.name]
        for bf in mesh.boundary.values():
            fgeom = bf.face_geom
            for r in range(len(bf.elem)):
                grp = int(bf.group[r])
                # face nodes restricted to this family
                fam_local = GEOMS[fgeom].family_nodes.get(
                    unk.family, GEOMS[fgeom].family_nodes["serendipity"])
                nn = bf.conn[r]
                nvf = GEOMS[fgeom].n_verts
                fam_nodes = nn[fam_local] if len(fam_local) <= len(nn) else nn
                for node in fam_nodes:
                    d = dm.node_to_dof[node]
                    if d < 0:
                        continue
                    x = mesh.coords[node]
                    is_dir, val = bc_fn(unk.name, x, grp, time)
                    if is_dir:
                        codes[d] = DIRICHLET
                        vals[d] = val
                        mask[off + d] = True
                        values[off + d] = val
                    elif codes[d] == INTERIOR:
                        codes[d] = NEUMANN_FACE
        out[unk.name] = (codes, vals)
    _finalize(mask, values)
    return out


def apply_dirichlet_values(assembler: Assembler, u: np.ndarray) -> np.ndarray:
    """Write Dirichlet values into the stacked solution vector."""
    vals = assembler.dirichlet_values
    u = np.array(u, dtype=np.float64)
    u[assembler.dirichlet_mask] = vals[assembler.dirichlet_mask]
    return u
