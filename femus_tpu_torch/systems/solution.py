"""Multilevel named solution fields.

Equivalent of ``MultiLevelSolution``/``Solution`` (MultiLevelSolution.hpp:44,
Solution.hpp:48): named variables with (FE family, time order), per-level dof
vectors (_Sol/_SolOld), initialization by function, boundary-condition code
generation (Bdc 0/1/2 convention, MultiLevelSolution.cpp:725-835).

Storage is host numpy (setup/bookkeeping); systems move stacked vectors to
the device for each solve step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from ..fe.geom import GEOMS
from ..mesh.multilevel import MultiLevelMesh

INTERIOR, NEUMANN_FACE, DIRICHLET = 2, 1, 0


@dataclasses.dataclass
class SolutionVar:
    name: str
    family: str = "biquadratic"
    time_order: int = 0          # 0 steady, 1 has _SolOld (reference AddSolution)


class MultiLevelSolution:
    def __init__(self, ml_mesh: MultiLevelMesh):
        self.ml_mesh = ml_mesh
        self.vars: Dict[str, SolutionVar] = {}
        # per level: var -> arrays
        self.sol: List[Dict[str, np.ndarray]] = [dict() for _ in ml_mesh.levels]
        self.sol_old: List[Dict[str, np.ndarray]] = [dict() for _ in ml_mesh.levels]
        self.bdc: List[Dict[str, np.ndarray]] = [dict() for _ in ml_mesh.levels]
        self.bdc_value: List[Dict[str, np.ndarray]] = [dict() for _ in ml_mesh.levels]
        self._bc_fn: Optional[Callable] = None

    def add_solution(self, name: str, family: str = "biquadratic",
                     time_order: int = 0) -> None:
        self.vars[name] = SolutionVar(name, family, time_order)
        for l, mesh in enumerate(self.ml_mesh.levels):
            n = mesh.dofmap(family).n_dofs
            self.sol[l][name] = np.zeros(n)
            if time_order > 0:
                self.sol_old[l][name] = np.zeros(n)

    def n_dofs(self, name: str, level: int = -1) -> int:
        return self.sol[level][name].shape[0]

    def initialize(self, name: str, fn: Optional[Callable] = None) -> None:
        """fn(x: (n, dim)) -> values at dof carriers; default zero."""
        v = self.vars[name]
        for l, mesh in enumerate(self.ml_mesh.levels):
            if fn is None:
                self.sol[l][name][:] = 0.0
            else:
                x = mesh.node_coords_of(v.family)
                vals = np.asarray(fn(x))
                if v.family == "disc_linear":
                    # value dof at centroid; derivative dofs zero
                    vals = vals.reshape(mesh.n_elems, 1 + mesh.dim)
                    vals[:, 1:] = 0.0
                    vals = vals.ravel()
                self.sol[l][name][:] = vals
            if v.time_order > 0:
                self.sol_old[l][name][:] = self.sol[l][name]

    # ------------------------------------------------------------------
    def attach_bc(self, fn: Callable) -> None:
        """fn(var, x (dim,), group:int, time) -> (is_dirichlet, value)."""
        self._bc_fn = fn

    def generate_bdc(self, *names: str, time: float = 0.0) -> None:
        """Fill Bdc codes and write Dirichlet values into _Sol (reference
        GenerateBdc semantics)."""
        assert self._bc_fn is not None, "attach_bc first"
        names = names or tuple(self.vars)
        for name in names:
            v = self.vars[name]
            for l, mesh in enumerate(self.ml_mesh.levels):
                dm = mesh.dofmap(v.family)
                codes = np.full(dm.n_dofs, INTERIOR, np.int8)
                vals = np.zeros(dm.n_dofs)
                if v.family not in ("disc_constant", "disc_linear"):
                    for bf in mesh.boundary.values():
                        fgeom = bf.face_geom
                        fam_local = GEOMS[fgeom].family_nodes.get(
                            v.family, GEOMS[fgeom].family_nodes["serendipity"])
                        for r in range(len(bf.elem)):
                            grp = int(bf.group[r])
                            nn = bf.conn[r]
                            fam_nodes = (nn[fam_local]
                                         if len(fam_local) <= len(nn) else nn)
                            for node in fam_nodes:
                                d = dm.node_to_dof[node]
                                if d < 0:
                                    continue
                                is_dir, val = self._bc_fn(
                                    name, mesh.coords[node], grp, time)
                                if is_dir:
                                    codes[d] = DIRICHLET
                                    vals[d] = val
                                elif codes[d] == INTERIOR:
                                    codes[d] = NEUMANN_FACE
                self.bdc[l][name] = codes
                self.bdc_value[l][name] = vals
                dirm = codes == DIRICHLET
                self.sol[l][name][dirm] = vals[dirm]

    def update_bdc(self, time: float) -> None:
        """Re-evaluate time-dependent Dirichlet values (reference UpdateBdc,
        MultiLevelSolution.hpp:383)."""
        self.generate_bdc(*self.vars, time=time)

    def fix_solution_at_point(self, name: str, dof: int = 0, value: float = 0.0):
        """Pin one dof (pressure gauge; reference FixSolutionAtOnePoint,
        MultiLevelSolution.hpp:492)."""
        for l in range(len(self.sol)):
            self.bdc[l].setdefault(name, np.full(self.sol[l][name].shape[0],
                                                 INTERIOR, np.int8))
            self.bdc_value[l].setdefault(name, np.zeros(self.sol[l][name].shape[0]))
            self.bdc[l][name][dof] = DIRICHLET
            self.bdc_value[l][name][dof] = value
            self.sol[l][name][dof] = value

    # ------------------------------------------------------------------
    def copy_to_old(self, *names: str) -> None:
        """_SolOld <- _Sol (reference CopySolutionToOldSolution)."""
        names = names or tuple(n for n, v in self.vars.items() if v.time_order > 0)
        for name in names:
            for l in range(len(self.sol)):
                if name in self.sol_old[l]:
                    self.sol_old[l][name][:] = self.sol[l][name]

    def refine_from(self, level: int) -> None:
        """Interpolate solution from ``level`` to ``level+1`` (prolongation)."""
        from ..algebra.transfer import prolongation_scipy
        cm, fm = self.ml_mesh.levels[level], self.ml_mesh.levels[level + 1]
        for name, v in self.vars.items():
            P = prolongation_scipy(cm, fm, v.family)
            self.sol[level + 1][name][:] = P @ self.sol[level][name]

    # ------------------------------------------------------------------
    def vector_norm(self, name: str, level: int = -1) -> float:
        """Vector 2-norm of dof values (the reference golden-value metric:
        NumericVector::l2_norm, unittests/testNSSteadyDD/main.cpp:202-237)."""
        return float(np.linalg.norm(self.sol[level][name]))
