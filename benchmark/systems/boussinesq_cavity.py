"""The program's differentially heated cavity (de Vahl Davis 1983), as the
benchmark drives it.

The four-field Boussinesq Newton solve (u, v, T biquadratic, p
discontinuous linear; ``assembly.forms.boussinesq`` in free-fall scaling)
through the port's public entry points as the repository's
``chip_smoke.boussinesq_system`` builds it (a copy, not an import): a
``MultiLevelMesh`` of ``unit_box`` with its levels RCM-reordered,
interleaved dofs, ``operator="bell"`` (kernel B1), a Vanka-smoothed
(kernel V1) multigrid cycle preconditioning GMRES, every Newton step on the
finest level.  The pressure is pinned at its first dof.  On the card,
torch's dense LU goes to the library the configuration's
``solver.linalg_library`` names (``torch.backends.cuda.
preferred_linalg_library``): "cusolver" puts the Vanka set-up's batched
LU of 60 x 60 blocks on cuBLAS's batched getrf in place of MAGMA's, whose
host-bound time swings from solve to solve and from run to run.  One solve
is one whole ``NonLinearImplicitSystem.solve()`` from rest: every level's
fields are put back before it, while the built steps, plans, tables and
kernels stay.
"""
from __future__ import annotations

from typing import Dict

import torch


def heated_cavity_bc(var, x, grp, t):
    """The de Vahl Davis walls: no-slip everywhere, T = 0.5 on x = 0 and
    -0.5 on x = 1, insulated top and bottom."""
    if var in ("u", "v"):
        return True, 0.0
    if var == "T":
        if abs(x[0]) < 1e-9:
            return True, 0.5
        if abs(x[0] - 1.0) < 1e-9:
            return True, -0.5
    return False, 0.0


class Driver:
    FIELDS = ("u", "v", "p", "T")

    def __init__(self, cfg: Dict, workdir: str, device: str):
        from femus_tpu_torch.assembly.forms import boussinesq
        from femus_tpu_torch.mesh.generation import unit_box
        from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
        from femus_tpu_torch.mesh.reorder import rcm_reorder_hierarchy
        from femus_tpu_torch.systems.problem import MultiLevelProblem
        from femus_tpu_torch.systems.solution import MultiLevelSolution
        from femus_tpu_torch.systems.system import NonLinearImplicitSystem

        mesh, phys, solver = cfg["mesh"], cfg["physics"], cfg["solver"]
        if device == "cuda":
            torch.backends.cuda.preferred_linalg_library(
                solver["linalg_library"])
        c = mesh["coarse_cells"]
        ml_mesh = MultiLevelMesh(unit_box((c, c)), mesh["levels"])
        rcm_reorder_hierarchy(ml_mesh)
        ml_sol = MultiLevelSolution(ml_mesh)
        for n in ("u", "v", "T"):
            ml_sol.add_solution(n, "biquadratic")
        ml_sol.add_solution("p", "disc_linear")
        for n in self.FIELDS:
            ml_sol.initialize(n)
        ml_sol.attach_bc(heated_cavity_bc)
        ml_sol.generate_bdc(*self.FIELDS)
        ml_sol.fix_solution_at_point("p", 0, 0.0)
        prob = MultiLevelProblem(ml_mesh, ml_sol,
                                 quad_order=solver["quadrature"])
        sys_ = prob.add_system(NonLinearImplicitSystem, "Boussinesq")
        sys_.add_unknown(*self.FIELDS)
        sys_.set_assembly(boussinesq(("u", "v"), "p", "T",
                                     pres_family="disc_linear",
                                     ra=phys["ra"], pr=phys["pr"]))
        conf = sys_.config
        conf.operator = solver["operator"]
        conf.interleave_dofs = solver["interleave"]
        conf.smoother = solver["smoother"]
        conf.vanka_multiplicative = solver["vanka_multiplicative"]
        conf.mg_type = solver["mg_type"]
        conf.rtol = solver["rtol"]
        conf.restart = solver["restart"]
        conf.max_outer = solver["max_outer"]
        conf.max_nonlinear = solver["newton_steps"]
        sys_.init(device=device, dtype=getattr(torch, cfg["dtype"]))
        self.sys, self.sol = sys_, ml_sol.sol
        self.initial = [{n: a.copy() for n, a in lv.items()}
                        for lv in self.sol]

    def solve(self, request: Dict) -> Dict:
        for lv, saved in zip(self.sol, self.initial):
            for n, a in saved.items():
                lv[n][:] = a
        self.sys.solve()
        hist = self.sys.history
        return {"newton_steps": len(hist),
                "krylov_iters": sum(h["lin_iters"] for h in hist),
                "converged": all(h["converged"] for h in hist)}

    def output(self) -> Dict:
        """The finest level's fields, copied to the host."""
        return {n: self.sol[-1][n].copy() for n in self.FIELDS}

    def layout(self) -> Dict:
        """Where the fields sit: the Q2 dofs' points and each element's
        corners (the frame of its pressure coefficients)."""
        m = self.sys.ml_mesh.levels[-1]
        return {"vel_xy": m.node_coords_of("biquadratic"),
                "elem_corners": m.coords[m.conn[:, :4]]}

    def profile(self) -> Dict:
        return self.sys.profile_step(-1, reps=3)
