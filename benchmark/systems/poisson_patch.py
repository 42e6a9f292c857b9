"""The program's Q2 Poisson solve on the patch operator, as the benchmark
drives it.

-div(grad u) = f on the unit square, u = 0 on the boundary, through the
port's public entry points as the repository's ``chip_smoke.patch_system``
builds it (a copy, not an import): a ``PatchedMultiLevelMesh`` of the
configuration's coarse cells and levels, ``operator="patch"`` (kernel B2),
``coarse_op="rediscretize"``, a Chebyshev-smoothed V-cycle preconditioning
GMRES.  The right-hand side is the form's ``rhs`` callable, a sum of sine
modes whose wave numbers and amplitudes are device tensors the benchmark
sets before each solve: data, not a new form.  One solve is one cold
``LinearImplicitSystem.solve()`` from zero.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


class Driver:
    def __init__(self, cfg: Dict, workdir: str, device: str):
        from femus_tpu_torch.assembly.forms import poisson
        from femus_tpu_torch.mesh.generation import unit_box
        from femus_tpu_torch.mesh.multilevel import PatchedMultiLevelMesh
        from femus_tpu_torch.systems.problem import MultiLevelProblem
        from femus_tpu_torch.systems.solution import MultiLevelSolution
        from femus_tpu_torch.systems.system import LinearImplicitSystem

        mesh, solver = cfg["mesh"], cfg["solver"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.device = torch.device(device)
        empty = torch.zeros(0, dtype=self.dtype, device=self.device)
        self.k, self.l, self.a = empty, empty.clone(), empty.clone()
        c = mesh["coarse_cells"]
        ml_mesh = PatchedMultiLevelMesh(unit_box((c, c)), mesh["levels"])
        ml_sol = MultiLevelSolution(ml_mesh)
        ml_sol.add_solution("u", "biquadratic")
        ml_sol.initialize("u")
        ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
        ml_sol.generate_bdc("u")
        prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
        sys_ = prob.add_system(LinearImplicitSystem, "poisson")
        sys_.add_unknown("u")
        sys_.set_assembly(poisson("u", rhs=self._rhs))
        conf = sys_.config
        conf.operator = solver["operator"]
        conf.coarse_op = solver["coarse_op"]
        conf.smoother = solver["smoother"]
        conf.mg_type = solver["cycle"]
        conf.rtol = solver["rtol"]
        sys_.init(device=device, dtype=self.dtype)
        self.sys, self.ml_mesh, self.sol = sys_, ml_mesh, ml_sol.sol

    def _rhs(self, x: torch.Tensor) -> torch.Tensor:
        """sum_m a_m sin(k_m pi x) sin(l_m pi y) at the points ``x``."""
        return (self.a * torch.sin(math.pi * x[:, :1] * self.k)
                * torch.sin(math.pi * x[:, 1:2] * self.l)).sum(1)

    def solve(self, request: Dict) -> Dict:
        modes = torch.as_tensor(request["modes"], dtype=self.dtype)
        if self.k.numel() != len(modes):
            self.k, self.l, self.a = (modes[:, j].to(self.device).clone()
                                      for j in range(3))
        else:
            for dst, j in ((self.k, 0), (self.l, 1), (self.a, 2)):
                dst.copy_(modes[:, j])
        self.sol[-1]["u"][:] = 0.0
        info = self.sys.solve()
        return {"krylov_iters": info["iters"],
                "converged": info["converged"]}

    def output(self) -> Dict:
        return {"u": self.sol[-1]["u"].copy()}

    def layout(self) -> Dict:
        return {"xy": self.ml_mesh.levels[-1].node_coords_of("biquadratic")}

    def profile(self) -> Dict:
        return self.sys.profile_step(-1, reps=3)
