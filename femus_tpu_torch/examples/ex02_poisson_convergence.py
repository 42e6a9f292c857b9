"""Poisson h-convergence orders over a refinement hierarchy.

Reference: applications/000_tutorial/ex02_poisson_* and the FE_convergence
harness (FE_convergence.hpp:29-139, order printout :400-471).
"""
import numpy as np
import torch

from .. import resolve_device
from ..assembly.forms import poisson
from ..mesh.generation import unit_box
from ..systems.fe_convergence import convergence_study
from ..systems.problem import MultiLevelProblem
from ..systems.solution import MultiLevelSolution
from ..systems.system import LinearImplicitSystem
from ._common import DTYPE, cli

pi = np.pi
FAMILIES = ("linear", "serendipity", "biquadratic")


def exact(x):
    return torch.sin(pi * x[:, 0]) * torch.sin(pi * x[:, 1])


def exact_grad(x):
    return torch.stack([pi * torch.cos(pi * x[:, 0]) * torch.sin(pi * x[:, 1]),
                        pi * torch.sin(pi * x[:, 0]) * torch.cos(pi * x[:, 1])],
                       dim=-1)


def runner(family, device="cuda"):
    def make_and_solve(ml_mesh):
        ml_sol = MultiLevelSolution(ml_mesh)
        ml_sol.add_solution("u", family)
        ml_sol.initialize("u")
        ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
        ml_sol.generate_bdc("u")
        prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
        sys = prob.add_system(LinearImplicitSystem, "Poisson")
        sys.add_unknown("u")
        sys.set_assembly(poisson("u", family,
                                 rhs=lambda x: 2 * pi * pi * exact(x)))
        sys.config.outer = "cg"
        sys.config.rtol = 1e-12
        sys.init(device=device, dtype=DTYPE)
        sys.solve()
        return ml_sol, {"u": family}
    return make_and_solve


def main(device="cuda"):
    device = resolve_device(device)
    out = {}
    for family in FAMILIES:
        res = convergence_study(runner(family, device),
                                unit_box((3, 3), "quad"), 3,
                                {"u": exact}, {"u": exact_grad},
                                device=device)
        print(f"== {family} ==")
        print(res.report())
        out[family] = {"l2": res.l2_errors["u"], "h1": res.h1_errors["u"],
                       "l2_orders": res.l2_orders["u"],
                       "h1_orders": res.h1_orders["u"]}
    return out


if __name__ == "__main__":
    cli(main)
