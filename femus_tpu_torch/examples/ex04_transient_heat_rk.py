"""Transient heat equation: Crank-Nicolson vs 2-stage Gauss-Legendre
implicit Runge-Kutta.

Reference: applications/050_RK (ex1rk/ex1cn): same problem integrated with
TransientSystem theta-scheme and ImplicitRungeKuttaSystem.
"""
import numpy as np
import torch

from .. import resolve_device
from ..assembly.forms import poisson
from ..assembly.norms import error_norms
from ..mesh.generation import unit_box
from ..mesh.multilevel import MultiLevelMesh
from ..systems.problem import MultiLevelProblem
from ..systems.solution import MultiLevelSolution
from ..systems.transient import (ImplicitRungeKuttaSystem,
                                 TransientLinearImplicitSystem,
                                 crank_nicolson, irk_form)
from ._common import DTYPE, cli

pi = np.pi
LAM = 2 * pi * pi


def u0(x):
    sin = torch.sin if torch.is_tensor(x) else np.sin
    return sin(pi * x[:, 0]) * sin(pi * x[:, 1])


def run(scheme, dt, T=0.1, n=8, device="cuda"):
    ml_mesh = MultiLevelMesh(unit_box((n, n), "quad"), 1)
    ml_sol = MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic", time_order=1)
    if scheme == "rk":
        ImplicitRungeKuttaSystem.add_stage_fields(ml_sol, ["u"], 2)
    ml_sol.initialize("u", u0)
    ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
    ml_sol.generate_bdc()
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    base = poisson("u", "biquadratic")
    if scheme == "cn":
        sys = prob.add_system(TransientLinearImplicitSystem, "Heat")
        sys.add_unknown("u")
        sys.set_assembly(crank_nicolson(base, {"u": "biquadratic"}))
    else:
        sys = prob.add_system(ImplicitRungeKuttaSystem, "HeatRK")
        sys.add_unknown("u@0", "u@1")
        sys.setup_rk(["u"], 2)
        sys.set_assembly(irk_form(base, {"u": "biquadratic"}, 2))
        sys.config.max_nonlinear = 3
    sys.config.outer = "gmres"
    sys.config.use_mg = False
    sys.config.rtol = 1e-12
    sys.init_time(dt)
    sys.init(device=device, dtype=DTYPE)
    for _ in range(int(round(T / dt))):
        sys.time_step()
    l2, _ = error_norms(ml_mesh.finest(), "biquadratic", ml_sol.sol[-1]["u"],
                        lambda x: np.exp(-LAM * T) * u0(x), device=device)
    return l2


def main(device="cuda"):
    device = resolve_device(device)
    out = {}
    for scheme in ("cn", "rk"):
        errs = [run(scheme, dt, device=device) for dt in (0.025, 0.0125)]
        order = np.log2(errs[0] / errs[1])
        note = ("(temporal order ~2)" if scheme == "cn"
                else "(order 4: error floors at the spatial limit)")
        print(f"{scheme}: L2 {errs[1]:.3e}  observed order {order:.2f} {note}")
        out[scheme] = {"l2": errs, "order": float(order)}
    return out


if __name__ == "__main__":
    cli(main)
