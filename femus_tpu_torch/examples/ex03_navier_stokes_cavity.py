"""Steady lid-driven cavity: Newton on Q2/Q1 Navier-Stokes + VTK output.

Reference: applications/000_tutorial/ex06* / 003_NavierStokes
(AssembleNavierStokes_AD weak form, 03_navier_stokes.hpp:339-360).
"""
import os
import tempfile

import numpy as np

from .. import resolve_device
from ..assembly.forms import navier_stokes
from ..io.vtk import write_vtu
from ..mesh.generation import unit_box
from ..mesh.multilevel import MultiLevelMesh
from ..systems.problem import MultiLevelProblem
from ..systems.solution import MultiLevelSolution
from ..systems.system import NonLinearImplicitSystem
from ..utils.telemetry import convergence_table
from ._common import DTYPE, cli, env_int


def bc(var, x, grp, t):
    if var == "p":
        return False, 0.0
    if var == "u" and abs(x[1] - 1.0) < 1e-9:
        return True, 1.0                      # moving lid
    return True, 0.0


def main(device="cuda"):
    device = resolve_device(device)
    n = env_int("EX_N", 16)
    ml_mesh = MultiLevelMesh(unit_box((n, n), "quad"), 1)
    ml_sol = MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.add_solution("v", "biquadratic")
    ml_sol.add_solution("p", "linear")
    for v in ("u", "v", "p"):
        ml_sol.initialize(v)
    ml_sol.attach_bc(bc)
    ml_sol.generate_bdc("u", "v", "p")
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys = prob.add_system(NonLinearImplicitSystem, "NS")
    sys.add_unknown("u", "v", "p")
    sys.set_assembly(navier_stokes(("u", "v"), "p", nu=0.01))  # Re = 100
    sys.config.outer = "gmres"
    sys.config.rtol = 1e-10
    sys.config.max_nonlinear = 15
    sys.config.nonlinear_tol = 1e-9
    sys.init(device=device, dtype=DTYPE)
    sys.solve()
    print(convergence_table(sys.history))
    mesh = ml_mesh.finest()
    out = write_vtu(os.environ.get("EX_OUT", os.path.join(
        tempfile.gettempdir(), "cavity.vtu")), mesh,
        point_data={v: np.asarray(ml_sol.sol[-1][v]) for v in ("u", "v")})
    u_max = float(np.abs(ml_sol.sol[-1]["u"]).max())
    print("max |u| =", u_max, " wrote", out)
    last = sys.history[-1]
    return {"newton_steps": len(sys.history),
            "lin_iters": [h["lin_iters"] for h in sys.history],
            "lin_converged": all(h["converged"] for h in sys.history),
            "max_eps": max(last["eps"].values()),
            "nonlinear_tol": sys.config.nonlinear_tol,
            "max_abs_u": u_max, "vtu": out,
            "u": ml_sol.sol[-1]["u"].copy(), "v": ml_sol.sol[-1]["v"].copy(),
            "p": ml_sol.sol[-1]["p"].copy()}


if __name__ == "__main__":
    cli(main)
