"""Tumor-growth diffusion on a disk: transient (degenerate) nonlinear
diffusion with a Robin absorption boundary.

Reference: applications/091_Tumor/ex1 (ex1.cpp:1-61 problem statement,
:290-447 assembly): u_t = div(a(u) grad u) on the unit ball/disk, boundary
term eps * u (Robin absorption, ex1.cpp:370-374 with eps = 5), initial
injection profile u0 = c0 * exp(1 - R^2/(R^2 - r^2)) vanishing at the
boundary (ex1.cpp:61), backward-Euler in time; the app tracks the tumor
volume fraction above a time-dependent threshold (ex1.cpp:463-466).

Here: a coarse Gambit mesh of the disk (``mesh_path``, default the
reference's input/disk.neu) is read and uniformly refined; the volume form
is ``nonlinear_diffusion`` (a(u) = D0 + D2 u^2 — set D2 = 0 for the
reference ex1 linear case), the Robin term is a 3-line face form, and the
drive is TransientNonlinearImplicitSystem (backward Euler).  Mass decays
only through the boundary absorption, which the mass-balance printout
checks.
"""
import os

import numpy as np

from .. import resolve_device
from ..apps import FEMUS_DIR
from ..assembly.forms import nonlinear_diffusion
from ..assembly.norms import integrate_field
from ..mesh.gambit import read_neu
from ..mesh.multilevel import MultiLevelMesh
from ..systems.problem import MultiLevelProblem
from ..systems.solution import MultiLevelSolution
from ..systems.transient import (TransientNonlinearImplicitSystem,
                                 backward_euler)
from ._common import DTYPE, cli, env_int

MESH = os.path.join(FEMUS_DIR, "applications", "091_Tumor", "ex1", "input",
                    "disk.neu")
R2 = 1.0            # injection support radius^2 (mesh radius)
EPS = 5.0           # Robin absorption coefficient (ex1.cpp:370)


def initial_u(x):
    r2 = np.sum(x * x, axis=-1)
    safe = np.clip(R2 - r2, 1e-6, None)
    return np.where(r2 < R2, 0.1 * np.exp(1.0 - R2 / safe), 0.0)


def robin_faces(var: str, family: str, eps: float):
    """aRes += phi * eps * u ds on every boundary face (ex1.cpp:370-374)."""

    def form(fops, u, fams, grp, aux):
        uq = fops.value(family, u[var])
        return {var: fops.t(family, eps * uq)}

    return form


def main(device="cuda", mesh_path=MESH):
    device = resolve_device(device)
    n_levels = env_int("EX_LEVELS", 3)
    n_steps = env_int("EX_STEPS", 8)
    dt = 0.01
    d2 = float(os.environ.get("EX_D2", "1.0"))     # 0 -> reference ex1 case

    ml_mesh = MultiLevelMesh(read_neu(mesh_path), n_levels)
    ml_sol = MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic", time_order=1)
    ml_sol.initialize("u", initial_u)
    ml_sol.attach_bc(lambda var, x, grp, t: (False, 0.0))   # pure Robin
    ml_sol.generate_bdc("u")

    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys = prob.add_system(TransientNonlinearImplicitSystem, "Tumor")
    sys.add_unknown("u")
    base = nonlinear_diffusion("u", "biquadratic",
                               a=lambda s: 1.0 + d2 * s * s)
    sys.set_assembly(backward_euler(base, {"u": "biquadratic"}),
                     robin_faces("u", "biquadratic", EPS))
    sys.config.outer = "gmres"
    sys.config.rtol = 1e-10
    sys.config.max_nonlinear = 6
    sys.init_time(dt)          # registers the '<var>_old' aux fields
    sys.init(device=device, dtype=DTYPE)

    mesh = ml_mesh.finest()
    mass0 = integrate_field(mesh, "biquadratic",
                            np.asarray(ml_sol.sol[-1]["u"]), device=device)
    print(f"levels={n_levels} dofs={len(ml_sol.sol[-1]['u'])} "
          f"a(u)=1+{d2}*u^2  mass0={mass0:.6f}")
    steps = []
    for k in range(n_steps):
        info = sys.time_step()
        u = np.asarray(ml_sol.sol[-1]["u"])
        mass = integrate_field(mesh, "biquadratic", u, device=device)
        frac = integrate_field(mesh, "biquadratic",
                               (u > 0.05).astype(np.float64), device=device)
        print(f"t={sys.time:.3f} mass={mass:.6f} frac(u>0.05)={frac:.4f} "
              f"lin_res={info['lin_res']:.2e} newton_its={info['newton_it'] + 1}")
        steps.append({"t": sys.time, "mass": mass, "frac": frac,
                      "lin_res": info["lin_res"],
                      "newton_its": info["newton_it"] + 1})
    # boundary absorption only removes mass: monotone decay, no blow-up
    assert mass < mass0 and mass > 0, (mass0, mass)
    decay = round(float(1 - mass / mass0), 4)
    print("mass decay:", decay)
    return {"dofs": len(ml_sol.sol[-1]["u"]), "mass0": mass0,
            "steps": steps, "mass_decay": decay, "u": u.copy()}


if __name__ == "__main__":
    cli(main)
