"""Steady Navier-Stokes + temperature on the Turek cylinder channel.

Equivalent of the reference's golden regression app
``unittests/testNSSteadyDD/main.cpp``:

- mesh ``input/nsbenc.neu`` (channel 2.2 x 0.41 with cylinder r=0.05 at
  (0.2, 0.2)), refined uniformly; golden norms measured at level 3
  (main.cpp:204-237)
- U, V, T Lagrange SECOND (biquadratic); P DISCONTINUOUS FIRST (P1dc)
- NS weak form main.cpp:616-700: grad-grad viscous term with IRe = 0.001,
  full-Newton advection, pressure term +p dphi/dx_d, continuity psi*div(u);
  do-nothing outflow
- T form main.cpp:874-905: IPe * grad(T).grad(phi) + (U.grad T) phi
- BCs main.cpp:289-392: face group 1 inflow (U = parabolic profile, T = 1),
  2 outflow (natural), 3 channel walls (no-slip, T natural),
  4 cylinder (no-slip, T = 5)

The golden U/V/P values are the *converged discrete solution* at level 3;
the golden T value is the *initialized* field at level 3 (the reference
solves T with V_CYCLE, which only runs on the finest level, so level 3
keeps the GenerateBdc Dirichlet insertion).  ``GOLD_SOLVED_T`` pins the
temperature solved in the converged velocity field.

Every function that reads the mesh takes ``mesh_path`` (default
:data:`MESH`); the systems run on ``device`` (the card unless the caller
passes "cpu") in ``dtype`` (the System default when None).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..assembly.bc import apply_dirichlet_values, generate_bdc
from ..assembly.engine import Assembler, Unknown
from ..assembly.forms import navier_stokes
from ..mesh.gambit import read_neu
from ..mesh.refine import refine
from . import FEMUS_DIR

MESH = os.path.join(FEMUS_DIR, "unittests", "testNSSteadyDD", "input",
                    "nsbenc.neu")

GOLD = {"U": 35.68179309424519, "V": 6.86749406268887,
        "P": 3.10222750612995, "T": 57.69748694700662}

# self-golden: L2 norm of the level-3 temperature SOLVED in the converged
# velocity field (Newton + direct sparse LU to residual ~1e-16)
GOLD_SOLVED_T = 305.75558043932313

IRE = 0.001   # 1/Re from Fluid(parameter, mu=0.001, rho=1) (main.cpp:228)
IPE = 0.001   # 1/Pe = 1/(Pr*Re), Pr = cp*mu/k = 1 (Fluid.cpp:81)


def inflow_u(y):
    return 1.5 * 0.2 * (4.0 / 0.1681) * y * (0.41 - y)


def bc_ns(var, x, grp, t):
    if var == "U":
        if grp == 1:
            return True, inflow_u(x[1])
        if grp == 2:
            return False, 0.0
        return True, 0.0
    if var == "V":
        if grp == 2:
            return False, 0.0
        return True, 0.0
    return False, 0.0          # P: no Dirichlet anywhere (main.cpp:354-371)


def bc_temperature(var, x, grp, t):
    if grp == 1:
        return True, 1.0
    if grp == 4:
        return True, 5.0
    return False, 0.0


def load_mesh(levels: int = 3, mesh_path: str = MESH):
    mesh = read_neu(mesh_path)
    for _ in range(levels):
        mesh = refine(mesh)
    return mesh


def make_ns_assembler(mesh, dtype=torch.float64, interleave: bool = False,
                      device="cuda") -> Assembler:
    asm = Assembler(mesh, [Unknown("U", "biquadratic"),
                           Unknown("V", "biquadratic"),
                           Unknown("P", "disc_linear")],
                    quad_order="seventh", dtype=dtype,
                    interleave=interleave, device=device)
    asm.set_volume_form(navier_stokes(("U", "V"), "P",
                                      pres_family="disc_linear", nu=IRE))
    generate_bdc(asm, bc_ns)
    return asm


def temperature_form(ops, u, aux):
    GT = ops.grad("biquadratic", u["T"])
    Uq = ops.value("biquadratic", aux["U"])
    Vq = ops.value("biquadratic", aux["V"])
    adv = Uq * GT[:, 0] + Vq * GT[:, 1]
    return {"T": IPE * ops.tgrad("biquadratic", GT)
            + ops.t("biquadratic", adv)}


def make_temperature_assembler(mesh, dtype=torch.float64,
                               device="cuda") -> Assembler:
    asmT = Assembler(mesh, [Unknown("T", "biquadratic")],
                     quad_order="seventh", dtype=dtype, device=device)
    asmT.add_aux_field("U", "biquadratic")
    asmT.add_aux_field("V", "biquadratic")
    asmT.set_volume_form(temperature_form)
    generate_bdc(asmT, bc_temperature)
    return asmT


def initial_guess(asm: Assembler, mesh) -> np.ndarray:
    u = np.zeros(asm.n_dofs)
    nU = asm.dofmaps["U"].n_dofs
    u[asm.offsets["U"]:asm.offsets["U"] + nU] = inflow_u(
        mesh.coords[asm.dofmaps["U"].nodes, 1])
    return apply_dirichlet_values(asm, u)


def var_norm(asm: Assembler, u: np.ndarray, name: str) -> float:
    off, n = asm.offsets[name], asm.dofmaps[name].n_dofs
    return float(np.linalg.norm(np.asarray(u)[off:off + n]))


def bdc_initialized_T(asmT: Assembler, mesh) -> np.ndarray:
    """The level-3 T field of the reference run: zeros + Dirichlet values."""
    return apply_dirichlet_values(asmT, np.zeros(asmT.n_dofs))


def make_temperature_system(prob, smoother: str = "vanka",
                            rtol: float = 1e-10, device="cuda",
                            dtype=None):
    """Add the temperature system to an existing NS problem and solve it the
    reference way: V_CYCLE = finest level only (LinearImplicitSystem.cpp:
    300-311), advecting velocity read as aux fields from the NS solution.
    """
    from ..systems.system import LinearImplicitSystem

    ml_sol = prob.ml_sol
    ml_sol.add_solution("T", "biquadratic")
    ml_sol.initialize("T")
    ml_sol.attach_bc(bc_temperature)   # only applied to the names below
    ml_sol.generate_bdc("T")
    sysT = prob.add_system(LinearImplicitSystem, "Temperature")
    sysT.add_unknown("T")
    sysT.set_assembly(temperature_form)
    sysT.add_aux_field("U")
    sysT.add_aux_field("V")
    cfg = sysT.config
    cfg.smoother = smoother
    cfg.mg_type = "V"              # finest level only, like the reference
    cfg.use_mg = True
    cfg.rtol = rtol
    cfg.restart = 60
    cfg.max_outer = 10
    sysT.init(device=device, dtype=dtype)
    return sysT


def make_ns_system(levels: int = 4, smoother: str = "vanka",
                   rtol: float = 1e-8, interleave: bool = False,
                   mesh_path: str = MESH, device="cuda", dtype=None):
    """The testNSSteadyDD drive through the framework's OWN solver stack
    (reference main.cpp:33-46 + LinearEquationSolverPetsc.cpp:294-353):
    ``levels``-deep uniformly refined hierarchy on the mesh at
    ``mesh_path``, F-cycle coarse-to-fine Newton ratchet, per-level
    MG-preconditioned GMRES with multiplicative Vanka (ASM-block) smoothers
    and a dense coarse solve.

    Returns (problem, system); ``system.solve()`` runs the full F-cycle and
    records per-iteration GMRES counts in ``system.history``.
    """
    from ..mesh.multilevel import MultiLevelMesh
    from ..systems.problem import MultiLevelProblem
    from ..systems.solution import MultiLevelSolution
    from ..systems.system import NonLinearImplicitSystem

    ml_mesh = MultiLevelMesh(read_neu(mesh_path), levels)
    if interleave:
        # RCM node numbering per level + node-major interleaved stacked
        # layout: the assembled pattern is banded, so the BELL frame is
        # the identity
        from ..mesh.reorder import rcm_reorder_hierarchy
        rcm_reorder_hierarchy(ml_mesh)
    ml_sol = MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("U", "biquadratic")
    ml_sol.add_solution("V", "biquadratic")
    ml_sol.add_solution("P", "disc_linear")
    ml_sol.initialize("U", lambda x: inflow_u(x[:, 1]))
    ml_sol.initialize("V")
    ml_sol.initialize("P")
    ml_sol.attach_bc(bc_ns)
    ml_sol.generate_bdc("U", "V", "P")
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="seventh")
    sys_ = prob.add_system(NonLinearImplicitSystem, "NS")
    sys_.add_unknown("U", "V", "P")
    sys_.set_assembly(navier_stokes(("U", "V"), "P",
                                    pres_family="disc_linear", nu=IRE))
    cfg = sys_.config
    cfg.smoother = smoother
    cfg.mg_type = "F"
    cfg.use_mg = True
    cfg.rtol = rtol
    cfg.restart = 60
    cfg.max_outer = 10
    cfg.nonlinear_tol = 1e-9
    cfg.interleave_dofs = interleave
    sys_.init(device=device, dtype=dtype)
    return prob, sys_
