"""Steady monolithic FSI on the Turek channel-with-beam mesh.

Equivalent of the reference's golden regression app
``unittests/testFSISteady/main.cpp``:

- mesh ``input/fsifirst.neu`` (channel + cylinder + elastic beam; element
  group 5 is the solid, MATERIAL 4), 3 uniform refinements; golden norms at
  level 3 = the finest level (main.cpp:148-196)
- unknowns DX, DY, U, V Lagrange SECOND; P DISCONTINUOUS FIRST; quadrature
  "fifth" (main.cpp:53)
- parameters main.cpp:46-51: rhof = 1000, muf = 1 -> IRe = 1e-3;
  rhos = 1000, nu_s = 0.4, E = 1.4e6 -> mu_lame = 5e5, lambda_lame = 2e6;
  mus = mu_lame/rhof = 500, lambda = lambda_lame/rhof = 2000; Neo-Hookean
  (solid model 1, Solid.cpp:72)

The residual reproduced verbatim from AssembleMatrixResFSI
(main.cpp:361-1196), with our sign convention r = -Rhs_reference:

fluid elements (material 2):
  DX/DY rows (ALE map):  (1-solidmark_i) * sum_q w_q grad_hat(phi_i).grad_hat(d)
                         — RAW gauss weight, no |J| (Weight_nojac,
                         main.cpp:736-742)
  U/V rows:   [ (U.grad)u phi_i + IRe grad(u).grad(phi_i) - p dphi_i/dx ] W
              on the MOVED configuration x = X + d (main.cpp:757-766)
  P rows:     - phi1 div(u) W (moved frame; main.cpp:852)

solid elements (material 4, group 5):
  DX/DY rows (kinematic): - phi_i v W_hat   (=> v = 0 steady, main.cpp:999)
  U/V rows:   [ grad(phi_i) : Cauchy - p dphi_i/dx ] W (moved frame), with
              incompressible Neo-Hookean Cauchy = (mus/J)(b - I),
              b = F F^T, F = I + grad_hat(d) (main.cpp:905-925,1012-1018)
  P rows:     - phi1 (log(J)/J + p/lambda) W_hat (main.cpp:1102-1106)

An exact-Jacobian Newton on this residual converges to the reference's
discrete solution (its B matrix is a quasi-Newton approximation).

Every function that reads the mesh takes ``mesh_path`` (default
:data:`MESH`); the system runs on ``device`` (the card unless the caller
passes "cpu") in ``dtype`` (the System default when None).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..assembly import tensors
from ..assembly.bc import generate_bdc
from ..assembly.engine import Assembler, Unknown
from ..mesh.gambit import read_neu
from ..mesh.refine import refine
from . import FEMUS_DIR

MESH = os.path.join(FEMUS_DIR, "unittests", "testFSISteady", "input",
                    "fsifirst.neu")

GOLD = {"DX": 0.00422796021240, "DY": 0.06728194901640,
        "U": 43.30221796101648, "V": 9.83398554915716, "P": 5.87173860743601}
TOL = {"DX": 1e-5, "DY": 1e-5, "U": 1e-4, "V": 1e-4, "P": 1e-4}

IRE = 1.0e-3          # muf/(rhof*Uref*Lref)
MUS = 5.0e5 / 1000.0  # mu_lame / rhof
LAM = 2.0e6 / 1000.0  # lambda_lame / rhof
SOLID_GROUP = 5


def inflow_u(y):
    return 1.5 * 0.2 * (4.0 / 0.1681) * y * (0.41 - y)


def bc_fsi(var, x, grp, t):
    """main.cpp:227-359 (groups: 1 inflow, 2 outflow, 3 channel walls,
    4 cylinder)."""
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
    if var == "DX":
        if grp == 3:
            return False, 0.0
        return True, 0.0
    if var == "DY":
        if grp in (1, 2):
            return False, 0.0
        return True, 0.0
    return False, 0.0     # P


def fsi_form(ops, u, aux):
    dim = 2
    grp = aux["group"]
    w_s = (grp == SOLID_GROUP).to(u["P"].dtype)
    w_f = 1.0 - w_s
    smark = aux["smark"]                       # (nd_bq, ne) 1 on solid nodes

    d_nodes = torch.stack([u["DX"], u["DY"]], dim=1)      # (nd_bq, dim, ne)
    mops = ops.moved(d_nodes)

    # hat-frame displacement gradients (reference configuration)
    Gd_hat = torch.stack([ops.grad("biquadratic", u[c])
                          for c in ("DX", "DY")], dim=1)   # (nq, dim, dim, ne)
    # moved-frame velocity values/gradients
    Vq = [mops.value("biquadratic", u[c]) for c in ("U", "V")]
    Gv = [mops.grad("biquadratic", u[c]) for c in ("U", "V")]
    pq = mops.value("disc_linear", u["P"])

    out = {}

    # ---- DX/DY rows ----------------------------------------------------
    # fluid ALE: (1-smark_i) * sum_q w_q grad_hat(phi_iq).grad_hat(d_q)
    dphi_hat = ops.dphi("biquadratic")         # (nq, nd, dim, ne)
    w_raw = ops.qweights
    for k, c in enumerate(("DX", "DY")):
        ale = torch.einsum("qnxe,qxe,q->ne", dphi_hat, Gd_hat[:, k], w_raw)
        r_f = (1.0 - smark) * ale
        # solid kinematic: - phi_i * v_k, hat weight
        r_s = -ops.t("biquadratic", Vq[k])
        out[c] = w_f * r_f + w_s * r_s

    # ---- U/V rows --------------------------------------------------------
    # solid Cauchy stress: F = I + grad_hat(d); b = F F^T; (mus/J)(b - I)
    I = tensors.eye_like(dim, Gd_hat)
    F = I + Gd_hat
    J = tensors.det(F)
    Jsafe = torch.where(J > 1e-8, J, torch.ones_like(J))
    b = tensors.matmulT(F, F)
    cauchy = tensors.qpm(MUS / Jsafe) * (b - I)

    mdphi = mops.dphi("biquadratic")           # moved-frame gradients
    for k, c in enumerate(("U", "V")):
        adv = sum(Vq[e] * Gv[k][:, e] for e in range(dim))
        r_f = (mops.t("biquadratic", adv)
               + IRE * mops.tgrad("biquadratic", Gv[k])
               - mops.tgrad_d("biquadratic", pq, k))
        # grad(phi_i) : Cauchy[k, :] integrated with moved weight
        r_s = (torch.einsum("qnxe,qxe,qe->ne", mdphi, cauchy[:, k],
                            mops.wdet)
               - mops.tgrad_d("biquadratic", pq, k))
        out[c] = w_f * r_f + w_s * r_s

    # ---- P rows ----------------------------------------------------------
    div_v = sum(Gv[e][:, e] for e in range(dim))
    r_f = -mops.t("disc_linear", div_v)
    r_s = -ops.t("disc_linear", torch.log(Jsafe) / Jsafe + pq / LAM)
    out["P"] = w_f * r_f + w_s * r_s
    return out


def load_mesh(levels: int = 3, mesh_path: str = MESH):
    mesh = read_neu(mesh_path)
    for _ in range(levels):
        mesh = refine(mesh)
    return mesh


def solid_mark(mesh) -> np.ndarray:
    """Per-node flag: 1 if the node belongs to a solid (group 5 / material 4)
    element (Mesh::Topology_FillSolidNodeFlag, Mesh.cpp:478-501)."""
    mark = np.zeros(mesh.coords.shape[0])
    sel = mesh.elem_group == SOLID_GROUP
    mark[np.unique(mesh.conn[sel].ravel())] = 1.0
    return mark


def make_assembler(mesh, dtype=torch.float64, device="cuda") -> Assembler:
    asm = Assembler(mesh, [Unknown("DX", "biquadratic"),
                           Unknown("DY", "biquadratic"),
                           Unknown("U", "biquadratic"),
                           Unknown("V", "biquadratic"),
                           Unknown("P", "disc_linear")],
                    quad_order="fifth", dtype=dtype, device=device)
    asm.add_aux_field("smark", "biquadratic")
    asm.set_volume_form(fsi_form)
    generate_bdc(asm, bc_fsi)
    return asm


def smark_dof_field(asm: Assembler, mesh) -> np.ndarray:
    mark = solid_mark(mesh)
    return mark[asm.dofmaps["DX"].nodes]


def var_norm(asm: Assembler, u: np.ndarray, name: str) -> float:
    off, n = asm.offsets[name], asm.dofmaps[name].n_dofs
    return float(np.linalg.norm(np.asarray(u)[off:off + n]))


def make_fsi_system(levels: int = 4, smoother: str = "vanka",
                    rtol: float = 1e-8, max_lin_iters: int = 0,
                    max_nonlinear: int = 15, mg_cycle: str = "V",
                    cfg_overrides: dict = None, mesh_path: str = MESH,
                    device="cuda", dtype=None):
    """The testFSISteady drive through the framework's OWN solver stack
    (reference main.cpp:100-146: F-cycle Newton over a ``levels``-deep
    uniformly refined hierarchy of the mesh at ``mesh_path``, each linear
    solve an MG-preconditioned GMRES with material-split Vanka (ASM)
    smoothers and the FSI Petrov-Galerkin _RR restriction / R A P coarse
    operators, and a dense coarse solve).  No external factorization
    anywhere.

    ``max_lin_iters`` > 0 caps each linear solve like the reference gate
    does (testFSISteady main.cpp:124 ``SetTolerances(1e-12, 1e-20, 1e50,
    20)`` — max 20 GMRES iterations per Newton step, i.e. INEXACT Newton
    riding the F-cycle ratchet).  ``cfg_overrides``: SolverConfig fields
    set before ``init``.

    Returns (problem, system); ``system.solve()`` runs the full F-cycle
    ratchet and records per-step GMRES counts in ``system.history``.
    """
    from ..mesh.multilevel import MultiLevelMesh
    from ..systems.fsi import MonolithicFSISystem
    from ..systems.problem import MultiLevelProblem
    from ..systems.solution import MultiLevelSolution

    ml_mesh = MultiLevelMesh(read_neu(mesh_path), levels)
    ml_sol = MultiLevelSolution(ml_mesh)
    for v in ("DX", "DY", "U", "V"):
        ml_sol.add_solution(v, "biquadratic")
    ml_sol.add_solution("P", "disc_linear")
    ml_sol.add_solution("smark", "biquadratic")   # solid-node flag aux field
    for v in ("DX", "DY", "U", "V", "P", "smark"):
        ml_sol.initialize(v)
    for l, mesh in enumerate(ml_mesh.levels):
        dm = mesh.dofmap("biquadratic")
        ml_sol.sol[l]["smark"][:] = solid_mark(mesh)[dm.nodes]
    ml_sol.attach_bc(bc_fsi)
    ml_sol.generate_bdc("DX", "DY", "U", "V", "P")
    # reference fsiSteady apps: PairSolution("U","DX") / ("V","DY")
    # (005_FSI/00_SteadyState/MG/fsiSteadyMG.cpp:252-253) — drives the
    # Petrov-Galerkin _RR restriction
    ml_sol.pair_solution("U", "DX")
    ml_sol.pair_solution("V", "DY")
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(MonolithicFSISystem, "FSI")
    sys_.solid_groups = (SOLID_GROUP,)
    sys_.add_unknown("DX", "DY", "U", "V", "P")
    sys_.add_aux_field("smark")
    sys_.set_assembly(fsi_form)
    cfg = sys_.config
    cfg.smoother = smoother
    cfg.vanka_groups = "material"
    # "K" (Notay's Krylov-accelerated cycle) is the iteration-optimal
    # choice on hierarchies deeper than 2
    cfg.mg_cycle = mg_cycle
    cfg.mg_type = "F"
    cfg.use_mg = True
    cfg.rtol = rtol
    if max_lin_iters > 0:
        cfg.restart = max_lin_iters
        cfg.max_outer = 1
    else:
        cfg.restart = 60
        cfg.max_outer = 20
    cfg.nonlinear_tol = 1e-9
    cfg.max_nonlinear = max_nonlinear
    for k, v in (cfg_overrides or {}).items():
        if not hasattr(cfg, k):
            raise AttributeError(f"SolverConfig has no field {k!r}")
        setattr(cfg, k, v)
    sys_.init(device=device, dtype=dtype)
    return prob, sys_
