"""PDE-constrained optimal control.

Reference: src/09_optimal_control — ``cost_functional`` templates
(00_cost_functional.hpp:53: target misfit + alpha L2 + beta H1-seminorm
regularization, volume or boundary control) and
``NonLinearImplicitSystemWithPrimalDualActiveSetMethod``
(NonLinearImplicitSystemWithPrimalDualActiveSetMethod.hpp:35: PDAS for
inequality-constrained controls).

The first-order optimality (KKT) system of the elliptic distributed-control
problem

    min 1/2 ||y - y_d||^2 + alpha/2 ||u||^2 + beta/2 |u|_H1^2
    s.t. -div(kappa grad y) = u + f,   y = g on Gamma_D

is assembled monolithically (state y, adjoint l, control u) with the same
batched engine; box constraints u_a <= u <= u_b are enforced by a
primal-dual active-set outer loop that converts active control dofs into
Dirichlet rows.

The control-mask edits (``fix_interior_control``, ``solve_pdas``) and
``assemble_constraint_vector`` address per-variable slices of the stacked
vector, so they need the stacked dof layout: on a system with
``interleave_dofs=True`` they raise ``ValueError``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..assembly.engine import Assembler
from ..assembly.norms import error_norms
from .system import NonLinearImplicitSystem


def elliptic_control_form(state: str = "y", adj: str = "l", ctrl: str = "u",
                          family: str = "biquadratic",
                          y_target: Callable = None,
                          alpha: float = 1e-3, beta: float = 0.0,
                          kappa: float = 1.0,
                          rhs: Optional[Callable] = None):
    """KKT residuals: state rows (tested with adjoint), adjoint rows,
    gradient rows  alpha u + beta (-lap u) - l = 0.  ``y_target`` and
    ``rhs`` map flat (N, dim) points to (N,) torch values."""

    def form(ops, u, aux):
        gy = ops.grad(family, u[state])
        gl = ops.grad(family, u[adj])
        yq = ops.value(family, u[state])
        lq = ops.value(family, u[adj])
        uq = ops.value(family, u[ctrl])
        yd = ops.pointwise(y_target)
        out = {}
        r_state = kappa * ops.tgrad(family, gy) - ops.t(family, uq)
        if rhs is not None:
            r_state = r_state - ops.t(family, ops.pointwise(rhs))
        out[state] = r_state
        out[adj] = kappa * ops.tgrad(family, gl) + ops.t(family, yq - yd)
        r_ctrl = alpha * ops.t(family, uq) - ops.t(family, lq)
        if beta:
            gu = ops.grad(family, u[ctrl])
            r_ctrl = r_ctrl + beta * ops.tgrad(family, gu)
        out[ctrl] = r_ctrl
        return out

    return form


def boundary_control_forms(state: str = "y", adj: str = "l", ctrl: str = "u",
                           family: str = "biquadratic",
                           y_target: Callable = None,
                           alpha: float = 1e-3, kappa: float = 1.0,
                           control_groups=(), obs_groups=None,
                           boundary_target: Optional[Callable] = None,
                           rhs: Optional[Callable] = None):
    """Neumann BOUNDARY control (reference 00_cost_functional.hpp:27-53
    boundary target/regularization integrals; 010_OptimalControl Neumann
    variants):

        min 1/2||y - y_d||^2_Omega [+ 1/2||y - y_db||^2_Gobs]
            + alpha/2 ||u||^2_{L2(Gc)}
        s.t. -div(kappa grad y) = f,   kappa dy/dn = u on Gc.

    KKT rows: state/adjoint volume rows as in the distributed case minus
    the volume control source; face rows on the control groups inject the
    Neumann control into the state equation and impose the boundary
    gradient condition alpha u - l = 0 on Gc.  The control variable only
    carries meaning on Gc — eliminate its interior dofs with
    :func:`fix_interior_control`.

    Returns (volume_form, face_form) for ``System.set_assembly``.
    """

    def vol(ops, u, aux):
        gy = ops.grad(family, u[state])
        gl = ops.grad(family, u[adj])
        yq = ops.value(family, u[state])
        yd = ops.pointwise(y_target)
        out = {}
        r_state = kappa * ops.tgrad(family, gy)
        if rhs is not None:
            r_state = r_state - ops.t(family, ops.pointwise(rhs))
        out[state] = r_state
        out[adj] = kappa * ops.tgrad(family, gl) + ops.t(family, yq - yd)
        return out

    def face(fops, u, fams, grp, aux):
        uq = fops.value(family, u[ctrl])
        lq = fops.value(family, u[adj])
        sel = sum((grp == g).to(uq.dtype) for g in control_groups)
        out = {state: -fops.t(family, uq * sel),
               ctrl: fops.t(family, (alpha * uq - lq) * sel)}
        if obs_groups and boundary_target is not None:
            yq = fops.value(family, u[state])
            ydb = boundary_target(fops.x)
            selo = sum((grp == g).to(uq.dtype) for g in obs_groups)
            out[adj] = fops.t(family, (yq - ydb) * selo)
        return out

    return vol, face


def _require_stacked(system, what: str) -> None:
    if system.config.interleave_dofs:
        raise ValueError(f"{what} addresses per-variable slices of the "
                         "stacked dof vector: it needs interleave_dofs=False")


def fix_interior_control(system, ctrl: str, control_groups,
                         level: int = -1) -> None:
    """Dirichlet-eliminate control dofs NOT on the control boundary (they
    carry no equation in the boundary-control KKT system) on every level.
    The masks of every level change: cached steps and sub-level transfers
    are dropped, as in the reference (the finest hierarchy's transfers
    built at ``init`` are kept)."""
    _require_stacked(system, "fix_interior_control")
    for l, a in enumerate(system.assemblers):
        mesh = a.mesh
        dm = a.dofmaps[ctrl]
        on_gc = np.zeros(dm.n_dofs, bool)
        for bf in mesh.boundary.values():
            for r in range(len(bf.elem)):
                if int(bf.group[r]) in control_groups:
                    d = dm.node_to_dof[bf.conn[r]]
                    on_gc[d[d >= 0]] = True
        mask = a.dirichlet_mask.copy()
        vals = a.dirichlet_values.copy()
        off = a.offsets[ctrl]
        mask[off:off + dm.n_dofs][~on_gc] = True
        vals[off:off + dm.n_dofs][~on_gc] = 0.0
        a.set_dirichlet(mask, vals)
        system.masks[l] = a.dirichlet_mask
    system._transfer_cache.clear()
    system._step_fns.clear()


def cost_functional(mesh, family: str, y, u, y_target: Callable,
                    alpha: float, beta: float = 0.0,
                    quad_order="ninth", device="cuda") -> float:
    """J = 1/2||y - y_d||^2 + alpha/2||u||^2 + beta/2|u|_H1^2 (reference
    00_cost_functional.hpp volume integrals), computed on ``device``."""
    mis, _ = error_norms(mesh, family, y, y_target, None, quad_order, device)
    ul2, uh1 = error_norms(mesh, family, u,
                           lambda x: x.new_zeros(x.shape[0]),
                           (lambda x: torch.zeros_like(x)) if beta else None,
                           quad_order, device)
    return 0.5 * mis ** 2 + 0.5 * alpha * ul2 ** 2 + 0.5 * beta * uh1 ** 2


def assemble_constraint_vector(system, volume_form=None, face_form=None,
                               level: int = -1) -> np.ndarray:
    """Assemble the row/column vector B of a LINEAR functional constraint
    g(x) = B . x (e.g. the zero-net-flux control constraint
    int_Gc u . n dGamma of the reference's Dirichlet-control problems,
    opt_systems_ns_dirichlet.hpp:995 "delta_theta row").

    The form is written like any assembly form but must be independent of
    the unknowns (it supplies coefficients against the TEST functions);
    its residual at u = 0 is exactly B.  Dirichlet rows of the owning
    system are zeroed (those dofs carry identity rows, not constraints).
    Assembled in float64 on the system's device."""
    _require_stacked(system, "assemble_constraint_vector")
    a_sys = system.assemblers[level]
    b_asm = Assembler(a_sys.mesh, system.unknowns,
                      quad_order=system.problem.quad_order,
                      dtype=torch.float64, device=system.device)
    b_asm.set_volume_form(volume_form if volume_form is not None
                          else (lambda ops, u, aux: {}))
    if face_form is not None:
        b_asm.set_face_form(face_form)
    fn = b_asm.make_assemble_fn(with_jacobian=False)
    R, _ = fn(torch.zeros(b_asm.n_dofs, dtype=torch.float64,
                          device=system.device))
    B = R.cpu().numpy().copy()
    B[a_sys.dirichlet_mask] = 0.0
    return B


class ScalarConstrainedSystem(NonLinearImplicitSystem):
    """Newton solve with global SCALAR unknowns theta_j bordering the system.

    Reference: the "theta" unknown of the Dirichlet-boundary-control
    problems — a DISCONTINUOUS_POLYNOMIAL/ZERO field whose single real dof
    is a Lagrange multiplier enforcing a scalar linear constraint
    (zero net control flux), wired into the Jacobian as a dense bordered
    row/column (opt_systems_ns_dirichlet.hpp:78-161 unknown registration,
    :995-1012 delta_theta rows/cols, 00_cost_functional.hpp:27-43
    get_theta_value).

    The bordered system

        [A  B] [x    ]   [f]
        [B' 0] [theta] = [g]

    is solved by block elimination: each Newton step solves A with 1+k
    right-hand sides through the SAME MG-preconditioned Krylov step
    (``extra_rhs``), then closes the k x k Schur complement (B' A^{-1} B)
    on the host.  theta is exact per step; x gets the constrained update.
    """

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._constraints: list = []      # (name, B vector, rhs)
        self.theta: Dict[str, float] = {}

    def add_scalar_constraint(self, name: str, b: np.ndarray,
                              rhs: float = 0.0) -> None:
        self._constraints.append((name, np.asarray(b, float), float(rhs)))
        self.theta[name] = 0.0

    def get_theta_value(self, name: str = None) -> float:
        """Reference get_theta_value (00_cost_functional.hpp:27-43)."""
        if name is None:
            name = self._constraints[0][0]
        return self.theta[name]

    def solve(self, device=None) -> Dict:
        assert self._initialized, "call init() first"
        assert self._constraints, "no scalar constraints added"
        assert self.config.operator == "assembled", \
            "bordered solve needs the assembled-operator path"
        self._check_device(device)
        cfg = self.config
        l = len(self.ml_mesh.levels) - 1
        step = self.step_fn(l)
        names = [c[0] for c in self._constraints]
        Bn = np.stack([c[1] for c in self._constraints], axis=1)
        g = np.array([c[2] for c in self._constraints])
        history = []
        for it in range(cfg.max_nonlinear):
            u = self.gather(l)
            out = step(torch.as_tensor(u, dtype=self.dtype,
                                       device=self.device), None,
                       self.aux_scalars, self._aux_arrays(l), extra_rhs=Bn)
            # Schur closure: theta+ = (B'D)^{-1} (B'(x + d1) - g)
            Dn = out.extra.cpu().numpy()
            u_new = out.u.cpu().numpy()
            theta = np.linalg.solve(Bn.T @ Dn, Bn.T @ u_new - g)
            x_new = u_new - Dn @ theta
            self.scatter(x_new, l)
            self.theta = dict(zip(names, theta.tolist()))
            norms = self.eps_norms(x_new - u, x_new, l)
            history.append({"level": l, "newton_it": it, "eps": norms,
                            "theta": dict(self.theta),
                            "lin_res": out.lin_res,
                            "lin_target": out.lin_target,
                            "lin_iters": out.lin_iters,
                            "converged": out.converged,
                            "res_norm": out.res_norm})
            if max(norms.values()) < cfg.nonlinear_tol:
                break
        self.history = history
        return history[-1] if history else {}


class PDASControlSystem(NonLinearImplicitSystem):
    """Primal-dual active-set outer loop around the KKT solve.

    Active sets (Bergounioux-Ito-Kunisch):  with multiplier mu = l - alpha u,
      A+ = { mu + c (u - ub) > 0 },  A- = { mu + c (u - ua) < 0 };
    active control dofs become Dirichlet rows at the bound value; iterate
    until the active sets stop changing (reference
    NonLinearImplicitSystemWithPrimalDualActiveSetMethod::MGsolve).

    A mask change reaches the cached step through the assembler's device
    tables (rebuilt after ``set_dirichlet``); the step's hierarchy (its
    transfers, coarse masks and Vanka blocks) and ``system.masks`` stay as
    built, as in the reference."""

    def set_control_bounds(self, ctrl: str, ua: float, ub: float,
                           c: float = 1.0, alpha: float = 1e-3,
                           adj: str = "l"):
        self._pdas = dict(ctrl=ctrl, ua=ua, ub=ub, c=c, alpha=alpha, adj=adj)

    def solve_pdas(self, max_iters: int = 20) -> Dict:
        """The PDAS loop; its info holds the active counts of the last
        iteration, and ``pdas_history`` one entry per iteration."""
        _require_stacked(self, "solve_pdas")
        p = self._pdas
        ctrl, adj = p["ctrl"], p["adj"]
        l = len(self.ml_mesh.levels) - 1
        a = self.assemblers[l]
        off = a.offsets[ctrl]
        nd = self.ml_sol.n_dofs(ctrl, l)
        base_mask = a.dirichlet_mask.copy()
        base_vals = a.dirichlet_values.copy()
        active_prev = None
        info = {}
        self.pdas_history = []
        for it in range(max_iters):
            out = super().solve()
            u = self.ml_sol.sol[l][ctrl]
            lam = self.ml_sol.sol[l][adj]
            mu = lam - p["alpha"] * u
            act_hi = mu + p["c"] * (u - p["ub"]) > 0
            act_lo = mu + p["c"] * (u - p["ua"]) < 0
            key = (act_hi.tobytes(), act_lo.tobytes())
            changed = key != active_prev
            info = {"pdas_iters": it + 1, "active_hi": int(act_hi.sum()),
                    "active_lo": int(act_lo.sum()), **out}
            self.pdas_history.append(
                {"active_hi": info["active_hi"],
                 "active_lo": info["active_lo"],
                 "linear_solves": [(h["lin_iters"], h["converged"])
                                   for h in self.history]})
            if not changed:
                break
            active_prev = key
            mask = base_mask.copy()
            vals = base_vals.copy()
            mask[off:off + nd][act_hi | act_lo] = True
            vals[off:off + nd][act_hi] = p["ub"]
            vals[off:off + nd][act_lo] = p["ua"]
            a.set_dirichlet(mask, vals)
            u[act_hi] = p["ub"]
            u[act_lo] = p["ua"]
        return info
