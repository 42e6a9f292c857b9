"""Time-dependent systems: theta-schemes, implicit Runge-Kutta, Newmark.

- ``TransientSystem<Base>``: per step the dt callback, the time-dependent
  boundary values (and masks), old <- current, then the base solve; the
  form reads the old values as element-local aux fields '<var>_old'.
- ``ImplicitRungeKuttaSystem``: s-stage Gauss-Legendre IRK; the stage
  slopes k_i are extra solution fields, u^{n+1} = u^n + dt sum b_i k_i.
- ``NewmarkTransientSystem``: Newmark-beta update for second-order
  dynamics.

The form combinators lift a steady weak form F(u) into the transient
residuals; the time derivative term uses the variable's own mass integral.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .solution import DIRICHLET
from .system import LinearImplicitSystem, NonLinearImplicitSystem


def theta_transient(base_form: Callable, evol_vars: Dict[str, str],
                    theta: float = 0.5):
    """Theta-scheme residual: for evolving vars (name -> family)

        int (u - u_old)/dt phi + theta F(u) + (1-theta) F(u_old) = 0

    Non-evolving vars (algebraic constraints, e.g. pressure) keep F(u) only.
    The form expects aux '<var>_old' element-local fields and scalar 'dt'.
    """

    def form(ops, u, aux):
        dt = aux["dt"]
        out_new = base_form(ops, u, aux)
        u_old = {v: aux[v + "_old"] for v in evol_vars}
        # the old state: non-evolving vars take their current values (their
        # contributions are algebraic)
        u_old_full = dict(u)
        u_old_full.update(u_old)
        out_old = base_form(ops, u_old_full, aux)
        res = {}
        for v in u:
            if v in evol_vars:
                fam = evol_vars[v]
                du = ops.value(fam, u[v]) - ops.value(fam, u_old[v])
                res[v] = (ops.t(fam, du / dt)
                          + theta * out_new[v] + (1.0 - theta) * out_old[v])
            else:
                res[v] = out_new[v]
        return res

    return form


def backward_euler(base_form: Callable, evol_vars: Dict[str, str]):
    return theta_transient(base_form, evol_vars, theta=1.0)


def crank_nicolson(base_form: Callable, evol_vars: Dict[str, str]):
    return theta_transient(base_form, evol_vars, theta=0.5)


class _TransientMixin:
    """Adds the time-stepping drive to a System subclass."""

    def init_time(self, dt: float, t0: float = 0.0,
                  dt_fn: Optional[Callable] = None,
                  time_dependent_bc: bool = False) -> None:
        """Set the clock and wire '<var>_old' aux fields for every unknown
        with time_order > 0; call before ``init``."""
        self.time = t0
        self.dt = dt
        self._dt_fn = dt_fn
        self._td_bc = time_dependent_bc
        self.set_scalar(dt=dt, time=t0)
        for name in self.unknown_names:
            if self.ml_sol.vars[name].time_order > 0:
                self.add_aux_field(name, name + "_old", old=True)

    def evolving(self) -> Dict[str, str]:
        return {n: self.ml_sol.vars[n].family for n in self.unknown_names
                if self.ml_sol.vars[n].time_order > 0}

    def time_step(self):
        """The dt callback, time, boundary values (and masks),
        old <- current, then the solve."""
        if self._dt_fn is not None:
            self.dt = float(self._dt_fn(self.time))
        self.time += self.dt
        self.set_scalar(dt=self.dt, time=self.time)
        if self._td_bc:
            self.ml_sol.update_bdc(self.time)
            self._refresh_bc()
        self.ml_sol.copy_to_old()
        return self.solve()

    def _refresh_bc(self):
        """Push regenerated Dirichlet values AND masks into the assemblers.

        The values reach the solve through the assemblers' tables.  A mask
        that changes (a boundary switching type) also invalidates what was
        built against the old one: the cached step functions (with their
        Vanka blocks and Dirichlet masks), the masked transfers and their
        R A P / P^T A P schedules, and the BELL device plans of the
        schedules' coarse patterns; the next step rebuilds them."""
        mask_changed = False
        for l, a in enumerate(self.assemblers):
            vals = np.zeros(a.n_dofs)
            mask = np.zeros(a.n_dofs, bool)
            for u in self.unknowns:
                codes = self.ml_sol.bdc[l].get(u.name)
                if codes is None:
                    continue
                off = a.offsets[u.name]
                sel = codes == DIRICHLET
                mask[off:off + len(codes)][sel] = True
                vals[off:off + len(codes)][sel] = \
                    self.ml_sol.bdc_value[l][u.name][sel]
            a.set_dirichlet(mask, vals)
            if not np.array_equal(a.dirichlet_mask, self.masks[l]):
                self.masks[l] = a.dirichlet_mask
                mask_changed = True
        if mask_changed:
            self._step_fns.clear()
            self._bell_plans.clear()
            self._transfer_cache.clear()
            self._build_transfers()


class TransientLinearImplicitSystem(_TransientMixin, LinearImplicitSystem):
    pass


class TransientNonlinearImplicitSystem(_TransientMixin,
                                       NonLinearImplicitSystem):
    pass


# ---------------------------------------------------------------------------
# Implicit Runge-Kutta (Gauss-Legendre collocation)
# ---------------------------------------------------------------------------

def gauss_legendre_tableau(s: int) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """(A, b, c) Butcher tableau of the s-stage Gauss-Legendre IRK
    (order 2s)."""
    from numpy.polynomial.legendre import leggauss
    x, w = leggauss(s)
    c = (x + 1) / 2
    b = w / 2
    # collocation: A_ij = int_0^{c_i} l_j(t) dt with the Lagrange basis on c
    A = np.zeros((s, s))
    for j in range(s):
        coef = np.poly1d([1.0])
        for k in range(s):
            if k != j:
                coef = coef * np.poly1d([1.0, -c[k]]) / (c[j] - c[k])
        integ = coef.integ()
        for i in range(s):
            A[i, j] = integ(c[i]) - integ(0.0)
    return A, b, c


def irk_form(base_form: Callable, evol_vars: Dict[str, str], s: int = 2):
    """Residual of the coupled s-stage IRK system.

    Unknowns are the stage slopes k_i per evolving variable, named
    '<var>@<i>'; aux carries '<var>_old'.  Stage states:
        u_i = u_old + dt sum_j A_ij k_j
    Stage residual for variable v, stage i:
        int k_i phi + F_v(u_i) = 0
    Algebraic vars appear per stage as '<var>@<i>' directly.
    """
    A, _, _ = gauss_legendre_tableau(s)

    def form(ops, u, aux):
        dt = aux["dt"]
        res = {}
        base_vars = sorted({n.rsplit("@", 1)[0] for n in u})
        for i in range(s):
            ui = {}
            for v in base_vars:
                if v in evol_vars:
                    uold = aux[v + "_old"]
                    ui[v] = uold + dt * sum(A[i, j] * u[f"{v}@{j}"]
                                            for j in range(s))
                else:
                    ui[v] = u[f"{v}@{i}"]
            out = base_form(ops, ui, aux)
            for v in base_vars:
                if v in evol_vars:
                    fam = evol_vars[v]
                    ki = ops.value(fam, u[f"{v}@{i}"])
                    res[f"{v}@{i}"] = ops.t(fam, ki) + out[v]
                else:
                    res[f"{v}@{i}"] = out[v]
        return res

    return form


class ImplicitRungeKuttaSystem(_TransientMixin, NonLinearImplicitSystem):
    """s-stage Gauss-Legendre IRK over a steady base form.

    Add the stage fields '<var>@<i>' to the MultiLevelSolution
    (:meth:`add_stage_fields`), set the assembly to irk_form(base, evol, s),
    call setup_rk + init_time + init + time_step; after each stage solve
    the base fields get u^{n+1} = u_old + dt sum_i b_i k_i."""

    def setup_rk(self, base_vars: Sequence[str], s: int = 2) -> None:
        self.rk_s = s
        self.rk_base_vars = list(base_vars)
        self.rk_A, self.rk_b, self.rk_c = gauss_legendre_tableau(s)

    @staticmethod
    def add_stage_fields(ml_sol, base_vars: Sequence[str], s: int) -> None:
        for v in base_vars:
            var = ml_sol.vars[v]
            for i in range(s):
                ml_sol.add_solution(f"{v}@{i}", var.family, time_order=0)

    def time_step(self):
        out = super().time_step()
        for v in self.rk_base_vars:
            if self.ml_sol.vars[v].time_order > 0:
                for l in range(len(self.ml_sol.sol)):
                    acc = self.ml_sol.sol_old[l][v].copy()
                    for i in range(self.rk_s):
                        acc += (self.dt * self.rk_b[i]
                                * self.ml_sol.sol[l][f"{v}@{i}"])
                    self.ml_sol.sol[l][v][:] = acc
        return out

    def evolving(self) -> Dict[str, str]:
        return {}

    def init_time(self, dt, t0=0.0, dt_fn=None, time_dependent_bc=False):
        self.time = t0
        self.dt = dt
        self._dt_fn = dt_fn
        self._td_bc = time_dependent_bc
        self.set_scalar(dt=dt, time=t0)
        for v in self.rk_base_vars:
            if self.ml_sol.vars[v].time_order > 0:
                self.add_aux_field(v, v + "_old", old=True)


def newmark_form(base_form: Callable, evol_vars: Dict[str, str],
                 beta: float = 0.25, gamma: float = 0.5):
    """Newmark-beta residual for second-order dynamics M a + F(u) = 0.

    Unknowns: displacements u; aux: '<v>_old' (displacement), '<v>_vel',
    '<v>_acc' element-local fields, scalar 'dt'.  The acceleration implied
    by the Newmark update is
        a_new = (u - u_old - dt v_old - dt^2 (1/2 - beta) a_old) / (beta dt^2)
    """

    def form(ops, u, aux):
        dt = aux["dt"]
        out = base_form(ops, u, aux)
        res = {}
        for v, fam in evol_vars.items():
            uo = aux[v + "_old"]
            vo = aux[v + "_vel"]
            ao = aux[v + "_acc"]
            a_new = ((u[v] - uo - dt * vo - dt * dt * (0.5 - beta) * ao)
                     / (beta * dt * dt))
            res[v] = ops.t(fam, ops.value(fam, a_new)) + out[v]
        for v in u:
            if v not in evol_vars:
                res[v] = out[v]
        return res

    return form


class NewmarkTransientSystem(_TransientMixin, NonLinearImplicitSystem):
    """Second-order dynamics with Newmark-beta updates of the velocity and
    acceleration fields '<v>_vel' / '<v>_acc'."""

    def setup_newmark(self, vars_: Sequence[str], beta=0.25, gamma=0.5):
        self.nm_vars = list(vars_)
        self.nm_beta, self.nm_gamma = beta, gamma

    def init_time(self, dt, t0=0.0, dt_fn=None, time_dependent_bc=False):
        super().init_time(dt, t0, dt_fn, time_dependent_bc)
        for v in self.nm_vars:
            self.add_aux_field(v + "_vel", v + "_vel")
            self.add_aux_field(v + "_acc", v + "_acc")

    def time_step(self):
        out = super().time_step()
        b, g, dt = self.nm_beta, self.nm_gamma, self.dt
        for v in self.nm_vars:
            for l in range(len(self.ml_sol.sol)):
                u = self.ml_sol.sol[l][v]
                uo = self.ml_sol.sol_old[l][v]
                vel = self.ml_sol.sol[l][v + "_vel"]
                acc = self.ml_sol.sol[l][v + "_acc"]
                a_new = ((u - uo - dt * vel - dt * dt * (0.5 - b) * acc)
                         / (b * dt * dt))
                vel[:] = vel + dt * ((1 - g) * acc + g * a_new)
                acc[:] = a_new
        return out
