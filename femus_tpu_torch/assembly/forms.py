"""Ready-made weak forms (Poisson, steady Navier–Stokes).

Each form is a pure function ``form(ops, u, aux) -> {var: residual}`` over
:class:`~femus_tpu_torch.assembly.engine.ElemOpsBatched`; Jacobians come
from forward-mode AD in the engine, so forms only state the residual.

Residual convention: R_i(u) = 0 is the discrete equation; the solvers step
u <- u + delta with J delta = -R.
"""
from __future__ import annotations

from typing import Callable, Optional


def poisson(var: str = "u", family: str = "biquadratic",
            rhs: Optional[Callable] = None, kappa: float = 1.0):
    """-div(kappa grad u) = f.  ``rhs`` maps a flat (N, dim) tensor of
    physical points to (N,) torch values."""

    def form(ops, u, aux):
        g = ops.grad(family, u[var])
        r = kappa * ops.tgrad(family, g)
        if rhs is not None:
            r = r - ops.t(family, ops.pointwise(rhs))
        return {var: r}

    return form


def navier_stokes(vel=("u", "v"), pres: str = "p",
                  vel_family: str = "biquadratic", pres_family: str = "linear",
                  nu: float = 1.0, force: Optional[Callable] = None,
                  stokes: bool = False):
    """Steady incompressible Navier-Stokes, velocity components + pressure:

      momentum_d: nu grad(u_d) . grad(phi) + (U . grad u_d) phi - p dphi/dx_d = f_d phi
      continuity: div(U) psi = 0
    """
    dim = len(vel)

    def form(ops, u, aux):
        nuv = aux.get("nu", nu)
        V = [ops.value(vel_family, u[c]) for c in vel]          # (nq, ne) each
        G = [ops.grad(vel_family, u[c]) for c in vel]           # (nq, dim, ne)
        pq = ops.value(pres_family, u[pres])
        out = {}
        fq = ops.pointwise(force) if force is not None else None
        for d, c in enumerate(vel):
            r = nuv * ops.tgrad(vel_family, G[d])
            if not stokes:
                adv = sum(V[e] * G[d][:, e] for e in range(dim))
                r = r + ops.t(vel_family, adv)
            r = r - ops.tgrad_d(vel_family, pq, d)
            if fq is not None:
                r = r - ops.t(vel_family, fq[:, d])
            out[c] = r
        divV = sum(G[d][:, d] for d in range(dim))
        out[pres] = -ops.t(pres_family, divV)
        return out

    return form
