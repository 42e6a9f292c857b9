"""Ready-made weak forms (Poisson, mass, nonlinear diffusion, steady
Navier–Stokes, linear elasticity).

Each form is a pure function ``form(ops, u, aux) -> {var: residual}`` over
:class:`~femus_tpu_torch.assembly.engine.ElemOpsBatched`; Jacobians come
from forward-mode AD in the engine, so forms only state the residual.

Residual convention: R_i(u) = 0 is the discrete equation; the solvers step
u <- u + delta with J delta = -R.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import tensors


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


def mass(var: str = "u", family: str = "biquadratic", coeff: float = 1.0):
    """coeff * u (projection/mass term), composable."""

    def form(ops, u, aux):
        return {var: coeff * ops.t(family, ops.value(family, u[var]))}

    return form


def nonlinear_diffusion(var: str = "u", family: str = "biquadratic",
                        a: Optional[Callable] = None,
                        rhs: Optional[Callable] = None):
    """-div(a(u) grad u) = f; ``a`` maps the (nq, ne) values of u at the
    quadrature points to the diffusivity there (default 1 + u^2)."""
    a = a or (lambda s: 1.0 + s * s)

    def form(ops, u, aux):
        uq = ops.value(family, u[var])
        g = ops.grad(family, u[var])
        r = ops.tgrad(family, a(uq)[:, None] * g)
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


def elasticity(disp=("dx", "dy"), family: str = "biquadratic",
               model: str = "linear", lam: float = 1.0, mu: float = 1.0,
               force: Optional[Callable] = None):
    """Linear elasticity in the displacement formulation:

      div P + f = 0,  P = 2 mu eps(u) + lam tr(eps(u)) I,
      eps(u) = (grad u + grad u^T) / 2.

    ``force`` maps a flat (N, dim) tensor of physical points to (N, dim)
    body-force values.  Only ``model="linear"`` is ported; the finite-strain
    models and the mixed displacement-pressure variant are not."""
    if model != "linear":
        raise NotImplementedError(f"elasticity model {model!r} is not "
                                  "ported (only 'linear')")
    dim = len(disp)

    def form(ops, u, aux):
        lam_ = aux.get("lambda", lam)
        mu_ = aux.get("mu", mu)
        # G[q, d, x, e] = du_d / dx_x
        G = torch.stack([ops.grad(family, u[c]) for c in disp], dim=1)
        eps = 0.5 * (G + tensors.transpose(G))
        P = (2.0 * mu_ * eps
             + lam_ * tensors.qpm(tensors.trace(eps)) * tensors.eye_like(dim, G))
        fq = ops.pointwise(force) if force is not None else None
        out = {}
        for d, c in enumerate(disp):
            r = ops.tgrad(family, P[:, d])
            if fq is not None:
                r = r - ops.t(family, fq[:, d])
            out[c] = r
        return out

    return form
