"""Shallow-water weak forms: single-layer and isopycnal layer stack.

Reference workload: ``applications/090_SW`` (layered shallow-water z-level
and isopycnal ocean examples — lock_exchange_zlevel, overflow_isopycnal,
tracer advection; ~27k LoC of per-app assemblies).  Here the same physics
is expressed through the generic form interface (assembly/forms.py
conventions): pure residual functions; time stepping via the theta/IRK
combinators (systems/transient.py); Jacobians by forward-mode AD in the
engine.

Formulation (velocity form, continuous Galerkin + optional viscosity):

  single layer:  h_t + div(h U) = 0
                 U_t + (U . grad) U + g grad(h + b) - nu lap U = 0

  isopycnal stack (layer k = 1..K, densities rho_k increasing downward,
  Montgomery-potential coupling):
                 h_k,t + (h_k u_k)_x = 0
                 u_k,t + u_k u_k,x + M_k,x - nu u_k,xx = 0
                 M_k = g [ b + sum_j alpha_jk h_j ],
                 alpha_jk = rho_j / rho_k  (j above k),  1  (j >= k)

Well-balancedness: with flat surface (h + b = const, U = 0) the residual
vanishes identically (tests/test_sw.py, tests/test_torch_forms.py).
"""
from __future__ import annotations

from typing import Optional, Sequence


def shallow_water(h_var: str = "h", vel=("u", "v"),
                  family: str = "biquadratic", g: float = 9.81,
                  nu: float = 0.0, bathymetry_field: Optional[str] = None):
    """Single-layer SW in (h, U) velocity form.

    ``bathymetry_field``: name of an aux element field holding the FE
    interpolant of b — the surface gradient grad(h + b) is then computed
    fully discretely, so 'lake at rest' (h + b = const) is exactly
    well-balanced (an analytic grad b would not cancel the interpolated
    grad h)."""
    dim = len(vel)

    def form(ops, u, aux):
        hq = ops.value(family, u[h_var])
        gh = ops.grad(family, u[h_var])
        V = [ops.value(family, u[c]) for c in vel]
        G = [ops.grad(family, u[c]) for c in vel]
        divV = sum(G[d][:, d] for d in range(dim))
        out = {}
        # continuity: h_t + U . grad h + h div U
        adv_h = sum(V[d] * gh[:, d] for d in range(dim))
        out[h_var] = ops.t(family, adv_h + hq * divV)
        # surface gradient: grad(h + b), b discrete
        gs = gh + (ops.grad(family, aux[bathymetry_field])
                   if bathymetry_field else 0.0)
        for d, c in enumerate(vel):
            adv = sum(V[e] * G[d][:, e] for e in range(dim))
            r = ops.t(family, adv + g * gs[:, d])
            if nu > 0.0:
                r = r + nu * ops.tgrad(family, G[d])
            out[c] = r
        return out

    return form


def shallow_water_layered(n_layers: int, family: str = "biquadratic",
                          g: float = 9.81, rho: Optional[Sequence[float]] = None,
                          nu: float = 0.0, kappa: float = 0.0,
                          bathymetry_field: Optional[str] = None,
                          h_prefix: str = "h", u_prefix: str = "u"):
    """1-D isopycnal layer stack (reference overflow_isopycnal style).

    Unknowns: h1..hK (thickness), u1..uK (layer velocity); ``kappa`` adds
    thickness diffusion (interface smoothing, as the reference's examples
    regularize).  alpha matrix from layer densities (default: equal density
    steps 1, 1+eps, ...)."""
    rho = list(rho) if rho is not None else [1.0 + 0.01 * k
                                            for k in range(n_layers)]
    alpha = [[(rho[j] / rho[k] if j < k else 1.0) for j in range(n_layers)]
             for k in range(n_layers)]

    def form(ops, u, aux):
        H = [ops.value(family, u[f"{h_prefix}{k+1}"]) for k in range(n_layers)]
        GH = [ops.grad(family, u[f"{h_prefix}{k+1}"]) for k in range(n_layers)]
        U = [ops.value(family, u[f"{u_prefix}{k+1}"]) for k in range(n_layers)]
        GU = [ops.grad(family, u[f"{u_prefix}{k+1}"]) for k in range(n_layers)]
        gb = (ops.grad(family, aux[bathymetry_field])
              if bathymetry_field else None)
        out = {}
        for k in range(n_layers):
            # continuity (1-D): h_k,t + (h_k u_k)_x
            flux_x = U[k] * GH[k][:, 0] + H[k] * GU[k][:, 0]
            r_h = ops.t(family, flux_x)
            if kappa > 0.0:
                r_h = r_h + kappa * ops.tgrad(family, GH[k])
            out[f"{h_prefix}{k+1}"] = r_h
            # momentum: u_k,t + u_k u_k,x + M_k,x
            gM = sum(alpha[k][j] * GH[j][:, 0] for j in range(n_layers))
            if gb is not None:
                gM = gM + gb[:, 0]
            r_u = ops.t(family, U[k] * GU[k][:, 0] + g * gM)
            if nu > 0.0:
                r_u = r_u + nu * ops.tgrad(family, GU[k])
            out[f"{u_prefix}{k+1}"] = r_u
        return out

    return form


def tracer_advection(c_var: str = "c", vel=("u", "v"),
                     family: str = "biquadratic", kappa: float = 0.0,
                     vel_family: Optional[str] = None):
    """Tracer c_t + U . grad c - kappa lap c = 0 over a (given or solved)
    velocity field (reference 090_SW tracer examples)."""
    vf = vel_family or family
    dim = len(vel)

    def form(ops, u, aux):
        gc = ops.grad(family, u[c_var])
        V = [ops.value(vf, u[c] if c in u else aux[c]) for c in vel]
        adv = sum(V[d] * gc[:, d] for d in range(dim))
        r = ops.t(family, adv)
        if kappa > 0.0:
            r = r + kappa * ops.tgrad(family, gc)
        return {c_var: r}

    return form
