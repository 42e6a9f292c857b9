"""Ready-made weak forms (Poisson, mass, nonlinear diffusion, the coupled
biharmonic, steady Navier–Stokes, Boussinesq, elasticity, Willmore flow of
a graph) and boundary-face forms (Neumann fluxes, Nitsche's weak Dirichlet
condition).

Each form is a pure function ``form(ops, u, aux) -> {var: residual}`` over
:class:`~femus_tpu_torch.assembly.engine.ElemOpsBatched`; Jacobians come
from forward-mode AD in the engine, so forms only state the residual.

Residual convention: R_i(u) = 0 is the discrete equation; the solvers step
u <- u + delta with J delta = -R.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

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


def biharmonic_coupled(u_var: str = "u", v_var: str = "v",
                       family: str = "biquadratic",
                       rhs: Optional[Callable] = None):
    """Biharmonic lap(lap u) = f as the coupled second-order system
    v = -lap u, -lap v = f (reference 01_biharmonic_coupled.hpp; tutorial
    ex04/ex05), simply-supported BCs u = v = 0."""

    def form(ops, u, aux):
        gu = ops.grad(family, u[u_var])
        gv = ops.grad(family, u[v_var])
        vq = ops.value(family, u[v_var])
        ru = ops.tgrad(family, gu) - ops.t(family, vq)
        rv = ops.tgrad(family, gv)
        if rhs is not None:
            rv = rv - ops.t(family, ops.pointwise(rhs))
        return {u_var: ru, v_var: rv}

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


def boussinesq(vel=("u", "v"), pres: str = "p", temp: str = "T",
               vel_family: str = "biquadratic", pres_family: str = "linear",
               temp_family: str = "biquadratic",
               nu: float = 1.0, alpha: float = 1.0, ra: float = 1.0,
               pr: float = 1.0, gravity_dir: int = -1):
    """Thermally coupled Navier-Stokes (reference 04_boussinesq.hpp):
    viscosity sqrt(Pr/Ra), buoyancy T in the gravity direction (the last
    axis by default), temperature advection-diffusion with conductivity
    1/sqrt(Ra Pr)."""
    dim = len(vel)
    gd = dim - 1 if gravity_dir == -1 else gravity_dir

    def form(ops, u, aux):
        V = [ops.value(vel_family, u[c]) for c in vel]
        G = [ops.grad(vel_family, u[c]) for c in vel]
        pq = ops.value(pres_family, u[pres])
        Tq = ops.value(temp_family, u[temp])
        GT = ops.grad(temp_family, u[temp])
        out = {}
        for d, c in enumerate(vel):
            adv = sum(V[e] * G[d][:, e] for e in range(dim))
            r = (math.sqrt(pr / ra) * ops.tgrad(vel_family, G[d])
                 + ops.t(vel_family, adv)
                 - ops.tgrad_d(vel_family, pq, d))
            if d == gd:
                r = r - ops.t(vel_family, Tq)
            out[c] = r
        divV = sum(G[d][:, d] for d in range(dim))
        out[pres] = -ops.t(pres_family, divV)
        advT = sum(V[e] * GT[:, e] for e in range(dim))
        out[temp] = (1.0 / math.sqrt(ra * pr) * ops.tgrad(temp_family, GT)
                     + ops.t(temp_family, advT))
        return out

    return form


def elasticity(disp=("dx", "dy"), family: str = "biquadratic",
               model: str = "linear", lam: float = 1.0, mu: float = 1.0,
               force: Optional[Callable] = None,
               pres: Optional[str] = None, pres_family: str = "linear",
               incompressible: bool = False):
    """Solid mechanics residual, total-Lagrangian displacement formulation:

      div P + f = 0,  tested with the displacement basis.

    Constitutive models: "linear" (P = 2 mu eps + lam tr(eps) I, eps the
    symmetric gradient), "saint-venant" (St. Venant-Kirchhoff, finite
    strain), "neo-hookean" (compressible, Bonet-Wood form), and the rest of
    the ``Solid`` registry through :func:`systems.constitutive.first_piola`.
    With ``pres`` set, a pressure field enforces (near-)incompressibility
    monolithically.  ``force`` maps a flat (N, dim) tensor of physical
    points to (N, dim) body-force values."""
    dim = len(disp)

    def form(ops, u, aux):
        lam_ = aux.get("lambda", lam)
        mu_ = aux.get("mu", mu)
        # G[q, d, x, e] = du_d / dx_x
        G = torch.stack([ops.grad(family, u[c]) for c in disp], dim=1)
        I = tensors.eye_like(dim, G)
        if model == "linear":
            eps = 0.5 * (G + tensors.transpose(G))
            P = 2.0 * mu_ * eps + lam_ * tensors.qpm(tensors.trace(eps)) * I
        elif model == "saint-venant":
            F = I + G
            E = 0.5 * (tensors.matTmul(F, F) - I)
            S = 2.0 * mu_ * E + lam_ * tensors.qpm(tensors.trace(E)) * I
            P = tensors.matmul(F, S)
        elif model == "neo-hookean":
            F = I + G
            J = tensors.det(F)
            FinvT = tensors.transpose(tensors.inv(F))
            P = mu_ * (F - FinvT) + lam_ * tensors.qpm(torch.log(J)) * FinvT
        else:
            # the rest of the registry (Bonet-Wood / Allan-Bower /
            # Mooney-Rivlin); the pressure enters the stress there
            from ..systems.constitutive import first_piola
            pq = (ops.value(pres_family, u[pres])
                  if pres is not None else None)
            P = first_piola(model, G, mu_, lam_, p=pq, incompressible=True)
            fq2 = ops.pointwise(force) if force is not None else None
            out = {}
            for d, c in enumerate(disp):
                r = ops.tgrad(family, P[:, d])
                if fq2 is not None:
                    r = r - ops.t(family, fq2[:, d])
                out[c] = r
            if pres is not None:
                J = tensors.det(I + G)
                cres = (J - 1.0) if incompressible else \
                    (J - 1.0) - ops.value(pres_family, u[pres]) / lam_
                out[pres] = -ops.t(pres_family, cres)
            return out
        out = {}
        if pres is not None:
            pq = ops.value(pres_family, u[pres])
            if model == "linear":
                P = P - tensors.qpm(pq) * I
            else:
                F = I + G
                J = tensors.det(F)
                FinvT = tensors.transpose(tensors.inv(F))
                P = P - tensors.qpm(pq * J) * FinvT
        fq = ops.pointwise(force) if force is not None else None
        for d, c in enumerate(disp):
            r = ops.tgrad(family, P[:, d])
            if fq is not None:
                r = r - ops.t(family, fq[:, d])
            out[c] = r
        if pres is not None:
            if model == "linear":
                divu = tensors.trace(G)
                cres = divu if incompressible else divu - ops.value(
                    pres_family, u[pres]) / lam_
            else:
                J = tensors.det(I + G)
                cres = (J - 1.0) if incompressible else (J - 1.0) - ops.value(
                    pres_family, u[pres]) / lam_
            out[pres] = -ops.t(pres_family, cres)
        return out

    return form


def willmore_graph(u_var: str = "u", w_var: str = "W",
                   family: str = "biquadratic", c: float = 0.0):
    """Willmore flow of a graph z = u(x, y), coupled second-order system
    (reference applications/Willmore/WillmoreGraph/ex2/ex2.cpp:485-522):

      A^2 = 1 + |grad u|^2,  B = I - grad(u) grad(u)^T / A^2
      W-eq:  (2 W / A) phi + (grad u / A) . grad phi = 0      (W = curvature)
      u-eq:  (1/A) [ B grad W - (W^2/A^2 + c) grad u ] . grad phi = 0

    Exact steady solution: any sphere cap u = sqrt(R^2 - r^2) with
    W = -1/u (spheres are Willmore surfaces)."""

    def form(ops, u, aux):
        Gu = ops.grad(family, u[u_var])                   # (nq, dim[, ne])
        Wq = ops.value(family, u[w_var])
        GW = ops.grad(family, u[w_var])
        A2 = 1.0 + tensors.vdot(Gu, Gu)
        A = torch.sqrt(A2)
        # B gradW = gradW - (gradu . gradW) gradu / A^2
        BgW = GW - tensors.qp(tensors.vdot(Gu, GW) / A2) * Gu
        flux_u = (BgW - tensors.qp(Wq * Wq / A2 + c) * Gu) / tensors.qp(A)
        return {
            w_var: (ops.t(family, -2.0 * Wq / A)
                    - ops.tgrad(family, Gu / tensors.qp(A))),
            u_var: ops.tgrad(family, flux_u),
        }

    return form


# ---- boundary-face forms (Assembler.set_face_form) -------------------------

def neumann_faces(flux: Dict[int, Callable], var: str = "u"):
    """Neumann surface term: -integral g phi ds on faces of given groups.

    flux: group -> g(x (nq, dim), normal (nq, dim)) returning (nq,).
    """

    def form(fops, u, fams, grp, aux):
        fam = fams[var]
        r = torch.zeros_like(u[var])
        for g, fn in flux.items():
            gq = fn(fops.x, fops.normal)
            r = r + torch.where(grp == g, -fops.t(fam, gq), 0.0)
        return {var: r}

    return form


def nitsche_dirichlet(var: str = "u", family: str = "biquadratic",
                      g_fn: Optional[Callable] = None, gamma: float = 20.0,
                      kappa: float = 1.0, groups: Optional[Sequence] = None):
    """Weak Dirichlet enforcement by Nitsche's method (reference ``Nitsche``
    application): on boundary faces (optionally restricted to ``groups``)

      - kappa du/dn v  - kappa dv/dn (u - g)  + gamma kappa / h (u - g) v

    Use with ``Assembler.set_face_form(form, volume=True)``: the terms need
    the owning element's trial space (VolumeFaceOps).  No strong Dirichlet
    rows are eliminated; convergence is optimal for gamma large enough
    (scales with the polynomial degree squared)."""

    def face_form(fops, u, grp, aux):
        uq = fops.value(family, u[var])
        dn = fops.dn(family, u[var])
        gq = g_fn(fops.x) if g_fn is not None else 0.0
        mism = uq - gq
        sel = 1.0
        if groups is not None:
            sel = sum((grp == g0).to(uq.dtype) for g0 in groups)
        r = (-kappa * fops.t(family, dn * sel)
             - kappa * fops.tn(family, mism * sel)
             + gamma * kappa / fops.h * fops.t(family, mism * sel))
        return {var: r}

    return face_form
