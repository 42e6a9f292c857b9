"""Monolithic fluid-structure interaction (ALE), steady and transient.

Unknowns: displacement d, velocity U, pressure p over the whole domain;
the material of each element comes from ``mesh.elem_group``:

- fluid elements: Navier-Stokes momentum and continuity on the DISPLACED
  configuration (``ops.moved`` rebuilds the geometry inside the function
  the engine differentiates, so the Jacobian carries the shape
  derivatives); mesh motion by harmonic extension of d on the reference
  configuration.
- solid elements: the total-Lagrangian elasticity residual P(F(d)) :
  grad(phi) tested with the velocity test functions (the traction balance
  at the interface comes from the shared test space); kinematic rows tie
  U = 0 (steady) or (d - d_old)/dt = U (transient); pressure rows give
  p = 0 (compressible solid) or J - 1 = 0 (incompressible).

Both materials are evaluated in every element and blended with 0/1
weights, as the reference does: the neo-Hookean log(J) of a fluid element
is computed and multiplied by 0.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..algebra.transfer import fsi_restriction_transpose
from ..assembly import tensors
from .system import NonLinearImplicitSystem
from .transient import _TransientMixin


def _solid_weights(grp, solid_groups, dtype):
    """(w_s, w_f): 1/0 per element for solid / fluid."""
    is_solid = torch.zeros_like(grp, dtype=torch.bool)
    for g in solid_groups:
        is_solid = is_solid | (grp == g)
    w_s = is_solid.to(dtype)
    return w_s, 1.0 - w_s


def _solid_stress(G, dim, solid_model, lam, mu, incompressible_solid, ops,
                  pres_family, p):
    """First Piola stress of the solid material at displacement gradient
    ``G`` (nq, dim, dim, ne)."""
    I = tensors.eye_like(dim, G)
    F = I + G
    if solid_model == "saint-venant":
        E = 0.5 * (tensors.matTmul(F, F) - I)
        S = 2 * mu * E + lam * tensors.qpm(tensors.trace(E)) * I
        P = tensors.matmul(F, S)
    else:  # neo-hookean
        J = tensors.det(F)
        FinvT = tensors.transpose(tensors.inv(F))
        P = mu * (F - FinvT) + lam * tensors.qpm(torch.log(J)) * FinvT
    if incompressible_solid:
        Js = tensors.det(F)
        FinvT = tensors.transpose(tensors.inv(F))
        ps = ops.value(pres_family, p)
        P = P - tensors.qpm(ps * Js) * FinvT
    return P


def _pressure_rows(ops, mops, G, Gv, dim, pres_family, p,
                   incompressible_solid, w_s, w_f):
    """Continuity on the moved configuration (fluid) / solid pressure."""
    divV = sum(Gv[e][:, e] for e in range(dim))
    if incompressible_solid:
        Js = tensors.det(tensors.eye_like(dim, G) + G)
        rs_p = ops.t(pres_family, Js - 1.0)
    else:
        rs_p = ops.t(pres_family, ops.value(pres_family, p))
    return w_f * (-mops.t(pres_family, divV)) + w_s * rs_p


def fsi_steady_form(disp=("dx", "dy"), vel=("u", "v"), pres: str = "p",
                    solid_groups: Sequence[int] = (1,),
                    disp_family: str = "biquadratic",
                    vel_family: str = "biquadratic", pres_family: str = "linear",
                    nu: float = 1.0, lam: float = 1.0, mu: float = 1.0,
                    solid_model: str = "neo-hookean",
                    kappa_mesh: float = 1.0,
                    force: Optional[Callable] = None,
                    incompressible_solid: bool = False):
    """Steady monolithic ALE FSI residual (see the module docstring).
    The displacement lives on the geometry family, so it moves the mesh."""
    dim = len(disp)
    solid_groups = tuple(int(g) for g in solid_groups)

    def form(ops, u, aux):
        w_s, w_f = _solid_weights(aux["group"], solid_groups,
                                  u[pres].dtype)
        d_nodes = torch.stack([u[c] for c in disp], dim=1)   # (nd, dim, ne)
        mops = ops.moved(d_nodes)
        G = torch.stack([ops.grad(disp_family, u[c]) for c in disp], dim=1)
        out = {}

        # fluid: Navier-Stokes on the moved configuration
        Vq = [mops.value(vel_family, u[c]) for c in vel]
        Gv = [mops.grad(vel_family, u[c]) for c in vel]
        pq = mops.value(pres_family, u[pres])
        fq = mops.pointwise(force) if force is not None else None
        # solid: total-Lagrangian stress on the reference configuration
        P = _solid_stress(G, dim, solid_model, lam, mu, incompressible_solid,
                          ops, pres_family, u[pres])

        for c_i, c in enumerate(vel):
            adv = sum(Vq[e] * Gv[c_i][:, e] for e in range(dim))
            rf = (nu * mops.tgrad(vel_family, Gv[c_i])
                  + mops.t(vel_family, adv)
                  - mops.tgrad_d(vel_family, pq, c_i))
            if fq is not None:
                rf = rf - mops.t(vel_family, fq[:, c_i])
            rs = ops.tgrad(vel_family, P[:, c_i])
            out[c] = w_f * rf + w_s * rs

        out[pres] = _pressure_rows(ops, mops, G, Gv, dim, pres_family,
                                   u[pres], incompressible_solid, w_s, w_f)

        # displacement rows: fluid mesh harmonic extension / solid kinematics
        for c_i, c in enumerate(disp):
            r_mesh = kappa_mesh * ops.tgrad(disp_family, G[:, c_i])
            r_kin = ops.t(disp_family, ops.value(vel_family, u[vel[c_i]]))
            out[c] = w_f * r_mesh + w_s * r_kin
        return out

    return form


class MonolithicFSISystem(NonLinearImplicitSystem):
    """Nonlinear monolithic FSI system (steady) with the FSI Petrov-Galerkin
    transfers: P stays the block interpolant, the restriction routes
    interface-crossing entries between paired variables (``pair_solution``,
    e.g. u -> dx) or drops them (self-paired dx, dy), and coarse operators
    are the non-symmetric R A P.

    Set ``solid_groups`` (the element groups of the solid material) before
    ``init()``; material-split smoother blocks come from
    ``config.vanka_groups = "material"``."""

    solid_groups: Sequence[int] = ()

    def _make_transfer_pair(self, l: int):
        P, _ = super()._make_transfer_pair(l)
        if not self.solid_groups and not self.ml_sol.pairs:
            return P, None
        RRt = fsi_restriction_transpose(
            self.ml_mesh.levels[l], self.ml_mesh.levels[l + 1],
            self.unknowns, self.ml_sol.pairs, self.solid_groups)
        return P, RRt.T.tocsr()


def fsi_transient_form(disp=("dx", "dy"), vel=("u", "v"), pres: str = "p",
                       solid_groups: Sequence[int] = (1,),
                       disp_family: str = "biquadratic",
                       vel_family: str = "biquadratic",
                       pres_family: str = "linear",
                       rho_f: float = 1.0, nu: float = 1.0,
                       rho_s: float = 1.0, lam: float = 1.0, mu: float = 1.0,
                       solid_model: str = "neo-hookean",
                       kappa_mesh: float = 1.0,
                       force: Optional[Callable] = None,
                       incompressible_solid: bool = False,
                       theta: float = 1.0):
    """Time-dependent monolithic ALE FSI residual, the moving-domain
    analogue of :func:`fsi_steady_form`:

    - fluid (moved configuration): rho_f [ (U - U_old)/dt
      + (U - w) . grad U ] with the mesh velocity w = (d - d_old)/dt at the
      quadrature points, plus the viscous and pressure terms; continuity on
      the moved configuration.
    - solid (reference configuration): rho_s (U - U_old)/dt + div P(F(d));
      the kinematic row (d - d_old)/dt = U.
    - fluid displacement rows: harmonic extension of d.

    ``theta`` blends the fluid viscous/advective terms between the new and
    the old velocity on the NEW configuration (1 = backward Euler); the
    pressure and continuity stay fully implicit.  The form reads the aux
    fields '<var>_old' of every displacement and velocity component and
    the scalar 'dt' (``_TransientMixin.init_time`` provides them for
    variables with time_order=1)."""
    dim = len(disp)
    solid_groups = tuple(int(g) for g in solid_groups)

    def form(ops, u, aux):
        dt = aux["dt"]
        w_s, w_f = _solid_weights(aux["group"], solid_groups,
                                  u[pres].dtype)
        d_nodes = torch.stack([u[c] for c in disp], dim=1)
        mops = ops.moved(d_nodes)
        G = torch.stack([ops.grad(disp_family, u[c]) for c in disp], dim=1)
        out = {}

        # fluid: ALE Navier-Stokes on the moved configuration
        Vq = [mops.value(vel_family, u[c]) for c in vel]
        Voq = [mops.value(vel_family, aux[c + "_old"]) for c in vel]
        Gv = [mops.grad(vel_family, u[c]) for c in vel]
        Gvo = ([mops.grad(vel_family, aux[c + "_old"]) for c in vel]
               if theta < 1.0 else None)
        pq = mops.value(pres_family, u[pres])
        fq = mops.pointwise(force) if force is not None else None
        # mesh velocity at the quadrature points (ALE convective correction)
        wq = [(mops.value(disp_family, u[c])
               - mops.value(disp_family, aux[c + "_old"])) / dt for c in disp]
        # solid: total-Lagrangian stress on the reference configuration
        P = _solid_stress(G, dim, solid_model, lam, mu, incompressible_solid,
                          ops, pres_family, u[pres])

        for c_i, c in enumerate(vel):
            dudt = (Vq[c_i] - Voq[c_i]) / dt
            adv = sum((Vq[e] - wq[e]) * Gv[c_i][:, e] for e in range(dim))
            spat = (nu * mops.tgrad(vel_family, Gv[c_i])
                    + rho_f * mops.t(vel_family, adv))
            if theta < 1.0:
                adv_o = sum((Voq[e] - wq[e]) * Gvo[c_i][:, e]
                            for e in range(dim))
                spat_o = (nu * mops.tgrad(vel_family, Gvo[c_i])
                          + rho_f * mops.t(vel_family, adv_o))
                spat = theta * spat + (1.0 - theta) * spat_o
            rf = (rho_f * mops.t(vel_family, dudt) + spat
                  - mops.tgrad_d(vel_family, pq, c_i))
            if fq is not None:
                rf = rf - mops.t(vel_family, fq[:, c_i])
            # solid momentum: rho_s dU/dt + div P (reference configuration)
            Uq = ops.value(vel_family, u[c])
            Uoq = ops.value(vel_family, aux[c + "_old"])
            rs = (rho_s * ops.t(vel_family, (Uq - Uoq) / dt)
                  + ops.tgrad(vel_family, P[:, c_i]))
            out[c] = w_f * rf + w_s * rs

        out[pres] = _pressure_rows(ops, mops, G, Gv, dim, pres_family,
                                   u[pres], incompressible_solid, w_s, w_f)

        # displacement rows: fluid harmonic extension / solid kinematics
        for c_i, c in enumerate(disp):
            r_mesh = kappa_mesh * ops.tgrad(disp_family, G[:, c_i])
            dq = ops.value(disp_family, u[c])
            doq = ops.value(disp_family, aux[c + "_old"])
            Uq = ops.value(vel_family, u[vel[c_i]])
            r_kin = ops.t(disp_family, (dq - doq) / dt - Uq)
            out[c] = w_f * r_mesh + w_s * r_kin
        return out

    return form


class TransientMonolithicFSI(_TransientMixin, MonolithicFSISystem):
    """Time-dependent monolithic FSI: init_time(dt) + init() + time_step().
    The displacement and velocity unknowns carry time_order=1, so the
    mixin wires the '<var>_old' aux fields :func:`fsi_transient_form`
    reads."""
