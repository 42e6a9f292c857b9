"""Conformal minimization of surface parameterizations.

Reference: applications/Conformal (AssembleConformalMinimization,
ex1.cpp:183-530) — reparameterize a (possibly embedded) surface
x = x_hat + Dx to minimize the conformal (Cauchy-Riemann defect) energy

  E = sum_q w_q ( |V|^2 + |W|^2 ),
  V_K = x_,v^K - (N x x_,u)^K,   W_K = x_,u^K + (N x x_,v)^K,

with N the unit surface normal from the current metric and the per-element
"equal weight trick" Area2 = w_q (ex1.cpp:398).  On a planar domain
(N = e_z, x3 = 0) the minimizers with analytic Dirichlet data are the
discrete Cauchy-Riemann (holomorphic) maps.

The residual is the exact AD gradient of the element energy
(``torch.func.grad``), so the engine's batch-first Jacobian (``jacfwd``
over it, under ``vmap``) is its exact Hessian and Newton is
energy-consistent by construction.
"""
from __future__ import annotations

import torch


def _ambient_position(ops, u, disp, family):
    """The element's geometry nodes in 3-D, displaced by the unknowns:
    (nd, 3)."""
    xhat = ops.coords                                     # (nd, sdim)
    nd, sdim = xhat.shape
    comps = []
    for K in range(3):
        base = xhat[:, K] if K < sdim else xhat.new_zeros(nd)
        dK = u[disp[K]] if K < len(disp) and disp[K] in u else 0.0
        comps.append(base + dK)
    return torch.stack(comps, dim=-1)


def conformal_energy(ops, u, disp=("Dx1", "Dx2"), family="biquadratic",
                     normal=None):
    """Per-element conformal energy sum_q w_q (|V|^2 + |W|^2) (ex1.cpp:466)
    over one element's :class:`~femus_tpu_torch.assembly.engine.ElemOps`."""
    x = _ambient_position(ops, u, disp, family)
    dref = ops.dphi_ref(family)                           # (nq, nd, 2)
    x_uv = torch.einsum("qnj,nK->qKj", dref, x)           # (nq, 3, 2)
    if normal is not None:
        N = torch.as_tensor(normal, dtype=x.dtype,
                            device=x.device).expand(x_uv.shape[0], 3)
    else:
        g = torch.einsum("qKi,qKj->qij", x_uv, x_uv)
        detg = g[:, 0, 0] * g[:, 1, 1] - g[:, 0, 1] * g[:, 1, 0]
        N = (torch.linalg.cross(x_uv[:, :, 0], x_uv[:, :, 1])
             / torch.sqrt(detg)[:, None])
    V = x_uv[:, :, 1] - torch.linalg.cross(N, x_uv[:, :, 0])
    W = x_uv[:, :, 0] + torch.linalg.cross(N, x_uv[:, :, 1])
    return torch.sum(ops.qweights * ((V * V).sum(-1) + (W * W).sum(-1)))


def conformal_minimization(disp=("Dx1", "Dx2", "Dx3"),
                           family: str = "biquadratic",
                           normal=None):
    """Weak form over one element's ops; unknowns = ambient displacement
    components of the surface position (pass 2 names on planar meshes:
    x3 = 0 frozen).

    normal: optional frozen unit normal (e.g. (0,0,1) on planar domains —
    the reference's planar mode, ex1.cpp:411-413).  With a frozen normal the
    energy is quadratic in the positions and Newton converges in one step;
    with normal=None the current-metric normal is used (fully nonlinear
    surface case, needs a near-conformal initial guess, which is how the
    reference employs it as a reparameterization pass)."""

    def form(ops, u, aux):
        names = [n for n in disp if n in u]

        def energy(vals):
            uu = {**u, **dict(zip(names, vals))}
            return conformal_energy(ops, uu, disp, family, normal)

        g = torch.func.grad(energy)([u[n] for n in names])
        return dict(zip(names, g))

    # the energy is written per element: assemble through the batch-first
    # layout (Assembler.set_volume_form)
    form.layout = "batch_first"
    return form
