"""Solid constitutive models (Cauchy stress in the moved configuration).

The ``Solid`` material registry and the stress branches of the FSI
assemblies:

  model 0  "Linear_elastic" / "Saint-Venant"  : sigma = 2 mu e  (+ vol term)
  model 1  "Neo-Hookean"                      : sigma = mu B            - inc mu I1(B) p I
  model 2  "Neo-Hookean-BW"  (Bonet-Wood)     : sigma = mu/J B          - inc mu/J p I
  model 3  "Neo-Hookean-BW-Penalty"           : sigma = mu (B - I)/J    + lam/J log(J) I
  model 4  "Neo-Hookean-AB-Penalty" (Allan-Bower):
           sigma = mu (B - I1(B) I/3)/J^{5/3} + lam (J - 1) I
  model 5  "Mooney-Rivlin"                    : sigma = 2 (C1 B - C2 B^-1) - inc p I,
           C1 = mu/3, C2 = C1/2

with B = F F^T the left Cauchy-Green tensor, F = I + grad_hat(d), J = det F,
p the (nondimensional) solid pressure unknown for the incompressible models.
2-D problems are plane strain: F is embedded in 3x3 with F_33 = 1 and the
in-plane block of sigma is returned.
"""
from __future__ import annotations

import torch

from ..assembly import tensors

# canonical-name -> model id (case-insensitive; "-MassPenalty" suffixes
# share the base model id)
MODEL_IDS = {
    "linear_elastic": 0, "linear": 0, "saint-venant": 0,
    "saint-venant-penalty": 0,
    "neo-hookean": 1, "neo-hookean-masspenalty": 1,
    "neo-hookean-bw": 2, "neo-hookean-bw-masspenalty": 2,
    "neo-hookean-bw-penalty": 3,
    "neo-hookean-ab-penalty": 4,
    "mooney-rivlin": 5, "mooney-rivlin-masspenalty": 5,
}


def _embed3(G):
    """Embed an (nq, d, d[, ne]) displacement gradient into 3x3 (plane
    strain); a trailing element axis passes through."""
    d = G.shape[1]
    if d == 3:
        return G
    pad = G.new_zeros(G.shape[:1] + (3 - d, d) + G.shape[3:])
    G = torch.cat([G, pad], dim=1)                        # (nq, 3, d, ...)
    pad = G.new_zeros(G.shape[:2] + (3 - d,) + G.shape[3:])
    return torch.cat([G, pad], dim=2)


def cauchy_stress(model, Gd_hat, mu, lam=0.0, p=None, incompressible=True):
    """Cauchy stress sigma (nq, dim, dim[, ne]) on the moved configuration.

    Gd_hat: (nq, dim, dim[, ne]) hat-frame displacement gradient, dim in
    {2, 3}; p: optional (nq[, ne]) pressure for the incompressible models."""
    mid = MODEL_IDS[model.lower()] if isinstance(model, str) else int(model)
    dim = Gd_hat.shape[1]
    G3 = _embed3(Gd_hat)
    I = tensors.eye_like(3, G3)
    F = I + G3
    inc = 1.0 if (incompressible and p is not None) else 0.0
    pq = p if p is not None else 0.0

    if mid == 0:
        e = 0.5 * (G3 + tensors.transpose(G3))
        tre = tensors.trace(e)
        sig = 2.0 * mu * e
        if inc:
            sig = sig - tensors.qpm(2.0 * mu * tre * pq) * I
        else:
            sig = sig + tensors.qpm(lam * tre) * I
        return sig[:, :dim, :dim]

    B = tensors.matmulT(F, F)
    J = tensors.det(F)
    I1 = tensors.trace(B)
    if mid == 1:
        sig = mu * B - tensors.qpm(inc * mu * I1 * pq) * I
    elif mid == 2:
        sig = tensors.qpm(mu / J) * B - tensors.qpm(inc * mu / J * pq) * I
    elif mid == 3:
        sig = (tensors.qpm(mu / J) * (B - I)
               + tensors.qpm(lam / J * torch.log(J)) * I)
    elif mid == 4:
        sig = (tensors.qpm(mu / J ** (5.0 / 3.0))
               * (B - tensors.qpm(I1 / 3.0) * I)
               + tensors.qpm(lam * (J - 1.0)) * I)
    elif mid == 5:
        C1 = mu / 3.0
        C2 = C1 / 2.0
        sig = 2.0 * (C1 * B - C2 * tensors.inv(B))
        if inc:
            sig = sig - tensors.qpm(pq) * I
    else:
        raise KeyError(model)
    return sig[:, :dim, :dim]


def first_piola(model, Gd_hat, mu, lam=0.0, p=None, incompressible=True):
    """First Piola-Kirchhoff stress P = J sigma F^{-T} (total-Lagrangian
    assembly on the reference configuration)."""
    dim = Gd_hat.shape[1]
    sig = cauchy_stress(model, Gd_hat, mu, lam, p, incompressible)
    F = tensors.eye_like(dim, Gd_hat) + Gd_hat
    J = tensors.det(F)
    FinvT = tensors.transpose(tensors.inv(F))
    return tensors.qpm(J) * tensors.matmul(sig, FinvT)
