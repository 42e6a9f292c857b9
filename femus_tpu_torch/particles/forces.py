"""Marker body forces: magnetophoretic force fields (ISM applications).

Reference: ``MagneticForce`` (applications/ISM/magnetic_force_test/
magnetic_force_test.cpp:80-526, same function in magnetic_stents /
tube_validation): the H-field of an infinite straight wire or a circular
current loop (Smythe elliptic-integral form), the magnetophoretic force on a
superparamagnetic particle

    Fm = (pi D^3 mu0 chi / 12) grad(H^2)        if H <  Msat/chi
    Fm = (pi D^3 mu0 Msat / 6) grad(H)          if H >= Msat/chi

normalized by Stokes drag 3 pi D mu_f (the force enters marker advection as
a velocity increment), and sign-flipped to be attractive.

The reference hand-derives the 3x3 Jacobian of the loop field over ~100
lines of elliptic-integral calculus; here the field H(x) of one point is
written once (complete elliptic integrals via the differentiable AGM
iteration) and ``torch.func.grad`` under ``torch.func.vmap`` supplies
grad(H^2) of a whole batch exactly.  Note the reference calls boost's
``ellint_1(k)`` (modulus convention) with k^2; we use the standard Smythe
form with parameter m = k^2 throughout.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

MU0 = 4e-7 * np.pi


def ellipk_ellipe(m, iters: int = 9):
    """Complete elliptic integrals K(m), E(m) (parameter convention,
    m = k^2) by the arithmetic-geometric mean — smooth torch ops only,
    differentiable, float64-accurate in <= 9 iterations for m in [0, 1)."""
    a = torch.ones_like(m)
    b = torch.sqrt(1.0 - m)
    c2_sum = 0.5 * m          # 2^{-1} c_0^2, c_0 = sqrt(m)
    pow2 = 1.0
    for _ in range(iters):
        c = 0.5 * (a - b)
        a, b = 0.5 * (a + b), torch.sqrt(a * b)
        pow2 *= 2.0
        c2_sum = c2_sum + 0.5 * pow2 * c * c
    K = torch.pi / (2.0 * a)
    E = K * (1.0 - c2_sum)
    return K, E


def _unit(v: Sequence[float]) -> torch.Tensor:
    v = torch.as_tensor(v, dtype=torch.float64)
    return v / torch.linalg.norm(v)


def wire_H(x0: Sequence[float], v: Sequence[float], I: float) -> Callable:
    """|H| of an infinite straight wire through x0 with direction v
    (reference case 0): H = I / (2 pi d), d = distance to the line.
    Returns H(x (3,)) -> 0-d tensor."""
    x0 = torch.as_tensor(x0, dtype=torch.float64)
    v = _unit(v)

    def H(x):
        vv = v.to(x)
        r = x - x0.to(x)
        perp = r - (r @ vv) * vv
        d2 = perp @ perp
        return I / (2.0 * torch.pi) / torch.sqrt(d2)

    return H


def loop_H(center: Sequence[float], axis: Sequence[float], a: float,
           I: float) -> Callable:
    """|H| of a circular current loop (reference case 1; Smythe 7.10):

      H_rho = I/(2 pi) * z / (rho * beta) * (-K(m) + (a^2+r^2)/alpha^2 E(m))
      H_z   = I/(2 pi) * 1/beta * ( K(m) + (a^2-r^2)/alpha^2 E(m))

    with alpha^2 = (a-rho)^2 + z^2, beta^2 = (a+rho)^2 + z^2,
    m = 4 a rho / beta^2; regularized on the symmetry axis.  Returns
    H(x (3,)) -> 0-d tensor."""
    c0 = torch.as_tensor(center, dtype=torch.float64)
    v = _unit(axis)

    def H(x):
        vv = v.to(x)
        r = x - c0.to(x)
        z = r @ vv
        perp = r - z * vv
        rho2 = perp @ perp
        rho = torch.sqrt(rho2 + 1e-30)
        r2 = rho2 + z * z
        alpha2 = a * a + r2 - 2.0 * a * rho
        beta2 = a * a + r2 + 2.0 * a * rho
        beta = torch.sqrt(beta2)
        m = 4.0 * a * rho / beta2
        K, E = ellipk_ellipe(m)
        pref = I / (2.0 * torch.pi)
        on_axis = rho2 < 1e-10 * a * a
        Hrho = torch.where(
            on_axis, 0.0,
            pref * z / (torch.where(on_axis, 1.0, rho) * beta)
            * (-K + (a * a + r2) / alpha2 * E))
        Hz = pref / beta * (K + (a * a - r2) / alpha2 * E)
        return torch.sqrt(Hrho * Hrho + Hz * Hz)

    return H


def magnetic_force(H_fn: Callable, D: float = 500e-9, chi: float = 3.0,
                   Msat: float = 1e6, mu_f: float = 3.5e-3,
                   attractive: bool = True, dim: int = 3) -> Callable:
    """Build force_fn(x (n, dim)) -> (n, dim) velocity increments of a batch
    of points from a |H| field of one point (reference force law
    magnetic_force_test.cpp:489-525, incl. the Stokes normalization and
    the sign flip).  Computed in float64, returned in x's dtype."""
    H0 = Msat / chi
    C1 = np.pi * D ** 3 * MU0 * chi / 12.0
    C2 = np.pi * D ** 3 * MU0 * Msat / 6.0
    drag = 3.0 * np.pi * D * mu_f
    # for chi > 0, +grad(H^2) already points toward the field source
    # (attraction); the reference negates its own result to force this
    # (the "cheating to have attractive force" block, :516-524)
    sign = 1.0 if attractive else -1.0
    gHsq = torch.func.vmap(torch.func.grad(lambda x3: H_fn(x3) ** 2))
    H_all = torch.func.vmap(H_fn)

    def force(x):
        x3 = x.to(torch.float64)
        if dim < 3:
            x3 = torch.cat([x3, x3.new_zeros(x3.shape[0], 3 - dim)], dim=1)
        g2 = gHsq(x3)
        H = H_all(x3)[:, None]
        gH = g2 / (2.0 * torch.clamp(H, min=1e-30))
        Fm = torch.where(H < H0, C1 * g2, C2 * gH)
        return (sign * Fm[:, :dim] / drag).to(x.dtype)

    return force
