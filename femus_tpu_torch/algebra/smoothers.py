"""Multigrid smoothers: weighted Jacobi and Chebyshev on D^-1 A."""
from __future__ import annotations

from typing import Callable

import torch


def power_lambda_max(A: Callable, dinv: torch.Tensor, n: int,
                     iters: int = 25) -> torch.Tensor:
    """Estimate lambda_max(D^-1 A) by power iteration (deterministic seed)."""
    v = torch.sin(torch.arange(n, dtype=dinv.dtype, device=dinv.device) + 1.0)
    v = v / torch.linalg.norm(v)
    nw = None
    for _ in range(iters):
        w = dinv * A(v)
        nw = torch.linalg.norm(w)
        v = w / nw
    return nw


def jacobi_smoother(A: Callable, diag: torch.Tensor, omega: float = 0.8,
                    iters: int = 2):
    """x <- x + omega D^-1 (b - A x), ``iters`` times."""
    dinv = 1.0 / diag

    def smooth(b, x):
        for _ in range(iters):
            x = x + omega * dinv * (b - A(x))
        return x

    return smooth


def chebyshev_smoother(A: Callable, diag: torch.Tensor,
                       lam_max: torch.Tensor, degree: int = 3,
                       eig_ratio: float = 10.0):
    """Chebyshev polynomial smoother on D^-1 A with eigenvalue window
    [lam_max/eig_ratio, 1.1 lam_max]."""
    dinv = 1.0 / diag
    lmax = 1.1 * lam_max
    lmin = lmax / eig_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    def smooth(b, x):
        r = b - A(x)
        sigma = theta / delta
        rho = 1.0 / sigma
        d = dinv * r / theta
        x = x + d
        for _ in range(degree - 1):
            r = b - A(x)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (dinv * r)
            x = x + d
            rho = rho_new
        return x

    return smooth
