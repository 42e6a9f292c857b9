"""Condition-number estimation (2-norm) of assembled operators.

sigma_max / sigma_min of the operator: Lanczos on A^T A for sigma_max,
inverse power iteration with CG solves for sigma_min — all through the
operator's matvec, no matrix entries needed.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .. import resolve_device
from .krylov import cg


def _ata(A: Callable, At: Callable) -> Callable:
    return lambda x: At(A(x))


def sigma_max(A: Callable, At: Callable, n: int, iters: int = 40,
              dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Largest singular value via Lanczos on A^T A; the iteration vectors
    live on ``device`` (the card unless the caller asks for the host)."""
    device = resolve_device(device)
    B = _ata(A, At)
    v = torch.sin(torch.arange(n, dtype=dtype, device=device) + 1.0)
    v = v / torch.linalg.norm(v)
    alphas = []
    betas = []
    v_prev = torch.zeros_like(v)
    beta = 0.0
    for _ in range(iters):
        w = B(v) - beta * v_prev
        alpha = torch.dot(v, w)
        w = w - alpha * v
        beta = torch.linalg.norm(w)
        alphas.append(alpha)
        betas.append(beta)
        v_prev = v
        v = w / torch.where(beta == 0, 1.0, beta)
    off = torch.stack(betas[:-1])
    T = (torch.diag(torch.stack(alphas)) + torch.diag(off, 1)
         + torch.diag(off, -1))
    lam = torch.linalg.eigvalsh(T)
    return torch.sqrt(torch.clamp(lam[-1], min=0.0))


def sigma_min(A: Callable, At: Callable, n: int, outer: int = 15,
              inner_tol: float = 1e-10, inner_iters: int = 2000,
              dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Smallest singular value via inverse power iteration on A^T A
    (each step: solve A^T A z = v with CG), on ``device`` as
    :func:`sigma_max`."""
    device = resolve_device(device)
    B = _ata(A, At)
    v = torch.cos(torch.arange(n, dtype=dtype, device=device) * 0.7 + 0.3)
    v = v / torch.linalg.norm(v)
    for _ in range(outer):
        z, _ = cg(B, v, tol=inner_tol, maxiter=inner_iters)
        v = z / torch.linalg.norm(z)
    lam_min = torch.dot(v, B(v))
    return torch.sqrt(torch.clamp(lam_min, min=0.0))


def cond_2norm(op, iters: int = 40) -> Tuple[float, float, float]:
    """(cond, sigma_max, sigma_min) for a SparseOp/DiaOp-like operator with
    ``matvec``, ``n_rows`` and ``data`` (whose dtype and device the
    iteration vectors take); ``rmatvec`` is used where present (symmetric
    operators apply ``matvec`` twice)."""
    A = op.matvec
    At = getattr(op, "rmatvec", op.matvec)
    n = op.n_rows
    kw = dict(dtype=op.data.dtype, device=op.data.device)
    smax = sigma_max(A, At, n, iters, **kw)
    smin = sigma_min(A, At, n, **kw)
    return float(smax / smin), float(smax), float(smin)
