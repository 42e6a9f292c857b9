"""Krylov solvers: CG and restarted GMRES (CGS2).

Operators and preconditioners are callables ``A(x) -> y`` on device
tensors, so assembled SpMV, blocked-ELL SpMV and multigrid cycles compose
freely.  The iteration bounds are the ``femus_tpu`` ones; the early exits
are Python loops.  Each iteration reads one small vector back to the host
to decide whether to go on (GMRES: the new Hessenberg column, whose Givens
rotation gives |g[j+1]|; CG: the residual norm).  That one synchronisation
per iteration is accepted here; capturing whole cycles in CUDA graphs is
later work.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.linalg
import torch


class SolveInfo(NamedTuple):
    iters: int
    residual: float       # final (preconditioned, for GMRES) residual norm
    converged: bool       # the stopping test was met within the bounds


def cg(A: Callable, b: torch.Tensor, x0=None, M: Optional[Callable] = None,
       tol: float = 1e-10, atol: float = 0.0, maxiter: int = 1000):
    """Preconditioned conjugate gradient.  Returns (x, SolveInfo)."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = M or (lambda r: r)
    r = b - A(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    target = max(tol * float(torch.linalg.norm(b)), atol)
    k = 0
    while k < maxiter and float(torch.linalg.norm(r)) > target:
        Ap = A(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    res = float(torch.linalg.norm(r))
    return x, SolveInfo(k, res, bool(res <= target))


def _givens(a: float, b: float):
    """Stable Givens rotation (c, s) with c*a + s*b = r, -s*a + c*b = 0."""
    h = float(np.hypot(a, b))
    if h == 0.0:
        return 1.0, 0.0
    return a / h, b / h


def gmres(A: Callable, b: torch.Tensor, x0=None, M: Optional[Callable] = None,
          tol: float = 1e-10, atol: float = 0.0, restart: int = 30,
          max_restarts: int = 20):
    """Restarted GMRES(m), left-preconditioned (solves M A x = M b), CGS2
    orthogonalization (two global reductions per iteration), Givens
    rotations with early exit once |g[j]| <= max(tol*||M b||, atol).

    The (m+1)-vector basis lives on the device; the small Hessenberg
    least-squares problem is solved on the host in float64."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = M or (lambda r: r)
    n, m = b.shape[0], restart

    def resid(x):
        return M(b - A(x))

    target = max(tol * float(torch.linalg.norm(M(b))), atol)
    r = resid(x)
    res = float(torch.linalg.norm(r))
    total = 0
    V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
    for k in range(max_restarts):
        if res <= target:
            break
        if k > 0:
            r = resid(x)
        beta = float(torch.linalg.norm(r))
        V[0] = r / (beta if beta != 0.0 else 1.0)
        H = np.zeros((m + 1, m))
        cs, sn = np.zeros(m), np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        j = 0
        while j < m and abs(g[j]) > target:
            w = M(A(V[j]))
            # CGS2 against the j+1 basis vectors so far
            Vj = V[:j + 1]
            h1 = Vj @ w
            w = w - Vj.T @ h1
            h2 = Vj @ w
            w = w - Vj.T @ h2
            wnorm = torch.linalg.norm(w)
            V[j + 1] = w / torch.where(wnorm == 0, 1.0, wnorm)
            # the iteration's one host read: the new Hessenberg column
            col = np.zeros(m + 1)
            col[:j + 2] = torch.cat([h1 + h2, wnorm[None]]).cpu().numpy()
            for i in range(j):
                hi = cs[i] * col[i] + sn[i] * col[i + 1]
                col[i + 1] = -sn[i] * col[i] + cs[i] * col[i + 1]
                col[i] = hi
            c, s = _givens(col[j], col[j + 1])
            col[j] = c * col[j] + s * col[j + 1]
            col[j + 1] = 0.0
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            H[:, j] = col
            cs[j], sn[j] = c, s
            j += 1
        if j:
            y = scipy.linalg.solve_triangular(H[:j, :j], g[:j], lower=False)
            x = x + V[:j].T @ torch.as_tensor(y, dtype=b.dtype,
                                              device=b.device)
        total += j
        res = abs(g[j])
    return x, SolveInfo(total, float(torch.linalg.norm(resid(x))),
                        bool(res <= target))
