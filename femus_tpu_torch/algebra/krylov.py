"""Krylov solvers: CG, restarted GMRES and FGMRES (CGS2), Richardson.

Operators and preconditioners are callables ``A(x) -> y`` on device
tensors, so assembled SpMV, blocked-ELL SpMV and multigrid cycles compose
freely.  The iteration bounds are the ``femus_tpu`` ones; the early exits
are Python loops.  Each iteration reads one small vector back to the host
to decide whether to go on (GMRES: the new Hessenberg column, whose Givens
rotation gives |g[j+1]|; CG: the residual norm).  That one synchronisation
per iteration is accepted here; capturing whole cycles in CUDA graphs is
later work.

``reduce`` (every solver): the sum over the ranks of a row-partitioned
vector's partial inner products (``parallel.ranks.RankGroup.sum``); each
rank then passes its own rows of ``b`` and ``x0``, and ``A``/``M`` act on
those rows.  ``None`` (one device) leaves every operation as it was.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.linalg
import torch

from ..utils.telemetry import count, span


def _dot(a: torch.Tensor, b: torch.Tensor, reduce: Optional[Callable]):
    return torch.dot(a, b) if reduce is None else reduce(torch.dot(a, b))


def _norm(v: torch.Tensor, reduce: Optional[Callable]) -> torch.Tensor:
    if reduce is None:
        return torch.linalg.norm(v)
    return torch.sqrt(reduce(torch.dot(v, v)))


class SolveInfo(NamedTuple):
    iters: int
    residual: float       # final (preconditioned, for GMRES) residual norm
    converged: bool       # the stopping test was met within the bounds
    target: float         # the residual norm the stopping test aims at


def cg(A: Callable, b: torch.Tensor, x0=None, M: Optional[Callable] = None,
       tol: float = 1e-10, atol: float = 0.0, maxiter: int = 1000,
       reduce: Optional[Callable] = None):
    """Preconditioned conjugate gradient.  Returns (x, SolveInfo)."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = M or (lambda r: r)
    r = b - A(x)
    with span("krylov.precond"):
        z = M(r)
    p = z
    rz = _dot(r, z, reduce)
    target = max(tol * float(_norm(b, reduce)), atol)
    count("host_wait.cg_target")
    k = 0
    while k < maxiter:
        count("host_wait.cg_residual")
        if not float(_norm(r, reduce)) > target:
            break
        Ap = A(p)
        alpha = rz / _dot(p, Ap, reduce)
        x = x + alpha * p
        r = r - alpha * Ap
        with span("krylov.precond"):
            z = M(r)
        rz_new = _dot(r, z, reduce)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    res = float(_norm(r, reduce))
    count("host_wait.cg_residual")
    return x, SolveInfo(k, res, bool(res <= target), target)


def jacobi_cg(A, b: torch.Tensor, mask: Optional[torch.Tensor] = None,
              tol: float = 1e-10, maxiter: int = 1000):
    """:func:`cg` on the operator ``A`` (``matvec``, ``diagonal``),
    preconditioned by its diagonal; diagonal entries below 1e-300 in size
    count as 1.  ``mask`` (bool per row): rows and columns held out of the
    solve (eliminated Dirichlet rows; ``b`` must vanish there, and so does
    the result).  Returns (x, SolveInfo)."""
    d = A.diagonal()
    op = A.matvec
    if mask is not None:
        d = torch.where(mask, 1.0, d)

        def op(v):
            v = torch.where(mask, 0.0, v)
            return torch.where(mask, v, A.matvec(v))

    d = torch.where(d.abs() < 1e-300, 1.0, d)
    return cg(op, b, M=lambda r: r / d, tol=tol, maxiter=maxiter)


def _givens(a: float, b: float):
    """Stable Givens rotation (c, s) with c*a + s*b = r, -s*a + c*b = 0."""
    h = float(np.hypot(a, b))
    if h == 0.0:
        return 1.0, 0.0
    return a / h, b / h


def _gmres_core(opM: Callable, opA: Callable, b: torch.Tensor, x0, M,
                tol: float, atol: float, restart: int, max_restarts: int,
                flexible: bool, reduce: Optional[Callable] = None):
    """Shared GMRES core: Givens-rotated Hessenberg with per-iteration
    residual tracking and early exit at both loop levels, CGS2
    orthogonalization (two global reductions per iteration).

    flexible=False: left-preconditioned (``opM`` = M; solves M A x = M b).
    flexible=True: right-preconditioned FGMRES (``opM`` = identity) that
    applies ``M`` to each basis vector and stores the results Z.

    The (m+1)-vector basis (and Z) lives on the device; the small
    Hessenberg least-squares problem is solved on the host in float64."""
    x = torch.zeros_like(b) if x0 is None else x0
    n, m = b.shape[0], restart

    def resid(x):
        return opM(b - opA(x))

    with span("krylov.precond"):
        target = max(tol * float(_norm(opM(b), reduce)), atol)
        r = resid(x)
    res = float(_norm(r, reduce))
    count("host_wait.gmres_target")
    count("host_wait.gmres_residual")
    total = 0
    V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
    Z = torch.zeros((m, n), dtype=b.dtype, device=b.device) if flexible \
        else None
    for k in range(max_restarts):
        if res <= target:
            break
        if k > 0:
            with span("krylov.precond"):
                r = resid(x)
        beta = float(_norm(r, reduce))
        count("host_wait.gmres_residual")
        V[0] = r / (beta if beta != 0.0 else 1.0)
        H = np.zeros((m + 1, m))
        cs, sn = np.zeros(m), np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        j = 0
        while j < m and abs(g[j]) > target:
            with span("krylov.precond"):
                if flexible:
                    Z[j] = M(V[j])
                    w = opA(Z[j])
                else:
                    w = opM(opA(V[j]))
            with span("krylov.orth"):
                # CGS2 against the j+1 basis vectors so far
                Vj = V[:j + 1]
                h1 = Vj @ w
                if reduce is not None:
                    h1 = reduce(h1)
                w = w - Vj.T @ h1
                h2 = Vj @ w
                if reduce is not None:
                    h2 = reduce(h2)
                w = w - Vj.T @ h2
                wnorm = _norm(w, reduce)
                V[j + 1] = w / torch.where(wnorm == 0, 1.0, wnorm)
                # the iteration's one host read: the new Hessenberg column
                col = np.zeros(m + 1)
                col[:j + 2] = torch.cat([h1 + h2, wnorm[None]]).cpu().numpy()
                count("host_wait.gmres_hessenberg")
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
            with span("krylov.orth"):
                y = scipy.linalg.solve_triangular(H[:j, :j], g[:j],
                                                  lower=False)
                basis = Z if flexible else V
                x = x + basis[:j].T @ torch.as_tensor(y, dtype=b.dtype,
                                                      device=b.device)
                count("host_wait.gmres_update_upload")
        total += j
        res = abs(g[j])
    with span("krylov.precond"):
        final = float(_norm(resid(x), reduce))
    count("host_wait.gmres_residual")
    return x, SolveInfo(total, final, bool(res <= target), target)


def gmres(A: Callable, b: torch.Tensor, x0=None, M: Optional[Callable] = None,
          tol: float = 1e-10, atol: float = 0.0, restart: int = 30,
          max_restarts: int = 20, reduce: Optional[Callable] = None):
    """Restarted GMRES(m), left-preconditioned (solves M A x = M b), with
    early exit once |g[j]| <= max(tol*||M b||, atol).  ``converged``
    reports that estimate; ``residual`` is the true ||M (b - A x)|| at the
    returned x, to hold against ``target``."""
    M = M or (lambda r: r)
    return _gmres_core(M, A, b, x0, M, tol, atol, restart, max_restarts,
                       flexible=False, reduce=reduce)


def fgmres(A: Callable, b: torch.Tensor, x0=None,
           M: Optional[Callable] = None, tol: float = 1e-10,
           atol: float = 0.0, restart: int = 30, max_restarts: int = 20,
           reduce: Optional[Callable] = None):
    """Flexible GMRES (right preconditioning, Saad 1993): tolerates
    nonlinear/varying preconditioners (inner Krylov solves, K-cycles) by
    storing the preconditioned basis Z.  ``residual`` and ``target`` are
    unpreconditioned: ||b - A x|| against max(tol*||b||, atol)."""
    M = M or (lambda r: r)
    return _gmres_core(lambda r: r, A, b, x0, M, tol, atol, restart,
                       max_restarts, flexible=True, reduce=reduce)


def richardson(A: Callable, b: torch.Tensor, x0=None,
               M: Optional[Callable] = None, scale: float = 1.0,
               iters: int = 10) -> torch.Tensor:
    """Fixed-iteration preconditioned Richardson: x += scale * M(b - A x)."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = M or (lambda r: r)
    for _ in range(iters):
        x = x + scale * M(b - A(x))
    return x
