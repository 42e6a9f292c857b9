"""Geometric multigrid V-cycle as a preconditioner.

An :class:`MGHierarchy` holds per-level operators (the assembled fine
operator and its Galerkin PtAP-coarsened levels, or operators assembled on
every level's own mesh), prolongation/restriction operator pairs and
smoother closures.  The coarsest level is solved directly: its dense
operator is LU-factored once per hierarchy build and each application is
one ``lu_solve``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from .. import resolve_device
from .smoothers import chebyshev_smoother, jacobi_smoother, power_lambda_max
from .sparse import SparseOp


@dataclasses.dataclass
class MGLevel:
    A: SparseOp
    P: Optional[SparseOp] = None          # prolongation from the level below
    R: Optional[SparseOp] = None          # restriction (P^T) to the level below
    smoother: Optional[Callable] = None   # smooth(b, x) -> x


@dataclasses.dataclass
class MGHierarchy:
    """levels[0] = coarsest, levels[-1] = finest."""

    levels: List[MGLevel]
    n_pre: int = 2
    n_post: int = 2
    coarse_lu: Optional[tuple] = None     # (LU, pivots) of the dense coarse A

    def setup_coarse(self):
        """Factor the dense coarsest operator once."""
        self.coarse_lu = torch.linalg.lu_factor(self.levels[0].A.to_dense())

    def coarse_solve(self, b):
        if self.coarse_lu is not None:
            lu, piv = self.coarse_lu
            return torch.linalg.lu_solve(lu, piv, b.to(lu.dtype)[:, None]
                                         )[:, 0].to(b.dtype)
        lv = self.levels[0]
        x = torch.zeros_like(b)
        for _ in range(20):
            x = lv.smoother(b, x)
        return x

    def v_cycle(self, b, x=None, level: Optional[int] = None):
        l = len(self.levels) - 1 if level is None else level
        lv = self.levels[l]
        if l == 0:
            return self.coarse_solve(b)
        x = torch.zeros_like(b) if x is None else x
        for _ in range(self.n_pre):
            x = lv.smoother(b, x)
        r = b - lv.A @ x
        ec = self.v_cycle(lv.R @ r, level=l - 1)
        x = x + lv.P @ ec
        for _ in range(self.n_post):
            x = lv.smoother(b, x)
        return x

    def as_preconditioner(self) -> Callable:
        """One V-cycle as M^{-1}."""
        return lambda r: self.v_cycle(r)


def apply_dirichlet_identity(op: SparseOp, valid: torch.Tensor,
                             mask: torch.Tensor) -> SparseOp:
    """Zero rows/cols at masked dofs and put 1 on their diagonal (symmetric
    elimination, matching assembly/engine.py)."""
    rows = torch.arange(op.n_rows, device=op.cols.device)[:, None]
    bad = mask[:, None] | mask[op.cols]
    ident = (op.cols == rows) & mask[:, None] & valid
    data = torch.where(bad, ident.to(op.data.dtype), op.data)
    return SparseOp(data, op.cols, op.n_cols)


def _point_smoother(A, smoother: str, jacobi_omega: float,
                    cheb_degree: int) -> Callable:
    """Jacobi or Chebyshev on D^-1 A (Chebyshev: lambda_max by power
    iteration, one per hierarchy build)."""
    diag = A.diagonal()
    # guard zero diagonals (e.g. pressure block)
    safe = torch.where(diag.abs() < 1e-30, 1.0, diag)
    if smoother == "jacobi":
        return jacobi_smoother(A.matvec, safe, jacobi_omega, iters=1)
    lam = power_lambda_max(A.matvec, 1.0 / safe, A.n_rows)
    return chebyshev_smoother(A.matvec, safe, lam, degree=cheb_degree)


def build_hierarchy(fine_op: SparseOp,
                    transfers: Sequence,   # [(P_op, R_op, ptap_schedule)] coarse->fine
                    smoother: str = "chebyshev",
                    n_pre: int = 2, n_post: int = 2,
                    jacobi_omega: float = 0.8,
                    cheb_degree: int = 3,
                    dir_masks: Optional[Sequence] = None,
                    vanka_blocks: Optional[Sequence] = None,
                    vanka_omega: float = 0.9,
                    vanka_multiplicative: bool = True,
                    coarse_dense_max: Optional[int] = None,
                    bell_plans: Optional[Sequence] = None,
                    device="cuda") -> MGHierarchy:
    """Construct the hierarchy from the finest assembled op via the PtAP
    chain, on ``device``.

    transfers[i] connects level i (coarse) to level i+1 (fine).  dir_masks
    (coarse->fine, excluding the finest, whose operator arrives eliminated)
    restores identity rows on the Galerkin-coarsened operators.  bell_plans
    (coarse->fine, one per level, BellDev/BellPlan or None) re-lays each
    level's matvec onto the blocked-ELL slab; PtAP and smoother block
    extraction keep reading the ELL side."""
    device = resolve_device(device)
    n_levels = len(transfers) + 1
    ops = [None] * n_levels
    ops[-1] = fine_op
    for l in range(n_levels - 2, -1, -1):
        sched = transfers[l][2]
        op_c = SparseOp(sched.apply(ops[l + 1].data.to(device)),
                        sched.coarse_cols, sched.coarse_pattern.n_cols)
        if dir_masks is not None and dir_masks[l] is not None:
            op_c = apply_dirichlet_identity(
                op_c, sched.coarse_valid,
                torch.as_tensor(dir_masks[l], device=device))
        ops[l] = op_c
    # a dense-LU coarsest level is never smoothed or multiplied in the
    # V-cycle: it gets neither a BELL slab nor a smoother
    coarse_lu = coarse_dense_max is None or ops[0].n_rows <= coarse_dense_max
    if bell_plans is not None:
        from .bell import BellBackedOp, bell_backed
        ops = [bell_backed(bp, A)
               if (bp is not None and not isinstance(A, BellBackedOp)
                   and not (l == 0 and coarse_lu)) else A
               for l, (bp, A) in enumerate(zip(bell_plans, ops))]
    levels = []
    for l in range(n_levels):
        A = ops[l]
        if l == 0 and coarse_lu:
            sm = None
        elif (smoother == "vanka" and vanka_blocks is not None
                and vanka_blocks[l] is not None):
            from .vanka import vanka_smoother
            sm = vanka_smoother(A, vanka_blocks[l], omega=vanka_omega,
                                multiplicative=vanka_multiplicative)
        else:
            sm = _point_smoother(A, smoother, jacobi_omega, cheb_degree)
        P = R = None
        if l > 0:
            P, R = transfers[l - 1][0], transfers[l - 1][1]
        levels.append(MGLevel(A, P, R, sm))
    h = MGHierarchy(levels, n_pre, n_post)
    if coarse_lu:
        h.setup_coarse()          # else: coarse solve = repeated smoothing
    return h


def build_hierarchy_from_ops(ops: Sequence, pr_pairs: Sequence,
                             smoother: str = "chebyshev",
                             n_pre: int = 2, n_post: int = 2,
                             jacobi_omega: float = 0.8,
                             cheb_degree: int = 3) -> MGHierarchy:
    """Hierarchy from EXPLICIT per-level operators (coarsest first) — the
    rediscretized (non-Galerkin) mode: each level's operator is assembled
    on its own mesh instead of PtAP-chained from the finest, so any
    operator with ``matvec``/``diagonal`` fits (ELL, patch stencil).
    ``pr_pairs[l]`` = (P, R) connecting level l to l+1.  The coarsest
    level is LU-factored once here and never smoothed."""
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"smoother {smoother!r}: rediscretized hierarchies "
                         "take 'jacobi' or 'chebyshev'")
    levels = [MGLevel(ops[0])]
    for l in range(1, len(ops)):
        P, R = pr_pairs[l - 1][0], pr_pairs[l - 1][1]
        levels.append(MGLevel(ops[l], P, R, _point_smoother(
            ops[l], smoother, jacobi_omega, cheb_degree)))
    h = MGHierarchy(levels, n_pre, n_post)
    h.setup_coarse()
    return h
