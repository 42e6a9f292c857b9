"""Geometric multigrid cycles (V/W/F/K/additive/kaskade) as preconditioners.

An :class:`MGHierarchy` holds per-level operators (the assembled fine
operator and its Galerkin PtAP-coarsened levels, operators assembled on
every level's own mesh, or a matrix-free fine operator over an assembled
sub-hierarchy), prolongation/restriction operator pairs and smoother
closures.  The coarsest level is solved directly: its dense operator is
LU-factored once per hierarchy build and each application is one
``lu_solve``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from .. import resolve_device
from ..utils.telemetry import count, span, timed
from .krylov import fgmres
from .smoothers import chebyshev_smoother, jacobi_smoother, power_lambda_max
from .sparse import SparseOp


def krylov_smoother(A, M_inner: Callable, m: int = 5) -> Callable:
    """Per-level KRYLOV smoother: ``m`` fixed FGMRES iterations on the
    level residual, right-preconditioned by one inner sweep (e.g. a Vanka
    block sweep).  Unlike a bare stationary block sweep it is
    residual-minimizing, so a sweep that would amplify on a stiff saddle
    point stays a stable smoother inside the Krylov envelope.  It is a
    nonlinear map: the outer iteration must be flexible (FGMRES)."""

    def smooth(b, x):
        r = b - A @ x
        d, _ = fgmres(A.matvec, r, M=M_inner, tol=1e-30, restart=m,
                      max_restarts=1)
        return x + d

    return smooth


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
    compute_dtype: Optional[torch.dtype] = None   # mixed-precision cycle dtype
    k_inner: int = 2                      # K-cycle inner FGMRES iterations

    @timed("mg_setup.coarse_lu")
    def setup_coarse(self):
        """Factor the dense coarsest operator once, in float32 when it is
        stored in bfloat16 (there is no bfloat16 LU)."""
        Ad = self.levels[0].A.to_dense()
        self.coarse_lu = torch.linalg.lu_factor(
            Ad.float() if Ad.dtype == torch.bfloat16 else Ad)
        count("host_wait.coarse_lu_check")

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

    def _descend(self, b, x, l):
        """Pre-smooth on level l and restrict the residual:
        (x, restricted residual)."""
        lv = self.levels[l]
        x = torch.zeros_like(b) if x is None else x
        for _ in range(self.n_pre):
            x = lv.smoother(b, x)
        return x, lv.R @ (b - lv.A @ x)

    def _ascend(self, b, x, ec, l):
        """Add the prolonged coarse correction and post-smooth."""
        lv = self.levels[l]
        x = x + lv.P @ ec
        for _ in range(self.n_post):
            x = lv.smoother(b, x)
        return x

    def v_cycle(self, b, x=None, level: Optional[int] = None):
        l = len(self.levels) - 1 if level is None else level
        if l == 0:
            return self.coarse_solve(b)
        x, rc = self._descend(b, x, l)
        return self._ascend(b, x, self.v_cycle(rc, level=l - 1), l)

    def w_cycle(self, b, x=None, level: Optional[int] = None):
        l = len(self.levels) - 1 if level is None else level
        if l == 0:
            return self.coarse_solve(b)
        x, rc = self._descend(b, x, l)
        ec = self.w_cycle(rc, level=l - 1)
        ec = self.w_cycle(rc, ec, level=l - 1)
        return self._ascend(b, x, ec, l)

    def f_cycle(self, b, level: Optional[int] = None):
        """Full-MG cycle: restrict the rhs to the coarsest grid, solve, and
        ascend — at each level the prolonged coarse solution seeds one
        V-cycle."""
        l = len(self.levels) - 1 if level is None else level
        if l == 0:
            return self.coarse_solve(b)
        lv = self.levels[l]
        ec = self.f_cycle(lv.R @ b, level=l - 1)
        return self.v_cycle(b, lv.P @ ec, level=l)

    def k_cycle(self, b, x=None, level: Optional[int] = None):
        """Krylov-accelerated K-cycle (Notay 2008): like a W-cycle, but the
        coarse-grid correction at every sub-level is computed by
        ``k_inner`` FGMRES iterations preconditioned by the sub-hierarchy's
        own K-cycle.  Residual-minimizing at each level, so it stays stable
        where the W-cycle's doubled corrections overshoot.  A nonlinear
        map: the outer iteration must be flexible (FGMRES)."""
        l = len(self.levels) - 1 if level is None else level
        if l == 0:
            return self.coarse_solve(b)
        x, rc = self._descend(b, x, l)
        if l - 1 == 0:
            ec = self.coarse_solve(rc)
        else:
            ec, _ = fgmres(self.levels[l - 1].A.matvec, rc,
                           M=lambda v: self.k_cycle(v, level=l - 1),
                           tol=1e-30, restart=self.k_inner, max_restarts=1)
        return self._ascend(b, x, ec, l)

    def additive_cycle(self, b, level: Optional[int] = None):
        """Additive MG: every level smooths ITS restriction of the SAME
        residual independently; prolonged corrections sum — no inter-level
        residual updates."""
        l = len(self.levels) - 1 if level is None else level
        if l == 0:
            return self.coarse_solve(b)
        lv = self.levels[l]
        x = torch.zeros_like(b)
        for _ in range(self.n_pre):
            x = lv.smoother(b, x)
        return x + lv.P @ self.additive_cycle(lv.R @ b, level=l - 1)

    def kaskade_cycle(self, b, level: Optional[int] = None):
        """Kaskade / cascadic MG: one coarse-to-fine sweep — solve the
        coarsest restriction, prolong, smooth, never descend again."""
        l = len(self.levels) - 1 if level is None else level
        if l == 0:
            return self.coarse_solve(b)
        lv = self.levels[l]
        x = lv.P @ self.kaskade_cycle(lv.R @ b, level=l - 1)
        for _ in range(self.n_pre + self.n_post):
            x = lv.smoother(b, x)
        return x

    def as_preconditioner(self, cycle: str = "V") -> Callable:
        """One cycle as M^{-1}: "V" | "W" | "F" (full MG) | "K" |
        "ADDITIVE" | "KASKADE".

        If the hierarchy was built with a lower ``compute_dtype`` (mixed
        precision), the input residual is cast down, the cycle runs in
        that dtype, and the correction is cast back: the outer Krylov
        stays in the ambient precision, so only the convergence rate can
        change, not the final accuracy.  bfloat16 is a storage type: its
        operators and transfers hold bfloat16 values and the cycle's
        vectors are float32 (kernel B1 multiplies bfloat16 values into a
        float32 x)."""
        fn = {"V": self.v_cycle, "W": self.w_cycle, "F": self.f_cycle,
              "K": self.k_cycle, "ADDITIVE": self.additive_cycle,
              "KASKADE": self.kaskade_cycle}[cycle.upper()]
        dt = vector_dtype(self.compute_dtype)
        if dt is None:
            return lambda r: fn(r)
        return lambda r: fn(r.to(dt)).to(r.dtype)


@dataclasses.dataclass
class MatFreeOp:
    """Fine-level operator as a J.v closure (the linearised residual).
    Quacks like :class:`SparseOp` where cycles need it (matvec / @)."""

    mv: Callable
    n: int

    @property
    def n_rows(self) -> int:
        return self.n

    def matvec(self, x):
        return self.mv(x)

    def __matmul__(self, x):
        return self.mv(x)


def apply_dirichlet_identity(op: SparseOp, valid: torch.Tensor,
                             mask: torch.Tensor) -> SparseOp:
    """Zero rows/cols at masked dofs and put 1 on their diagonal (symmetric
    elimination, matching assembly/engine.py)."""
    rows = torch.arange(op.n_rows, device=op.cols.device)[:, None]
    bad = mask[:, None] | mask[op.cols]
    ident = (op.cols == rows) & mask[:, None] & valid
    data = torch.where(bad, ident.to(op.data.dtype), op.data)
    return SparseOp(data, op.cols, op.n_cols)


def _point_smoother(matvec: Callable, diag: torch.Tensor, smoother: str,
                    jacobi_omega: float, cheb_degree: int) -> Callable:
    """Jacobi (``smoother == "jacobi"``) or else Chebyshev on D^-1 A
    (lambda_max by power iteration, one per hierarchy build)."""
    # guard zero diagonals (e.g. pressure block)
    safe = torch.where(diag.abs() < 1e-30, 1.0, diag)
    if smoother == "jacobi":
        return jacobi_smoother(matvec, safe, jacobi_omega, iters=1)
    lam = power_lambda_max(matvec, 1.0 / safe, diag.shape[0])
    return chebyshev_smoother(matvec, safe, lam, degree=cheb_degree)


def vector_dtype(dtype: Optional[torch.dtype]) -> Optional[torch.dtype]:
    """The dtype of a cycle's vectors for operators stored in ``dtype``:
    float32 for bfloat16 storage, else ``dtype`` itself."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _cast(op: SparseOp, dtype: torch.dtype) -> SparseOp:
    return SparseOp(op.data.to(dtype), op.cols, op.n_cols)


def build_hierarchy(fine_op: SparseOp,
                    transfers: Sequence,   # [(P_op, R_op, ptap_schedule)] coarse->fine
                    smoother: str = "chebyshev",
                    n_pre: int = 2, n_post: int = 2,
                    jacobi_omega: float = 0.8,
                    cheb_degree: int = 3,
                    dir_masks: Optional[Sequence] = None,
                    vanka_blocks: Optional[Sequence] = None,
                    vanka_omega: float = 0.9,
                    krylov_m: int = 5,
                    vanka_multiplicative: bool = True,
                    compute_dtype: Optional[torch.dtype] = None,
                    coarse_dense_max: Optional[int] = None,
                    bell_plans: Optional[Sequence] = None,
                    device="cuda") -> MGHierarchy:
    """Construct the hierarchy from the finest assembled op via the PtAP
    chain, on ``device``.

    transfers[i] connects level i (coarse) to level i+1 (fine).  dir_masks
    (coarse->fine, excluding the finest, whose operator arrives eliminated)
    restores identity rows on the Galerkin-coarsened operators.  bell_plans
    (coarse->fine, one per level, SellPlan/SellDev or None) re-lays each
    level's matvec onto the sliced-ELL operator; PtAP and smoother block
    extraction keep reading the ELL side.  smoother: "chebyshev" |
    "jacobi" | "vanka" | "vanka_gmres" (the block sweep inside ``krylov_m``
    FGMRES iterations per level, :func:`krylov_smoother`).  compute_dtype:
    the PtAP chain runs in the fine operator's precision, then operators,
    transfers and smoothers are cast to it (see ``as_preconditioner``)."""
    device = resolve_device(device)
    n_levels = len(transfers) + 1
    ops = [None] * n_levels
    ops[-1] = fine_op
    with span("step.coarsen"):
        for l in range(n_levels - 2, -1, -1):
            sched = transfers[l][2]
            op_c = SparseOp(sched.apply(ops[l + 1].data.to(device)),
                            sched.coarse_cols, sched.coarse_pattern.n_cols)
            if dir_masks is not None and dir_masks[l] is not None:
                op_c = apply_dirichlet_identity(
                    op_c, sched.coarse_valid,
                    torch.as_tensor(dir_masks[l], device=device))
            ops[l] = op_c
    with span("step.mg_setup"):
        pr = [(t[0], t[1]) for t in transfers]
        if compute_dtype is not None:
            ops, pr = ([_cast(A, compute_dtype) for A in ops],
                       [(_cast(P, compute_dtype), _cast(R, compute_dtype))
                        for P, R in pr])
        # a dense-LU coarsest level is never smoothed or multiplied in the
        # V-cycle: it gets neither a BELL-frame operator nor a smoother
        coarse_lu = (coarse_dense_max is None
                     or ops[0].n_rows <= coarse_dense_max)
        if bell_plans is not None:
            from .bell import BellBackedOp, bell_backed
            ops = [bell_backed(bp, A)
                   if (bp is not None and not isinstance(A, BellBackedOp)
                       and not (l == 0 and coarse_lu)) else A
                   for l, (bp, A) in enumerate(zip(bell_plans, ops))]
        levels = []
        with span("mg_setup.smoothers"):
            for l in range(n_levels):
                A = ops[l]
                if l == 0 and coarse_lu:
                    sm = None
                elif (smoother in ("vanka", "vanka_gmres")
                        and vanka_blocks is not None
                        and vanka_blocks[l] is not None):
                    from .vanka import vanka_smoother
                    sm = vanka_smoother(A, vanka_blocks[l],
                                        omega=vanka_omega,
                                        multiplicative=vanka_multiplicative)
                    if smoother == "vanka_gmres":
                        sm = krylov_smoother(
                            A, lambda r, _s=sm: _s(r, torch.zeros_like(r)),
                            m=krylov_m)
                else:
                    d = A.diagonal()
                    sm = _point_smoother(A.matvec,
                                         d.to(vector_dtype(d.dtype)),
                                         smoother, jacobi_omega, cheb_degree)
                P, R = pr[l - 1] if l > 0 else (None, None)
                levels.append(MGLevel(A, P, R, sm))
        h = MGHierarchy(levels, n_pre, n_post, compute_dtype=compute_dtype)
        if coarse_lu:
            h.setup_coarse()      # else: coarse solve = repeated smoothing
        return h


def _cast_level(op, dtype: torch.dtype):
    """An operator stored in ``dtype``: an ELL operator, or an ELL
    operator on the BELL frame (both value arrays cast)."""
    from .bell import BellBackedOp, BellOp
    if isinstance(op, BellBackedOp):
        return BellBackedOp(op.data.to(dtype), op.cols, op.n_cols,
                            BellOp(op.bell.vals.to(dtype), op.bell.dev))
    return _cast(op, dtype)


@timed("step.mg_setup")
def build_hierarchy_from_ops(ops: Sequence, pr_pairs: Sequence,
                             smoother: str = "chebyshev",
                             n_pre: int = 2, n_post: int = 2,
                             jacobi_omega: float = 0.8,
                             cheb_degree: int = 3,
                             vanka_blocks: Optional[Sequence] = None,
                             vanka_omega: float = 0.9,
                             krylov_m: int = 5,
                             vanka_multiplicative: bool = True,
                             compute_dtype: Optional[torch.dtype] = None
                             ) -> MGHierarchy:
    """Hierarchy from EXPLICIT per-level operators (coarsest first) — the
    rediscretized (non-Galerkin) mode: each level's operator is assembled
    on its own mesh instead of PtAP-chained from the finest, so any
    operator with ``matvec``/``diagonal`` fits (ELL, ELL on the BELL
    frame, patch stencil).  ``pr_pairs[l]`` = (P, R) connecting level l to
    l+1.  The coarsest level is LU-factored once here and never smoothed.

    smoother: "jacobi" | "chebyshev" | "vanka" (multiplicative block
    sweeps on the levels whose ``vanka_blocks`` entry is not None,
    Chebyshev on the others).  The additive Vanka sweep
    (``vanka_multiplicative=False``) and "vanka_gmres" (``krylov_m``
    inner FGMRES iterations) raise: the rediscretized hierarchy of the
    reference runs neither.  compute_dtype: every level, the finest
    included, and every transfer are cast to it (see
    ``as_preconditioner``)."""
    if smoother == "vanka_gmres" or (smoother == "vanka"
                                     and not vanka_multiplicative):
        raise ValueError(f"smoother {smoother!r} (multiplicative="
                         f"{vanka_multiplicative}, krylov_m={krylov_m}): "
                         "rediscretized hierarchies take 'jacobi', "
                         "'chebyshev' or multiplicative 'vanka'")
    if smoother not in ("jacobi", "chebyshev", "vanka"):
        raise ValueError(f"smoother {smoother!r}: rediscretized "
                         "hierarchies take 'jacobi', 'chebyshev' or "
                         "multiplicative 'vanka'")
    pr = [(P, R) for P, R, *_ in pr_pairs]
    if compute_dtype is not None:
        ops = [_cast_level(A, compute_dtype) for A in ops]
        pr = [(_cast(P, compute_dtype), _cast(R, compute_dtype))
              for P, R in pr]
    levels = [MGLevel(ops[0])]
    with span("mg_setup.smoothers"):
        for l in range(1, len(ops)):
            A = ops[l]
            if (smoother == "vanka" and vanka_blocks is not None
                    and vanka_blocks[l] is not None):
                from .vanka import vanka_smoother
                sm = vanka_smoother(A, vanka_blocks[l], omega=vanka_omega)
            else:
                d = A.diagonal()
                sm = _point_smoother(A.matvec, d.to(vector_dtype(d.dtype)),
                                     smoother, jacobi_omega, cheb_degree)
            levels.append(MGLevel(A, pr[l - 1][0], pr[l - 1][1], sm))
    h = MGHierarchy(levels, n_pre, n_post, compute_dtype=compute_dtype)
    h.setup_coarse()
    return h


def build_hierarchy_matfree(fine_mv: Callable, fine_diag: torch.Tensor,
                            next_op: SparseOp, transfers: Sequence,
                            smoother: str = "chebyshev",
                            n_pre: int = 2, n_post: int = 2,
                            jacobi_omega: float = 0.8, cheb_degree: int = 3,
                            dir_masks: Optional[Sequence] = None,
                            vanka_blocks: Optional[Sequence] = None,
                            vanka_omega: float = 0.9,
                            compute_dtype: Optional[torch.dtype] = None,
                            device="cuda") -> MGHierarchy:
    """Hierarchy whose FINEST level is matrix-free: operator = ``fine_mv``
    (J.v via the linearised residual, no matrix data), smoother =
    Jacobi/Chebyshev on the scatter-assembled ``fine_diag`` (a Vanka
    request means Chebyshev on the fine level — Vanka needs assembled
    block slots — but still applies on the assembled sub-levels); the
    first coarse level is the ASSEMBLED ``next_op`` (assembled directly on
    the coarse mesh at the restricted state — rediscretization replaces
    the PtAP that would otherwise need the fine matrix), and deeper levels
    Galerkin-coarsen from it via ``transfers[:-1]``.  ``transfers[-1]``
    supplies only the fine P/R pair.  compute_dtype: the assembled
    sub-levels and every transfer are stored in it; the fine J.v keeps the
    ambient precision and takes and returns the cycle's vectors (see
    ``as_preconditioner``)."""
    sub = build_hierarchy(next_op, transfers[:-1], smoother=smoother,
                          n_pre=n_pre, n_post=n_post,
                          jacobi_omega=jacobi_omega, cheb_degree=cheb_degree,
                          dir_masks=dir_masks, vanka_blocks=vanka_blocks,
                          vanka_omega=vanka_omega,
                          compute_dtype=compute_dtype, device=device)
    P, R = transfers[-1][0], transfers[-1][1]
    vdt = vector_dtype(compute_dtype)
    if vdt is not None:
        mv0, amb = fine_mv, fine_diag.dtype
        fine_mv = lambda x: mv0(x.to(amb)).to(x.dtype)      # noqa: E731
        fine_diag = fine_diag.to(vdt)
        P, R = _cast(P, compute_dtype), _cast(R, compute_dtype)
    with span("step.mg_setup"), span("mg_setup.smoothers"):
        sm = _point_smoother(fine_mv, fine_diag, smoother, jacobi_omega,
                             cheb_degree)
    levels = sub.levels + [MGLevel(MatFreeOp(fine_mv, fine_diag.shape[0]),
                                   P, R, sm)]
    return MGHierarchy(levels, n_pre, n_post, coarse_lu=sub.coarse_lu,
                       compute_dtype=compute_dtype)
