"""The sharded solve step over a group of ranks.

The reference's one parallel strategy is MPI domain decomposition
(SURVEY.md §2.4): element partition, contiguous per-rank dof ranges, ghost
exchange inside PETSc's SpMV.  The JAX package writes the global step once
and lets the XLA partitioner insert the collectives.  The port runs one
process per rank (``parallel/ranks.py``) and writes them out:

- rows: the stacked (or interleaved) dof vector, padded with identity rows
  to S*R, is cut into S slabs of R rows; rank s owns rows [s*R, (s+1)*R)
  of ``u``, the residual and the ELL data;
- assembly: each rank assembles the elements that touch its rows (its own
  and one layer), reading ``u`` at the ghost dofs the halo exchange brings
  (the ghost columns of the matrix pattern are exactly the dofs of those
  elements), and keeps its own rows.  No scatter communication;
- matvec: the halo-exchange SpMV (``parallel/halo.py``), ELL gather or
  kernel B1 per rank (``local_format``); ``use_halo=False`` (the JAX
  package's partitioner route) gathers all of ``x`` instead;
- inner products: one ``all_reduce`` each (the Krylov solvers' ``reduce``);
- multigrid: coarse levels replicated on every rank.  The fine level's
  Galerkin PtAP triplets whose fine slot lies in the rank's rows give a
  partial coarse operator, summed by one ``all_reduce`` per assembly;
  restriction applies the columns of the finest transfer's R (P^T for
  Galerkin transfers, the Petrov-Galerkin R of FSI) that belong to the own
  fine rows, then an ``all_reduce`` of the coarse vector; prolongation
  reads the own rows of P.  Every level below the fine one is then the
  same on every rank;
- smoothing: Jacobi or Chebyshev on the own rows, or the multiplicative
  Vanka sweep (``smoother="vanka"``) of the global algorithm: per colour
  the residual of the own rows, the residual at the other ranks' dofs of
  the blocks touching the own rows (one exchange of a gather plan wider
  than the SpMV halo), the same block corrections on every rank that
  shares a block, each rank keeping its own rows.  The blocks' matrix
  rows that other ranks own travel once per assembly.  Replicated coarse
  levels smooth with the single-device Vanka on their own operators.

``step(u_blk) -> (u_blk_new, residual_norm)`` (``step(u_blk, aux_fields)``
with ``with_aux``) is one Newton (or linear) step on this rank's rows.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..algebra.krylov import cg, fgmres, gmres
from ..algebra.mg import (MGHierarchy, MGLevel, _point_smoother,
                          apply_dirichlet_identity)
from ..algebra.smoothers import chebyshev_smoother, jacobi_smoother
from ..algebra.sparse import SparseOp, pad_pattern
from ..algebra.vanka import _invert_blocks, lut_with_miss, vanka_smoother
from .halo import (HaloExchange, build_gather_plan, build_halo_plan,
                   gather_slots, make_halo_spmv, make_halo_spmv_bell)
from .ranks import RankGroup, device_mesh  # noqa: F401  (re-exported)


def pad_prolongation(P_csr, nf_pad: int, nc_pad: int):
    """Resize a prolongation matrix with zero padding rows/cols."""
    import scipy.sparse as sp
    Pm = sp.csr_matrix(P_csr)
    Pm.resize((nf_pad, nc_pad))
    return Pm.tocsr()


def padded_rows(n: int, world_size: int) -> int:
    """Rows of the padded operator: ``n`` rounded up to the world size."""
    return -(-n // world_size) * world_size


class _Clock:
    """Seconds by section (exchange, local matvec, reductions), each
    section closed by a device synchronisation; off unless ``on``."""

    def __init__(self, on: bool, device: torch.device):
        self.on, self.device = on, device
        self.seconds = {"exchange": 0.0, "matvec": 0.0, "reduce": 0.0}

    @contextlib.contextmanager
    def section(self, name: str):
        if not self.on:
            yield
            return
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        self.seconds[name] += time.perf_counter() - t0


class _HaloOp:
    """This rank's rows of the fine operator: the matvec is the
    halo-exchange SpMV (or the all-gather route), the diagonal is local.
    Quacks like SparseOp where the solvers need it."""

    def __init__(self, mv: Callable, diag: torch.Tensor):
        self.mv = mv
        self._diag = diag

    @property
    def n_rows(self) -> int:
        return self._diag.shape[0]

    def matvec(self, x):
        return self.mv(x)

    def __matmul__(self, x):
        return self.mv(x)

    def diagonal(self):
        return self._diag


class _RowsOf:
    """Prolongation to this rank's fine rows: the own rows of P."""

    def __init__(self, P: SparseOp):
        self.P = P

    def __matmul__(self, ec):
        return self.P.matvec(ec)


class _SumOfRows:
    """Restriction from this rank's fine rows: the columns of R that
    belong to the own rows applied to the own block, summed over the ranks
    (one all_reduce of the coarse vector).  ``R`` is the restriction as a
    coarse-row operator whose columns are the own rows, or, where no R is
    given, the own rows of P (``transpose``: then P^T is applied)."""

    def __init__(self, R: SparseOp, reduce: Callable, transpose: bool):
        self.R, self.reduce, self.transpose = R, reduce, transpose

    def __matmul__(self, r_blk):
        part = (self.R.rmatvec(r_blk) if self.transpose
                else self.R.matvec(r_blk))
        return self.reduce(part)


def _own_columns(Rop: SparseOp, lo: int, hi: int) -> SparseOp:
    """The columns [lo, hi) of the coarse-row operator ``Rop``, renumbered
    from 0 (the other entries zeroed)."""
    own = (Rop.cols >= lo) & (Rop.cols < hi)
    return SparseOp(torch.where(own, Rop.data, 0.0),
                    torch.where(own, Rop.cols - lo, 0), hi - lo)


class _ShardedVanka:
    """The multiplicative Vanka sweep of ``algebra.vanka.vanka_smoother``
    on the row-partitioned fine level (module docstring).  ``blocks``: the
    global fine-level blocks (every rank builds the same), dummy dof
    ``blocks.n``; ``step``: the ShardedStep whose rows, group and clock
    it uses.  ``prepare(A, data_blk)`` fetches the other ranks' rows of
    the blocks (once per assembly), inverts the blocks that touch the own
    rows and returns ``smooth(b, x)`` over the own rows for the operator
    ``A`` whose matvec is the halo SpMV."""

    def __init__(self, blocks, step: "ShardedStep", omega: float):
        S, s, R = step.group.world_size, step.group.rank, step.R
        n, w, dev = blocks.n, step.pattern.width, step.group.device
        self.R, self.n, self.omega, self.clock = R, n, omega, step.clock
        cdofs = [d.cpu().numpy() for d in blocks.color_dofs]

        def touching(t):
            lo, hi = t * R, min((t + 1) * R, n)
            return [d[((d >= lo) & (d < hi)).any(axis=1)] for d in cdofs]

        def ghosts(t, per_color):
            g = np.unique(np.concatenate([d.ravel() for d in per_color]))
            return g[(g < n) & ((g < t * R) | (g >= (t + 1) * R))]

        # every rank's ghost set, known on every rank: the blocks are global
        needs = [ghosts(t, touching(t)) for t in range(S)]
        plan = build_gather_plan(needs, R)
        self.exchange = HaloExchange(plan, step.group)
        self.note = {"ghosts": int(len(needs[s])), "m": plan.m,
                     "transport": self.exchange.transport}
        # positions in the extended frame [own rows | S*m ghost slots |
        # zero]: own dof g -> g - lo, ghost -> R + its slot, dummy -> the
        # zero slot
        lo = s * R
        zero = R + S * plan.m
        pos_of = np.full(n + 1, zero, np.int64)
        pos_of[lo:min(lo + R, n)] = np.arange(min(lo + R, n) - lo)
        pos_of[needs[s]] = R + gather_slots(plan, needs[s])
        # block matrix entries: global ELL slot g*w + k of row g ->
        # own rows' data (R*w), then the fetched rows (S*m*w), then zero
        lut = lut_with_miss(step.pattern)
        oob = step.pattern.n_rows * w
        self.miss = R * w + S * plan.m * w
        i64 = dict(dtype=torch.int64, device=dev)
        self.colors = []
        for d in touching(s):
            nb, bs = d.shape
            bi = np.repeat(d, bs, axis=1).reshape(nb, bs, bs)
            bj = np.tile(d, (1, bs)).reshape(nb, bs, bs)
            slot = lut(bi.ravel(), bj.ravel()).reshape(nb, bs, bs)
            hit = (slot != oob) & (bi < n) & (bj < n)
            slot_ext = np.where(
                hit, pos_of[np.minimum(bi, n)] * w + slot - bi * w,
                self.miss)
            pos = pos_of[d]
            own = np.where(pos < R, pos, R)            # R = dropped
            self.colors.append({
                "dofs": torch.as_tensor(d, **i64),
                "pos": torch.as_tensor(pos, **i64),
                "own": torch.as_tensor(own, **i64),
                "slots": torch.as_tensor(slot_ext, **i64)})

    def prepare(self, A, data_blk: torch.Tensor) -> Callable:
        with self.clock.section("exchange"):
            rows = self.exchange.start(data_blk)()
        flat = torch.cat([data_blk.reshape(-1), rows.reshape(-1)])
        per_color = []
        for c in self.colors:
            Ainv, rv = _invert_blocks(flat, c["dofs"], c["slots"], self.n)
            per_color.append((c["pos"], c["own"], Ainv, rv))
        R, omega = self.R, self.omega

        def smooth(b, x):
            for pos, own, Ainv, rv in per_color:
                r = b - A @ x
                with self.clock.section("exchange"):
                    rg = self.exchange.start(r)()
                r_ext = torch.cat([r, rg, r.new_zeros(1)])
                rb = r_ext[pos] * rv
                delta = torch.bmm(Ainv, rb[:, :, None])[:, :, 0] * rv
                upd = x.new_zeros(R + 1).index_add_(
                    0, own.reshape(-1), delta.reshape(-1))[:R]
                x = x + omega * upd
            return x

        return smooth


def _sub_tables(tables: dict, elems: torch.Tensor) -> dict:
    """Assembly tables of the elements ``elems`` only (row tables stay)."""
    t = dict(tables)
    ne = tables["edofs"].shape[0]
    for key in ("elem_group", "edofs", "coords_e"):
        t[key] = tables[key][elems]
    t["slots"] = tables["slots"].view(ne, -1)[elems].reshape(-1)
    t["aux_conn"] = {k: v[elems] for k, v in tables["aux_conn"].items()}
    return t


def make_sharded_step(assembler, group: RankGroup,
                      transfers: Sequence = (),
                      dir_masks: Sequence = (),
                      outer: str = "gmres", rtol: float = 1e-8,
                      restart: int = 30, max_outer: int = 10,
                      smoother: str = "jacobi",
                      aux_scalars: Optional[dict] = None,
                      use_halo: bool = True,
                      local_format: str = "auto",
                      mg_cycle: str = "V",
                      vanka_blocks: Optional[Sequence] = None,
                      vanka_omega: float = 0.9,
                      with_aux: bool = False,
                      timed: bool = False) -> "ShardedStep":
    """One Newton/linear step on this rank's rows (module docstring).

    ``assembler``: the global level's Assembler on the rank's device (every
    rank builds it; each assembles only its elements).  ``transfers``:
    [(P_op, R_op, PtAPSchedule)] coarse->fine on the rank's device, the
    finest one built on the fine pattern padded to ``padded_rows`` rows
    (:func:`pad_prolongation`); ``dir_masks`` restore identity rows on the
    coarse levels, as ``algebra.mg.build_hierarchy``.  ``outer``: "cg",
    "gmres" or "fgmres" (forced for ``mg_cycle="K"``).  ``smoother``:
    "jacobi", "chebyshev" or "vanka" (multiplicative; needs transfers and
    ``vanka_blocks``, coarse->fine, one ``build_element_blocks`` per
    level against the pattern of that level's operator, every level above
    the LU-solved coarsest one given: the fine level's on the assembler's
    pattern, the others on their PtAP/R·A·P ``coarse_pattern``; damping
    ``vanka_omega``); any other name raises.  ``with_aux``: the step is
    ``step(u_blk, aux_fields)``, the aux fields (name -> global vector of
    the field's family, replicated on every rank) reaching the form as in
    ``Assembler.make_assemble_fn``.  ``local_format``: "ell" (gather), "bell"
    (kernel B1 per rank, :func:`~femus_tpu_torch.parallel.halo.make_halo_spmv_bell`)
    or "auto" (bell on CUDA, ell on the CPU).  ``timed``: accumulate the
    seconds of exchange, local matvec and reductions in ``step.clock``
    (each section synchronises the device, and the halo SpMV runs its
    exchange and its local product in turn, without overlap: an
    instrumented path beside the production one; ``step.clock.on``
    switches it between calls)."""
    return ShardedStep(assembler, group, transfers, dir_masks, outer, rtol,
                       restart, max_outer, smoother, aux_scalars, use_halo,
                       local_format, mg_cycle, timed, vanka_blocks,
                       vanka_omega, with_aux)


class ShardedStep:
    """See :func:`make_sharded_step`.  ``rows``: this rank's slice of the
    padded dof vector; ``note``: the routing (format, transport);
    ``info``: the last solve's SolveInfo."""

    def __init__(self, assembler, group, transfers, dir_masks, outer, rtol,
                 restart, max_outer, smoother, aux_scalars, use_halo,
                 local_format, mg_cycle, timed, vanka_blocks=None,
                 vanka_omega=0.9, with_aux=False):
        if assembler.face_form is not None or assembler.patch_tab is not None:
            raise ValueError("make_sharded_step: ELL volume forms only (no "
                             "face form, no patch layout)")
        if smoother not in ("jacobi", "chebyshev", "vanka"):
            raise ValueError(f"make_sharded_step: smoother {smoother!r} "
                             "(jacobi, chebyshev or vanka)")
        if smoother == "vanka":
            L = len(transfers) + 1
            if not transfers:
                raise ValueError("make_sharded_step: smoother='vanka' needs "
                                 "transfers (a multigrid hierarchy)")
            if (vanka_blocks is None or len(vanka_blocks) != L
                    or any(b is None for b in vanka_blocks[1:])):
                raise ValueError(
                    "make_sharded_step: smoother='vanka' needs vanka_blocks, "
                    f"one per level ({L}, coarse->fine; only the coarsest "
                    "may be None)")
        dev = assembler.device
        if dev != group.device:
            raise ValueError("make_sharded_step: the assembler lives on "
                             f"{dev}, the rank on {group.device}")
        if local_format == "auto":
            local_format = "bell" if dev.type == "cuda" else "ell"
        S, s = group.world_size, group.rank
        n = assembler.n_dofs
        n_pad = padded_rows(n, S)
        R = n_pad // S
        lo, hi = s * R, (s + 1) * R
        self.group = group
        self.n, self.n_pad, self.R = n, n_pad, R
        self.rows = slice(lo, hi)
        self.n_real = max(0, min(hi, n) - lo)        # own rows below n
        self.outer = "fgmres" if mg_cycle.upper() == "K" else outer
        self.rtol, self.restart, self.max_outer = rtol, restart, max_outer
        self.smoother, self.mg_cycle = smoother, mg_cycle
        self.vanka_blocks, self.vanka_omega = vanka_blocks, vanka_omega
        self.with_aux = with_aux
        self.scalars = dict(aux_scalars or {})
        self.clock = _Clock(timed, dev)
        self.pattern = pattern = pad_pattern(assembler.pattern, n_pad, n_pad)
        w = pattern.width
        self.note = {"local_format": local_format, "use_halo": use_halo,
                     "world_size": S, "rows_per_rank": R, "n_pad": n_pad}

        # ---- assembly: the elements touching the own rows ----------------
        edofs = assembler.edofs
        touch = ((edofs >= lo) & (edofs < hi)).any(axis=1)
        elems = torch.as_tensor(np.flatnonzero(touch), dtype=torch.int64,
                                device=dev)
        self.tables = _sub_tables(assembler.device_tables(), elems)
        self.assemble = assembler.make_assemble_fn(pass_tables=True)
        self.note["elements"] = int(touch.sum())

        # ---- the fine operator's matvec ----------------------------------
        i64 = dict(dtype=torch.int64, device=dev)
        cols_blk = pattern.cols[lo:hi].astype(np.int64)
        self.halo = None
        if use_halo:
            plan = build_halo_plan(pattern, S)
            if local_format == "bell":
                self.prepare, self.halo = make_halo_spmv_bell(plan, pattern,
                                                              group)
            else:
                self.halo, _ = make_halo_spmv(plan, group)
            self.note.update(self.halo.exchange.note)
            gg, used = plan.ghost_globals(s)
            keep = used & (gg < n)
            self.ghost_src = torch.as_tensor(np.flatnonzero(keep), **i64)
            self.ghost_dst = torch.as_tensor(gg[keep], **i64)
        elif local_format == "bell":
            raise ValueError("local_format='bell' needs use_halo=True")
        else:
            self.cols_glob = torch.as_tensor(cols_blk, **i64)
        # own diagonal slot of every own row
        own = (cols_blk == np.arange(lo, hi)[:, None]) & pattern.valid[lo:hi]
        self.diag_idx = torch.as_tensor(np.arange(R) * w + own.argmax(1),
                                        **i64)

        # ---- multigrid: replicated coarse levels --------------------------
        self.transfers = list(transfers)
        self.dir_masks = list(dir_masks)
        if self.transfers:
            Pop, Rop, sched = self.transfers[-1]
            keep = (sched.src >= lo * w) & (sched.src < hi * w)
            self.f_src = sched.src[keep] - lo * w
            self.f_dst = sched.dst[keep]
            self.f_coeff = sched.coeff[keep]
            self.f_sched = sched
            Pl = SparseOp(Pop.data[lo:hi], Pop.cols[lo:hi], Pop.n_cols)
            self.P_rows = _RowsOf(Pl)
            # restrict with the transfer's own R (the R of its R·A·P
            # schedule); P^T only where no R is given
            self.R_rows = (_SumOfRows(Pl, self._sum, transpose=True)
                           if Rop is None else
                           _SumOfRows(_own_columns(Rop, lo, hi), self._sum,
                                      transpose=False))
        self.vanka = None
        if smoother == "vanka":
            self.vanka = _ShardedVanka(vanka_blocks[-1], self, vanka_omega)
            self.note["vanka"] = self.vanka.note

    # ---- communication, timed -------------------------------------------
    def _sum(self, t):
        with self.clock.section("reduce"):
            return self.group.sum(t)

    def _ghosts(self, u_blk):
        """u on the global numbering: own rows and ghosts filled in."""
        u = u_blk.new_zeros(self.n)
        u[self.rows.start:self.rows.start + self.n_real] = \
            u_blk[:self.n_real]
        if self.halo is not None:
            with self.clock.section("exchange"):
                xg = self.halo.exchange.start(u_blk)()
            u[self.ghost_dst] = xg[self.ghost_src]
        else:
            with self.clock.section("exchange"):
                u = self.group.all_gather(u_blk)[:self.n]
        return u

    def _matvec(self, data_blk, slabs):
        if self.halo is None:
            def mv(x):
                with self.clock.section("exchange"):
                    xf = self.group.all_gather(x)
                with self.clock.section("matvec"):
                    return (data_blk * xf[self.cols_glob]).sum(dim=-1)
            return mv
        local = data_blk if slabs is None else slabs
        if not self.clock.on:
            return lambda x: self.halo(local, x)

        def mv(x):
            # timed: exchange, then the local product (no overlap)
            with self.clock.section("exchange"):
                xg = self.halo.exchange.start(x)()
            with self.clock.section("matvec"):
                return self.halo.local(local, x, xg)
        return mv

    # ---- one step -------------------------------------------------------
    def local_assemble(self, u_blk, aux_fields=None):
        """(R_blk (R,), data_blk (R, w)) of the own rows at ``u_blk``;
        padding rows: zero residual, identity row."""
        lo, nr, R = self.rows.start, self.n_real, self.R
        w = self.pattern.width
        Rg, data = self.assemble(self._ghosts(u_blk), self.tables,
                                 self.scalars, aux_fields)
        R_blk = u_blk.new_zeros(R)
        R_blk[:nr] = Rg[lo:lo + nr]
        data_blk = data.new_zeros((R, w))
        data_blk[:nr] = data[lo:lo + nr]
        data_blk[nr:, 0] = 1.0
        return R_blk, data_blk

    def _hierarchy(self, A, data_blk) -> Callable:
        """The multigrid preconditioner (replicated coarse levels)."""
        dev = data_blk.device
        sched = self.f_sched
        nrc, wc = sched.coarse_pattern.n_rows, sched.coarse_pattern.width
        part = data_blk.new_zeros(nrc * wc).index_add_(
            0, self.f_dst, self.f_coeff.to(data_blk.dtype)
            * data_blk.reshape(-1)[self.f_src])
        L = len(self.transfers) + 1
        ops = [None] * (L - 1)
        ops[-1] = SparseOp(self._sum(part).view(nrc, wc), sched.coarse_cols,
                           sched.coarse_pattern.n_cols)
        for l in range(L - 2, -1, -1):
            if l < L - 2:
                sc = self.transfers[l][2]
                ops[l] = SparseOp(sc.apply(ops[l + 1].data), sc.coarse_cols,
                                  sc.coarse_pattern.n_cols)
            sc = self.transfers[l][2]
            if self.dir_masks and self.dir_masks[l] is not None:
                ops[l] = apply_dirichlet_identity(
                    ops[l], sc.coarse_valid,
                    torch.as_tensor(self.dir_masks[l], device=dev))
        levels = [MGLevel(ops[0])]
        for l in range(1, L - 1):
            if self.smoother == "vanka":
                sm = vanka_smoother(ops[l], self.vanka_blocks[l],
                                    omega=self.vanka_omega)
            else:
                sm = _point_smoother(ops[l].matvec, ops[l].diagonal(),
                                     self.smoother, 0.8, 3)
            levels.append(MGLevel(ops[l], *self.transfers[l - 1][:2], sm))
        fine_sm = (self.vanka.prepare(A, data_blk) if self.vanka is not None
                   else self._fine_smoother(A))
        levels.append(MGLevel(A, self.P_rows, self.R_rows, fine_sm))
        h = MGHierarchy(levels)
        h.setup_coarse()
        return h.as_preconditioner(self.mg_cycle)

    def _fine_smoother(self, A):
        d = A.diagonal()
        safe = torch.where(d.abs() < 1e-30, 1.0, d)
        if self.smoother == "jacobi":
            return jacobi_smoother(A.matvec, safe, 0.8, iters=1)
        # power iteration on D^-1 A over the ranks' rows (the start vector
        # of algebra.smoothers.power_lambda_max, cut to the own rows)
        lo = self.rows.start
        dinv = 1.0 / safe
        v = torch.sin(torch.arange(lo, lo + self.R, dtype=d.dtype,
                                   device=d.device) + 1.0)
        v = v / torch.sqrt(self._sum(torch.dot(v, v)))
        for _ in range(25):
            wv = dinv * A.matvec(v)
            nw = torch.sqrt(self._sum(torch.dot(wv, wv)))
            v = wv / nw
        return chebyshev_smoother(A.matvec, safe, nw, degree=3)

    def __call__(self, u_blk: torch.Tensor, aux_fields=None):
        if self.with_aux != (aux_fields is not None):
            raise TypeError("make_sharded_step: the step takes (u_blk, "
                            "aux_fields) with with_aux=True and (u_blk) "
                            "without")
        if aux_fields is not None:
            aux_fields = {k: torch.as_tensor(v, dtype=u_blk.dtype,
                                             device=u_blk.device)
                          for k, v in aux_fields.items()}
        R_blk, data_blk = self.local_assemble(u_blk, aux_fields)
        slabs = self.prepare(data_blk) if self.note["local_format"] == \
            "bell" and self.halo is not None else None
        A = _HaloOp(self._matvec(data_blk, slabs),
                    data_blk.reshape(-1)[self.diag_idx])
        if self.transfers:
            M = self._hierarchy(A, data_blk)
        else:
            d = A.diagonal()
            dsafe = torch.where(d.abs() < 1e-30, 1.0, d)
            M = lambda r: r / dsafe                       # noqa: E731
        red = self._sum if self.group.distributed else None
        if self.outer == "cg":
            delta, info = cg(A.matvec, -R_blk, M=M, tol=self.rtol,
                             maxiter=self.max_outer * self.restart,
                             reduce=red)
        else:
            solve = fgmres if self.outer == "fgmres" else gmres
            delta, info = solve(A.matvec, -R_blk, M=M, tol=self.rtol,
                                restart=self.restart,
                                max_restarts=self.max_outer, reduce=red)
        self.info = info
        return u_blk + delta, info.residual

    def own(self, u_global: torch.Tensor) -> torch.Tensor:
        """This rank's padded block of a global (n,) or (n_pad,) vector."""
        out = u_global.new_zeros(self.R)
        out[:self.n_real] = u_global[self.rows.start:
                                     self.rows.start + self.n_real]
        return out
