"""Halo-exchange SpMV over a group of ranks (``torch.distributed``).

The reference's ghost-dof exchange lives inside PETSc's VecGhost/MatMult
(SURVEY.md §2.4: ``_ghostDofs`` Mesh.hpp:543).  As in the JAX package the
communication schedule is static (static sparsity -> static plan): rows
are range-partitioned, R rows per rank; at set-up the host computes, per
rank pair (src, dst), the local x entries src ships to dst
(:class:`HaloPlan`, host numpy, the JAX package's arrays).  Each rank then
holds its x block of R entries and receives its ghosts into a local frame
of S * m slots (rank t's ghosts at [t*m, t*m + len)), so its operator block
reads the extended vector ``[x_own | ghosts]`` of R + S*m entries.

Transports (:class:`HaloExchange`, the rule printed in its ``note``):

- ``all_to_all``: one ``dist.all_to_all_single`` of (S, m) slots, the
  dense exchange for any communication graph;
- ``ppermute``: when the graph is banded (every pair talks across at most
  ``_MAX_PPERMUTE_OFFSETS`` rank offsets), one batched ``isend``/``irecv``
  per active offset ships exactly that offset's ghosts.

gloo aborts on a CUDA tensor in ``send``/``recv``
(``tools/torch_gloo_cuda_probe.py``), so ``transport="auto"`` on a gloo
group of CUDA ranks picks ``all_to_all`` (whose CUDA tensors gloo stages
itself), and ``ppermute`` asked for by name on such a group raises.  No
transport is switched by catching an error.

Both are double-buffered (``overlap=True``): the exchange is started
asynchronously, the rows' products over OWN columns run while it is in
flight, and the ghost columns are added once it lands.

Local formats of a rank's operator block: :func:`make_halo_spmv` gathers
the ELL block (plain torch); :func:`make_halo_spmv_bell` lays the block
out as two sliced-ELL plans run through kernel B1 (``csrc/sell_spmv.cu``):
an interior plan of R rows over the own columns (x of R entries) and a
boundary plan of the rows with ghost columns over the extended frame
(x of R + S*m entries), the port's counterpart of the JAX package's
per-shard interior/boundary blocked-ELL slabs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..algebra.bell import SellPlan, relayout_ell, sell_plan_from_csr
from ..algebra.sparse import EllPattern
from .ranks import RankGroup

# use the offset-ppermute transport when the plan's communication graph
# spans at most this many distinct rank offsets
_MAX_PPERMUTE_OFFSETS = 6


@dataclasses.dataclass
class HaloPlan:
    """Static plan for one row-partitioned ELL operator (host numpy; the
    arrays equal ``femus_tpu.parallel.halo.HaloPlan``'s)."""

    n_shards: int
    rows_per_shard: int          # R (padded)
    m: int                       # max ghosts per (src, dst) pair (padded)
    send_idx: np.ndarray         # (S_src, S_dst, m): local idx in src to send
    cols_local: np.ndarray       # (S * R, w) remapped ELL columns
    n_rows: int                  # original (padded) row count = S * R
    bnd_rows: np.ndarray         # (S, B) local boundary-row ids (R = pad)
    offs: Tuple[int, ...]        # active shard-index offsets (dst - src)
    off_send: Tuple[np.ndarray, ...]  # per offset d: (S, m_d) src-local idx

    @property
    def banded(self) -> bool:
        return len(self.offs) <= _MAX_PPERMUTE_OFFSETS

    def ghost_globals(self, s: int) -> Tuple[np.ndarray, np.ndarray]:
        """(global dof of each of rank ``s``'s S*m ghost slots, valid mask):
        slot t*m + k holds rank t's local entry ``send_idx[t, s, k]``."""
        S, R, m = self.n_shards, self.rows_per_shard, self.m
        glob = (np.arange(S)[:, None] * R + self.send_idx[:, s, :]).ravel()
        used = np.zeros(S * m, bool)
        c = self.cols_local[s * R:(s + 1) * R]
        used[c[c >= R] - R] = True
        return glob.astype(np.int64), used


def build_halo_plan(pattern: EllPattern, n_shards: int) -> HaloPlan:
    n = pattern.n_rows
    assert n % n_shards == 0, "pad rows to a multiple of the shard count first"
    R = n // n_shards
    cols = pattern.cols
    owner = cols // R                                  # (n, w)
    need = [[None] * n_shards for _ in range(n_shards)]
    for s in range(n_shards):
        blk_cols = cols[s * R:(s + 1) * R]
        blk_owner = owner[s * R:(s + 1) * R]
        for t in range(n_shards):
            if t == s:
                continue
            need[s][t] = np.unique(blk_cols[blk_owner == t])
    m, send_idx, offs, off_send = _schedule(need, n_shards, R)
    # remap columns to local frame: own -> [0, R); ghost from t -> R + t*m + k
    # (ghost lists are sorted-unique, so position = searchsorted)
    cols_local = np.empty_like(cols)
    for s in range(n_shards):
        blk = cols[s * R:(s + 1) * R]
        own = blk - s * R
        out = np.where((blk >= s * R) & (blk < (s + 1) * R), own, 0)
        for t in range(n_shards):
            if t == s or need[s][t] is None or len(need[s][t]) == 0:
                continue
            sel = (blk // R) == t
            if not sel.any():
                continue
            out[sel] = R + t * m + np.searchsorted(need[s][t], blk[sel])
        cols_local[s * R:(s + 1) * R] = out
    cols_local = cols_local.astype(np.int32)

    # boundary rows: any VALID slot referencing a ghost column (the only
    # rows the exchange's result can touch)
    ghost_slot = (cols_local >= R) & pattern.valid
    bnd_lists = [np.flatnonzero(ghost_slot[s * R:(s + 1) * R].any(axis=1))
                 for s in range(n_shards)]
    B = max(1, max(len(b) for b in bnd_lists))
    bnd_rows = np.full((n_shards, B), R, np.int32)     # R = drop sentinel
    for s, b in enumerate(bnd_lists):
        bnd_rows[s, :len(b)] = b
    return HaloPlan(n_shards, R, m, send_idx, cols_local, n, bnd_rows,
                    offs, off_send)


def _schedule(need, n_shards: int, R: int):
    """(m, send_idx, offs, off_send) of the exchange in which rank s
    receives from rank t the sorted global ids ``need[s][t]`` (owned by t;
    None or empty: nothing), each pair's list padded to m slots."""
    m = max([1] + [len(g) for row in need for g in row if g is not None])
    send_idx = np.zeros((n_shards, n_shards, m), np.int32)
    for s in range(n_shards):
        for t in range(n_shards):
            if t == s or need[s][t] is None:
                continue
            g = need[s][t]
            send_idx[t, s, :len(g)] = g - t * R        # t sends to s
    # offset schedule: active offsets d = dst - src, and per offset the
    # (S, m_d) source-local indices src ships to src + d
    offs = sorted({s - t for s in range(n_shards) for t in range(n_shards)
                   if t != s and need[s][t] is not None and len(need[s][t])})
    off_send = []
    for d in offs:
        lens = [len(need[src + d][src]) if 0 <= src + d < n_shards
                and need[src + d][src] is not None else 0
                for src in range(n_shards)]
        m_d = max(1, max(lens))
        sa = np.zeros((n_shards, m_d), np.int32)
        for src in range(n_shards):
            if lens[src]:
                sa[src, :lens[src]] = need[src + d][src] - src * R
        off_send.append(sa)
    return m, send_idx, tuple(offs), tuple(off_send)


def build_gather_plan(needs, rows_per_shard: int) -> HaloPlan:
    """The exchange that brings each rank ``s`` the entries at the global
    ids ``needs[s]`` (any ids outside its own rows [s*R, (s+1)*R), sorted
    unique), owner by owner, into the ghost frame of S*m slots: id g owned
    by rank t lands in slot ``t*m + k``, k its position among ``needs[s]``'s
    ids owned by t (:func:`gather_slots`).  A plan without an operator:
    ``cols_local`` and ``bnd_rows`` are empty."""
    S, R = len(needs), rows_per_shard
    need = [[None] * S for _ in range(S)]
    for s, g in enumerate(needs):
        g = np.asarray(g, np.int64)
        for t in range(S):
            if t != s:
                need[s][t] = g[(g >= t * R) & (g < (t + 1) * R)]
    m, send_idx, offs, off_send = _schedule(need, S, R)
    return HaloPlan(S, R, m, send_idx, np.zeros((0, 0), np.int32), S * R,
                    np.zeros((S, 0), np.int32), offs, off_send)


def gather_slots(plan: HaloPlan, needs_s: np.ndarray) -> np.ndarray:
    """The ghost-frame slot of each id of ``needs_s`` (sorted unique, as
    given to :func:`build_gather_plan`) in its rank's exchange."""
    R, m = plan.rows_per_shard, plan.m
    g = np.asarray(needs_s, np.int64)
    owner = g // R
    slots = np.empty(len(g), np.int64)
    for t in np.unique(owner):
        sel = owner == t
        slots[sel] = t * m + np.arange(int(sel.sum()))
    return slots


def choose_transport(plan: HaloPlan, group: RankGroup,
                     transport: str = "auto") -> Tuple[str, str]:
    """(transport that runs, the rule that chose it): see the module
    docstring."""
    staged = group.backend == "gloo" and group.device.type == "cuda"
    if plan.n_shards == 1:
        return "none", "one rank: no ghosts"
    if transport == "auto":
        if staged:
            return "all_to_all", ("gloo with CUDA ranks: all_to_all_single "
                                  "(gloo stages it through the host); "
                                  "gloo's send/recv refuse CUDA tensors")
        if plan.banded:
            return "ppermute", f"banded: {len(plan.offs)} offsets"
        return "all_to_all", (f"{len(plan.offs)} offsets > "
                              f"{_MAX_PPERMUTE_OFFSETS}")
    if transport == "ppermute" and staged:
        raise ValueError("transport 'ppermute' on a gloo group of CUDA "
                         "ranks: gloo's send/recv refuse CUDA tensors "
                         "(use 'all_to_all' or 'auto')")
    if transport in ("ppermute", "all_to_all"):
        return transport, "asked for"
    raise ValueError(f"unknown transport {transport!r}")


class HaloExchange:
    """This rank's ghost gather: ``start(x_blk)`` posts the exchange of the
    (R,) block and returns ``wait() -> xghost (S*m,)`` in the plan's ghost
    frame.  ``transport`` as in the module docstring; ``note`` records the
    rule that chose it."""

    def __init__(self, plan: HaloPlan, group: RankGroup,
                 transport: str = "auto"):
        S, m = plan.n_shards, plan.m
        asked_for = transport
        if group.world_size != S:
            raise ValueError(f"halo plan of {S} shards on a group of "
                             f"{group.world_size} ranks")
        dev, s = group.device, group.rank
        self.plan = plan
        transport, why = choose_transport(plan, group, transport)
        self.transport = transport
        self.note = {"transport": transport, "asked": asked_for, "rule": why,
                     "offsets": list(plan.offs), "m": m}
        i64 = dict(dtype=torch.int64, device=dev)
        if transport == "all_to_all":
            self.send_idx = torch.as_tensor(plan.send_idx[s].reshape(-1),
                                            **i64)
        elif transport == "ppermute":
            self.sends, self.recvs = [], []
            for d, sa in zip(plan.offs, plan.off_send):
                m_d = sa.shape[1]
                if 0 <= s + d < S:
                    self.sends.append((s + d, torch.as_tensor(sa[s], **i64)))
                if 0 <= s - d < S:
                    self.recvs.append((s - d, m_d))

    def start(self, x_blk: torch.Tensor) -> Callable[[], torch.Tensor]:
        """Post the exchange of the block ``x_blk`` ((R,), or (R, ...):
        whole rows travel) and return its ``wait``."""
        S, m = self.plan.n_shards, self.plan.m
        tail = tuple(x_blk.shape[1:])
        if self.transport == "none":
            xg = x_blk.new_zeros((S * m,) + tail)
            return lambda: xg
        if self.transport == "all_to_all":
            send = x_blk[self.send_idx]
            recv = torch.empty_like(send)
            work = dist.all_to_all_single(recv, send, async_op=True)

            def wait():
                work.wait()
                return recv

            return wait
        # ppermute: one batched isend/irecv per active offset
        xg = x_blk.new_zeros((S * m,) + tail)
        ops, landing = [], []
        for peer, ix in self.sends:
            ops.append(dist.P2POp(dist.isend, x_blk[ix], peer))
        for peer, m_d in self.recvs:
            rb = x_blk.new_empty((m_d,) + tail)
            ops.append(dist.P2POp(dist.irecv, rb, peer))
            landing.append((peer * m, rb))
        reqs = dist.batch_isend_irecv(ops) if ops else []

        def wait():
            for r in reqs:
                r.wait()
            for pos, rb in landing:
                xg[pos:pos + rb.shape[0]] = rb
            return xg

        return wait


class HaloSpMV:
    """``y_blk = spmv(data_blk (R, w), x_blk (R,))`` on this rank's rows
    (``rows``): the ELL block's gather against ``[x_blk | ghosts]``."""

    def __init__(self, plan: HaloPlan, group: RankGroup, overlap: bool,
                 transport: str):
        s, R = group.rank, plan.rows_per_shard
        dev = group.device
        self.plan, self.overlap = plan, overlap
        self.exchange = HaloExchange(plan, group, transport)
        self.rows = slice(s * R, (s + 1) * R)
        self.cols = torch.as_tensor(plan.cols_local[self.rows],
                                    dtype=torch.int64, device=dev)
        b = plan.bnd_rows[s]
        self.bnd = torch.as_tensor(b[b < R], dtype=torch.int64, device=dev)

    def local(self, data_blk: torch.Tensor, x_blk: torch.Tensor,
              xghost: torch.Tensor) -> torch.Tensor:
        """The rank's product once its ghosts ``xghost`` are in."""
        xfull = torch.cat([x_blk, xghost])
        return (data_blk * xfull[self.cols]).sum(dim=-1)

    def __call__(self, data_blk: torch.Tensor,
                 x_blk: torch.Tensor) -> torch.Tensor:
        R, S, m = self.plan.rows_per_shard, self.plan.n_shards, self.plan.m
        wait = self.exchange.start(x_blk)
        if not self.overlap:
            return self.local(data_blk, x_blk, wait())
        # interior pass: ghost slots read zeros, no dependency on the
        # exchange in flight
        xpad = torch.cat([x_blk, x_blk.new_zeros(S * m)])
        y = (data_blk * xpad[self.cols]).sum(dim=-1)
        xghost = wait()
        if self.bnd.numel():
            c_b = self.cols[self.bnd]
            g = (c_b - R).clamp(0, S * m - 1)
            corr = (data_blk[self.bnd] * torch.where(
                c_b >= R, xghost[g], 0.0)).sum(dim=-1)
            y = y.index_add(0, self.bnd, corr)
        return y


def make_halo_spmv(plan: HaloPlan, group: RankGroup, overlap: bool = True,
                   transport: str = "auto"):
    """(spmv, rows): ``spmv(data_blk (R, w), x_blk (R,)) -> y_blk (R,)`` on
    this rank's rows ``rows`` of the global operator (local ELL gather);
    ``overlap=True`` computes the own-column products while the exchange
    is in flight; ``transport`` as in the module docstring
    (``spmv.exchange.note`` says which ran)."""
    spmv = HaloSpMV(plan, group, overlap, transport)
    return spmv, spmv.rows


# ---------------------------------------------------------------------------
# sliced-ELL local blocks on kernel B1
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LocalSellPlan:
    """One rank's operator block as two sliced-ELL plans (identity frame,
    values gathered from the rank's ELL data block of R*w slots)."""

    R: int
    C: int                       # extended frame R + S*m
    interior: SellPlan           # R rows x R own columns
    boundary: SellPlan           # B rows x C columns: the ghost entries
    bnd_rows: np.ndarray         # (B,) local rows of the boundary plan


def _csr_of(rows, cols, slots, n_rows):
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=n_rows))]).astype(np.int64)
    return indptr, cols[order], slots[order]


def build_local_sell(plan: HaloPlan, pattern: EllPattern,
                     rank: int) -> LocalSellPlan:
    """Rank ``rank``'s interior/boundary sliced-ELL plans (the port's
    counterpart of the JAX package's ``build_local_bell``, whose per-shard
    blocked-ELL slabs split at 128-column blocks; here the split is exact:
    own columns in one plan, ghost columns in the other)."""
    S, R, m = plan.n_shards, plan.rows_per_shard, plan.m
    w = pattern.width
    C = R + S * m
    cols_blk = plan.cols_local[rank * R:(rank + 1) * R].astype(np.int64)
    valid = pattern.valid[rank * R:(rank + 1) * R]
    r, k = np.nonzero(valid)
    c = cols_blk[r, k]
    slot = r * w + k
    own = c < R
    ip, ic, isl = _csr_of(r[own], c[own], slot[own], R)
    interior = sell_plan_from_csr(ip, ic, isl, R, R * w)
    bnd = np.unique(r[~own])
    pos = np.searchsorted(bnd, r[~own])
    bp, bc, bsl = _csr_of(pos, c[~own], slot[~own], len(bnd))
    boundary = sell_plan_from_csr(bp, bc, bsl, C, R * w)
    return LocalSellPlan(R, C, interior, boundary, bnd)


class HaloSpMVBell:
    """``spmv(slabs, x_blk)`` with ``slabs = prepare(data_blk)``: the
    interior plan's B1 launch over ``x_blk`` while the exchange is in
    flight, then the boundary plan's B1 launch over ``[x_blk | ghosts]``,
    added into the boundary rows."""

    def __init__(self, plan: HaloPlan, pattern: EllPattern,
                 group: RankGroup, overlap: bool, transport: str):
        dev = group.device
        self.overlap = overlap
        self.exchange = HaloExchange(plan, group, transport)
        lb = build_local_sell(plan, pattern, group.rank)
        self.dev_i = lb.interior.to_device(dev)
        self.dev_b = lb.boundary.to_device(dev) if len(lb.bnd_rows) else None
        self.bnd = torch.as_tensor(lb.bnd_rows, dtype=torch.int64,
                                   device=dev)

    def prepare(self, data_blk: torch.Tensor):
        """ELL data block (R, w) -> (interior, boundary) sliced-ELL
        operators (one gather each per assembly)."""
        dev = data_blk.device
        op_i = relayout_ell(self.dev_i, data_blk, device=dev)
        op_b = (relayout_ell(self.dev_b, data_blk, device=dev)
                if self.dev_b is not None else None)
        return op_i, op_b

    def local(self, slabs, x_blk: torch.Tensor,
              xghost: torch.Tensor) -> torch.Tensor:
        """The rank's product once its ghosts ``xghost`` are in."""
        op_i, op_b = slabs
        y = op_i.matvec_frame(x_blk)
        return y if op_b is None else self._boundary(op_b, y, x_blk, xghost)

    def _boundary(self, op_b, y, x_blk, xghost):
        yb = op_b.matvec_frame(torch.cat([x_blk, xghost]))
        return y.index_add(0, self.bnd, yb)

    def __call__(self, slabs, x_blk: torch.Tensor) -> torch.Tensor:
        op_i, op_b = slabs
        wait = self.exchange.start(x_blk)
        if not self.overlap:
            return self.local(slabs, x_blk, wait())
        y = op_i.matvec_frame(x_blk)        # while the exchange is in flight
        xghost = wait()
        return y if op_b is None else self._boundary(op_b, y, x_blk, xghost)


def make_halo_spmv_bell(plan: HaloPlan, pattern: EllPattern,
                        group: RankGroup, overlap: bool = True,
                        transport: str = "auto"):
    """Returns (prepare, spmv): ``slabs = prepare(data_blk)`` re-lays this
    rank's assembled ELL block into its interior and boundary sliced-ELL
    operators (one gather each per assembly); ``spmv(slabs, x_blk)`` runs
    the ghost exchange with the interior B1 launch overlapped and the
    boundary B1 launch once the ghosts land (``overlap=False``: exchange
    first).  ``spmv.exchange.note`` says which transport ran."""
    spmv = HaloSpMVBell(plan, pattern, group, overlap, transport)
    return spmv.prepare, spmv
