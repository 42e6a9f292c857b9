"""The general sparse matvec of the BELL frame: blocked-ELL plans on the
host, a sliced-ELL (SELL-C-sigma) operator on the device.

Two layouts live here.

- :class:`BellPlan` (host, identical to ``femus_tpu``'s ``BellPlan``) is the
  blocked-ELL layout of the JAX package: rows cut into tiles of ``T`` rows,
  columns into ``C``-column blocks packed into 128-lane slab rows.  The
  port keeps it for what the solver reads from it: the frame (``perm`` /
  ``iperm``, identity or reverse Cuthill-McKee) and the slab-density figure
  that decides when an identity frame is rebuilt with RCM.  The port stores
  no slab.
- :class:`SellPlan` is the layout the card streams: rows of the frame are
  cut into slices of ``SELL_C`` = 32 rows (one warp); inside a window of
  ``sigma`` rows they are sorted by length, so a slice pads only to its own
  longest row (rounded up to ``SELL_V`` = 4 columns); values and int32
  columns (frame numbering) are stored slice by slice in groups of 4
  columns, lane-major inside a group, so lane r of a warp reads row r with
  one 16-byte load and a warp reads 512 contiguous bytes.  The row sort is
  a permutation inside the plan (``row_order``): the matvec writes ``y``
  back in frame order.

Assembled ELL data re-lays out with one gather through ``SellPlan.src``
(:func:`relayout_ell`).  The matvec ``y_frame = A_frame x_frame`` runs on a
CUDA tensor as the hand-written kernel ``csrc/sell_spmv.cu`` (one warp per
slice, lane = row, a running sum per lane) and on a CPU tensor as
:func:`_matvec_plain_frame` (gather, multiply, row sums over the same
arrays).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .._cuda_build import load_library
from .. import resolve_device
from .sparse import EllPattern

# slab rows per chunk: the plan pads the slab to whole chunks cut at tile
# boundaries (the layout femus_tpu's fused kernel streams; kept so the
# plans of both packages are identical arrays)
_CHUNK = 256

# the sliced-ELL layout of the card: rows per slice (one warp), slice
# columns per lane and load (16 bytes of float32 or int32), and the window
# of rows inside which rows are sorted by length.  sigma is fixed from the
# measured fill (stored slots / nonzeros) and kernel time of the 128x128
# cavity Jacobian (tools/torch_sell_sigma.py)
SELL_C = 32
SELL_V = 4
SELL_SIGMA = 512


def rcm_permutation(pattern: EllPattern) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrized pattern graph:
    new index i <-> old index perm[i]."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = pattern.n_rows
    a = sp.csr_matrix((np.ones(pattern.nnz, np.int8), pattern.indices,
                       pattern.indptr), shape=(n, pattern.n_cols))
    s = ((a + a.T) > 0).astype(np.int8)
    return np.asarray(reverse_cuthill_mckee(s.tocsr(), symmetric_mode=True),
                      dtype=np.int64)


@dataclasses.dataclass(frozen=True, eq=False)
class BellPlan:
    """Host-side BELL layout.  The fields up to ``tile_widths`` equal
    ``femus_tpu.algebra.bell.BellPlan``'s; ``pattern`` is the operator
    pattern the plan was built from (the sliced-ELL plan of the same frame
    is built from it on first use, :meth:`sell`)."""

    n: int                    # logical dof count (= pattern.n_rows)
    tile: int                 # rows per block (T)
    n_tiles: int
    n_xblocks: int            # col-blocks (C-wide) covering permuted x
    col_block: int            # C: columns per block (128 // pack)
    perm: np.ndarray          # (n,) new -> old dof index
    iperm: np.ndarray         # (n,) old -> new dof index
    block_ids: np.ndarray     # (nb_pad,) col-block id per block (C units)
    tile_start: np.ndarray    # (n_tiles + 1,) block range per row tile
    dest: np.ndarray          # (n*width,) slab-flat index per ELL slot
                              #            (out of bounds for padding slots)
    diag_src: np.ndarray      # (n,) slab-flat index of each row's diagonal
    nb: int                   # logical (nonempty) block count
    win_start: np.ndarray     # (n_chunks,) x-window start per chunk (C units)
    win: int                  # x-window width (C units, 128-padded)
    tile_ids: np.ndarray      # (slab_rows,) row-tile id per slab row
    twin_start: np.ndarray    # (n_chunks,) tile-window start per chunk
    twin: int                 # tile-window width (8-padded)
    chunk: int                # slab rows per chunk
    tile_widths: tuple        # per-chunk tile-range widths
    pattern: EllPattern       # the operator pattern (square)

    @property
    def identity(self) -> bool:
        """True when no reordering was applied (skips permute gathers)."""
        return bool(self.perm[0] == 0 and self.perm[-1] == self.n - 1
                    and np.array_equal(self.perm, np.arange(self.n)))

    @property
    def pack(self) -> int:
        return 128 // self.col_block

    @property
    def slab_rows(self) -> int:
        """Physical (T, 128) slab rows."""
        return int(self.block_ids.shape[0]) // self.pack

    def slab_bytes(self, itemsize: int = 4) -> int:
        return self.slab_rows * self.tile * 128 * itemsize

    @property
    def nnz_bytes_ratio(self) -> float:
        """Slab bytes / ideal ELL bytes (value+index) — the traffic price."""
        return self.slab_bytes() / (len(self.dest) * 8)

    def sell(self, sigma: int = SELL_SIGMA) -> "SellPlan":
        """The sliced-ELL plan of this pattern in this plan's frame
        (cached per sigma)."""
        cache = self.__dict__.setdefault("_sell", {})
        if sigma not in cache:
            cache[sigma] = build_sell_plan(self.pattern, self.perm, sigma)
        return cache[sigma]

    def to_device(self, device) -> "SellDev":
        """Device view of the sliced-ELL plan (cached per device)."""
        return self.sell().to_device(device)


def build_bell_plan(pattern: EllPattern, tile: int = 16,
                    perm=None, col_block: int = 32) -> BellPlan:
    """Blocked-ELL layout of ``pattern``.

    ``perm``: None -> RCM ordering; "identity" -> no permutation (block
    density relies on the dof numbering being local, e.g. a mesh passed
    through ``mesh.reorder.rcm_reorder`` with interleaved dofs); or an
    explicit (n,) ordering array.  ``col_block`` C: columns per block;
    ``tile`` T: rows per block.

    Layout invariants: blocks sorted (row-tile, col-block); each tile's
    block run padded to a multiple of ``pack`` (single-tile slab rows);
    slab rows cut into ``chunk``-row pieces at tile boundaries."""
    n = pattern.n_rows
    assert pattern.n_cols == n, "BELL expects a square operator"
    assert 128 % col_block == 0
    if isinstance(perm, str) and perm == "identity":
        perm = np.arange(n, dtype=np.int64)
    elif perm is None:
        perm = rcm_permutation(pattern)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(n)

    counts = np.diff(pattern.indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    rp = iperm[rows]
    cp = iperm[pattern.indices]

    C = col_block
    pack = 128 // C
    T = tile
    n_tiles = -(-n // T)
    n_xblocks = -(-n // C)
    chunk = _CHUNK

    key = (rp // T) * np.int64(n_xblocks) + cp // C
    uniq, inv = np.unique(key, return_inverse=True)
    nb = len(uniq)
    tid0 = (uniq // n_xblocks).astype(np.int64)
    bid0 = (uniq % n_xblocks).astype(np.int32)
    # pad each tile's block run to a pack multiple -> single-tile slab rows
    tiles_u, tstartb = np.unique(tid0, return_index=True)
    cnt = np.diff(np.append(tstartb, nb))
    rows_pt = -(-cnt // pack)                      # slab rows per tile
    row_off = np.concatenate([[0], np.cumsum(rows_pt)]).astype(np.int64)
    rank = np.arange(nb, dtype=np.int64) - np.repeat(tstartb, cnt)
    pb1 = np.repeat(row_off[:-1] * pack, cnt) + rank
    nrows1 = int(row_off[-1])
    rowtile = np.repeat(tiles_u, rows_pt)          # (nrows1,) tile per row
    # chunk cuts in row units at tile boundaries
    cuts = [0]
    while cuts[-1] < nrows1:
        limit = cuts[-1] + chunk
        if limit >= nrows1:
            cuts.append(nrows1)
            break
        j = np.searchsorted(row_off, limit, side="right") - 1
        cut = int(row_off[j])
        if cut <= cuts[-1]:            # one tile wider than a whole chunk
            cut = limit
        cuts.append(cut)
    cuts = np.asarray(cuts, np.int64)
    n_chunks = max(len(cuts) - 1, 1)
    sr = n_chunks * chunk
    # physical row of each padded row index
    chunk_of_r = np.searchsorted(cuts, np.arange(nrows1), side="right") - 1
    shift = np.arange(n_chunks, dtype=np.int64) * chunk - cuts[:-1]
    pr_of = np.arange(nrows1, dtype=np.int64) + shift[chunk_of_r]
    pb = pr_of[pb1 // pack] * pack + pb1 % pack    # final block position
    # relayout destinations per ELL slot
    prb = pb[inv]
    dest_nnz = ((prb // pack) * T + rp % T) * 128 + (prb % pack) * C + cp % C
    dest = sr * T * 128 + np.arange(n * pattern.width, dtype=np.int64)
    dest[pattern.csr_to_ell_slots()] = dest_nnz
    dest_csr = dest_nnz
    # per-chunk x windows + tile ranges (tb)
    win_start = np.zeros(n_chunks, np.int32)
    win = 1
    tb = np.zeros(n_chunks + 1, np.int64)
    tb[n_chunks] = n_tiles
    seam = False
    tid_by_row = np.zeros(sr, np.int32)
    bid_per_block = np.zeros(sr * pack, np.int32)
    bid_per_block[pb] = bid0
    for c in range(n_chunks):
        lo, hi = int(cuts[c]), int(cuts[c + 1])
        if hi > lo:
            blk_lo = np.searchsorted(pb1 // pack, lo, side="left")
            blk_hi = np.searchsorted(pb1 // pack, hi, side="left")
            ids = bid0[blk_lo:blk_hi]
            if len(ids):
                win_start[c] = ids.min()
                win = max(win, int(ids.max()) - int(ids.min()) + 1)
            tb[c] = 0 if c == 0 else rowtile[lo]
            if c > 0 and rowtile[lo - 1] >= rowtile[lo]:
                seam = True
        else:
            tb[c] = 0 if c == 0 else tb[c - 1]
    win = -(-win // 128) * 128
    win_start = np.minimum(win_start, max(n_xblocks, win) - win)
    widths = np.diff(tb)
    twin = -(-max(int(widths.max()) if len(widths) else 1, 1) // 8) * 8
    if seam:
        twin = 1 << 30
    twin_start = tb[:-1].astype(np.int32)
    tile_widths = tuple(int(w) for w in widths)
    # padding blocks/rows index their chunk's window starts (zero values)
    pad_mask = np.ones(sr * pack, bool)
    pad_mask[pb] = False
    pad_idx = np.flatnonzero(pad_mask)
    bid_per_block[pad_idx] = win_start[pad_idx // (chunk * pack)]
    row_pad = np.ones(sr, bool)
    row_pad[pr_of] = False
    tid_by_row[pr_of] = rowtile.astype(np.int32)
    rpad_idx = np.flatnonzero(row_pad)
    tid_by_row[rpad_idx] = twin_start[rpad_idx // chunk]
    size = sr * T * 128
    # diagonal slab positions per (new-order) row; rows without a diagonal
    # pattern entry read a guaranteed-zero hole
    diag_rows_new = rp[cp == rp]
    diag = np.empty(n, np.int64)
    diag[diag_rows_new] = dest_csr[cp == rp]
    if len(diag_rows_new) < n:
        used = np.zeros(size, bool)
        used[dest_csr] = True
        hole = int(np.argmin(used))
        if used[hole]:
            raise RuntimeError("BELL slab fully dense — no zero slot for "
                               "diagonal-less rows (pad blocks exhausted)")
        missing = np.ones(n, bool)
        missing[diag_rows_new] = False
        diag[missing] = hole
    diag = diag[iperm]               # new-row order -> original row order
    tile_start = np.concatenate([[0], np.cumsum(
        np.bincount(tid0, minlength=n_tiles))]).astype(np.int64)
    return BellPlan(n, T, n_tiles, n_xblocks, C, perm, iperm,
                    bid_per_block, tile_start, dest, diag, nb, win_start,
                    win, tid_by_row, twin_start, twin, chunk, tile_widths,
                    pattern)


@dataclasses.dataclass(frozen=True, eq=False)
class SellPlan:
    """Host-side sliced-ELL (SELL-C-sigma) layout of a pattern in a frame.

    Slot of column k of the row stored at lane r of slice s:
    ``(slice_ptr[s] + k // V) * C * V + r * V + k % V``."""

    n: int                    # logical dof count (= pattern.n_rows)
    nnz: int                  # pattern nonzeros
    sigma: int                # sorting window (rows)
    n_slices: int
    perm: np.ndarray          # (n,) frame -> original dof index
    iperm: np.ndarray         # (n,) original -> frame dof index
    slice_ptr: np.ndarray     # (n_slices + 1,) int32, in groups of C*V slots
    cols: np.ndarray          # (total,) int32 frame column per slot
    src: np.ndarray           # (total + 1,) ELL-flat slot per stored slot;
                              #   padding and the last entry point one past
                              #   the ELL data, where a zero is read
    row_order: np.ndarray     # (n_slices * C,) int32 frame row stored at
                              #   each (slice, lane); -1 beyond the last row
    diag_slot: np.ndarray     # (n,) slot of each ORIGINAL row's diagonal
                              #   (``total``, the zero, for rows without one)
    n_cols: int               # x entries (n, but for a rectangular block)

    @property
    def total(self) -> int:
        """Stored slots."""
        return int(self.cols.shape[0])

    @property
    def fill(self) -> float:
        """Stored slots / nonzeros (1.0 = no padding)."""
        return self.total / max(self.nnz, 1)

    @property
    def identity(self) -> bool:
        return bool(np.array_equal(self.perm, np.arange(self.n)))

    def to_device(self, device) -> "SellDev":
        """Device view of the plan (cached per device)."""
        device = resolve_device(device)
        cache = self.__dict__.setdefault("_dev", {})
        if device not in cache:
            def t(a, dt):
                return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

            ident = self.identity
            cache[device] = SellDev(
                t(self.slice_ptr, torch.int32), t(self.cols, torch.int32),
                t(self.row_order, torch.int32),
                t(self.src, torch.int32 if self.src[-1] < 2 ** 31
                  else torch.int64),
                t(self.diag_slot, torch.int64),
                None if ident else t(self.perm, torch.int64),
                None if ident else t(self.iperm, torch.int64),
                self.n, self.n_slices, self.nnz, self.sigma, self.n_cols)
        return cache[device]


def build_sell_plan(pattern: EllPattern, perm=None,
                    sigma: int = SELL_SIGMA) -> SellPlan:
    """Sliced-ELL layout of ``pattern`` in the frame ``perm`` (None -> RCM,
    "identity", or an explicit (n,) ordering, as :func:`build_bell_plan`).
    Rows are sorted by length (longest first, ties in frame order) inside
    windows of ``sigma`` frame rows, a multiple of the slice height."""
    n = pattern.n_rows
    assert pattern.n_cols == n, "the frame matvec expects a square operator"
    if isinstance(perm, str) and perm == "identity":
        perm = np.arange(n, dtype=np.int64)
    elif perm is None:
        perm = rcm_permutation(pattern)
    return sell_plan_from_csr(pattern.indptr, pattern.indices,
                              pattern.csr_to_ell_slots(), n,
                              n * pattern.width, perm, sigma)


def sell_plan_from_csr(indptr, indices, src_slots, n_cols: int,
                       zero_slot: int, perm=None,
                       sigma: int = SELL_SIGMA) -> SellPlan:
    """Sliced-ELL layout of a CSR structure whose value of CSR entry e sits
    at ``src_slots[e]`` of a flat data array of ``zero_slot`` entries (the
    relayout reads a zero appended there for padding).

    ``perm`` (n,): frame ordering of a square operator, rows and columns
    (:func:`build_sell_plan`).  ``perm=None``: rows and columns keep their
    numbering, and the block may be rectangular (``n_cols`` x-entries for
    ``len(indptr) - 1`` rows: the per-rank blocks of the halo SpMV,
    ``parallel/halo.py``)."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    n = len(indptr) - 1
    C, V = SELL_C, SELL_V
    if sigma % C:
        raise ValueError(f"sigma {sigma} is no multiple of {C}")
    framed = perm is not None
    if framed and n_cols != n:
        raise ValueError("a frame ordering needs a square operator")
    perm = (np.asarray(perm, dtype=np.int64) if framed
            else np.arange(n, dtype=np.int64))
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(n)
    nnz = len(indices)

    counts = np.diff(indptr)
    n_slices = -(-n // C)
    n_pad = n_slices * C
    lens = np.zeros(n_pad, np.int64)
    lens[:n] = counts[perm]
    rows_f = np.arange(n_pad, dtype=np.int64)
    order = np.lexsort((rows_f, -lens, rows_f // sigma))   # position -> row
    pos_of = np.empty(n_pad, np.int64)
    pos_of[order] = rows_f                                 # frame row -> position
    width = lens[order].reshape(n_slices, C).max(axis=1)
    groups = -(-width // V)                                # V-column groups
    slice_ptr = np.concatenate([[0], np.cumsum(groups)])
    total = int(slice_ptr[-1]) * C * V
    if total >= 2 ** 31:
        raise ValueError("sliced-ELL slab beyond 2^31 slots")
    row_order = np.where(order < n, order, -1).astype(np.int32)

    # padding slots: a zero value times the row's own x entry (the last
    # x entry for rows beyond a rectangular block's columns)
    slot_slice = np.repeat(np.arange(n_slices, dtype=np.int64),
                           groups * C * V)
    slot_lane = (np.arange(total, dtype=np.int64) // V) % C
    cols = np.minimum(np.maximum(row_order[slot_slice * C + slot_lane], 0),
                      max(n_cols - 1, 0)).astype(np.int32)
    del slot_slice, slot_lane
    src = np.full(total + 1, zero_slot, np.int64)
    # every nonzero: CSR entry e is column k of its row
    rows_o = np.repeat(np.arange(n, dtype=np.int64), counts)
    k = np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1], counts)
    pos = pos_of[iperm[rows_o]]
    slot = ((slice_ptr[pos // C] + k // V) * C + pos % C) * V + k % V
    cols[slot] = iperm[indices] if framed else indices
    src[slot] = src_slots
    diag_slot = np.full(n, total, np.int64)
    on_diag = indices == rows_o
    diag_slot[rows_o[on_diag]] = slot[on_diag]
    return SellPlan(n, int(nnz), int(sigma), n_slices, perm, iperm,
                    slice_ptr.astype(np.int32), cols, src, row_order,
                    diag_slot, int(n_cols))


@dataclasses.dataclass
class SellDev:
    """Device-side sliced-ELL plan tensors."""

    slice_ptr: torch.Tensor      # (n_slices + 1,) int32
    cols: torch.Tensor           # (total,) int32
    row_order: torch.Tensor      # (n_slices * C,) int32
    src: torch.Tensor            # (total + 1,) int32 (int64 past 2^31)
    diag_slot: torch.Tensor      # (n,) int64
    perm: Optional[torch.Tensor]     # None = identity ordering
    iperm: Optional[torch.Tensor]
    n: int
    n_slices: int
    nnz: int
    sigma: int
    n_cols: int                  # x entries (n, but for a rectangular block)

    @property
    def total(self) -> int:
        return int(self.cols.shape[0])

    @property
    def fill(self) -> float:
        return self.total / max(self.nnz, 1)


@dataclasses.dataclass
class BellOp:
    """Device operator of the BELL frame: sliced-ELL values + device plan."""

    vals: torch.Tensor          # (total + 1,): the stored slots and a zero
    dev: SellDev

    @property
    def n_rows(self) -> int:
        return self.dev.n

    @property
    def n_cols(self) -> int:
        return self.dev.n_cols

    # -- frame helpers: run whole solves in the permuted (banded) frame --
    def to_frame(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dev.perm is None else x[self.dev.perm]

    def from_frame(self, xf: torch.Tensor) -> torch.Tensor:
        return xf if self.dev.iperm is None else xf[self.dev.iperm]

    def matvec_frame(self, xf: torch.Tensor) -> torch.Tensor:
        """y_frame = A_frame x_frame: the CUDA kernel for a CUDA tensor,
        the plain version for a CPU tensor."""
        if xf.device.type == "cpu":
            return _matvec_plain_frame(self, xf)
        return spmv_bell_cuda(self, xf)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.from_frame(self.matvec_frame(self.to_frame(x)))

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        return self.vals[self.dev.diag_slot]


def _matvec_plain_frame(op: BellOp, xf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sliced-ELL matvec (frame-resident) over the arrays the
    kernel reads: one x gather per slot, the V products of a (group, lane)
    summed, groups summed onto their slice (``index_add_`` over the slice
    id of each group, from ``slice_ptr``), rows written back through
    ``row_order``.  Accumulates in the promotion of x's dtype and float32
    (bf16 values multiply into float32)."""
    p = op.dev
    C, V = SELL_C, SELL_V
    acc = torch.promote_types(xf.dtype, torch.float32)
    prod = op.vals[:p.total].to(acc) * xf.to(acc)[p.cols.long()]
    ptr = p.slice_ptr.long()
    group_slice = torch.repeat_interleave(
        torch.arange(p.n_slices, device=xf.device), ptr[1:] - ptr[:-1])
    stored = torch.zeros(p.n_slices, C, dtype=acc, device=xf.device)
    stored.index_add_(0, group_slice, prod.view(-1, C, V).sum(dim=-1))
    rows = p.row_order.long()
    real = rows >= 0
    y = torch.zeros(p.n, dtype=acc, device=xf.device)   # n rows, any n_cols
    y[rows[real]] = stored.view(-1)[real]
    return y.to(xf.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def spmv_bell_cuda(op: BellOp, xf: torch.Tensor) -> torch.Tensor:
    """y_frame = A_frame x_frame through the CUDA kernel
    (``csrc/sell_spmv.cu``), launched on the current stream: ``n`` rows of
    y from ``n_cols`` entries of x (a square frame, or a rectangular
    per-rank block of the halo SpMV).  Raises on anything the kernel does
    not take; there is no fallback."""
    p = op.dev
    vals = op.vals
    if not (xf.is_cuda and vals.is_cuda and xf.device == vals.device
            and p.cols.device == xf.device):
        raise ValueError("spmv_bell_cuda: values, x and plan must share one "
                         "CUDA device")
    if xf.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spmv_bell_cuda: x dtype {xf.dtype} not supported")
    if vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"spmv_bell_cuda: value dtype {vals.dtype} not "
                        "supported")
    if xf.shape != (p.n_cols,) or vals.shape != (p.total + 1,):
        raise ValueError(f"spmv_bell_cuda: shapes x {tuple(xf.shape)}, "
                         f"values {tuple(vals.shape)} do not fit the plan")
    if not (xf.is_contiguous() and vals.is_contiguous()
            and vals.data_ptr() % 16 == 0 and p.cols.data_ptr() % 16 == 0):
        raise ValueError("spmv_bell_cuda: x and values must be contiguous, "
                         "values and columns 16-byte aligned")
    fn = _sell_fn()
    y = xf.new_empty(p.n)          # a rectangular block: n rows, n_cols x
    stream = torch.cuda.current_stream(xf.device).cuda_stream
    rc = fn(vals.data_ptr(), _DTYPE_CODE[vals.dtype], p.cols.data_ptr(),
            p.slice_ptr.data_ptr(), p.row_order.data_ptr(), xf.data_ptr(),
            y.data_ptr(), _DTYPE_CODE[xf.dtype], p.n_slices, stream)
    if rc != 0:
        raise RuntimeError(f"sell_spmv kernel launch failed: CUDA error {rc}")
    spmv_bell_cuda.launches += 1
    return y


spmv_bell_cuda.launches = 0


_fn = []


def _sell_fn():
    """The kernel's C entry point (the library is built at first use)."""
    if not _fn:
        fn = load_library("algebra/csrc/sell_spmv.cu").sell_spmv
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, vp, vp, vp, vp, vp, ci, ci, vp]
        fn.restype = ci
        _fn.append(fn)
    return _fn[0]


def relayout_ell(plan, ell_data: torch.Tensor, dtype=None,
                 device="cuda") -> BellOp:
    """Lay assembled ELL data out as sliced-ELL values on ``device``: one
    gather through the plan's source index (padding slots read the zero
    appended to the data).  ``plan``: a host :class:`BellPlan` or
    :class:`SellPlan`, or a :class:`SellDev`.  ``dtype``: value storage
    type (float32, float64 or bfloat16); x and the accumulation stay in
    the solve precision."""
    device = resolve_device(device)
    dev = plan if isinstance(plan, SellDev) else plan.to_device(device)
    dt = ell_data.dtype if dtype is None else dtype
    flat = ell_data.to(device).reshape(-1)
    vals = torch.cat([flat, flat.new_zeros(1)])[dev.src]
    return BellOp(vals.to(dt), dev)

@dataclasses.dataclass
class BellBackedOp:
    """ELL operator whose matvec rides the sliced-ELL operator of the BELL
    frame.

    Quacks like :class:`~femus_tpu_torch.algebra.sparse.SparseOp`: ``data``
    / ``cols`` / ``rmatvec`` stay ELL (PtAP schedules, Vanka blocks and
    Dirichlet fix-ups read assembled ELL slots), ``matvec``/``@`` run on
    the sliced-ELL values."""

    data: torch.Tensor       # ELL (n_rows, width)
    cols: torch.Tensor       # ELL (n_rows, width) int64
    n_cols: int
    bell: BellOp

    @property
    def n_rows(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.bell.matvec(x)

    def __matmul__(self, x):
        return self.matvec(x)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.n_cols, dtype=self.data.dtype,
                          device=self.data.device)
        return out.index_add_(0, self.cols.reshape(-1),
                              (self.data * y[:, None]).reshape(-1))

    def diagonal(self) -> torch.Tensor:
        return self.bell.diagonal()

    def to_dense(self) -> torch.Tensor:
        from .sparse import SparseOp
        return SparseOp(self.data, self.cols, self.n_cols).to_dense()


def bell_backed(plan, op) -> BellBackedOp:
    """Wrap an assembled ELL operator with the frame matvec (values on the
    operator's device).  ``plan``: a host :class:`BellPlan` or
    :class:`SellPlan`, or a :class:`SellDev`."""
    return BellBackedOp(op.data, op.cols, op.n_cols,
                        relayout_ell(plan, op.data, device=op.data.device))


# rows from which an operator's matvec runs on the sliced-ELL operator of
# the BELL frame (kernel B1); below, the ELL gather is already cheap
BELL_MIN_ROWS = 2048


def bell_device_plan(pattern, order: str = "identity", device="cuda"):
    """(device plan, routing note) of an operator pattern: the sliced-ELL
    layout in the BELL frame, identity (``order="identity"``, rebuilt with
    RCM when the identity slab would exceed 24 B per nonzero) or RCM."""
    plan = build_bell_plan(pattern,
                           perm="identity" if order == "identity" else None)
    note = {"order": order}
    if order == "identity" and plan.nnz_bytes_ratio > 24.0:
        ratio = plan.nnz_bytes_ratio
        plan = build_bell_plan(pattern)        # RCM rescue
        note = {"order": "rcm-rescue",
                "reason": f"identity slab {ratio:.1f} B/nnz > 24.0, "
                          f"rebuilt with RCM ({plan.nnz_bytes_ratio:.1f})"}
    sell = plan.sell()
    note = {"path": "bell", "kernel": "bell_spmv", "sigma": sell.sigma,
            "fill": round(sell.fill, 4), **note}
    return sell.to_device(resolve_device(device)), note


def on_bell_frame(op, pattern, device, routing: Optional[list] = None):
    """``op`` with its matvec on the sliced-ELL operator of the BELL frame
    (kernel B1) from BELL_MIN_ROWS rows, else ``op`` itself; the decision
    is appended to ``routing``."""
    if pattern.n_rows < BELL_MIN_ROWS:
        note = {"n_rows": pattern.n_rows, "path": "ell",
                "reason": f"below bell threshold ({BELL_MIN_ROWS} rows)"}
    else:
        dev, note = bell_device_plan(pattern, "identity", device)
        note = {"n_rows": pattern.n_rows, **note}
        op = bell_backed(dev, op)
    if routing is not None:
        routing.append(note)
    return op
