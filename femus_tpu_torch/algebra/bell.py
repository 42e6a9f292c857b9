"""The general sparse matvec of the BELL frame (kernel B1): a sliced-ELL
(SELL-C-sigma) operator on the device, in a frame of the operator's dofs.

- The frame (``perm`` / ``iperm``) is the identity or reverse Cuthill-McKee.
  :func:`bell_device_plan` decides it, and whether an operator takes B1 at
  all, in one place: an identity frame is rebuilt with RCM where the JAX
  package's blocked-ELL slab would be too sparse (its rescue rule, whose
  density :func:`slab_bytes_per_nnz` computes without building a slab).
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
    "identity", or an explicit (n,) ordering: new index i <-> old perm[i]).
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
    appended to the data).  ``plan``: a host :class:`SellPlan` or a
    :class:`SellDev`.  ``dtype``: value storage
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
    operator's device).  ``plan``: a host :class:`SellPlan` or a
    :class:`SellDev`."""
    return BellBackedOp(op.data, op.cols, op.n_cols,
                        relayout_ell(plan, op.data, device=op.data.device))


# rows from which an operator's matvec runs on the sliced-ELL operator of
# the BELL frame (kernel B1); below, the ELL gather is already cheap
BELL_MIN_ROWS = 2048

# the JAX package's blocked-ELL slab, whose density its RCM rescue reads:
# row tiles of 16, column blocks of 32 packed 4 to a 128-lane slab row,
# slab rows padded to chunks of 256 cut at tile boundaries.  They reproduce
# that rule's figure here and feed no layout of the port
_SLAB_TILE, _SLAB_COLS, _SLAB_PACK, _SLAB_CUT = 16, 32, 4, 256


def slab_bytes_per_nnz(pattern: EllPattern, perm: np.ndarray) -> float:
    """Bytes of the JAX package's blocked-ELL slab of ``pattern`` in the
    frame ``perm`` over the value and index bytes of its ELL slots (that
    package's ``nnz_bytes_ratio``, equal to the last bit), counted without
    building the slab: the nonempty (row tile, column block) pairs, a
    tile's blocks in whole slab rows, slab rows in whole chunks."""
    n = pattern.n_rows
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(n)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(pattern.indptr))
    n_xblocks = -(-n // _SLAB_COLS)
    blocks = np.unique((iperm[rows] // _SLAB_TILE) * np.int64(n_xblocks)
                       + iperm[pattern.indices] // _SLAB_COLS)
    _, per_tile = np.unique(blocks // n_xblocks, return_counts=True)
    row_off = np.concatenate([[0], np.cumsum(-(-per_tile // _SLAB_PACK))])
    n_chunks, cut, end = 0, 0, int(row_off[-1])
    while cut < end:
        limit = cut + _SLAB_CUT
        nxt = end if limit >= end else int(
            row_off[np.searchsorted(row_off, limit, side="right") - 1])
        cut = nxt if nxt > cut else limit   # one tile wider than a chunk
        n_chunks += 1
    slab = max(n_chunks, 1) * _SLAB_CUT * _SLAB_TILE * 128 * 4
    return slab / (int(n) * int(pattern.width) * 8)


def bell_device_plan(pattern, order: str = "identity", device="cuda"):
    """(device plan, routing note) of an operator pattern: None below
    BELL_MIN_ROWS rows, else the sliced-ELL layout in the BELL frame,
    identity (``order="identity"``, rebuilt with RCM when the identity slab
    would exceed 24 B per nonzero) or RCM."""
    n = pattern.n_rows
    if n < BELL_MIN_ROWS:
        return None, {"n_rows": n, "path": "ell",
                      "reason": f"below bell threshold ({BELL_MIN_ROWS} rows)"}
    note = {"order": order}
    if order == "identity":
        perm = np.arange(n, dtype=np.int64)
        ratio = slab_bytes_per_nnz(pattern, perm)
        if ratio > 24.0:
            perm = rcm_permutation(pattern)        # RCM rescue
            note = {"order": "rcm-rescue",
                    "reason": f"identity slab {ratio:.1f} B/nnz > 24.0, "
                              "rebuilt with RCM "
                              f"({slab_bytes_per_nnz(pattern, perm):.1f})"}
    else:
        perm = rcm_permutation(pattern)
    sell = build_sell_plan(pattern, perm)
    note = {"n_rows": n, "path": "bell", "kernel": "bell_spmv",
            "sigma": sell.sigma, "fill": round(sell.fill, 4), **note}
    return sell.to_device(resolve_device(device)), note


def on_bell_frame(op, pattern, device, routing: Optional[list] = None):
    """``op`` with its matvec on the sliced-ELL operator of the BELL frame
    (kernel B1) where :func:`bell_device_plan` gives a plan, else ``op``
    itself; the decision is appended to ``routing``."""
    dev, note = bell_device_plan(pattern, "identity", device)
    if routing is not None:
        routing.append(note)
    return op if dev is None else bell_backed(dev, op)
