"""Blocked-ELL (BELL) sparse operator — the fast matvec for general
unstructured operators.

Layout (host plan, identical to ``femus_tpu``'s ``BellPlan``):

- rows are cut into tiles of ``T`` rows, columns into narrow ``C``-column
  blocks (default C=32: FEM rows cluster in ~30-column neighbour groups);
  ``pack = 128 // C`` blocks share one 128-lane physical slab row, so the
  slab is ``(slab_rows, T, 128)``;
- each tile's block run is padded to a multiple of ``pack``, so one slab
  row never mixes tiles;
- dofs may be reordered by reverse Cuthill-McKee (``perm``) so each row's
  neighbours land in a narrow index range — dense blocks.

Assembled ELL data re-lays out into the slab with one scatter per assembly
(:func:`relayout_ell`).  The matvec ``y_frame = A_frame x_frame`` runs on a
CUDA tensor as the hand-written kernel ``csrc/bell_spmv.cu`` (one warp per
row tile, x gathered directly — exact, no window or size cap) and on a CPU
tensor as :func:`_matvec_plain_frame` (gather, multiply, lane sum,
``index_add_`` over the per-row tile ids).
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
    ``femus_tpu.algebra.bell.BellPlan``'s; ``tile_row_ptr``/``tile_rows``
    (the physical slab rows of each row tile, CSR-style) are the CUDA
    kernel's walk order."""

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
    tile_row_ptr: np.ndarray  # (n_tiles + 1,) range into tile_rows
    tile_rows: np.ndarray     # (real slab rows,) physical rows, by tile

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

    def to_device(self, device) -> "BellDev":
        """Device view of the plan (cached per device)."""
        device = resolve_device(device)
        cache = self.__dict__.setdefault("_dev", {})
        if device not in cache:
            cache[device] = BellDev.from_arrays(
                device, n=self.n, tile=self.tile, n_tiles=self.n_tiles,
                n_xblocks=self.n_xblocks, col_block=self.col_block,
                perm=None if self.identity else self.perm,
                block_ids=self.block_ids, tile_ids=self.tile_ids,
                dest=self.dest, diag_src=self.diag_src,
                tile_row_ptr=self.tile_row_ptr, tile_rows=self.tile_rows)
        return cache[device]


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
    # kernel walk order: the real slab rows of each tile (padded rows are
    # sorted by tile, so pr_of lists them tile by tile)
    tile_row_ptr = np.searchsorted(rowtile, np.arange(n_tiles + 1)
                                   ).astype(np.int32)
    tile_rows = pr_of.astype(np.int32)
    return BellPlan(n, T, n_tiles, n_xblocks, C, perm, iperm,
                    bid_per_block, tile_start, dest, diag, nb, win_start,
                    win, tid_by_row, twin_start, twin, chunk, tile_widths,
                    tile_row_ptr, tile_rows)


@dataclasses.dataclass
class BellDev:
    """Device-side BELL plan tensors."""

    block_ids: torch.Tensor      # (slab_rows * pack,) int32
    tile_ids: torch.Tensor       # (slab_rows,) int64
    tile_row_ptr: torch.Tensor   # (n_tiles + 1,) int32
    tile_rows: torch.Tensor      # (real slab rows,) int32
    relayout_src: torch.Tensor   # ELL flat slots that land in the slab
    relayout_dst: torch.Tensor   # their slab-flat destinations
    diag_src: torch.Tensor       # (n,) int64
    perm: Optional[torch.Tensor]     # None = identity ordering
    iperm: Optional[torch.Tensor]
    n: int
    tile: int
    n_xblocks: int
    col_block: int
    n_tiles: int

    @classmethod
    def from_arrays(cls, device, *, n, tile, n_tiles, n_xblocks, col_block,
                    perm, block_ids, tile_ids, dest, diag_src,
                    tile_row_ptr, tile_rows) -> "BellDev":
        """Upload host plan arrays (``perm`` None = identity ordering)."""
        def t(a, dt):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        sr = len(tile_ids)
        dest = np.asarray(dest)
        src = np.flatnonzero(dest < sr * tile * 128)
        iperm = None
        if perm is not None:
            iperm = np.empty(n, np.int64)
            iperm[np.asarray(perm)] = np.arange(n)
        return cls(t(block_ids, torch.int32), t(tile_ids, torch.int64),
                   t(tile_row_ptr, torch.int32), t(tile_rows, torch.int32),
                   t(src, torch.int64), t(dest[src], torch.int64),
                   t(diag_src, torch.int64),
                   None if perm is None else t(perm, torch.int64),
                   None if iperm is None else t(iperm, torch.int64),
                   int(n), int(tile), int(n_xblocks), int(col_block),
                   int(n_tiles))

    @property
    def pack(self) -> int:
        return 128 // self.col_block

    @property
    def slab_rows(self) -> int:
        return int(self.tile_ids.shape[0])


@dataclasses.dataclass
class BellOp:
    """Device BELL operator (slab + device plan)."""

    blocks: torch.Tensor        # (slab_rows, T, 128)
    dev: BellDev

    @property
    def n_rows(self) -> int:
        return self.dev.n

    @property
    def n_cols(self) -> int:
        return self.dev.n

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
        return self.blocks.reshape(-1)[self.dev.diag_src]


def _matvec_plain_frame(op: BellOp, xf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch BELL matvec (frame-resident): one C-wide x gather per
    block, full-lane row sums (slab rows are single-tile), ``index_add_``
    over the per-row tile ids.  Accumulates in the promotion of x's dtype
    and float32 (bf16 slabs multiply into float32)."""
    p = op.dev
    C, pack, T = p.col_block, p.pack, p.tile
    acc = torch.promote_types(xf.dtype, torch.float32)
    xp = torch.zeros(p.n_xblocks * C, dtype=xf.dtype, device=xf.device)
    xp[:p.n] = xf
    xg = xp.view(p.n_xblocks, C)[p.block_ids].reshape(p.slab_rows, pack * C)
    rowsum = (op.blocks.to(acc) * xg.to(acc)[:, None, :]).sum(dim=-1)
    yt = torch.zeros(p.n_tiles, T, dtype=acc, device=xf.device)
    yt.index_add_(0, p.tile_ids, rowsum)
    return yt.reshape(-1)[:p.n].to(xf.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def spmv_bell_cuda(op: BellOp, xf: torch.Tensor) -> torch.Tensor:
    """y_frame = A_frame x_frame through the CUDA kernel
    (``csrc/bell_spmv.cu``), launched on the current stream.  Raises on
    anything the kernel does not take; there is no fallback."""
    p = op.dev
    blocks = op.blocks
    if not (xf.is_cuda and blocks.is_cuda and xf.device == blocks.device
            and p.block_ids.device == xf.device):
        raise ValueError("spmv_bell_cuda: slab, x and plan must share one "
                         "CUDA device")
    if xf.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spmv_bell_cuda: x dtype {xf.dtype} not supported")
    if blocks.dtype not in _DTYPE_CODE:
        raise TypeError(f"spmv_bell_cuda: slab dtype {blocks.dtype} not "
                        "supported")
    if p.tile not in (8, 16) or p.col_block % 4:
        raise ValueError("spmv_bell_cuda: needs tile 8 or 16 and a column "
                         "block that is a multiple of 4")
    if xf.shape != (p.n,) or blocks.shape != (p.slab_rows, p.tile, 128):
        raise ValueError(f"spmv_bell_cuda: shapes x {tuple(xf.shape)}, slab "
                         f"{tuple(blocks.shape)} do not fit the plan")
    if not (xf.is_contiguous() and blocks.is_contiguous()
            and blocks.data_ptr() % 16 == 0):
        raise ValueError("spmv_bell_cuda: x and slab must be contiguous, "
                         "slab 16-byte aligned")
    lib = _bell_lib()
    y = torch.empty_like(xf)
    stream = torch.cuda.current_stream(xf.device).cuda_stream
    rc = lib.bell_spmv(blocks.data_ptr(), _DTYPE_CODE[blocks.dtype],
                       xf.data_ptr(), y.data_ptr(), _DTYPE_CODE[xf.dtype],
                       p.block_ids.data_ptr(), p.tile_row_ptr.data_ptr(),
                       p.tile_rows.data_ptr(), p.n, p.n_tiles, p.tile,
                       p.col_block, stream)
    if rc != 0:
        raise RuntimeError(f"bell_spmv kernel launch failed: CUDA error {rc}")
    spmv_bell_cuda.launches += 1
    return y


spmv_bell_cuda.launches = 0


def _bell_lib():
    lib = load_library("algebra/csrc/bell_spmv.cu")
    fn = lib.bell_spmv
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp, ctypes.c_longlong,
                       ci, ci, ci, vp]
        fn.restype = ci
    return lib


def relayout_ell(plan, ell_data: torch.Tensor, dtype=None,
                 device="cuda") -> BellOp:
    """Scatter assembled ELL data into the BELL slab on ``device`` (one
    scatter of the in-slab ELL slots; padding slots are dropped).
    ``plan``: a host :class:`BellPlan` or a :class:`BellDev`.  ``dtype``:
    slab storage type (float32, float64 or bfloat16); x and the
    accumulation stay in the solve precision."""
    device = resolve_device(device)
    dev = plan.to_device(device) if isinstance(plan, BellPlan) else plan
    dt = ell_data.dtype if dtype is None else dtype
    slab = torch.zeros(dev.slab_rows * dev.tile * 128, dtype=dt,
                       device=device)
    src = ell_data.to(device).reshape(-1)[dev.relayout_src]
    slab[dev.relayout_dst] = src.to(dt)
    return BellOp(slab.view(dev.slab_rows, dev.tile, 128), dev)


@dataclasses.dataclass
class BellBackedOp:
    """ELL operator whose matvec rides the BELL slab.

    Quacks like :class:`~femus_tpu_torch.algebra.sparse.SparseOp`: ``data``
    / ``cols`` / ``rmatvec`` stay ELL (PtAP schedules, Vanka blocks and
    Dirichlet fix-ups read assembled ELL slots), ``matvec``/``@`` run on
    the slab."""

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
    """Wrap an assembled ELL operator with a BELL matvec (slab on the
    operator's device).  ``plan``: a host :class:`BellPlan` or a
    :class:`BellDev`."""
    return BellBackedOp(op.data, op.cols, op.n_cols,
                        relayout_ell(plan, op.data, device=op.data.device))
