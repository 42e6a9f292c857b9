"""Batched block (Vanka / ASM-style) smoothers.

Blocks are the dof patches of a few consecutive elements.  All block
matrices are extracted from the ELL operator with one precomputed gather,
inverted together, and applied as batched dense matvecs.  On the card a
colour's blocks are gathered and inverted in one CUDA kernel call
(``csrc/vanka_invert.cu``, Gauss-Jordan with partial pivoting); on the host
by the plain chain (gather, batched LU, LU solves of the identity).
Blocks are greedily coloured so blocks of one colour touch disjoint dofs:
the multiplicative sweep refreshes the residual between colours
(Gauss-Seidel over colours); the additive sweep applies all blocks at once
with overlap averaging.  On the card the multiplicative sweep runs in one
CUDA kernel call a sweep (``csrc/vanka_colour.cu``: a colour's own residual
rows, then its block solves and update, two launches a colour); on the
host it runs the plain PyTorch chain.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .._cuda_build import load_library
from ..utils.telemetry import count, span
from .bell import _DTYPE_CODE
from .sparse import EllPattern


@dataclasses.dataclass
class VankaBlocks:
    """Block structure, pre-split by colour at build time.

    color_dofs[c]: (nb_c, bs) block dof ids, padded with n (dummy);
    color_slots[c]: (nb_c, bs, bs) flat ELL index (miss -> oob sentinel)."""

    color_dofs: Tuple[torch.Tensor, ...]
    color_slots: Tuple[torch.Tensor, ...]
    scale: torch.Tensor      # (n,) 1/overlap count (additive sweep)
    n: int

    @property
    def n_colors(self) -> int:
        return len(self.color_dofs)


def _color_blocks(blocks: Sequence[np.ndarray], n: int) -> np.ndarray:
    """Greedy colouring so blocks of one colour touch disjoint dofs."""
    colors = np.zeros(len(blocks), np.int32)
    used: list = []
    for i, b in enumerate(blocks):
        c = 0
        while True:
            if c == len(used):
                used.append(np.zeros(n, bool))
            if not used[c][b].any():
                used[c][b] = True
                colors[i] = c
                break
            c += 1
    return colors


def build_element_blocks(assembler, elems_per_block: int = 4,
                         pattern: Optional[EllPattern] = None,
                         dof_filter: Optional[np.ndarray] = None,
                         groups=None, device="cuda") -> VankaBlocks:
    """Blocks = dof patches of ``elems_per_block`` consecutive elements,
    without Dirichlet rows.

    pattern: ELL pattern of the target operator (default: the assembler's;
    pass the PtAP coarse pattern for a Galerkin-coarsened operator).
    dof_filter: boolean (n_dofs,) mask restricting blocks to a dof subset
    (Vanka within a field split).
    groups: None = blocks over all elements; "material" = blocks never
    span two element groups (the FSI fluid/solid split: each group's
    elements are chunked on their own); a sequence of group ids = blocks
    over the elements of those groups only."""
    device = resolve_device(device)
    edofs_all = assembler.edofs[:assembler.mesh.n_elems]
    eg = np.asarray(assembler.mesh.elem_group)
    if groups is None:
        chunks = [edofs_all]
    elif isinstance(groups, str):
        if groups != "material":
            raise ValueError(f"vanka groups {groups!r}")
        chunks = [edofs_all[eg == g] for g in np.unique(eg)]
    else:
        chunks = [edofs_all[np.isin(eg, list(groups))]]
    n = assembler.n_dofs
    blocks = []
    for edofs in chunks:
        for b in range(-(-len(edofs) // elems_per_block)):
            sel = edofs[b * elems_per_block:(b + 1) * elems_per_block]
            d = np.unique(sel)
            d = d[(d >= 0) & (d < n)]
            d = d[~assembler.dirichlet_mask[d]]
            if dof_filter is not None:
                d = d[dof_filter[d]]
            if len(d):
                blocks.append(d)
    if not blocks:
        raise ValueError("no non-empty Vanka blocks (filter too "
                         "restrictive?)")
    nb = len(blocks)
    bs = max(len(b) for b in blocks)
    dofs = np.full((nb, bs), n, np.int64)
    for i, b in enumerate(blocks):
        dofs[i, :len(b)] = b
    cnt = np.zeros(n + 1)
    np.add.at(cnt, dofs.ravel(), 1.0)
    scale = np.where(cnt[:n] > 0, 1.0 / np.maximum(cnt[:n], 1.0), 0.0)
    pat = pattern if pattern is not None else assembler.pattern
    lut = lut_with_miss(pat)
    bi = np.repeat(dofs, bs, axis=1).reshape(nb, bs, bs)
    bj = np.tile(dofs, (1, bs)).reshape(nb, bs, bs)
    slots = lut(bi.ravel(), bj.ravel()).reshape(nb, bs, bs)
    colors = _color_blocks(blocks, n)
    cd, cs = [], []
    for c in range(int(colors.max()) + 1):
        sel = colors == c
        cd.append(torch.as_tensor(dofs[sel], device=device))
        cs.append(torch.as_tensor(slots[sel], device=device))
    return VankaBlocks(tuple(cd), tuple(cs),
                       torch.as_tensor(scale, device=device), n)


def lut_with_miss(pattern: EllPattern):
    """(rows, cols) -> flat ELL slot, with misses/out-of-range -> oob index."""
    counts = np.diff(pattern.indptr)
    csr_rows = np.repeat(np.arange(pattern.n_rows, dtype=np.int64), counts)
    csr_keys = csr_rows * pattern.n_cols + pattern.indices
    ell_slots = pattern.csr_to_ell_slots()
    oob = pattern.n_rows * pattern.width

    def lut(rows, cols):
        in_range = (rows < pattern.n_rows) & (cols < pattern.n_cols)
        keys = rows.astype(np.int64) * pattern.n_cols + cols.astype(np.int64)
        pos = np.searchsorted(csr_keys, np.where(in_range, keys, 0))
        pos = np.minimum(pos, len(csr_keys) - 1)
        hit = in_range & (csr_keys[pos] == keys)
        return np.where(hit, ell_slots[pos], oob)

    return lut


def _invert_blocks(data: torch.Tensor, dofs: torch.Tensor,
                   slots: torch.Tensor, n: int):
    """Explicit batched block inverses, so each smoother application is
    one batched dense matvec: ``(Ainv, rv)``, ``Ainv`` (nb, bs, bs) and
    ``rv`` (nb, bs) the blocks' row mask.  ``slots`` index the flat
    operator values ``data``, ``data.numel()`` marking a miss.  Padding
    rows/cols of a block become identity.  Blocks of bfloat16 or float32
    values are inverted in float32, float64 ones in float64.  Values on
    the card take kernel V2 (:func:`vanka_invert_cuda`, one launch, no
    host wait), host values the plain chain (:func:`invert_plain`)."""
    if data.is_cuda:
        return vanka_invert_cuda(data.contiguous(), dofs, slots, n)
    return invert_plain(data, dofs, slots, n)


def gather_blocks(data: torch.Tensor, dofs: torch.Tensor,
                  slots: torch.Tensor, n: int) -> torch.Tensor:
    """The (nb, bs, bs) block matrices in ``data``'s dtype: the values at
    ``slots`` (``data.numel()`` a miss: zero), identity on padding rows and
    columns."""
    flat = torch.cat([data.reshape(-1), data.new_zeros(1)])
    Ab = flat[slots]                                   # (nb, bs, bs)
    rows_valid = dofs < n                              # (nb, bs)
    eye = torch.eye(dofs.shape[1], dtype=data.dtype, device=data.device)
    Ab = torch.where(rows_valid[:, :, None] & rows_valid[:, None, :], Ab, 0.0)
    return Ab + (~rows_valid).to(data.dtype)[:, :, None] * eye


def invert_plain(data: torch.Tensor, dofs: torch.Tensor,
                 slots: torch.Tensor, n: int):
    """:func:`_invert_blocks` in plain PyTorch, on any device: the gather,
    then a batched LU and LU solves of the identity (bfloat16 values in
    float32: there is no bfloat16 LU).  What the kernel computes; the
    host's path."""
    data = data.float() if data.dtype == torch.bfloat16 else data
    Ab = gather_blocks(data, dofs, slots, n)
    eye = torch.eye(dofs.shape[1], dtype=data.dtype, device=data.device)
    lu, piv = torch.linalg.lu_factor(Ab)
    Ainv = torch.linalg.lu_solve(lu, piv, eye.expand(Ab.shape))
    return Ainv, (dofs < n).to(data.dtype)


# the dynamic shared memory a V2 thread block may take (H100: 227 kB)
_MAX_INVERT_SMEM = 227 * 1024


def invert_smem_bytes(bs: int, dtype: torch.dtype) -> int:
    """Shared memory of one V2 thread block: a block of ``bs`` dofs in an
    odd leading dimension, two cached vectors and three int vectors, in
    float64 for float64 values and float32 otherwise."""
    x = 8 if dtype == torch.float64 else 4
    return (bs * (bs | 1) + 2 * bs) * x + 3 * bs * 4


def vanka_invert_cuda(data: torch.Tensor, dofs: torch.Tensor,
                      slots: torch.Tensor, n: int):
    """The blocks' inverses through the CUDA kernel V2
    (``csrc/vanka_invert.cu``), one launch on the current stream and no
    host wait: ``(Ainv, rv)`` as :func:`invert_plain` gives them.  The
    kernel writes the inverses transposed, so ``Ainv`` is the
    ``transpose(1, 2)`` view of a contiguous (nb, bs, bs) array (what
    :func:`colour_plan` reads without a copy).  A singular block gives
    non-finite entries, as the LU does, and raises nothing.  Counts
    ``vanka.invert_kernel`` by the blocks inverted.  Raises on anything
    the kernel does not take; there is no fallback."""
    dev = data.device
    if not (data.is_cuda and dofs.device == dev and slots.device == dev):
        raise ValueError("vanka_invert_cuda: values, dofs and slots must "
                         "share one CUDA device")
    if data.dtype not in _DTYPE_CODE:
        raise TypeError(f"vanka_invert_cuda: value dtype {data.dtype} not "
                        "supported")
    if dofs.dtype != torch.int64 or slots.dtype != torch.int64:
        raise TypeError("vanka_invert_cuda: dofs and slots must be int64")
    if dofs.dim() != 2 or slots.shape != (*dofs.shape, dofs.shape[1]):
        raise ValueError(f"vanka_invert_cuda: shapes dofs "
                         f"{tuple(dofs.shape)}, slots {tuple(slots.shape)} "
                         "are not (nb, bs) and (nb, bs, bs)")
    if not all(t.is_contiguous() for t in (data, dofs, slots)):
        raise ValueError("vanka_invert_cuda: values, dofs and slots must be "
                         "contiguous")
    nb, bs = dofs.shape
    if bs < 1 or n < 1:
        raise ValueError(f"vanka_invert_cuda: blocks of {bs} dofs over "
                         f"{n} rows")
    if invert_smem_bytes(bs, data.dtype) > _MAX_INVERT_SMEM:
        raise ValueError(f"vanka_invert_cuda: blocks of {bs} dofs in "
                         f"{data.dtype} exceed the card's shared memory")
    xdt = torch.float64 if data.dtype == torch.float64 else torch.float32
    ainv_t = torch.empty(nb, bs, bs, dtype=xdt, device=dev)
    rv = torch.empty(nb, bs, dtype=xdt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _invert_fn()(data.data_ptr(), _DTYPE_CODE[data.dtype], data.numel(),
                      dofs.data_ptr(), slots.data_ptr(), nb, bs,
                      ainv_t.data_ptr(), rv.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"vanka_invert kernel launch failed: CUDA error "
                           f"{rc}")
    vanka_invert_cuda.launches += 1
    count("vanka.invert_kernel", nb)
    return ainv_t.transpose(1, 2), rv


vanka_invert_cuda.launches = 0


def _correct(x, r, d, Ainv, rv, omega, scale=None):
    """x + omega * (the blocks ``d``'s solves of the residual ``r``,
    scattered; times ``scale`` for the additive sweep)."""
    n = x.shape[0]
    rb = torch.cat([r, r.new_zeros(1)])[d] * rv
    delta = torch.bmm(Ainv, rb[:, :, None])[:, :, 0] * rv
    upd = x.new_zeros(n + 1).index_add_(0, d.reshape(-1),
                                        delta.reshape(-1))[:n]
    return x + omega * (upd if scale is None else scale * upd)


def sweep_plain(A, per_color, b, x, omega: float = 1.0, iters: int = 1):
    """The multiplicative sweep in plain PyTorch, on any device: per colour
    ((dofs, Ainv, rv) as ``vanka_smoother`` builds them) the whole
    residual, then the colour's batched block solve and update.  What the
    kernel (:func:`vanka_sweep_cuda`) computes; the host's path."""
    for _ in range(iters):
        for d, Ainv, rv in per_color:
            x = _correct(x, b - A @ x, d, Ainv, rv, omega)
    return x


def vanka_smoother(A, blocks: VankaBlocks, omega: float = 1.0,
                   iters: int = 1, multiplicative: bool = True):
    """smooth(b, x) -> x.

    multiplicative=True: coloured sweeps, one batched solve per colour with
    the residual refreshed between colours (an operator on the card
    through the kernel, a host one through :func:`sweep_plain`; each colour
    step counts ``vanka.colour_kernel`` or ``vanka.colour_torch``).
    multiplicative=False: one additive sweep with overlap averaging (needs
    omega ~0.5).  Either way the block inverses are one span
    ``smoothers.vanka_invert`` and the counter ``vanka.blocks_inverted``
    adds the blocks inverted (``vanka.invert_kernel`` those kernel V2
    inverted, on the card)."""
    n = blocks.n
    count("vanka.blocks_inverted",
          sum(d.shape[0] for d in blocks.color_dofs))
    if multiplicative:
        with span("smoothers.vanka_invert"):
            per_color = [(d, *_invert_blocks(A.data, d, s, n))
                         for d, s in zip(blocks.color_dofs,
                                         blocks.color_slots)]
        steps = iters * len(per_color)
        if A.data.is_cuda:
            plan = colour_plan(A.data.contiguous(), A.cols.contiguous(),
                               per_color, n)

            def smooth(b, x):
                count("vanka.colour_kernel", steps)
                return vanka_sweep_cuda(plan, b, x, omega, iters)
        else:
            def smooth(b, x):
                count("vanka.colour_torch", steps)
                return sweep_plain(A, per_color, b, x, omega, iters)

        return smooth

    dofs = torch.cat(blocks.color_dofs)
    with span("smoothers.vanka_invert"):
        Ainv, rv = _invert_blocks(A.data, dofs,
                                  torch.cat(blocks.color_slots), n)
    scale = blocks.scale.to(A.data.dtype)

    def smooth(b, x):
        for _ in range(iters):
            x = _correct(x, b - A @ x, dofs, Ainv, rv, omega, scale)
        return x

    return smooth


# an update thread block's shared memory holds a block's residual at least
_MAX_SMEM = 48 * 1024


@dataclasses.dataclass
class ColourPlan:
    """A multiplicative sweep's operator and colours as the kernel reads
    them, checked once: ELL ``data`` (n, width) and int64 ``cols``, each
    colour's (nb_c, bs) int64 dof ids and its (nb_c, bs, bs) inverses
    transposed (``ainv_t[c][k, j, i] = Ainv[k, i, j]``: what kernel V2
    writes and the batched LU solve leaves, so no copy), and the ctypes
    arrays of their addresses."""

    data: torch.Tensor
    cols: torch.Tensor
    dofs: Tuple[torch.Tensor, ...]
    ainv_t: Tuple[torch.Tensor, ...]
    n: int
    bs: int
    rows: int                    # the largest colour's nb_c * bs
    dof_ptrs: ctypes.Array
    ainv_ptrs: ctypes.Array
    n_blocks: ctypes.Array


def colour_plan(data: torch.Tensor, cols: torch.Tensor, per_color,
                n: int) -> ColourPlan:
    """The :class:`ColourPlan` of ``per_color`` ((dofs, Ainv, rv) a colour,
    as ``vanka_smoother`` builds them) over the ELL operator
    (``data``, ``cols``) of ``n`` rows.  Raises on what the kernel does not
    take.  Inverses in another layout than V2's and the LU solve's are
    copied."""
    dofs = tuple(d for d, _, _ in per_color)
    ainv = tuple(a for _, a, _ in per_color)
    if not dofs:
        raise ValueError("vanka colour plan: no colours")
    dev = data.device
    if not (data.is_cuda and all(t.device == dev
                                 for t in (cols, *dofs, *ainv))):
        raise ValueError("vanka colour plan: operator, dofs and inverses "
                         "must share one CUDA device")
    if data.dtype not in _DTYPE_CODE:
        raise TypeError(f"vanka colour plan: value dtype {data.dtype} not "
                        "supported")
    adt = ainv[0].dtype
    if adt not in (torch.float32, torch.float64) or any(
            a.dtype != adt for a in ainv):
        raise TypeError("vanka colour plan: inverses must be one of "
                        "float32 or float64")
    if cols.dtype != torch.int64 or any(d.dtype != torch.int64
                                        for d in dofs):
        raise TypeError("vanka colour plan: columns and dofs must be int64")
    bs = dofs[0].shape[-1]
    if (data.dim() != 2 or data.shape != cols.shape or data.shape[0] != n
            or data.shape[1] < 1
            or any(d.dim() != 2 or d.shape[1] != bs for d in dofs)
            or any(a.shape != (d.shape[0], bs, bs)
                   for d, a in zip(dofs, ainv))):
        raise ValueError("vanka colour plan: shapes do not fit an (n, width) "
                         "operator and (nb, bs) blocks")
    if bs * ainv[0].element_size() > _MAX_SMEM:
        raise ValueError(f"vanka colour plan: blocks of {bs} dofs exceed "
                         "the update's shared memory")
    if not all(t.is_contiguous() for t in (data, cols, *dofs)):
        raise ValueError("vanka colour plan: operator and dofs must be "
                         "contiguous")
    ainv_t = tuple(a.transpose(1, 2).contiguous() for a in ainv)
    k = len(dofs)
    return ColourPlan(
        data, cols, dofs, ainv_t, n, bs,
        max(d.shape[0] for d in dofs) * bs,
        (ctypes.c_void_p * k)(*[d.data_ptr() for d in dofs]),
        (ctypes.c_void_p * k)(*[a.data_ptr() for a in ainv_t]),
        (ctypes.c_longlong * k)(*[d.shape[0] for d in dofs]))


def vanka_sweep_cuda(plan: ColourPlan, b: torch.Tensor, x: torch.Tensor,
                     omega: float = 1.0, iters: int = 1) -> torch.Tensor:
    """``iters`` multiplicative sweeps over the plan's colours through the
    CUDA kernel (``csrc/vanka_colour.cu``), launched on the current stream:
    a copy of ``x`` is updated in place and returned (``x`` is never
    written).  Raises on anything the kernel does not take; there is no
    fallback."""
    ainv = plan.ainv_t[0]
    if not (b.is_cuda and x.is_cuda and b.device == x.device == ainv.device):
        raise ValueError("vanka_sweep_cuda: b, x and the plan must share one "
                         "CUDA device")
    if not (b.dtype == x.dtype == ainv.dtype):
        raise TypeError(f"vanka_sweep_cuda: b {b.dtype} and x {x.dtype} "
                        f"must be the inverses' {ainv.dtype}")
    if b.shape != (plan.n,) or x.shape != (plan.n,):
        raise ValueError(f"vanka_sweep_cuda: shapes b {tuple(b.shape)}, "
                         f"x {tuple(x.shape)} do not fit n = {plan.n}")
    if not (b.is_contiguous() and x.is_contiguous()):
        raise ValueError("vanka_sweep_cuda: b and x must be contiguous")
    y = x.clone()
    r = x.new_empty(plan.rows)
    k = len(plan.dofs)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _sweep_fn()(k, plan.dof_ptrs, plan.ainv_ptrs, plan.n_blocks,
                     plan.bs, plan.data.data_ptr(),
                     _DTYPE_CODE[plan.data.dtype], plan.cols.data_ptr(),
                     plan.data.shape[1], b.data_ptr(), y.data_ptr(),
                     r.data_ptr(), _DTYPE_CODE[x.dtype], plan.n, omega,
                     iters, stream)
    if rc != 0:
        raise RuntimeError(f"vanka_colour kernel launch failed: CUDA error "
                           f"{rc}")
    vanka_sweep_cuda.launches += 2 * k * iters
    return y


vanka_sweep_cuda.launches = 0


_fn = []
_inv_fn = []


def _invert_fn():
    """V2's C entry point (the library is built at first use)."""
    if not _inv_fn:
        fn = load_library("algebra/csrc/vanka_invert.cu").vanka_invert
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [vp, ctypes.c_int, ll, vp, vp, ll, ctypes.c_int, vp, vp,
                       ll, vp]
        fn.restype = ctypes.c_int
        _inv_fn.append(fn)
    return _inv_fn[0]


def _sweep_fn():
    """The kernel's C entry point (the library is built at first use)."""
    if not _fn:
        fn = load_library("algebra/csrc/vanka_colour.cu").vanka_sweep
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ctypes.POINTER(vp), ctypes.POINTER(vp),
                       ctypes.POINTER(ctypes.c_longlong), ci, vp, ci, vp, ci,
                       vp, vp, vp, ci, ctypes.c_longlong, ctypes.c_double,
                       ci, vp]
        fn.restype = ci
        _fn.append(fn)
    return _fn[0]
