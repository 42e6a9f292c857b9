"""2-D lattice stencil SpMV for structured dof numberings.

On a lattice-ordered dof grid (structured box meshes: Q1/Q2 dofs form an
(N, M) grid and every DIA offset decomposes as ``off = di*M + dj`` with
small |di|, |dj|), the operator is a variable-coefficient 2-D stencil:

    y[i, j] = sum_k  data[k, i, j] * x[i + di_k, j + dj_k]

with x zero outside the lattice: unlike the flattened DIA form (dia.py), a
column offset that leaves its lattice row reads zero, not the neighbouring
row's end.

Storage: ``data`` is the contiguous logical ``(K, N, M)`` array with no
padding, so :func:`build_stencil` is a reshape of the DIA data (a view, no
copy) and ``data[k].reshape(-1)`` IS diagonal ``di*M + dj``.  Kernel B3
reads it with scalar coalesced loads, which need no row alignment.

The sum is kernel B3: ``csrc/stencil_spmv.cu`` on a CUDA tensor
(:func:`spmv_stencil_cuda`), the plain PyTorch version
:func:`_matvec_plain` (shifted windows of a zero-haloed x grid) on a CPU
tensor.  Unstructured meshes keep the DIA/ELL paths.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .._cuda_build import load_library
from .dia import DTYPE_CODE, DiaOp

MAX_HALO = 8             # |di|, |dj| the kernel takes (csrc/stencil_spmv.cu)
MAX_OFFSETS = (2 * MAX_HALO + 1) ** 2
MAX_ROW_WIDTH = 1 << 26  # M the kernel takes (32-bit di * M + dj)


def _matvec_plain(data: torch.Tensor, offsets, grid: Tuple[int, int],
                  x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B3: the K shifted-window products of
    the zero-haloed x grid, summed in offset order."""
    N, M = grid
    hd = max(abs(di) for di, _ in offsets)
    hw = max(abs(dj) for _, dj in offsets)
    x2 = torch.nn.functional.pad(x.view(N, M), (hw, hw, hd, hd))
    y = x.new_zeros((N, M))
    for k, (di, dj) in enumerate(offsets):
        y = y + data[k] * x2[hd + di:hd + di + N, hw + dj:hw + dj + M]
    return y.reshape(-1)


@functools.lru_cache(maxsize=64)
def _c_offsets(offsets):
    """(di, dj) as two C arrays, made once per distinct offset tuple (the
    kernel receives them by value; nothing is copied to the device)."""
    arr = ctypes.c_int * len(offsets)
    return arr(*(di for di, _ in offsets)), arr(*(dj for _, dj in offsets))


def _stencil_lib():
    lib = load_library("algebra/csrc/stencil_spmv.cu")
    fn = lib.stencil_spmv
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, ip, ip, vp]
        fn.restype = ci
    return lib


def spmv_stencil_cuda(op: "StencilOp", x: torch.Tensor) -> torch.Tensor:
    """Kernel B3 (``csrc/stencil_spmv.cu``) on the current stream:
    ``y = A x``.  Raises on anything the kernel does not take; there is no
    fallback."""
    data = op.data
    N, M = op.grid
    K = len(op.offsets)
    if not (data.is_cuda and x.is_cuda and data.device == x.device):
        raise ValueError("spmv_stencil_cuda: data and x must share one CUDA "
                         "device")
    if x.dtype not in DTYPE_CODE or data.dtype != x.dtype:
        raise TypeError(f"spmv_stencil_cuda: dtypes {data.dtype}/{x.dtype} "
                        "not supported (float32 or float64, one for both)")
    if not 1 <= K <= MAX_OFFSETS or any(
            max(abs(di), abs(dj)) > MAX_HALO for di, dj in op.offsets):
        raise ValueError(f"spmv_stencil_cuda: {K} offsets, halo up to "
                         f"{MAX_HALO} (at most {MAX_OFFSETS} offsets)")
    if M > MAX_ROW_WIDTH:
        raise ValueError(f"spmv_stencil_cuda: row width {M} above "
                         f"{MAX_ROW_WIDTH}")
    if tuple(data.shape) != (K, N, M) or tuple(x.shape) != (N * M,):
        raise ValueError(f"spmv_stencil_cuda: shapes {tuple(data.shape)}, "
                         f"{tuple(x.shape)} do not fit K={K}, grid={op.grid}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("spmv_stencil_cuda: tensors must be contiguous")
    lib = _stencil_lib()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.stencil_spmv(data.data_ptr(), x.data_ptr(), y.data_ptr(),
                          DTYPE_CODE[x.dtype], N, M, K,
                          *_c_offsets(op.offsets), stream)
    if rc != 0:
        raise RuntimeError("stencil_spmv kernel launch failed: CUDA error "
                           f"{rc}")
    spmv_stencil_cuda.launches += 1
    return y


spmv_stencil_cuda.launches = 0


@dataclasses.dataclass
class StencilOp:
    """data[k, i, j] = A[(i, j), (i + di_k, j + dj_k)] on the (N, M)
    lattice; ``data`` is contiguous and unpadded."""

    data: torch.Tensor                     # (K, N, M)
    offsets: Tuple[Tuple[int, int], ...]   # static (di, dj)
    grid: Tuple[int, int]                  # (N, M)

    @property
    def n_rows(self) -> int:
        return self.grid[0] * self.grid[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Kernel B3 for a CUDA tensor, its plain version for a CPU one."""
        if x.device.type == "cpu":
            return _matvec_plain(self.data, self.offsets, self.grid, x)
        return spmv_stencil_cuda(self, x)

    def __matmul__(self, x):
        return self.matvec(x)


def build_stencil(dia: DiaOp, row_width: int,
                  max_halo: int = MAX_HALO) -> Optional[StencilOp]:
    """Decompose a DIA operator over an (N, M)-lattice dof grid.

    row_width: M, the fast (contiguous) grid dimension of the dof numbering.
    Returns None unless every offset splits as di*M + dj with
    |di|,|dj| <= max_halo (i.e. the numbering really is the lattice).  The
    result shares the DIA operator's data."""
    n = dia.n
    if row_width <= 0 or n % row_width:
        return None
    M = row_width
    N = n // M
    offs = []
    for o in dia.offsets:
        di = int(np.rint(o / M))
        dj = o - di * M
        if abs(di) > max_halo or abs(dj) > max_halo:
            return None
        offs.append((di, dj))
    return StencilOp(dia.data.reshape(len(offs), N, M), tuple(offs), (N, M))
