"""Diagonal (DIA) sparse operator: SpMV without column indices.

FEM operators on lattice-ordered dof numberings are stencil matrices: every
nonzero lies on one of a small set of constant diagonals (col - row = const;
25 diagonals for Q2 quads).  Stored by diagonals,

    y[i] = sum_k  data[k, i] * x[i + offsets[k]]        (x = 0 outside [0, n))

needs no index array at all: 4 B/nnz in float32 instead of 8.  Note the
flattened form reads ``x[i + off]`` whenever that index lies in ``[0, n)``,
also where the lattice column ``j + dj`` has left its row; an assembled
operator holds zeros there, random data does not (the 2-D form,
stencil.py, masks per row instead).

The sum is kernel B4: ``csrc/dia_spmv.cu`` on a CUDA tensor
(:func:`spmv_dia_cuda`), the plain PyTorch version :func:`_matvec_plain`
(shifted slices of a zero-padded x) on a CPU tensor.

Conversion from the general ELL operator is a precomputed gather (host-built
slot map, :func:`build_dia_plan`), so assembled data is re-laid out on the
device after each assembly.  The plan is None when the pattern has too many
distinct diagonals (unstructured meshes keep the ELL path).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._cuda_build import load_library
from .sparse import EllPattern

MAX_DIAGS = 128          # offsets the kernel takes (csrc/dia_spmv.cu)
MAX_ROWS = 1 << 30       # rows the kernel takes (32-bit row arithmetic)
DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _matvec_plain(data: torch.Tensor, offsets: Tuple[int, ...],
                  x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B4: the K shifted-slice products of
    a zero-padded x, summed in offset order."""
    n = x.shape[0]
    lo = -min(0, min(offsets))
    hi = max(0, max(offsets))
    xpad = torch.nn.functional.pad(x, (lo, hi))
    y = torch.zeros_like(x)
    for k, off in enumerate(offsets):
        y = y + data[k] * xpad[lo + off:lo + off + n]
    return y


@functools.lru_cache(maxsize=64)
def _c_offsets(offsets: Tuple[int, ...]):
    """The offsets as a C array, made once per distinct offset tuple (the
    kernel receives them by value; nothing is copied to the device)."""
    return (ctypes.c_longlong * len(offsets))(*offsets)


def _dia_lib():
    lib = load_library("algebra/csrc/dia_spmv.cu")
    fn = lib.dia_spmv
    if fn.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, ci, ll, ci,
                       ctypes.POINTER(ctypes.c_longlong), vp]
        fn.restype = ci
    return lib


def spmv_dia_cuda(op: "DiaOp", x: torch.Tensor) -> torch.Tensor:
    """Kernel B4 (``csrc/dia_spmv.cu``) on the current stream: ``y = A x``.
    Raises on anything the kernel does not take; there is no fallback."""
    data = op.data
    if not (data.is_cuda and x.is_cuda and data.device == x.device):
        raise ValueError("spmv_dia_cuda: data and x must share one CUDA "
                         "device")
    if x.dtype not in DTYPE_CODE or data.dtype != x.dtype:
        raise TypeError(f"spmv_dia_cuda: dtypes {data.dtype}/{x.dtype} not "
                        "supported (float32 or float64, one for both)")
    K = len(op.offsets)
    if not 1 <= K <= MAX_DIAGS or op.n > MAX_ROWS:
        raise ValueError(f"spmv_dia_cuda: {K} diagonals (1..{MAX_DIAGS}), "
                         f"{op.n} rows (up to {MAX_ROWS})")
    if tuple(data.shape) != (K, op.n) or tuple(x.shape) != (op.n,):
        raise ValueError(f"spmv_dia_cuda: shapes {tuple(data.shape)}, "
                         f"{tuple(x.shape)} do not fit K={K}, n={op.n}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("spmv_dia_cuda: tensors must be contiguous")
    lib = _dia_lib()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.dia_spmv(data.data_ptr(), x.data_ptr(), y.data_ptr(),
                      DTYPE_CODE[x.dtype], op.n, K, _c_offsets(op.offsets),
                      stream)
    if rc != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error {rc}")
    spmv_dia_cuda.launches += 1
    return y


spmv_dia_cuda.launches = 0


@dataclasses.dataclass
class DiaOp:
    """data[k, i] = A[i, i + offsets[k]] (0 where out of band/pattern)."""

    data: torch.Tensor           # (K, n)
    offsets: Tuple[int, ...]     # static
    n: int

    @property
    def n_rows(self) -> int:
        return self.n

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Kernel B4 for a CUDA tensor, its plain version for a CPU one."""
        if x.device.type == "cpu":
            return _matvec_plain(self.data, self.offsets, x)
        return spmv_dia_cuda(self, x)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        return self.data[self.offsets.index(0)]


@dataclasses.dataclass
class DiaPlan:
    """Host-built ELL -> DIA relayout plan."""

    offsets: Tuple[int, ...]
    src: np.ndarray          # (K, n) int64 flat index into ell data; the
                             # index one past its end = the appended zero
    _src_dev: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def apply(self, ell_data: torch.Tensor, n: int) -> DiaOp:
        """One gather of the ELL values (on their device) into diagonals;
        the slot map is uploaded once per device."""
        dev = ell_data.device
        if dev not in self._src_dev:
            self._src_dev[dev] = torch.as_tensor(self.src, device=dev)
        flat = torch.cat([ell_data.reshape(-1), ell_data.new_zeros(1)])
        return DiaOp(flat[self._src_dev[dev]], self.offsets, n)


def build_dia_plan(pattern: EllPattern,
                   max_diags: int = MAX_DIAGS) -> Optional[DiaPlan]:
    """Detect diagonal structure; None if > max_diags distinct offsets."""
    if pattern.n_rows != pattern.n_cols:
        return None
    counts = np.diff(pattern.indptr)
    rows = np.repeat(np.arange(pattern.n_rows, dtype=np.int64), counts)
    offs = pattern.indices - rows
    uniq = np.unique(offs)
    if len(uniq) > max_diags:
        return None
    koff = np.searchsorted(uniq, offs)
    src = np.full((len(uniq), pattern.n_rows), -1, np.int64)
    src[koff, rows] = pattern.csr_to_ell_slots()
    # -1 maps to the appended zero element
    src = np.where(src < 0, pattern.n_rows * pattern.width, src)
    return DiaPlan(tuple(int(o) for o in uniq), src)
