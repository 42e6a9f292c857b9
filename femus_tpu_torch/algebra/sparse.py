"""Sparse operators with a static ELL pattern.

The sparsity pattern is frozen on the host at set-up (FEM patterns are
static); the device holds a dense, padded value array:

- ELL layout: ``cols (n_rows, w)`` int64 and ``data (n_rows, w)``; padding
  entries point at the row's own diagonal with value 0, so SpMV needs no
  masking and the gather is always in bounds.
- SpMV = ``(data * x[cols]).sum(-1)`` (gather + row sum); ``A^T y`` is an
  ``index_add_`` scatter.  The sliced-ELL operator (bell.py) re-lays the
  same assembled data for the fast matvec.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class EllPattern:
    """Host-side immutable sparsity pattern with CSR<->ELL correspondence.

    eq=False: identity hash, so a pattern can key caches (BELL plans)."""

    n_rows: int
    n_cols: int
    width: int
    cols: np.ndarray          # (n_rows, width) int32, padded with row-diag col
    valid: np.ndarray         # (n_rows, width) bool
    indptr: np.ndarray        # CSR indptr (n_rows+1,)
    indices: np.ndarray       # CSR indices (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def csr_to_ell_slots(self) -> np.ndarray:
        """(nnz,) flat index into data.ravel() for each CSR entry, in CSR order."""
        counts = np.diff(self.indptr)
        rows = np.repeat(np.arange(self.n_rows), counts)
        k = np.arange(self.nnz) - np.repeat(self.indptr[:-1], counts)
        return (rows * self.width + k).astype(np.int64)


def pattern_from_pairs(rows: np.ndarray, cols: np.ndarray,
                       n_rows: int, n_cols: int) -> EllPattern:
    """Build an ELL pattern from (row, col) index pairs (duplicates merged).

    CSR entry order is (row, sorted col) — ELL slot k of row r is the k-th
    smallest column, making the layout deterministic."""
    m = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                      shape=(n_rows, n_cols))
    m.sum_duplicates()
    m.sort_indices()
    counts = np.diff(m.indptr)
    w = int(counts.max()) if n_rows else 0
    ell_cols = np.repeat(np.minimum(np.arange(n_rows), n_cols - 1)[:, None],
                         w, axis=1)
    valid = np.zeros((n_rows, w), bool)
    for_r = np.repeat(np.arange(n_rows), counts)
    k = np.arange(m.nnz) - np.repeat(m.indptr[:-1], counts)
    ell_cols[for_r, k] = m.indices
    valid[for_r, k] = True
    return EllPattern(n_rows, n_cols, w, ell_cols.astype(np.int32), valid,
                      m.indptr.copy(), m.indices.astype(np.int64))


def pad_pattern(pat: EllPattern, n_rows_pad: int, n_cols_pad: int) -> EllPattern:
    """Extend a pattern with identity padding rows (row i gets a single valid
    diagonal entry).  Padding rows are meant to be flagged Dirichlet."""
    if n_rows_pad == pat.n_rows and n_cols_pad == pat.n_cols:
        return pat
    extra = n_rows_pad - pat.n_rows
    cols = np.vstack([pat.cols,
                      np.repeat(np.arange(pat.n_rows, n_rows_pad,
                                          dtype=np.int32)[:, None],
                                pat.width, axis=1)])
    valid = np.vstack([pat.valid, np.zeros((extra, pat.width), bool)])
    valid[pat.n_rows:, 0] = True
    indptr = np.concatenate([pat.indptr,
                             pat.indptr[-1] + 1 + np.arange(extra)])
    indices = np.concatenate([pat.indices,
                              np.arange(pat.n_rows, n_rows_pad, dtype=np.int64)])
    return EllPattern(n_rows_pad, n_cols_pad, pat.width, cols, valid, indptr,
                      indices)


@dataclasses.dataclass
class SparseOp:
    """Device sparse matrix: ELL values + column table (same device)."""

    data: torch.Tensor       # (n_rows, width)
    cols: torch.Tensor       # (n_rows, width) int64
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return (self.data * x[self.cols]).sum(dim=-1)

    def __matmul__(self, x):
        return self.matvec(x)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """A^T y via an ``index_add_`` scatter."""
        out = torch.zeros(self.n_cols, dtype=self.data.dtype,
                          device=self.data.device)
        return out.index_add_(0, self.cols.reshape(-1),
                              (self.data * y[:, None]).reshape(-1))

    def diagonal(self) -> torch.Tensor:
        rows = torch.arange(self.n_rows, device=self.cols.device)[:, None]
        return (self.data * (self.cols == rows)).sum(dim=-1)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.n_rows * self.n_cols, dtype=self.data.dtype,
                          device=self.data.device)
        rows = torch.arange(self.n_rows, device=self.cols.device)[:, None]
        return out.index_add_(0, (rows * self.n_cols + self.cols).reshape(-1),
                              self.data.reshape(-1)).reshape(self.n_rows,
                                                             self.n_cols)


def op_from_pattern(pat: EllPattern, data: torch.Tensor) -> SparseOp:
    """ELL operator on ``pat`` with values ``data`` (n_rows, width); the
    columns go to the device the values are on."""
    return SparseOp(data, torch.as_tensor(pat.cols, dtype=torch.int64,
                                          device=data.device), pat.n_cols)


def op_from_scipy(m: sp.spmatrix, device, dtype=torch.float64
                  ) -> Tuple[SparseOp, EllPattern]:
    """ELL operator (on ``device``) and its pattern from a scipy matrix."""
    m = m.tocsr()
    m.sort_indices()
    coo = m.tocoo()
    pat = pattern_from_pairs(coo.row, coo.col, m.shape[0], m.shape[1])
    data = np.zeros((pat.n_rows, pat.width), np.float64)
    data.ravel()[pat.csr_to_ell_slots()] = m.data
    op = SparseOp(torch.as_tensor(data, dtype=dtype, device=device),
                  torch.as_tensor(pat.cols, dtype=torch.int64, device=device),
                  pat.n_cols)
    return op, pat
