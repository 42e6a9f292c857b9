"""Inter-level transfer operators and Galerkin coarsening.

- Prolongation P (coarse -> fine) per FE family, built element-wise on the
  host from the refinement embedding.
- Galerkin triple product A_c = P^T A_f P as a precomputed linear
  schedule: with both patterns static, every coarse nnz is a fixed linear
  combination of fine nnz values, so the device-side PtAP is one gather +
  multiply + per-segment sum.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import resolve_device
from ..mesh.refine import local_prolongation
from .sparse import EllPattern, SparseOp, op_from_scipy, pattern_from_pairs


def prolongation_scipy(coarse_mesh, fine_mesh, family: str) -> sp.csr_matrix:
    """(n_fine_dofs, n_coarse_dofs) interpolation matrix for one family."""
    assert fine_mesh.parent_elem is not None, "fine mesh lacks refinement lineage"
    blocks = local_prolongation(fine_mesh.geom, family)   # (nk, ndf, ndc)
    dmf = fine_mesh.dofmap(family)
    dmc = coarse_mesh.dofmap(family)
    ndf, ndc = blocks.shape[1], blocks.shape[2]
    rows = np.repeat(dmf.conn, ndc, axis=1).ravel()
    cols = np.tile(dmc.conn[fine_mesh.parent_elem], (1, ndf)).ravel()
    slots = np.asarray(fine_mesh.child_slot)
    vals = blocks[slots].ravel()
    # conforming interpolation: duplicated (row, col) pairs agree — keep first
    keys = rows.astype(np.int64) * dmc.n_dofs + cols
    _, first = np.unique(keys, return_index=True)
    rows, cols, vals = rows[first], cols[first], vals[first]
    keep = np.abs(vals) > 1e-14
    P = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])),
                      shape=(dmf.n_dofs, dmc.n_dofs))
    P.sum_duplicates()
    P.sort_indices()
    return P


def block_diag_prolongation(coarse_mesh, fine_mesh, unknowns) -> sp.csr_matrix:
    """Stacked-block prolongation over a system's unknowns (KKoffset layout)."""
    mats = [prolongation_scipy(coarse_mesh, fine_mesh, u.family)
            for u in unknowns]
    return sp.block_diag(mats, format="csr")


@dataclasses.dataclass
class PtAPSchedule:
    """Device-side Galerkin product:
    coarse_data[s] = sum over triplets with dst == s of coeff * fine_data[src].

    The sum is per segment (``index_add_``), never the difference of a
    global prefix sum: in float32 a running prefix whose magnitude is far
    above a segment's sum wipes the segment out entirely."""

    coarse_pattern: EllPattern
    src: torch.Tensor          # (n_triplets,) flat index into fine ELL data
    dst: torch.Tensor          # (n_triplets,) flat index into coarse ELL data
    coeff: torch.Tensor        # (n_triplets,)
    coarse_cols: torch.Tensor  # coarse pattern cols on the device (int64)
    coarse_valid: torch.Tensor  # coarse pattern valid mask on the device

    def apply(self, fine_data: torch.Tensor) -> torch.Tensor:
        """fine ELL data (nr, w) -> coarse ELL data (nrc, wc)."""
        contrib = self.coeff.to(fine_data.dtype) * fine_data.reshape(-1)[self.src]
        nrc, wc = self.coarse_pattern.n_rows, self.coarse_pattern.width
        out = fine_data.new_zeros(nrc * wc)
        return out.index_add_(0, self.dst, contrib).view(nrc, wc)


def ptap_triplets(fine_pattern: EllPattern, P: sp.csr_matrix,
                  R: Optional[sp.spmatrix] = None):
    """Host side of the triple product: the coarse pattern and the sorted
    (src, dst, coeff) triplets.

    Galerkin (R=None): A_c[i, j] = sum_{k,l} P[k, i] A[k, l] P[l, j] — for
    every fine nnz (k, l) and every (i in P-row k, j in P-row l) one triplet
    (dst=slot_c(i,j), src=slot_f(k,l), coeff=P[k,i] * P[l,j]).  With an
    explicit R (nc x nf) the left factor draws i from R-column k."""
    counts_f = np.diff(fine_pattern.indptr)
    k_of = np.repeat(np.arange(fine_pattern.n_rows), counts_f)
    l_of = fine_pattern.indices
    slot_f = fine_pattern.csr_to_ell_slots()
    ones = sp.csr_matrix((np.ones_like(slot_f, dtype=np.float64),
                          fine_pattern.indices.astype(np.int64),
                          fine_pattern.indptr),
                         shape=(fine_pattern.n_rows, fine_pattern.n_cols))
    Pc = P.tocsr()
    Lc = Pc if R is None else R.T.tocsr()
    # symbolic product with |P|: signed entries can cancel exactly and
    # punch holes in the coarse pattern
    Pabs = Pc.copy()
    Pabs.data = np.abs(Pabs.data)
    Labs = Lc.copy()
    Labs.data = np.abs(Labs.data)
    C = (Labs.T @ ones @ Pabs).tocsr()
    C.sort_indices()
    coo = C.tocoo()
    # always include the diagonal so Dirichlet identity rows exist on coarse
    # levels even when P has been masked at essential dofs
    dg = np.arange(C.shape[0])
    cpat = pattern_from_pairs(np.concatenate([coo.row, dg]),
                              np.concatenate([coo.col, dg]),
                              C.shape[0], C.shape[1])
    from ..assembly.engine import _build_slot_lut
    lut_c = _build_slot_lut(cpat)
    Pptr, Pidx, Pval = Pc.indptr, Pc.indices, Pc.data
    Lptr, Lidx, Lval = Lc.indptr, Lc.indices, Lc.data
    src_all, dst_all, coeff_all = [], [], []
    B = 1 << 20
    for s0 in range(0, len(slot_f), B):
        kk = k_of[s0:s0 + B]
        ll = l_of[s0:s0 + B]
        ss = slot_f[s0:s0 + B]
        nk = Lptr[kk + 1] - Lptr[kk]
        nl = Pptr[ll + 1] - Pptr[ll]
        reps = nk * nl
        if reps.sum() == 0:
            continue
        ent = np.repeat(np.arange(len(kk)), reps)
        starts = np.zeros(len(reps), np.int64)
        np.cumsum(reps[:-1], out=starts[1:])
        offs = np.arange(int(reps.sum()), dtype=np.int64) - starts[ent]
        a = offs // nl[ent]
        b = offs % nl[ent]
        pi = Lidx[Lptr[kk[ent]] + a]
        pj = Pidx[Pptr[ll[ent]] + b]
        cv = Lval[Lptr[kk[ent]] + a] * Pval[Pptr[ll[ent]] + b]
        src_all.append(ss[ent])
        dst_all.append(lut_c(pi, pj))
        coeff_all.append(cv)
    src = np.concatenate(src_all)
    dst = np.concatenate(dst_all)
    coeff = np.concatenate(coeff_all)
    keep = np.abs(coeff) > 0
    src, dst, coeff = src[keep], dst[keep], coeff[keep]
    order = np.argsort(dst, kind="stable")
    return cpat, src[order], dst[order], coeff[order]


def build_ptap_schedule(fine_pattern: EllPattern, P: sp.csr_matrix,
                        dtype=torch.float64,
                        R: Optional[sp.spmatrix] = None,
                        device="cuda") -> PtAPSchedule:
    """Precompute the triple-product schedule (see :func:`ptap_triplets`)
    and upload it to ``device``."""
    device = resolve_device(device)
    cpat, src, dst, coeff = ptap_triplets(fine_pattern, P, R)
    i64 = dict(dtype=torch.int64, device=device)
    return PtAPSchedule(cpat, torch.as_tensor(src, **i64),
                        torch.as_tensor(dst, **i64),
                        torch.as_tensor(coeff, dtype=dtype, device=device),
                        torch.as_tensor(cpat.cols, **i64),
                        torch.as_tensor(cpat.valid, device=device))


def mask_prolongation(P: sp.spmatrix, row_mask, col_mask) -> sp.csr_matrix:
    """Zero the masked (essential/Dirichlet) rows and columns of a transfer
    operator (CSR diagonal scaling)."""
    dr = sp.diags((~np.asarray(row_mask[:P.shape[0]])).astype(np.float64))
    dc = sp.diags((~np.asarray(col_mask[:P.shape[1]])).astype(np.float64))
    Pm = (dr @ P @ dc).tocsr()
    Pm.eliminate_zeros()
    return Pm


def op_pair_from_scipy(P: sp.csr_matrix, dtype=torch.float64,
                       R: Optional[sp.spmatrix] = None,
                       device="cuda") -> Tuple[SparseOp, SparseOp]:
    """(P, R) as device ELL operators; R defaults to P^T (Galerkin)."""
    device = resolve_device(device)
    Pop, _ = op_from_scipy(P, device, dtype)
    Rm = P.T.tocsr() if R is None else R.tocsr()
    Rop, _ = op_from_scipy(Rm, device, dtype)
    return Pop, Rop
