"""Batched block (Vanka / ASM-style) smoothers.

Blocks are the dof patches of a few consecutive elements.  All block
matrices are extracted from the ELL operator with one precomputed gather,
inverted together (batched LU), and applied as batched dense matvecs.
Blocks are greedily coloured so blocks of one colour touch disjoint dofs:
the multiplicative sweep refreshes the residual between colours
(Gauss-Seidel over colours); the additive sweep applies all blocks at once
with overlap averaging.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
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
                         device="cuda") -> VankaBlocks:
    """Blocks = dof patches of ``elems_per_block`` consecutive elements,
    without Dirichlet rows.

    pattern: ELL pattern of the target operator (default: the assembler's;
    pass the PtAP coarse pattern for a Galerkin-coarsened operator)."""
    device = resolve_device(device)
    edofs = assembler.edofs[:assembler.mesh.n_elems]
    n = assembler.n_dofs
    blocks = []
    for b in range(-(-len(edofs) // elems_per_block)):
        sel = edofs[b * elems_per_block:(b + 1) * elems_per_block]
        d = np.unique(sel)
        d = d[(d >= 0) & (d < n)]
        d = d[~assembler.dirichlet_mask[d]]
        if len(d):
            blocks.append(d)
    assert blocks, "no non-empty Vanka blocks"
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


def _invert_blocks(A, dofs: torch.Tensor, slots: torch.Tensor, n: int):
    """Explicit batched block inverses (batched LU, then LU solves of the
    identity), so each smoother application is one batched dense matvec.
    Padding rows/cols of a block become identity."""
    data = A.data
    flat = torch.cat([data.reshape(-1), data.new_zeros(1)])
    Ab = flat[slots]                                   # (nb, bs, bs)
    rows_valid = dofs < n                              # (nb, bs)
    bs = dofs.shape[1]
    eye = torch.eye(bs, dtype=data.dtype, device=data.device)
    Ab = torch.where(rows_valid[:, :, None] & rows_valid[:, None, :], Ab, 0.0)
    Ab = Ab + (~rows_valid).to(data.dtype)[:, :, None] * eye
    lu, piv = torch.linalg.lu_factor(Ab)
    Ainv = torch.linalg.lu_solve(lu, piv, eye.expand(Ab.shape))
    return Ainv, rows_valid.to(data.dtype)


def vanka_smoother(A, blocks: VankaBlocks, omega: float = 1.0,
                   iters: int = 1, multiplicative: bool = True):
    """smooth(b, x) -> x.

    multiplicative=True: coloured sweeps, one batched solve per colour with
    the residual refreshed between colours.  multiplicative=False: one
    additive sweep with overlap averaging (needs omega ~0.5)."""
    n = blocks.n

    def correct(x, r, d, Ainv, rv, scale=None):
        rb = torch.cat([r, r.new_zeros(1)])[d] * rv
        delta = torch.bmm(Ainv, rb[:, :, None])[:, :, 0] * rv
        upd = x.new_zeros(n + 1).index_add_(0, d.reshape(-1),
                                            delta.reshape(-1))[:n]
        return x + omega * (upd if scale is None else scale * upd)

    if multiplicative:
        per_color = [(d, *_invert_blocks(A, d, s, n))
                     for d, s in zip(blocks.color_dofs, blocks.color_slots)]

        def smooth(b, x):
            for _ in range(iters):
                for d, Ainv, rv in per_color:
                    x = correct(x, b - A @ x, d, Ainv, rv)
            return x

        return smooth

    dofs = torch.cat(blocks.color_dofs)
    Ainv, rv = _invert_blocks(A, dofs, torch.cat(blocks.color_slots), n)
    scale = blocks.scale.to(A.data.dtype)

    def smooth(b, x):
        for _ in range(iters):
            x = correct(x, b - A @ x, dofs, Ainv, rv, scale)
        return x

    return smooth
