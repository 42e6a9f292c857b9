"""Carry operators and state into the port from numpy arrays.

The JAX package's objects hand over as plain numpy arrays (its operators'
``data``/``cols``, its BELL plan's index arrays and slab, its patch
operators' weights and routing matrices, its DIA and lattice-stencil
operators' data and offsets, its solution fields), so both
packages can compute on the same operator and state.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from . import resolve_device
from .algebra.bell import BellDev, BellOp
from .algebra.dia import DiaOp
from .algebra.patchstencil import BlockPatchStencilOp, PatchStencilOp
from .algebra.sparse import SparseOp
from .algebra.stencil import StencilOp


def sparse_op_from_numpy(data: np.ndarray, cols: np.ndarray, n_cols: int,
                         device="cuda",
                         dtype: Optional[torch.dtype] = None) -> SparseOp:
    """ELL operator from its value and column arrays."""
    device = resolve_device(device)
    data = np.asarray(data)
    return SparseOp(torch.as_tensor(data, dtype=dtype, device=device),
                    torch.as_tensor(np.asarray(cols), dtype=torch.int64,
                                    device=device), int(n_cols))


def bell_op_from_numpy(plan_arrays: Mapping, slab: np.ndarray,
                       device="cuda",
                       dtype: Optional[torch.dtype] = None) -> BellOp:
    """BELL operator from a plan's arrays and its slab.

    ``plan_arrays`` holds ``n``, ``tile``, ``n_tiles``, ``n_xblocks``,
    ``col_block``, ``perm`` (None or the (n,) ordering), ``block_ids``,
    ``tile_ids``, ``dest`` and ``diag_src`` — the fields of either
    package's ``BellPlan``.  Without ``tile_row_ptr``/``tile_rows`` (the
    JAX plan has none) the kernel's walk order is derived from
    ``tile_ids``: every slab row of a tile, chunk padding included (padding
    rows hold zeros and add nothing)."""
    device = resolve_device(device)
    p = dict(plan_arrays)
    if "tile_row_ptr" not in p:
        tid = np.asarray(p["tile_ids"])
        order = np.argsort(tid, kind="stable")
        p["tile_rows"] = order.astype(np.int32)
        p["tile_row_ptr"] = np.searchsorted(
            tid[order], np.arange(int(p["n_tiles"]) + 1)).astype(np.int32)
    perm = p.get("perm")
    if perm is not None and np.array_equal(perm, np.arange(int(p["n"]))):
        perm = None
    dev = BellDev.from_arrays(
        device, n=p["n"], tile=p["tile"], n_tiles=p["n_tiles"],
        n_xblocks=p["n_xblocks"], col_block=p["col_block"], perm=perm,
        block_ids=p["block_ids"], tile_ids=p["tile_ids"], dest=p["dest"],
        diag_src=p["diag_src"], tile_row_ptr=p["tile_row_ptr"],
        tile_rows=p["tile_rows"])
    blocks = torch.as_tensor(np.asarray(slab), dtype=dtype, device=device)
    return BellOp(blocks.reshape(dev.slab_rows, dev.tile, 128).contiguous(),
                  dev)


def patch_op_from_numpy(wt: np.ndarray, G_face: np.ndarray,
                        G_edge: np.ndarray, M_cs: np.ndarray,
                        M_vs: np.ndarray, meta, device="cuda",
                        dtype: Optional[torch.dtype] = None) -> PatchStencilOp:
    """Patch-stencil operator from its weights, routing matrices and
    ``meta`` — the fields of either package's ``PatchStencilOp`` (7-entry
    meta) or ``BlockPatchStencilOp`` (8 entries, the last one nv).  The
    routing matrices take the weights' dtype."""
    device = resolve_device(device)
    w = torch.as_tensor(np.array(wt), dtype=dtype, device=device)
    routing = [torch.as_tensor(np.array(m), dtype=w.dtype, device=device)
               for m in (G_face, G_edge, M_cs, M_vs)]
    meta = tuple(int(v) for v in meta)
    cls = BlockPatchStencilOp if len(meta) == 8 else PatchStencilOp
    return cls(w.contiguous(), *routing, meta)


def dia_op_from_numpy(data: np.ndarray, offsets, n: int, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> DiaOp:
    """DIA operator from its ``(K, n)`` data and its offsets — the fields
    of either package's ``DiaOp``."""
    device = resolve_device(device)
    d = torch.as_tensor(np.array(data), dtype=dtype, device=device)
    return DiaOp(d.contiguous(), tuple(int(o) for o in offsets), int(n))


def stencil_op_from_numpy(data: np.ndarray, offsets, grid, device="cuda",
                          dtype: Optional[torch.dtype] = None) -> StencilOp:
    """Lattice-stencil operator from its data, ``(di, dj)`` offsets and
    logical ``(N, M)`` grid — the fields of either package's ``StencilOp``.
    The JAX package pads ``data`` to ``(K, Nt, Mp)`` tiles; the padding is
    dropped, the port stores the logical ``(K, N, M)`` block."""
    device = resolve_device(device)
    N, M = (int(v) for v in grid)
    d = torch.as_tensor(np.array(data)[:, :N, :M], dtype=dtype,
                        device=device)
    return StencilOp(d.contiguous(),
                     tuple((int(di), int(dj)) for di, dj in offsets), (N, M))


def solution_from_numpy(ml_sol, arrays: Dict[str, np.ndarray],
                        level: int = -1):
    """Write named field arrays into one level of a port
    ``MultiLevelSolution`` (in place; returns it)."""
    for name, values in arrays.items():
        ml_sol.sol[level][name][:] = np.asarray(values)
    return ml_sol
