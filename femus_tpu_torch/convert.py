"""Carry operators and state into the port from numpy arrays.

The JAX package's objects hand over as plain numpy arrays (its operators'
``data``/``cols``, its BELL plan's index arrays and slab, its patch
operators' weights and one-hot routing matrices, its DIA and lattice-stencil
operators' data and offsets, its solution fields, old fields and aux
fields, its material points and markers), so both packages can compute on
the same operator and state.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .algebra.bell import BellOp, build_sell_plan, relayout_ell
from .algebra.dia import DiaOp
from .algebra.patchstencil import (BlockPatchStencilOp, PatchRouting,
                                   PatchStencilOp, routing_from_onehot)
from .algebra.sparse import EllPattern, SparseOp
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


def bell_op_from_numpy(plan_arrays: Mapping, slab: np.ndarray, pattern,
                       device="cuda",
                       dtype: Optional[torch.dtype] = None) -> BellOp:
    """Frame operator from a blocked-ELL plan's arrays, its slab and the
    pattern the plan was built from.

    ``plan_arrays`` holds ``perm`` (None or the (n,) ordering) and ``dest``
    (the slab-flat index of every ELL slot, out of bounds for padding
    slots) — fields of the JAX package's ``BellPlan``; ``pattern`` has the
    fields of either package's ``EllPattern``.  The slab's values are read
    back into ELL order through ``dest`` and laid out in the sliced-ELL
    plan of the same frame."""
    device = resolve_device(device)
    pat = EllPattern(pattern.n_rows, pattern.n_cols, pattern.width,
                     np.asarray(pattern.cols), np.asarray(pattern.valid),
                     np.asarray(pattern.indptr), np.asarray(pattern.indices))
    flat = np.asarray(slab).reshape(-1)
    dest = np.asarray(plan_arrays["dest"])
    inside = dest < flat.size
    ell = np.zeros(dest.shape, flat.dtype)
    ell[inside] = flat[dest[inside]]
    perm = plan_arrays.get("perm")
    plan = build_sell_plan(pat, "identity" if perm is None else perm)
    return relayout_ell(plan, torch.as_tensor(ell).view(pat.n_rows, pat.width),
                        dtype=dtype, device=device)


def patch_op_from_numpy(wt: np.ndarray, G_face: np.ndarray,
                        G_edge: np.ndarray, M_cs: np.ndarray,
                        M_vs: np.ndarray, meta, device="cuda",
                        dtype: Optional[torch.dtype] = None) -> PatchStencilOp:
    """Patch-stencil operator from its weights, one-hot routing matrices
    and ``meta`` — the fields of the JAX package's ``PatchStencilOp``
    (7-entry meta) or ``BlockPatchStencilOp`` (8 entries, the last one nv).
    The routing matrices are read back into the port's index tables on the
    host; only those go to the device."""
    device = resolve_device(device)
    w = torch.as_tensor(np.array(wt), dtype=dtype, device=device)
    meta = tuple(int(v) for v in meta)
    routing = PatchRouting.from_arrays(
        routing_from_onehot(G_face, G_edge, M_cs, M_vs, meta), device)
    cls = BlockPatchStencilOp if len(meta) == 8 else PatchStencilOp
    return cls(w.contiguous(), routing, meta)


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
                        level: int = -1, old: bool = False):
    """Write named field arrays into one level of a port
    ``MultiLevelSolution``, into its old values with ``old`` (in place;
    returns it)."""
    dst = ml_sol.sol_old if old else ml_sol.sol
    for name, values in arrays.items():
        dst[level][name][:] = np.asarray(values)
    return ml_sol


def state_from_numpy(ml_sol, sol: Sequence[Mapping[str, np.ndarray]],
                     sol_old: Optional[Sequence[Mapping]] = None):
    """Carry a whole multilevel state across: ``sol`` (and ``sol_old``)
    hold one name -> array dict per level, as either package's
    ``MultiLevelSolution.sol`` / ``sol_old`` do."""
    for l, arrays in enumerate(sol):
        solution_from_numpy(ml_sol, arrays, l)
    for l, arrays in enumerate(sol_old or ()):
        solution_from_numpy(ml_sol, arrays, l, old=True)
    return ml_sol


def aux_fields_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda",
                          dtype: torch.dtype = None) -> Dict[str,
                                                             torch.Tensor]:
    """Aux field arrays (alias -> global dof vector, as the JAX package's
    ``System._aux_arrays`` gives them) as the ``aux_fields`` argument of
    the port's assembly and step functions."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in arrays.items()}


MPM_FIELDS = ("x", "v", "F", "mass", "vol0", "elem")


def mpm_state_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda",
                         dtype: Optional[torch.dtype] = None):
    """A material-point state from its arrays (``x``, ``v``, ``F``,
    ``mass``, ``vol0``, ``elem`` — the fields of either package's
    ``MPMState``), so both packages step the same cloud."""
    from .particles.mpm import MPMState

    device = resolve_device(device)
    dtype = dtype or torch.float64
    out = {k: torch.as_tensor(np.array(arrays[k]),
                              dtype=torch.int64 if k == "elem" else dtype,
                              device=device) for k in MPM_FIELDS}
    return MPMState(**out)


def marker_cloud_from_numpy(mesh, x: np.ndarray, elem: np.ndarray,
                            fields: Optional[Mapping[str, np.ndarray]] = None):
    """A marker cloud of the port on its ``mesh`` from positions, owner
    elements and named per-marker fields (those of either package's
    ``MarkerCloud``)."""
    from .particles.markers import MarkerCloud

    return MarkerCloud(mesh, np.array(x, np.float64),
                       np.array(elem, np.int64),
                       {k: np.array(v) for k, v in (fields or {}).items()})


def to_numpy(a) -> np.ndarray:
    """A host numpy array of ``a``: tensors (on any device) are copied to
    the host, everything else goes through ``np.asarray``."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)
