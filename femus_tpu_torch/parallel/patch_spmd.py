"""Sharded patch-stencil SpMV: slabs of patches over a group of ranks.

The patch-lattice operator (algebra/patchstencil.py) shards on its patch
axis, the counterpart of the reference's element-partition domain
decomposition (SURVEY.md §2.4): each rank owns a contiguous slab of
coarse-element patches (their weights and the interior dofs of those
patches), while the SKELETON (coarse-edge and vertex values, an amount of
data set by the coarse mesh alone) is replicated.  Each rank runs its slab
through kernel B2 (``csrc/patch_stencil.cu``): the slab is a patch
operator of its own, whose routing tables are the global ones restricted
to the slab (sides of other ranks' patches dropped), so its skeleton rows
come out as the slab's partial sums.  One ``all_reduce`` closes them (the
JAX package's ``psum``); the interior rows never communicate.  The
communication per matvec is E * n_edges + n_verts values.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..algebra.patchstencil import PatchRouting, PatchStencilOp, _round_up
from .ranks import RankGroup


def slab_bounds(P: int, n_ranks: int) -> List[Tuple[int, int]]:
    """Contiguous patch ranges [lo, hi) of the ranks: the P real patches
    split as evenly as they go (the padding patches belong to no rank)."""
    cuts = np.linspace(0, P, n_ranks + 1).round().astype(int)
    return [(int(cuts[r]), int(cuts[r + 1])) for r in range(n_ranks)]


def patch_slab(op: PatchStencilOp, lo: int, hi: int) -> dict:
    """Host arrays of the slab of patches [lo, hi) of a scalar patch
    operator: weights padded to a multiple of 128 patches, the routing
    tables restricted to the slab (patch ids relative to ``lo``), and the
    slab's meta (H, P_loc, Pp_loc, E, n_edges, n_verts, n_loc)."""
    if op.nv != 1:
        raise ValueError("patch_slab: scalar patch operators only")
    H, P, Pp, E, n_edges, n_verts, n = op.meta[:7]
    Pl = hi - lo
    Ppl = _round_up(max(Pl, 1), 128)
    wt = np.zeros(op.wt.shape[:3] + (Ppl,), op.wt.cpu().numpy().dtype)
    wt[..., :Pl] = op.wt[..., lo:hi].cpu().numpy()
    rt = op.routing
    fc = np.full((4, Ppl), -1, np.int32)
    fc[:, :Pl] = rt.face_code[:, lo:hi].cpu().numpy()
    cv = np.full((4, Ppl), -1, np.int32)
    cv[:, :Pl] = rt.corner_vert[:, lo:hi].cpu().numpy()
    es = rt.edge_sides.cpu().numpy().astype(np.int64)
    p = es // 8
    es = np.where((es >= 0) & (p >= lo) & (p < hi), es - 8 * lo, -1)
    vs = rt.vert_sides.cpu().numpy().astype(np.int64)
    p = vs // 4
    vs = np.where((vs >= 0) & (p >= lo) & (p < hi), vs - 4 * lo, -1)
    n_loc = E * E * Pl + E * n_edges + n_verts
    return {"wt": wt, "tables": (fc, cv, es.astype(np.int32),
                                 vs.astype(np.int32)),
            "meta": (H, Pl, Ppl, E, n_edges, n_verts, n_loc),
            "lo": lo, "hi": hi, "global_meta": tuple(op.meta[:7])}


def slab_operator(part: dict, device) -> PatchStencilOp:
    """The slab's own patch operator on ``device`` (kernel B2 on a card)."""
    wt = torch.as_tensor(part["wt"], device=device).contiguous()
    return PatchStencilOp(wt, PatchRouting.from_arrays(part["tables"],
                                                       device),
                          part["meta"])


def shard_patch_op(op: PatchStencilOp, group: RankGroup) -> PatchStencilOp:
    """This rank's slab operator of ``op`` (:func:`slab_bounds`), on the
    rank's device."""
    lo, hi = slab_bounds(op.meta[1], group.world_size)[group.rank]
    return slab_operator(patch_slab(op, lo, hi), group.device)


def make_sharded_patch_matvec(meta, group: RankGroup):
    """``mv(slab_op, x_int (E, E, P_loc), xe (E, n_edges), xv (n_verts,))
    -> (y_int (E, E, P_loc), y_e (E, n_edges), y_v (n_verts,))``: the
    slab's matvec (one B2 stencil launch and one combine launch on a
    card), the skeleton partial sums closed over the ranks."""
    H, P, Pp, E, n_edges, n_verts, n = meta[:7]

    def mv(slab_op, x_int, xe, xv):
        Pl = slab_op.meta[1]
        x = torch.cat([x_int.reshape(-1), xe.reshape(-1), xv])
        y = slab_op.matvec(x)
        n_int = E * E * Pl
        skel = group.sum(y[n_int:])
        return (y[:n_int].view(E, E, Pl),
                skel[:E * n_edges].view(E, n_edges), skel[E * n_edges:])

    return mv


def split_vector(meta, x: torch.Tensor):
    """Global dof vector -> (x_int (E, E, Pp) patch-padded, xe, xv)."""
    H, Pm, Pp, E, n_edges, n_verts, n = meta[:7]
    n_int = E * E * Pm
    xi = x.new_zeros((E, E, Pp))
    xi[:, :, :Pm] = x[:n_int].view(E, E, Pm)
    xe = x[n_int:n_int + E * n_edges].view(E, n_edges)
    xv = x[n_int + E * n_edges:n]
    return xi, xe, xv


def join_vector(meta, y_int, y_e, y_v) -> torch.Tensor:
    H, Pm, Pp, E, n_edges, n_verts, n = meta[:7]
    return torch.cat([y_int[:, :, :Pm].reshape(-1), y_e.reshape(-1), y_v])
