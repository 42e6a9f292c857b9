"""Patch-lattice stencil operator: the SpMV of refined meshes without
per-nonzero column indices.

Companion of mesh/patches.py: on a patch-coherently renumbered refined mesh
the operator splits exactly as

    A = sum_p  S_p^T A_p S_p

with A_p the patch-local operator (contributions of the elements INSIDE
coarse element p — every fine element belongs to exactly one patch, so the
split is exact, with no halo: A_p only couples nodes of patch p's own
(H x H) lattice).  Each A_p is a variable-coefficient 25-point lattice
stencil (biquadratic Q2), stored batched as ``wt[k, i, j, p]``:

    (A x)|_(p,i,j) = sum_k  wt[k, i, j, p] * X[i + di_k, j + dj_k, p]

Skeleton rows (coarse-edge / coarse-vertex nodes) appear in several patches;
their glue (x routing into patch boundaries, partial-sum combination) is a
set of one-hot routing matrices sized by the COARSE mesh only
(``G_face``, ``M_cs`` in, ``G_edge``, ``M_vs`` out), applied with
``torch.matmul`` around the stencil.

The stencil itself — window assembly from the interior/line/corner inputs,
the 25 shifted multiply-adds and the extraction of the per-patch partials —
is kernel B2: ``csrc/patch_stencil.cu`` on a CUDA tensor
(:func:`spmv_patch_cuda`), the plain PyTorch version
:func:`_patch_chunk_plain` on a CPU tensor.

Assembly targets this layout DIRECTLY: :func:`build_patch_slots` maps each
element-Jacobian entry to its (k, i, j, p) weight slot (assembly/engine.py
``set_patch_layout``); symmetric Dirichlet elimination is done in stencil
form (shifted masks built once per level, :func:`dirichlet_masks`).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .._cuda_build import load_library
from ..mesh.patches import PatchPlan


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


OFFSETS = [(di, dj) for di in range(-2, 3) for dj in range(-2, 3)]
K = len(OFFSETS)                      # 25 (biquadratic halo 2)
K0 = OFFSETS.index((0, 0))            # the centre (diagonal) offset


@dataclasses.dataclass(frozen=True)
class PatchTables:
    """Host-side routing tables (built once per mesh/plan).

    The one-hot matrices are sized by the COARSE mesh (P patches, n_edges
    coarse edges, n_verts coarse vertices) — constant in refinement depth.
    """

    H: int
    P: int
    Pp: int                           # P padded to a multiple of 128
    E: int
    n_edges: int
    n_verts: int
    n: int                            # total dofs
    G_face: np.ndarray                # (2*n_edges, 4P): xef -> face lines
    G_edge: np.ndarray                # (8P, n_edges): face lines -> edge sums
    M_cs: np.ndarray                  # (4P, n_verts): xv -> patch corners
    M_vs: np.ndarray                  # (n_verts, 4P): corner sums -> y_v
    owner: np.ndarray                 # (H, H, Pp) bool: this patch copy owns
                                      # the row (used for Dirichlet identity)


def build_patch_tables(plan: PatchPlan, lanes: int = 128) -> PatchTables:
    P, H, E = plan.P, plan.H, plan.E
    ne_, nv_ = plan.n_edges, plan.n_verts
    Pp = _round_up(P, lanes)
    n = plan.n_int + E * ne_ + nv_

    # x routing: face line (f, p) reads edge e straight (col e) or flipped
    # (col n_edges + e) of the stacked (E, 2*n_edges) edge matrix
    G_face = np.zeros((2 * ne_, 4 * P), np.float32)
    for p in range(P):
        for f in range(4):
            e = plan.patch_edges[p, f]
            fl = int(plan.patch_edge_flip[p, f])
            G_face[fl * ne_ + e, f * P + p] = 1.0

    # y routing: edge e sums its (<=2) face lines; flipped sides read the
    # reversed copy, so source column = flip*4P + f*P + p of (E, 8P)
    G_edge = np.zeros((8 * P, ne_), np.float32)
    for e in range(ne_):
        for s in range(2):
            p, f, fl = plan.edge_sides[e, s]
            if p >= 0:
                G_edge[fl * 4 * P + f * P + p, e] = 1.0

    M_cs = np.zeros((4 * P, nv_), np.float32)
    M_vs = np.zeros((nv_, 4 * P), np.float32)
    for p in range(P):
        for c in range(4):
            v = plan.patch_verts[p, c]
            M_cs[c * P + p, v] = 1.0
            M_vs[v, c * P + p] = 1.0

    owner = np.zeros((H, H, Pp), bool)
    owner[1:H - 1, 1:H - 1, :P] = True
    for e in range(ne_):
        p, f, fl = plan.edge_sides[e, 0]
        ii, jj = _face_line_idx(H, int(f))
        owner[ii, jj, p] = True
    corner_lat = [(0, 0), (H - 1, 0), (H - 1, H - 1), (0, H - 1)]
    for v in range(nv_):
        p, c = plan.vert_sides_idx[v, 0]
        ci, cj = corner_lat[int(c)]
        owner[ci, cj, p] = True

    return PatchTables(H=H, P=P, Pp=Pp, E=E, n_edges=ne_, n_verts=nv_, n=n,
                       G_face=G_face, G_edge=G_edge, M_cs=M_cs, M_vs=M_vs,
                       owner=owner)


def _face_line_idx(H: int, f: int):
    """Lattice (i, j) index arrays of face f's interior line, face order.

    Faces: 0: j=0 row; 1: i=H-1 col; 2: j=H-1 row; 3: i=0 col."""
    r = np.arange(1, H - 1)
    if f == 0:
        return r, np.zeros_like(r)
    if f == 1:
        return np.full_like(r, H - 1), r
    if f == 2:
        return r, np.full_like(r, H - 1)
    return np.zeros_like(r), r


def build_patch_slots(plan: PatchPlan, tab: PatchTables,
                      nv: int = 1) -> Tuple[np.ndarray, int]:
    """(ne, nv*n_bq, nv*n_bq) flat weight-slot index per element-Jacobian
    entry for a stacked system of ``nv`` biquadratic unknowns.

    Weight layout: flat = ((((vr*nv + vc)*K + k)*H + i)*H + j)*Pp + p for
    row lattice (i, j) of patch p, variable blocks (vr, vc), offset
    k = (di+2)*5 + (dj+2) with (di, dj) = col - row."""
    H, Pp = tab.H, tab.Pp
    lat = plan.elem_node_lat                        # (ne, n_bq, 2)
    ne, n_bq = lat.shape[:2]
    p = plan.elem_patch[:, None, None]
    ia, ja = lat[:, :, None, 0], lat[:, :, None, 1]
    ib, jb = lat[:, None, :, 0], lat[:, None, :, 1]
    k = (ib - ia + 2) * 5 + (jb - ja + 2)
    base = ((k * H + ia) * H + ja) * Pp + p         # (ne, n_bq, n_bq)
    if nv == 1:
        return base.astype(np.int64), K * H * H * Pp
    blk = K * H * H * Pp
    out = np.empty((ne, nv * n_bq, nv * n_bq), np.int64)
    for vr in range(nv):
        for vc in range(nv):
            out[:, vr * n_bq:(vr + 1) * n_bq, vc * n_bq:(vc + 1) * n_bq] = \
                base + (vr * nv + vc) * blk
    return out, nv * nv * blk


def patch_routing(tab: PatchTables, device, dtype) -> Tuple[torch.Tensor, ...]:
    """(G_face, G_edge, M_cs, M_vs) on ``device`` in the solve precision
    (uploaded once per mesh level; a one-hot product is exact in it)."""
    return tuple(torch.as_tensor(m, dtype=dtype, device=device)
                 for m in (tab.G_face, tab.G_edge, tab.M_cs, tab.M_vs))


# ---------------------------------------------------------------------------
# x -> per-patch inputs -> kernel B2 -> per-patch partials -> y
# ---------------------------------------------------------------------------


def _patch_inputs(meta, G_face, M_cs, x):
    """x -> (interior lattice (E, E, Pp), routed face lines (E, 4, Pp),
    routed corners (4, Pp)), zero beyond patch P.  With P == Pp the
    interior block is a view of x.  ``meta``: an operator's meta (a block
    operator's trailing nv is ignored)."""
    H, P, Pp, E, n_edges, n_verts, n = meta[:7]
    n_int = E * E * P
    xe = x[n_int:n_int + E * n_edges].view(E, n_edges)
    xef = torch.cat([xe, xe.flip(0)], dim=1)             # straight|flipped
    ln = (xef @ G_face).view(E, 4, P)
    cn = (M_cs @ x[n_int + E * n_edges:]).view(4, P)
    xi = x[:n_int].view(E, E, P)
    if P == Pp:
        return xi, ln, cn
    xi_p = x.new_zeros((E, E, Pp))
    xi_p[:, :, :P] = xi
    ln_p = x.new_zeros((E, 4, Pp))
    ln_p[:, :, :P] = ln
    cn_p = x.new_zeros((4, Pp))
    cn_p[:, :P] = cn
    return xi_p, ln_p, cn_p


def _patch_combine(meta, G_edge, M_vs, yi, yl, yc):
    """Per-patch partials -> global vector: interior rows as they are,
    face lines summed onto their coarse edges, corners onto vertices."""
    H, P, Pp, E, n_edges, n_verts, n = meta[:7]
    y_int = yi[:, :, :P].reshape(E * E * P)
    lf = yl[:, :, :P].reshape(E, 4 * P)
    lfl = torch.cat([lf, lf.flip(0)], dim=1)             # (E, 8P)
    y_e = lfl @ G_edge                                   # (E, n_edges)
    y_v = M_vs @ yc[:, :P].reshape(-1)                   # (n_verts,)
    return torch.cat([y_int, y_e.reshape(-1), y_v])


def _window(xi, lines, cv):
    """The (H+4, H+4, Pp) lattice window of every patch: interior, face
    lines and corners in place, a zero ring of 2 for the shifts."""
    E = xi.shape[0]
    H = E + 2
    X = xi.new_zeros((H + 4, H + 4, xi.shape[-1]))
    X[3:1 + H, 3:1 + H] = xi
    X[3:1 + H, 2] = lines[:, 0]
    X[H + 1, 3:1 + H] = lines[:, 1]
    X[3:1 + H, H + 1] = lines[:, 2]
    X[2, 3:1 + H] = lines[:, 3]
    X[2, 2] = cv[0]
    X[H + 1, 2] = cv[1]
    X[H + 1, H + 1] = cv[2]
    X[2, H + 1] = cv[3]
    return X


def _extract(Y):
    """(H, H, Pp) lattice -> (interior, face lines, corners) partials, the
    inverse of the placement in :func:`_window`."""
    H = Y.shape[0]
    yi = Y[1:H - 1, 1:H - 1]
    yl = torch.stack([Y[1:H - 1, 0], Y[H - 1, 1:H - 1],
                      Y[1:H - 1, H - 1], Y[0, 1:H - 1]], dim=1)
    yc = torch.stack([Y[0, 0], Y[H - 1, 0], Y[H - 1, H - 1], Y[0, H - 1]])
    return yi, yl, yc


def _patch_chunk_plain(wt, xi, lines, cv):
    """Plain PyTorch version of kernel B2: (K, H, H, Pp) weights and the
    per-patch inputs -> (yi (E, E, Pp), yl (E, 4, Pp), yc (4, Pp)).  Builds
    the window in memory, sums the 25 shifted products in offset order and
    extracts the partials."""
    H = wt.shape[1]
    X = _window(xi, lines, cv)
    Y = None
    for k in range(K):
        a, b = divmod(k, 5)
        term = wt[k] * X[a:a + H, b:b + H]
        Y = term if Y is None else Y + term
    return _extract(Y)


_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def spmv_patch_cuda(wt, xi, lines, cv, out=None):
    """Kernel B2 (``csrc/patch_stencil.cu``) on the current stream:
    ``(yi, yl, yc)`` of one (K, H, H, Pp) weight slab.  With ``out`` (a
    ``(yi, yl, yc)`` triple) the kernel adds into it (a block operator
    sums its column-variable pairs this way).  Raises on anything the
    kernel does not take; there is no fallback."""
    tensors = (wt, xi, lines, cv) + (tuple(out) if out is not None else ())
    dev = xi.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("spmv_patch_cuda: all tensors must share one CUDA "
                         "device")
    if xi.dtype not in _DTYPE_CODE or any(t.dtype != xi.dtype
                                          for t in tensors):
        raise TypeError(f"spmv_patch_cuda: dtype {xi.dtype} not supported "
                        "(float32 or float64, one for all tensors)")
    _, H, _, Pp = wt.shape
    E = H - 2
    shapes = [(K, H, H, Pp), (E, E, Pp), (E, 4, Pp), (4, Pp)]
    if out is not None:
        shapes += shapes[1:]
    if H < 3 or [tuple(t.shape) for t in tensors] != shapes:
        raise ValueError("spmv_patch_cuda: shapes "
                         f"{[tuple(t.shape) for t in tensors]} do not fit "
                         f"the weight slab {tuple(wt.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spmv_patch_cuda: tensors must be contiguous")
    if out is None:
        out = (torch.empty_like(xi), torch.empty_like(lines),
               torch.empty_like(cv))
        accumulate = 0
    else:
        accumulate = 1
    yi, yl, yc = out
    lib = _patch_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.patch_stencil(wt.data_ptr(), xi.data_ptr(), lines.data_ptr(),
                           cv.data_ptr(), yi.data_ptr(), yl.data_ptr(),
                           yc.data_ptr(), _DTYPE_CODE[xi.dtype], H, Pp,
                           accumulate, stream)
    if rc != 0:
        raise RuntimeError(f"patch_stencil kernel launch failed: CUDA error "
                           f"{rc}")
    spmv_patch_cuda.launches += 1
    return out


spmv_patch_cuda.launches = 0


def _patch_lib():
    lib = load_library("algebra/csrc/patch_stencil.cu")
    fn = lib.patch_stencil
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def _patch_chunk(wt, xi, lines, cv, out=None):
    """Kernel B2 for a CUDA tensor, its plain version for a CPU tensor;
    with ``out`` the partials are added into it."""
    if xi.device.type == "cpu":
        parts = _patch_chunk_plain(wt, xi, lines, cv)
        if out is None:
            return parts
        return tuple(o + q for o, q in zip(out, parts))
    return spmv_patch_cuda(wt, xi, lines, cv, out=out)


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PatchStencilOp:
    """Device operator: stencil weights + one-hot skeleton routing (all on
    the weights' device, in their dtype)."""

    wt: torch.Tensor                  # (K, H, H, Pp)
    G_face: torch.Tensor
    G_edge: torch.Tensor
    M_cs: torch.Tensor
    M_vs: torch.Tensor
    meta: Tuple[int, ...]             # H, P, Pp, E, n_edges, n_verts, n

    @property
    def n_rows(self) -> int:
        return self.meta[6]

    def _inputs(self, x):
        return _patch_inputs(self.meta, self.G_face, self.M_cs, x)

    def _combine(self, yi, yl, yc):
        return _patch_combine(self.meta, self.G_edge, self.M_vs, yi, yl, yc)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._combine(*_patch_chunk(self.wt, *self._inputs(x)))

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        return self._combine(*_extract(self.wt[K0]))

    def to_dense(self) -> torch.Tensor:
        """Dense matrix, one matvec per column (small operators only)."""
        eye = torch.eye(self.n_rows, dtype=self.wt.dtype,
                        device=self.wt.device)
        return torch.stack([self.matvec(e) for e in eye], dim=1)


@dataclasses.dataclass
class BlockPatchStencilOp(PatchStencilOp):
    """Stacked system of nv biquadratic unknowns: per-block patch stencils.

    wt[(vr*nv + vc)*K + k] couples row variable vr to column variable vc —
    a (nv x nv)-block operator whose every block is a 25-point patch
    stencil; the skeleton routing is shared across variables (same node
    lattice for every biquadratic unknown).  ``meta`` adds nv:
    (H, P, Pp, E, n_edges, n_verts, n_per_var, nv).
    """

    @property
    def nv(self) -> int:
        return self.meta[7]

    @property
    def n_rows(self) -> int:
        return self.meta[6] * self.meta[7]

    def _pair(self, vr: int, vc: int) -> torch.Tensor:
        q = vr * self.nv + vc
        return self.wt[q * K:(q + 1) * K]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """One launch of B2 per (row var, col var) pair; the partials of a
        row variable accumulate in place before one skeleton combine."""
        nb, nv = self.meta[6], self.nv
        inputs = [self._inputs(x[vc * nb:(vc + 1) * nb]) for vc in range(nv)]
        out = []
        for vr in range(nv):
            acc = None
            for vc in range(nv):
                acc = _patch_chunk(self._pair(vr, vc), *inputs[vc], out=acc)
            out.append(self._combine(*acc))
        return torch.cat(out)

    def diagonal(self) -> torch.Tensor:
        return torch.cat([self._combine(*_extract(self._pair(v, v)[K0]))
                          for v in range(self.nv)])


def patch_meta(tab: PatchTables) -> Tuple[int, ...]:
    """A scalar operator's ``meta``: (H, P, Pp, E, n_edges, n_verts, n)."""
    return (tab.H, tab.P, tab.Pp, tab.E, tab.n_edges, tab.n_verts, tab.n)


def make_patch_op(tab: PatchTables, wt: torch.Tensor,
                  routing: Optional[Sequence[torch.Tensor]] = None
                  ) -> PatchStencilOp:
    """Scalar patch operator on ``wt``'s device; ``routing``: the
    :func:`patch_routing` tensors, if already uploaded."""
    routing = routing or patch_routing(tab, wt.device, wt.dtype)
    return PatchStencilOp(wt, *routing, patch_meta(tab))


def make_block_patch_op(tab: PatchTables, wt: torch.Tensor, nv: int,
                        routing: Optional[Sequence[torch.Tensor]] = None
                        ) -> BlockPatchStencilOp:
    routing = routing or patch_routing(tab, wt.device, wt.dtype)
    return BlockPatchStencilOp(wt, *routing, patch_meta(tab) + (nv,))


def dirichlet_masks(meta, G_face: torch.Tensor, M_cs: torch.Tensor,
                    dir_mask: torch.Tensor, owner: torch.Tensor, nv: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric Dirichlet elimination in stencil form, as masks built once
    per mesh level (``meta``, ``G_face``, ``M_cs``: an operator's):
    ``bad`` (nv*nv*K, H, H, Pp) marks every weight whose row OR col node
    is Dirichlet; ``ident`` holds the flat slots of the centre weight of
    the OWNER copy of each Dirichlet row, which become 1.0 (ELL
    equivalent: the engine's ``dir_bad`` / ``dir_ident``).  Apply with
    :func:`apply_dirichlet`."""
    H = meta[0]
    nb = meta[6]
    D = [_window(*_patch_inputs(meta, G_face, M_cs,
                                dir_mask[v * nb:(v + 1) * nb].to(M_cs.dtype)))
         for v in range(nv)]
    core = [d[2:2 + H, 2:2 + H] > 0.5 for d in D]
    bad = torch.stack([core[vr] | (D[vc][2 + di:2 + di + H,
                                         2 + dj:2 + dj + H] > 0.5)
                       for vr in range(nv) for vc in range(nv)
                       for di, dj in OFFSETS])
    ident = torch.zeros_like(bad)
    for v in range(nv):
        ident[(v * nv + v) * K + K0] = core[v] & owner
    return bad, ident.view(-1).nonzero().view(-1)


def apply_dirichlet(wt: torch.Tensor, bad: torch.Tensor,
                    ident: torch.Tensor) -> torch.Tensor:
    """Weights with the :func:`dirichlet_masks` elimination applied."""
    w = torch.where(bad, 0.0, wt)
    w.view(-1).index_fill_(0, ident, 1.0)
    return w


def dirichlet_eliminate(op: PatchStencilOp, dir_mask: torch.Tensor,
                        owner: torch.Tensor) -> PatchStencilOp:
    """Symmetric elimination in stencil form (see :func:`dirichlet_masks`)."""
    return dataclasses.replace(op, wt=apply_dirichlet(
        op.wt, *dirichlet_masks(op.meta, op.G_face, op.M_cs, dir_mask, owner,
                                1)))


def dirichlet_eliminate_block(op: BlockPatchStencilOp, dir_mask: torch.Tensor,
                              owner: torch.Tensor) -> BlockPatchStencilOp:
    """Blockwise symmetric elimination (see :func:`dirichlet_masks`)."""
    return dataclasses.replace(op, wt=apply_dirichlet(
        op.wt, *dirichlet_masks(op.meta, op.G_face, op.M_cs, dir_mask, owner,
                                op.nv)))
