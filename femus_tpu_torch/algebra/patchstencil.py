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
set of int32 index tables sized by the COARSE mesh only
(:class:`PatchRouting`: per (patch, face) the edge and its flip, per
(patch, corner) the vertex, per edge and per vertex its sides).  The JAX
package routes with one-hot matrices (``G_face``, ``M_cs`` in, ``G_edge``,
``M_vs`` out) because its target has no gather; :class:`PatchTables` keeps
them on the host, equal to the JAX package's, and nothing uploads them.

The whole matvec — window assembly straight from ``x`` through the index
tables, the 25 shifted multiply-adds, interior rows written into ``y``,
line and corner partials combined onto their edges and vertices — is
kernel B2: ``csrc/patch_stencil.cu`` on a CUDA tensor
(:func:`spmv_patch_cuda`, one stencil launch and one combine launch per
matvec, scalar or block), the plain PyTorch version
:func:`_patch_matvec_plain` (index gathers, :func:`_patch_chunk_plain`,
index combine) on a CPU tensor.

Assembly targets this layout DIRECTLY: :func:`build_patch_slots` maps each
element-Jacobian entry to its (k, i, j, p) weight slot (assembly/engine.py
``set_patch_layout``); symmetric Dirichlet elimination is done in stencil
form (shifted masks built once per level, :func:`dirichlet_masks`).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

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
    # index routing (int32; -1 = no entry), what the card reads
    face_code: np.ndarray             # (4, Pp): 2*edge + flip of face f
    corner_vert: np.ndarray           # (4, Pp): vertex at corner c
    edge_sides: np.ndarray            # (n_edges, 2): 8*patch + 2*face + flip
    vert_sides: np.ndarray            # (n_verts, maxval): 4*patch + corner


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

    # the same routing as index tables, from the same plan fields
    face_code = np.full((4, Pp), -1, np.int32)
    face_code[:, :P] = (2 * plan.patch_edges
                        + plan.patch_edge_flip.astype(np.int64)).T
    corner_vert = np.full((4, Pp), -1, np.int32)
    corner_vert[:, :P] = plan.patch_verts.T
    es = plan.edge_sides
    edge_sides = np.where(es[:, :, 0] >= 0,
                          8 * es[:, :, 0] + 2 * es[:, :, 1] + es[:, :, 2],
                          -1).astype(np.int32)
    vs = plan.vert_sides_idx
    vert_sides = np.where(vs[:, :, 0] >= 0, 4 * vs[:, :, 0] + vs[:, :, 1],
                          -1).astype(np.int32)

    return PatchTables(H=H, P=P, Pp=Pp, E=E, n_edges=ne_, n_verts=nv_, n=n,
                       G_face=G_face, G_edge=G_edge, M_cs=M_cs, M_vs=M_vs,
                       owner=owner, face_code=face_code,
                       corner_vert=corner_vert, edge_sides=edge_sides,
                       vert_sides=vert_sides)


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


def routing_from_onehot(G_face, G_edge, M_cs, M_vs, meta):
    """(face_code, corner_vert, edge_sides, vert_sides) read back from the
    one-hot routing matrices of either package's patch operator (host
    numpy; sides in ascending order of their one-hot row or column)."""
    H, P, Pp, E, n_edges, n_verts = (int(v) for v in meta[:6])
    G_face, G_edge = np.asarray(G_face), np.asarray(G_edge)
    M_cs, M_vs = np.asarray(M_cs), np.asarray(M_vs)
    row = G_face.argmax(axis=0).reshape(4, P)          # flip*n_edges + e
    face_code = np.full((4, Pp), -1, np.int32)
    face_code[:, :P] = 2 * (row % n_edges) + row // n_edges
    corner_vert = np.full((4, Pp), -1, np.int32)
    corner_vert[:, :P] = M_cs.argmax(axis=1).reshape(4, P)
    edge_sides = np.full((n_edges, 2), -1, np.int32)
    src, e = np.nonzero(G_edge)                        # flip*4P + f*P + p
    rank = _rank_in_group(e, n_edges)
    fl, fp = src // (4 * P), src % (4 * P)
    edge_sides[e, rank] = 8 * (fp % P) + 2 * (fp // P) + fl
    v, cp = np.nonzero(M_vs)                           # c*P + p
    rank = _rank_in_group(v, n_verts)
    vert_sides = np.full((n_verts, int(rank.max()) + 1), -1, np.int32)
    vert_sides[v, rank] = 4 * (cp % P) + cp // P
    return face_code, corner_vert, edge_sides, vert_sides


def _rank_in_group(ids: np.ndarray, n_groups: int) -> np.ndarray:
    """Position of each entry among the entries of its id (stable)."""
    order = np.argsort(ids, kind="stable")
    start = np.concatenate([[0], np.cumsum(np.bincount(ids,
                                                       minlength=n_groups))])
    rank = np.empty(len(ids), np.int64)
    rank[order] = np.arange(len(ids)) - start[ids[order]]
    return rank


@dataclasses.dataclass
class PatchRouting:
    """Device-side index routing of one mesh level: the four int32 tables
    the kernel reads (see :class:`PatchTables`), and, derived from them on
    first use, the gather indices of the plain version."""

    face_code: torch.Tensor           # (4, Pp) int32
    corner_vert: torch.Tensor         # (4, Pp) int32
    edge_sides: torch.Tensor          # (n_edges, 2) int32
    vert_sides: torch.Tensor          # (n_verts, maxval) int32

    @classmethod
    def from_arrays(cls, arrays, device) -> "PatchRouting":
        return cls(*(torch.as_tensor(np.ascontiguousarray(a),
                                     dtype=torch.int32, device=device)
                     for a in arrays))

    def gather_indices(self, meta):
        """(line_src (E, 4, Pp), corner_src (4, Pp)) into ``cat([x, 0])``
        and (edge_src (2, E, n_edges), vert_src (maxval, n_verts)) into
        ``cat([yl.ravel(), 0])`` and ``cat([yc.ravel(), 0])``: int64, an
        absent entry points at the appended zero.  Cached."""
        if getattr(self, "_gather", None) is None:
            H, P, Pp, E, n_edges, n_verts, n = meta[:7]
            n_int = E * E * P
            r = torch.arange(E, device=self.face_code.device)[:, None, None]
            code = self.face_code.long()[None]                 # (1, 4, Pp)
            rr = torch.where(code % 2 == 1, E - 1 - r, r)
            line_src = torch.where(code >= 0,
                                   n_int + rr * n_edges + code // 2, n)
            cvert = self.corner_vert.long()
            corner_src = torch.where(cvert >= 0,
                                     n_int + E * n_edges + cvert, n)
            side = self.edge_sides.long().T[:, None, :]        # (2, 1, ne)
            rr = torch.where(side % 2 == 1, E - 1 - r.view(1, E, 1),
                             r.view(1, E, 1))
            edge_src = torch.where(
                side >= 0, (rr * 4 + (side // 2) % 4) * Pp + side // 8,
                E * 4 * Pp)
            vside = self.vert_sides.long().T                   # (maxval, nv)
            vert_src = torch.where(vside >= 0,
                                   (vside % 4) * Pp + vside // 4, 4 * Pp)
            self._gather = (line_src, corner_src, edge_src, vert_src)
        return self._gather


def patch_routing(tab: PatchTables, device) -> PatchRouting:
    """The index routing of ``tab`` on ``device`` (uploaded once per mesh
    level: a few int32 per coarse face, edge and vertex)."""
    return PatchRouting.from_arrays(
        (tab.face_code, tab.corner_vert, tab.edge_sides, tab.vert_sides),
        device)


# ---------------------------------------------------------------------------
# plain version: x -> per-patch inputs -> stencil -> per-patch partials -> y
# ---------------------------------------------------------------------------


def _patch_inputs(meta, routing: PatchRouting, x):
    """x -> (interior lattice (E, E, Pp), routed face lines (E, 4, Pp),
    routed corners (4, Pp)) by index gathers, zero beyond patch P.  With
    P == Pp the interior block is a view of x.  ``meta``: an operator's
    meta (a block operator's trailing nv is ignored)."""
    H, P, Pp, E, n_edges, n_verts, n = meta[:7]
    line_src, corner_src, _, _ = routing.gather_indices(meta)
    x_ext = torch.cat([x, x.new_zeros(1)])
    ln = x_ext[line_src]
    cn = x_ext[corner_src]
    xi = x[:E * E * P].view(E, E, P)
    if P == Pp:
        return xi, ln, cn
    xi_p = x.new_zeros((E, E, Pp))
    xi_p[:, :, :P] = xi
    return xi_p, ln, cn


def _patch_combine(meta, routing: PatchRouting, yi, yl, yc):
    """Per-patch partials -> global vector: interior rows as they are,
    face lines summed onto their coarse edges and corners onto vertices,
    each in the side order of the tables."""
    H, P, Pp, E, n_edges, n_verts, n = meta[:7]
    _, _, edge_src, vert_src = routing.gather_indices(meta)
    y_int = yi[:, :, :P].reshape(E * E * P)
    yl_ext = torch.cat([yl.reshape(-1), yl.new_zeros(1)])
    y_e = yl_ext[edge_src[0]] + yl_ext[edge_src[1]]      # (E, n_edges)
    yc_ext = torch.cat([yc.reshape(-1), yc.new_zeros(1)])
    y_v = yc_ext[vert_src[0]]
    for s in range(1, vert_src.shape[0]):
        y_v = y_v + yc_ext[vert_src[s]]
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
    """The stencil of one (K, H, H, Pp) weight slab in plain PyTorch, the
    function of the TPU kernel: per-patch inputs -> (yi (E, E, Pp),
    yl (E, 4, Pp), yc (4, Pp)).  Builds the window in memory, sums the 25
    shifted products in offset order and extracts the partials."""
    H = wt.shape[1]
    X = _window(xi, lines, cv)
    Y = None
    for k in range(K):
        a, b = divmod(k, 5)
        term = wt[k] * X[a:a + H, b:b + H]
        Y = term if Y is None else Y + term
    return _extract(Y)


def _patch_matvec_plain(op: "PatchStencilOp", x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the whole matvec of a scalar or block patch
    operator: index gathers into the per-patch inputs of every column
    variable, :func:`_patch_chunk_plain` per (row, column) variable pair
    summed over the column variable in ascending order, index combine."""
    nb, nv = op.meta[6], op.nv
    inputs = [_patch_inputs(op.meta, op.routing, x[vc * nb:(vc + 1) * nb])
              for vc in range(nv)]
    out = []
    for vr in range(nv):
        acc = None
        for vc in range(nv):
            parts = _patch_chunk_plain(op._pair(vr, vc), *inputs[vc])
            acc = parts if acc is None else tuple(
                a + b for a, b in zip(acc, parts))
        out.append(_patch_combine(op.meta, op.routing, *acc))
    return out[0] if nv == 1 else torch.cat(out)


_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
# which of the two launches a call makes: the stencil kernel, the combine
# kernel, or (a matvec) both
STENCIL, COMBINE, MATVEC = 1, 2, 3


def _checked_operator(op: "PatchStencilOp") -> tuple:
    """Hold ``op`` to what the kernel takes and return its launch
    arguments (pointers, sizes); checked once per operator object."""
    args = op.__dict__.get("_launch_args")
    if args is not None:
        return args
    H, P, Pp, E, n_edges, n_verts, nb = op.meta[:7]
    nv = op.nv
    wt, rt = op.wt, op.routing
    tables = (rt.face_code, rt.corner_vert, rt.edge_sides, rt.vert_sides)
    if not all(t.is_cuda and t.device == wt.device for t in (wt,) + tables):
        raise ValueError("spmv_patch_cuda: weights, x and routing tables "
                         "must share one CUDA device")
    if wt.dtype not in _DTYPE_CODE:
        raise TypeError(f"spmv_patch_cuda: weight dtype {wt.dtype} not "
                        "supported (float32 or float64)")
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError("spmv_patch_cuda: routing tables must be int32")
    maxval = int(rt.vert_sides.shape[1]) if rt.vert_sides.dim() == 2 else -1
    shapes = [(nv * nv * K, H, H, Pp), (4, Pp), (4, Pp), (n_edges, 2),
              (n_verts, maxval)]
    got = [tuple(t.shape) for t in (wt,) + tables]
    if (H < 3 or E != H - 2 or Pp % 128 or not 0 < P <= Pp
            or nb != E * E * P + E * n_edges + n_verts or got != shapes):
        raise ValueError(f"spmv_patch_cuda: shapes {got} do not fit the "
                         f"operator's meta {op.meta}")
    if not all(t.is_contiguous() for t in (wt,) + tables) \
            or wt.data_ptr() % 16:
        raise ValueError("spmv_patch_cuda: tensors must be contiguous, the "
                         "weights 16-byte aligned")
    args = (wt.data_ptr(), tuple(t.data_ptr() for t in tables),
            (_DTYPE_CODE[wt.dtype], H, P, Pp, n_edges, n_verts, maxval, nv))
    op.__dict__["_launch_args"] = args
    return args


def spmv_patch_cuda(op: "PatchStencilOp", x: torch.Tensor,
                    stages: int = MATVEC, scratch=None) -> torch.Tensor:
    """y = A x of a scalar or block patch operator through kernel B2
    (``csrc/patch_stencil.cu``) on the current stream: one stencil launch
    (grid over patch groups, lattice tiles and the row variable; the column
    variables looped inside) and one combine launch.  ``stages`` other
    than ``MATVEC`` launches one of the two alone (for timing; ``scratch``
    then carries the ``(yl, yc)`` partials between the calls).  Raises on
    anything the kernel does not take; there is no fallback."""
    wt_ptr, table_ptrs, sizes = _checked_operator(op)
    wt = op.wt
    if not (x.is_cuda and x.device == wt.device):
        raise ValueError("spmv_patch_cuda: weights, x and routing tables "
                         "must share one CUDA device")
    if x.dtype != wt.dtype:
        raise TypeError(f"spmv_patch_cuda: dtypes x {x.dtype}, weights "
                        f"{wt.dtype} differ")
    if x.shape != (op.n_rows,) or not x.is_contiguous():
        raise ValueError(f"spmv_patch_cuda: x {tuple(x.shape)} is not a "
                         f"contiguous vector of {op.n_rows} rows")
    fn = _patch_fn()
    if scratch is None:
        # the partials between the two launches: the operator's own,
        # reused by every matvec (launches of one stream run in order)
        scratch = op.__dict__.get("_scratch")
        if scratch is None:
            E, Pp, nv = op.meta[3], op.meta[2], op.nv
            scratch = op.__dict__["_scratch"] = (
                torch.empty((nv, E, 4, Pp), dtype=x.dtype, device=x.device),
                torch.empty((nv, 4, Pp), dtype=x.dtype, device=x.device))
    yl, yc = scratch
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(wt_ptr, x.data_ptr(), y.data_ptr(), yl.data_ptr(), yc.data_ptr(),
            *table_ptrs, *sizes, stages, stream)
    if rc != 0:
        raise RuntimeError(f"patch_stencil kernel launch failed: CUDA error "
                           f"{rc}")
    spmv_patch_cuda.launches += 1
    return y


spmv_patch_cuda.launches = 0


_fn = []


def _patch_fn():
    """The kernel's C entry point (the library is built at first use)."""
    if not _fn:
        fn = load_library("algebra/csrc/patch_stencil.cu").patch_matvec
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 9 + [ci] * 9 + [vp]
        fn.restype = ci
        _fn.append(fn)
    return _fn[0]


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PatchStencilOp:
    """Device operator: stencil weights + index skeleton routing (all on
    the weights' device)."""

    wt: torch.Tensor                  # (K, H, H, Pp)
    routing: PatchRouting
    meta: Tuple[int, ...]             # H, P, Pp, E, n_edges, n_verts, n

    nv = 1

    @property
    def n_rows(self) -> int:
        return self.meta[6]

    def _pair(self, vr: int, vc: int) -> torch.Tensor:
        """The (K, H, H, Pp) weights coupling row variable ``vr`` to column
        variable ``vc``."""
        q = vr * self.nv + vc
        return self.wt[q * K:(q + 1) * K]

    def _combine(self, yi, yl, yc):
        return _patch_combine(self.meta, self.routing, yi, yl, yc)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Kernel B2 for a CUDA tensor, the plain version for a CPU
        tensor."""
        if x.device.type == "cpu":
            return _patch_matvec_plain(self, x)
        return spmv_patch_cuda(self, x)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        return torch.cat([self._combine(*_extract(self._pair(v, v)[K0]))
                          for v in range(self.nv)])

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
    (H, P, Pp, E, n_edges, n_verts, n_per_var, nv).  The matvec is still
    one stencil launch and one combine launch.
    """

    @property
    def nv(self) -> int:
        return self.meta[7]

    @property
    def n_rows(self) -> int:
        return self.meta[6] * self.meta[7]


def patch_meta(tab: PatchTables) -> Tuple[int, ...]:
    """A scalar operator's ``meta``: (H, P, Pp, E, n_edges, n_verts, n)."""
    return (tab.H, tab.P, tab.Pp, tab.E, tab.n_edges, tab.n_verts, tab.n)


def make_patch_op(tab: PatchTables, wt: torch.Tensor,
                  routing: Optional[PatchRouting] = None) -> PatchStencilOp:
    """Scalar patch operator on ``wt``'s device; ``routing``: the
    :func:`patch_routing` tables, if already uploaded."""
    routing = routing or patch_routing(tab, wt.device)
    return PatchStencilOp(wt, routing, patch_meta(tab))


def make_block_patch_op(tab: PatchTables, wt: torch.Tensor, nv: int,
                        routing: Optional[PatchRouting] = None
                        ) -> BlockPatchStencilOp:
    routing = routing or patch_routing(tab, wt.device)
    return BlockPatchStencilOp(wt, routing, patch_meta(tab) + (nv,))


def dirichlet_masks(meta, routing: PatchRouting, dir_mask: torch.Tensor,
                    owner: torch.Tensor, nv: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric Dirichlet elimination in stencil form, as masks built once
    per mesh level (``meta``, ``routing``: an operator's):
    ``bad`` (nv*nv*K, H, H, Pp) marks every weight whose row OR col node
    is Dirichlet; ``ident`` holds the flat slots of the centre weight of
    the OWNER copy of each Dirichlet row, which become 1.0 (ELL
    equivalent: the engine's ``dir_bad`` / ``dir_ident``).  Apply with
    :func:`apply_dirichlet`."""
    H = meta[0]
    nb = meta[6]
    D = [_window(*_patch_inputs(meta, routing,
                                dir_mask[v * nb:(v + 1) * nb].to(
                                    torch.float32)))
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
        op.wt, *dirichlet_masks(op.meta, op.routing, dir_mask, owner, 1)))


def dirichlet_eliminate_block(op: BlockPatchStencilOp, dir_mask: torch.Tensor,
                              owner: torch.Tensor) -> BlockPatchStencilOp:
    """Blockwise symmetric elimination (see :func:`dirichlet_masks`)."""
    return dataclasses.replace(op, wt=apply_dirichlet(
        op.wt, *dirichlet_masks(op.meta, op.routing, dir_mask, owner,
                                op.nv)))
