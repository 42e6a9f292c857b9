"""3-D (hex) patch-lattice stencil operator — the volumetric companion of
algebra/patchstencil.py (see that module and mesh/patches3d.py).

    (A x)|_(p,i,j,k) = sum_o wt[o, i, j, k, p] * X[i+di, j+dj, k+dk, p]

125 shifted multiply-adds (biquadratic halo 2) over batched (H x H x H)
patch lattices, patch axis last.  The skeleton glue (coarse faces with D4
orientation transforms, coarse edges of any valence, coarse vertices) is
routed by index tables, as the 2-D operator's card path is: the JAX
package, whose target has no gather, routes with one-hot matmuls sized by
the coarse mesh.  :class:`PatchTables3D` keeps those one-hot matrices on
the host, equal to the JAX package's, and adds what the port reads:

- ``lat_dof (H, H, H, Pp)``: the global dof at every lattice point of every
  patch (``n``, a zero, beyond patch P), so the window of all patches is
  one gather of x;
- ``copies (max_copies, n_skel)``: for every skeleton dof, the flat
  positions in an (H, H, H, Pp) lattice of its copies, in ascending patch
  order (the plan's side order), so the skeleton rows of y are sums of
  gathered partials in a fixed order.

Plain torch (the JAX package has no Pallas kernel for it).  Assembly
targets the layout directly (:func:`build_patch_slots_3d`, read by
``assembly/engine.py`` ``set_patch_layout``); symmetric Dirichlet
elimination is done in stencil form with masks built once per level
(:func:`dirichlet_masks_3d`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..mesh.patches3d import (C8, E12, F6, PatchPlan3D, d4_apply,
                              d4_inverse)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


OFFSETS3 = [(a, b, c) for a in range(-2, 3) for b in range(-2, 3)
            for c in range(-2, 3)]
K3 = len(OFFSETS3)                    # 125
K3_0 = OFFSETS3.index((0, 0, 0))      # the centre (diagonal) offset


# local-edge placement geometry: (axis along edge, start corner, direction)
def _edge_geom(li: int, M: int):
    a, b = E12[li]
    A, B = C8[a] * M, C8[b] * M
    d = B - A
    ax = int(np.argmax(np.abs(d)))
    return ax, A, int(np.sign(d[ax]))


def _face_geom(f: int, M: int):
    q = F6[f]
    O = C8[q[0]] * M
    U = C8[q[1]] - C8[q[0]]
    V = C8[q[3]] - C8[q[0]]
    Wn = np.cross(U, V)
    ax = int(np.argmax(np.abs(Wn)))
    return O, U, V, ax


@dataclasses.dataclass(frozen=True)
class PatchTables3D:
    """Host tables of one level.  The fields up to ``owner`` equal
    ``femus_tpu.algebra.patchstencil3d.PatchTables3D``'s; ``lat_dof`` and
    ``copies`` are the index routing the port's operator reads."""

    H: int
    P: int
    Pp: int
    E: int
    n_faces: int
    n_edges: int
    n_verts: int
    n: int
    G_face_in: np.ndarray            # (8*n_faces, 6P)
    G_face_out: np.ndarray           # (8*6P, n_faces)
    G_edge_in: np.ndarray            # (2*n_edges, 12P)
    G_edge_out: np.ndarray           # (2*12P, n_edges)
    M_cs: np.ndarray                 # (8P, n_verts)
    M_vs: np.ndarray                 # (n_verts, 8P)
    owner: np.ndarray                # (H, H, H, Pp) bool
    lat_dof: np.ndarray              # (H, H, H, Pp) int64, n beyond P
    copies: np.ndarray               # (max_copies, n - n_int) int64 flat
                                     #   lattice positions, H^3 Pp = none


def _lattice_dofs(plan: PatchPlan3D, Pp: int) -> np.ndarray:
    """The renumbered node at every lattice point of every patch (the
    numbering of ``mesh.patches3d.refine_patched_hex``, vectorised over
    patches; ``node_of_3d`` point by point)."""
    P, H, E, M = plan.P, plan.H, plan.E, plan.H - 1
    nf, ne_ = plan.n_faces, plan.n_edges
    n_int = plan.n_int
    n = n_int + E * E * nf + E * ne_ + plan.n_verts
    lat = np.full((H, H, H, Pp), n, np.int64)
    p = np.arange(P)
    r = np.arange(1, M)
    ii, jj, kk = np.meshgrid(r, r, r, indexing="ij")
    lat[1:M, 1:M, 1:M, :P] = ((((ii - 1) * E + (jj - 1)) * E + (kk - 1))
                              [..., None] * P + p)
    uu, vv = np.meshgrid(r, r, indexing="ij")
    for f in range(6):
        O, U, V, _ = _face_geom(f, M)
        pos = O[None, None, :] + uu[..., None] * U + vv[..., None] * V
        tf = plan.patch_face_tf[:, f]
        ids = np.empty((M - 1, M - 1, P), np.int64)
        for t in range(8):
            sel = tf == t
            if sel.any():
                cu, cv = d4_apply(t, uu, vv, M)
                ids[:, :, sel] = (n_int + (((cu - 1) * E + (cv - 1))
                                           * nf)[..., None]
                                  + plan.patch_faces[sel, f])
        lat[pos[..., 0], pos[..., 1], pos[..., 2], :P] = ids
    base_e = n_int + E * E * nf
    for le in range(12):
        ax, A, sg = _edge_geom(le, M)
        pos = np.broadcast_to(A, (M - 1, 3)).copy()
        pos[:, ax] = A[ax] + sg * r if sg > 0 else A[ax] - r
        tt = r[:, None]                                   # from corner a
        fl = plan.patch_edge_flip[:, le]
        tloc = np.where(fl[None, :], M - tt, tt)
        lat[pos[:, 0], pos[:, 1], pos[:, 2], :P] = (
            base_e + (tloc - 1) * ne_ + plan.patch_edges[:, le])
    base_v = base_e + E * ne_
    for c in range(8):
        cc = C8[c] * M
        lat[cc[0], cc[1], cc[2], :P] = base_v + plan.patch_verts[:, c]
    return lat


def build_patch_tables_3d(plan: PatchPlan3D,
                          lanes: int = 128) -> PatchTables3D:
    P, H, E, M = plan.P, plan.H, plan.E, plan.H - 1
    nf, ne_, nv_ = plan.n_faces, plan.n_edges, plan.n_verts
    Pp = _round_up(P, lanes)
    n = plan.n_int + E * E * nf + E * ne_ + nv_

    G_face_in = np.zeros((8 * nf, 6 * P), np.float32)
    G_face_out = np.zeros((8 * 6 * P, nf), np.float32)
    for p in range(P):
        for f in range(6):
            fid = plan.patch_faces[p, f]
            t = int(plan.patch_face_tf[p, f])
            G_face_in[t * nf + fid, f * P + p] = 1.0
            s = d4_inverse(t)
            G_face_out[(s * 6 + f) * P + p, fid] = 1.0

    G_edge_in = np.zeros((2 * ne_, 12 * P), np.float32)
    G_edge_out = np.zeros((2 * 12 * P, ne_), np.float32)
    for p in range(P):
        for le in range(12):
            e = plan.patch_edges[p, le]
            fl = int(plan.patch_edge_flip[p, le])
            G_edge_in[fl * ne_ + e, le * P + p] = 1.0
            G_edge_out[(fl * 12 + le) * P + p, e] = 1.0

    M_cs = np.zeros((8 * P, nv_), np.float32)
    M_vs = np.zeros((nv_, 8 * P), np.float32)
    for p in range(P):
        for c in range(8):
            v = plan.patch_verts[p, c]
            M_cs[c * P + p, v] = 1.0
            M_vs[v, c * P + p] = 1.0

    owner = np.zeros((H, H, H, Pp), bool)
    owner[1:M, 1:M, 1:M, :P] = True
    for fid in range(nf):
        p, f, t = plan.face_sides[fid, 0]
        O, U, V, ax = _face_geom(int(f), M)
        uu, vv = np.meshgrid(np.arange(1, M), np.arange(1, M), indexing="ij")
        pos = O[None, None, :] + uu[..., None] * U + vv[..., None] * V
        owner[pos[..., 0], pos[..., 1], pos[..., 2], p] = True
    for eid in range(ne_):
        p, le, fl = plan.edge_sides[eid, 0]
        ax, A, sg = _edge_geom(int(le), M)
        ts = np.arange(1, M)
        pos = np.broadcast_to(A, (M - 1, 3)).copy()
        pos[:, ax] = A[ax] + sg * ts if sg > 0 else A[ax] - ts
        owner[pos[:, 0], pos[:, 1], pos[:, 2], p] = True
    for vid in range(nv_):
        p, c = plan.vert_sides[vid, 0]
        cc = C8[c] * M
        owner[cc[0], cc[1], cc[2], p] = True

    # index routing: the lattice dofs and the skeleton dofs' copies
    lat = _lattice_dofs(plan, Pp)
    flat = lat.reshape(-1)
    pos = np.flatnonzero((flat >= plan.n_int) & (flat < n))
    dof = flat[pos] - plan.n_int
    order = np.lexsort((pos % Pp, dof))          # by dof, then patch
    pos, dof = pos[order], dof[order]
    n_skel = n - plan.n_int
    start = np.concatenate([[0], np.cumsum(np.bincount(dof,
                                                       minlength=n_skel))])
    rank = np.arange(len(dof)) - start[dof]
    copies = np.full((int(rank.max()) + 1 if len(rank) else 1, n_skel),
                     H ** 3 * Pp, np.int64)
    copies[rank, dof] = pos

    return PatchTables3D(H=H, P=P, Pp=Pp, E=E, n_faces=nf, n_edges=ne_,
                         n_verts=nv_, n=n, G_face_in=G_face_in,
                         G_face_out=G_face_out, G_edge_in=G_edge_in,
                         G_edge_out=G_edge_out, M_cs=M_cs, M_vs=M_vs,
                         owner=owner, lat_dof=lat, copies=copies)


def build_patch_slots_3d(plan: PatchPlan3D,
                         tab: PatchTables3D) -> Tuple[np.ndarray, int]:
    """(ne, 27, 27) flat weight slot of every element-Jacobian entry:
    ((((k*H + i)*H + j)*H + l)*Pp + p for the row's lattice (i, j, l) in
    patch p and offset k = col - row."""
    H, Pp = tab.H, tab.Pp
    lat = plan.elem_node_lat                       # (ne, 27, 3)
    p = plan.elem_patch[:, None, None]
    ra = lat[:, :, None, :]
    rb = lat[:, None, :, :]
    d = rb - ra + 2                                 # (ne, 27, 27, 3)
    k = (d[..., 0] * 5 + d[..., 1]) * 5 + d[..., 2]
    ia, ja, ka = ra[..., 0], ra[..., 1], ra[..., 2]
    slots = (((k * H + ia) * H + ja) * H + ka) * Pp + p
    return slots.astype(np.int64), K3 * H * H * H * Pp


@dataclasses.dataclass
class PatchRouting3D:
    """Device-side index routing of one level (int64)."""

    lat_dof: torch.Tensor            # (H, H, H, Pp)
    copies: torch.Tensor             # (max_copies, n_skel)


def patch_routing_3d(tab: PatchTables3D, device) -> PatchRouting3D:
    i64 = dict(dtype=torch.int64, device=device)
    return PatchRouting3D(torch.as_tensor(tab.lat_dof, **i64),
                          torch.as_tensor(tab.copies, **i64))


def _window(routing: PatchRouting3D, x: torch.Tensor) -> torch.Tensor:
    """The (H+4)^3 x Pp lattice window of every patch: one gather of x
    (zeros beyond patch P) inside a zero ring of 2 for the shifts."""
    H = routing.lat_dof.shape[0]
    X = x.new_zeros((H + 4, H + 4, H + 4, routing.lat_dof.shape[3]))
    X[2:2 + H, 2:2 + H, 2:2 + H] = torch.cat([x, x.new_zeros(1)])[
        routing.lat_dof]
    return X


@dataclasses.dataclass
class PatchStencilOp3D:
    wt: torch.Tensor                  # (K3, H, H, H, Pp)
    routing: PatchRouting3D
    meta: Tuple[int, ...]             # H,P,Pp,E,n_faces,n_edges,n_verts,n

    @property
    def n_rows(self) -> int:
        return self.meta[7]

    def _collect(self, Y: torch.Tensor) -> torch.Tensor:
        """Per-patch lattice values (H, H, H, Pp) -> global vector:
        interior rows as they are, every skeleton row the sum of its
        copies in ascending patch order."""
        H, P, Pp, E = self.meta[:4]
        M = H - 1
        y_int = Y[1:M, 1:M, 1:M, :P].reshape(-1)
        ext = torch.cat([Y.reshape(-1), Y.new_zeros(1)])
        cp = self.routing.copies
        y_s = ext[cp[0]]
        for s in range(1, cp.shape[0]):
            y_s = y_s + ext[cp[s]]
        return torch.cat([y_int, y_s])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        H = self.meta[0]
        X = _window(self.routing, x)
        Y = None
        for k, (di, dj, dk) in enumerate(OFFSETS3):
            term = self.wt[k] * X[2 + di:2 + di + H, 2 + dj:2 + dj + H,
                                  2 + dk:2 + dk + H]
            Y = term if Y is None else Y + term
        return self._collect(Y)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        return self._collect(self.wt[K3_0])

    def to_dense(self) -> torch.Tensor:
        """Dense matrix, one matvec per column (small operators only)."""
        eye = torch.eye(self.n_rows, dtype=self.wt.dtype,
                        device=self.wt.device)
        return torch.stack([self.matvec(e) for e in eye], dim=1)


def patch_meta_3d(tab: PatchTables3D) -> Tuple[int, ...]:
    return (tab.H, tab.P, tab.Pp, tab.E, tab.n_faces, tab.n_edges,
            tab.n_verts, tab.n)


def dirichlet_masks_3d(routing: PatchRouting3D, dir_mask: torch.Tensor,
                       owner: torch.Tensor):
    """Symmetric Dirichlet elimination in stencil form, built once per
    level: ``bad`` (K3, H, H, H, Pp) marks every weight whose row or
    column node is Dirichlet; ``ident`` the flat slots of the centre
    weight of the OWNER copy of each Dirichlet row, which become 1.0.
    Apply with ``algebra.patchstencil.apply_dirichlet``."""
    H = routing.lat_dof.shape[0]
    D = _window(routing, dir_mask.to(torch.float32)) > 0.5
    core = D[2:2 + H, 2:2 + H, 2:2 + H]
    bad = torch.stack([core | D[2 + a:2 + a + H, 2 + b:2 + b + H,
                                2 + c:2 + c + H]
                       for a, b, c in OFFSETS3])
    ident = torch.zeros_like(bad)
    ident[K3_0] = core & owner
    return bad, ident.view(-1).nonzero().view(-1)


def dirichlet_eliminate_3d(op: PatchStencilOp3D, dir_mask: torch.Tensor,
                           owner: torch.Tensor) -> PatchStencilOp3D:
    """Symmetric elimination in stencil form (see
    :func:`dirichlet_masks_3d`)."""
    from .patchstencil import apply_dirichlet
    return dataclasses.replace(op, wt=apply_dirichlet(
        op.wt, *dirichlet_masks_3d(op.routing, dir_mask, owner)))


def make_patch_op_3d(tab: PatchTables3D, wt: torch.Tensor,
                     routing: PatchRouting3D = None) -> PatchStencilOp3D:
    """The 3-D patch operator on ``wt``'s device; ``routing``: the
    :func:`patch_routing_3d` tables, if already uploaded."""
    routing = routing or patch_routing_3d(tab, wt.device)
    return PatchStencilOp3D(wt, routing, patch_meta_3d(tab))
