"""Nonlocal (integral / peridynamic-type) diffusion.

Reference workload: ``applications/NonLocal`` (~12k LoC; 1-D/2-D nonlocal
diffusion with finite horizon delta, assembled by double element loops).

Operator:  L u(x) = int_{|x'-x|<delta} gamma(x, x') (u(x') - u(x)) dx'
Weak form: a(u, v) = 1/2 intint gamma 1_{|x-y|<delta}
                     (u(y)-u(x)) (v(y)-v(x)) dy dx

With gamma = c_d / delta^(dim+2) (c_1 = 3, c_2 = 8/pi ... the standard
normalization) the operator converges to the Laplacian as delta -> 0.

Design: the double element loop becomes ONE batched kernel over
precomputed interacting element PAIRS (centroid distance < delta + 2 h,
found on the host): for each pair, a (nq, nq) double-quadrature
contraction of the ball-indicator kernel (``torch.func.vmap`` over the
pairs); the per-pair dense blocks are added into the ELL values through
four precomputed slot maps (int32 on the device), the static-sparsity
pattern the rest of the framework uses.  The Dirichlet solve multiplies on
the sliced-ELL operator of the BELL frame (kernel B1) from
``BELL_MIN_ROWS`` rows.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..algebra.bell import on_bell_frame
from ..algebra.krylov import jacobi_cg
from ..algebra.sparse import SparseOp, op_from_pattern, pattern_from_pairs
from ..fe.basis import get_basis
from ..fe.geom import GEOMS
from ..fe.quadrature import gauss
from ..mesh.mesh import Mesh
from .engine import _build_slot_lut
from .norms import _setup, _wdet

_C_NORM = {1: 3.0, 2: 8.0 / np.pi}


class NonlocalOperator:
    """Assembled nonlocal diffusion operator for one FE family, on
    ``device`` in ``dtype`` (float64 on the host, float32 on the card by
    default)."""

    def __init__(self, mesh: Mesh, family: str = "linear",
                 delta: float = 0.1, gamma: Optional[Callable] = None,
                 quad_order: int = 4, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.mesh = mesh
        self.family = family
        self.delta = delta
        g = GEOMS[mesh.geom]
        b = get_basis(mesh.geom, family)
        dm = mesh.dofmap(family)
        self.dofmap = dm
        fam_local = g.family_nodes[family]
        econn = dm.node_to_dof[mesh.conn[:, fam_local]]     # (ne, nd)
        nd = econn.shape[1]

        # quadrature geometry per element (host)
        pts, w = gauss(mesh.geom, quad_order)
        gb = get_basis(mesh.geom, "biquadratic")
        gphi = np.asarray(gb.eval(pts))
        gdphi = np.asarray(gb.eval_grad(pts))
        ec = mesh.coords[mesh.conn]
        xq = np.einsum("qn,end->eqd", gphi, ec)             # (ne, nq, dim)
        J = np.einsum("qnd,enx->eqdx", gdphi, ec)
        wdet = np.abs(np.linalg.det(J)) * w[None, :]        # (ne, nq)
        phi = np.asarray(b.eval(pts))                       # (nq, nd)

        # interacting pairs by centroid distance (host)
        cent = xq.mean(axis=1)
        from scipy.spatial import cKDTree
        tree = cKDTree(cent)
        h = mesh.char_length()
        pairs = tree.query_pairs(delta + 2.0 * h, output_type="ndarray")
        self_pairs = np.stack([np.arange(mesh.n_elems)] * 2, axis=1)
        pairs = np.concatenate([self_pairs, pairs])         # e1 <= e2
        self.pairs = pairs

        # sparsity: all (i, j) dof pairs of interacting elements
        ra = econn[pairs[:, 0]]
        rb = econn[pairs[:, 1]]
        rows = np.concatenate([
            np.repeat(ra, nd, 1).ravel(), np.repeat(rb, nd, 1).ravel(),
            np.repeat(ra, nd, 1).ravel(), np.repeat(rb, nd, 1).ravel()])
        cols = np.concatenate([
            np.tile(ra, (1, nd)).ravel(), np.tile(rb, (1, nd)).ravel(),
            np.tile(rb, (1, nd)).ravel(), np.tile(ra, (1, nd)).ravel()])
        self.pattern = pattern_from_pairs(rows, cols, dm.n_dofs, dm.n_dofs)

        lut = _build_slot_lut(self.pattern)

        def slot_block(ea, eb):
            r = np.repeat(econn[ea], nd, 1)
            c = np.tile(econn[eb], (1, nd))
            return lut(r.ravel(), c.ravel()).reshape(len(ea), nd, nd)

        self._slots = dict(
            aa=slot_block(pairs[:, 0], pairs[:, 0]),
            bb=slot_block(pairs[:, 1], pairs[:, 1]),
            ab=slot_block(pairs[:, 0], pairs[:, 1]),
            ba=slot_block(pairs[:, 1], pairs[:, 0]))

        if gamma is None:
            c = _C_NORM[mesh.dim]
            gam = lambda r2: c / delta ** (mesh.dim + 2) + 0.0 * r2  # noqa: E731
        else:
            gam = gamma
        self._gam = gam
        # the pair list and slot maps fit 32 bits (n_rows * width < 2^31);
        # uploaded once, read by every assembly
        i32 = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.int32, device=self.device)
        self._pairs_dev = i32(pairs)
        self._slots_dev = {k: i32(v.ravel()) for k, v in self._slots.items()}
        self._xq = self._tensor(xq)
        self._wdet = self._tensor(wdet)
        self._phi = self._tensor(phi)
        self._data = self._assemble()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _assemble(self) -> torch.Tensor:
        """Batched pair kernel -> ELL data (n_rows, width)."""
        pa, pb = self._pairs_dev[:, 0], self._pairs_dev[:, 1]
        phi = self._phi
        delta2 = self.delta ** 2
        gam = self._gam

        def pair_blocks(xa, xb, wa, wb, same):
            d2 = ((xa[:, None, :] - xb[None, :, :]) ** 2).sum(-1)  # (nq, nq)
            ker = torch.where(d2 < delta2, gam(d2), 0.0)
            W = ker * wa[:, None] * wb[None, :]
            half = torch.where(same, 0.5, 1.0)
            # a(u,v) blocks: K_aa[i,j] = int int W phi_i(x) phi_j(x)
            # (from the (u(y)-u(x)) term), K_ab the cross terms
            s_b = W.sum(1)                          # int over y, per x-qp
            s_a = W.sum(0)
            K_aa = half * (phi.T * s_b) @ phi       # (nd, nd)
            K_bb = half * (phi.T * s_a) @ phi
            K_ab = -half * (phi.T @ W @ phi)
            K_ba = -half * (phi.T @ W.T @ phi)
            return K_aa, K_bb, K_ab, K_ba

        blocks = torch.func.vmap(pair_blocks)(
            self._xq[pa], self._xq[pb], self._wdet[pa], self._wdet[pb],
            pa == pb)
        # pairs (a, b) with a < b appear once; K_ab/K_ba cover both
        # directions of the double integral, self pairs are halved
        nrows, w = self.pattern.n_rows, self.pattern.width
        flat = torch.zeros(nrows * w, dtype=self.dtype, device=self.device)
        for key, K in zip(("aa", "bb", "ab", "ba"), blocks):
            flat.index_add_(0, self._slots_dev[key], K.reshape(-1))
        return flat.reshape(nrows, w)

    def op(self) -> SparseOp:
        return op_from_pattern(self.pattern, self._data)

    def solve_dirichlet(self, rhs_fn: Callable, bc_fn: Callable,
                        collar: Optional[float] = None, tol=1e-10):
        """Solve L u = f with "volume constraint" Dirichlet data on the
        collar region within ``collar`` (default delta) of the boundary —
        the nonlocal analogue of boundary conditions.  ``rhs_fn`` maps a
        flat (N, dim) tensor of points to (N,) values, ``bc_fn`` a numpy
        (N, dim) array to (N,).  Diagonal-preconditioned CG on the device;
        the matvec runs on the BELL frame (kernel B1) from BELL_MIN_ROWS
        rows (``self.routing`` says which).  Returns (u numpy, SolveInfo)."""
        mesh, dm, dev, dt = self.mesh, self.dofmap, self.device, self.dtype
        collar = collar if collar is not None else self.delta
        x = mesh.coords[dm.nodes] if self.family != "disc_constant" else None
        lo = mesh.coords.min(axis=0)
        hi = mesh.coords.max(axis=0)
        dist = np.minimum((x - lo).min(axis=1), (hi - x).min(axis=1))
        mask = dist < collar + 1e-12
        gvals = np.asarray(bc_fn(x))
        # rhs: int f phi (local mass quadrature), all elements at once
        gphi, gdphi, fphi, _, w, coords_e, conn = _setup(
            mesh, self.family, "fifth", dt, dev)
        wdet = _wdet(gdphi, w, coords_e)                     # (ne, nq)
        xq = torch.einsum("qn,enx->eqx", gphi, coords_e)
        ne, nq, sdim = xq.shape
        f = rhs_fn(xq.reshape(ne * nq, sdim)).reshape(ne, nq)
        re = torch.einsum("qn,eq->en", fphi, wdet * f)
        R = torch.zeros(dm.n_dofs, dtype=dt, device=dev).index_add_(
            0, conn.reshape(-1), re.reshape(-1))

        routing = []
        A = on_bell_frame(self.op(), self.pattern, dev, routing)
        self.routing = routing[0]
        mj = torch.as_tensor(mask, device=dev)
        gj = torch.as_tensor(np.where(mask, gvals, 0.0), dtype=dt, device=dev)
        rj = torch.where(mj, 0.0, R - A @ gj)
        u, info = jacobi_cg(A, rj, mask=mj, tol=tol, maxiter=4000)
        u = torch.where(mj, gj, u)
        return u.cpu().numpy(), info
