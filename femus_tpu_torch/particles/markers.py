"""Lagrangian markers / particle tracking (ISM).

Reference: ``Marker`` (Marker.hpp:38 — coords, owner element search
GetElement/GetElementSerial :408-410, inverse reference mapping
InverseMappingTEST :417) and ``Line`` (Line.hpp:34 — particle set;
``AdvectionParallel(n, T, order)`` RK advection with cross-proc hand-off
:75).  Every particle operation runs batched over the whole cloud on the
device:

  inverse isoparametric Newton (a fixed number of iterations) -> FE
  velocity interpolation -> RK update -> neighbor-walk element relocation
  (a fixed number of hops over the precomputed element-neighbor table).

Every particle takes the same number of Newton iterations; the walks stop
only once every particle of the batch is done (a particle that is done
keeps its element, so the batch-wide exit changes no result, while a
per-particle exit would move markers that sit on a shared face).  Markers
that exit the domain are parked (elem = -1) and ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..fe.basis import _diff_tables, get_basis
from ..fe.geom import GEOMS
from ..mesh.mesh import Mesh, elem_neighbors

# reference-coordinate face violations per geometry (face order of geom.py):
# fn(xi (n, dim)) -> (n, n_faces), positive where xi lies beyond that face
_FACE_VIOLATION = {
    "edge": lambda xi: torch.stack([-(1 + xi[:, 0]), xi[:, 0] - 1], dim=-1),
    "quad": lambda xi: torch.stack([-(1 + xi[:, 1]), xi[:, 0] - 1,
                                    xi[:, 1] - 1, -(1 + xi[:, 0])], dim=-1),
    "tri": lambda xi: torch.stack([-xi[:, 1], xi[:, 0] + xi[:, 1] - 1,
                                   -xi[:, 0]], dim=-1),
    "hex": lambda xi: torch.stack([-(1 + xi[:, 2]), xi[:, 2] - 1,
                                   -(1 + xi[:, 1]), xi[:, 0] - 1,
                                   xi[:, 1] - 1, -(1 + xi[:, 0])], dim=-1),
    "tet": lambda xi: torch.stack([-xi[:, 2], -xi[:, 1],
                                   xi[:, 0] + xi[:, 1] + xi[:, 2] - 1,
                                   -xi[:, 0]], dim=-1),
    "wedge": lambda xi: torch.stack([-(1 + xi[:, 2]), xi[:, 2] - 1,
                                     -xi[:, 1], xi[:, 0] + xi[:, 1] - 1,
                                     -xi[:, 0]], dim=-1),
}


@dataclasses.dataclass
class MarkerCloud:
    """Struct-of-arrays particle set bound to one mesh level (host arrays;
    the operations upload them)."""

    mesh: Mesh
    x: np.ndarray                 # (np_, dim)
    elem: np.ndarray              # (np_,) owner element (-1 = outside)
    fields: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.x.shape[0]


class PointBasis:
    """A basis of ``fe/basis.py`` evaluated at a batch of reference points
    on the device: ``eval(xi (n, dim)) -> (n, nd)``, ``eval_grad(xi) ->
    (n, nd, dim)``.  Every monomial x_0^a_0 ... of the basis and of its
    derivatives has exponents below ``m``, so one outer product of the
    per-axis powers gives all m^dim of them and one matrix product with
    the stacked coefficient tables gives the values and the gradients."""

    def __init__(self, geom: str, family: str, device, dtype):
        b = get_basis(geom, family)
        self.dim, self.nd = b.dim, b.n_basis
        tables = [(b.exponents, b.coeff)] + [_diff_tables(b, d)
                                             for d in range(b.dim)]
        self._m = int(max(e.max() for e, _ in tables)) + 1
        C = np.zeros((self._m ** b.dim, len(tables) * self.nd))
        for t, (e, c) in enumerate(tables):
            rows = np.ravel_multi_index(tuple(e.T), (self._m,) * b.dim)
            np.add.at(C, (rows[:, None],
                          t * self.nd + np.arange(self.nd)[None, :]), c.T)
        self._C = torch.as_tensor(C, dtype=dtype, device=device)

    def _monomials(self, xi):
        """(n, m^dim): every product of per-axis powers below m."""
        out = None
        for d in range(self.dim):
            pw = [torch.ones_like(xi[:, d]), xi[:, d]]
            while len(pw) < self._m:
                pw.append(pw[-1] * xi[:, d])
            pw = torch.stack(pw[:self._m], dim=1)
            out = pw if out is None else (out[:, :, None]
                                          * pw[:, None, :]).flatten(1)
        return out

    def eval(self, xi):
        return self._monomials(xi) @ self._C[:, :self.nd]

    def eval_both(self, xi):
        """(eval, eval_grad) from one matrix product."""
        v = (self._monomials(xi) @ self._C).view(-1, 1 + self.dim, self.nd)
        return v[:, 0], v[:, 1:].transpose(1, 2)

    def eval_grad(self, xi):
        return self.eval_both(xi)[1]


def solve_small(A, r):
    """x with A x = r for a batch of 1x1, 2x2 or 3x3 systems, A (n, d, d),
    r (n, d), by the adjugate: never raises (a singular A gives inf/nan, as
    an LU solve of the reference package does), no factorisation call and
    no batched matrix product."""
    if A.shape[-1] == 2:
        det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
        return torch.stack([A[:, 1, 1] * r[:, 0] - A[:, 0, 1] * r[:, 1],
                            A[:, 0, 0] * r[:, 1] - A[:, 1, 0] * r[:, 0]],
                           dim=-1) / det[:, None]
    return (inv_small(A) * r[:, None, :]).sum(dim=-1)


def inv_small(A):
    """Batched inverse of (n, d, d) matrices, d <= 3, by the adjugate."""
    d = A.shape[-1]
    if d == 1:
        return 1.0 / A
    if d == 2:
        det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
        adj = torch.stack([torch.stack([A[:, 1, 1], -A[:, 0, 1]], -1),
                           torch.stack([-A[:, 1, 0], A[:, 0, 0]], -1)], -2)
        return adj / det[:, None, None]
    c = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            i1, i2 = (i + 1) % 3, (i + 2) % 3
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            c[i][j] = (A[:, i1, j1] * A[:, i2, j2]
                       - A[:, i1, j2] * A[:, i2, j1])     # cofactor (i, j)
    det = A[:, 0, 0] * c[0][0] + A[:, 0, 1] * c[0][1] + A[:, 0, 2] * c[0][2]
    adj = torch.stack([torch.stack([c[j][i] for j in range(3)], -1)
                       for i in range(3)], -2)
    return adj / det[:, None, None]


class GeoTables:
    """A mesh's geometry on the device for particle work: the biquadratic
    element coordinates, the element-neighbor table, the geometry basis and
    the reference centre."""

    def __init__(self, mesh: Mesh, device, dtype):
        g = GEOMS[mesh.geom]
        self.conn = torch.as_tensor(
            mesh.conn[:, g.family_nodes["biquadratic"]], dtype=torch.int64,
            device=device)
        self.coords = torch.as_tensor(mesh.coords, dtype=dtype, device=device)
        self.elem_xy = self.coords[self.conn]          # (ne, nd_geo, dim)
        self.neigh = torch.as_tensor(elem_neighbors(mesh), dtype=torch.int64,
                                     device=device)
        self.basis = PointBasis(mesh.geom, "biquadratic", device, dtype)
        self.center = torch.as_tensor(g.center, dtype=dtype, device=device)
        self.viol = _FACE_VIOLATION[mesh.geom]

    def elem_coords(self, e):
        """(n, nd_geo, dim) node coordinates of the elements ``e``."""
        return self.elem_xy[e]

    def inverse(self, ce, xp, iters: int = 6):
        """Reference coordinates of the physical points ``xp`` (n, dim) in
        the elements of coordinates ``ce``: ``iters`` Newton iterations from
        the element centre."""
        return _inverse_newton(self.basis, ce, xp,
                               self.center.expand_as(xp), iters)

    def walk(self, x, e, hops: int, iters: int, inside_tol: float,
             leave: bool):
        """Neighbor walk of every point from element ``e``: ``hops`` hops,
        each a Newton inverse map and a step across the most violated face.
        A point stays where it is when it is inside or when that face is on
        the boundary; it is done once inside or, with ``leave``, once it
        met the boundary (without, it keeps trying every hop).  Returns
        the elements."""
        done = torch.zeros_like(e, dtype=torch.bool)
        for _ in range(hops):
            xi = self.inverse(self.elem_coords(e), x, iters)
            v = self.viol(xi)
            inside = v.max(dim=-1).values < inside_tol
            nxt = self.neigh[e, v.argmax(dim=-1)]
            out = ~inside & (nxt < 0)
            e = torch.where(inside | done | out, e, nxt)
            done = done | inside | (out if leave else False)
            if bool(done.all()):
                break
        return e

    def settle(self, x, e, iters: int, tol: float):
        """``e`` where the point lies inside it to ``tol``, else -1."""
        xi = self.inverse(self.elem_coords(e), x, iters)
        ok = self.viol(xi).max(dim=-1).values < tol
        return torch.where(ok, e, torch.full_like(e, -1))


def _inverse_newton(basis: PointBasis, ce, xp, xi0, iters: int = 6):
    """Batched inverse isoparametric map: ``iters`` Newton steps of
    phi(xi) @ ce = xp from ``xi0`` (n, dim).  The contractions over the
    element's nodes are broadcast products and sums (memory-bound), not
    batched matrix products of tiny matrices."""
    xi = xi0
    for _ in range(iters):
        phi, dphi = basis.eval_both(xi)            # (n, nd), (n, nd, dim)
        r = (phi[:, :, None] * ce).sum(dim=1) - xp
        # J[k, d] = d x_d / d xi_k
        J = (dphi[:, :, :, None] * ce[:, :, None, :]).sum(dim=1)
        xi = xi - solve_small(J.transpose(1, 2), r)
    return xi


def locate(cloud: MarkerCloud, max_hops: int = 64, device="cuda") -> None:
    """Initial owner-element search: nearest-centroid guess on the host
    (scipy cKDTree) + neighbor walk on the device in float64 (reference
    GetElementSerial)."""
    from scipy.spatial import cKDTree

    device = resolve_device(device)
    mesh = cloud.mesh
    g = GEOMS[mesh.geom]
    cent = mesh.coords[mesh.conn[:, :g.n_verts]].mean(axis=1)
    _, e0 = cKDTree(cent).query(cloud.x)
    geo = GeoTables(mesh, device, torch.float64)
    x = torch.as_tensor(cloud.x, dtype=torch.float64, device=device)
    e = torch.as_tensor(e0, dtype=torch.int64, device=device)
    e = geo.walk(x, e, max_hops, iters=8, inside_tol=1e-10, leave=True)
    cloud.elem = geo.settle(x, e, iters=8, tol=1e-8).cpu().numpy()


def make_advect_fn(mesh: Mesh, vel_families: Sequence[str], order: int = 2,
                   max_hops: int = 4, dtype: Optional[torch.dtype] = None,
                   force_fn: Optional[Callable] = None, device="cuda"):
    """Build the batched advection substep over a velocity FE field.

    Returns step(x (n, dim), elem (n,), vel_dofs: tuple of (n_dofs,) per
    component, dt) -> (x_new, elem_new), tensors on ``device``.  order: 2
    (midpoint RK2) or 4 (classical RK4) (reference Line::AdvectionParallel
    RK2/RK4).  force_fn(x (n, dim)) -> (n, dim) adds a body-force velocity
    increment (the reference's optional Force argument — e.g.
    particles.forces.magnetic_force)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    dim = mesh.dim
    geo = GeoTables(mesh, device, dtype)
    vconns = [torch.as_tensor(mesh.dofmap(f).conn, dtype=torch.int64,
                              device=device) for f in vel_families]
    vbases = [PointBasis(mesh.geom, f, device, dtype) for f in vel_families]

    def velocity(xp, ce, vals):
        """The field at ``xp`` in the elements of coordinates ``ce`` and
        element dof values ``vals`` (one (n, nd) per component)."""
        xi = geo.inverse(ce, xp)
        vv = torch.stack([(vbases[d].eval(xi) * vals[d]).sum(dim=-1)
                          for d in range(dim)], dim=-1)
        if force_fn is not None:
            vv = vv + force_fn(xp)
        return vv

    def step(x, elem, vel_dofs, dt):
        alive = elem >= 0
        esafe = elem.clamp(min=0)
        # every RK stage evaluates in the step's starting element
        ce = geo.elem_coords(esafe)
        vals = [vel_dofs[d][vconns[d][esafe]] for d in range(dim)]
        if order == 4:
            k1 = velocity(x, ce, vals)
            k2 = velocity(x + 0.5 * dt * k1, ce, vals)
            k3 = velocity(x + 0.5 * dt * k2, ce, vals)
            k4 = velocity(x + dt * k3, ce, vals)
            dx = dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        else:
            k1 = velocity(x, ce, vals)
            k2 = velocity(x + 0.5 * dt * k1, ce, vals)
            dx = dt * k2
        x_new = torch.where(alive[:, None], x + dx, x)
        e_walk = geo.walk(x_new, esafe, max_hops, iters=6, inside_tol=1e-9,
                          leave=True)
        e_new = geo.settle(x_new, e_walk, iters=6, tol=1e-6)
        return x_new, torch.where(alive, e_new, elem)

    return step


def advect(cloud: MarkerCloud, vel_dofs: Sequence[np.ndarray],
           vel_families: Sequence[str], T: float, n_steps: int,
           order: int = 2, force_fn: Optional[Callable] = None,
           dtype: Optional[torch.dtype] = None, device="cuda") -> None:
    """Advect the cloud through a steady velocity field for time T
    (reference Line::AdvectionParallel)."""
    device = resolve_device(device)
    step = make_advect_fn(cloud.mesh, vel_families, order, force_fn=force_fn,
                          dtype=dtype, device=device)
    dtype = dtype or default_dtype(device)
    dt = T / n_steps
    x = torch.as_tensor(cloud.x, dtype=dtype, device=device)
    e = torch.as_tensor(cloud.elem, dtype=torch.int64, device=device)
    vd = tuple(torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
               for v in vel_dofs)
    for _ in range(n_steps):
        x, e = step(x, e, vd, dt)
    cloud.x = x.cpu().numpy()
    cloud.elem = e.cpu().numpy()
