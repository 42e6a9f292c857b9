"""Material point method: particle <-> grid transfer and explicit dynamics.

Reference: the MPM half of ``src/ism/`` — ``Marker`` particle state (mass,
velocity, acceleration, deformation gradient, Marker.hpp:248-320) and
``Line``'s grid transfer helpers (``GetParticlesToGridMaterial``,
``UpdateLineMPM``, Line.hpp:75-87), used by the MPM_FEM / MPM_FSI apps.

Particles are one struct-of-arrays batch of tensors; every stage runs over
the whole cloud on the device —

  Transfer uses the (non-negative) linear Lagrange basis by default —
  quadratic bases take negative values, producing near-zero/negative grid
  masses at support edges (the standard MPM restriction).

  P2G:  m_i = sum_p m_p phi_i(x_p);  (mv)_i = sum_p m_p v_p phi_i(x_p);
        f_i = - sum_p V_p sigma_p . grad phi_i(x_p)     [index_add_ scatter]
  grid: v* = (mv + dt (f + m g)) / m, essential BCs zeroed on grid dofs
  G2P:  v_p <- PIC/FLIP blend, x_p += dt v*, F_p <- (I + dt grad v*) F_p
        [gather]

On the card the scatter's float atomics add in no fixed order, so a card
run equals a host run to rounding, not bit for bit.  Owner elements and
local coords ride the marker machinery (neighbor-walk relocation after the
position update).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..fe.basis import get_basis
from ..fe.geom import GEOMS
from ..mesh.mesh import Mesh
from .markers import GeoTables, PointBasis, inv_small


@dataclasses.dataclass
class MPMState:
    """Particle state (all (np_, ...) tensors on one device)."""

    x: torch.Tensor          # (np_, dim) positions
    v: torch.Tensor          # (np_, dim) velocities
    F: torch.Tensor          # (np_, dim, dim) deformation gradient
    mass: torch.Tensor       # (np_,)
    vol0: torch.Tensor       # (np_,) initial volume
    elem: torch.Tensor       # (np_,) owner element


def init_particles(mesh: Mesh, region_fn: Callable, ppc: int = 4,
                   density: float = 1.0, vel_fn: Optional[Callable] = None,
                   device="cuda", dtype: Optional[torch.dtype] = None
                   ) -> MPMState:
    """Seed ``ppc``^dim particles per element (tensor lattice in the
    reference cell) inside ``region_fn(x)->bool`` (host numpy, as the
    region and velocity callbacks are), then upload the state."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    b = get_basis(mesh.geom, "biquadratic")
    # lattice of local coords in the reference element
    t = (np.arange(ppc) + 0.5) / ppc
    if mesh.geom in ("quad", "hex", "edge"):
        axes = [2 * t - 1] * mesh.dim
        xi = np.stack(np.meshgrid(*axes, indexing="ij"),
                      axis=-1).reshape(-1, mesh.dim)
        ref_vol = 2.0 ** mesh.dim
    elif mesh.geom == "tri":
        pts = np.stack(np.meshgrid(t, t, indexing="ij"), -1).reshape(-1, 2)
        xi = np.where(pts.sum(1, keepdims=True) > 1, 1 - pts[:, ::-1], pts)
        ref_vol = 0.5
    else:
        raise NotImplementedError(mesh.geom)
    phi = np.asarray(b.eval(xi))                        # (npp, n_bq)
    dphi = np.asarray(b.eval_grad(xi))                  # (npp, n_bq, dim)
    ec = mesh.coords[mesh.conn]                         # (ne, n_bq, dim)
    xp = np.einsum("pn,end->epd", phi, ec).reshape(-1, mesh.dim)
    J = np.einsum("pnd,enx->epxd", dphi, ec)
    detJ = np.abs(np.linalg.det(J)).reshape(-1)
    vol = detJ * ref_vol / (ppc ** mesh.dim)
    elem = np.repeat(np.arange(mesh.n_elems), len(xi))
    keep = np.asarray(region_fn(xp), bool)
    xp, vol, elem = xp[keep], vol[keep], elem[keep]
    v = (np.asarray(vel_fn(xp)) if vel_fn is not None
         else np.zeros_like(xp))
    n = len(xp)

    def up(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return MPMState(
        x=up(xp), v=up(v),
        F=torch.eye(mesh.dim, dtype=dtype, device=device).repeat(n, 1, 1),
        mass=up(density * vol), vol0=up(vol),
        elem=torch.as_tensor(elem, dtype=torch.int64, device=device))


def neo_hookean_stress(mu: float, lam: float):
    """Cauchy stress sigma(F) for a compressible neo-Hookean solid
    (reference Solid model 1, Solid.cpp:72-75); F (..., dim, dim)."""
    def stress(F):
        dim = F.shape[-1]
        Jd = torch.clamp(torch.linalg.det(F), min=1e-6)[..., None, None]
        B = F @ F.transpose(-1, -2)
        I = torch.eye(dim, dtype=F.dtype, device=F.device)
        return (mu * (B - I) + lam * torch.log(Jd) * I) / Jd
    return stress


class ParticleShapes:
    """A family's basis values and physical gradients at particles, from
    their owner elements (Newton inverse map on the biquadratic geometry)."""

    def __init__(self, mesh: Mesh, family: str, device, dtype):
        self.geo = GeoTables(mesh, device, dtype)
        self.basis = PointBasis(mesh.geom, family, device, dtype)

    def __call__(self, x, e):
        """phi (np_, nd), grad phi (np_, nd, dim) at the particles."""
        ce = self.geo.elem_coords(e)
        xi = self.geo.inverse(ce, x)
        gdphi = self.geo.basis.eval_grad(xi)
        Jg = (gdphi[:, :, :, None] * ce[:, :, None, :]).sum(dim=1)
        phi, dphi = self.basis.eval_both(xi)
        return phi, dphi @ inv_small(Jg)


def make_mpm_step(mesh: Mesh, stress_fn: Callable,
                  family: str = "linear",
                  gravity: Tuple[float, ...] = (0.0, -9.81),
                  flip: float = 0.95,
                  fixed_dofs: Optional[np.ndarray] = None,
                  max_hops: int = 3, dtype: Optional[torch.dtype] = None,
                  device="cuda"):
    """Build the explicit MPM step: (state, dt) -> state, on ``device``.

    fixed_dofs: boolean (n_family_dofs,) — grid velocity zeroed there
    (essential boundary, e.g. walls)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    g = GEOMS[mesh.geom]
    dm = mesh.dofmap(family)
    fam_local = g.family_nodes[family]
    econn = torch.as_tensor(dm.node_to_dof[mesh.conn[:, fam_local]],
                            dtype=torch.int64, device=device)   # (ne, nd)
    shapes = ParticleShapes(mesh, family, device, dtype)
    n_dofs = dm.n_dofs
    dim = mesh.dim
    grav = torch.as_tensor(gravity[:dim], dtype=dtype, device=device)
    free = ~(torch.as_tensor(np.asarray(fixed_dofs), device=device)
             if fixed_dofs is not None
             else torch.zeros(n_dofs, dtype=torch.bool, device=device))

    def scatter(vals, dofs):
        return torch.zeros(n_dofs, dtype=dtype, device=device).index_add_(
            0, dofs.reshape(-1), vals.reshape(-1))

    def step(s: MPMState, dt) -> MPMState:
        phi, gphi = shapes(s.x, s.elem)      # (np_, nd), (np_, nd, dim)
        dofs = econn[s.elem]                             # (np_, nd)
        sig = stress_fn(s.F)                             # (np_, dim, dim)
        volp = s.vol0 * torch.linalg.det(s.F)

        # P2G scatter
        mi = scatter(s.mass[:, None] * phi, dofs)
        mv = torch.stack([scatter(s.mass[:, None] * s.v[:, d:d + 1] * phi,
                                  dofs) for d in range(dim)], dim=1)
        sg = torch.einsum("pxd,pnd->pnx", sig, gphi)
        fint = torch.stack([scatter(-(volp[:, None] * sg[:, :, d]), dofs)
                            for d in range(dim)], dim=1)

        # small-mass cutoff RELATIVE to the particle mass scale.  With
        # linear-hat transfer, grad phi stays O(1/h) while phi -> 0 at a
        # node's support edge, so f_i/m_i is unbounded for sliver nodes
        # (the MPM cell-crossing instability); nodes carrying less than a
        # few percent of one particle are dropped from the grid solve.
        thr = 3e-2 * s.mass.mean()
        m_safe = torch.clamp(mi, min=thr)[:, None]
        v_old = mv / m_safe
        v_new = v_old + dt * (fint / m_safe + grav[None, :])
        act = ((mi > thr) & free)[:, None]
        v_old = torch.where(act, v_old, 0.0)
        v_new = torch.where(act, v_new, 0.0)

        # G2P gather
        vg_new = torch.einsum("pn,pnx->px", phi, v_new[dofs])
        vg_old = torch.einsum("pn,pnx->px", phi, v_old[dofs])
        gradv = torch.einsum("pnd,pnx->pxd", gphi, v_new[dofs])
        v_p = flip * (s.v + vg_new - vg_old) + (1 - flip) * vg_new
        x_p = s.x + dt * vg_new
        I = torch.eye(dim, dtype=s.F.dtype, device=device)
        F_p = (I[None] + dt * gradv) @ s.F
        e_p = shapes.geo.walk(x_p, s.elem, max_hops, iters=6,
                              inside_tol=1e-9, leave=False)
        return MPMState(x=x_p, v=v_p, F=F_p, mass=s.mass, vol0=s.vol0,
                        elem=e_p)

    return step


def grid_fields(mesh: Mesh, s: MPMState, family: str = "linear"):
    """Diagnostic P2G of mass/momentum (reference GetParticlesToGridMaterial
    flavor), on the state's device: returns (m_i, (mv)_i) numpy arrays."""
    g = GEOMS[mesh.geom]
    dm = mesh.dofmap(family)
    dev = s.x.device
    econn = torch.as_tensor(dm.node_to_dof[mesh.conn[:, g.family_nodes[family]]],
                            dtype=torch.int64, device=dev)
    phi, _ = ParticleShapes(mesh, family, dev, s.x.dtype)(s.x, s.elem)
    dofs = econn[s.elem].reshape(-1)

    def scatter(vals):
        return torch.zeros(dm.n_dofs, dtype=s.x.dtype, device=dev
                           ).index_add_(0, dofs, vals.reshape(-1))

    mi = scatter(s.mass[:, None] * phi)
    mv = torch.stack([scatter(s.mass[:, None] * s.v[:, d:d + 1] * phi)
                      for d in range(mesh.dim)], dim=1)
    return mi.cpu().numpy(), mv.cpu().numpy()
