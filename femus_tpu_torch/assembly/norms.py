"""Error norms and functional integrals over a mesh.

Backs the FE-convergence harness (reference FE_convergence.hpp:29-139:
per-unknown L2/H1 error norms vs analytic solution or vs finer level).
All elements are evaluated at once (element axis first); analytic fields
are called on the flat (n_elems * nq, sdim) quadrature points.  Results
come back as Python floats.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..fe.geom import GEOMS
from ..fe.tabulate import tabulate
from .engine import GEO_FAMILY, _element_geometry


def _geometry(mesh, quad_order, dtype, device):
    """(gphi, gdphi, weights, coords_e (ne, nd_geo, sdim)) on ``device``."""
    g = GEOMS[mesh.geom]
    tg = tabulate(mesh.geom, GEO_FAMILY, quad_order)
    geo_conn = mesh.conn[:, g.family_nodes[GEO_FAMILY]]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return t(tg.phi), t(tg.dphi), t(tg.weights), t(mesh.coords[geo_conn])


def _setup(mesh, family, quad_order, dtype, device):
    gphi, gdphi, w, coords_e = _geometry(mesh, quad_order, dtype, device)
    tf = tabulate(mesh.geom, family, quad_order)
    conn = torch.as_tensor(mesh.dofmap(family).conn, dtype=torch.int64,
                           device=device)
    return (gphi, gdphi,
            torch.as_tensor(tf.phi, dtype=dtype, device=device),
            torch.as_tensor(tf.dphi, dtype=dtype, device=device),
            w, coords_e, conn)


def _metric(gdphi, w, coords_e):
    """(wdet (ne, nq), invJT (ne, nq, d, x)): the assembly engine's element
    geometry with the element axis first — quadrature weights times the
    volume (or embedded-manifold area) element, and the map taking
    reference derivatives to physical (tangential) gradients."""
    wdet, M = _element_geometry(gdphi, w, coords_e.permute(1, 2, 0))
    return wdet.T, M.permute(3, 0, 1, 2)


def _wdet(gdphi, w, coords_e):
    """Quadrature weights x volume (or manifold area) element: (ne, nq)."""
    return _metric(gdphi, w, coords_e)[0]


def _at_points(fn: Callable, xq: torch.Tensor) -> torch.Tensor:
    """``fn`` on the flat quadrature points, element axis restored."""
    ne, nq, sdim = xq.shape
    out = fn(xq.reshape(ne * nq, sdim))
    return out.reshape((ne, nq) + tuple(out.shape[1:]))


def _field(u, device) -> torch.Tensor:
    u = torch.as_tensor(u, device=device)
    return u if u.is_floating_point() else u.double()


def error_norms(mesh, family: str, u, exact: Callable,
                exact_grad: Optional[Callable] = None,
                quad_order="ninth", device="cuda") -> Tuple[float, float]:
    """(L2 error, H1-seminorm error) of the FE function vs an analytic field,
    computed on ``device`` in ``u``'s precision.

    exact(x: (N, sdim)) -> (N,); exact_grad(x) -> (N, sdim).
    """
    device = resolve_device(device)
    u = _field(u, device)
    gphi, gdphi, fphi, fdphi, w, coords_e, conn = _setup(
        mesh, family, quad_order, u.dtype, device)
    ul = u[conn]                                        # (ne, nd)
    wdet, invJT = _metric(gdphi, w, coords_e)
    xq = torch.einsum("qn,enx->eqx", gphi, coords_e)
    uh = torch.einsum("qn,en->eq", fphi, ul)
    e2 = ((uh - _at_points(exact, xq)) ** 2 * wdet).sum()
    h2 = 0.0
    if exact_grad is not None:
        dphi = torch.einsum("qnd,eqdx->eqnx", fdphi, invJT)
        gh = torch.einsum("eqnx,en->eqx", dphi, ul)
        h2 = float((((gh - _at_points(exact_grad, xq)) ** 2).sum(dim=-1)
                    * wdet).sum())
    return float(torch.sqrt(e2)), float(np.sqrt(h2))


def l2_norm_field(mesh, family: str, u, quad_order="ninth",
                  device="cuda") -> float:
    """Integral L2 norm of the FE function itself."""
    z, _ = error_norms(mesh, family, u,
                       lambda x: x.new_zeros(x.shape[0]), None, quad_order,
                       device)
    return z


def integrate_field(mesh, family: str, u, quad_order="ninth",
                    device="cuda") -> float:
    """integral of the FE function u over the mesh (e.g. total mass)."""
    device = resolve_device(device)
    u = _field(u, device)
    gphi, gdphi, fphi, _, w, coords_e, conn = _setup(
        mesh, family, quad_order, u.dtype, device)
    uh = torch.einsum("qn,en->eq", fphi, u[conn])
    return float((uh * _wdet(gdphi, w, coords_e)).sum())


def integrate(mesh, fn: Callable, quad_order="ninth", dtype=torch.float64,
              device="cuda") -> float:
    """integral of fn(x) over the mesh (host-facing convenience)."""
    device = resolve_device(device)
    gphi, gdphi, w, coords_e = _geometry(mesh, quad_order, dtype, device)
    xq = torch.einsum("qn,enx->eqx", gphi, coords_e)
    return float((_at_points(fn, xq) * _wdet(gdphi, w, coords_e)).sum())
