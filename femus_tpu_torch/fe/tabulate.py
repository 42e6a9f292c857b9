"""Pre-tabulated FE evaluations at quadrature points.

The reference pre-tabulates phi / dphi-dxi at all Gauss points once per
(geom, FE family, quadrature order) inside ``elem_type`` /
``elem_type_templ`` (ElemType.hpp:40, ElemType_template.hpp:33;
MultiLevelProblem.hpp:206 builds them for every combination).  Here the same
tables are plain numpy arrays produced at setup and uploaded once by the
assembler — the analogue of the reference's ``_phi``/``_dphidxi`` member
arrays.

Geometric mapping (reference ``Jacobian``/``JacobianSur``,
ElemType.hpp:285-360, ElemType_template.hpp:49-76) is done on device inside
the batched assembly kernels using these tables; see assembly/engine.py.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

from .basis import get_basis
from .geom import GEOMS
from .quadrature import gauss


@dataclasses.dataclass(frozen=True)
class Tabulation:
    """phi, dphi (reference coords), weights for one (geom, family, order)."""

    geom: str
    family: str
    points: np.ndarray    # (nq, dim)
    weights: np.ndarray   # (nq,)
    phi: np.ndarray       # (nq, nd)
    dphi: np.ndarray      # (nq, nd, dim)

    @property
    def nq(self) -> int:
        return self.weights.shape[0]

    @property
    def nd(self) -> int:
        return self.phi.shape[1]


@functools.lru_cache(maxsize=None)
def tabulate(geom: str, family: str, order) -> Tabulation:
    pts, w = gauss(geom, order)
    b = get_basis(geom, family)
    return Tabulation(geom, family, pts, w,
                      np.asarray(b.eval(pts), np.float64),
                      np.asarray(b.eval_grad(pts), np.float64))


@functools.lru_cache(maxsize=None)
def tabulate_at(geom: str, family: str, pts_key) -> Tuple[np.ndarray, np.ndarray]:
    """phi/dphi at arbitrary (hashable tuple-encoded) reference points."""
    pts = np.asarray(pts_key, np.float64)
    b = get_basis(geom, family)
    return np.asarray(b.eval(pts)), np.asarray(b.eval_grad(pts))


def face_trace_nodes(geom: str, family: str, iface: int):
    """(face_family, local volume-node ids) whose trace forms the face
    element's nodal basis, ordered per the face geometry's node order.

    The trace family can degrade: tet10/wedge18 tri faces carry no centroid
    bubble, so their trace of ``biquadratic`` is tri6 (``serendipity``)."""
    g = GEOMS[geom]
    fgeom_name, f_bq_ids = g.faces[iface]
    fg = GEOMS[fgeom_name]
    f_bq = np.asarray(f_bq_ids)
    face_family = family
    if len(fg.family_nodes.get(family, ())) > len(f_bq):
        face_family = "serendipity"
    face_local = fg.family_nodes[face_family]      # face-geom local ids
    vol_bq = f_bq[face_local]                      # volume biquadratic ids
    fam_nodes = g.family_nodes[family]
    inv = {int(n): i for i, n in enumerate(fam_nodes)}
    return face_family, np.array([inv[int(v)] for v in vol_bq], int)


def inverse_map_newton(geom: str, coords, x_phys, xp, iters: int = 8):
    """Invert the isoparametric (biquadratic) map: find ref xi with
    F(xi) = x_phys, via Newton (the reference's marker inverse mapping,
    PolynomialBases.cpp, Marker InverseMappingTEST, Marker.hpp:417).
    Pure-array: ``xp`` is ``numpy`` (host arrays) or ``torch`` (tensors on
    any device, differentiable).

    coords: (nd, dim) physical node coords; x_phys: (dim,).
    Returns xi (dim,).
    """
    b = get_basis(geom, "biquadratic")
    g = GEOMS[geom]
    if xp is np:
        xi = np.asarray(g.center, coords.dtype)
    else:
        xi = xp.as_tensor(np.asarray(g.center), dtype=coords.dtype,
                          device=coords.device)
    for _ in range(iters):
        phi = b.eval(xi[None, :], xp)[0]           # (nd,)
        dphi = b.eval_grad(xi[None, :], xp)[0]     # (nd, dim)
        r = phi @ coords - x_phys                  # (dim,)
        J = dphi.T @ coords                        # J[a,b] = dx_b/dxi_a
        xi = xi - xp.linalg.solve(J.T, r)
    return xi
