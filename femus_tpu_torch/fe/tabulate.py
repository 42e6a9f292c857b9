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
import numpy as np

from .basis import get_basis
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
