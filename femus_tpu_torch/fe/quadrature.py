"""Gauss quadrature rules for all reference geometries.

Replaces the reference's static per-geometry weight tables
(src/02_reference_geom_elements/02_quadrature, quadrature_interface.hpp:32,
order strings "zero".."ninth" mapped at quadrature_interface.cpp:36-50) with
rules generated at setup: Gauss-Legendre tensor products for edge/quad/hex and
conical (Duffy + Gauss-Jacobi) products for tri/tet/wedge — exact to the
requested polynomial degree at any order, not just the tabulated ones.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
from numpy.polynomial.legendre import leggauss
from scipy.special import roots_jacobi

# femus-compatible order names (quadrature_interface.cpp:36-50): the string is
# the max total polynomial degree integrated exactly.
ORDER_NAMES = {
    "zero": 0, "first": 1, "second": 2, "third": 3, "fourth": 4,
    "fifth": 5, "sixth": 6, "seventh": 7, "eighth": 8, "ninth": 9,
    "tenth": 10, "eleventh": 11, "twelfth": 12,
}


def _deg(order) -> int:
    if isinstance(order, str):
        return ORDER_NAMES[order]
    return int(order)


def _n1d(deg: int) -> int:
    return deg // 2 + 1   # Gauss-Legendre with n points exact to degree 2n-1


@functools.lru_cache(maxsize=None)
def gauss(geom: str, order) -> Tuple[np.ndarray, np.ndarray]:
    """Quadrature rule (points (nq, dim), weights (nq,)) exact for polynomials
    of total degree <= order on the reference element of ``geom``."""
    deg = _deg(order)
    n = _n1d(deg)
    if geom == "point":
        return np.zeros((1, 0)), np.ones(1)
    if geom == "edge":
        x, w = leggauss(n)
        return x[:, None], w
    if geom == "quad":
        x, w = leggauss(n)
        X, Y = np.meshgrid(x, x, indexing="ij")
        W = np.outer(w, w)
        return np.stack([X.ravel(), Y.ravel()], axis=1), W.ravel()
    if geom == "hex":
        x, w = leggauss(n)
        X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
        W = np.einsum("i,j,k->ijk", w, w, w)
        return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1), W.ravel()
    if geom == "tri":
        return _conical_tri(n)
    if geom == "tet":
        return _conical_tet(n)
    if geom == "wedge":
        pt, wt = _conical_tri(n)
        x, w = leggauss(n)
        pts = np.concatenate(
            [np.repeat(pt, len(x), axis=0),
             np.tile(x, len(pt))[:, None]], axis=1)
        ws = np.repeat(wt, len(x)) * np.tile(w, len(pt))
        return pts, ws
    raise KeyError(geom)


def _conical_tri(n: int):
    """Conical-product rule on the unit triangle x,y>=0, x+y<=1."""
    xa, wa = roots_jacobi(n, 1.0, 0.0)   # weight (1-t) on [-1,1]
    xb, wb = leggauss(n)
    ta, tb = (xa + 1) / 2, (xb + 1) / 2  # to [0,1]
    wa, wb = wa / 4, wb / 2              # jacobi weight includes (1-t): /2 scale + /2 interval
    pts, ws = [], []
    for i in range(n):
        for j in range(n):
            x = ta[i]
            y = tb[j] * (1 - ta[i])
            pts.append((x, y))
            ws.append(wa[i] * wb[j])
    return np.array(pts), np.array(ws)


def _conical_tet(n: int):
    """Conical-product rule on the unit tetrahedron."""
    xa, wa = roots_jacobi(n, 2.0, 0.0)   # (1-t)^2
    xb, wb = roots_jacobi(n, 1.0, 0.0)   # (1-t)
    xc, wc = leggauss(n)
    ta, tb, tc = (xa + 1) / 2, (xb + 1) / 2, (xc + 1) / 2
    wa, wb, wc = wa / 8, wb / 4, wc / 2
    pts, ws = [], []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                x = ta[i]
                y = tb[j] * (1 - x)
                z = tc[k] * (1 - x - y)
                pts.append((x, y, z))
                ws.append(wa[i] * wb[j] * wc[k])
    return np.array(pts), np.array(ws)
