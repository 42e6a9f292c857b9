"""FE shape functions for all families x geometries.

Replaces the reference's hand-coded per-shape basis classes
(src/02_reference_geom_elements/01_fe, Basis.hpp:41, eval_phi/eval_dphidx at
Basis.hpp:101-216) with a single generic construction: every FE space is the
span of a set of polynomials (rows of a coefficient matrix over a monomial
exponent list); nodal bases are obtained by inverting the node-evaluation
matrix (generalized Vandermonde) once at setup in float64 on host.

The resulting representation — ``exponents (n_mono, dim)`` int array and
``coeff (n_basis, n_mono)`` float array — evaluates with pure array ops, so
the same tables drive host tabulation (numpy, ``xp=np``) and any other array
module passed as ``xp``.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, Sequence, Tuple

import numpy as np

from .geom import GEOMS, GeomElem, LAGRANGE_FAMILIES


@dataclasses.dataclass(frozen=True)
class Basis:
    """Polynomial basis: phi_i(x) = sum_m coeff[i, m] * prod_d x_d^exponents[m, d]."""

    geom: str
    family: str
    exponents: np.ndarray   # (n_mono, dim) int
    coeff: np.ndarray       # (n_basis, n_mono) float64
    nodes: np.ndarray       # (n_basis, dim) dof carrier positions (ref coords)

    @property
    def n_basis(self) -> int:
        return self.coeff.shape[0]

    @property
    def dim(self) -> int:
        return self.exponents.shape[1]

    def eval(self, x, xp=np):
        """phi at points x (..., dim) -> (..., n_basis).  xp: array module."""
        x = xp.asarray(x)
        mono = _monomials(x, self.exponents, xp)           # (..., n_mono)
        return mono @ xp.asarray(self.coeff).T

    def eval_grad(self, x, xp=np):
        """dphi/dx at points x (..., dim) -> (..., n_basis, dim)."""
        x = xp.asarray(x)
        outs = []
        for d in range(self.dim):
            de, dc = _diff_tables(self, d)
            mono = _monomials(x, de, xp)
            outs.append(mono @ xp.asarray(dc).T)
        return xp.stack(outs, axis=-1)

    def eval_hess(self, x, xp=np):
        """d2phi/dx2 -> (..., n_basis, dim, dim)."""
        x = xp.asarray(x)
        rows = []
        for d1 in range(self.dim):
            e1, c1 = _diff_tables(self, d1)
            cols = []
            for d2 in range(self.dim):
                e2, c2 = _diff_raw(e1, c1, d2)
                mono = _monomials(x, e2, xp)
                cols.append(mono @ xp.asarray(c2).T)
            rows.append(xp.stack(cols, axis=-1))
        return xp.stack(rows, axis=-2)


def _monomials(x, exponents, xp):
    # x: (..., dim); exponents: (n_mono, dim) -> (..., n_mono)
    e = xp.asarray(exponents)[(None,) * (x.ndim - 1)]       # broadcast
    xb = x[..., None, :]
    # 0**0 must be 1: exponent arrays are small; use where
    p = xp.where(e == 0, xp.ones_like(xb), xb ** e)
    return xp.prod(p, axis=-1)


def _diff_raw(exponents, coeff, d):
    e = exponents.copy()
    c = coeff * e[None, :, d] if coeff.ndim == 2 else coeff * e[:, d]
    e[:, d] = np.maximum(e[:, d] - 1, 0)
    return e, c


@functools.lru_cache(maxsize=None)
def _diff_cache_key(geom, family, d):
    b = get_basis(geom, family)
    return _diff_raw(b.exponents, b.coeff, d)


def _diff_tables(basis: Basis, d: int):
    return _diff_cache_key(basis.geom, basis.family, d)


# ---------------------------------------------------------------------------
# Monomial span definitions per (geom, family)
# ---------------------------------------------------------------------------

def _tensor_exps(dim: int, deg: int) -> np.ndarray:
    return np.array(list(itertools.product(range(deg + 1), repeat=dim)), int)


def _simplex_exps(dim: int, deg: int) -> np.ndarray:
    return np.array([e for e in itertools.product(range(deg + 1), repeat=dim)
                     if sum(e) <= deg], int)


def _span(geom: str, family: str) -> np.ndarray:
    """Monomial exponent list defining the polynomial space."""
    if family == "disc_constant":
        return np.zeros((1, GEOMS[geom].dim), int)
    if family == "disc_linear":
        d = GEOMS[geom].dim
        return np.vstack([np.zeros((1, d), int), np.eye(d, dtype=int)])

    if geom == "edge":
        return _tensor_exps(1, 1 if family == "linear" else 2)
    if geom == "quad":
        if family == "linear":
            return _tensor_exps(2, 1)
        full = _tensor_exps(2, 2)
        if family == "biquadratic":
            return full
        # serendipity quad8: drop x^2 y^2
        return np.array([e for e in full.tolist() if e != [2, 2]], int)
    if geom == "hex":
        if family == "linear":
            return _tensor_exps(3, 1)
        if family == "biquadratic":
            return _tensor_exps(3, 2)
        # serendipity hex20: trilinear + {x^2,y^2,z^2} x linear-in-others
        exps = _tensor_exps(3, 1).tolist()
        for d in range(3):
            for o in itertools.product(range(2), repeat=2):
                e = [0, 0, 0]
                e[d] = 2
                rest = [i for i in range(3) if i != d]
                e[rest[0]], e[rest[1]] = o
                exps.append(e)
        return np.array(exps, int)
    if geom == "tri":
        if family == "linear":
            return _simplex_exps(2, 1)
        if family == "serendipity":
            return _simplex_exps(2, 2)
        # tri7: P2 + cubic bubble x*y*(1-x-y); span with one cubic monomial
        # chosen so the node-eval matrix stays invertible; use symmetric pair
        # via generator matrix below (handled in _generators).
        return np.vstack([_simplex_exps(2, 2), np.array([[2, 1], [1, 2]], int)])
    if geom == "tet":
        return _simplex_exps(3, 1 if family == "linear" else 2)
    if geom == "wedge":
        if family == "linear":
            exps = [(a, b, c) for (a, b) in _simplex_exps(2, 1).tolist() for c in range(2)]
            return np.array(exps, int)
        if family == "biquadratic":
            exps = [(a, b, c) for (a, b) in _simplex_exps(2, 2).tolist() for c in range(3)]
            return np.array(exps, int)
        # serendipity wedge15: standard space = span of the 18 tensor monomials
        # minus the 3 quad-face bubbles; generators built in _generators.
        exps = [(a, b, c) for (a, b) in _simplex_exps(2, 2).tolist() for c in range(3)]
        return np.array(exps, int)
    raise KeyError((geom, family))


def _generators(geom: str, family: str) -> Tuple[np.ndarray, np.ndarray]:
    """(exponents, G) with G (n_gen, n_mono): generating polynomials of the space."""
    exps = _span(geom, family)
    n = len(exps)
    if geom == "tri" and family == "biquadratic":
        # 6 P2 monomials as-is + the symmetric cubic bubble xy - x^2 y - x y^2
        G = np.zeros((7, n))
        for i in range(6):
            G[i, i] = 1.0
        idx = {tuple(e): k for k, e in enumerate(exps.tolist())}
        G[6, idx[(1, 1)]] = 1.0
        G[6, idx[(2, 1)]] = -1.0
        G[6, idx[(1, 2)]] = -1.0
        return exps, G
    if geom == "wedge" and family == "serendipity":
        # start from 18 tensor monomials, remove the 3 quad-face bubble dofs by
        # selecting the 15-dim subspace spanned by serendipity node functionals:
        # take monomials m(x,y)*p(z) with (deg_xy, deg_z) != (2,2)-type bubbles.
        # Standard wedge15 space: span{ tri6(x,y) x {1,z} } + span{ tri3(x,y) x {z^2} }
        keep = []
        for k, (a, b, c) in enumerate(exps.tolist()):
            if c <= 1:
                keep.append(k)            # tri6 x {1, z}: 12
            elif a + b <= 1:
                keep.append(k)            # tri3 x z^2: 3
        G = np.zeros((len(keep), n))
        for i, k in enumerate(keep):
            G[i, k] = 1.0
        return exps, G
    G = np.eye(n)
    return exps, G


def _nodes(geom: str, family: str) -> np.ndarray:
    g = GEOMS[geom]
    if family == "disc_constant":
        return g.center[None, :]
    if family == "disc_linear":
        # coefficient dofs; carriers: centroid (value) + axis points (formal)
        return np.vstack([g.center[None, :]] * (1 + g.dim))
    return g.ref_nodes[g.family_nodes[family]]


@functools.lru_cache(maxsize=None)
def get_basis(geom: str, family: str) -> Basis:
    """Build (and cache) the nodal basis for (geom, family)."""
    exps, G = _generators(geom, family)
    nodes = _nodes(geom, family)
    if family == "disc_constant":
        coeff = np.ones((1, 1))
        return Basis(geom, family, exps, coeff, nodes)
    if family == "disc_linear":
        # coefficient basis: phi_0 = 1, phi_d = x_d (not interpolatory)
        coeff = np.eye(1 + GEOMS[geom].dim)
        return Basis(geom, family, exps, coeff, nodes)
    # node-evaluation matrix over generators
    mono = _monomials(nodes, exps, np)          # (n_nodes, n_mono)
    E = mono @ G.T                              # (n_nodes, n_gen)
    assert E.shape[0] == E.shape[1], (geom, family, E.shape)
    cond = np.linalg.cond(E)
    assert cond < 1e8, f"singular nodal basis for {geom}/{family}: cond={cond:.2e}"
    # phi_j = sum_k C[k, j] g_k with phi_j(node_i) = delta_ij  =>  E C = I.
    M = np.linalg.inv(E).T @ G                  # (n_basis, n_mono)
    # verify
    chk = mono @ M.T
    assert np.allclose(chk, np.eye(len(nodes)), atol=1e-9), (geom, family)
    return Basis(geom, family, exps, M, nodes)


def all_bases():
    out = {}
    for gname, g in GEOMS.items():
        for fam in ("linear", "serendipity", "biquadratic", "disc_constant", "disc_linear"):
            out[(gname, fam)] = get_basis(gname, fam)
    return out
