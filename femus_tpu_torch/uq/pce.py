"""Uncertainty quantification: polynomial chaos expansion tables.

Reference: ``uq`` (uq.hpp:16 — Hermite/Legendre quadrature points :174+,
tensor-product and total-degree multi-index sets ComputeTensorProductSet :42 /
ComputeIndexSet :81, stochastic integral & mass matrices :96-123, multivariate
polynomial evaluations :128-145; global instances FemusInit.cpp:37-38).

Quadrature nodes and multi-index sets are host numpy tables; the polynomial
evaluations, the stochastic mass matrix, the triple-product tensor and the
projection are tensors on ``device``.  Orthonormal probabilists' Hermite
(standard Gaussian weight) and Legendre on [-1, 1] (uniform weight).
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Tuple

import numpy as np
import torch
from numpy.polynomial.hermite_e import hermegauss
from numpy.polynomial.legendre import leggauss

from .. import resolve_device


@functools.lru_cache(maxsize=None)
def quadrature_1d(kind: str, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss points/weights wrt the probability measure: 'hermite' = N(0,1),
    'legendre' = U(-1,1) (host arrays)."""
    if kind == "hermite":
        x, w = hermegauss(n)
        return x, w / w.sum()
    if kind == "legendre":
        x, w = leggauss(n)
        return x, w / 2.0
    raise KeyError(kind)


def polys_1d(kind: str, deg: int, x, device="cuda") -> torch.Tensor:
    """Orthonormal polynomial values: (deg+1, len(x)) on ``device``."""
    device = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float64, device=device)
    rows = []
    prev, cur = torch.zeros_like(x), torch.ones_like(x)
    if kind == "hermite":
        # probabilists' Hermite He_n, orthonormal: He_n / sqrt(n!)
        for n in range(deg + 1):
            rows.append(cur / np.sqrt(float(math.factorial(n)) if n < 171
                                      else np.inf))
            prev, cur = cur, x * cur - n * prev
        return torch.stack(rows)
    if kind == "legendre":
        for n in range(deg + 1):
            rows.append(cur * np.sqrt(2 * n + 1))
            prev, cur = cur, ((2 * n + 1) * x * cur - n * prev) / (n + 1)
        return torch.stack(rows)
    raise KeyError(kind)


def tensor_product_set(dims: int, n_per_dim: int) -> np.ndarray:
    """Full tensor multi-index set (reference ComputeTensorProductSet)."""
    return np.array(list(itertools.product(range(n_per_dim), repeat=dims)), int)


def total_degree_set(dims: int, max_deg: int) -> np.ndarray:
    """Total-degree multi-index set (reference ComputeIndexSet)."""
    return np.array([m for m in itertools.product(range(max_deg + 1), repeat=dims)
                     if sum(m) <= max_deg], int)


def multivariate_polys(kind: str, index_set: np.ndarray, samples,
                       device="cuda") -> torch.Tensor:
    """Psi_k(xi_s): (n_terms, n_samples) for samples (n_samples, dims)."""
    device = resolve_device(device)
    samples = torch.as_tensor(samples, dtype=torch.float64, device=device)
    deg = int(index_set.max())
    idx = torch.as_tensor(index_set, dtype=torch.int64, device=device)
    out = torch.ones((index_set.shape[0], samples.shape[0]),
                     dtype=torch.float64, device=device)
    for d in range(index_set.shape[1]):
        out = out * polys_1d(kind, deg, samples[:, d], device)[idx[:, d]]
    return out


def _tensor_rule(kind: str, dims: int, nq_1d: int):
    """Tensor Gauss points (host) and weights of the probability measure."""
    x, w = quadrature_1d(kind, nq_1d)
    pts = np.array(list(itertools.product(x, repeat=dims)))
    ws = np.prod(np.array(list(itertools.product(w, repeat=dims))), axis=1)
    return pts, ws


def stochastic_mass_matrix(kind: str, index_set: np.ndarray,
                           nq_1d: int, device="cuda") -> torch.Tensor:
    """G[i,j] = E[Psi_i Psi_j] via tensor Gauss quadrature (reference
    stochastic mass matrices, uq.hpp:96-123); identity for exact quadrature
    (orthonormality check)."""
    device = resolve_device(device)
    pts, ws = _tensor_rule(kind, index_set.shape[1], nq_1d)
    P = multivariate_polys(kind, index_set, pts, device)
    return (P * torch.as_tensor(ws, device=device)) @ P.T


def triple_product_tensor(kind: str, index_set: np.ndarray,
                          nq_1d: int, device="cuda") -> torch.Tensor:
    """C[i,j,k] = E[Psi_i Psi_j Psi_k] (stochastic Galerkin coupling), one
    (n_terms, n_terms) slab per i so no (n_terms^2, nq) product is held."""
    device = resolve_device(device)
    pts, ws = _tensor_rule(kind, index_set.shape[1], nq_1d)
    P = multivariate_polys(kind, index_set, pts, device)
    Pw = P * torch.as_tensor(ws, device=device)
    return torch.stack([(P * Pw[i]) @ P.T for i in range(P.shape[0])])


def pce_project(kind: str, index_set: np.ndarray, fn, nq_1d: int,
                device="cuda") -> torch.Tensor:
    """Coefficients c_k = E[f Psi_k] by tensor quadrature; fn(samples) ->
    (nq,), called once on the (nq, dims) float64 points on ``device``."""
    device = resolve_device(device)
    pts, ws = _tensor_rule(kind, index_set.shape[1], nq_1d)
    P = multivariate_polys(kind, index_set, pts, device)
    pts_t = torch.as_tensor(pts, dtype=torch.float64, device=device)
    f = torch.as_tensor(fn(pts_t), dtype=torch.float64, device=device)
    return P @ (torch.as_tensor(ws, device=device) * f)
