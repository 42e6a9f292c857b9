"""Hierarchical sparse-grid density estimation.

Reference: ``sparseGrid`` (sparseGrid.hpp:13-44 — hierarchical sparse-grid
PDF estimator over samples with EvaluatePDF and ComputeAvgL2Error).  Here: a
standard Smolyak construction of hierarchical hat functions on a box; PDF
coefficients solve the dense Galerkin system M c = b with b_i = mean_s
phi_i(x_s) — the L2-projection density estimate.  The basis values at the
samples (in sample chunks), the mass matrix (every pair's exact 1-D overlaps
at once) and the solve run on ``device``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Tuple

import numpy as np
import torch

from .. import resolve_device

# samples (or evaluation points) whose basis values are formed at once
CHUNK = 1 << 16
# 3-point Gauss on [0, 1]: exact for the piecewise quadratic hat products
_G3 = (0.1127016653792583, 0.5, 0.8872983346207417)
_W3 = (5 / 18, 8 / 18, 5 / 18)


def _hat(level, idx, t):
    """Hierarchical hat on [0,1]: level l has odd idx in [1, 2^l - 1],
    support width 2^{1-l}, centered at idx/2^l."""
    h = 0.5 ** level
    c = idx * h
    return torch.clamp(1.0 - torch.abs(t - c) / h, min=0.0)


Levels = List[Tuple[Tuple[int, ...], Tuple[int, ...]]]


def _level_arrays(levels: Levels, device):
    """(nb, dim) level and index tensors of the basis."""
    lv = torch.as_tensor([l for l, _ in levels], dtype=torch.float64,
                         device=device)
    ix = torch.as_tensor([i for _, i in levels], dtype=torch.float64,
                         device=device)
    return lv, ix


def basis_values(levels: Levels, t: torch.Tensor) -> torch.Tensor:
    """Phi[k, s] = prod_d hat(level_kd, idx_kd, t_sd): (nb, n) for unit-box
    points t (n, dim)."""
    lv, ix = _level_arrays(levels, t.device)
    Phi = torch.ones((lv.shape[0], t.shape[0]), dtype=torch.float64,
                     device=t.device)
    for d in range(t.shape[1]):
        Phi = Phi * _hat(lv[:, d:d + 1], ix[:, d:d + 1], t[None, :, d])
    return Phi


@dataclasses.dataclass
class SparseGridPDF:
    bounds: np.ndarray                 # (dim, 2)
    levels: Levels                     # (lvl vec, idx vec) per basis function
    coeff: torch.Tensor                # (nb,) on the fit's device

    def evaluate(self, x) -> torch.Tensor:
        """Density at the points x (n, dim), on the coefficients' device."""
        dev = self.coeff.device
        b = torch.as_tensor(self.bounds, device=dev)
        t = (torch.as_tensor(x, dtype=torch.float64, device=dev) - b[:, 0]
             ) / (b[:, 1] - b[:, 0])
        vals = torch.cat([self.coeff @ basis_values(self.levels,
                                                    t[s:s + CHUNK])
                          for s in range(0, t.shape[0], CHUNK)])
        # scale back to physical density
        return vals / float(np.prod(self.bounds[:, 1] - self.bounds[:, 0]))


def _index_set(dim: int, max_level: int) -> Levels:
    out = []
    for lv in itertools.product(range(1, max_level + 1), repeat=dim):
        if sum(lv) <= max_level + dim - 1:
            for ix in itertools.product(*[range(1, 2 ** l, 2) for l in lv]):
                out.append((lv, ix))
    return out


def _overlap(l1, i1, l2, i2):
    """Exact integrals of pairs of 1-D hats on [0,1] (broadcast tensors):
    3-point Gauss on each linear piece between the sorted knots of the two
    supports (the knots clamped into the common support, so pieces outside
    it have zero length)."""
    h1, h2 = 0.5 ** l1, 0.5 ** l2
    a = torch.maximum((i1 - 1) * h1, (i2 - 1) * h2)
    b = torch.minimum((i1 + 1) * h1, (i2 + 1) * h2)
    knots = torch.stack(torch.broadcast_tensors(
        a, b, i1 * h1, i2 * h2, (i1 - 1) * h1, (i1 + 1) * h1,
        (i2 - 1) * h2, (i2 + 1) * h2), dim=-1)
    knots = torch.minimum(torch.maximum(knots, a[..., None]), b[..., None])
    knots = torch.sort(knots, dim=-1).values
    lo, hi = knots[..., :-1], knots[..., 1:]
    total = torch.zeros_like(lo[..., 0])
    for k in range(lo.shape[-1]):
        lo_k, w = lo[..., k], hi[..., k] - lo[..., k]
        piece = None
        for g, wg in zip(_G3, _W3):
            xs = lo_k + w * g
            term = wg * w * _hat(l1, i1, xs) * _hat(l2, i2, xs)
            piece = term if piece is None else piece + term
        total = total + piece
    return torch.where(b > a, total, torch.zeros_like(total))


def mass_matrix(levels: Levels, device="cuda") -> torch.Tensor:
    """Galerkin mass matrix M[i, j] = int phi_i phi_j on the unit box: the
    product over dimensions of the exact 1-D overlaps, every pair at
    once."""
    device = resolve_device(device)
    lv, ix = _level_arrays(levels, device)
    M = torch.ones((lv.shape[0], lv.shape[0]), dtype=torch.float64,
                   device=device)
    for d in range(lv.shape[1]):
        M = M * _overlap(lv[:, None, d], ix[:, None, d],
                         lv[None, :, d], ix[None, :, d])
    return M


def fit_pdf(samples, max_level: int = 4, bounds=None,
            device="cuda") -> SparseGridPDF:
    """L2-projection sparse-grid density estimate from samples (n, dim);
    the basis values are formed CHUNK samples at a time."""
    device = resolve_device(device)
    samples = torch.as_tensor(samples, dtype=torch.float64, device=device)
    samples = samples.reshape(1, -1) if samples.ndim < 2 else samples
    dim = samples.shape[1]
    if bounds is None:
        lo, hi = samples.min(dim=0).values, samples.max(dim=0).values
        pad = 0.05 * (hi - lo)
        bounds = torch.stack([lo - pad, hi + pad], dim=1).cpu().numpy()
    bounds = np.asarray(bounds, float)
    bt = torch.as_tensor(bounds, device=device)
    levels = _index_set(dim, max_level)
    # b_i = mean over the samples of phi_i
    b = torch.zeros(len(levels), dtype=torch.float64, device=device)
    for s in range(0, samples.shape[0], CHUNK):
        t = (samples[s:s + CHUNK] - bt[:, 0]) / (bt[:, 1] - bt[:, 0])
        b = b + basis_values(levels, t).sum(dim=1)
    b = b / samples.shape[0]
    M = mass_matrix(levels, device)
    c = torch.linalg.solve(
        M + 1e-12 * torch.eye(len(levels), dtype=torch.float64,
                              device=device), b)
    return SparseGridPDF(bounds, levels, c)


def avg_l2_error(pdf: SparseGridPDF, true_pdf, n_mc: int = 20000,
                 rng=None) -> float:
    """Monte-Carlo L2 error of the estimated density vs the true density on
    the sparse grid's box (reference ComputeAvgL2Error); the points come
    from the host generator ``rng`` and ``true_pdf`` takes them as numpy."""
    rng = rng or np.random.default_rng(0)
    dim = pdf.bounds.shape[0]
    x = rng.uniform(pdf.bounds[:, 0], pdf.bounds[:, 1], size=(n_mc, dim))
    diff = pdf.evaluate(x).cpu().numpy() - true_pdf(x)
    vol = np.prod(pdf.bounds[:, 1] - pdf.bounds[:, 0])
    return float(np.sqrt(vol * np.mean(diff ** 2)))
