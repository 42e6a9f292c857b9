"""Small-tensor algebra for weak forms in the batched element-last layout.

Quadrature-point tensors in ``ElemOpsBatched`` (assembly/engine.py):
scalars (nq, ne), vectors (nq, dim, ne), matrices (nq, dim, dim, ne).  The
helpers put the matrix axes at positions (1, 2) and broadcast over any
trailing axes; determinants and inverses are explicit adjugate formulas for
dim <= 3, like ``engine._det_inv_batched``.
"""
from __future__ import annotations

import torch


def qp(s):
    """Broadcast a qp-scalar against a qp-vector: (nq[, ne]) -> (nq, 1[, ne])."""
    return s.unsqueeze(1)


def qpm(s):
    """Broadcast a qp-scalar against a qp-matrix: -> (nq, 1, 1[, ne])."""
    return s.unsqueeze(1).unsqueeze(1)


def vdot(a, b):
    """Dot product of qp-vectors over the dim axis: -> qp-scalar."""
    return (a * b).sum(dim=1)


def eye_like(dim: int, T):
    """Identity broadcastable against a qp-matrix T of ndim 3 or 4."""
    return torch.eye(dim, dtype=T.dtype, device=T.device).reshape(
        (1, dim, dim) + (1,) * (T.ndim - 3))


def transpose(F):
    return F.transpose(1, 2)


def matmul(A, B):
    """A @ B over matrix axes (1, 2), broadcasting trailing axes."""
    return torch.einsum("qik...,qkj...->qij...", A, B)


def matTmul(A, B):
    """A^T @ B over matrix axes (1, 2)."""
    return torch.einsum("qki...,qkj...->qij...", A, B)


def matmulT(A, B):
    """A @ B^T over matrix axes (1, 2)."""
    return torch.einsum("qik...,qjk...->qij...", A, B)


def matvec(A, v):
    """A @ v: qp-matrix times qp-vector -> qp-vector."""
    return torch.einsum("qij...,qj...->qi...", A, v)


def trace(F):
    return torch.diagonal(F, dim1=1, dim2=2).sum(dim=-1)


def det(F):
    """Determinant over axes (1, 2) for dim 1/2/3, any trailing axes."""
    d = F.shape[1]
    if d == 1:
        return F[:, 0, 0]
    if d == 2:
        return F[:, 0, 0] * F[:, 1, 1] - F[:, 0, 1] * F[:, 1, 0]
    return (F[:, 0, 0] * (F[:, 1, 1] * F[:, 2, 2] - F[:, 1, 2] * F[:, 2, 1])
            - F[:, 0, 1] * (F[:, 1, 0] * F[:, 2, 2] - F[:, 1, 2] * F[:, 2, 0])
            + F[:, 0, 2] * (F[:, 1, 0] * F[:, 2, 1] - F[:, 1, 1] * F[:, 2, 0]))


def inv(F):
    """Inverse over axes (1, 2) via the adjugate, dim 1/2/3."""
    d = F.shape[1]
    detF = det(F)
    if d == 1:
        return 1.0 / qpm(detF) * torch.ones_like(F)
    if d == 2:
        r0 = torch.stack([F[:, 1, 1], -F[:, 0, 1]], dim=1)
        r1 = torch.stack([-F[:, 1, 0], F[:, 0, 0]], dim=1)
        return torch.stack([r0, r1], dim=1) / qpm(detF)
    c = [[(1, 1, 2, 2, 1, 2, 2, 1), (0, 2, 2, 1, 0, 1, 2, 2), (0, 1, 1, 2, 0, 2, 1, 1)],
         [(1, 2, 2, 0, 1, 0, 2, 2), (0, 0, 2, 2, 0, 2, 2, 0), (0, 2, 1, 0, 0, 0, 1, 2)],
         [(1, 0, 2, 1, 1, 1, 2, 0), (0, 1, 2, 0, 0, 0, 2, 1), (0, 0, 1, 1, 0, 1, 1, 0)]]
    rows = []
    for i in range(3):
        cols = []
        for j in range(3):
            a, b_, cc, dd, e, f, g, h = c[i][j]
            cols.append(F[:, a, b_] * F[:, cc, dd] - F[:, e, f] * F[:, g, h])
        rows.append(torch.stack(cols, dim=1))
    return torch.stack(rows, dim=1) / qpm(detF)
