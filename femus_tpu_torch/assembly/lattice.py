"""Scatter-free assembly into stencil format for lattice (box) meshes.

The generic assembly scatters ne * ndt^2 element-Jacobian entries into the
ELL array through an index table.  On a structured box mesh the inverse of
that scatter map is affine: with dof lattice id = iy*M + ix and element
grid (ex, ey), local dof i sits at (s*ey + b_i, s*ex + a_i) for family
order s, so the (i, j) Jacobian plane jac[i, j] (reshaped to the element
grid) lands on the stencil slab

    data[k(i,j), b_i + s*ey, a_i + s*ex]  with  k(i,j) = (b_j-b_i, a_j-a_i)

— a STRIDED SLICE ADD per (i, j) pair, done in place on strided views: no
index table, no scatter, and the output is directly the StencilOp the
lattice SpMV consumes (algebra/stencil.py), so the ELL/DIA relayout
disappears too.

Built for single-unknown problems on 2-D quad lattices; everything is
verified on the host at plan-build time and the plan is None when the mesh
is not a lattice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..algebra.stencil import StencilOp


@dataclasses.dataclass
class LatticePlan:
    grid: Tuple[int, int]          # dof lattice (N, M)
    egrid: Tuple[int, int]         # element grid (ney, nex)
    s: int                         # family order (nodes stride per element)
    a: np.ndarray                  # (ndt,) local dof x-offset
    b: np.ndarray                  # (ndt,) local dof y-offset
    offsets: Tuple[Tuple[int, int], ...]   # stencil offsets (di, dj)
    kij: np.ndarray                # (ndt, ndt) -> offset index


def build_lattice_plan(asm) -> Optional[LatticePlan]:
    """Detect the lattice structure of a single-unknown Assembler."""
    if len(asm.unknowns) != 1:
        return None
    mesh = asm.mesh
    if mesh.geom != "quad":
        return None
    dm = asm.dofmaps[asm.unknowns[0].name]
    xy = mesh.coords[dm.nodes]
    xs = np.unique(np.round(xy[:, 0], 12))
    M = len(xs)
    n = dm.n_dofs
    if n % M:
        return None
    N = n // M
    ids = dm.conn                            # (ne, ndt)
    px, py = ids % M, ids // M
    x0, y0 = px.min(axis=1), py.min(axis=1)
    a = px - x0[:, None]
    b = py - y0[:, None]
    if (a != a[0]).any() or (b != b[0]).any():
        return None
    a, b = a[0], b[0]
    s = int(a.max())
    if s == 0 or (x0 % s).any() or (y0 % s).any():
        return None
    ex, ey = x0 // s, y0 // s
    nex, ney = int(ex.max()) + 1, int(ey.max()) + 1
    if nex * ney != mesh.n_elems:
        return None
    # elements must be stored row-major over the element grid so that an
    # element-axis reshape to (ney, nex) IS the element plane
    if (ex != np.tile(np.arange(nex), ney)).any() or \
       (ey != np.repeat(np.arange(ney), nex)).any():
        return None
    ndt = ids.shape[1]
    offs, kij = [], np.zeros((ndt, ndt), np.int32)
    seen = {}
    for i in range(ndt):
        for j in range(ndt):
            o = (int(b[j] - b[i]), int(a[j] - a[i]))
            if o not in seen:
                seen[o] = len(offs)
                offs.append(o)
            kij[i, j] = seen[o]
    return LatticePlan((N, M), (ney, nex), s, a, b, tuple(offs), kij)


def make_lattice_assemble_fn(asm, plan: LatticePlan) -> Callable:
    """(u, tables, aux_scalars=None) -> (R, StencilOp).

    Reuses the engine's batched element residuals and Jacobians
    (``Assembler.element_terms``); replaces both scatters with strided
    slice adds; applies the engine's symmetric Dirichlet elimination
    directly on the stencil slabs, with masks built here, once, on the
    assembler's device."""
    if asm.face_form is not None:
        raise NotImplementedError("lattice assembly: face forms are not "
                                  "supported")
    N, M = plan.grid
    ney, nex = plan.egrid
    s = plan.s
    K = len(plan.offsets)
    ndt = len(plan.a)
    k0 = plan.offsets.index((0, 0))
    dir_mask2 = np.asarray(asm.dirichlet_mask[:N * M]).reshape(N, M)

    def shifted_mask(di, dj):
        """dir_mask2 evaluated at (i+di, j+dj), False outside."""
        z = np.zeros((N + 2 * abs(di), M + 2 * abs(dj)), bool)
        z[abs(di):abs(di) + N, abs(dj):abs(dj) + M] = dir_mask2
        return z[abs(di) + di:abs(di) + di + N,
                 abs(dj) + dj:abs(dj) + dj + M]

    dir2 = torch.as_tensor(dir_mask2, device=asm.device)
    # a weight is eliminated when its row OR its column dof is Dirichlet
    bad = torch.as_tensor(
        np.stack([dir_mask2 | shifted_mask(di, dj)
                  for di, dj in plan.offsets]), device=asm.device)
    spans = [(slice(int(bi), int(bi) + s * ney, s),
              slice(int(ai), int(ai) + s * nex, s))
             for ai, bi in zip(plan.a, plan.b)]

    def assemble(u, tables, aux_scalars=None):
        rT, jacT = asm.element_terms(u, tables, aux_scalars)
        r = rT.view(ndt, ney, nex)
        jac = jacT.view(ndt, ndt, ney, nex)             # [j, i, ey, ex]

        R2 = torch.zeros((N, M), dtype=asm.dtype, device=asm.device)
        for i in range(ndt):
            R2[spans[i]] += r[i]
        R2.masked_fill_(dir2, 0.0)

        data = torch.zeros((K, N, M), dtype=asm.dtype, device=asm.device)
        for i in range(ndt):
            for j in range(ndt):
                data[int(plan.kij[i, j])][spans[i]] += jac[j, i]
        # symmetric Dirichlet elimination on the slabs: zero the weights,
        # then a unit diagonal on the Dirichlet rows
        data.masked_fill_(bad, 0.0)
        data[k0].masked_fill_(dir2, 1.0)
        return R2.reshape(-1), StencilOp(data, plan.offsets, (N, M))

    return assemble
