"""Assembly over mixed element-type meshes: one batched kernel per geometry
block, all feeding ONE union ELL pattern over one global dof numbering
(SURVEY.md §7 hard part 4; reference per-element types, Elem.hpp:45).

Each block gets a standard :class:`Assembler` whose dofmaps were replaced by
the global mixed numbering (mesh/mixed.py), so its residual vector and ELL
pattern already live in the global dof space; the union operator is a
precomputed slot remap (block ELL slot -> union ELL slot) applied as one
``index_add_`` per block.  Dirichlet elimination runs ONCE at the union
level (block-level elimination would double-insert identity diagonals on
shared rows).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..algebra.sparse import SparseOp, pattern_from_pairs
from ..mesh.mixed import MixedMesh, build_global_dofmaps
from .bc import generate_bdc
from .engine import Assembler, Unknown, _build_slot_lut


class MixedAssembler:
    """Residual + Jacobian of one set of unknowns over a :class:`MixedMesh`,
    on ``device`` in ``dtype`` (float64 on the host, float32 on the card by
    default)."""

    def __init__(self, mmesh: MixedMesh, unknowns: Sequence[Unknown],
                 quad_order: str = "fifth",
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.mesh = mmesh
        self.unknowns = list(unknowns)
        # every block must see the global numbering before its pattern is
        # built
        for u in unknowns:
            build_global_dofmaps(mmesh, u.family)
        self.subs: List[Assembler] = [
            Assembler(b, unknowns, quad_order=quad_order, dtype=self.dtype,
                      device=self.device)
            for b in mmesh.blocks]
        s0 = self.subs[0]
        self.offsets: Dict[str, int] = s0.offsets
        self.dofmaps = s0.dofmaps
        self.n_dofs = s0.n_dofs
        assert all(s.n_dofs == self.n_dofs for s in self.subs)

        # union ELL pattern over all blocks' couplings
        rows_all, cols_all = [], []
        for s in self.subs:
            pat = s.pattern
            v = pat.valid.ravel()
            rows_all.append(np.repeat(np.arange(pat.n_rows), pat.width)[v])
            cols_all.append(pat.cols.ravel()[v])
        upat = pattern_from_pairs(np.concatenate(rows_all),
                                  np.concatenate(cols_all),
                                  self.n_dofs, self.n_dofs)
        self.pattern = upat
        lut = _build_slot_lut(upat)
        # block slot -> union slot; a block's padding slots go to one dump
        # slot past the end (index_add_ has no out-of-bounds drop)
        oob = upat.n_rows * upat.width
        self.remaps = []
        for s in self.subs:
            pat = s.pattern
            rr = np.repeat(np.arange(pat.n_rows, dtype=np.int64), pat.width)
            slot = lut(rr, pat.cols.ravel().astype(np.int64))
            slot = np.where(pat.valid.ravel(), slot, oob)
            self.remaps.append(torch.as_tensor(slot, dtype=torch.int64,
                                               device=self.device))
        # block-level elimination off: the union applies it once
        for s in self.subs:
            s.set_dirichlet(np.zeros(s.n_dofs, bool))
        self.set_dirichlet(np.zeros(self.n_dofs, bool))

    # ---- forms --------------------------------------------------------
    def set_volume_form(self, fn: Callable) -> None:
        for s in self.subs:
            s.set_volume_form(fn)

    def add_aux_field(self, name: str, family: str) -> None:
        for s in self.subs:
            s.add_aux_field(name, family)

    @property
    def aux_field_specs(self):
        return self.subs[0].aux_field_specs

    def set_dirichlet(self, mask: np.ndarray,
                      values: Optional[np.ndarray] = None) -> None:
        """Install the union Dirichlet mask/values (global dof numbering)."""
        self.dirichlet_mask = np.asarray(mask[:self.n_dofs], bool).copy()
        self.dirichlet_values = np.zeros(self.n_dofs)
        if values is not None:
            self.dirichlet_values[:] = values[:self.n_dofs]
        self.__dict__.pop("_union_tables", None)

    @functools.cached_property
    def _union_tables(self) -> dict:
        """Device tables of the union-level symmetric elimination: zero
        masked rows/cols, exactly one unit entry on a masked row's diagonal
        (``valid`` excludes the diagonal-pointing padding slots)."""
        pat, mask, dev = self.pattern, self.dirichlet_mask, self.device
        rows = np.arange(pat.n_rows)[:, None]
        return {
            "dir_mask": torch.as_tensor(mask, device=dev),
            "dir_bad": torch.as_tensor(mask[:, None] | mask[pat.cols],
                                       device=dev),
            "dir_ident": torch.as_tensor(
                (pat.cols == rows) & mask[:, None] & pat.valid,
                dtype=self.dtype, device=dev),
            "ell_cols": torch.as_tensor(pat.cols, dtype=torch.int64,
                                        device=dev),
        }

    # ---- assembly -------------------------------------------------------
    def make_assemble_fn(self, with_jacobian: bool = True):
        """(u, aux_scalars=None, aux_fields=None) -> (R, data): each block's
        assembly (global dof ids, no elimination), block data added into
        the union ELL ``data (n_rows, width)`` through its slot remap, then
        the union-level Dirichlet elimination."""
        sub_fns = [s.make_assemble_fn(with_jacobian=with_jacobian,
                                      pass_tables=True) for s in self.subs]
        nr, w = self.pattern.n_rows, self.pattern.width

        def assemble(u, aux_scalars=None, aux_fields=None):
            t = self._union_tables
            R = torch.zeros(self.n_dofs, dtype=self.dtype, device=self.device)
            df = torch.zeros(nr * w + 1, dtype=self.dtype,
                             device=self.device)
            for s, fn, remap in zip(self.subs, sub_fns, self.remaps):
                Rs, Ds = fn(u, s.device_tables_cached(), aux_scalars,
                            aux_fields)
                R = R + Rs
                if with_jacobian:
                    df.index_add_(0, remap, Ds.reshape(-1))
            R = torch.where(t["dir_mask"], 0.0, R)
            if not with_jacobian:
                return R, None
            data = df[:-1].view(nr, w)
            return R, torch.where(t["dir_bad"], t["dir_ident"], data)

        return assemble

    def op_with(self, data: torch.Tensor) -> SparseOp:
        return SparseOp(data, self._union_tables["ell_cols"],
                        self.pattern.n_cols)


def generate_bdc_mixed(masm: MixedAssembler, bc_fn: Callable,
                       time: float = 0.0) -> None:
    """GenerateBdc over a mixed mesh: per-block face sweeps OR-ed into one
    global Dirichlet mask/value set (block faces carry global dof ids)."""
    mask = np.zeros(masm.n_dofs, bool)
    vals = np.zeros(masm.n_dofs)
    for s in masm.subs:
        generate_bdc(s, bc_fn, time=time)
        sel = s.dirichlet_mask
        mask |= sel
        vals[sel] = s.dirichlet_values[sel]
        # restore the block-level no-elimination invariant
        s.set_dirichlet(np.zeros(s.n_dofs, bool))
    masm.set_dirichlet(mask, vals)
