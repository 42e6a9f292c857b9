"""Batched element assembly engine (element-last layout).

One pass over all elements of a mesh level:

  gather element dof slabs  ->  batched quadrature contraction of the weak
  form (element axis last)  ->  forward-mode AD over the ``ndt`` element
  basis tangents for the element Jacobians (``torch.func.jvp`` under
  ``torch.func.vmap``; exact, because element residuals are local)  ->
  ``index_add_`` scatter into the ELL value array + residual.

Block layout: unknowns are stacked into one global dof vector with static
per-variable offsets (KKoffset); ``interleave=True`` permutes the stacked
index space node-major (``stack_perm``) so the assembled pattern is banded
for the blocked-ELL matvec with no per-matvec permutes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..algebra.sparse import EllPattern, SparseOp, pattern_from_pairs
from ..fe.geom import GEOMS
from ..fe.quadrature import gauss
from ..fe.tabulate import tabulate

GEO_FAMILY = "biquadratic"   # isoparametric geometry representation


@dataclasses.dataclass(frozen=True)
class Unknown:
    """A scalar unknown field: name + FE family."""
    name: str
    family: str = "biquadratic"


def _det_inv_batched(J):
    """Determinant and inverse of J[q, a, b, e] over the (a, b) axes for
    dim 1/2/3 — explicit adjugate, element axis stays last."""
    d = J.shape[1]
    if d == 1:
        det = J[:, 0, 0]
        return det, 1.0 / det[:, None, None]
    if d == 2:
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        row0 = torch.stack([J[:, 1, 1], -J[:, 0, 1]], dim=1)
        row1 = torch.stack([-J[:, 1, 0], J[:, 0, 0]], dim=1)
        return det, torch.stack([row0, row1], dim=1) / det[:, None, None]
    c00 = J[:, 1, 1] * J[:, 2, 2] - J[:, 1, 2] * J[:, 2, 1]
    c01 = J[:, 1, 2] * J[:, 2, 0] - J[:, 1, 0] * J[:, 2, 2]
    c02 = J[:, 1, 0] * J[:, 2, 1] - J[:, 1, 1] * J[:, 2, 0]
    det = J[:, 0, 0] * c00 + J[:, 0, 1] * c01 + J[:, 0, 2] * c02
    c10 = J[:, 0, 2] * J[:, 2, 1] - J[:, 0, 1] * J[:, 2, 2]
    c11 = J[:, 0, 0] * J[:, 2, 2] - J[:, 0, 2] * J[:, 2, 0]
    c12 = J[:, 0, 1] * J[:, 2, 0] - J[:, 0, 0] * J[:, 2, 1]
    c20 = J[:, 0, 1] * J[:, 1, 2] - J[:, 0, 2] * J[:, 1, 1]
    c21 = J[:, 0, 2] * J[:, 1, 0] - J[:, 0, 0] * J[:, 1, 2]
    c22 = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    adjT = torch.stack([torch.stack([c00, c10, c20], dim=1),
                        torch.stack([c01, c11, c21], dim=1),
                        torch.stack([c02, c12, c22], dim=1)], dim=1)
    return det, adjT / det[:, None, None]


class ElemOpsBatched:
    """Quadrature operations over all elements, element axis LAST.

    Scalars at quadrature points are (nq, ne); element-local dof vectors
    are (nd, ne); ``aux['group']`` is (ne,)."""

    def __init__(self, tabs, weights, coords, dim):
        # coords: (nd_geo, sdim, ne)
        self.dim = dim
        gphi, gdphi = tabs[GEO_FAMILY]
        if coords.shape[1] != dim:
            raise NotImplementedError("embedded-manifold geometry is not "
                                      "ported")
        # centre per element before contracting: sum_n dphi = 0, so J is
        # unchanged while the operands shrink from absolute-coordinate to
        # element-size scale (with full-f32 matmuls, set in the package
        # __init__, this keeps determinants sign-accurate on fine meshes)
        cmean = coords.mean(dim=0, keepdim=True)
        J = torch.einsum("qnd,nxe->qdxe", gdphi, coords - cmean)
        self.x = torch.einsum("qn,nxe->qxe", gphi, coords)  # (nq, sdim, ne)
        self._phi = {f: t[0] for f, t in tabs.items()}
        detJ, invJ = _det_inv_batched(J)                   # invJ[q, x, d, e]
        self.wdet = weights[:, None] * detJ.abs()          # (nq, ne)
        self._dphi = {f: torch.einsum("qnd,qxde->qnxe", t[1], invJ)
                      for f, t in tabs.items()}

    def value(self, fam: str, u: torch.Tensor) -> torch.Tensor:
        """u: (nd, ne) -> (nq, ne)."""
        return torch.einsum("qn,ne->qe", self._phi[fam], u)

    def grad(self, fam: str, u: torch.Tensor) -> torch.Tensor:
        """u: (nd, ne) -> (nq, dim, ne)."""
        return torch.einsum("qnxe,ne->qxe", self._dphi[fam], u)

    def pointwise(self, fn: Callable) -> torch.Tensor:
        """Call ``fn`` on the flat (nq*ne, sdim) quadrature points and
        restore the element axis last: (nq, ..., ne)."""
        nq, sdim, ne = self.x.shape
        out = fn(self.x.permute(0, 2, 1).reshape(nq * ne, sdim))
        out = out.reshape((nq, ne) + tuple(out.shape[1:]))
        return out.movedim(1, -1)

    def t(self, fam: str, s: torch.Tensor) -> torch.Tensor:
        """s: (nq, ne) -> (nd, ne)."""
        return torch.einsum("qn,qe->ne", self._phi[fam], self.wdet * s)

    def tgrad(self, fam: str, v: torch.Tensor) -> torch.Tensor:
        """v: (nq, dim, ne) -> (nd, ne)."""
        return torch.einsum("qnxe,qxe->ne", self._dphi[fam],
                            v * self.wdet[:, None])

    def tgrad_d(self, fam: str, s: torch.Tensor, d: int) -> torch.Tensor:
        return torch.einsum("qne,qe->ne", self._dphi[fam][:, :, d],
                            s * self.wdet)


class Assembler:
    """Assembles residual + Jacobian for a set of unknowns on one mesh level,
    with tensors on ``device`` in ``dtype`` (default float64 on the host,
    float32 on the card)."""

    def __init__(self, mesh, unknowns: Sequence[Unknown], quad_order="fifth",
                 dtype: Optional[torch.dtype] = None,
                 interleave: bool = False, device="cuda"):
        """interleave=True replaces the slab-major stacked layout with a
        NODE-MAJOR one: the physical position of logical dof (var k, idx i)
        follows the mesh entity it lives on (node for Lagrange families,
        owning element's last node for element-wise families), so coupled
        variables of one node sit adjacent and the pattern is banded when
        the mesh numbering is local.  Offsets stay the LOGICAL interface;
        ``stack_perm`` (logical -> physical) is applied once here."""
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.mesh = mesh
        self.unknowns = list(unknowns)
        self.dim = mesh.dim
        # ---- block layout (KKoffset analogue) --------------------------
        self.dofmaps = {u.name: mesh.dofmap(u.family) for u in unknowns}
        self.offsets: Dict[str, int] = {}
        off = 0
        for u in unknowns:
            self.offsets[u.name] = off
            off += self.dofmaps[u.name].n_dofs
        self.n_dofs = off
        parts = []
        self.local_slices: Dict[str, slice] = {}
        loc = 0
        for u in unknowns:
            dm = self.dofmaps[u.name]
            parts.append(dm.conn + self.offsets[u.name])
            self.local_slices[u.name] = slice(loc, loc + dm.conn.shape[1])
            loc += dm.conn.shape[1]
        self.ndt = loc
        self.edofs = np.concatenate(parts, axis=1).astype(np.int32)
        self.stack_perm = None
        if interleave and len(unknowns) > 1:
            keys = np.empty(self.n_dofs, np.int64)
            for u in unknowns:
                dm = self.dofmaps[u.name]
                off = self.offsets[u.name]
                nodes = np.asarray(dm.nodes)
                if (nodes >= 0).all():
                    keys[off:off + dm.n_dofs] = 2 * nodes.astype(np.int64)
                else:
                    # element-wise dofs anchor after their element's last node
                    npp = dm.n_dofs // mesh.n_elems
                    anchor = mesh.conn.max(axis=1).astype(np.int64)
                    keys[off:off + dm.n_dofs] = 2 * np.repeat(anchor, npp) + 1
            order = np.argsort(keys, kind="stable")   # logical, phys-ordered
            sp_ = np.empty(self.n_dofs, np.int64)
            sp_[order] = np.arange(self.n_dofs)
            self.stack_perm = sp_.astype(np.int32)
            self.edofs = self.stack_perm[self.edofs]
        # ---- sparsity pattern + ELL slots ------------------------------
        ne = mesh.n_elems
        rows = np.repeat(self.edofs, self.ndt, axis=1).ravel()
        cols = np.tile(self.edofs, (1, self.ndt)).ravel()
        self.pattern = pattern_from_pairs(rows, cols, self.n_dofs, self.n_dofs)
        lut = _build_slot_lut(self.pattern)
        self.slots = lut(rows, cols).reshape(ne, self.ndt, self.ndt)
        # ---- tabulations ------------------------------------------------
        self.quad_order = quad_order
        fams = {GEO_FAMILY} | {u.family for u in unknowns}
        _, w = gauss(mesh.geom, quad_order)
        self.tabs_np = {f: (tabulate(mesh.geom, f, quad_order).phi,
                            tabulate(mesh.geom, f, quad_order).dphi)
                        for f in fams}
        self.qweights_np = np.asarray(w)
        self.geo_conn = mesh.conn[:, GEOMS[mesh.geom].family_nodes[GEO_FAMILY]]
        self.coords_e = mesh.coords[self.geo_conn]   # (ne, nd_geo, sdim)
        # ---- Dirichlet bookkeeping (set by the systems layer) -----------
        self.dirichlet_mask = np.zeros(self.n_dofs, bool)
        self.dirichlet_values = np.zeros(self.n_dofs)
        self.volume_form: Optional[Callable] = None
        self._tables_cache = None

    # ------------------------------------------------------------------
    def set_dirichlet(self, mask: np.ndarray,
                      values: Optional[np.ndarray] = None) -> None:
        """Install Dirichlet mask/values (LOGICAL offsets layout); with an
        interleaved layout they are permuted into the physical frame."""
        m = np.zeros(self.n_dofs, bool)
        v = np.zeros(self.n_dofs)
        idx = (self.stack_perm if self.stack_perm is not None
               else np.arange(self.n_dofs))
        m[idx] = mask[:self.n_dofs]
        if values is not None:
            v[idx] = values[:self.n_dofs]
        self.dirichlet_mask = m
        self.dirichlet_values = v
        self._tables_cache = None

    def set_volume_form(self, fn: Callable) -> None:
        """fn(ops: ElemOpsBatched, u: dict, aux: dict) -> dict name -> (nd, ne)."""
        self.volume_form = fn

    def _split(self, u_flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {u.name: u_flat[self.local_slices[u.name]] for u in self.unknowns}

    # ------------------------------------------------------------------
    def device_tables_cached(self) -> dict:
        """device_tables() with caching; invalidated by set_dirichlet."""
        if self._tables_cache is None:
            self._tables_cache = self.device_tables()
        return self._tables_cache

    def device_tables(self) -> dict:
        """All arrays the assembly reads, as tensors on the device."""
        dev, dt = self.device, self.dtype

        def i64(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

        def flt(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        pat = self.pattern
        mask = self.dirichlet_mask
        rows = np.arange(pat.n_rows)[:, None]
        # symmetric Dirichlet elimination: zero masked rows/cols, exactly
        # one unit entry on the diagonal of a masked row (ell_valid excludes
        # the diagonal-pointing padding slots)
        bad = mask[:, None] | mask[pat.cols]
        ident = (pat.cols == rows) & mask[:, None] & pat.valid
        t = {
            "elem_group": i64(self.mesh.elem_group),
            "edofs": i64(self.edofs),
            "slots": i64(self.slots.reshape(-1)),
            "coords_e": flt(self.coords_e),
            "dir_mask": torch.as_tensor(mask, device=dev),
            "dir_bad": torch.as_tensor(bad, device=dev),
            "dir_ident": flt(ident),
            "ell_cols": i64(pat.cols),
            "tabs": {f: (flt(p), flt(d)) for f, (p, d) in self.tabs_np.items()},
            "qweights": flt(self.qweights_np),
        }
        return t

    def make_assemble_fn(self, with_jacobian: bool = True,
                         pass_tables: bool = False):
        """Assembly function.

        pass_tables=False: (u, aux_scalars) -> (R, data) with the tables
        built once and closed over.
        pass_tables=True: (u, tables, aux_scalars) -> (R, data) with tables
        supplied per call.  ``aux_scalars`` (e.g. ``nu``) reach the form's
        ``aux`` dict.

        The volume form runs once over all elements through
        :class:`ElemOpsBatched`; the Jacobian is the forward derivative of
        the element residuals along the ``ndt`` unit tangents."""
        nrows, w = self.pattern.n_rows, self.pattern.width
        const_tables = None if pass_tables else self.device_tables()

        def assemble_t(u, tables, aux_scalars=None):
            aux = dict(aux_scalars or {})
            u = u.to(device=self.device, dtype=self.dtype)
            u_locT = u[tables["edofs"]].T                    # (ndt, ne)
            ne = u_locT.shape[1]
            aux["group"] = tables["elem_group"]
            ops = ElemOpsBatched(tables["tabs"], tables["qweights"],
                                 tables["coords_e"].permute(1, 2, 0),
                                 self.dim)

            def all_elems(ulT):
                out = self.volume_form(ops, self._split(ulT), aux)
                parts = []
                for un in self.unknowns:
                    r = out.get(un.name)
                    if r is None:      # forms may omit rows (zeros)
                        sl = self.local_slices[un.name]
                        r = ulT.new_zeros((sl.stop - sl.start, ne))
                    parts.append(r)
                return torch.cat(parts)

            rT = all_elems(u_locT)                           # (ndt, ne)
            R = torch.zeros(self.n_dofs, dtype=self.dtype, device=self.device)
            R.index_add_(0, tables["edofs"].reshape(-1), rT.T.reshape(-1))
            R = torch.where(tables["dir_mask"], 0.0, R)
            if not with_jacobian:
                return R, None
            eye = torch.eye(self.ndt, dtype=self.dtype, device=self.device)
            tang = eye[:, :, None].expand(self.ndt, self.ndt, ne)
            jacT = torch.func.vmap(
                lambda tg: torch.func.jvp(all_elems, (u_locT,), (tg,))[1]
            )(tang)                                   # (ndt_j, ndt_i, ne)
            data = torch.zeros(nrows * w, dtype=self.dtype, device=self.device)
            data.index_add_(0, tables["slots"],
                            jacT.permute(2, 1, 0).reshape(-1))
            data = data.view(nrows, w)
            data = torch.where(tables["dir_bad"], tables["dir_ident"], data)
            return R, data

        if pass_tables:
            return assemble_t

        def assemble(u, aux_scalars=None):
            return assemble_t(u, const_tables, aux_scalars)

        return assemble

    def op_with(self, data: torch.Tensor, cols: torch.Tensor = None) -> SparseOp:
        """Wrap assembled ELL data as a device operator (``cols``: the
        tables' ``ell_cols``, uploaded once)."""
        if cols is None:
            cols = torch.as_tensor(self.pattern.cols, dtype=torch.int64,
                                   device=data.device)
        return SparseOp(data, cols, self.pattern.n_cols)


def _build_slot_lut(pattern: EllPattern):
    """Return lut(rows, cols) -> flat ELL slot index.

    CSR entries sorted by (row, col) form a globally sorted key sequence, so a
    single searchsorted resolves every query; the ELL slot is then
    row * width + within-row position."""
    counts = np.diff(pattern.indptr)
    csr_rows = np.repeat(np.arange(pattern.n_rows, dtype=np.int64), counts)
    csr_keys = csr_rows * pattern.n_cols + pattern.indices
    ell_slots = pattern.csr_to_ell_slots()

    def lut(rows, cols):
        keys = rows.astype(np.int64) * pattern.n_cols + cols.astype(np.int64)
        pos = np.searchsorted(csr_keys, keys)
        assert np.all(csr_keys[pos] == keys), "query pair outside pattern"
        return ell_slots[pos]

    return lut
