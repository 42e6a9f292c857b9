"""Batched element assembly engine.

One pass over all elements of a mesh level:

  gather element dof slabs  ->  batched quadrature contraction of the weak
  form (element axis last)  ->  forward-mode AD over the ``ndt`` element
  basis tangents for the element Jacobians (``torch.func.jvp`` under
  ``torch.func.vmap``; exact, because element residuals are local)  ->
  ``index_add_`` scatter into the ELL value array + residual.

A form written per element sets ``form.layout = "batch_first"``: it then
runs through :class:`ElemOps` under ``torch.func.vmap`` over the elements,
with ``vmap(jacfwd(...))`` for the element Jacobians.  Meshes embedded in a
higher-dimensional space (surface FE, ``mesh.generation.map_to_surface``)
integrate with the first fundamental form in either layout.

Block layout: unknowns are stacked into one global dof vector with static
per-variable offsets (KKoffset); ``interleave=True`` permutes the stacked
index space node-major (``stack_perm``) so the assembled pattern is banded
for the blocked-ELL matvec with no per-matvec permutes.

Matrix layouts: ELL by default (the pattern is built on first use);
``set_patch_layout`` sends the Jacobian straight into the patch-stencil
weights instead (algebra/patchstencil.py), and then no ELL pattern is built.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..algebra.patchstencil import (K, apply_dirichlet, build_patch_slots,
                                    build_patch_tables, dirichlet_masks,
                                    make_block_patch_op, make_patch_op,
                                    patch_meta, patch_routing)
from ..algebra.patchstencil3d import (K3, PatchTables3D,
                                      build_patch_slots_3d,
                                      build_patch_tables_3d,
                                      dirichlet_masks_3d, make_patch_op_3d,
                                      patch_routing_3d)
from ..mesh.patches3d import PatchPlan3D
from ..algebra.sparse import (EllPattern, SparseOp, op_from_pattern,
                              pattern_from_pairs)
from ..fe.geom import GEOMS
from ..fe.quadrature import gauss
from ..fe.basis import get_basis
from ..fe.tabulate import face_trace_nodes, tabulate
from ..utils.telemetry import count, span

GEO_FAMILY = "biquadratic"   # isoparametric geometry representation


@dataclasses.dataclass(frozen=True)
class Unknown:
    """A scalar unknown field: name + FE family."""
    name: str
    family: str = "biquadratic"


def _det_inv_batched(J):
    """Determinant and inverse of J[q, a, b, ...] over the (a, b) axes for
    dim 1/2/3 — explicit adjugate, any trailing (element) axes stay last."""
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


def _element_geometry(gdphi, weights, coords):
    """(wdet, M) of the geometric map of ``coords`` (nd_geo, sdim[, ne]):
    the quadrature weights times the volume element (nq[, ne]) and the map
    M[q, d, x[, e]] taking reference derivatives to physical gradients,
    dphi[q, n, x] = dphi_ref[q, n, d] M[q, d, x].  On an embedded manifold
    (sdim > dim: surface or curve FE) the first fundamental form G = J J^T
    gives the area element sqrt(det G) and the tangential gradients
    M = G^-1 J in ambient coordinates.  The coordinates are centred per
    element before contracting: sum_n dphi = 0, so J is unchanged while the
    operands shrink from absolute-coordinate to element-size scale (with
    full-f32 matmuls, set in the package __init__, this keeps determinants
    sign-accurate on fine meshes)."""
    # J[q, d, x] = dx_x / dxi_d  (d: reference, x: ambient)
    J = torch.einsum("qnd,nx...->qdx...", gdphi,
                     coords - coords.mean(dim=0, keepdim=True))
    w = weights.reshape((-1,) + (1,) * (coords.ndim - 2))
    if J.shape[1] == J.shape[2]:
        det, inv = _det_inv_batched(J)                # inv[q, x, d, ...]
        return w * det.abs(), inv.transpose(1, 2)
    G = torch.einsum("qdx...,qbx...->qdb...", J, J)
    detG, invG = _det_inv_batched(G)
    return (w * torch.sqrt(detG),
            torch.einsum("qdb...,qbx...->qdx...", invG, J))


class ElemOpsBatched:
    """Quadrature operations over all elements, element axis LAST.

    Scalars at quadrature points are (nq, ne); element-local dof vectors
    are (nd, ne); ``aux['group']`` is (ne,).  ``coords`` (nd_geo, sdim, ne)
    may be embedded (sdim > dim): gradients are then tangential, (nq, sdim,
    ne)."""

    def __init__(self, tabs, weights, coords, dim):
        self.dim = dim
        self._tabs, self._weights, self.coords = tabs, weights, coords
        gphi, gdphi = tabs[GEO_FAMILY]
        self.x = torch.einsum("qn,nxe->qxe", gphi, coords)  # (nq, sdim, ne)
        self._phi = {f: t[0] for f, t in tabs.items()}
        self.wdet, M = _element_geometry(gdphi, weights, coords)  # (nq, ne)
        self._dphi = {f: torch.einsum("qnd,qdxe->qnxe", t[1], M)
                      for f, t in tabs.items()}

    def moved(self, disp_nodes: torch.Tensor) -> "ElemOpsBatched":
        """The same operations on the configuration displaced by
        ``disp_nodes`` (nd_geo, dim, ne).  Called inside a form, the
        geometry is rebuilt inside the function the engine differentiates,
        so the Jacobian carries the shape derivatives."""
        return ElemOpsBatched(self._tabs, self._weights,
                              self.coords + disp_nodes, self.dim)

    # ---- raw tabulations (metric-based surface forms) --------------------
    @property
    def qweights(self) -> torch.Tensor:
        """Raw quadrature weights (no geometric Jacobian): (nq,)."""
        return self._weights

    def phi(self, fam: str) -> torch.Tensor:
        """Shape functions at the quadrature points: (nq, nd)."""
        return self._phi[fam]

    def dphi(self, fam: str) -> torch.Tensor:
        """Physical gradients: (nq, nd, sdim, ne)."""
        return self._dphi[fam]

    def dphi_ref(self, fam: str) -> torch.Tensor:
        """Reference-frame derivatives d(phi)/d(xi): (nq, nd, dim)."""
        return self._tabs[fam][1]

    def value(self, fam: str, u: torch.Tensor) -> torch.Tensor:
        """u: (nd, ne) -> (nq, ne)."""
        return torch.einsum("qn,ne->qe", self._phi[fam], u)

    def grad(self, fam: str, u: torch.Tensor) -> torch.Tensor:
        """u: (nd, ne) -> (nq, sdim, ne)."""
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
        """v: (nq, sdim, ne) -> (nd, ne)."""
        return torch.einsum("qnxe,qxe->ne", self._dphi[fam],
                            v * self.wdet[:, None])

    def tgrad_d(self, fam: str, s: torch.Tensor, d: int) -> torch.Tensor:
        return torch.einsum("qne,qe->ne", self._dphi[fam][:, :, d],
                            s * self.wdet)


class ElemOps:
    """Quadrature operations of ONE element: the batch-first layout, built
    inside ``torch.func.vmap`` over the elements, for forms written against
    per-element semantics (``fn.layout = "batch_first"``, e.g. an energy
    differentiated per element).  Scalars at quadrature points are (nq,),
    element-local dof vectors (nd,), ``coords`` (nd_geo, sdim) and ``x``
    (nq, sdim); the same method surface as :class:`ElemOpsBatched`."""

    def __init__(self, tabs, weights, coords, dim):
        self.dim = dim
        self._tabs, self._weights, self.coords = tabs, weights, coords
        gphi, gdphi = tabs[GEO_FAMILY]
        self.x = gphi @ coords                             # (nq, sdim)
        self._phi = {f: t[0] for f, t in tabs.items()}
        self.wdet, M = _element_geometry(gdphi, weights, coords)  # (nq,)
        self._dphi = {f: torch.einsum("qnd,qdx->qnx", t[1], M)
                      for f, t in tabs.items()}

    def moved(self, disp_nodes: torch.Tensor) -> "ElemOps":
        """The operations on the configuration displaced by ``disp_nodes``
        (nd_geo, dim), rebuilt inside the differentiated function."""
        return ElemOps(self._tabs, self._weights, self.coords + disp_nodes,
                       self.dim)

    @property
    def qweights(self) -> torch.Tensor:
        """Raw quadrature weights (no geometric Jacobian): (nq,)."""
        return self._weights

    def phi(self, fam: str) -> torch.Tensor:
        """Shape functions at the quadrature points: (nq, nd)."""
        return self._phi[fam]

    def dphi(self, fam: str) -> torch.Tensor:
        """Physical gradients: (nq, nd, sdim)."""
        return self._dphi[fam]

    def dphi_ref(self, fam: str) -> torch.Tensor:
        """Reference-frame derivatives d(phi)/d(xi): (nq, nd, dim)."""
        return self._tabs[fam][1]

    def value(self, fam: str, u: torch.Tensor) -> torch.Tensor:
        """u: (nd,) -> (nq,)."""
        return self._phi[fam] @ u

    def grad(self, fam: str, u: torch.Tensor) -> torch.Tensor:
        """u: (nd,) -> (nq, sdim)."""
        return torch.einsum("qnx,n->qx", self._dphi[fam], u)

    def pointwise(self, fn: Callable) -> torch.Tensor:
        """``fn`` on this element's (nq, sdim) quadrature points."""
        return fn(self.x)

    def t(self, fam: str, s: torch.Tensor) -> torch.Tensor:
        """integral s * phi_i   (s: (nq,)) -> (nd,)."""
        return self._phi[fam].T @ (self.wdet * s)

    def tgrad(self, fam: str, v: torch.Tensor) -> torch.Tensor:
        """integral v . grad phi_i   (v: (nq, sdim)) -> (nd,)."""
        return torch.einsum("qnx,qx,q->n", self._dphi[fam], v, self.wdet)

    def tgrad_d(self, fam: str, s: torch.Tensor, d: int) -> torch.Tensor:
        """integral s * d(phi_i)/dx_d   (s: (nq,)) -> (nd,)."""
        return torch.einsum("qn,q,q->n", self._dphi[fam][:, :, d], s,
                            self.wdet)


def _face_geometry(gdphi, weights, coords, dim):
    """(unit outward normal (nq, dim), weights x surface measure (nq,)) of
    one boundary face from its geometry-trace node coordinates (the face's
    tangents; the trace's node order makes the normal point out)."""
    T = torch.einsum("qnd,nx->qdx", gdphi, coords - coords.mean(dim=0))
    if dim == 2:
        t = T[:, 0, :]
        ds = torch.linalg.norm(t, dim=-1)
        n = torch.stack([t[:, 1], -t[:, 0]], dim=-1) / ds[:, None]
    elif dim == 3:
        cr = torch.linalg.cross(T[:, 0, :], T[:, 1, :])
        ds = torch.linalg.norm(cr, dim=-1)
        n = cr / ds[:, None]
    else:
        ds = torch.ones_like(weights)
        n = torch.ones_like(weights)[:, None]
    return n, weights * ds


class FaceOps:
    """Per-boundary-face quadrature operations (surface integrals; analogue
    of the reference's JacobianSur, ElemType.hpp:330-360).  Built inside
    ``torch.func.vmap`` over the faces of a batch, so every array is one
    face's: ``x`` (nq, dim), ``normal`` (nq, dim), ``wds`` (nq,)."""

    def __init__(self, tabs, weights, coords, dim, sign):
        gphi, gdphi = tabs[GEO_FAMILY]
        self.x = gphi @ coords                            # (nq, dim)
        n, self.wds = _face_geometry(gdphi, weights, coords, dim)
        self.normal = n * sign
        self._phi = {f: t[0] for f, t in tabs.items()}

    def value(self, fam, u):
        return self._phi[fam] @ u

    def t(self, fam, s):
        """integral_face s * phi_i ds."""
        return self._phi[fam].T @ (self.wds * s)


class VolumeFaceOps:
    """Face quadrature with the owning ELEMENT's trial space: values,
    physical gradients and normal derivatives of volume basis functions on
    a boundary face (Nitsche, DG-type terms).  Geometry (normal, surface
    measure) comes from the face trace like :class:`FaceOps`; trial data
    from the volume tabulation at the face quadrature points."""

    def __init__(self, vtabs, ftabs, weights, ecoords, fcoords, dim, sign):
        gphi, gdphi = ftabs[GEO_FAMILY]
        self.x = gphi @ fcoords
        n, self.wds = _face_geometry(gdphi, weights, fcoords, dim)
        self.normal = n * sign
        self._vtabs = vtabs
        _, vgdphi = vtabs[GEO_FAMILY]
        # J[q, d, x] = dx_x / dxi_d of the owning element at the face qps
        J = torch.einsum("qnd,nx->qdx", vgdphi,
                         ecoords - ecoords.mean(dim=0))
        self._invJ = torch.linalg.inv(J)                  # [q, x, d]
        # characteristic face size for penalty scaling: measure^(1/(dim-1))
        measure = self.wds.sum()
        self.h = measure if dim <= 2 else torch.sqrt(measure)

    def _dphi(self, fam):
        """Physical gradients of the volume basis: (nq, nd, dim)."""
        return torch.einsum("qnd,qxd->qnx", self._vtabs[fam][1], self._invJ)

    def value(self, fam, ue):
        return self._vtabs[fam][0] @ ue

    def grad(self, fam, ue):
        return torch.einsum("qnx,n->qx", self._dphi(fam), ue)

    def dn(self, fam, ue):
        """normal derivative du/dn at the face qps."""
        return (self.grad(fam, ue) * self.normal).sum(dim=-1)

    def t(self, fam, s):
        """integral s * phi_i ds over element-local dofs."""
        return self._vtabs[fam][0].T @ (self.wds * s)

    def tn(self, fam, s):
        """integral s * dphi_i/dn ds (symmetrizing Nitsche term)."""
        dn = torch.einsum("qnx,qx->qn", self._dphi(fam), self.normal)
        return dn.T @ (self.wds * s)


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
        self.face_form: Optional[Callable] = None
        self.face_form_volume = False
        self.face_batches: List[dict] = []
        # element-local auxiliary fields (name, family): global dof vectors
        # of another field the form reads per element as aux[name] (nd, ne)
        self.aux_field_specs: List[Tuple[str, str]] = []
        # material-point residual terms (set_particle_form)
        self.particle_form: Optional[Callable] = None
        self.particle_payload_names: Tuple[str, ...] = ()
        self._tables_cache = None
        # ---- patch-stencil matrix layout (set_patch_layout) --------------
        self.patch_tab = None
        self._patch_slots = None
        self._patch_size = None
        self._patch_nv = 1

    # ---- ELL sparsity pattern + slots, built on first use ----------------
    @functools.cached_property
    def _ell(self):
        rows = np.repeat(self.edofs, self.ndt, axis=1).ravel()
        cols = np.tile(self.edofs, (1, self.ndt)).ravel()
        pattern = pattern_from_pairs(rows, cols, self.n_dofs, self.n_dofs)
        slots = _build_slot_lut(pattern)(rows, cols)
        return pattern, slots.reshape(-1, self.ndt, self.ndt)

    @property
    def pattern(self) -> EllPattern:
        return self._ell[0]

    @property
    def slots(self) -> np.ndarray:
        """(ne, ndt, ndt) flat ELL slot of every element-Jacobian entry."""
        return self._ell[1]

    def set_patch_layout(self, plan) -> None:
        """Assemble the Jacobian into the PATCH-STENCIL layout instead of
        ELL (the mesh must come from mesh.patches.refine_patched, or
        mesh.patches3d.refine_patched_hex with ``plan`` a PatchPlan3D;
        stacked, not interleaved, biquadratic unknowns).  ``op_with`` then
        returns a PatchStencilOp (one unknown), BlockPatchStencilOp or
        PatchStencilOp3D (one unknown) with symmetric Dirichlet
        elimination applied in stencil form."""
        if not all(u.family == "biquadratic" for u in self.unknowns):
            raise ValueError("patch layout: biquadratic unknowns only")
        if self.stack_perm is not None:
            raise ValueError("patch layout: needs the stacked (not "
                             "interleaved) dof layout")
        if self.face_form is not None:
            raise ValueError("patch matrix layout: face forms are not "
                             "supported")
        nv = len(self.unknowns)
        if isinstance(plan, PatchPlan3D):
            if nv != 1:
                raise ValueError("3-D patch layout: one unknown")
            tab = build_patch_tables_3d(plan)
            assert tab.n == self.n_dofs, (tab.n, self.n_dofs)
            self._patch_slots, self._patch_size = build_patch_slots_3d(
                plan, tab)
        else:
            tab = build_patch_tables(plan)
            assert tab.n * nv == self.n_dofs, (tab.n, nv, self.n_dofs)
            self._patch_slots, self._patch_size = build_patch_slots(
                plan, tab, nv=nv)
        self._patch_nv = nv
        self.patch_tab = tab
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

    def set_face_form(self, fn: Callable, volume: bool = False) -> None:
        """fn(fops: FaceOps, u: dict, fams: dict, group, aux: dict) -> dict:
        boundary-face residuals on face-local dofs (``u[name]`` (nd_face,),
        ``fams[name]`` the face trace's family, ``group`` the face's group
        as a 0-d tensor), one face at a time under ``torch.func.vmap``.

        volume=True: the form needs the owning ELEMENT's trial space on the
        face (normal derivatives, Nitsche/DG terms): it is called as
        fn(fops: VolumeFaceOps, u, group, aux) with element-local dof
        vectors, and returns residuals per element-local dof (reference
        boundary loops that call the volume ``JacobianSur``,
        03_navier_stokes.hpp:193-301).  Group selectors inside a form are
        written ``(grp == g).to(dtype)`` or ``torch.where(grp == g, ...)``."""
        if self.patch_tab is not None:
            raise ValueError("patch matrix layout: face forms are not "
                             "supported")
        self.face_form = fn
        self.face_form_volume = volume
        self._build_face_tables()
        self._tables_cache = None

    def add_aux_field(self, name: str, family: str) -> None:
        """Let the form read the global ``family`` dof vector passed as
        ``aux_fields[name]`` as its element-local values ``aux[name]``."""
        self.aux_field_specs.append((name, family))
        self._tables_cache = None

    def set_particle_form(self, fn: Callable,
                          payload_names: Sequence[str]) -> None:
        """Residual contribution of material points to their owner element.

        fn(u: dict name -> (nd,) element-local dofs, p: dict payload-name ->
        one particle's tensors, aux: dict scalars) -> dict name -> (nd,),
        called one particle at a time under ``torch.func.vmap``.

        This is the monolithic MPM-FSI coupling hook: the reference adds
        solid-particle stress/inertia terms to the background-grid momentum
        rows inside the assembly loop (applications/MPM_FSI; grid transfer
        Line.hpp:81-87).  Particle terms couple only the owner element's
        dofs, so the Jacobian lands in the existing element ELL slots.
        Particle data is regrouped per call via :meth:`particle_tables` and
        supplied as ``tables['particles']``.
        """
        self.particle_form = fn
        self.particle_payload_names = tuple(payload_names)

    def particle_tables(self, elems, payload: Dict[str, torch.Tensor],
                        ppe: int) -> dict:
        """Group particles by owner element into fixed (ne, ppe) slots.

        elems: (np_,) owner element per particle (-1 = inactive).  payload:
        per-particle tensors (np_, ...), gathered on the device into
        (ne, ppe, ...); an empty slot gathers particle 0 and is masked out.
        The grouping is a stable sort by element and each particle's rank
        in its group (host).  Raises if any element holds more than ``ppe``
        particles (static capacity)."""
        elems = torch.as_tensor(elems).cpu().numpy().astype(np.int64)
        ne = self.mesh.n_elems
        act = np.nonzero(elems >= 0)[0]
        order = act[np.argsort(elems[act], kind="stable")]
        grp = elems[order]
        counts = np.bincount(grp, minlength=ne)
        if counts.max(initial=0) > ppe:
            raise ValueError(f"element {int(np.argmax(counts > ppe))} holds "
                             f"more than ppe={ppe} particles")
        rank = np.arange(len(order)) - (np.cumsum(counts) - counts)[grp]
        idx = np.zeros((ne, ppe), np.int64)
        mask = np.zeros((ne, ppe), bool)
        idx[grp, rank] = order
        mask[grp, rank] = True
        gidx = torch.as_tensor(idx, device=self.device)
        return {"mask": torch.as_tensor(mask, device=self.device),
                "payload": {k: torch.as_tensor(v, device=self.device)[gidx]
                            for k, v in payload.items()}}

    def _add_particles(self, u, tables, aux_scalars, R, data,
                       with_jacobian: bool):
        """Add the material points' residuals (one ``vmap`` over the slots
        of each element, masked with ``torch.where`` — an empty slot holds
        particle 0's data, whose terms may be inf) to ``R`` and, with
        ``with_jacobian``, their element Jacobians (``vmap(jacfwd(...))``
        over the elements) to the flat ELL ``data`` through the element
        slots."""
        pt = tables["particles"]
        names = self.particle_payload_names
        pay = [pt["payload"][k] for k in names]
        aux = dict(aux_scalars or {})

        def single(uu, mi, *one):
            out = self.particle_form(uu, dict(zip(names, one)), dict(aux))
            vec = torch.cat([out[un.name] if un.name in out
                             else uu[un.name].new_zeros(uu[un.name].shape)
                             for un in self.unknowns])
            return torch.where(mi, vec, torch.zeros_like(vec))

        def pone(ul, m, *pv):
            return torch.func.vmap(single, in_dims=(None,) + (0,) * (
                1 + len(pv)))(self._split(ul), m, *pv).sum(dim=0)

        u_loc = u[tables["edofs"]]                       # (ne, ndt)
        if with_jacobian:
            jp, rp = torch.func.vmap(torch.func.jacfwd(
                lambda *a: (pone(*a),) * 2, has_aux=True))(
                    u_loc, pt["mask"], *pay)
            data = data.index_add(0, tables["slots"], jp.reshape(-1))
        else:
            rp = torch.func.vmap(pone)(u_loc, pt["mask"], *pay)
        R = R.index_add(0, tables["edofs"].reshape(-1), rp.reshape(-1))
        return R, data

    def _split(self, u_flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {u.name: u_flat[self.local_slices[u.name]] for u in self.unknowns}

    # ------------------------------------------------------------------
    def _build_face_tables(self) -> None:
        """Per-boundary-face gather tables and tabulations, one batch per
        (face group geometry, local face id)."""
        self.face_batches = []
        mesh = self.mesh
        g = GEOMS[mesh.geom]
        for fg, bf in mesh.boundary.items():
            if len(bf.elem) == 0:
                continue
            pts, w = gauss(fg, self.quad_order)
            for iface in np.unique(bf.iface):
                sel = np.where(bf.iface == iface)[0]
                elems = bf.elem[sel]
                fams, fdof_parts, fslices = {}, [], {}
                loc0 = 0
                for u in self.unknowns:
                    ff, lidx = face_trace_nodes(mesh.geom, u.family,
                                                int(iface))
                    fams[u.name] = ff
                    sl = self.local_slices[u.name]
                    fdof_parts.append(self.edofs[elems][:, sl][:, lidx])
                    fslices[u.name] = slice(loc0, loc0 + len(lidx))
                    loc0 += len(lidx)
                gff, glidx = face_trace_nodes(mesh.geom, GEO_FAMILY,
                                              int(iface))
                tabs = {}
                for fam in {gff} | set(fams.values()):
                    t = tabulate(fg, fam, self.quad_order)
                    tabs[fam] = (t.phi, t.dphi)
                tabs[GEO_FAMILY] = tabs[gff]
                batch = dict(
                    fgeom=fg, iface=int(iface),
                    fdofs=np.concatenate(fdof_parts, axis=1).astype(np.int32),
                    fslices=fslices, fams=fams, ndf=loc0,
                    coords=mesh.coords[self.geo_conn[elems][:, glidx]],
                    groups=np.asarray(bf.group[sel]), tabs=tabs,
                    weights=np.asarray(w))
                if self.face_form_volume:
                    # volume trial space at the face quadrature points:
                    # face-ref -> volume-ref through the face's bq nodes
                    fgeo, f_bq = g.faces[int(iface)]
                    xi_vol = np.asarray(get_basis(fgeo, GEO_FAMILY).eval(
                        pts)) @ np.asarray(g.ref_nodes[np.asarray(f_bq)])
                    batch["vtabs"] = {}
                    for fam in {u.family for u in self.unknowns} | {
                            GEO_FAMILY}:
                        vb = get_basis(mesh.geom, fam)
                        batch["vtabs"][fam] = (np.asarray(vb.eval(xi_vol)),
                                               np.asarray(vb.eval_grad(
                                                   xi_vol)))
                    batch["eidx"] = self.edofs[elems]
                    batch["ecoords"] = self.coords_e[elems]
                self.face_batches.append(batch)

    def _face_slots(self, batch) -> np.ndarray:
        """(nf, nd, nd) flat ELL slot of every face-Jacobian entry, on the
        physical pattern (face dofs, or all element dofs for a volume face
        form)."""
        if "slots" not in batch:
            lut = _build_slot_lut(self.pattern)
            fd = batch["eidx"] if self.face_form_volume else batch["fdofs"]
            n = fd.shape[1]
            rows = np.repeat(fd, n, axis=1).ravel()
            cols = np.tile(fd, (1, n)).ravel()
            batch["slots"] = lut(rows, cols).reshape(fd.shape[0], n, n)
        return batch["slots"]

    def _face_residual(self, batch, tabs, weights, u_flat, coords, grp,
                       aux_scalars):
        """One face's residual on its face-local dofs (plain face form)."""
        fops = FaceOps(tabs, weights, coords, self.dim, 1.0)
        u = {name: u_flat[sl] for name, sl in batch["fslices"].items()}
        out = self.face_form(fops, u, batch["fams"], grp, dict(aux_scalars))
        parts = []
        for un in self.unknowns:
            r = out.get(un.name)
            if r is None:
                sl = batch["fslices"][un.name]
                r = u_flat.new_zeros(sl.stop - sl.start)
            parts.append(r)
        return torch.cat(parts)

    def _volume_face_residual(self, vtabs, tabs, weights, ue, ecoords,
                              fcoords, grp, aux_scalars):
        """One face's residual on its element-local dofs (volume face
        form)."""
        fops = VolumeFaceOps(vtabs, tabs, weights, ecoords, fcoords,
                             self.dim, 1.0)
        out = self.face_form(fops, self._split(ue), grp, dict(aux_scalars))
        parts = []
        for un in self.unknowns:
            r = out.get(un.name)
            if r is None:
                sl = self.local_slices[un.name]
                r = ue.new_zeros(sl.stop - sl.start)
            parts.append(r)
        return torch.cat(parts)

    def _face_batch_fns(self, tables, aux_scalars) -> list:
        """[(dofs, fone, rest, batch tables)] per face batch: ``fone(u_loc,
        *rest)`` is one face's residual on its local dofs ``dofs`` (face
        dofs, or all element dofs for a volume face form)."""
        aux_scalars = aux_scalars or {}
        out = []
        for b, bt in zip(self.face_batches, tables["faces"]):
            if self.face_form_volume:
                def fone(ue, ecl, fcl, grp, _bt=bt):
                    return self._volume_face_residual(
                        _bt["vtabs"], _bt["tabs"], _bt["weights"], ue, ecl,
                        fcl, grp, aux_scalars)

                out.append((bt["eidx"], fone, (bt["ecoords"], bt["coords"],
                                               bt["groups"]), bt))
            else:
                def fone(ul, cl, grp, _b=b, _bt=bt):
                    return self._face_residual(_b, _bt["tabs"],
                                               _bt["weights"], ul, cl, grp,
                                               aux_scalars)

                out.append((bt["fdofs"], fone, (bt["coords"], bt["groups"]),
                            bt))
        return out

    def _add_faces(self, u, tables, aux_scalars, R, data,
                   with_jacobian: bool):
        """Add the boundary-face residuals to ``R`` and, with
        ``with_jacobian``, their Jacobians (``torch.func.jacfwd``: forward
        derivatives along the face's local dof tangents) to the flat ELL
        ``data`` through the face slots."""
        for dofs, fone, rest, bt in self._face_batch_fns(tables, aux_scalars):
            args = (u[dofs],) + rest
            if with_jacobian:
                # one pass: the residual rides along as jacfwd's aux
                jf, rf = torch.func.vmap(torch.func.jacfwd(
                    lambda *a, _f=fone: (_f(*a),) * 2, has_aux=True))(*args)
                data = data.index_add(0, bt["slots"], jf.reshape(-1))
            else:
                rf = torch.func.vmap(fone)(*args)
            R = R.index_add(0, dofs.reshape(-1), rf.reshape(-1))
        return R, data

    # ------------------------------------------------------------------
    def device_tables_cached(self) -> dict:
        """device_tables() with caching; invalidated by set_dirichlet."""
        if self._tables_cache is None:
            with span("setup.step_build"):
                count("rebuild.tables")
                self._tables_cache = self.device_tables()
        return self._tables_cache

    def device_tables(self) -> dict:
        """All arrays the assembly reads, as tensors on the device."""
        dev, dt = self.device, self.dtype

        def i64(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

        def flt(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        mask = self.dirichlet_mask
        t = {
            "elem_group": i64(self.mesh.elem_group),
            "edofs": i64(self.edofs),
            "coords_e": flt(self.coords_e),
            "dir_mask": torch.as_tensor(mask, device=dev),
            "tabs": {f: (flt(p), flt(d)) for f, (p, d) in self.tabs_np.items()},
            "qweights": flt(self.qweights_np),
            "aux_conn": {name: i64(self.mesh.dofmap(fam).conn)
                         for name, fam in self.aux_field_specs},
            "faces": [],
        }
        if self.face_form is not None:
            for b in self.face_batches:
                ft = {"fdofs": i64(b["fdofs"]), "coords": flt(b["coords"]),
                      "groups": i64(b["groups"]), "weights": flt(b["weights"]),
                      "tabs": {f: (flt(p), flt(d))
                               for f, (p, d) in b["tabs"].items()},
                      "slots": i64(self._face_slots(b).reshape(-1))}
                if self.face_form_volume:
                    ft["eidx"] = i64(b["eidx"])
                    ft["ecoords"] = flt(b["ecoords"])
                    ft["vtabs"] = {f: (flt(p), flt(d))
                                   for f, (p, d) in b["vtabs"].items()}
                t["faces"].append(ft)
        if self.patch_tab is not None:
            tab = self.patch_tab
            t["patch_slots"] = i64(self._patch_slots.reshape(-1))
            t["patch_owner"] = torch.as_tensor(tab.owner, device=dev)
            # symmetric Dirichlet elimination in stencil form, as masks
            if isinstance(tab, PatchTables3D):
                t["patch_routing"] = routing = patch_routing_3d(tab, dev)
                t["patch_dir_bad"], t["patch_dir_ident"] = \
                    dirichlet_masks_3d(routing, t["dir_mask"],
                                       t["patch_owner"])
                return t
            t["patch_routing"] = routing = patch_routing(tab, dev)
            t["patch_dir_bad"], t["patch_dir_ident"] = dirichlet_masks(
                patch_meta(tab), routing, t["dir_mask"], t["patch_owner"],
                self._patch_nv)
            return t
        pat = self.pattern
        rows = np.arange(pat.n_rows)[:, None]
        # symmetric Dirichlet elimination: zero masked rows/cols, exactly
        # one unit entry on the diagonal of a masked row (ell_valid excludes
        # the diagonal-pointing padding slots)
        bad = mask[:, None] | mask[pat.cols]
        ident = (pat.cols == rows) & mask[:, None] & pat.valid
        t.update({
            "slots": i64(self.slots.reshape(-1)),
            "dir_bad": torch.as_tensor(bad, device=dev),
            "dir_ident": flt(ident),
            "ell_cols": i64(pat.cols),
        })
        return t

    def _layout(self, layout: str = "element_last") -> str:
        """The assembly layout: the volume form's own ``layout`` attribute
        (``"batch_first"`` for forms written per element), else ``layout``
        (only :meth:`make_assemble_fn` passes one)."""
        layout = getattr(self.volume_form, "layout", layout)
        if layout not in ("element_last", "batch_first"):
            raise ValueError(f"layout {layout!r}")
        return layout

    def _elem_residual(self, tabs, qweights, aux_scalars, ul, cl, grp,
                       *aux_vals):
        """One element's residual (ndt,) through :class:`ElemOps`: the
        batch-first layout's function, mapped over the elements by
        ``torch.func.vmap``."""
        aux = dict(aux_scalars)
        aux.update(zip([n for n, _ in self.aux_field_specs], aux_vals))
        aux["group"] = grp
        out = self.volume_form(ElemOps(tabs, qweights, cl, self.dim),
                               self._split(ul), aux)
        parts = []
        for un in self.unknowns:
            r = out.get(un.name)
            if r is None:          # forms may omit rows (zeros)
                sl = self.local_slices[un.name]
                r = ul.new_zeros(sl.stop - sl.start)
            parts.append(r)
        return torch.cat(parts)

    def _batch_first_args(self, tables, aux_scalars, aux_fields):
        """(one, element arguments after the dofs): ``one(u_loc[e],
        *(a[e] for a in args))`` is element e's residual."""
        one = functools.partial(self._elem_residual, tables["tabs"],
                                tables["qweights"], aux_scalars or {})
        args = (tables["coords_e"], tables["elem_group"]) + tuple(
            aux_fields[name][tables["aux_conn"][name]]
            for name, _ in self.aux_field_specs)
        return one, args

    def _element_fn(self, tables, aux_scalars=None,
                    aux_fields=None) -> Callable:
        """``all_elems(ulT (ndt, ne)) -> (ndt, ne)``: the volume form over
        all elements at once, element-local dofs in, element residuals
        out.  ``aux_fields`` (name -> global dof vector of the field's
        family, one per ``add_aux_field``) reach the form as element-local
        ``aux[name]`` ((nd, ne) element-last, (nd,) batch-first), beside
        the scalars and ``aux['group']``."""
        if self._layout() == "batch_first":
            one, args = self._batch_first_args(tables, aux_scalars,
                                               aux_fields)
            return lambda ulT: torch.func.vmap(one)(ulT.T, *args).T
        aux = dict(aux_scalars or {})
        for name, _ in self.aux_field_specs:
            aux[name] = aux_fields[name][tables["aux_conn"][name]].T
        aux["group"] = tables["elem_group"]
        ops = ElemOpsBatched(tables["tabs"], tables["qweights"],
                             tables["coords_e"].permute(1, 2, 0), self.dim)

        def all_elems(ulT):
            out = self.volume_form(ops, self._split(ulT), aux)
            parts = []
            for un in self.unknowns:
                r = out.get(un.name)
                if r is None:      # forms may omit rows (zeros)
                    sl = self.local_slices[un.name]
                    r = ulT.new_zeros((sl.stop - sl.start, ulT.shape[1]))
                parts.append(r)
            return torch.cat(parts)

        return all_elems

    def _scatter_rows(self, tables, vT) -> torch.Tensor:
        """Sum element-local row values ``vT (ndt, ne)`` into a global
        ``(n_dofs,)`` vector."""
        out = torch.zeros(self.n_dofs, dtype=self.dtype, device=self.device)
        return out.index_add_(0, tables["edofs"].reshape(-1),
                              vT.T.reshape(-1))

    def element_terms(self, u, tables, aux_scalars=None,
                      with_jacobian: bool = True, aux_fields=None):
        """Element residuals ``rT (ndt, ne)`` of the volume form at ``u``
        and, with ``with_jacobian``, their Jacobians ``jacT (ndt_j, ndt_i,
        ne)`` (else None), in the form's layout (:meth:`_layout`).  Every
        matrix layout (ELL, patch stencil, lattice stencil, diagonal)
        scatters these."""
        terms = (self._batch_first_terms if self._layout() == "batch_first"
                 else self._element_last_terms)
        return terms(u, tables, aux_scalars, with_jacobian, aux_fields)

    def _batch_first_terms(self, u, tables, aux_scalars, with_jacobian,
                           aux_fields):
        """:meth:`element_terms` batch-first: ``vmap`` over the elements
        of ``jacfwd`` of one element's residual."""
        u = u.to(device=self.device, dtype=self.dtype)
        one, args = self._batch_first_args(tables, aux_scalars, aux_fields)
        u_loc = u[tables["edofs"]]                       # (ne, ndt)
        if not with_jacobian:
            return torch.func.vmap(one)(u_loc, *args).T, None
        # one pass: the residual rides along as jacfwd's aux
        jac, r = torch.func.vmap(torch.func.jacfwd(
            lambda *a: (one(*a),) * 2, has_aux=True))(u_loc, *args)
        return r.T, jac.permute(2, 1, 0)

    def _element_last_terms(self, u, tables, aux_scalars, with_jacobian,
                            aux_fields):
        """:meth:`element_terms` element-last: the forward derivative of
        all element residuals along the ``ndt`` unit tangents
        (``torch.func.jvp`` under ``vmap``; exact, because element
        residuals are local)."""
        u = u.to(device=self.device, dtype=self.dtype)
        all_elems = self._element_fn(tables, aux_scalars, aux_fields)
        u_locT = u[tables["edofs"]].T                    # (ndt, ne)
        rT = all_elems(u_locT)
        if not with_jacobian:
            return rT, None
        eye = torch.eye(self.ndt, dtype=self.dtype, device=self.device)
        tang = eye[:, :, None].expand(self.ndt, self.ndt, u_locT.shape[1])
        jacT = torch.func.vmap(
            lambda tg: torch.func.jvp(all_elems, (u_locT,), (tg,))[1])(tang)
        return rT, jacT

    def make_assemble_fn(self, with_jacobian: bool = True,
                         pass_tables: bool = False,
                         layout: str = "element_last"):
        """Assembly function.

        pass_tables=False: (u, aux_scalars, aux_fields) -> (R, data) with
        the tables built once and closed over.
        pass_tables=True: (u, tables, aux_scalars, aux_fields) -> (R, data)
        with tables supplied per call (``tables['particles']``, from
        :meth:`particle_tables`, adds the particle form's terms).
        ``aux_scalars`` (e.g. ``nu``) and
        the element-local ``aux_fields`` (see :meth:`_element_fn`) reach
        the form's ``aux`` dict.

        Element residuals and Jacobians come from :meth:`element_terms`
        in ``layout`` (a form's own ``layout`` attribute wins); the
        Jacobian lands in ELL ``data (n_rows, width)`` or, with a patch
        layout, in the flat patch-stencil weights."""
        const_tables = None if pass_tables else self.device_tables()
        terms = (self._batch_first_terms
                 if self._layout(layout) == "batch_first"
                 else self._element_last_terms)

        def assemble_t(u, tables, aux_scalars=None, aux_fields=None):
            rT, jacT = terms(u, tables, aux_scalars, with_jacobian,
                             aux_fields)
            R = self._scatter_rows(tables, rT)
            data = None
            if with_jacobian:
                jac = jacT.permute(2, 1, 0).reshape(-1)   # (ne, ndt_i, ndt_j)
                if self.patch_tab is not None:
                    # every element scatters into its own patch's lattice
                    # slots
                    data = torch.zeros(self._patch_size, dtype=self.dtype,
                                       device=self.device)
                    return (torch.where(tables["dir_mask"], 0.0, R),
                            data.index_add_(0, tables["patch_slots"], jac))
                nrows, w = self.pattern.n_rows, self.pattern.width
                data = torch.zeros(nrows * w, dtype=self.dtype,
                                   device=self.device)
                data.index_add_(0, tables["slots"], jac)
            if (self.particle_form is not None
                    and tables.get("particles") is not None):
                R, data = self._add_particles(
                    u.to(device=self.device, dtype=self.dtype), tables,
                    aux_scalars, R, data, with_jacobian)
            if self.face_form is not None:
                R, data = self._add_faces(
                    u.to(device=self.device, dtype=self.dtype), tables,
                    aux_scalars, R, data, with_jacobian)
            R = torch.where(tables["dir_mask"], 0.0, R)
            if not with_jacobian:
                return R, None
            data = data.view(self.pattern.n_rows, self.pattern.width)
            data = torch.where(tables["dir_bad"], tables["dir_ident"], data)
            return R, data

        if pass_tables:
            return assemble_t

        def assemble(u, aux_scalars=None, aux_fields=None):
            return assemble_t(u, const_tables, aux_scalars, aux_fields)

        return assemble

    def make_diag_fn(self):
        """(u, tables, aux_scalars=None, aux_fields=None) -> the Jacobian
        DIAGONAL ``(n_dofs,)`` without global matrix data: the smoother
        scaling of the matrix-free operator path, in the form's layout.
        Dirichlet rows get exactly 1."""

        def diag_t(u, tables, aux_scalars=None, aux_fields=None):
            _, jacT = self.element_terms(u, tables, aux_scalars,
                                         aux_fields=aux_fields)
            dlocT = torch.diagonal(jacT, dim1=0, dim2=1).T    # (ndt, ne)
            return torch.where(tables["dir_mask"], 1.0,
                               self._scatter_rows(tables, dlocT))

        return diag_t

    def make_linearized_fn(self):
        """(u, tables, aux_scalars=None, aux_fields=None) -> (R, jv): the
        residual at ``u`` (Dirichlet rows zeroed) and the action
        ``jv(v) = J(u) v`` of its Jacobian WITHOUT Dirichlet elimination
        and without any global matrix data — the fine operator of the
        matrix-free path.  The element residuals, and the boundary-face
        residuals of a face form, are linearised once
        (``torch.func.linearize``, element- and face-local, so neither the
        gathers nor the ``index_add_`` scatters are differentiated); each
        ``jv`` is gather -> linear maps -> scatter.  A batch-first form
        (:meth:`_layout`) is linearised through its per-element ``vmap``."""

        def lin_t(u, tables, aux_scalars=None, aux_fields=None):
            all_elems = self._element_fn(tables, aux_scalars, aux_fields)
            u = u.to(device=self.device, dtype=self.dtype)
            rT, jvp = torch.func.linearize(all_elems, u[tables["edofs"]].T)
            R = self._scatter_rows(tables, rT)
            faces = self._linearized_faces(u, tables, aux_scalars)
            for dofs, rf, _ in faces:
                R = R.index_add(0, dofs.reshape(-1), rf.reshape(-1))
            R = torch.where(tables["dir_mask"], 0.0, R)

            def jv(v):
                out = self._scatter_rows(tables, jvp(v[tables["edofs"]].T))
                for dofs, _, fjvp in faces:
                    out = out.index_add(0, dofs.reshape(-1),
                                        fjvp(v[dofs]).reshape(-1))
                return out

            return R, jv

        return lin_t

    def _linearized_faces(self, u, tables, aux_scalars) -> list:
        """[(dofs, face residuals, their linear map)] of each face batch
        of the face form at ``u`` (none without a face form)."""
        if self.face_form is None:
            return []
        out = []
        for dofs, fone, rest, _ in self._face_batch_fns(tables, aux_scalars):
            rf, fjvp = torch.func.linearize(
                lambda ul, _f=fone, _r=rest: torch.func.vmap(_f)(ul, *_r),
                u[dofs])
            out.append((dofs, rf, fjvp))
        return out

    def new_op(self) -> SparseOp:
        """A zero ELL operator on this level's pattern (device, dtype)."""
        return op_from_pattern(self.pattern, torch.zeros(
            (self.pattern.n_rows, self.pattern.width), dtype=self.dtype,
            device=self.device))

    def op_with(self, data: torch.Tensor, cols: torch.Tensor = None):
        """Wrap assembled data as a device operator: ELL data -> SparseOp
        (``cols``: the tables' ``ell_cols``, uploaded once); patch layout ->
        PatchStencilOp / BlockPatchStencilOp with stencil-form Dirichlet
        elimination applied (routing and masks from the cached tables)."""
        if self.patch_tab is not None:
            tab, t, nv = self.patch_tab, self.device_tables_cached(), \
                self._patch_nv
            if isinstance(tab, PatchTables3D):
                wt = apply_dirichlet(
                    data.view(K3, tab.H, tab.H, tab.H, tab.Pp),
                    t["patch_dir_bad"], t["patch_dir_ident"])
                return make_patch_op_3d(tab, wt, t["patch_routing"])
            wt = apply_dirichlet(data.view(nv * nv * K, tab.H, tab.H, tab.Pp),
                                 t["patch_dir_bad"], t["patch_dir_ident"])
            if nv > 1:
                return make_block_patch_op(tab, wt, nv, t["patch_routing"])
            return make_patch_op(tab, wt, t["patch_routing"])
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
