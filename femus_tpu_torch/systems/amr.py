"""AMR solve driver: solve -> estimate -> flag -> selectively refine.

Each AMR cycle is a full host re-setup (static shapes per cycle).  Within a
cycle the conforming reduced operator C^T A C is computed on the device by
the same precomputed-schedule PtAP that multigrid uses, with the Dirichlet
identity put back on the reduced rows, and the solve is a preconditioned
CG in the free-dof space.  A reduced operator of at least 2048 rows runs
its matvec on the sliced-ELL operator of the BELL frame (kernel B1); the
LU-solved coarsest level of the multigrid across AMR levels is never
multiplied and keeps its ELL values.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import default_dtype, resolve_device
from ..algebra.bell import on_bell_frame
from ..algebra.krylov import cg, jacobi_cg
from ..algebra.mg import build_hierarchy_from_ops
from ..algebra.sparse import op_from_pattern
from ..algebra.transfer import (block_diag_prolongation, build_ptap_schedule,
                                mask_prolongation, op_pair_from_scipy)
from ..assembly.bc import apply_dirichlet_values, generate_bdc
from ..assembly.engine import Assembler, Unknown
from ..fe.basis import get_basis
from ..fe.geom import GEOMS
from ..fe.quadrature import gauss
from ..mesh.amr import flag_by_error, hanging_constraints, refine_selective
from ..mesh.mesh import Mesh


# ---------------------------------------------------------------------------
# Kelly-type gradient-jump error indicator (host, set-up-scale work)
# ---------------------------------------------------------------------------

def kelly_indicator(mesh: Mesh, family: str, u: np.ndarray,
                    quad_order: int = 3) -> np.ndarray:
    """eta_e^2 = sum over matched interior faces  h_f * 0.5 * int [du/dn]^2.

    Refinement-boundary faces (coarse/fine mismatch) are skipped: their
    jump is controlled by the hanging constraints.  Returns per-element
    eta."""
    g = GEOMS[mesh.geom]
    b = get_basis(mesh.geom, family)
    dm = mesh.dofmap(family)
    fam_local = g.family_nodes[family]

    # matched interior face pairs
    keys, elems, ifaces = [], [], []
    for fi, (fg, f_bq) in enumerate(g.faces):
        nvf = GEOMS[fg].n_verts
        keys.append(np.sort(mesh.conn[:, np.asarray(f_bq[:nvf])], axis=1))
        elems.append(np.arange(mesh.n_elems))
        ifaces.append(np.full(mesh.n_elems, fi))
    keys = np.concatenate(keys)
    elems = np.concatenate(elems)
    ifaces = np.concatenate(ifaces)
    order = np.lexsort(keys.T[::-1])
    keys, elems, ifaces = keys[order], elems[order], ifaces[order]
    same = np.all(keys[1:] == keys[:-1], axis=1)
    p1, p2 = np.where(same)[0], np.where(same)[0] + 1

    eta2 = np.zeros(mesh.n_elems)
    # single-geometry mesh: every face has the same geometry
    fg0 = g.faces[0][0]
    qpts, qw = gauss(fg0, quad_order)                    # face-ref quadrature
    fbas = get_basis(fg0, "biquadratic")
    fphi = np.asarray(fbas.eval(qpts))                   # (nq, n_face_bq)
    fdphi = np.asarray(fbas.eval_grad(qpts))             # (nq, n_face_bq, dim-1)

    e1a, f1a, e2a, f2a = elems[p1], ifaces[p1], elems[p2], ifaces[p2]
    g1, n1, dS1 = _side_batch(mesh, b, dm, fam_local, u, e1a, f1a, fphi, fdphi)
    g2, _, _ = _side_batch(mesh, b, dm, fam_local, u, e2a, f2a, fphi, fdphi)
    jump = np.einsum("mqx,mqx->mq", g1 - g2, n1)         # (m, nq)
    h = dS1.sum(axis=1)                                  # ~ face measure
    eta = h * np.einsum("q,mq,mq->m", qw, jump ** 2, dS1)
    np.add.at(eta2, e1a, 0.5 * eta)
    np.add.at(eta2, e2a, 0.5 * eta)
    return np.sqrt(eta2)


def _side_batch(mesh, b, dm, fam_local, u, elems, ifaces, fphi, fdphi):
    """Batched one-sided face-gradient evaluation: physical gradients,
    normals and surface measure at face quadrature points for every
    (element, local face) pair at once, grouped by local face index."""
    g = GEOMS[mesh.geom]
    geo_b = get_basis(mesh.geom, "biquadratic")
    m, nq = len(elems), fphi.shape[0]
    dim = mesh.dim
    gphys = np.zeros((m, nq, dim))
    nrm_all = np.zeros((m, nq, dim))
    dS_all = np.zeros((m, nq))
    for fi in np.unique(ifaces):
        sel = ifaces == fi
        E = elems[sel]
        fg, f_bq = g.faces[int(fi)]
        f_bq = np.asarray(f_bq)
        xi = fphi @ g.ref_nodes[f_bq]                    # (nq, dim)
        dphi_e = np.asarray(b.eval_grad(xi))             # (nq, nd, dim)
        geo_dphi = np.asarray(geo_b.eval_grad(xi))       # (nq, nd_geo, dim)
        conn_E = mesh.conn[E]                            # (me, nd_geo)
        coords_E = mesh.coords[conn_E]                   # (me, nd_geo, dim)
        J = np.einsum("qnd,mnx->mqxd", geo_dphi, coords_E)
        Jinv = np.linalg.inv(J)                          # (me, nq, d, x)
        dofs_E = u[dm.node_to_dof[conn_E[:, fam_local]]]  # (me, nd)
        gref = np.einsum("qnd,mn->mqd", dphi_e, dofs_E)
        gphys[sel] = np.einsum("mqdx,mqd->mqx", Jinv, gref)
        fcoords = mesh.coords[conn_E[:, f_bq]]           # (me, nfb, dim)
        T = np.einsum("qns,mnx->mqxs", fdphi, fcoords)   # (me, nq, dim, dim-1)
        if T.shape[3] == 1:
            dS = np.linalg.norm(T[:, :, :, 0], axis=2)
            nrm = np.stack([T[:, :, 1, 0], -T[:, :, 0, 0]], axis=2)
        else:
            nrm = np.cross(T[:, :, :, 0], T[:, :, :, 1])
            dS = np.linalg.norm(nrm, axis=2)
        nrm_all[sel] = nrm / np.maximum(dS[:, :, None], 1e-300)
        dS_all[sel] = dS
    return gphys, nrm_all, dS_all


# ---------------------------------------------------------------------------
# One conforming solve on a (possibly mixed-level) mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AMRResult:
    mesh: Mesh
    u: np.ndarray                 # stacked dof vector (all dofs, conforming)
    eta: np.ndarray               # per-element indicator
    n_free: int
    info: Dict


def _constraints(mesh, unknowns):
    """Block-diagonal constraint operator over the unknowns and the stacked
    free-dof index."""
    blocks, frees = [], []
    off = 0
    for u in unknowns:
        Cb, fb = hanging_constraints(mesh, u.family)
        blocks.append(Cb)
        frees.append(fb + off)
        off += Cb.shape[0]
    return sp.block_diag(blocks, format="csr"), np.concatenate(frees)


def _assembler(mesh, unknowns, volume_form, bc_fn, quad_order, face_form,
               dtype, device):
    asm = Assembler(mesh, list(unknowns), quad_order=quad_order, dtype=dtype,
                    device=device)
    asm.set_volume_form(volume_form)
    if face_form is not None:
        asm.set_face_form(face_form)
    generate_bdc(asm, bc_fn)
    return asm


def _restore_dirichlet(data: torch.Tensor, cpat, mask_f: np.ndarray):
    """Re-impose the Dirichlet identity on the reduced rows and columns:
    the Galerkin reduction distributes hanging equations onto masters,
    which must not touch the Dirichlet masters' identity rows."""
    touched = (mask_f[:, None] | mask_f[cpat.cols]) & cpat.valid
    diag_slot = (cpat.cols == np.arange(cpat.n_rows)[:, None]) & cpat.valid
    setdiag = diag_slot & mask_f[:, None]
    keep = np.where(touched & ~setdiag, 0.0, 1.0)
    sd = torch.as_tensor(setdiag, dtype=data.dtype, device=data.device)
    return data * torch.as_tensor(keep, dtype=data.dtype,
                                  device=data.device) * (1 - sd) + sd


def _start(asm, C, free_idx, dtype, device) -> torch.Tensor:
    """Constraint-consistent start: Dirichlet values, with the hanging
    dofs interpolating their masters (so Dirichlet values reach
    boundary-adjacent hanging dofs through C)."""
    u0 = apply_dirichlet_values(asm, np.zeros(asm.n_dofs))
    return torch.as_tensor(C @ u0[free_idx], dtype=dtype, device=device)


def solve_conforming(mesh: Mesh, unknowns: Sequence[Unknown],
                     volume_form, bc_fn, quad_order: str = "fifth",
                     tol: float = 1e-10, maxiter: int = 2000,
                     face_form=None, device="cuda",
                     dtype: Optional[torch.dtype] = None
                     ) -> Tuple[np.ndarray, Dict]:
    """Assemble on all elements, reduce by the hanging constraint operator
    C (block-diagonal over unknowns), solve C^T A C in free space by
    diagonal-preconditioned CG, prolong.  Returns (u_all, info)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    asm = _assembler(mesh, unknowns, volume_form, bc_fn, quad_order,
                     face_form, dtype, device)
    C, free_idx = _constraints(mesh, unknowns)
    n_hang = C.shape[0] - C.shape[1]
    u0 = _start(asm, C, free_idx, dtype, device)
    R, data = asm.make_assemble_fn()(u0)
    routing: List[dict] = []
    if n_hang == 0:
        A = on_bell_frame(asm.op_with(data), asm.pattern, device, routing)
        delta, si = jacobi_cg(A, -R, tol=tol, maxiter=maxiter)
        return (u0 + delta).cpu().numpy(), {
            "n_hanging": 0, "iterations": si.iters,
            "residual": si.residual, "routing": routing}

    Cop, CTop = op_pair_from_scipy(C, dtype=dtype, device=device)
    sched = build_ptap_schedule(asm.pattern, C, dtype=dtype, device=device)
    mask_f = np.asarray(asm.dirichlet_mask)[free_idx]
    cpat = sched.coarse_pattern
    Ar = on_bell_frame(op_from_pattern(cpat, _restore_dirichlet(
        sched.apply(data), cpat, mask_f)), cpat, device, routing)
    mask_t = torch.as_tensor(mask_f, device=device)
    Rr = torch.where(mask_t, 0.0, CTop @ R)
    delta_f, si = jacobi_cg(Ar, -Rr, tol=tol, maxiter=maxiter)
    # prolong: full-space solution (hanging dofs interpolated); u0 carries
    # the Dirichlet values, delta the free-space correction
    return (u0 + Cop @ delta_f).cpu().numpy(), {
        "n_hanging": int(n_hang), "iterations": si.iters,
        "residual": si.residual, "routing": routing}


def amr_loop(mesh: Mesh, unknowns: Sequence[Unknown], volume_form, bc_fn,
             max_cycles: int = 4, threshold: float = 0.3,
             mode: str = "fraction", quad_order: str = "fifth",
             estimator: Optional[Callable] = None,
             region_fn: Optional[Callable] = None,
             tol: float = 1e-10, device="cuda",
             dtype: Optional[torch.dtype] = None) -> List[AMRResult]:
    """solve -> estimate -> flag -> refine, ``max_cycles`` times.

    ``region_fn(centroids) -> bool mask`` overrides the error estimator;
    otherwise ``estimator`` (default kelly_indicator on the first unknown)
    + flag_by_error(threshold, mode)."""
    results: List[AMRResult] = []
    for cyc in range(max_cycles):
        u, info = solve_conforming(mesh, unknowns, volume_form, bc_fn,
                                   quad_order=quad_order, tol=tol,
                                   device=device, dtype=dtype)
        fam0 = unknowns[0].family
        u0_slice = u[:mesh.dofmap(fam0).n_dofs]
        if estimator is None:
            eta = kelly_indicator(mesh, fam0, u0_slice)
        else:
            eta = estimator(mesh, u)
        results.append(AMRResult(mesh, u, eta, info.get("n_free", -1), info))
        if cyc == max_cycles - 1:
            break
        if region_fn is not None:
            cent = mesh.coords[mesh.conn[:, :GEOMS[mesh.geom].n_verts]
                               ].mean(axis=1)
            flags = np.asarray(region_fn(cent), bool)
        else:
            flags = flag_by_error(eta, threshold, mode=mode)
        if not np.any(flags):
            break
        mesh = refine_selective(mesh, flags)
    return results


def _reduced_system(mesh, unknowns, volume_form, bc_fn, quad_order="fifth",
                    face_form=None, device="cuda", dtype=None):
    """(assembler, C, free_idx, mask_f, reduced schedule) of one AMR level:
    the hanging-constraint reduction of solve_conforming, factored out so
    that the multigrid across AMR levels can build every level."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    asm = _assembler(mesh, unknowns, volume_form, bc_fn, quad_order,
                     face_form, dtype, device)
    C, free_idx = _constraints(mesh, unknowns)
    mask_f = np.asarray(asm.dirichlet_mask)[free_idx]
    sched = build_ptap_schedule(asm.pattern, C, dtype=dtype, device=device)
    return asm, C, free_idx, mask_f, sched


def _reduced_op(asm, C, free_idx, mask_f, sched, u_all):
    """Assemble at ``u_all`` and Galerkin-reduce by C with the Dirichlet
    identity restored on the reduced rows (the algebra of
    solve_conforming): (reduced ELL operator, reduced residual, C as a
    device operator)."""
    R, data = asm.make_assemble_fn()(u_all)
    cpat = sched.coarse_pattern
    A_r = op_from_pattern(cpat, _restore_dirichlet(sched.apply(data), cpat,
                                                   mask_f))
    Cop, CTop = op_pair_from_scipy(C, dtype=asm.dtype, device=asm.device)
    Rr = torch.where(torch.as_tensor(mask_f, device=asm.device), 0.0,
                     CTop @ R)
    return A_r, Rr, Cop


def solve_mg_amr(meshes, unknowns, volume_form, bc_fn, quad_order="fifth",
                 tol: float = 1e-10, maxiter: int = 200,
                 n_pre: int = 2, n_post: int = 2, device="cuda",
                 dtype: Optional[torch.dtype] = None):
    """V-cycle-preconditioned CG across the AMR level chain.

    meshes: the AMR chain, coarsest (uniform) first, each produced by
    refine_selective of the previous.  Every level assembles on its own
    mesh and reduces by its own constraint operator; the transfers between
    reduced spaces are P_red = (P_amr @ C_coarse)[free_fine, :], the
    embedding prolongation (identity on copied elements) composed with the
    coarse constraint interpolation, with the Dirichlet rows and columns
    masked.  Chebyshev smoothing; the coarsest level is LU-solved.
    Returns (u_all_fine, info): CG iterations, residual, convergence and
    the residual norm aimed at (tol * ||b||), levels, the
    finest level's hanging dofs, the routing of each level, and the host
    seconds of the set-up (every level's reduction, assembly and
    transfers, the hierarchy) and of the solve."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    t0 = time.perf_counter()
    levels = [_reduced_system(m, unknowns, volume_form, bc_fn, quad_order,
                              device=device, dtype=dtype) for m in meshes]
    routing: List[dict] = [{"n_rows": levels[0][4].coarse_pattern.n_rows,
                            "path": "lu",
                            "reason": "coarsest V-cycle level: dense LU "
                                      "solve"}]
    ops = []
    n_hang = levels[-1][1].shape[0] - levels[-1][1].shape[1]
    for li, (asm, C, free_idx, mask_f, sched) in enumerate(levels):
        u0 = _start(asm, C, free_idx, dtype, device)
        A_r, R_r, Cop = _reduced_op(asm, C, free_idx, mask_f, sched, u0)
        if li > 0:
            A_r = on_bell_frame(A_r, sched.coarse_pattern, device, routing)
        ops.append(A_r)
        if li == len(levels) - 1:
            rhs, Cop_f, u0_f = R_r, Cop, u0
    pr_pairs = []
    for l in range(len(meshes) - 1):
        _, C_c, _, mfc, _ = levels[l]
        _, _, free_f, mff, _ = levels[l + 1]
        P_all = block_diag_prolongation(meshes[l], meshes[l + 1], unknowns)
        P_red = (P_all @ C_c).tocsr()[free_f, :]
        pr_pairs.append(op_pair_from_scipy(
            mask_prolongation(P_red, mff, mfc), dtype=dtype, device=device))
    h = build_hierarchy_from_ops(ops, pr_pairs, smoother="chebyshev",
                                 n_pre=n_pre, n_post=n_post)
    t1 = _synced(device)
    A = ops[-1]
    delta, si = cg(A.matvec, -rhs, M=h.as_preconditioner("V"), tol=tol,
                   maxiter=maxiter)
    u = (u0_f + Cop_f @ delta).cpu().numpy()
    return u, {"iterations": si.iters, "residual": si.residual,
               "converged": si.converged, "target": si.target,
               "n_levels": len(meshes), "n_hanging": int(n_hang),
               "routing": routing,
               "setup_seconds": t1 - t0, "solve_seconds": _synced(device) - t1}


def _synced(device) -> float:
    """The host clock after the device's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
