"""System hierarchy: linear / nonlinear implicit systems with geometric-MG
preconditioned Krylov solves.

Each level owns one solve step (assemble -> PtAP chain -> MG-preconditioned
GMRES/FGMRES/CG -> correction), or its matrix-free variant (linearised
residual as the fine operator); the Newton and F-cycle drives are short
host loops around it.  Every tensor lives on the device given to
:meth:`System.init`.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import default_dtype, resolve_device
from ..algebra.bell import bell_backed, bell_device_plan, spmv_bell_cuda
from ..algebra.dia import spmv_dia_cuda
from ..algebra.krylov import cg, fgmres, gmres
from ..algebra.mg import (build_hierarchy, build_hierarchy_from_ops,
                          build_hierarchy_matfree)
from ..algebra.patchstencil import spmv_patch_cuda
from ..algebra.patchstencil3d import PatchTables3D
from ..algebra.sparse import op_from_scipy
from ..algebra.stencil import spmv_stencil_cuda
from ..algebra.transfer import (block_diag_prolongation, build_ptap_schedule,
                                mask_prolongation, op_pair_from_scipy)
from ..algebra.vanka import vanka_invert_cuda, vanka_sweep_cuda
from ..assembly.engine import Assembler, Unknown
from ..utils.telemetry import count, records_solve, span, timed
from .solution import DIRICHLET, MultiLevelSolution

# every CUDA kernel wrapper of the port, by kernel name; each counts its
# own launches (``fn.launches``)
KERNELS = {"bell_spmv": spmv_bell_cuda, "patch_stencil": spmv_patch_cuda,
           "dia_spmv": spmv_dia_cuda, "stencil_spmv": spmv_stencil_cuda,
           "vanka_colour": vanka_sweep_cuda,
           "vanka_invert": vanka_invert_cuda}


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel so far, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


@dataclasses.dataclass
class SolverConfig:
    outer: str = "gmres"            # "gmres" | "cg"
    rtol: float = 1e-8
    atol: float = 1e-50
    restart: int = 30
    max_outer: int = 20             # GMRES restarts / CG maxiter scale
    # "chebyshev" | "jacobi" | "vanka" | "vanka_gmres" (the block sweep
    # wrapped in krylov_m FGMRES iterations per level; a nonlinear
    # preconditioner, so the outer iteration becomes FGMRES)
    smoother: str = "chebyshev"
    n_pre: int = 2
    n_post: int = 2
    cheb_degree: int = 3
    vanka_block_elems: int = 2
    vanka_omega: float = 0.9
    # None = blocks over all elements; "material" = blocks never span two
    # element groups (the FSI fluid/solid split); a sequence of group ids =
    # blocks over those groups' elements only
    vanka_groups: Optional[object] = None
    # multiplicative (coloured sweeps, one residual refresh per colour) vs
    # additive (one batched sweep with overlap averaging, omega ~0.5)
    vanka_multiplicative: bool = True
    krylov_m: int = 5               # inner iterations of "vanka_gmres"
    mg_type: str = "V"              # "V" | "F" (F = coarse-to-fine ratchet)
    # cycle shape of ONE preconditioner application: "V" | "W" | "F"
    # (full MG: coarse solve first, then ascend with a V-cycle per level) |
    # "K" (Krylov-accelerated; forces the FGMRES outer) | "ADDITIVE" |
    # "KASKADE"
    mg_cycle: str = "V"
    use_mg: bool = True
    # "assembled" = ELL data + PtAP Galerkin chain; "bell" = the same
    # operators, with every Krylov/smoother matvec on a level of at least
    # 2048 rows through the sliced-ELL operator of the BELL frame
    # (algebra/bell.py, kernel B1); "patch" = every
    # refined level of a PatchedMultiLevelMesh assembles straight into a
    # patch-lattice stencil (algebra/patchstencil.py, kernel B2), the coarse
    # level stays ELL (needs coarse_op="rediscretize"); "matrix_free" = the
    # finest level's J.v is the linearised residual (no fine matrix data),
    # its smoother Chebyshev/Jacobi on a scatter-assembled diagonal, the
    # first coarse level re-assembled on its own mesh at the restricted
    # state, deeper levels Galerkin
    operator: str = "assembled"
    # coarse V-cycle operators: "galerkin" = PtAP chain from the fine
    # Jacobian; "rediscretize" = each coarse level re-assembled on its own
    # mesh at the restricted state (no PtAP schedule is built; stacked dofs
    # only; smoothers jacobi, chebyshev or multiplicative vanka on each
    # level's own pattern; operator="matrix_free" does not read it: its
    # first coarse level is always re-assembled, the deeper ones Galerkin)
    coarse_op: str = "galerkin"
    # dof ordering of the BELL frame: "identity" trusts the mesh numbering
    # (rebuilt with RCM where the JAX package's blocked-ELL slab would
    # exceed 24x the ELL bytes), "rcm" reorders at plan build
    bell_order: str = "identity"
    # cap on the cycle's depth: K = only the top K mesh levels form the
    # preconditioner hierarchy (0 = all); a truncated coarsest level above
    # coarse_dense_max_dofs is smoothed instead of LU-solved
    max_mg_levels: int = 0
    # dofs above which the coarsest V-cycle level is smoothed, not LU-solved
    coarse_dense_max_dofs: int = 20000
    # a single-level solve below this size is a dense direct solve
    coarse_direct_max_dofs: int = 20000
    # node-major interleaved stacked layout (assembly/engine.py)
    interleave_dofs: bool = False
    # nonlinear
    max_nonlinear: int = 15
    nonlinear_tol: float = 1e-8
    verbose: bool = False


class StepOut(NamedTuple):
    """One solve step: the new state, the correction, the linear solve's
    final residual, iterations and convergence, ||R(u)|| at the input, the
    residual norm the linear solve's stopping test aimed at, and the
    columns D = A^{-1} B of the step's ``extra_rhs`` B (None without)."""
    u: torch.Tensor
    delta: torch.Tensor
    lin_res: float
    lin_iters: int
    res_norm: float
    converged: bool
    lin_target: float
    extra: Optional[torch.Tensor] = None


class System:
    """Base equation system bound to a MultiLevelProblem."""

    def __init__(self, problem, name: str):
        self.problem = problem
        self.name = name
        self.unknown_names: List[str] = []
        self.volume_form: Optional[Callable] = None
        self.face_form: Optional[Callable] = None
        # element-local aux fields: (solution var, alias, use its old value)
        self.aux_specs: List[Tuple[str, str, bool]] = []
        self.aux_scalars: Dict[str, float] = {}
        self.config = SolverConfig()
        self._initialized = False
        # profile_step's split (assembly_s, coarsen_s, solve_step_s)
        self.timing: Dict[str, float] = {}
        self._routing_notes: List[dict] = []

    def add_unknown(self, *names: str) -> None:
        self.unknown_names.extend(names)

    def set_assembly(self, volume_form: Callable,
                     face_form: Optional[Callable] = None) -> None:
        """The weak form (a pure function, see assembly/forms.py) and an
        optional boundary-face form (``Assembler.set_face_form``)."""
        self.volume_form = volume_form
        self.face_form = face_form

    def add_aux_field(self, sol_var: str, alias: Optional[str] = None,
                      old: bool = False) -> None:
        """Expose another solution variable (or its old value) to the form
        as ``aux[alias]`` (element-local); call before :meth:`init`."""
        self.aux_specs.append(
            (sol_var, alias or (sol_var + ("_old" if old else "")), old))

    def set_scalar(self, **kw) -> None:
        self.aux_scalars.update(kw)

    @property
    def ml_sol(self) -> MultiLevelSolution:
        return self.problem.ml_sol

    @property
    def ml_mesh(self):
        return self.problem.ml_mesh

    # ---- setup --------------------------------------------------------
    @timed("setup.init")
    def init(self, device="cuda", dtype: Optional[torch.dtype] = None) -> None:
        """Build per-level assemblers, Dirichlet masks and transfers on
        ``device`` (solve precision ``dtype``: float64 on the host, float32
        on the card by default)."""
        cfg = self.config
        if cfg.operator not in ("assembled", "bell", "patch", "matrix_free"):
            raise ValueError(f"operator {cfg.operator!r}")
        if cfg.coarse_op not in ("galerkin", "rediscretize"):
            raise ValueError(f"coarse_op {cfg.coarse_op!r}")
        rediscretize = self._rediscretized
        if cfg.operator == "patch":
            # PtAP cannot consume the patch layout, so coarse V-cycle
            # operators are re-assembled per level
            if cfg.use_mg and not rediscretize:
                raise ValueError("operator='patch' needs "
                                 "coarse_op='rediscretize'")
            if cfg.smoother not in ("jacobi", "chebyshev"):
                raise ValueError("operator='patch': jacobi/chebyshev "
                                 "smoothers only")
        elif rediscretize and (cfg.smoother == "vanka_gmres" or (
                cfg.smoother == "vanka" and not cfg.vanka_multiplicative)):
            raise ValueError("coarse_op='rediscretize' takes jacobi, "
                             "chebyshev or multiplicative vanka smoothers")
        if cfg.interleave_dofs and cfg.operator in ("patch", "matrix_free"):
            raise ValueError("interleave_dofs needs assembled/bell "
                             "operators")
        if cfg.interleave_dofs and rediscretize:
            raise ValueError("interleave_dofs needs coarse_op='galerkin'")
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        ml_sol = self.ml_sol
        self.unknowns = [Unknown(n, ml_sol.vars[n].family)
                         for n in self.unknown_names]
        self.assemblers: List[Assembler] = []
        self.masks: List[np.ndarray] = []
        for l, mesh in enumerate(self.ml_mesh.levels):
            a = Assembler(mesh, self.unknowns,
                          quad_order=self.problem.quad_order,
                          dtype=self.dtype, interleave=cfg.interleave_dofs,
                          device=self.device)
            a.set_volume_form(self.volume_form)
            if (cfg.operator == "patch"
                    and getattr(mesh, "patch_plan", None) is not None):
                a.set_patch_layout(mesh.patch_plan)
            if self.face_form is not None:
                a.set_face_form(self.face_form)
            for svar, alias, _ in self.aux_specs:
                a.add_aux_field(alias, ml_sol.vars[svar].family)
            mask = np.zeros(a.n_dofs, bool)
            vals = np.zeros(a.n_dofs)
            for u in self.unknowns:
                codes = ml_sol.bdc[l].get(u.name)
                if codes is None:
                    continue
                off = a.offsets[u.name]
                sel = codes == DIRICHLET
                mask[off:off + len(codes)][sel] = True
                vals[off:off + len(codes)][sel] = ml_sol.bdc_value[l][u.name][sel]
            a.set_dirichlet(mask, vals)
            self.assemblers.append(a)
            self.masks.append(a.dirichlet_mask)
        self._transfer_cache: Dict[int, list] = {}
        self._build_transfers()
        self._step_fns: Dict[int, Callable] = {}
        self._bell_plans: Dict[object, object] = {}
        self._initialized = True

    @property
    def _rediscretized(self) -> bool:
        """Coarse levels re-assembled per step (``coarse_op="rediscretize"``;
        the matrix-free step builds its own coarse side and ignores it)."""
        return (self.config.coarse_op == "rediscretize"
                and self.config.operator != "matrix_free")

    def _build_transfers(self) -> None:
        """Transfers against the current Dirichlet masks, chained top-down
        so each schedule consumes the actual ELL pattern of the level above;
        rediscretized levels need P and R only, plus the state restriction
        of each level."""
        rediscretize = self._rediscretized
        n_levels = len(self.ml_mesh.levels)
        self.transfers = [None] * (n_levels - 1)
        self._rsol = [None] * (n_levels - 1)
        pat_above = None if rediscretize else self.assemblers[-1].pattern
        for l in range(n_levels - 2, -1, -1):
            P, R = self._physical_pair(l)
            self.transfers[l] = self._build_transfer(l, P, R, pat_above)
            if rediscretize:
                self._rsol[l] = self._state_restriction(P)
            else:
                pat_above = self.transfers[l][2].coarse_pattern

    def _check_device(self, device) -> None:
        if device is not None and resolve_device(device) != self.device:
            raise ValueError(f"system '{self.name}' was initialised on "
                             f"{self.device}, not {device}")

    # ---- stacked vector <-> ml_sol ------------------------------------
    def gather(self, level: int = -1) -> np.ndarray:
        a = self.assemblers[level]
        out = np.zeros(a.n_dofs)
        for u in self.unknowns:
            off = a.offsets[u.name]
            s = self.ml_sol.sol[level][u.name]
            out[off:off + len(s)] = s
        if a.stack_perm is not None:          # logical -> physical
            phys = np.zeros(a.n_dofs)
            phys[a.stack_perm] = out
            return phys
        return out

    def scatter(self, x: np.ndarray, level: int = -1) -> None:
        a = self.assemblers[level]
        x = np.asarray(x)
        if a.stack_perm is not None:          # physical -> logical
            x = x[a.stack_perm]
        for u in self.unknowns:
            off = a.offsets[u.name]
            n = self.ml_sol.n_dofs(u.name, level)
            self.ml_sol.sol[level][u.name][:] = x[off:off + n]

    def snapshot(self) -> List[Dict[str, np.ndarray]]:
        """A copy of every level's fields, for ``reset``."""
        return [{n: a.copy() for n, a in lv.items()}
                for lv in self.ml_sol.sol]

    def reset(self, state: List[Dict[str, np.ndarray]]) -> None:
        """Every level's fields back to ``state`` (from ``snapshot``), and
        the built steps dropped: the next solve builds them from the
        config as it is then (another cycle shape, smoother or compute
        type)."""
        for lv, saved in zip(self.ml_sol.sol, state):
            for n, a in saved.items():
                lv[n][:] = a
        self._step_fns.clear()

    def _aux_arrays(self, level: int) -> Dict[str, torch.Tensor]:
        """The aux fields of ``level`` as read now (old values after the
        transient drive's copy_to_old), on the device."""
        out = {}
        for svar, alias, old in self.aux_specs:
            src = self.ml_sol.sol_old if old else self.ml_sol.sol
            out[alias] = torch.as_tensor(src[level][svar], dtype=self.dtype,
                                         device=self.device)
            count("host_wait.aux_upload")
        return out

    # ---- routing telemetry -----------------------------------------------
    def _route_note(self, **kw) -> None:
        """Record an operator auto-routing decision once (shown by
        ``solver_info()``)."""
        if kw not in self._routing_notes:
            self._routing_notes.append(kw)

    def solver_info(self) -> Dict:
        """Solver configuration + recorded operator-routing decisions."""
        cfg = self.config
        return {
            "system": self.name,
            "outer": cfg.outer, "operator": cfg.operator,
            "smoother": cfg.smoother, "mg_type": cfg.mg_type,
            "mg_cycle": cfg.mg_cycle, "n_pre": cfg.n_pre,
            "n_post": cfg.n_post, "rtol": cfg.rtol,
            "restart": cfg.restart, "max_outer": cfg.max_outer,
            "interleave_dofs": cfg.interleave_dofs,
            "device": str(getattr(self, "device", None)),
            "routing": list(self._routing_notes),
        }

    def _bell_dev(self, pattern):
        """Cached device plan (sliced ELL in the BELL frame) for an
        operator pattern, as :func:`bell_device_plan` decides it: None
        below its row threshold."""
        # EllPattern has identity equality: the pattern object is the key
        if pattern not in self._bell_plans:
            with span("setup.step_build"):
                count("rebuild.bell_plan")
                dev, note = bell_device_plan(pattern, self.config.bell_order,
                                             self.device)
            self._route_note(**note)
            self._bell_plans[pattern] = dev
        return self._bell_plans[pattern]

    # ---- transfers ---------------------------------------------------------
    def _permute_transfer(self, M, row_perm, col_perm):
        """Reindex a (rows x cols) scipy transfer into the physical frame."""
        if row_perm is None and col_perm is None:
            return M
        coo = M.tocoo()
        r = coo.row if row_perm is None else row_perm[coo.row]
        c = coo.col if col_perm is None else col_perm[coo.col]
        out = sp.csr_matrix((coo.data, (r, c)), shape=M.shape)
        out.sort_indices()
        return out

    def _make_transfer_pair(self, l: int):
        """Unmasked scipy (P, R) for level l -> l+1 in the logical
        (per-variable block) layout; R = None means P^T (Galerkin).
        ``MonolithicFSISystem`` overrides this with the FSI Petrov-Galerkin
        restriction."""
        P = block_diag_prolongation(self.ml_mesh.levels[l],
                                    self.ml_mesh.levels[l + 1], self.unknowns)
        return P, None

    def _physical_pair(self, l: int):
        """:meth:`_make_transfer_pair` in the physical frame: P's rows are
        fine dofs and its columns coarse ones, R the other way round."""
        P, R = self._make_transfer_pair(l)
        pf = self.assemblers[l + 1].stack_perm
        pc = self.assemblers[l].stack_perm
        P = self._permute_transfer(P, pf, pc)
        if R is not None:
            R = self._permute_transfer(R, pc, pf)
        return P, R

    def _build_transfer(self, l: int, P, R, pat_above):
        """(P_op, R_op, coarse schedule) for level l -> l+1 from the
        unmasked physical-frame pair (``R`` None: P^T); the schedule (R A P,
        or P^T A P) runs against the fine-side pattern ``pat_above`` (None:
        no schedule)."""
        # essential-dof masking in the PHYSICAL frame (R: masks swapped)
        Pm = mask_prolongation(P, self.masks[l + 1], self.masks[l])
        Rm = (None if R is None
              else mask_prolongation(R, self.masks[l], self.masks[l + 1]))
        Pop, Rop = op_pair_from_scipy(Pm, dtype=self.dtype, R=Rm,
                                      device=self.device)
        sched = None if pat_above is None else build_ptap_schedule(
            pat_above, Pm, dtype=self.dtype, R=Rm, device=self.device)
        return (Pop, Rop, sched)

    def _state_restriction(self, P):
        """(P^T, winv): the averaged state restriction
        u_c = (P^T u_f) * winv with winv = 1 / (P^T 1) (0 where P^T 1 = 0),
        of the unmasked prolongation."""
        Rsol, _ = op_from_scipy(P.T.tocsr(), self.device, self.dtype)
        w = np.asarray(P.sum(axis=0)).ravel()
        winv = np.where(np.abs(w) > 1e-14,
                        1.0 / np.maximum(np.abs(w), 1e-14), 0.0)
        return Rsol, torch.as_tensor(winv, dtype=self.dtype,
                                     device=self.device)

    def _transfers_for(self, level: int):
        """PtAP-chained transfers for a hierarchy whose finest level is
        ``level`` (cached)."""
        n_levels = len(self.ml_mesh.levels)
        if level < 0:
            level += n_levels
        if level not in self._transfer_cache:
            if level == n_levels - 1 or self._rediscretized:
                tr = self.transfers[:level]
            else:
                with span("setup.step_build"):
                    count("rebuild.transfers")
                    tr = [None] * level
                    pat_above = self.assemblers[level].pattern
                    for l in range(level - 1, -1, -1):
                        tr[l] = self._build_transfer(
                            l, *self._physical_pair(l), pat_above)
                        pat_above = tr[l][2].coarse_pattern
            self._transfer_cache[level] = tr
        return self._transfer_cache[level]

    # ---- per-level solve step ----------------------------------------------
    def step_fn(self, level: int = -1, device=None) -> Callable:
        """(u, tables=None, aux_scalars=None, aux_fields=None,
        extra_rhs=None) -> :class:`StepOut`.  ``aux_fields`` (the level's
        element-local aux fields) default to :meth:`_aux_arrays` read at
        the call, never at the build: a cached step reads the old values of
        the current time step.  ``extra_rhs`` (n, k): k more right-hand
        sides B, each solved by the same outer solve with the same
        preconditioner (one dense solve with k columns on a coarse-direct
        level); their solutions D = A^{-1} B come back as ``extra`` (the
        bordered solves of scalar global unknowns).  ``device``: None or
        the device the system was initialised on."""
        self._check_device(device)
        if level < 0:
            level += len(self.ml_mesh.levels)
        step = self._step_fns.get(level)
        if step is None:
            with span("setup.step_build"):
                count("rebuild.step")
                step = self._step_fns[level] = self._build_step(level)
        return step

    def _build_step(self, level: int) -> Callable:
        """The solve step of ``level`` (see :meth:`step_fn`)."""
        n_levels = len(self.ml_mesh.levels)
        a = self.assemblers[level]
        assemble = a.make_assemble_fn(pass_tables=True)
        cfg = self.config
        transfers = (self._transfers_for(level)
                     if (cfg.use_mg and level > 0) else [])
        base = 0                       # coarsest mesh level of the cycle
        if transfers and cfg.max_mg_levels >= 2:
            base = max(0, level - (cfg.max_mg_levels - 1))
            transfers = transfers[base:]
        dmasks = [torch.as_tensor(m, device=self.device)
                  for m in self.masks[base:level]]
        rediscretize = self._rediscretized and bool(transfers)
        if rediscretize and base:
            raise NotImplementedError("coarse_op='rediscretize' with "
                                      "max_mg_levels")
        # a coarsest level within coarse_dense_max_dofs (a rediscretized
        # one always) is LU-solved in the V-cycle: it is never smoothed nor
        # multiplied, so it gets no Vanka blocks and no BELL-frame operator
        if rediscretize:
            n_coarse = self.assemblers[0].n_dofs
        elif transfers:
            n_coarse = transfers[0][2].coarse_pattern.n_rows
        coarse_lu = bool(transfers) and (
            rediscretize or n_coarse <= cfg.coarse_dense_max_dofs)
        if coarse_lu:
            self._route_note(n_rows=n_coarse, path="lu",
                             reason="coarsest V-cycle level: dense LU solve")
        if cfg.operator == "patch":
            for l in range(1 if transfers else level, level + 1):
                al = self.assemblers[l]
                if isinstance(al.patch_tab, PatchTables3D):
                    # the 3-D patch operator is plain torch (the JAX
                    # package has no Pallas kernel for it)
                    self._route_note(n_rows=al.n_dofs, path="patch3d",
                                     kernel=None)
                elif al.patch_tab is not None:
                    self._route_note(n_rows=al.n_dofs, path="patch",
                                     kernel="patch_stencil")
                else:
                    self._route_note(n_rows=al.n_dofs, path="ell")
        coarse_assemble = [self.assemblers[l].make_assemble_fn(
            pass_tables=True) for l in range(level)] if rediscretize else None

        # the coarsest level of an MG drive gets a direct dense solve
        coarse_direct = (not transfers and cfg.use_mg
                         and a.n_dofs <= cfg.coarse_direct_max_dofs
                         and n_levels > 1)

        if cfg.operator == "matrix_free" and not coarse_direct:
            if base:
                raise NotImplementedError("operator='matrix_free' with "
                                          "max_mg_levels")
            return self._matrix_free_step(level, a, transfers)

        vblocks = None
        if cfg.smoother in ("vanka", "vanka_gmres"):
            from ..algebra.vanka import build_element_blocks
            if transfers:
                # j indexes the cycle's levels, base + j the mesh levels;
                # a Galerkin coarse operator lives on its PtAP pattern, a
                # rediscretized one on its level's own assembler pattern
                vblocks = [None if (j == 0 and coarse_lu) else
                           build_element_blocks(
                               self.assemblers[base + j],
                               cfg.vanka_block_elems,
                               pattern=(transfers[j][2].coarse_pattern
                                        if (j < len(transfers)
                                            and not rediscretize) else None),
                               groups=cfg.vanka_groups, device=self.device)
                           for j in range(level + 1 - base)]
            else:
                vblocks = [build_element_blocks(a, cfg.vanka_block_elems,
                                                groups=cfg.vanka_groups,
                                                device=self.device)]

        bell_fine = bell_coarse = None
        if cfg.operator == "bell" and not coarse_direct:
            bell_fine = self._bell_dev(a.pattern)
            if transfers:
                bell_coarse = [None if (l == 0 and coarse_lu) else
                               self._bell_dev(
                                   self.assemblers[l].pattern if rediscretize
                                   else t[2].coarse_pattern)
                               for l, t in enumerate(transfers)] + [None]

        def step(u, tables=None, aux_scalars=None, aux_fields=None,
                 extra_rhs=None):
            with span("step.assemble"):
                tables = a.device_tables_cached() if tables is None else tables
                if aux_fields is None:
                    aux_fields = self._aux_arrays(level)
                u = u.to(device=self.device, dtype=self.dtype)
                if extra_rhs is not None:
                    if not torch.is_tensor(extra_rhs):
                        count("host_wait.extra_rhs_upload")
                    extra_rhs = torch.as_tensor(extra_rhs, dtype=self.dtype,
                                                device=self.device)
                R, data = assemble(u, tables, aux_scalars, aux_fields)
                res_norm = float(torch.linalg.norm(R))
                count("host_wait.res_norm")
                A = a.op_with(data, tables.get("ell_cols"))
                if bell_fine is not None:
                    A = bell_backed(bell_fine, A)
            if coarse_direct:
                with span("step.krylov"):         # the direct solve
                    Ad = A.to_dense()
                    delta = torch.linalg.solve(Ad, -R)
                    res = float(torch.linalg.norm(R + A @ delta))
                    D = (None if extra_rhs is None
                         else torch.linalg.solve(Ad, extra_rhs))
                    count("host_wait.direct_solve_check",
                          1 if extra_rhs is None else 2)
                    count("host_wait.direct_residual")
                return StepOut(u + delta, delta, res, 1, res_norm, True,
                               max(cfg.rtol * res_norm, cfg.atol), D)
            if rediscretize:
                # each coarse level assembled on its own mesh at the
                # averaged-restricted state
                with span("step.coarsen"):
                    ops = [None] * level + [A]
                    u_l = u
                    for l in range(level - 1, -1, -1):
                        Rsol, winv = self._rsol[l]
                        u_l = (Rsol @ u_l) * winv
                        a_c = self.assemblers[l]
                        t_c = a_c.device_tables_cached()
                        _, data_l = coarse_assemble[l](u_l, t_c, aux_scalars,
                                                       self._aux_arrays(l))
                        ops[l] = a_c.op_with(data_l, t_c.get("ell_cols"))
                with span("step.mg_setup"):
                    if bell_coarse is not None:
                        ops = [op if bp is None else bell_backed(bp, op)
                               for bp, op in zip(bell_coarse, ops)]
                    h = build_hierarchy_from_ops(
                        ops, [(t[0], t[1]) for t in transfers],
                        smoother=cfg.smoother, n_pre=cfg.n_pre,
                        n_post=cfg.n_post, cheb_degree=cfg.cheb_degree,
                        vanka_blocks=vblocks, vanka_omega=cfg.vanka_omega,
                        krylov_m=cfg.krylov_m,
                        vanka_multiplicative=cfg.vanka_multiplicative)
                M = h.as_preconditioner(cfg.mg_cycle)
            elif transfers:
                h = build_hierarchy(A, transfers, smoother=cfg.smoother,
                                    n_pre=cfg.n_pre, n_post=cfg.n_post,
                                    cheb_degree=cfg.cheb_degree,
                                    dir_masks=dmasks, vanka_blocks=vblocks,
                                    vanka_omega=cfg.vanka_omega,
                                    krylov_m=cfg.krylov_m,
                                    vanka_multiplicative=cfg.vanka_multiplicative,
                                    coarse_dense_max=cfg.coarse_dense_max_dofs,
                                    bell_plans=bell_coarse,
                                    device=self.device)
                M = h.as_preconditioner(cfg.mg_cycle)
            elif cfg.smoother in ("vanka", "vanka_gmres"):
                from ..algebra.vanka import vanka_smoother
                with span("step.mg_setup"):
                    sm = vanka_smoother(A, vblocks[0], omega=cfg.vanka_omega)
                M = lambda r: sm(torch.zeros_like(r), r)
            else:
                with span("step.mg_setup"):
                    d = A.diagonal()
                    dsafe = torch.where(d.abs() < 1e-30, 1.0, d)
                M = lambda r: r / dsafe
            delta, info = self._outer_solve(A.matvec, -R, M)
            D = None
            if extra_rhs is not None:
                D = torch.stack([self._outer_solve(A.matvec, extra_rhs[:, j],
                                                   M)[0]
                                 for j in range(extra_rhs.shape[1])], dim=1)
            return StepOut(u + delta, delta, info.residual, info.iters,
                           res_norm, info.converged, info.target, D)

        return step

    @timed("step.krylov")
    def _outer_solve(self, A: Callable, b: torch.Tensor, M: Callable):
        """The configured outer Krylov solve of ``A x = b``.  An
        inner-Krylov smoother ("vanka_gmres") or a K-cycle makes ``M`` a
        NONLINEAR preconditioner, so the outer iteration is then flexible
        (right-preconditioned FGMRES, Saad 1993)."""
        cfg = self.config
        if cfg.outer == "cg":
            return cg(A, b, M=M, tol=cfg.rtol, atol=cfg.atol,
                      maxiter=cfg.max_outer * cfg.restart)
        flexible = (cfg.smoother == "vanka_gmres"
                    or cfg.mg_cycle.upper() == "K")
        return (fgmres if flexible else gmres)(
            A, b, M=M, tol=cfg.rtol, atol=cfg.atol, restart=cfg.restart,
            max_restarts=cfg.max_outer)

    def _matrix_free_step(self, level: int, a, transfers) -> Callable:
        """Matrix-free solve step: the fine operator is the linearised
        residual (``Assembler.make_linearized_fn``) with the Dirichlet rows
        kept as identity — no fine-level matrix data is ever built.  MG
        coarse side: the level below is re-assembled on its own mesh at the
        averaged-restricted state u_c = (P^T u) / (P^T 1); deeper levels
        Galerkin-coarsen from it."""
        cfg = self.config
        linearize = a.make_linearized_fn()
        diag_fn = a.make_diag_fn()
        m_f = torch.as_tensor(a.dirichlet_mask, device=self.device)
        self._route_note(n_rows=a.n_dofs, path="matrix_free")
        if transfers:
            sub_tr = self._transfers_for(level - 1)
            fine_pr = transfers[level - 1][:2]
            a_c = self.assemblers[level - 1]
            assemble_c = a_c.make_assemble_fn(pass_tables=True)
            Rsol, winv = self._state_restriction(
                self._physical_pair(level - 1)[0])
            sub_masks = [torch.as_tensor(m, device=self.device)
                         for m in self.masks[:level - 1]]
            # Vanka on the assembled sub-levels (the LU-solved coarsest
            # one excepted); the fine level has no block slots
            vblocks = None
            if cfg.smoother == "vanka":
                from ..algebra.vanka import build_element_blocks
                vblocks = [None if l == 0 else build_element_blocks(
                    self.assemblers[l], cfg.vanka_block_elems,
                    pattern=(sub_tr[l][2].coarse_pattern
                             if l < len(sub_tr) else None),
                    groups=cfg.vanka_groups, device=self.device)
                    for l in range(level)]

        def step(u, tables=None, aux_scalars=None, aux_fields=None):
            with span("step.assemble"):
                tables = a.device_tables_cached() if tables is None else tables
                if aux_fields is None:
                    aux_fields = self._aux_arrays(level)
                u = u.to(device=self.device, dtype=self.dtype)
                R, jv = linearize(u, tables, aux_scalars, aux_fields)
                res_norm = float(torch.linalg.norm(R))
                count("host_wait.res_norm")
                diag = diag_fn(u, tables, aux_scalars, aux_fields)

            def Amv(v):
                return torch.where(m_f, v, jv(torch.where(m_f, 0.0, v)))

            if transfers:
                with span("step.coarsen"):
                    t_c = a_c.device_tables_cached()
                    _, data_c = assemble_c((Rsol @ u) * winv, t_c,
                                           aux_scalars,
                                           self._aux_arrays(level - 1))
                h = build_hierarchy_matfree(
                    Amv, diag, a_c.op_with(data_c, t_c.get("ell_cols")),
                    list(sub_tr) + [fine_pr], smoother=cfg.smoother,
                    n_pre=cfg.n_pre, n_post=cfg.n_post,
                    cheb_degree=cfg.cheb_degree, dir_masks=sub_masks,
                    vanka_blocks=vblocks, vanka_omega=cfg.vanka_omega,
                    device=self.device)
                M = h.as_preconditioner(cfg.mg_cycle)
            else:
                with span("step.mg_setup"):
                    dsafe = torch.where(diag.abs() < 1e-30, 1.0, diag)
                M = lambda r: r / dsafe
            delta, info = self._outer_solve(Amv, -R, M)
            return StepOut(u + delta, delta, info.residual, info.iters,
                           res_norm, info.converged, info.target)

        return step

    # ---- norms ---------------------------------------------------------
    def eps_norms(self, delta: np.ndarray, u: np.ndarray,
                  level: int) -> Dict[str, float]:
        """Per-variable ||delta|| / ||u|| (the Newton convergence test)."""
        a = self.assemblers[level]
        delta, u = np.asarray(delta), np.asarray(u)
        if a.stack_perm is not None:          # physical -> logical slices
            delta, u = delta[a.stack_perm], u[a.stack_perm]
        out = {}
        for unk in self.unknowns:
            off = a.offsets[unk.name]
            n = self.dofmap_size(unk.name, level)
            e = np.linalg.norm(delta[off:off + n])
            s = np.linalg.norm(u[off:off + n])
            out[unk.name] = float(e / max(s, 1e-250))
        return out

    def profile_step(self, level: int = -1, reps: int = 3) -> Dict[str, float]:
        """Per-phase wall-time split of one solve step at ``level`` —
        assembly / Galerkin coarsening into ``level`` (its transfer's PtAP
        or R A P schedule; only with ``use_mg`` and ``level`` > 0) / the
        whole solve step — the split the reference prints per run
        (LinearImplicitSystem.cpp:326,372,406 assembly vs preparation vs
        solver time; NonLinearImplicitSystem.cpp:89-98).  Each phase runs
        once to warm up, then ``reps`` times at the CURRENT solution state,
        each call ending in ``torch.cuda.synchronize()`` on the card; the
        best is kept.  The phases overlap (the step assembles and
        coarsens too), so the split is diagnostic, not additive.  Returns
        seconds under the keys ``assembly_s``, ``coarsen_s`` and
        ``solve_step_s``, also written into ``self.timing``."""
        n_levels = len(self.ml_mesh.levels)
        if level < 0:
            level += n_levels
        a = self.assemblers[level]
        assemble = a.make_assemble_fn(pass_tables=True)
        u = torch.as_tensor(self.gather(level), dtype=self.dtype,
                            device=self.device)
        tabs = a.device_tables_cached()
        aux = self._aux_arrays(level)
        scal = self.aux_scalars
        cuda = self.device.type == "cuda"

        def best(fn):
            fn()
            ts = []
            for _ in range(reps):
                t0 = _time.perf_counter()
                fn()
                if cuda:
                    torch.cuda.synchronize(self.device)
                ts.append(_time.perf_counter() - t0)
            return min(ts)

        out = {"assembly_s": best(lambda: assemble(u, tabs, scal, aux))}
        _, data = assemble(u, tabs, scal, aux)
        if self.config.use_mg and level > 0:
            sched = self._transfers_for(level)[-1][2]
            if sched is not None:
                out["coarsen_s"] = best(lambda: sched.apply(data))
        step = self.step_fn(level)
        out["solve_step_s"] = best(lambda: step(u, tabs, scal, aux))
        self.timing.update(out)
        return out

    def dofmap_size(self, name: str, level: int) -> int:
        return self.ml_sol.n_dofs(name, level)

    def _levels_to_solve(self):
        n_levels = len(self.ml_mesh.levels)
        return (range(n_levels) if self.config.mg_type.upper() == "F"
                else [n_levels - 1])

    def _run_step(self, l: int) -> StepOut:
        with span("drive"):
            u = torch.as_tensor(self.gather(l), dtype=self.dtype,
                                device=self.device)
            count("host_wait.gather_upload")
        k0 = launch_counts()
        with span("step") as timer:
            out = self.step_fn(l)(u, None, self.aux_scalars,
                                  self._aux_arrays(l))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                count("host_wait.step_sync")
        self.last_step_seconds = timer.seconds
        self.last_step_launches = {k: n - k0[k]
                                   for k, n in launch_counts().items()}
        return out

    def _refine_to(self, l: int) -> None:
        """F-cycle ratchet: prolong level l's solution to l+1 and re-impose
        the fine Dirichlet values."""
        self.ml_sol.refine_from(l)
        self._apply_bc_values(l + 1)

    def _apply_bc_values(self, level: int) -> None:
        for u in self.unknowns:
            codes = self.ml_sol.bdc[level].get(u.name)
            if codes is None:
                continue
            sel = codes == DIRICHLET
            self.ml_sol.sol[level][u.name][sel] = \
                self.ml_sol.bdc_value[level][u.name][sel]


class LinearImplicitSystem(System):
    """One assemble + MG-preconditioned solve on the finest level (V) or on
    every level, coarse to fine (F)."""

    @records_solve
    def solve(self, device=None) -> Dict:
        assert self._initialized, "call init() first"
        self._check_device(device)
        info = {}
        levels = self._levels_to_solve()
        for l in levels:
            out = self._run_step(l)
            with span("drive"):
                self.scatter(out.u.cpu().numpy(), l)
                count("host_wait.solution_copy")
            info = {"level": l, "residual": out.lin_res,
                    "target": out.lin_target,
                    "iters": out.lin_iters, "converged": out.converged,
                    "seconds": self.last_step_seconds,
                    "kernel_launches": self.last_step_launches}
            if l < levels[-1]:
                with span("drive"):
                    self._refine_to(l)
        if self.config.verbose:
            print(f"[{self.name}] solver: {self.solver_info()}")
        return info


class NonLinearImplicitSystem(LinearImplicitSystem):
    """Newton-MG: outer Newton loop per level with per-variable relative
    correction norms as the stopping test."""

    @records_solve
    def solve(self, device=None) -> Dict:
        assert self._initialized, "call init() first"
        self._check_device(device)
        cfg = self.config
        history = []
        levels = self._levels_to_solve()
        for l in levels:
            restarted = False
            it = 0
            while it < cfg.max_nonlinear:
                out = self._run_step(l)
                with span("drive"):
                    u_new = out.u.cpu().numpy()
                    norms = self.eps_norms(out.delta.cpu().numpy(), u_new, l)
                    count("host_wait.solution_copy", 2)
                    worst = max(norms.values())
                    if np.isnan(worst) or np.isinf(worst):
                        # NaN recovery: restart the level once from its
                        # Dirichlet values
                        if not restarted:
                            restarted = True
                            self._apply_bc_values(l)
                            it = 0
                            continue
                        raise FloatingPointError(f"NaN in system '{self.name}'"
                                                 f" level {l} after restart")
                    self.scatter(u_new, l)
                history.append({"level": l, "newton_it": it, "eps": norms,
                                "lin_res": out.lin_res,
                                "lin_target": out.lin_target,
                                "lin_iters": out.lin_iters,
                                "converged": out.converged,
                                "res_norm": out.res_norm,
                                "seconds": self.last_step_seconds,
                                "kernel_launches": self.last_step_launches})
                it += 1
                if worst < cfg.nonlinear_tol:
                    break
            if l < levels[-1]:
                with span("drive"):
                    self._refine_to(l)
        self.history = history
        if cfg.verbose:
            print(f"[{self.name}] solver: {self.solver_info()}")
        return history[-1] if history else {}

