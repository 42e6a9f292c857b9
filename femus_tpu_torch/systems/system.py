"""System hierarchy: linear / nonlinear implicit systems with geometric-MG
preconditioned Krylov solves.

Each level owns one solve step (assemble -> PtAP chain -> MG-preconditioned
GMRES/CG -> correction); the Newton and F-cycle drives are short host loops
around it.  Every tensor lives on the device given to :meth:`System.init`.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .. import default_dtype, resolve_device
from ..algebra.bell import bell_backed, build_bell_plan, spmv_bell_cuda
from ..algebra.krylov import cg, gmres
from ..algebra.mg import build_hierarchy
from ..algebra.transfer import (block_diag_prolongation, build_ptap_schedule,
                                mask_prolongation, op_pair_from_scipy)
from ..assembly.engine import Assembler, Unknown
from .solution import DIRICHLET, MultiLevelSolution


@dataclasses.dataclass
class SolverConfig:
    outer: str = "gmres"            # "gmres" | "cg"
    rtol: float = 1e-8
    atol: float = 1e-50
    restart: int = 30
    max_outer: int = 20             # GMRES restarts / CG maxiter scale
    smoother: str = "chebyshev"     # "chebyshev" | "jacobi" | "vanka"
    n_pre: int = 2
    n_post: int = 2
    cheb_degree: int = 3
    vanka_block_elems: int = 2
    vanka_omega: float = 0.9
    # multiplicative (coloured sweeps, one residual refresh per colour) vs
    # additive (one batched sweep with overlap averaging, omega ~0.5)
    vanka_multiplicative: bool = True
    mg_type: str = "V"              # "V" | "F" (F = coarse-to-fine ratchet)
    use_mg: bool = True
    # "assembled" = ELL data + PtAP Galerkin chain; "bell" = the same
    # operators, with every Krylov/smoother matvec on a level of at least
    # 2048 rows on the blocked-ELL slab (algebra/bell.py)
    operator: str = "assembled"
    # dof ordering of the BELL slabs: "identity" trusts the mesh numbering
    # (a plan whose slab exceeds 24x the ELL bytes is rebuilt with RCM),
    # "rcm" reorders at plan build
    bell_order: str = "identity"
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
    final residual, iterations and convergence, and ||R(u)|| at the input."""
    u: torch.Tensor
    delta: torch.Tensor
    lin_res: float
    lin_iters: int
    res_norm: float
    converged: bool


class System:
    """Base equation system bound to a MultiLevelProblem."""

    def __init__(self, problem, name: str):
        self.problem = problem
        self.name = name
        self.unknown_names: List[str] = []
        self.volume_form: Optional[Callable] = None
        self.aux_scalars: Dict[str, float] = {}
        self.config = SolverConfig()
        self._initialized = False
        self.timing = {"solve": 0.0}
        self._routing_notes: List[dict] = []

    def add_unknown(self, *names: str) -> None:
        self.unknown_names.extend(names)

    def set_assembly(self, volume_form: Callable) -> None:
        """The weak form (a pure function, see assembly/forms.py)."""
        self.volume_form = volume_form

    def set_scalar(self, **kw) -> None:
        self.aux_scalars.update(kw)

    @property
    def ml_sol(self) -> MultiLevelSolution:
        return self.problem.ml_sol

    @property
    def ml_mesh(self):
        return self.problem.ml_mesh

    # ---- setup --------------------------------------------------------
    def init(self, device="cuda", dtype: Optional[torch.dtype] = None) -> None:
        """Build per-level assemblers, Dirichlet masks and transfers on
        ``device`` (solve precision ``dtype``: float64 on the host, float32
        on the card by default)."""
        cfg = self.config
        if cfg.operator not in ("assembled", "bell"):
            raise NotImplementedError(f"operator {cfg.operator!r} is not "
                                      "ported")
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
        # transfers, chained top-down so each schedule consumes the actual
        # ELL pattern of the level above
        n_levels = len(self.ml_mesh.levels)
        self.transfers = [None] * (n_levels - 1)
        pat_above = self.assemblers[-1].pattern
        self._transfer_cache: Dict[int, list] = {}
        for l in range(n_levels - 2, -1, -1):
            self.transfers[l] = self._build_transfer(l, pat_above)
            pat_above = self.transfers[l][2].coarse_pattern
        self._step_fns: Dict[int, Callable] = {}
        self._bell_plans: Dict[object, object] = {}
        self._initialized = True

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
            "n_pre": cfg.n_pre,
            "n_post": cfg.n_post, "rtol": cfg.rtol,
            "restart": cfg.restart, "max_outer": cfg.max_outer,
            "interleave_dofs": cfg.interleave_dofs,
            "device": str(getattr(self, "device", None)),
            "routing": list(self._routing_notes),
        }

    def _bell_dev(self, pattern):
        """Cached BELL device plan for an operator pattern; None below 2048
        rows, where the ELL gather is already cheap."""
        if pattern.n_rows < 2048:
            self._route_note(n_rows=pattern.n_rows, path="ell",
                             reason="below bell threshold (2048 rows)")
            return None
        # EllPattern has identity equality: the pattern object is the key
        if pattern not in self._bell_plans:
            order = self.config.bell_order
            plan = build_bell_plan(
                pattern, perm="identity" if order == "identity" else None)
            if order == "identity" and plan.nnz_bytes_ratio > 24.0:
                ratio = plan.nnz_bytes_ratio
                plan = build_bell_plan(pattern)        # RCM rescue
                self._route_note(
                    n_rows=pattern.n_rows, path="bell", order="rcm-rescue",
                    reason=f"identity slab {ratio:.1f} B/nnz > 24.0, "
                           f"rebuilt with RCM ({plan.nnz_bytes_ratio:.1f})")
            else:
                self._route_note(n_rows=pattern.n_rows, path="bell",
                                 order=order)
            self._bell_plans[pattern] = plan.to_device(self.device)
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

    def _build_transfer(self, l: int, pat_above):
        """(P_op, R_op, coarse schedule) for level l -> l+1 against the
        fine-side pattern ``pat_above``."""
        P = block_diag_prolongation(self.ml_mesh.levels[l],
                                    self.ml_mesh.levels[l + 1], self.unknowns)
        P = self._permute_transfer(P, self.assemblers[l + 1].stack_perm,
                                   self.assemblers[l].stack_perm)
        # essential-dof masking in the PHYSICAL frame
        Pm = mask_prolongation(P, self.masks[l + 1], self.masks[l])
        Pop, Rop = op_pair_from_scipy(Pm, dtype=self.dtype,
                                      device=self.device)
        sched = build_ptap_schedule(pat_above, Pm, dtype=self.dtype,
                                    device=self.device)
        return (Pop, Rop, sched)

    def _transfers_for(self, level: int):
        """PtAP-chained transfers for a hierarchy whose finest level is
        ``level`` (cached)."""
        n_levels = len(self.ml_mesh.levels)
        if level < 0:
            level += n_levels
        if level not in self._transfer_cache:
            if level == n_levels - 1:
                tr = self.transfers
            else:
                tr = [None] * level
                pat_above = self.assemblers[level].pattern
                for l in range(level - 1, -1, -1):
                    tr[l] = self._build_transfer(l, pat_above)
                    pat_above = tr[l][2].coarse_pattern
            self._transfer_cache[level] = tr
        return self._transfer_cache[level]

    # ---- per-level solve step ----------------------------------------------
    def step_fn(self, level: int = -1, device=None) -> Callable:
        """(u, tables=None, aux_scalars=None) -> :class:`StepOut`.
        ``device``: None or the device the system was initialised on."""
        self._check_device(device)
        n_levels = len(self.ml_mesh.levels)
        if level < 0:
            level += n_levels
        if level in self._step_fns:
            return self._step_fns[level]
        a = self.assemblers[level]
        assemble = a.make_assemble_fn(pass_tables=True)
        cfg = self.config
        transfers = (self._transfers_for(level)
                     if (cfg.use_mg and level > 0) else [])
        dmasks = [torch.as_tensor(m, device=self.device)
                  for m in self.masks[:level]]
        # a coarsest level within coarse_dense_max_dofs is LU-solved in the
        # V-cycle: it is never smoothed nor multiplied, so it gets no Vanka
        # blocks and no BELL slab
        coarse_lu = bool(transfers) and (
            transfers[0][2].coarse_pattern.n_rows <= cfg.coarse_dense_max_dofs)
        if coarse_lu:
            self._route_note(n_rows=transfers[0][2].coarse_pattern.n_rows,
                             path="lu", reason="coarsest V-cycle level: "
                             "dense LU solve")

        vblocks = None
        if cfg.smoother == "vanka":
            from ..algebra.vanka import build_element_blocks
            if transfers:
                vblocks = [None if (l == 0 and coarse_lu) else
                           build_element_blocks(
                               self.assemblers[l], cfg.vanka_block_elems,
                               pattern=(transfers[l][2].coarse_pattern
                                        if l < len(transfers) else None),
                               device=self.device)
                           for l in range(level + 1)]
            else:
                vblocks = [build_element_blocks(a, cfg.vanka_block_elems,
                                                device=self.device)]

        # the coarsest level of an MG drive gets a direct dense solve
        coarse_direct = (not transfers and cfg.use_mg
                         and a.n_dofs <= cfg.coarse_direct_max_dofs
                         and n_levels > 1)

        bell_fine = bell_coarse = None
        if cfg.operator == "bell" and not coarse_direct:
            bell_fine = self._bell_dev(a.pattern)
            if transfers:
                bell_coarse = [None if (l == 0 and coarse_lu) else
                               self._bell_dev(t[2].coarse_pattern)
                               for l, t in enumerate(transfers)] + [None]

        def step(u, tables=None, aux_scalars=None):
            tables = a.device_tables_cached() if tables is None else tables
            u = u.to(device=self.device, dtype=self.dtype)
            R, data = assemble(u, tables, aux_scalars)
            res_norm = float(torch.linalg.norm(R))
            A = a.op_with(data, tables["ell_cols"])
            if bell_fine is not None:
                A = bell_backed(bell_fine, A)
            if coarse_direct:
                Ad = A.to_dense()
                delta = torch.linalg.solve(Ad, -R)
                res = float(torch.linalg.norm(R + A @ delta))
                return StepOut(u + delta, delta, res, 1, res_norm, True)
            if transfers:
                h = build_hierarchy(A, transfers, smoother=cfg.smoother,
                                    n_pre=cfg.n_pre, n_post=cfg.n_post,
                                    cheb_degree=cfg.cheb_degree,
                                    dir_masks=dmasks, vanka_blocks=vblocks,
                                    vanka_omega=cfg.vanka_omega,
                                    vanka_multiplicative=cfg.vanka_multiplicative,
                                    coarse_dense_max=cfg.coarse_dense_max_dofs,
                                    bell_plans=bell_coarse,
                                    device=self.device)
                M = h.as_preconditioner()
            elif cfg.smoother == "vanka":
                from ..algebra.vanka import vanka_smoother
                sm = vanka_smoother(A, vblocks[0], omega=cfg.vanka_omega)
                M = lambda r: sm(torch.zeros_like(r), r)
            else:
                d = A.diagonal()
                dsafe = torch.where(d.abs() < 1e-30, 1.0, d)
                M = lambda r: r / dsafe
            if cfg.outer == "cg":
                delta, info = cg(A.matvec, -R, M=M, tol=cfg.rtol,
                                 atol=cfg.atol,
                                 maxiter=cfg.max_outer * cfg.restart)
            else:
                delta, info = gmres(A.matvec, -R, M=M, tol=cfg.rtol,
                                    atol=cfg.atol, restart=cfg.restart,
                                    max_restarts=cfg.max_outer)
            return StepOut(u + delta, delta, info.residual, info.iters,
                           res_norm, info.converged)

        self._step_fns[level] = step
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
            n = self.ml_sol.n_dofs(unk.name, level)
            e = np.linalg.norm(delta[off:off + n])
            s = np.linalg.norm(u[off:off + n])
            out[unk.name] = float(e / max(s, 1e-250))
        return out

    def _levels_to_solve(self):
        n_levels = len(self.ml_mesh.levels)
        return (range(n_levels) if self.config.mg_type.upper() == "F"
                else [n_levels - 1])

    def _run_step(self, l: int) -> StepOut:
        u = torch.as_tensor(self.gather(l), dtype=self.dtype,
                            device=self.device)
        k0 = spmv_bell_cuda.launches
        t0 = _time.perf_counter()
        out = self.step_fn(l)(u, None, self.aux_scalars)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_step_seconds = _time.perf_counter() - t0
        self.last_step_launches = spmv_bell_cuda.launches - k0
        self.timing["solve"] += self.last_step_seconds
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

    def solve(self, device=None) -> Dict:
        assert self._initialized, "call init() first"
        self._check_device(device)
        info = {}
        levels = self._levels_to_solve()
        for l in levels:
            out = self._run_step(l)
            self.scatter(out.u.cpu().numpy(), l)
            info = {"level": l, "residual": out.lin_res,
                    "iters": out.lin_iters, "converged": out.converged}
            if l < levels[-1]:
                self._refine_to(l)
        if self.config.verbose:
            print(f"[{self.name}] solver: {self.solver_info()}")
        return info


class NonLinearImplicitSystem(LinearImplicitSystem):
    """Newton-MG: outer Newton loop per level with per-variable relative
    correction norms as the stopping test."""

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
                u_new = out.u.cpu().numpy()
                norms = self.eps_norms(out.delta.cpu().numpy(), u_new, l)
                worst = max(norms.values())
                if np.isnan(worst) or np.isinf(worst):
                    # NaN recovery: restart the level once from its
                    # Dirichlet values
                    if not restarted:
                        restarted = True
                        self._apply_bc_values(l)
                        it = 0
                        continue
                    raise FloatingPointError(
                        f"NaN in system '{self.name}' level {l} after restart")
                self.scatter(u_new, l)
                history.append({"level": l, "newton_it": it, "eps": norms,
                                "lin_res": out.lin_res,
                                "lin_iters": out.lin_iters,
                                "converged": out.converged,
                                "res_norm": out.res_norm,
                                "seconds": self.last_step_seconds,
                                "bell_launches": self.last_step_launches})
                it += 1
                if worst < cfg.nonlinear_tol:
                    break
            if l < levels[-1]:
                self._refine_to(l)
        self.history = history
        if cfg.verbose:
            print(f"[{self.name}] solver: {self.solver_info()}")
        return history[-1] if history else {}

