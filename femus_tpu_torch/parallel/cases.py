"""Problems and rank programs of the multi-device layer.

:func:`~femus_tpu_torch.parallel.ranks.launch` runs a module-level
function in every rank; the ones here build their problem from plain
arguments (so a spawned rank imports nothing but the package), run one
distributed operation and return numpy arrays and numbers to the parent.
The tests hold them against the JAX package at small sizes on the CPU;
``chip_smoke.py`` runs them at full size on the card.

Problems:

- :func:`poisson_assembler`: Q2 Poisson on ``unit_box((n, n))``,
  homogeneous Dirichlet (n = 256: 263,169 dofs);
- :func:`cavity_assembler`: the Re = 100 lid-driven cavity Jacobian,
  Q2/Q2/P1dc, RCM-ordered mesh, interleaved dofs (n = 128: 181,250 rows);
- :func:`dryrun_levels`: the two-level Q2/Q2/Q1 cavity of the JAX
  package's ``dryrun_multichip`` (nu = 0.1, the first pressure dof pinned);
- :func:`fsi_bed`: fsi-bed, steady or transient (an elastic bed under a
  fluid, the Petrov-Galerkin R·A·P transfers, material Vanka, the
  K-cycle; the transient one's old fields are aux fields);
- :func:`transient_ns_assembler`: the backward-Euler Navier-Stokes cavity
  of the JAX package's ``examples/ex10_sharded_transient_particles.py``
  (the old velocities as aux fields).
"""
from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch

from ..assembly.bc import apply_dirichlet_values, generate_bdc
from ..assembly.engine import Assembler, Unknown
from ..assembly.forms import navier_stokes, poisson
from ..mesh.generation import unit_box
from .ranks import RankGroup

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def poisson_assembler(n: int, device, dtype=torch.float64,
                      rhs: str = "one") -> Assembler:
    """Q2 Poisson on unit_box((n, n)), zero Dirichlet data; ``rhs``:
    "one" (f = 1) or "sin" (f = 2 pi^2 sin(pi x) sin(pi y))."""
    pi = np.pi
    f = ((lambda x: 1.0 + 0.0 * x[:, 0]) if rhs == "one" else
         (lambda x: 2 * pi ** 2 * torch.sin(pi * x[:, 0])
          * torch.sin(pi * x[:, 1])))
    asm = Assembler(unit_box((n, n), "quad"), [Unknown("u", "biquadratic")],
                    quad_order="fifth", device=device, dtype=dtype)
    asm.set_volume_form(poisson("u", "biquadratic", rhs=f))
    generate_bdc(asm, lambda var, x, grp, t: (True, 0.0))
    return asm


def _lid(var, x, grp, t):
    if var == "p":
        return (False, 0.0)
    if var == "u" and abs(x[1] - 1.0) < 1e-9:
        return (True, 1.0)
    return (True, 0.0)


def cavity_assembler(n: int, device, dtype=torch.float64,
                     nu: float = 0.01) -> Assembler:
    """The lid-driven cavity on unit_box((n, n)) (the main path's
    discretisation: Q2/Q2/P1dc, RCM node order, interleaved dofs)."""
    from ..mesh.reorder import rcm_reorder
    mesh = rcm_reorder(unit_box((n, n), "quad"))
    unknowns = [Unknown("u", "biquadratic"), Unknown("v", "biquadratic"),
                Unknown("p", "disc_linear")]
    asm = Assembler(mesh, unknowns, quad_order="fifth", device=device,
                    dtype=dtype, interleave=True)
    asm.set_volume_form(navier_stokes(("u", "v"), "p",
                                      pres_family="disc_linear", nu=nu))
    generate_bdc(asm, _lid)
    return asm


def dryrun_levels(coarse: int, device, dtype=torch.float64):
    """(coarse, fine) assemblers of the JAX package's dryrun_multichip
    cavity: unit_box((coarse, coarse)) and one refinement, Q2/Q2/Q1,
    nu = 0.1, lid on boundary group 4, the first pressure dof pinned."""
    from ..mesh.multilevel import MultiLevelMesh

    def bc(var, x, grp, t):
        if var == "p":
            return False, 0.0
        return True, (1.0 if (var == "u" and grp == 4) else 0.0)

    ml = MultiLevelMesh(unit_box((coarse, coarse), "quad"), 2)
    unknowns = [Unknown("u", "biquadratic"), Unknown("v", "biquadratic"),
                Unknown("p", "linear")]
    asms = []
    for lmesh in ml.levels:
        a = Assembler(lmesh, unknowns, quad_order="fifth", device=device,
                      dtype=dtype)
        a.set_volume_form(navier_stokes(("u", "v"), "p", nu=0.1))
        generate_bdc(a, bc)
        mask = a.dirichlet_mask.copy()
        mask[a.offsets["p"]] = True
        a.set_dirichlet(mask, a.dirichlet_values)
        asms.append(a)
    return ml, asms


def galerkin_transfers(ml, asms, n_pad: int, device, dtype=torch.float64,
                       unknowns=None):
    """[(P, R, PtAP schedule)] coarse->fine of a hierarchy of assemblers
    (``asms[0]`` coarsest), the finest P padded to ``n_pad`` rows and its
    schedule built on the padded fine pattern, each coarser schedule on
    the Galerkin pattern the finer one produces; P is zeroed at Dirichlet
    rows and columns.  Returns (transfers, coarse dir masks)."""
    from ..algebra.sparse import pad_pattern
    from ..algebra.transfer import (block_diag_prolongation,
                                    build_ptap_schedule, mask_prolongation,
                                    op_pair_from_scipy)
    from .spmd import pad_prolongation
    L = len(asms)
    transfers, masks = [None] * (L - 1), [None] * (L - 1)
    pat = pad_pattern(asms[-1].pattern, n_pad, n_pad)
    for l in range(L - 2, -1, -1):
        c, f = asms[l], asms[l + 1]
        P = block_diag_prolongation(ml.levels[l], ml.levels[l + 1],
                                    unknowns or f.unknowns)
        P = mask_prolongation(P, f.dirichlet_mask, c.dirichlet_mask)
        if l == L - 2:
            P = pad_prolongation(P, n_pad, c.n_dofs)
        Pop, Rop = op_pair_from_scipy(P, dtype, device=device)
        sched = build_ptap_schedule(pat, P, dtype, device=device)
        transfers[l] = (Pop, Rop, sched)
        masks[l] = c.dirichlet_mask.copy()
        pat = sched.coarse_pattern
    return transfers, masks


# fsi-bed: the bed is the elements whose centroid has y < FSI_BED
FSI_FIELDS = ("dx", "dy", "u", "v", "p")
FSI_BED = 0.25
# the lid speed and viscosity of the steady case: the JAX package's Newton
# at 3 levels on the host needs more than 8 steps (it diverges) at nu 0.01
# and lid 1, so nu 0.05, lid 0.2
FSI_NU, FSI_LID = 0.05, 0.2
# the transient case's horizontal kick of the bed and its time step
FSI_KICK, FSI_DT = 0.5, 0.01
# the pressure is pinned at the value dof of the last element (top right,
# in the fluid on every level): inside the solid, where p = 0 holds
# anyway, a pin leaves the fluid pressure's level free and the Newton
# iteration wanders
FSI_PIN = -3
# relative Newton correction at which a level's loop stops
FSI_NONLINEAR_TOL = 1e-5
# FGMRES(60) restarts per linear solve: the finest fsi-bed-128 level needed
# 800-1,800 iterations for rtol 1e-4
FSI_MAX_OUTER = 40


def fsi_bed(coarse: int, levels: int, device, dtype=torch.float64,
            rtol: float = 1e-10, transient: bool = True, lid: float = None,
            **config):
    """fsi-bed through the systems layer: unit_box((coarse, coarse))
    refined ``levels - 1`` times, an elastic bed (element centroid y <
    FSI_BED, group 1) under a fluid, dx, dy, u, v biquadratic and p
    disc_linear, pairs u->dx and v->dy, neo-Hookean lam = mu = 50, the
    pressure pinned at dof FSI_PIN.  ``transient`` (fsi-bed-transient):
    every wall clamped and no-slip, the bed kicked horizontally (u =
    FSI_KICK sin(pi x) sin(pi y / FSI_BED)), fsi_transient_form (rho = 1,
    nu = 0.05, theta = 1, dt = FSI_DT) through TransientMonolithicFSI, the
    old fields (set by ``copy_to_old``) its aux fields.  Steady: lid-driven
    (u = FSI_LID on the top wall, group 4; ``lid`` overrides it),
    fsi_steady_form with nu = FSI_NU.  Solver: operator="bell",
    interleaved dofs, material Vanka (2 elements a block), F ratchet,
    K-cycle FGMRES(60) with FSI_MAX_OUTER restarts to ``rtol``, Newton to
    FSI_NONLINEAR_TOL; ``config`` overrides fields of its SolverConfig.
    Returns the initialised system."""
    from ..mesh.multilevel import MultiLevelMesh
    from ..systems.fsi import (MonolithicFSISystem, TransientMonolithicFSI,
                               fsi_steady_form, fsi_transient_form)
    from ..systems.problem import MultiLevelProblem
    from ..systems.solution import MultiLevelSolution

    mesh = unit_box((coarse, coarse), "quad")
    cent = mesh.coords[mesh.conn].mean(axis=1)
    mesh.elem_group = np.where(cent[:, 1] < FSI_BED, 1, 0).astype(np.int32)
    ml_mesh = MultiLevelMesh(mesh, levels)
    ml_sol = MultiLevelSolution(ml_mesh)
    for v in ("dx", "dy", "u", "v"):
        ml_sol.add_solution(v, "biquadratic", time_order=int(transient))
    ml_sol.add_solution("p", "disc_linear")

    def bc(var, x, grp, t):
        if var == "p":
            return (False, 0.0)
        if var == "u" and grp == 4 and not transient:
            return (True, FSI_LID if lid is None else lid)   # moving lid
        return (True, 0.0)                        # clamped, no-slip

    ml_sol.attach_bc(bc)
    for v in FSI_FIELDS:
        ml_sol.initialize(v)
    if transient:
        ml_sol.initialize("u", lambda x: np.where(
            x[:, 1] < FSI_BED, FSI_KICK * np.sin(np.pi * x[:, 0])
            * np.sin(np.pi * x[:, 1] / FSI_BED), 0.0))
    ml_sol.generate_bdc()
    ml_sol.fix_solution_at_point("p", FSI_PIN, 0.0)
    ml_sol.pair_solution("u", "dx")
    ml_sol.pair_solution("v", "dy")
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    if transient:
        sys_ = prob.add_system(TransientMonolithicFSI, "FSI")
        form = fsi_transient_form(
            ("dx", "dy"), ("u", "v"), "p", solid_groups=(1,),
            pres_family="disc_linear", rho_f=1.0, nu=0.05, rho_s=1.0,
            lam=50.0, mu=50.0, solid_model="neo-hookean", theta=1.0)
    else:
        sys_ = prob.add_system(MonolithicFSISystem, "FSI")
        form = fsi_steady_form(
            ("dx", "dy"), ("u", "v"), "p", solid_groups=(1,),
            pres_family="disc_linear", nu=FSI_NU, lam=50.0, mu=50.0,
            solid_model="neo-hookean")
    sys_.solid_groups = (1,)
    sys_.add_unknown(*FSI_FIELDS)
    sys_.set_assembly(form)
    cfg = sys_.config
    cfg.operator = "bell"
    cfg.interleave_dofs = True
    cfg.smoother = "vanka"
    cfg.vanka_groups = "material"
    cfg.vanka_block_elems = 2
    cfg.mg_type = "F"
    cfg.mg_cycle = "K"
    cfg.restart = 60
    cfg.max_outer = FSI_MAX_OUTER
    cfg.rtol = rtol
    cfg.nonlinear_tol = FSI_NONLINEAR_TOL
    for key, value in config.items():
        if not hasattr(cfg, key):
            raise AttributeError(f"SolverConfig has no field {key!r}")
        setattr(cfg, key, value)
    if transient:
        sys_.init_time(FSI_DT)
    sys_.init(device=device, dtype=dtype)
    if transient:
        ml_sol.copy_to_old()
    return sys_


def ratchet(sys_, steps: int = 2) -> None:
    """The F-cycle ratchet below the finest level, as the JAX package's
    ``dryrun_multichip`` does it: ``steps`` solve steps on each level but
    the finest, each level's state prolonged to the next (the R·A·P
    coarse operator is singular at the zero state)."""
    n_levels = len(sys_.ml_mesh.levels)
    for l in range(n_levels - 1):
        step = sys_.step_fn(l)
        for _ in range(steps):
            u = torch.as_tensor(sys_.gather(l), dtype=sys_.dtype,
                                device=sys_.device)
            out = step(u, None, sys_.aux_scalars, sys_._aux_arrays(l))
            sys_.scatter(out.u.cpu().numpy(), l)
        sys_.ml_sol.refine_from(l)
        sys_._apply_bc_values(l + 1)


def system_vanka_blocks(sys_, transfers) -> list:
    """The Vanka blocks of every level of ``sys_``'s hierarchy whose
    finest level is its finest mesh level (coarse->fine): each coarse
    level's against its PtAP/R·A·P pattern, the finest against its
    assembler's pattern; the system's block size and groups."""
    from ..algebra.vanka import build_element_blocks
    cfg = sys_.config
    L = len(transfers) + 1
    return [build_element_blocks(
        sys_.assemblers[l], cfg.vanka_block_elems,
        pattern=transfers[l][2].coarse_pattern if l < L - 1 else None,
        groups=cfg.vanka_groups, device=sys_.device) for l in range(L)]


NS_DT, NS_NU = 0.05, 0.05


def transient_ns_form(dt: float = NS_DT, nu: float = NS_NU):
    """Backward-Euler Navier-Stokes: (u - u_old)/dt + the steady terms
    (ex10's form; the old velocities are the aux fields u_old, v_old)."""
    steady = navier_stokes(("u", "v"), "p", nu=nu)

    def form(ops, u, aux):
        out = steady(ops, u, aux)
        for c in ("u", "v"):
            du = (ops.value("biquadratic", u[c])
                  - ops.value("biquadratic", aux[c + "_old"])) / dt
            out[c] = out[c] + ops.t("biquadratic", du)
        return out

    return form


def transient_ns_assembler(n: int, device, dtype=torch.float64) -> Assembler:
    """ex10's cavity on unit_box((n, n)): Q2/Q2/Q1, the lid (y = 1) moving
    at u = 1, the first pressure dof pinned, aux fields u_old and v_old."""
    asm = Assembler(unit_box((n, n), "quad"),
                    [Unknown("u", "biquadratic"), Unknown("v", "biquadratic"),
                     Unknown("p", "linear")],
                    quad_order="fifth", device=device, dtype=dtype)
    for c in ("u", "v"):
        asm.add_aux_field(c + "_old", "biquadratic")
    asm.set_volume_form(transient_ns_form())

    def bc(var, x, grp, t):
        if var == "p":
            return False, 0.0
        return True, (1.0 if var == "u" and abs(x[1] - 1.0) < 1e-9 else 0.0)

    generate_bdc(asm, bc)
    mask = asm.dirichlet_mask.copy()
    mask[asm.offsets["p"]] = True
    asm.set_dirichlet(mask, asm.dirichlet_values)
    return asm


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------


def _operator(case: str, n: int, device, dtype):
    """(assembler, ELL data) of a halo case: Poisson at zero, the cavity
    at its boundary values."""
    if case == "poisson":
        asm = poisson_assembler(n, device, dtype)
    elif case == "cavity":
        asm = cavity_assembler(n, device, dtype)
    else:
        raise ValueError(case)
    u = torch.as_tensor(apply_dirichlet_values(asm, np.zeros(asm.n_dofs)),
                        dtype=dtype, device=device)
    _, data = asm.make_assemble_fn()(u)
    return asm, data


def _b1_block(op, x, reps: int) -> dict:
    """Kernel B1 on one rank block against its plain version (the error
    within the rounding budget of max(|A| |x|)), the milliseconds of both
    (CUDA events, back to back) and the sizes of the HBM bound."""
    from ..algebra import bell
    y = bell.spmv_bell_cuda(op, x)
    ref = bell._matvec_plain_frame(op, x)
    scale = bell._matvec_plain_frame(bell.BellOp(op.vals.abs(), op.dev),
                                     x.abs()).abs().max()
    d = op.dev
    return {"max_abs_err": float((y - ref).abs().max()),
            "scale": float(scale),
            "ms": _events_ms(lambda: bell.spmv_bell_cuda(op, x), reps),
            "plain_ms": _events_ms(lambda: bell._matvec_plain_frame(op, x),
                                   max(1, reps // 4)),
            "n": d.n, "n_cols": d.n_cols, "nnz": d.nnz, "slots": d.total,
            "n_slices": d.n_slices, "value_bytes": op.vals.element_size(),
            "x_bytes": x.element_size()}


def _events_ms(fn, reps: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def halo_rank(group: RankGroup, cases: Sequence, variants: Sequence,
              seed: int = 0, reps: int = 0) -> dict:
    """The halo SpMV on this rank's rows, for each case ``(problem, n,
    dtype)`` (problem "poisson" or "cavity", dtype "f32" or "f64") and each
    variant ``(local_format "ell" | "bell", transport, overlap)``, on
    x = rng(seed).standard_normal(n_pad).  Returns, per case
    ``"problem-n-dtype"``, the y blocks, the transport notes, the B1
    launches of each variant and, with ``reps`` on a card, the
    milliseconds of the exchange alone, of the interior and boundary B1
    launches and of the whole SpMV (CUDA events)."""
    return {f"{c}-{n}-{dt}": _halo_case(group, c, n, dt, variants, seed,
                                        reps)
            for c, n, dt in cases}


def _halo_case(group, case, n, dtype, variants, seed, reps) -> dict:
    from ..algebra.bell import spmv_bell_cuda
    from ..algebra.sparse import pad_pattern
    from .halo import build_halo_plan, make_halo_spmv, make_halo_spmv_bell
    from .spmd import padded_rows

    dev, dt = group.device, DTYPES[dtype]
    t0 = time.perf_counter()
    asm, data = _operator(case, n, dev, dt)
    S, s = group.world_size, group.rank
    nr = asm.n_dofs
    n_pad = padded_rows(nr, S)
    pattern = pad_pattern(asm.pattern, n_pad, n_pad)
    plan = build_halo_plan(pattern, S)
    R = plan.rows_per_shard
    lo = s * R
    data_blk = data.new_zeros((R, pattern.width))
    own = max(0, min(R, nr - lo))
    data_blk[:own] = data[lo:lo + own]
    data_blk[own:, 0] = 1.0
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(n_pad),
                        dtype=dt, device=dev)
    x_blk = x[lo:lo + R].contiguous()
    setup_s = time.perf_counter() - t0
    out = {"rank": s, "rows": (lo, lo + R), "n": nr, "n_pad": n_pad,
           "nnz": int(asm.pattern.nnz), "m": plan.m,
           "offsets": list(plan.offs), "setup_s": setup_s, "y": {},
           "note": {}, "launches": {}, "ms": {}}
    for fmt, transport, overlap in variants:
        key = f"{fmt}/{transport}/{'overlap' if overlap else 'seq'}"
        if fmt == "bell":
            prepare, spmv = make_halo_spmv_bell(plan, pattern, group,
                                                overlap, transport)
            slabs = prepare(data_blk)
            run = lambda: spmv(slabs, x_blk)              # noqa: E731
        else:
            spmv, _ = make_halo_spmv(plan, group, overlap, transport)
            run = lambda: spmv(data_blk, x_blk)           # noqa: E731
        before = spmv_bell_cuda.launches
        y = run()
        out["launches"][key] = spmv_bell_cuda.launches - before
        out["y"][key] = y.cpu().numpy()
        out["note"][key] = spmv.exchange.note
        if reps and dev.type == "cuda":
            # the whole SpMV and the exchange alone, all ranks at once
            group.barrier()
            ms = {"spmv": _events_ms(run, reps)}
            group.barrier()
            ms["exchange"] = _events_ms(
                lambda: spmv.exchange.start(x_blk)(), reps)
            group.barrier()
            out["ms"][key] = ms
    if reps and dev.type == "cuda" and any(v[0] == "bell" for v in variants):
        # B1 on this rank's blocks against its plain version, timed one
        # rank at a time (the others wait), like with like beside
        # torch.sparse CSR: the rank's whole local product (interior and
        # boundary launches, the boundary rows added in) against one CSR
        # product of the whole block, and the interior launch against the
        # CSR of the own-column entries
        from ..algebra import bell
        prepare, spmv = make_halo_spmv_bell(plan, pattern, group)
        op_i, op_b = prepare(data_blk)
        xg = spmv.exchange.start(x_blk)()
        xf = torch.cat([x_blk, xg])
        y_blk = spmv((op_i, op_b), x_blk)

        def plain():
            y = bell._matvec_plain_frame(op_i, x_blk)
            return y if op_b is None else y.index_add(
                0, spmv.bnd, bell._matvec_plain_frame(op_b, xf))

        # inside the loop only rank r works: no collective may run there
        for r in range(S):
            group.barrier()
            if r != s:
                continue
            out["blocks"] = {"interior": _b1_block(op_i, x_blk, reps)}
            if op_b is not None:
                out["blocks"]["boundary"] = _b1_block(op_b, xf, reps)
            out["blocks"]["product_ms"] = _events_ms(
                lambda: spmv.local((op_i, op_b), x_blk, xg), reps)
            out["blocks"]["product_plain_ms"] = _events_ms(
                plain, max(1, reps // 4))
            # the ghosts the rank's rows read (the frame has S*m slots)
            out["blocks"]["ghosts"] = int(plan.ghost_globals(s)[1].sum())
            # the CSR of the block: entries sorted by (row, local column)
            rr, kk = np.nonzero(pattern.valid[lo:lo + R])
            cc = plan.cols_local[lo:lo + R][rr, kk].astype(np.int64)
            for key, sel, ncols, xx in (
                    ("library", slice(None), xf.shape[0], xf),
                    ("library_interior", cc < R, R, x_blk)):
                r_, k_, c_ = rr[sel], kk[sel], cc[sel]
                order = np.lexsort((c_, r_))
                crow = np.concatenate([[0], np.cumsum(np.bincount(
                    r_, minlength=R))])
                i64 = dict(dtype=torch.int64, device=dev)
                csr = torch.sparse_csr_tensor(
                    torch.as_tensor(crow, **i64),
                    torch.as_tensor(c_[order], **i64),
                    data_blk[torch.as_tensor(r_[order], **i64),
                             torch.as_tensor(k_[order], **i64)],
                    size=(R, ncols), check_invariants=True)
                out["blocks"][key + "_ms"] = _events_ms(lambda: csr @ xx,
                                                        reps)
                ref = y_blk if key == "library" else \
                    bell.spmv_bell_cuda(op_i, x_blk)
                out["blocks"][key + "_err"] = float((csr @ xx - ref).abs()
                                                    .max())
        group.barrier()
    return out


def step_rank(group: RankGroup, configs: Sequence[dict]) -> list:
    """:func:`sharded_step_case` for each config (keyword arguments) in
    turn; the list of their results."""
    return [sharded_step_case(group, **cfg) for cfg in configs]


# the dryrun cavity's Vanka blocks (elements a block) and damping
DRYRUN_VANKA_ELEMS, DRYRUN_VANKA_OMEGA = 2, 0.9


def sharded_step_case(group: RankGroup, case: str, n: int, levels: int = 1,
                      outer: str = "cg", rtol: float = 1e-10,
                      restart: int = 30, max_outer: int = 40,
                      use_halo: bool = True, local_format: str = "auto",
                      mg_cycle: str = "V", timed: bool = False,
                      smoother: str = "jacobi", steps: int = 1) -> dict:
    """``steps`` sharded steps of ``case``: "poisson" (Q2 Poisson on
    unit_box((n, n)), f = 1; ``levels`` > 1 adds a Galerkin hierarchy of
    that many levels with coarsest unit_box((n / 2^(levels-1))^2));
    "dryrun" (the two-level NS cavity from unit_box((n, n)), GMRES with a
    V-cycle; ``smoother`` "vanka": blocks of DRYRUN_VANKA_ELEMS elements
    on both levels, damping DRYRUN_VANKA_OMEGA); "fsi" (the transient
    :func:`fsi_bed` from unit_box((n, n)) with ``levels`` levels,
    ratcheted below the finest level, then one Newton step of its first
    theta-step at the finest level: the system's Petrov-Galerkin R·A·P
    transfers (R != P^T), its old fields as aux fields and, with
    ``smoother`` "vanka", its Vanka blocks on every level); "ns-aux" (ex10's backward-Euler cavity on unit_box((n, n)),
    no transfers, its old velocities as aux fields, each step's result
    the next step's old fields).  Returns this rank's block of the last
    u, the residual, the iterations of each step, the seconds of the
    first step and the B1 launches of the calls.  ``timed``: the step
    (the production path, with the overlapped halo SpMV) runs twice from
    the same state, cold then warm (``step_s``), and then once more with
    the timing sections on (``timed_step_s``, its sections in ``clock``,
    its largest difference from the untimed solution in
    ``timed_diff``)."""
    from ..algebra.bell import spmv_bell_cuda
    from .spmd import make_sharded_step, padded_rows

    dev = group.device
    t0 = time.perf_counter()
    S = group.world_size
    transfers, masks, vblocks, scalars = (), (), None, None
    omega = DRYRUN_VANKA_OMEGA
    aux_of = None                 # global u -> the aux fields of a step
    if case == "poisson":
        if levels > 1:
            from ..mesh.multilevel import MultiLevelMesh
            coarse = n >> (levels - 1)
            ml = MultiLevelMesh(unit_box((coarse, coarse), "quad"), levels)
            asms = []
            for lm in ml.levels:
                a = Assembler(lm, [Unknown("u", "biquadratic")],
                              quad_order="fifth", device=dev,
                              dtype=torch.float64)
                a.set_volume_form(poisson("u", "biquadratic",
                                          rhs=lambda x: 1.0 + 0.0 * x[:, 0]))
                generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
                asms.append(a)
            fine = asms[-1]
            transfers, masks = galerkin_transfers(
                ml, asms, padded_rows(fine.n_dofs, S), dev)
        else:
            fine = poisson_assembler(n, dev)
    elif case == "dryrun":
        ml, asms = dryrun_levels(n, dev)
        fine = asms[-1]
        transfers, masks = galerkin_transfers(
            ml, asms, padded_rows(fine.n_dofs, S), dev)
        if smoother == "vanka":
            from ..algebra.vanka import build_element_blocks
            vblocks = [build_element_blocks(
                asms[0], DRYRUN_VANKA_ELEMS,
                pattern=transfers[0][2].coarse_pattern, device=dev),
                build_element_blocks(fine, DRYRUN_VANKA_ELEMS, device=dev)]
    elif case == "fsi":
        sys_ = fsi_bed(n, levels, dev)
        ratchet(sys_)
        fine = sys_.assemblers[-1]
        if fine.n_dofs % S:
            raise ValueError(f"fsi: {fine.n_dofs} rows do not split into "
                             f"{S} ranks")
        transfers = sys_._transfers_for(levels - 1)
        masks = sys_.masks[:levels - 1]
        if smoother == "vanka":
            vblocks = system_vanka_blocks(sys_, transfers)
        omega = sys_.config.vanka_omega
        scalars = sys_.aux_scalars
        aux_old = sys_._aux_arrays(levels - 1)
        aux_of = lambda u: aux_old                        # noqa: E731
    elif case == "ns-aux":
        fine = transient_ns_assembler(n, dev)
        nd = fine.dofmaps["u"].n_dofs
        ou, ov = fine.offsets["u"], fine.offsets["v"]
        aux_of = lambda u: {"u_old": u[ou:ou + nd],       # noqa: E731
                            "v_old": u[ov:ov + nd]}
    else:
        raise ValueError(case)
    step = make_sharded_step(fine, group, transfers=transfers,
                             dir_masks=masks, outer=outer, rtol=rtol,
                             restart=restart, max_outer=max_outer,
                             smoother=smoother, aux_scalars=scalars,
                             use_halo=use_halo, local_format=local_format,
                             mg_cycle=mg_cycle, vanka_blocks=vblocks,
                             vanka_omega=omega,
                             with_aux=aux_of is not None)
    if case == "fsi":
        u0 = torch.as_tensor(sys_.gather(levels - 1), dtype=torch.float64,
                             device=dev)
    else:
        u0 = torch.as_tensor(apply_dirichlet_values(fine,
                                                    np.zeros(fine.n_dofs)),
                             dtype=torch.float64, device=dev)
    u_blk = step.own(u0)
    setup_s = time.perf_counter() - t0
    before = spmv_bell_cuda.launches

    def run(u_blk, u_glob):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        args = () if aux_of is None else (aux_of(u_glob),)
        u1, res = step(u_blk, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return u1, res, time.perf_counter() - t1

    u1, res, sec = run(u_blk, u0)
    iters = [step.info.iters]
    converged = step.info.converged
    out = {"rank": group.rank, "rows": (step.rows.start, step.rows.stop),
           "n": fine.n_dofs, "setup_s": setup_s, "step_s": [sec],
           "note": step.note}
    if timed:
        out["step_s"].append(run(u_blk, u0)[2])   # warm, from the same state
        step.clock.on = True
        u_t, _, out["timed_step_s"] = run(u_blk, u0)
        step.clock.on = False
        out["clock"] = dict(step.clock.seconds)
        out["timed_diff"] = float((u_t - u1).abs().max())
    for _ in range(steps - 1):
        u_glob = group.all_gather(u1)[:fine.n_dofs]
        u1, res, _ = run(u1, u_glob)
        iters.append(step.info.iters)
        converged = converged and step.info.converged
    out.update({"u": u1.cpu().numpy(), "residual": res, "iters": iters[-1],
                "step_iters": iters, "converged": converged,
                "b1_launches": spmv_bell_cuda.launches - before})
    return out


def join_rows(results: Sequence[Dict], key: str = "u") -> np.ndarray:
    """The global vector (first ``n`` rows) from the ranks' blocks."""
    n = results[0]["n"]
    return np.concatenate([r[key] for r in results])[:n]


def save_parts(path: str, parts: Sequence[dict], **arrays) -> None:
    """Write per-rank host parts (``patch_spmd.patch_slab`` dicts) and
    shared arrays for :func:`patch_rank` into the directory ``path``."""
    import os
    for r, part in enumerate(parts):
        np.savez(os.path.join(path, f"part{r}.npz"), wt=part["wt"],
                 fc=part["tables"][0], cv=part["tables"][1],
                 es=part["tables"][2], vs=part["tables"][3],
                 meta=np.asarray(part["meta"]), lo=part["lo"],
                 hi=part["hi"], global_meta=np.asarray(part["global_meta"]))
    np.savez(os.path.join(path, "shared.npz"), **arrays)


def _load_part(path: str, r: int) -> dict:
    import os
    z = np.load(os.path.join(path, f"part{r}.npz"))
    return {"wt": z["wt"], "tables": (z["fc"], z["cv"], z["es"], z["vs"]),
            "meta": tuple(int(v) for v in z["meta"]), "lo": int(z["lo"]),
            "hi": int(z["hi"]),
            "global_meta": tuple(int(v) for v in z["global_meta"])}


def patch_csr(op) -> torch.Tensor:
    """A scalar patch operator (a whole level or a rank's slab) as one
    torch.sparse CSR matrix on its device, the library yardstick of
    kernel B2: weight ``wt[k, i, j, p]`` couples the dof at lattice point
    (i, j) of patch p (its row) to the dof at (i + a - 2, j + b - 2) (its
    column), (a, b) = divmod(k, 5), through the routing's gather indices;
    points outside the lattice or absent (a face of another slab's patch)
    drop, duplicates sum and zeros go.  ``patch_csr(op) @ x`` equals
    ``op.matvec(x)`` up to rounding."""
    from ..algebra.patchstencil import K, _window
    H, P, Pp, E, n_edges, n_verts, n = op.meta[:7]
    if op.nv != 1:
        raise ValueError("patch_csr: scalar patch operators only")
    i64 = dict(dtype=torch.int64, device=op.wt.device)
    line_src, corner_src, _, _ = op.routing.gather_indices(op.meta)
    xi = torch.full((E, E, Pp), n, **i64)
    xi[:, :, :P] = torch.arange(E * E * P, **i64).view(E, E, P)
    # dof ids + 1 in the window, so that its zero ring reads -1
    X = _window(xi + 1, line_src + 1, corner_src + 1) - 1
    rows = X[2:H + 2, 2:H + 2]
    r, c, v = [], [], []
    for k in range(K):
        a, b = divmod(k, 5)
        cols = X[a:a + H, b:b + H]
        w = op.wt[k]
        keep = ((rows >= 0) & (rows < n) & (cols >= 0) & (cols < n)
                & (w != 0))
        r.append(rows[keep])
        c.append(cols[keep])
        v.append(w[keep])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(r), torch.cat(c)]),
                                  torch.cat(v), (n, n)).coalesce()
    return coo.to_sparse_csr()


def patch_rank(group: RankGroup, path: str, reps: int = 0) -> dict:
    """The sharded patch matvec on this rank's slab (written by
    :func:`save_parts`, with the global x in ``shared.npz``).  Returns the
    slab's interior rows, the closed skeleton, the B2 launches and, with
    ``reps`` on a card, the ms of the slab matvec and of the skeleton
    all_reduce (CUDA events), and B2 on the slab against its plain version
    and the slab's CSR (:func:`patch_csr`) one rank at a time."""
    import os
    from ..algebra.patchstencil import PatchStencilOp, spmv_patch_cuda
    from .patch_spmd import (make_sharded_patch_matvec, slab_operator,
                             split_vector)
    part = _load_part(path, group.rank)
    x = torch.as_tensor(np.load(os.path.join(path, "shared.npz"))["x"],
                        device=group.device)
    meta = part["global_meta"]
    op = slab_operator(part, group.device)
    xi, xe, xv = split_vector(meta, x)
    xi = xi[:, :, part["lo"]:part["hi"]].contiguous()
    mv = make_sharded_patch_matvec(meta, group)
    before = spmv_patch_cuda.launches
    y_int, y_e, y_v = mv(op, xi, xe, xv)
    out = {"rank": group.rank, "lo": part["lo"], "hi": part["hi"],
           "y_int": y_int.cpu().numpy(), "y_e": y_e.cpu().numpy(),
           "y_v": y_v.cpu().numpy(),
           "launches": spmv_patch_cuda.launches - before, "ms": {}}
    if reps and group.device.type == "cuda":
        from ..algebra.patchstencil import _patch_matvec_plain
        xl = torch.cat([xi.reshape(-1), xe.reshape(-1), xv])
        skel = torch.zeros(xe.numel() + xv.numel(), dtype=x.dtype,
                           device=x.device)
        group.barrier()
        out["ms"]["all_reduce"] = _events_ms(lambda: group.sum(skel), reps)
        group.barrier()
        out["ms"]["sharded_matvec"] = _events_ms(
            lambda: mv(op, xi, xe, xv), reps)
        # B2 on this rank's slab against its plain version and against
        # one torch.sparse CSR product of the slab's operator, timed one
        # rank at a time (the others wait)
        csr = patch_csr(op)
        for r in range(group.world_size):
            group.barrier()
            if r != group.rank:
                continue
            y = op.matvec(xl)
            ref = _patch_matvec_plain(op, xl)
            scale = _patch_matvec_plain(
                PatchStencilOp(op.wt.abs(), op.routing, op.meta),
                xl.abs()).abs().max()
            out["slab"] = {
                "max_abs_err": float((y - ref).abs().max()),
                "scale": float(scale),
                "ms": _events_ms(lambda: op.matvec(xl), reps),
                "plain_ms": _events_ms(lambda: _patch_matvec_plain(op, xl),
                                       max(1, reps // 4)),
                "library_ms": _events_ms(lambda: csr @ xl, reps),
                "library_err": float((csr @ xl - y).abs().max()),
                "nnz": int(csr.values().numel()),
                "meta": op.meta, "value_bytes": op.wt.element_size(),
                "table_bytes": sum(t.numel() * 4 for t in (
                    op.routing.face_code, op.routing.corner_vert,
                    op.routing.edge_sides, op.routing.vert_sides))}
        group.barrier()
    return out


def rotation_field(mesh):
    """The Q2 rigid rotation u = -(y - 1/2), v = x - 1/2 (period 2 pi)."""
    xy = mesh.coords[mesh.dofmap("biquadratic").nodes]
    return -(xy[:, 1] - 0.5), xy[:, 0] - 0.5


def markers_rank(group: RankGroup, path: str, n_cells: int,
                 runs: Sequence[dict]) -> list:
    """For each run (keyword arguments of :func:`sharded_markers_run`),
    the sharded advection of the located cloud in ``path``."""
    return [sharded_markers_run(group, path, n_cells, **run) for run in runs]


def sharded_markers_run(group: RankGroup, path: str, n_cells: int,
                        steps: int, dt: float, order: int = 4,
                        cap_migrate: int = 0, slack: float = 2.0) -> dict:
    """``steps`` sharded RK steps of the located cloud in ``path``
    (``cloud.npz``: x, elem) on unit_box((n_cells, n_cells)) through the
    rigid rotation (float64).  Returns this rank's block, the migrations
    and drops of each step and the seconds per step."""
    import os
    from ..particles.markers import MarkerCloud
    from ..particles.sharded import distribute, make_plan, \
        make_sharded_advect_fn
    dev = group.device
    z = np.load(os.path.join(path, "cloud.npz"))
    mesh = unit_box((n_cells, n_cells), "quad")
    cloud = MarkerCloud(mesh, z["x"], z["elem"])
    plan = make_plan(mesh, group.world_size, cloud.n, cap_migrate, slack)
    X, Ee = distribute(cloud, plan)
    C, s = plan.capacity, group.rank
    f64 = dict(dtype=torch.float64, device=dev)
    x = torch.as_tensor(X[s * C:(s + 1) * C], **f64)
    e = torch.as_tensor(Ee[s * C:(s + 1) * C], dtype=torch.int64,
                        device=dev)
    vel = tuple(torch.as_tensor(v, **f64) for v in rotation_field(mesh))
    step = make_sharded_advect_fn(mesh, plan, group, ["biquadratic"] * 2,
                                  order=order, dtype=torch.float64)
    migrated, dropped = [], []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        x, e, nd = step(x, e, vel, dt)
        migrated.append(step.migrated)
        dropped.append(nd)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"rank": s, "x": x.cpu().numpy(), "elem": e.cpu().numpy(),
            "migrated": migrated, "dropped": dropped,
            "capacity": C, "cap_migrate": plan.cap_migrate,
            "step_s": (time.perf_counter() - t0) / max(steps, 1)}


def calls_rank(group: RankGroup, calls: Sequence) -> list:
    """Several rank programs of this module in one launch: for each
    ``(name, args)`` the result of ``name(group, *args)``."""
    return [globals()[name](group, *args) for name, args in calls]


def fail_rank(group: RankGroup, bad: int, hang: bool = False) -> int:
    """The launcher's failure rules: rank ``bad`` raises (``hang=False``)
    or sleeps for an hour (``hang=True``) while the others wait for it in
    a barrier."""
    if group.rank == bad:
        if hang:
            time.sleep(3600)
        raise RuntimeError(f"rank {bad} fails on purpose")
    group.barrier()
    return group.rank
