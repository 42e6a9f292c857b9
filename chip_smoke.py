"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # the slice configurations
    python3 chip_smoke.py --profile  # plus a profiled Newton step and a
                                     # profiled patch solve step

Phases, one JSON line each; any failure exits non-zero.  Slice 1, the
steady Navier-Stokes Newton step on the BELL operator:

1. build   — compile every CUDA kernel of the port from the sources in this
             checkout (one nvcc per source, all started together);
2. kernel  — on the main path's own operator (the cavity Jacobian at the
             initial state, identity BELL plan), hold the BELL SpMV kernel
             against its plain PyTorch version (f32 and bf16 slabs), time
             both and one torch.sparse CSR matvec of the same matrix with
             CUDA events, and compute the HBM bound of the call (of the
             slab as laid out, and of the nonzeros alone);
3. main    — the main path: Re=100 lid-driven cavity (Ghia, Ghia & Shin
             1982) on unit_box((16,16)) refined to 4 levels (finest 128x128
             Q2/Q2/P1dc, 181,250 dofs), RCM hierarchy, interleaved dofs,
             operator="bell", Vanka-smoothed V-cycle GMRES in float32, up to
             5 Newton steps through NonLinearImplicitSystem.solve;
   (--profile: one more Newton step under torch.profiler);
4. reference — the same solve at a small size on the card (float32) and on
             the host (float64) must agree.

Slice 2, the patch-stencil operator path (operator="patch", rediscretized
V-cycle, Chebyshev smoothing, GMRES(30) in float32 at rtol 1e-6):

5. patch_setup     — System.init of poisson-patch-1M (-Lap u = 2 pi^2
                     sin(pi x) sin(pi y), homogeneous Dirichlet, on
                     PatchedMultiLevelMesh(unit_box((32,32)), 5): finest
                     512x512 Q2, 1,050,625 dofs, H=33, P=1024) and of
                     elasticity-patch (linear elasticity (DX, DY), lam=1.2,
                     mu=0.8, clamped at x=0, uniform body force, on
                     unit_box((16,16)), 5 levels: 2 x 263,169 dofs);
6. patch_kernel    — on the finest operators after Dirichlet elimination,
                     hold kernel B2 against its plain version (scalar
                     Poisson slab; one elasticity block row, two pairs
                     accumulated), time both, the whole matvec (with the
                     skeleton routing products), and one torch.sparse CSR
                     matvec of the same Poisson matrix from the port's ELL
                     assembly; HBM bound of the kernel call (the weights
                     it reads, see patch_kernel_work) and of the nonzeros
                     alone;
7. patch_main      — LinearImplicitSystem.solve on poisson-patch-1M: wall
                     time, iterations, the true preconditioned residual
                     against the solve's target (bounded by float32, see
                     RESIDUAL_SLACK), nodal error against sin(pi x)
                     sin(pi y) (see PATCH_ERR_MAX), B2 launches, operator
                     routing;
   (--profile: one more solve step under torch.profiler);
8. patch_elasticity — the same solve report for elasticity-patch;
9. patch_reference — both problems on unit_box((4,4)), 3 levels, on the
                     card (float32) and the host (float64) must agree.

Then the card's name and power limit, the kernel table as one JSON line,
and the final status line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12          # H100 SXM float32, outside the tensor cores
# the slice configurations: coarsest mesh cells per side, mesh levels
COARSE_CELLS = 16                 # cavity-128
LEVELS = 4
PATCH_COARSE, PATCH_LEVELS = 32, 5    # poisson-patch-1M
ELAST_COARSE, ELAST_LEVELS = 16, 5    # elasticity-patch
# max nodal error of the float32 poisson-patch-1M solve: 2x the float32
# floor, 0.0123 for an exact solve of the card's float32 data
# (tools/torch_patch_f32_limit.py --device cuda); the solve reaches 0.0120
# and 30 more GMRES iterations leave it there
# (tools/torch_patch_residual.py); a wrong operator or an unconverged
# solve gives O(1)
PATCH_ERR_MAX = 2.5e-2
# largest true preconditioned residual ||M (b - A x)|| over the solve's
# target rtol * ||M b|| that a float32 patch solve may end with: further
# GMRES cycles do not push it below the float32 floor, which
# tools/torch_patch_residual.py measured on the card at 5.7-27x (Poisson)
# and 16-179x (elasticity, up to 300x in other runs); a solve that stopped
# with no iteration sits at 1e6x
RESIDUAL_SLACK = {"patch_main": 100.0, "patch_elasticity": 1000.0}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cavity_system(coarse: int, levels: int, device, dtype, rtol: float,
                  max_nonlinear: int):
    """The lid-driven cavity through the port's public entry points."""
    from femus_tpu_torch.assembly.forms import navier_stokes
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.mesh.reorder import rcm_reorder_hierarchy
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import NonLinearImplicitSystem

    def bc(var, x, grp, t):
        if var == "p":
            return (False, 0.0)
        if var == "u" and abs(x[1] - 1.0) < 1e-9:
            return (True, 1.0)                   # the moving lid
        return (True, 0.0)

    ml_mesh = MultiLevelMesh(unit_box((coarse, coarse)), levels)
    rcm_reorder_hierarchy(ml_mesh)
    ml_sol = MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.add_solution("v", "biquadratic")
    ml_sol.add_solution("p", "disc_linear")
    for n in ("u", "v", "p"):
        ml_sol.initialize(n)
    ml_sol.attach_bc(bc)
    for n in ("u", "v", "p"):
        ml_sol.generate_bdc(n)
    ml_sol.fix_solution_at_point("p", 0, 0.0)
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(NonLinearImplicitSystem, "NS")
    sys_.add_unknown("u", "v", "p")
    sys_.set_assembly(navier_stokes(("u", "v"), "p",
                                    pres_family="disc_linear", nu=0.01))
    cfg = sys_.config
    cfg.operator = "bell"
    cfg.interleave_dofs = True
    cfg.smoother = "vanka"
    cfg.mg_type = "V"
    cfg.rtol = rtol
    cfg.restart = 60
    cfg.max_outer = 10
    cfg.max_nonlinear = max_nonlinear
    sys_.init(device=device, dtype=dtype)
    return sys_, ml_sol


def patch_system(problem: str, coarse: int, levels: int, device, dtype,
                 rtol: float):
    """A patch-operator linear system through the port's public entry
    points: "poisson" or "elasticity" (see the module docstring)."""
    from femus_tpu_torch.assembly.forms import elasticity, poisson
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import PatchedMultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import LinearImplicitSystem

    pi = np.pi
    if problem == "poisson":
        names = ["u"]
        form = poisson("u", rhs=lambda x: 2 * pi ** 2 * torch.sin(pi * x[:, 0])
                       * torch.sin(pi * x[:, 1]))
        bc = lambda var, x, grp, t: (True, 0.0)          # noqa: E731
    else:
        names = ["DX", "DY"]
        form = elasticity(("DX", "DY"), lam=1.2, mu=0.8, force=lambda x:
                          torch.stack([0.0 * x[:, 0], -1.0 + 0.0 * x[:, 1]],
                                      1))
        bc = lambda var, x, grp, t: (grp == 1, 0.0)       # noqa: E731
    ml_mesh = PatchedMultiLevelMesh(unit_box((coarse, coarse)), levels)
    ml_sol = MultiLevelSolution(ml_mesh)
    for n in names:
        ml_sol.add_solution(n, "biquadratic")
        ml_sol.initialize(n)
    ml_sol.attach_bc(bc)
    for n in names:
        ml_sol.generate_bdc(n)
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(LinearImplicitSystem, problem)
    sys_.add_unknown(*names)
    sys_.set_assembly(form)
    cfg = sys_.config
    cfg.operator = "patch"
    cfg.coarse_op = "rediscretize"
    cfg.smoother = "chebyshev"
    cfg.mg_type = "V"
    cfg.rtol = rtol
    sys_.init(device=device, dtype=dtype)
    return sys_, ml_mesh, ml_sol, names


def reset_launches() -> None:
    from femus_tpu_torch.systems.system import KERNELS
    for fn in KERNELS.values():
        fn.launches = 0


def time_ms(fn, reps: int = 60, warm: int = 5) -> float:
    """Median device time of one call over ``reps`` back-to-back calls.
    An event is recorded between consecutive calls; the host enqueues
    faster than the card drains, so each interval is one call's device
    time (launch gaps excluded)."""
    for _ in range(warm):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda.synchronize()
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    ev[-1].synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1])
                            for i in range(reps)]))


def phase_build(card: str):
    from femus_tpu_torch._cuda_build import KERNEL_SOURCES, build
    t0 = time.perf_counter()
    logs = build(KERNEL_SOURCES)
    report = {src: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln][:8]
              for src, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "sources": KERNEL_SOURCES,
          "ptxas": report})


def phase_kernel(sys_) -> dict:
    """B1 against its plain version on the main path's fine operator."""
    from femus_tpu_torch.algebra import bell

    a = sys_.assemblers[-1]
    u0 = torch.as_tensor(sys_.gather(-1), dtype=sys_.dtype,
                         device=sys_.device)
    _, data = a.make_assemble_fn(pass_tables=True)(
        u0, a.device_tables_cached())
    plan = bell.build_bell_plan(a.pattern, perm="identity")
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(plan.n, generator=gen, dtype=torch.float32).cuda()
    T = plan.tile
    real_rows = int(len(plan.tile_rows))
    out = {"n": plan.n, "nnz": int(a.pattern.nnz),
           "slab_rows": plan.slab_rows, "real_slab_rows": real_rows,
           "tile": T, "col_block": plan.col_block}
    rows = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        op = bell.relayout_ell(plan, data, dtype=dt, device="cuda")
        y_k = bell.spmv_bell_cuda(op, x)
        torch.cuda.synchronize()
        y_p = bell._matvec_plain_frame(op, x)
        absop = bell.BellOp(op.blocks.abs(), op.dev)
        scale = float(bell._matvec_plain_frame(absop, x.abs()).abs().max())
        err = float((y_k - y_p).abs().max())
        ok = err <= 1e-5 * scale
        isz = op.blocks.element_size()
        nbytes = (real_rows * (T * 128 * isz + plan.pack * 4 + 4)
                  + (plan.n_tiles + 1) * 4 + 2 * plan.n * 4)
        flops = 2 * real_rows * T * 128
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # what the matvec itself needs: each nonzero's value and int32
        # column id, x and y once; the slab bound above also counts the
        # layout's zero padding
        nnz_bytes = int(a.pattern.nnz) * (isz + 4) + 2 * plan.n * 4
        t_nnz = nnz_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        ms = time_ms(lambda: bell.spmv_bell_cuda(op, x))
        plain_ms = time_ms(lambda: bell._matvec_plain_frame(op, x), reps=50)
        rows[name] = {"max_abs_err": err, "scale": scale, "ok": ok,
                      "ms": ms, "plain_ms": plain_ms,
                      "bytes": nbytes, "slab_bytes": plan.slab_bytes(isz),
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "pct_of_bound": 100.0 * max(t_bytes, t_ops) / ms,
                      "nnz_bytes": nnz_bytes, "bound_nnz_ms": t_nnz,
                      "pct_of_nnz_bound": 100.0 * t_nnz / ms}
        del op, absop
    # library yardstick: one torch.sparse CSR matvec of the same matrix
    valid = torch.as_tensor(a.pattern.valid, device="cuda")
    cols = torch.as_tensor(a.pattern.cols, dtype=torch.int64, device="cuda")
    counts = valid.sum(dim=1)
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    csr = torch.sparse_csr_tensor(crow, cols[valid], data.float()[valid],
                                  check_invariants=False,
                                  size=(plan.n, plan.n))
    y_lib = csr @ x
    rows["f32"]["library_err"] = float(
        (y_lib - bell.spmv_bell_cuda(bell.relayout_ell(plan, data,
                                                       device="cuda"), x)
         ).abs().max())
    rows["f32"]["library_ms"] = time_ms(lambda: csr @ x)
    out.update(rows)
    emit({"phase": "kernel", **out})
    if not all(r["ok"] for r in rows.values()):
        raise AssertionError("BELL kernel disagrees with its plain version")
    return rows["f32"]


def phase_main(sys_, ml_sol) -> int:
    from femus_tpu_torch.systems.system import launch_counts

    reset_launches()
    t0 = time.perf_counter()
    sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()["bell_spmv"]
    for h in sys_.history:
        emit({"phase": "newton_step", "it": h["newton_it"],
              "seconds": h["seconds"], "gmres_iters": h["lin_iters"],
              "lin_res": h["lin_res"], "lin_target": h["lin_target"],
              "converged": h["converged"],
              "res_norm": h["res_norm"],
              "kernel_launches": h["kernel_launches"], "eps": h["eps"]})
    hist = sys_.history
    drop = hist[0]["res_norm"] / max(hist[-1]["res_norm"], 1e-300)
    on_cuda = _all_on_cuda(sys_)
    fields_ok = all(np.all(np.isfinite(ml_sol.sol[-1][n]))
                    for n in ("u", "v", "p"))
    emit({"phase": "main", "wall_s": wall, "newton_steps": len(hist),
          "kernel_launches": launch_counts(), "res_norm_drop": drop,
          "all_converged": all(h["converged"] for h in hist),
          "tensors_on_cuda": on_cuda, "fields_finite": fields_ok,
          "n_dofs": sys_.assemblers[-1].n_dofs,
          "routing": sys_.solver_info()["routing"]})
    if not all(h["converged"] for h in hist):
        raise AssertionError("a linear solve missed its rtol")
    if not drop >= 1e3:
        raise AssertionError(f"||R(u)|| fell only {drop:.3g}x")
    if launches <= 0:
        raise AssertionError("the main path launched no BELL kernel")
    if not (on_cuda and fields_ok):
        raise AssertionError("tensors off the card or non-finite fields")
    return launches


def _all_on_cuda(sys_) -> bool:
    tensors = []
    for a in sys_.assemblers:
        t = a.device_tables_cached()
        tensors += [v for v in t.values() if torch.is_tensor(v)]
        tensors += [x for v in t.values() if isinstance(v, tuple) for x in v]
        tensors += [x for pair in t["tabs"].values() for x in pair]
    for P, R, sched in sys_.transfers:
        tensors += [P.data, P.cols, R.data, R.cols]
        if sched is not None:
            tensors += [sched.src, sched.dst, sched.coeff]
    for rs in sys_._rsol:
        if rs is not None:
            tensors += [rs[0].data, rs[0].cols, rs[1]]
    for dev in sys_._bell_plans.values():
        tensors += [dev.block_ids, dev.tile_rows, dev.diag_src]
    return all(t.is_cuda for t in tensors)


def phase_profile(sys_, u, label: str) -> None:
    """One more solve step from state ``u`` under torch.profiler: device
    time by kernel and the device's busy share of the step."""
    from torch.profiler import ProfilerActivity, profile

    step = sys_.step_fn(-1)
    step(u)                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step(u)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    emit({"phase": "profile", "system": label, "step_wall_s": wall,
          "gmres_iters": out.lin_iters, "device_busy_s": busy_us * 1e-6,
          "idle_share": 1.0 - busy_us * 1e-6 / wall,
          "n_kernels": len(kernels),
          "top": [{"name": n[:60], "calls": c, "ms": us * 1e-3}
                  for n, (c, us) in top]})


def phase_reference() -> None:
    """Small cavity: the card's float32 solve against the host's float64."""
    fields = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        sys_, ml_sol = cavity_system(8, 2, device, dtype, rtol=1e-6,
                                     max_nonlinear=4)
        sys_.solve()
        fields[device] = np.concatenate([ml_sol.sol[-1][n]
                                         for n in ("u", "v", "p")])
    ref = fields["cpu"]
    rel = float(np.linalg.norm(fields["cuda"] - ref) / np.linalg.norm(ref))
    emit({"phase": "reference", "n_dofs": int(ref.size), "rel_diff": rel})
    if not rel < 1e-3:
        raise AssertionError(f"card and host solutions differ: {rel:.3g}")


def _patch_parts_check(got, want, scale) -> tuple:
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    s = max(float(x.max()) for x in scale)
    return err, s, err <= 1e-5 * s


def patch_kernel_work(H: int, P: int, isz: int) -> tuple:
    """(bytes, flops) kernel B2 must move and do for one (K, H, H, P)
    weight slab: the weights whose window position lies inside the H x H
    lattice (a weight on the zero ring multiplies zero and is not read),
    each read once; the interior, line and corner inputs read once; the
    partials written once.  Padding patches beyond P are not counted."""
    from femus_tpu_torch.algebra.patchstencil import OFFSETS
    weights = sum((H - abs(di)) * (H - abs(dj)) for di, dj in OFFSETS) * P
    E = H - 2
    vectors = 2 * (E * E + 4 * E + 4) * P
    return (weights + vectors) * isz, 2 * weights


def phase_patch_kernel(psys, esys) -> dict:
    """B2 against its plain version on the finest eliminated operators."""
    from femus_tpu_torch.algebra import patchstencil as ps
    from femus_tpu_torch.assembly.engine import Assembler

    gen = torch.Generator(device="cpu").manual_seed(0)
    out = {}
    # scalar: the poisson-patch-1M fine operator
    a = psys.assemblers[-1]
    u0 = torch.zeros(a.n_dofs, dtype=torch.float32, device="cuda")
    _, data = a.make_assemble_fn(pass_tables=True)(
        u0, a.device_tables_cached())
    op = a.op_with(data)
    x = torch.randn(op.n_rows, generator=gen, dtype=torch.float32).cuda()
    ins = op._inputs(x)
    y_k = ps.spmv_patch_cuda(op.wt, *ins)
    torch.cuda.synchronize()
    y_p = ps._patch_chunk_plain(op.wt, *ins)
    scale = ps._patch_chunk_plain(op.wt.abs(), *(t.abs() for t in ins))
    err, s, ok = _patch_parts_check(y_k, y_p, scale)
    H, P, Pp = op.meta[0], op.meta[1], op.meta[2]
    isz = op.wt.element_size()
    nbytes, flops = patch_kernel_work(H, P, isz)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    ms = time_ms(lambda: ps.spmv_patch_cuda(op.wt, *ins))
    plain_ms = time_ms(lambda: ps._patch_chunk_plain(op.wt, *ins), reps=20)
    matvec_ms = time_ms(lambda: op.matvec(x))
    # library yardstick: one torch.sparse CSR matvec of the same matrix,
    # from the port's own ELL assembly of the same mesh (same Dirichlet rows)
    e = Assembler(a.mesh, a.unknowns, quad_order=a.quad_order,
                  dtype=torch.float32, device="cuda")
    e.set_volume_form(a.volume_form)
    e.set_dirichlet(a.dirichlet_mask)
    _, edata = e.make_assemble_fn()(u0)
    valid = torch.as_tensor(e.pattern.valid, device="cuda")
    cols = torch.as_tensor(e.pattern.cols, dtype=torch.int64, device="cuda")
    counts = valid.sum(dim=1)
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    csr = torch.sparse_csr_tensor(crow, cols[valid], edata[valid],
                                  check_invariants=False,
                                  size=(e.n_dofs, e.n_dofs))
    y_mv = op.matvec(x)
    y_lib = csr @ x
    nnz = int(e.pattern.nnz)
    nnz_bytes = nnz * (isz + 4) + 2 * op.n_rows * isz
    t_nnz = nnz_bytes / HBM_BYTES_PER_S * 1e3
    # a layout that stored the nonzeros' values alone (no column ids, no
    # structural zeros): the yardstick for the kernel's next step
    t_val = (nnz * isz + 2 * op.n_rows * isz) / HBM_BYTES_PER_S * 1e3
    out["poisson"] = {
        "H": H, "P": P, "Pp": Pp, "n": op.n_rows, "nnz": nnz,
        "max_abs_err": err, "scale": s, "ok": ok, "ms": ms,
        "plain_ms": plain_ms, "matvec_ms": matvec_ms,
        "library_ms": time_ms(lambda: csr @ x),
        "library_vs_patch_matvec": float((y_lib - y_mv).abs().max()),
        "library_vs_patch_scale": float(y_lib.abs().max()),
        "bytes": nbytes, "slab_bytes": op.wt.numel() * isz,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "pct_of_bound": 100.0 * max(t_bytes, t_ops) / ms,
        "nnz_bytes": nnz_bytes, "bound_nnz_ms": t_nnz,
        "pct_of_nnz_bound": 100.0 * t_nnz / ms, "bound_values_ms": t_val}
    del csr, e, edata, valid, cols
    # block: row variable 0 of the elasticity operator, pairs (0,0) and
    # (0,1) accumulated by the kernel
    a = esys.assemblers[-1]
    u0 = torch.zeros(a.n_dofs, dtype=torch.float32, device="cuda")
    _, data = a.make_assemble_fn(pass_tables=True)(
        u0, a.device_tables_cached())
    bop = a.op_with(data)
    nb = bop.meta[6]
    x = torch.randn(bop.n_rows, generator=gen, dtype=torch.float32).cuda()
    ins = [bop._inputs(x[v * nb:(v + 1) * nb]) for v in range(bop.nv)]
    acc = ref = scale = None
    for vc in range(bop.nv):
        w = bop._pair(0, vc)
        acc = ps.spmv_patch_cuda(w, *ins[vc], out=acc)
        r = ps._patch_chunk_plain(w, *ins[vc])
        sc = ps._patch_chunk_plain(w.abs(), *(t.abs() for t in ins[vc]))
        ref = r if ref is None else tuple(p + q for p, q in zip(ref, r))
        scale = sc if scale is None else tuple(
            p + q for p, q in zip(scale, sc))
    torch.cuda.synchronize()
    err, s, ok = _patch_parts_check(acc, ref, scale)
    out["elasticity_block_row"] = {
        "H": bop.meta[0], "P": bop.meta[1], "n": bop.n_rows,
        "max_abs_err": err, "scale": s, "ok": ok,
        "block_matvec_ms": time_ms(lambda: bop.matvec(x))}
    emit({"phase": "patch_kernel", **out})
    if not all(r["ok"] for r in out.values()):
        raise AssertionError("patch kernel disagrees with its plain version")
    return out["poisson"]


def phase_patch_solve(sys_, ml_mesh, ml_sol, names, label: str,
                      setup_s: float) -> dict:
    """LinearImplicitSystem.solve on a patch configuration, with the
    launch counts set to 0 just before it and read just after."""
    from femus_tpu_torch.systems.system import launch_counts

    reset_launches()
    t0 = time.perf_counter()
    info = sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    # a second solve step from the same initial state, after warm-up
    u_init = torch.as_tensor(sys_.gather(-1) * 0.0, dtype=sys_.dtype,
                             device="cuda")
    t0 = time.perf_counter()
    again = sys_.step_fn(-1)(u_init)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    fields_ok = all(np.all(np.isfinite(ml_sol.sol[-1][n])) for n in names)
    rep = {"phase": label, "setup_s": setup_s, "solve_wall_s": wall,
           "second_step_s": steady, "second_step_iters": again.lin_iters,
           "gmres_iters": info["iters"], "residual": info["residual"],
           "target": info["target"],
           "residual_over_target": info["residual"] / info["target"],
           "converged": info["converged"], "kernel_launches": launches,
           "n_dofs": [a.n_dofs for a in sys_.assemblers],
           "tensors_on_cuda": _all_on_cuda(sys_), "fields_finite": fields_ok,
           "routing": sys_.solver_info()["routing"]}
    if names == ["u"]:
        xy = ml_mesh.levels[-1].node_coords_of("biquadratic")
        exact = np.sin(np.pi * xy[:, 0]) * np.sin(np.pi * xy[:, 1])
        rep["max_nodal_err"] = float(np.abs(ml_sol.sol[-1]["u"] - exact).max())
    else:
        rep["max_abs_disp"] = float(max(np.abs(ml_sol.sol[-1][n]).max()
                                        for n in names))
    emit(rep)
    if not (info["converged"] and info["iters"] < 20):
        raise AssertionError(f"{label}: the MG-GMRES drive failed ({info})")
    if not info["residual"] <= RESIDUAL_SLACK[label] * info["target"]:
        raise AssertionError(f"{label}: true residual {info['residual']} "
                             f"above {RESIDUAL_SLACK[label]} x target "
                             f"{info['target']}")
    if launches["patch_stencil"] <= 0:
        raise AssertionError(f"{label}: the solve launched no patch kernel")
    if rep.get("max_nodal_err", 0.0) >= PATCH_ERR_MAX:
        raise AssertionError(f"{label}: nodal error {rep['max_nodal_err']}")
    if not (rep["tensors_on_cuda"] and fields_ok):
        raise AssertionError(f"{label}: tensors off the card or non-finite "
                             "fields")
    return rep


def phase_patch_reference() -> None:
    """Both patch problems at a small size: the card's float32 solve
    against the host's float64 solve."""
    rep = {"phase": "patch_reference"}
    for problem in ("poisson", "elasticity"):
        fields = {}
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            sys_, _, ml_sol, names = patch_system(problem, 4, 3, device,
                                                  dtype, rtol=1e-6)
            sys_.solve()
            fields[device] = np.concatenate([ml_sol.sol[-1][n]
                                             for n in names])
        ref = fields["cpu"]
        rep[problem] = float(np.linalg.norm(fields["cuda"] - ref)
                             / np.linalg.norm(ref))
        rep[problem + "_n_dofs"] = int(ref.size)
    emit(rep)
    if not max(rep["poisson"], rep["elasticity"]) < 1e-4:
        raise AssertionError(f"card and host patch solutions differ: {rep}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one Newton step and one patch solve "
                         "step (device time by kernel, idle share)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import femus_tpu_torch  # noqa: F401  (needs the repo checkout)
        card = card_line()
        phase_build(card)
        t0 = time.perf_counter()
        sys_, ml_sol = cavity_system(COARSE_CELLS, LEVELS, "cuda",
                                     torch.float32, rtol=1e-4,
                                     max_nonlinear=5)
        emit({"phase": "setup", "seconds": time.perf_counter() - t0,
              "n_dofs": sys_.assemblers[-1].n_dofs,
              "levels": [a.n_dofs for a in sys_.assemblers]})
        k = phase_kernel(sys_)
        launches = phase_main(sys_, ml_sol)
        if args.profile:
            phase_profile(sys_, torch.as_tensor(
                sys_.gather(-1), dtype=sys_.dtype, device="cuda"), "NS")
        phase_reference()
        del sys_, ml_sol
        # slice 2: the patch-stencil operator path
        setup = {}
        for name, problem, coarse, levels in (
                ("poisson", "poisson", PATCH_COARSE, PATCH_LEVELS),
                ("elasticity", "elasticity", ELAST_COARSE, ELAST_LEVELS)):
            t0 = time.perf_counter()
            setup[name] = patch_system(problem, coarse, levels, "cuda",
                                       torch.float32, rtol=1e-6)
            setup[name + "_s"] = time.perf_counter() - t0
        emit({"phase": "patch_setup",
              "seconds": {n: setup[n + "_s"]
                          for n in ("poisson", "elasticity")},
              "n_dofs": {n: [a.n_dofs for a in setup[n][0].assemblers]
                         for n in ("poisson", "elasticity")}})
        k2 = phase_patch_kernel(setup["poisson"][0], setup["elasticity"][0])
        main2 = phase_patch_solve(*setup["poisson"], "patch_main",
                                  setup["poisson_s"])
        if args.profile:
            psys = setup["poisson"][0]
            phase_profile(psys, torch.as_tensor(
                psys.gather(-1) * 0.0, dtype=psys.dtype, device="cuda"),
                "poisson-patch-1M")
        phase_patch_solve(*setup["elasticity"], "patch_elasticity",
                          setup["elasticity_s"])
        del setup
        phase_patch_reference()
    except Exception:
        traceback.print_exc()
        return 1
    print(card)
    emit({"kernels": [{
        "name": "bell_spmv", "route": "cuda",
        "source": "femus_tpu_torch/algebra/csrc/bell_spmv.cu",
        "replaces": "femus_tpu/algebra/bell.py:603",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]}, {
        "name": "patch_stencil", "route": "cuda",
        "source": "femus_tpu_torch/algebra/csrc/patch_stencil.cu",
        "replaces": "femus_tpu/algebra/patchstencil.py:377",
        "launches": main2["kernel_launches"]["patch_stencil"],
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
