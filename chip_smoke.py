"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # the slice configuration
    python3 chip_smoke.py --profile  # plus a profiled Newton step

Phases, one JSON line each; any failure exits non-zero:

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
# the slice configuration: coarsest mesh cells per side, mesh levels
COARSE_CELLS = 16
LEVELS = 4


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
    from femus_tpu_torch.algebra import bell

    bell.spmv_bell_cuda.launches = 0
    t0 = time.perf_counter()
    sys_.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bell.spmv_bell_cuda.launches
    for h in sys_.history:
        emit({"phase": "newton_step", "it": h["newton_it"],
              "seconds": h["seconds"], "gmres_iters": h["lin_iters"],
              "lin_res": h["lin_res"], "converged": h["converged"],
              "res_norm": h["res_norm"], "bell_launches": h["bell_launches"],
              "eps": h["eps"]})
    hist = sys_.history
    drop = hist[0]["res_norm"] / max(hist[-1]["res_norm"], 1e-300)
    on_cuda = _all_on_cuda(sys_)
    fields_ok = all(np.all(np.isfinite(ml_sol.sol[-1][n]))
                    for n in ("u", "v", "p"))
    emit({"phase": "main", "wall_s": wall, "newton_steps": len(hist),
          "bell_launches": launches, "res_norm_drop": drop,
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
        tensors += [x for pair in t["tabs"].values() for x in pair]
    for P, R, sched in sys_.transfers:
        tensors += [P.data, P.cols, R.data, R.cols, sched.src, sched.dst,
                    sched.coeff]
    for dev in sys_._bell_plans.values():
        tensors += [dev.block_ids, dev.tile_rows, dev.diag_src]
    return all(t.is_cuda for t in tensors)


def phase_profile(sys_) -> None:
    """One more Newton step at the converged state under torch.profiler:
    device time by kernel and the device's busy share of the step."""
    from torch.profiler import ProfilerActivity, profile

    step = sys_.step_fn(-1)
    u = torch.as_tensor(sys_.gather(-1), dtype=sys_.dtype, device="cuda")
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
    emit({"phase": "profile", "step_wall_s": wall,
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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one Newton step (device time by "
                         "kernel, idle share)")
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
            phase_profile(sys_)
        phase_reference()
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
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
