"""One run of one benchmark cell.

Set-up (imports, the CUDA context, the kernels' load from the build cache,
the program's mesh, hierarchy and ``System.init``, and one whole warm-up
solve of the cell's own shapes), then a closed-loop window of whole solves
for ``--seconds`` seconds, then the reference's judgement of a sample of
the window's answers.  With ``--trace 1`` the window's first solves run
under torch.profiler and the per-layer metrics are reported instead of the
end-to-end ones.  The last line of standard output is the result.

The cell, its configuration and its traffic mix are found by name: the
cell in ``BENCHMARK.json``, the configuration in the file that names, the
mix in ``benchmark/traffic/<traffic>.json``.  A configuration names the
driver of the program (``benchmark/systems/<system>.py``: builds the
program's system through its public entry points and runs one solve) and
its plain reference (``benchmark/references/<reference>.py``: judges the
answers, never imports the program).  A per-layer metric is read by
``benchmark/metrics/<name>.py``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional

from . import traffic as traffic_mod
from .plugins import benchmark_spec, cell as find_cell, config as find_config
from .plugins import load_file, metrics_of

# top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "femus_tpu", "chip_smoke")


class RunFailed(Exception):
    """A run that must end without a result."""


def forbidden_modules() -> List[str]:
    """The forbidden top-level names among ``sys.modules``, compared whole
    (``femus_tpu_torch`` is not ``femus_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        raise SystemExit("--seed must be a whole number >= 0")
    return args


def _sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


class Run:
    """What the metric readers see of one run."""

    def __init__(self):
        self.solves: List[Dict] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.peak_bytes = 0
        self.trace: Optional[Dict] = None
        self.profile: Optional[Dict] = None

    def mean(self, key: str) -> Optional[float]:
        vals = [s[key] for s in self.solves if s.get(key) is not None]
        return sum(vals) / len(vals) if vals else None

    def roofline_pct(self, matvec: str) -> Optional[float]:
        """The least time of the traced matvecs' work as a share of the
        device time of the kernels that implement them; None where the
        window ran none."""
        if not self.trace:
            return None
        least = self.trace["least_s"].get(matvec, 0.0)
        busy = self.trace["kernel_s"].get(matvec, 0.0)
        if least <= 0.0 or busy <= 0.0:
            return None
        pct = 100.0 * least / busy
        if pct > 100.0:
            raise RunFailed(f"{matvec}: the roofline share reads {pct:.2f} "
                            "%, above 100 %: the work is counted too high "
                            "or the kernel time misses part of it")
        return pct


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             overrides: Optional[Dict] = None) -> Dict:
    """Run the cell once and return the result object (the last line).
    ``overrides`` replace keys of the configuration (tests at small sizes on
    the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = benchmark_spec()
    cell = find_cell(spec, workload)
    cfg = {**find_config(spec, cell["config"]), **(overrides or {})}
    mix = traffic_mod.load(cell["traffic"])
    e2e = metrics_of(spec, workload, "end_to_end")
    per_layer = metrics_of(spec, workload, "per_layer")
    system = load_file("systems", cfg["system"])
    reference = load_file("references", cfg["reference"])

    workdir = tempfile.mkdtemp(prefix="femus-bench-")
    try:
        return _run(cfg, mix, e2e, per_layer, system, reference, workdir,
                    seed, seconds, trace, device, t_start)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(cfg, mix, e2e, per_layer, system, reference, workdir, seed,
         seconds, trace, device, t_start) -> Dict:
    import torch

    run = Run()
    driver = system.Driver(cfg, workdir, device)
    reqs = traffic_mod.requests(mix, seed)
    driver.solve(next(reqs))                 # warm-up: every shape used
    _sync(device)
    run.setup_s = time.perf_counter() - t_start

    sample = traffic_mod.Reservoir(mix["compare"], traffic_mod.rng(seed, 1))
    tracer = None
    if trace:
        from .trace import Tracer
        tracer = Tracer(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_open = time.perf_counter()
    deadline = t_open + seconds
    while True:
        req = next(reqs)
        if tracer is not None and not run.solves:
            tracer.start()
        t0 = time.perf_counter()
        info = driver.solve(req)
        _sync(device)
        t1 = time.perf_counter()
        run.solves.append({**info, "seconds": t1 - t0})
        if tracer is not None and tracer.prof is not None and (
                len(run.solves) == mix["trace_solves"] or t1 >= deadline):
            tracer.stop(t1 - t_open, len(run.solves))
        sample.offer(len(run.solves) - 1,
                     lambda req=req: {"request": req,
                                      "fields": driver.output()})
        if t1 >= deadline:
            break
    run.window_s = t1 - t_open
    if device == "cuda":
        run.peak_bytes = int(torch.cuda.max_memory_allocated())
    if tracer is not None:
        run.trace = tracer.summary
        run.profile = driver.profile()
    layout = driver.layout()
    del driver
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    checks = reference.check(cfg, workdir, layout, sample.sample())
    limits = cfg["limits"]
    if set(checks) != set(limits):
        raise RunFailed(f"the reference compared {sorted(checks)}, the "
                        f"configuration limits {sorted(limits)}")
    correct = all(math.isfinite(v) and v <= limits[k]
                  for k, v in checks.items())

    metrics = {}
    if trace:
        for m in per_layer:
            value = load_file("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = e2e_values(run)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": bool(correct), "attempted": len(run.solves),
           "failed": sum(1 for s in run.solves if not s.get("converged",
                                                            True)),
           "metrics": metrics, "device": dev}
    if trace and run.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in checks.items()}
    return out


def e2e_values(run: Run) -> Dict[str, float]:
    """Every end-to-end reading the harness takes on the host clock."""
    times = [s["seconds"] for s in run.solves]
    out = {"setup_s": run.setup_s,
           "solve_s": run.window_s / len(run.solves),
           "peak_mem_gb": run.peak_bytes / 1e9}
    # the 95th percentile over every solve of the window
    out["solve_p95_s"] = (times[0] if len(times) == 1 else
                          statistics.quantiles(times, n=20,
                                               method="inclusive")[18])
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = parse(argv)
    import torch

    spec = benchmark_spec()
    chips = find_cell(spec, args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"benchmark: needs {chips} CUDA device(s); {found} found",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", t_start)
    except RunFailed as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
