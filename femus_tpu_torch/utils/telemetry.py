"""Structured solver telemetry and profiler hooks.

The reference instruments with ad-hoc wall-clock printouts (SURVEY.md §5.1:
assembly/solver spans LinearImplicitSystem.cpp:292-410, totals
`compute_assembly_vs_net_solver_times` NonLinearImplicitSystem.cpp:89-98,
PetscTime around KSPSolve).  Here telemetry is data, not stdout: solve()
already returns per-iteration history (level, newton_it, per-variable eps
norms, linear residual/iters — systems/system.py); this module adds

- PhaseTimer: named wall-clock spans with totals (the
  `_totalAssemblyTime/_totalSolverTime` analogue),
- report(): the assembly-vs-solver split summary,
- trace(): context manager around ``torch.profiler`` writing a Chrome
  trace of the host and device activity (the PETSc -log_view analogue).

Caveat for device timing: CUDA work is asynchronous, so a wall-clock span
measures the enqueue unless it ends in ``torch.cuda.synchronize()``.
``PhaseTimer`` and ``convergence_table`` print the text of
``femus_tpu.utils.telemetry``.
"""
from __future__ import annotations

import contextlib
import os
import time
import types
from collections import defaultdict
from typing import Dict, Iterator, List


class PhaseTimer:
    """Accumulating named wall-clock spans."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        """Assembly-vs-net-solver style split (reference
        NonLinearImplicitSystem.cpp:89-98)."""
        total = sum(self.totals.values()) or 1.0
        lines = [f"{'phase':<20}{'total [s]':>12}{'calls':>8}{'share':>8}"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<20}{t:>12.4f}{self.counts[name]:>8}"
                         f"{t / total:>8.1%}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[types.SimpleNamespace]:
    """torch.profiler trace of the block: host (CPU) activity always, and
    CUDA kernels and copies when a card is present.  On exit the trace is
    written as Chrome-trace JSON into ``log_dir``
    (``trace_<pid>_<n>.json``, open it in chrome://tracing or Perfetto).
    Yields a handle whose ``profile`` is the torch profiler (for
    ``key_averages()``) and whose ``path`` is the trace file once the
    block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    handle = types.SimpleNamespace(profile=prof, path=None)
    prof.start()
    try:
        yield handle
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
        handle.path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
        prof.export_chrome_trace(handle.path)


def convergence_table(history: List[dict]) -> str:
    """Render the Newton/linear history returned by
    NonLinearImplicitSystem.solve() as the reference-style convergence
    trace (LinearImplicitSystem.cpp:426 printouts)."""
    lines = ["level  newton_it  lin_iters  lin_res      max_eps"]
    for h in history:
        eps = max(h.get("eps", {"": float("nan")}).values())
        lines.append(f"{h.get('level', 0):>5}  {h.get('newton_it', 0):>9}"
                     f"  {h.get('lin_iters', 0):>9}"
                     f"  {h.get('lin_res', float('nan')):>11.3e}"
                     f"  {eps:>11.3e}")
    return "\n".join(lines)
