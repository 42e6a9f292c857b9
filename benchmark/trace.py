"""The traced window: torch.profiler over whole solves, the benchmark's own
matvec counters around the kernels' entry points, and the reduction of
both to what the per-layer metrics read.

A matvec's kernel-name list, entry point and work count sit in
``benchmark/kernels/<matvec>.json`` (keys ``entry``: "module:function",
``kernels``: substrings of the device kernels' names, ``work``: the name
of ``benchmark/work/<work>.py``).  While the window is traced, each entry
point is wrapped: every call adds the work that one matvec of its operator
needs, computed from the operator's shapes by the work file's
``work(op, x) -> (bytes, flops, dtype)``.
"""
from __future__ import annotations

import bisect
import glob
import importlib
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from . import peaks
from .plugins import load_file

HERE = os.path.dirname(os.path.abspath(__file__))
# host calls that wait for the device: copies to the host end in one
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def matvec_specs() -> Dict[str, Dict]:
    """Every ``benchmark/kernels/*.json``, by matvec name."""
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", "*.json"))):
        with open(path) as fh:
            out[os.path.basename(path)[:-5]] = json.load(fh)
    return out


class MatvecCounter:
    """Wraps each matvec entry point while it is installed; ``least_s``
    sums, per matvec, the least time the chip needs for the calls' work."""

    def __init__(self, specs: Dict[str, Dict]):
        self.specs = specs
        self.least_s = {m: 0.0 for m in specs}
        self.calls = {m: 0 for m in specs}
        self._saved: List[Tuple[object, str, object]] = []

    def install(self) -> None:
        for name, spec in self.specs.items():
            mod_name, fn_name = spec["entry"].split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn_name)
            work = load_file("work", spec["work"]).work
            self._saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, self._wrap(name, orig, work))

    def _wrap(self, name, orig, work):
        counter = self

        class Counted:
            """Stands in for ``orig`` under its name; the program's
            ``fn.launches += 1`` on it lands on ``orig``, so a table that
            holds ``orig`` itself (``system.KERNELS``) keeps counting."""

            launches = property(
                lambda _: orig.launches,
                lambda _, v: setattr(orig, "launches", v))

            def __call__(self, op, x, *args, **kw):
                nbytes, flops, dtype = work(op, x)
                counter.least_s[name] += peaks.least_seconds(nbytes, flops,
                                                             dtype)
                counter.calls[name] += 1
                return orig(op, x, *args, **kw)
        return Counted()

    def remove(self) -> None:
        for mod, fn_name, orig in reversed(self._saved):
            setattr(mod, fn_name, orig)
        self._saved.clear()


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def kineto_events(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every event of a finished
    ``torch.profiler.profile``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), e.device_type() == cuda, start,
                    start + e.duration_ns()))
    return out


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_events(events, window_s: float, solves: int,
                  specs: Dict[str, Dict]) -> Dict:
    """What the per-layer metrics read from one traced window of ``solves``
    whole solves lasting ``window_s`` seconds on the host clock."""
    dev = [(n, a, b) for n, d, a, b in events if d]
    host = [(n, a, b) for n, d, a, b in events if not d]
    busy = _union((a, b) for _, a, b in dev)
    busy_ns = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for n, a, b in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
    kernel_s = {m: sum(s for n, s in by_name.items()
                       if any(k in n for k in spec["kernels"]))
                for m, spec in specs.items()}
    # idle gaps between device activity, each named by the last host
    # operation (not a CUDA runtime call) that started before the gap
    # ended: what the host was doing while the device waited
    gaps: Dict[str, float] = {}
    ops = sorted((a, n) for n, a, _ in host if not n.startswith("cuda"))
    starts = [a for a, _ in ops]
    for (_, b0), (a1, _) in zip(busy, busy[1:]):
        k = bisect.bisect_left(starts, a1) - 1
        label = ops[k][1] if k >= 0 else "host"
        gaps[label] = gaps.get(label, 0.0) + (a1 - b0) * 1e-9
    top = sorted(by_name.items(), key=lambda t: -t[1])[:10]
    return {
        "solves": solves,
        "window_s": window_s,
        "busy_s": busy_ns * 1e-9,
        "kernels": sum(1 for n, _, _ in dev if not _is_copy(n)),
        "syncs": sum(1 for n, _, _ in host if n in SYNC_CALLS),
        "kernel_s": kernel_s,
        "device_ops": [[n[:160], s] for n, s in top],
        "idle_gaps": [[n[:160], s] for n, s in
                      sorted(gaps.items(), key=lambda t: -t[1])[:10]],
    }


class Tracer:
    """Profiles the solves between :meth:`start` and :meth:`stop`."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self.specs = matvec_specs()
        self.counter = MatvecCounter(self.specs)
        self.prof = None
        self.summary: Optional[Dict] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.counter.install()
        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if self.device == "cuda":
            torch.cuda.synchronize()

    def stop(self, window_s: float, solves: int) -> None:
        import torch
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.counter.remove()
        self.summary = reduce_events(kineto_events(self.prof), window_s,
                                     solves, self.specs)
        self.summary["least_s"] = dict(self.counter.least_s)
        self.summary["matvecs"] = dict(self.counter.calls)
        self.prof = None
