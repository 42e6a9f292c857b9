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
- the program's recorder (:class:`Recorder`, a PhaseTimer): ``span(name)``
  and ``count(site)`` where the work happens, kept per solve
  (:func:`solves`) and for the process (:func:`totals`), and, while a
  torch profiler runs, a timeline of the spans on the profiler's clock,
- trace(): context manager around ``torch.profiler`` writing a Chrome
  trace of the host and device activity (the PETSc -log_view analogue),
  the program's spans among the kernels, and the device's idle time put
  down to the span open over it.

Caveat for device timing: CUDA work is asynchronous, so a wall-clock span
measures the enqueue unless it ends in ``torch.cuda.synchronize()``.
``PhaseTimer`` and ``convergence_table`` print the text of
``femus_tpu.utils.telemetry``.

Spans (dotted names nest; the program opens them):

- ``solve``: one ``LinearImplicitSystem``/``NonLinearImplicitSystem``
  solve, which is also one record of :func:`solves`;
- ``step``: one solve step (``System._run_step``), up to its synchronise;
  inside it ``step.assemble`` (fine assembly, ``||R||``, the fine
  operator), ``step.coarsen`` (the coarse operators: Galerkin PtAP and
  Dirichlet identity, or each rediscretized level's assembly),
  ``step.mg_setup`` (coarse BELL re-layout; ``mg_setup.smoothers``: Vanka
  block inverses, Chebyshev lambda_max, Jacobi diagonals, and inside it
  ``smoothers.vanka_invert``: a level's Vanka blocks gathered, factorised
  and inverted;
  ``mg_setup.coarse_lu``: the coarsest dense LU) and ``step.krylov`` (the
  outer solve; each iteration's ``krylov.precond`` and ``krylov.orth``);
- ``drive``: the solve's host work around its steps (gather and upload,
  copies to the host, correction norms, scatter, F-cycle prolongation);
- ``setup.mesh``, ``setup.init``, ``setup.step_build``,
  ``setup.kernel_load``: the mesh hierarchy, ``System.init``, the lazy
  build of a solve step (its plans, blocks, transfer chains and the
  assembly's device tables), and each CUDA library's load (and build).

A span opened while one of the same name is open (a nested build, an
inner Krylov solve inside a preconditioner) adds nothing: the outer one
already holds its time.  Counters: ``host_wait.<site>`` at each program
site that blocks on the device (counted whatever the device: on the host
nothing waits), ``rebuild.<what>`` at each cache miss of a built step,
transfer chain, BELL plan, assembly's device tables or kernel library
(``kernel_build``: an ``nvcc`` run), ``vanka.colour_kernel`` and
``vanka.colour_torch`` at each colour step of a multiplicative Vanka sweep
(the CUDA kernel's or the plain PyTorch chain's), ``vanka.blocks_inverted``
at each level's Vanka set-up (the blocks it inverts, from host shapes).
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import os
import time
import types
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch
from torch.autograd import _profiler_enabled

# solve records kept (the newest)
KEEP_SOLVES = 4096
# timeline entries kept while a profiler runs (the newest)
KEEP_TIMELINE = 1 << 20


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


class Recorder(PhaseTimer):
    """The program's spans and counters.

    ``totals``/``counts`` (the PhaseTimer's) hold every span of the
    process; ``sites`` every counter.  A solve record, open between
    :meth:`open_solve` and :meth:`close_solve`, receives the spans and
    counters of its solve too: ``{"system", "solve" (seconds), "spans":
    {name: [seconds, calls]}, "counts": {site: n}}``.  While a torch
    profiler runs, each span also lands in ``timeline`` as ``(name, depth,
    start_ns, end_ns)`` on the profiler's clock (the wall clock), and,
    while ``tracing`` (set by :func:`trace`), enters ``record_function``
    so the exported trace shows it."""

    def __init__(self, keep: int = KEEP_SOLVES) -> None:
        super().__init__()
        self.sites: Dict[str, int] = {}
        self.records: collections.deque = collections.deque(maxlen=keep)
        self.timeline: collections.deque = collections.deque(
            maxlen=KEEP_TIMELINE)
        self.tracing = False
        self._open: List[dict] = []          # open solve records
        self._stack: List[str] = []          # open span names
        self._profiling = False
        self._offset_ns = 0

    # ---- clock ---------------------------------------------------------
    def now_ns(self) -> int:
        """perf_counter on the profiler's clock (wall-clock ns)."""
        return time.perf_counter_ns() + self._offset_ns

    def start_timeline(self) -> None:
        """Empty the timeline and take the wall clock's offset anew."""
        self.timeline.clear()
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self._profiling = True

    def _profiler_on(self) -> bool:
        if _profiler_enabled():
            if not self._profiling:          # a profiler has started
                self.start_timeline()
            return True
        self._profiling = False
        return False

    # ---- solve records -------------------------------------------------
    def open_solve(self, system: str) -> dict:
        rec = {"system": system, "solve": 0.0, "spans": {}, "counts": {}}
        self._open.append(rec)
        return rec

    def close_solve(self, rec: dict, seconds: float) -> None:
        rec["solve"] = seconds
        self._open.remove(rec)
        self.records.append(rec)

    # ---- counters ------------------------------------------------------
    def count(self, site: str, n: int = 1) -> None:
        sites = self.sites
        sites[site] = sites.get(site, 0) + n
        if self._open:
            c = self._open[-1]["counts"]
            c[site] = c.get(site, 0) + n

    def _add(self, name: str, t0: float, t1: float) -> None:
        dt = t1 - t0
        self.totals[name] += dt
        self.counts[name] += 1
        if self._open:
            spans = self._open[-1]["spans"]
            e = spans.get(name)
            if e is None:
                spans[name] = [dt, 1]
            else:
                e[0] += dt
                e[1] += 1
        if self._profiler_on():
            off = self._offset_ns
            self.timeline.append((name, len(self._stack),
                                  int(t0 * 1e9) + off, int(t1 * 1e9) + off))


class Span:
    """One span of ``rec`` (a context manager); ``seconds`` holds its
    duration once it has closed, nested in one of its name or not."""

    __slots__ = ("rec", "name", "t0", "seconds", "_own", "_rf")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> "Span":
        rec = self.rec
        self._own = self.name not in rec._stack
        self._rf = None
        self.t0 = time.perf_counter()
        if self._own:
            rec._stack.append(self.name)
            if rec.tracing and rec._profiler_on():
                # inside the span's interval, so the trace's annotation
                # and the ops under it lie within the timeline's entry
                from torch.profiler import record_function
                self._rf = record_function(self.name)
                self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        t1 = time.perf_counter()
        self.seconds = t1 - self.t0
        if self._own:
            self.rec._stack.pop()
            self.rec._add(self.name, self.t0, t1)
        return False


class SolveRecord:
    """The record of one solve and its ``solve`` span (a context
    manager)."""

    __slots__ = ("rec", "system", "_span", "_entry")

    def __init__(self, rec: Recorder, system: str):
        self.rec, self.system = rec, system

    def __enter__(self) -> dict:
        self._entry = self.rec.open_solve(self.system)
        self._span = Span(self.rec, "solve").__enter__()
        return self._entry

    def __exit__(self, *exc) -> bool:
        self._span.__exit__(*exc)
        self.rec.close_solve(self._entry, self._span.seconds)
        return False


# the process's recorder: the program's spans and counters land here
RECORDER = Recorder()


def span(name: str) -> Span:
    """``with span(name):`` times the block into the open solve record and
    the process totals."""
    return Span(RECORDER, name)


def timed(name: str):
    """Decorator: every call of the function is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with Span(RECORDER, name):
                return fn(*args, **kw)
        return inner
    return wrap


def count(site: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``site`` (open solve record and process)."""
    RECORDER.count(site, n)


def records_solve(solve):
    """Method decorator: each call of ``solve`` is one solve record of
    ``self.name``."""
    @functools.wraps(solve)
    def inner(self, *args, **kw):
        with SolveRecord(RECORDER, self.name):
            return solve(self, *args, **kw)
    return inner


def solves() -> List[dict]:
    """The newest solve records, oldest first."""
    return list(RECORDER.records)


def totals() -> Dict[str, Dict]:
    """Every span (``{name: [seconds, calls]}``) and counter of the
    process so far."""
    rec = RECORDER
    return {"spans": {n: [t, rec.counts[n]] for n, t in rec.totals.items()},
            "counts": dict(rec.sites)}


def timeline() -> List[Tuple[str, int, int, int]]:
    """The spans of the latest profiler session: (name, depth, start_ns,
    end_ns) on the profiler's clock, in the order they closed."""
    return list(RECORDER.timeline)


def _label_segments(spans, w0: int, w1: int) -> List[Tuple[int, int, str]]:
    """[w0, w1] cut into (start, end, innermost open span or "outside");
    ``spans`` properly nested (name, depth, start, end)."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []
    t = w0

    def emit(a, b, label):
        a, b = max(a, w0), min(b, w1)
        if b > a:
            out.append((a, b, label))

    for name, _, a, b in sorted(spans, key=lambda s: (s[2], s[1])):
        while stack and stack[-1][0] <= a:
            end, nm = stack.pop()
            emit(t, end, nm)
            t = max(t, end)
        emit(t, a, stack[-1][1] if stack else "outside")
        t = max(t, a)
        stack.append((b, name))
    while stack:
        end, nm = stack.pop()
        emit(t, end, nm)
        t = max(t, end)
    emit(t, w1, "outside")
    return out


def _union(intervals) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_by_span(spans, busy, w0: int, w1: int) -> Dict[str, float]:
    """Seconds of [w0, w1] (ns) in which the device ran nothing of
    ``busy`` ((start, end) ns), by the innermost span of ``spans`` open
    then, ``"outside"`` where none was; the parts sum to the idle time."""
    idle, t = [], w0
    for a, b in _union(busy):
        if a > t:
            idle.append((t, min(a, w1)))
        t = max(t, b)
        if t >= w1:
            break
    if t < w1:
        idle.append((t, w1))
    segs = _label_segments(spans, w0, w1)
    starts = [s[0] for s in segs]
    out: Dict[str, float] = {}
    for a, b in idle:
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(segs) and segs[k][0] < b:
            sa, sb, label = segs[k]
            lo, hi = max(a, sa), min(b, sb)
            if hi > lo:
                out[label] = out.get(label, 0.0) + (hi - lo) * 1e-9
            k += 1
    return out


def device_busy(events, spans) -> List[Tuple[int, int]]:
    """(start, end) ns of the device work among profiler ``events``
    (kernels, copies, sets), leaving out the ranges the device's timeline
    shows for the annotations named in ``spans``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.device_type() == cuda and e.name() not in spans]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[types.SimpleNamespace]:
    """torch.profiler trace of the block: host (CPU) activity always, and
    CUDA kernels and copies when a card is present, with the program's
    spans among them.  On exit the trace is written as Chrome-trace JSON
    into ``log_dir`` (``trace_<pid>_<n>.json``, open it in chrome://tracing
    or Perfetto).  Yields a handle whose ``profile`` is the torch profiler
    (for ``key_averages()``) and whose ``path`` is the trace file once the
    block has ended; then also ``timeline`` (the spans, as
    :func:`timeline`), ``window_s`` (the block's length), ``idle_s`` (the
    part of it in which the device ran nothing) and ``idle_by_span`` (that
    idle time by the innermost span open over it, ``"outside"`` where none
    was)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    handle = types.SimpleNamespace(profile=prof, path=None, timeline=[],
                                   window_s=0.0, idle_s=0.0,
                                   idle_by_span={})
    rec = RECORDER
    prof.start()
    rec.start_timeline()
    rec.tracing = True
    w0 = rec.now_ns()
    try:
        yield handle
    finally:
        if cuda:
            torch.cuda.synchronize()
        w1 = rec.now_ns()
        rec.tracing = False
        prof.stop()
        handle.timeline = timeline()
        busy = device_busy(prof.profiler.kineto_results.events(),
                           {s[0] for s in handle.timeline})
        handle.idle_by_span = idle_by_span(handle.timeline, busy, w0, w1)
        handle.window_s = (w1 - w0) * 1e-9
        handle.idle_s = sum(handle.idle_by_span.values())
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
