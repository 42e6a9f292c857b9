"""The port's recorder (``femus_tpu_torch.utils.telemetry``) on small solves
on the host.

- A small lid-driven cavity (Galerkin V-cycle, Vanka, ``operator="bell"``
  below the BELL threshold, so ELL) and a small patch Poisson (patch
  operator, rediscretized Chebyshev V-cycle) each leave one record a solve,
  with every step span once a step, the Krylov spans once an iteration,
  and the step spans plus ``drive`` covering the solve.
- ``host_wait.gmres_hessenberg`` is one a GMRES iteration; a second solve
  rebuilds nothing; ``profile_step`` leaves no record.
- With no profiler nothing enters ``record_function`` and the timeline
  stays as it was; under another profiler the spans reach the timeline
  and not the profiler's events; under ``telemetry.trace()`` the spans
  hold the ops under them on the profiler's clock, the Chrome trace names
  them, and ``idle_by_span`` sums to the window's idle time.
"""
import json

import numpy as np
import pytest
import torch

from femus_tpu_torch.utils import telemetry

STEP_SPANS = ("step.assemble", "step.coarsen", "step.mg_setup",
              "step.krylov")
# every span a multigrid-GMRES solve step opens inside its solve
SOLVE_SPANS = ("solve", "step", "drive", *STEP_SPANS, "mg_setup.smoothers",
               "mg_setup.coarse_lu", "krylov.precond", "krylov.orth")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cavity():
    from femus_tpu_torch.assembly.forms import navier_stokes
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import NonLinearImplicitSystem

    def bc(var, x, grp, t):
        if var == "p":
            return (False, 0.0)
        return (True, 1.0 if var == "u" and abs(x[1] - 1.0) < 1e-9
                else 0.0)

    ml_mesh = MultiLevelMesh(unit_box((4, 4)), 2)
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
                                    pres_family="disc_linear", nu=0.1))
    cfg = sys_.config
    cfg.operator = "bell"
    cfg.smoother = "vanka"
    cfg.mg_type = "V"
    cfg.rtol = 1e-6
    cfg.max_nonlinear = 3
    sys_.init(device="cpu")
    sys_.initial = sys_.snapshot()
    return sys_


def _patch_poisson():
    from femus_tpu_torch.assembly.forms import poisson
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import PatchedMultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import LinearImplicitSystem

    ml_mesh = PatchedMultiLevelMesh(unit_box((4, 4)), 3)
    ml_sol = MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.initialize("u")
    ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
    ml_sol.generate_bdc("u")
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(LinearImplicitSystem, "poisson")
    sys_.add_unknown("u")
    sys_.set_assembly(poisson(
        "u", rhs=lambda x: torch.sin(np.pi * x[:, 0])
        * torch.sin(2 * np.pi * x[:, 1])))
    cfg = sys_.config
    cfg.operator = "patch"
    cfg.coarse_op = "rediscretize"
    cfg.smoother = "chebyshev"
    cfg.rtol = 1e-8
    sys_.init(device="cpu")
    sys_.initial = sys_.snapshot()
    return sys_


def _solve(sys_):
    """One whole solve from the system's initial state; its record."""
    for lv, saved in zip(sys_.ml_sol.sol, sys_.initial):
        for n, a in saved.items():
            lv[n][:] = a
    n = len(telemetry.solves())
    info = sys_.solve()
    recs = telemetry.solves()
    assert len(recs) == min(n + 1, telemetry.RECORDER.records.maxlen)
    return info, recs[-1]


@pytest.fixture(scope="module")
def cavity():
    sys_ = _cavity()
    first = _solve(sys_)
    return sys_, first, _solve(sys_)


@pytest.fixture(scope="module")
def patch():
    sys_ = _patch_poisson()
    first = _solve(sys_)
    return sys_, first, _solve(sys_)


def _steps(sys_, info):
    hist = getattr(sys_, "history", None)
    return (len(hist), sum(h["lin_iters"] for h in hist)) if hist else \
        (1, info["iters"])


@pytest.mark.parametrize("case", ["cavity", "patch"])
def test_one_record_a_solve_with_every_span(case, request):
    sys_, (_, first), (info, rec) = request.getfixturevalue(case)
    steps, iters = _steps(sys_, info)
    assert rec["system"] == sys_.name and rec["solve"] > 0
    spans = rec["spans"]
    assert set(SOLVE_SPANS) <= set(spans)
    calls = {n: c for n, (_, c) in spans.items()}
    assert calls["solve"] == 1 and calls["step"] == steps
    for name in (*STEP_SPANS, "mg_setup.smoothers", "mg_setup.coarse_lu"):
        assert calls[name] == steps, name
    assert calls["krylov.orth"] >= iters and calls["krylov.precond"] >= iters
    assert calls["drive"] >= steps
    # the first solve built its steps; the set-up spans sit in the totals
    assert first["counts"].get("rebuild.step", 0) >= 1
    assert "setup.step_build" in first["spans"]
    tot = telemetry.totals()["spans"]
    for name in ("setup.mesh", "setup.init", "setup.step_build"):
        assert tot[name][0] > 0 and tot[name][1] >= 1


@pytest.mark.parametrize("case", ["cavity", "patch"])
def test_step_spans_and_drive_cover_the_solve(case, request):
    _, _, (_, rec) = request.getfixturevalue(case)
    covered = sum(rec["spans"][n][0] for n in (*STEP_SPANS, "drive"))
    assert 0.9 * rec["solve"] <= covered <= rec["solve"]
    # the step spans are the step's parts
    inside = sum(rec["spans"][n][0] for n in STEP_SPANS)
    assert inside <= rec["spans"]["step"][0]


@pytest.mark.parametrize("case", ["cavity", "patch"])
def test_a_hessenberg_read_per_iteration_and_no_rebuild(case, request):
    sys_, _, (info, rec) = request.getfixturevalue(case)
    _, iters = _steps(sys_, info)
    counts = rec["counts"]
    assert counts["host_wait.gmres_hessenberg"] == iters
    steps = rec["spans"]["step"][1]
    assert counts["host_wait.res_norm"] == steps
    assert counts["host_wait.gather_upload"] == steps
    assert not [k for k in counts if k.startswith("rebuild.")]
    assert "setup.step_build" not in rec["spans"]


def test_profile_step_adds_no_record(patch):
    sys_ = patch[0]
    n = len(telemetry.solves())
    before = telemetry.totals()["spans"]["step.assemble"][1]
    sys_.profile_step(-1, reps=1)
    assert len(telemetry.solves()) == n
    # its steps land in the process totals only
    assert telemetry.totals()["spans"]["step.assemble"][1] > before


class _Counting:
    """Stands in for ``torch.profiler.record_function``, counting entries."""
    entered = 0
    real = torch.profiler.record_function

    def __init__(self, name):
        self.inner = _Counting.real(name)

    def __enter__(self):
        _Counting.entered += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def test_no_profiler_no_record_function_no_timeline(patch, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.entered = 0
    before = telemetry.timeline()
    _solve(patch[0])
    assert _Counting.entered == 0
    assert telemetry.timeline() == before


def test_another_profiler_gets_no_span_events(patch, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.entered = 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve(patch[0])
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert _Counting.entered == 0
    assert not names & set(SOLVE_SPANS)
    got = {s[0] for s in telemetry.timeline()}
    assert set(SOLVE_SPANS) <= got


def test_trace_puts_spans_on_the_profilers_clock(cavity, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.entered = 0
    with telemetry.trace(str(tmp_path)) as h:
        _solve(cavity[0])
    assert _Counting.entered == len(h.timeline) > 0
    events = list(h.profile.profiler.kineto_results.events())
    marks = {}
    for e in events:
        if e.name() in SOLVE_SPANS:
            marks.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = {}
    for name, depth, a, b in h.timeline:
        spans.setdefault(name, []).append((a, b))
    assert set(SOLVE_SPANS) <= set(spans)
    # each span holds its trace annotation, and every aten op under it
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
           if e.name().startswith("aten::")]
    for name in SOLVE_SPANS:
        assert len(marks[name]) == len(spans[name])
        for (s, e), (a, b) in zip(sorted(marks[name]), sorted(spans[name])):
            assert a <= s <= e <= b, name
            inner = [o for o in ops if s <= o[0] and o[1] <= e]
            assert all(a <= o[0] and o[1] <= b for o in inner)
    names = {e.get("name") for e in json.load(open(h.path))["traceEvents"]}
    assert set(SOLVE_SPANS) <= names
    # no card: the whole window is idle, every part of it owned
    assert sum(h.idle_by_span.values()) == pytest.approx(h.idle_s, rel=1e-9)
    assert h.idle_s == pytest.approx(h.window_s, rel=1e-6)
    assert h.idle_by_span["krylov.precond"] > 0


def test_idle_by_span_splits_gaps_by_innermost_span():
    spans = [("solve", 0, 10, 100), ("step", 1, 20, 90),
             ("step.krylov", 2, 40, 80)]
    busy = [(0, 15), (30, 50), (85, 120)]
    got = telemetry.idle_by_span(spans, busy, 0, 110)
    # idle: 15-30 (solve 15-20, step 20-30), 50-85 (krylov 50-80,
    # step 80-85)
    assert got == pytest.approx({"solve": 5e-9, "step": 15e-9,
                                 "step.krylov": 30e-9})
    assert telemetry.idle_by_span([], [], 0, 50) == pytest.approx(
        {"outside": 5e-8})
    assert telemetry.idle_by_span(spans, [], 0, 120) == pytest.approx(
        {"outside": 3e-8, "solve": 2e-8, "step": 3e-8,
         "step.krylov": 4e-8})


def test_span_counts_into_the_open_record_and_the_totals():
    rec = telemetry.Recorder(keep=4)
    assert rec.records.maxlen == 4 and telemetry.KEEP_SOLVES >= 4096
    with telemetry.Span(rec, "outer"):
        rec.count("host_wait.x")
    with telemetry.SolveRecord(rec, "sys") as r:
        with telemetry.Span(rec, "outer") as s:
            with telemetry.Span(rec, "outer"):      # nested: adds nothing
                rec.count("host_wait.x", 2)
    assert s.seconds >= 0
    assert r["system"] == "sys" and r["counts"] == {"host_wait.x": 2}
    assert r["spans"]["outer"][1] == 1 and r["spans"]["solve"][1] == 1
    assert rec.counts["outer"] == 2 and rec.sites == {"host_wait.x": 3}
    assert list(rec.records) == [r]


class _Event:
    def __init__(self, name, cuda, start, end):
        self._n, self._c, self._s, self._e = name, cuda, start, end

    def name(self):
        return self._n

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


def test_device_busy_leaves_out_the_spans_annotations():
    events = [_Event("sell_spmv_kernel", True, 10, 20),
              _Event("step", True, 0, 100),          # the span's range
              _Event("aten::mul", False, 5, 9),
              _Event("Memcpy HtoD", True, 30, 35)]
    assert telemetry.device_busy(events, {"step", "drive"}) == [
        (10, 20), (30, 35)]
