"""Whole runs of each cell at a small size on the CPU (the program's plain
matvecs stand in for the kernels): the last line's schema, the import
check, the faults that ``correct`` has to catch, and a cell added as new
files only."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import harness, plugins

ROOT = plugins.ROOT
# sizes a test run can hold: the channel refined once, the patch square at
# 16 x 16 elements
SMALL = {"channel.steady": {"mesh": {"coarse_cells": [44, 8], "levels": 2}},
         "patch.solve": {"mesh": {"coarse_cells": 4, "levels": 3}}}
SEED = 2 ** 31 + 77


def _run(cell, trace=False, seconds=0.2):
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            overrides=SMALL[cell])


@pytest.fixture(scope="module")
def torch_one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_last_line_schema(cell, torch_one_thread):
    out = _run(cell)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["attempted"] >= 1
    e2e = plugins.metrics_of(plugins.benchmark_spec(), cell, "end_to_end")
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    for m in e2e:
        assert out["metrics"][m["name"]]["unit"] == m["unit"]
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.loads(json.dumps(out))


def test_traced_line_carries_the_layers(torch_one_thread):
    out = _run("patch.solve", trace=True)
    assert out["correct"] is True
    m = out["metrics"]
    # on the CPU no device metric has anything to read
    assert {"krylov_iters", "assembly_ms"} <= set(m)
    assert not {"device_idle_pct", "b2_roofline_pct"} & set(m)


BROKEN = {
    # a step that returns its state unchanged
    "unchanged": "out._replace(u=u.to(out.u.dtype), delta=0 * out.delta)",
    # an answer altered where it is produced: one dof moved by max |u|
    "altered": "out._replace(u=_spike(out.u))",
}


@pytest.mark.parametrize("fault", sorted(BROKEN))
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch,
                                      torch_one_thread):
    from femus_tpu_torch.systems import system as sysmod

    orig = sysmod.System.step_fn

    def _spike(v):
        v = v.clone()
        v[v.numel() // 2] += v.abs().max()
        return v

    def step_fn(self, level=-1, device=None):
        step = orig(self, level, device)

        def broken(u, *args, **kw):
            out = step(u, *args, **kw)
            return eval(BROKEN[fault], {"out": out, "u": u,
                                        "_spike": _spike})
        return broken

    monkeypatch.setattr(sysmod.System, "step_fn", step_fn)
    out = _run(cell)
    assert out["correct"] is False, out["checks"]


def _scaled_operator(monkeypatch):
    """Kernel B2's class returns 0.9 A x: GMRES converges to u / 0.9, a
    smooth error that the residual reads as 0.11, under its limit."""
    from femus_tpu_torch.algebra import patchstencil
    matvec = patchstencil.PatchStencilOp.matvec
    monkeypatch.setattr(patchstencil.PatchStencilOp, "matvec",
                        lambda self, x: 0.9 * matvec(self, x))
    return {}


def _newton_stopped_short(monkeypatch):
    """One Newton step a level where the configuration states five."""
    solver = plugins.config(plugins.benchmark_spec(),
                            "dfg-2d1-square-obstacle")["solver"]
    return {"solver": {**solver, "max_newton_per_level": 1}}


@pytest.mark.parametrize("cell, fault", [
    ("patch.solve", _scaled_operator),
    ("channel.steady", _newton_stopped_short)])
def test_a_wrong_or_short_solve_is_not_correct(cell, fault, monkeypatch,
                                               torch_one_thread):
    over = {**SMALL[cell], **fault(monkeypatch)}
    out = harness.run_cell(cell, SEED, 0.2, False, device="cpu",
                           overrides=over)
    assert out["correct"] is False, out["checks"]


def test_nothing_forbidden_is_loaded(tmp_path):
    """A fresh process that runs the harness and each cell's driver: no
    top-level jax, jaxlib, flax, femus_tpu or chip_smoke module."""
    code = textwrap.dedent(f"""
        import json, sys, torch
        torch.set_num_threads(2)
        sys.path.insert(0, {ROOT!r})
        from benchmark import harness
        for cell, over in {SMALL!r}.items():
            out = harness.run_cell(cell, 5, 0.5, False, device="cpu",
                                   overrides=over)
            assert out["correct"], out
        print(json.dumps([harness.forbidden_modules(),
                          "femus_tpu_torch" in sys.modules]))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    bad, loaded = json.loads(res.stdout.splitlines()[-1])
    assert bad == [] and loaded


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "femus_tpu_torch_extra", sys)
    assert "femus_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def test_a_cell_is_added_as_files_only(tmp_path):
    """A throwaway cell, configuration, traffic mix and per-layer metric,
    added as new files to a copy of the benchmark (and entries of its
    BENCHMARK.json), runs with no edit to an existing file."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = plugins.benchmark_spec()
    before = {p: open(os.path.join(ROOT, "benchmark", p), "rb").read()
              for p in ("harness.py", "traffic.py", "plugins.py",
                        "trace.py")}
    cfg = plugins.config(spec, "poisson-q2-patch-1m")
    cfg.update(name="tiny-poisson", mesh={"coarse_cells": 4, "levels": 2})
    new = tmp_path / "benchmark"
    (new / "configs" / "tiny-poisson.json").write_text(json.dumps(cfg))
    (new / "traffic" / "tiny_cold.json").write_text(json.dumps(
        {"loop": "closed", "compare": 2, "trace_solves": 2,
         "modes": {"count": 3, "max_k": 4, "amplitude": [1, 2]}}))
    (new / "metrics" / "solves_seen.py").write_text(
        "def read(run):\n    return float(len(run.solves))\n")
    spec["configs"].append({"name": "tiny-poisson", "source": "a test",
                            "file": "benchmark/configs/tiny-poisson.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny.cold", "config": "tiny-poisson",
                              "traffic": "tiny_cold", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "solves_seen", "unit": "solves",
                              "better": "higher", "source":
                              "program_counter", "layer": "drive",
                              "moves": "solve_s", "workloads": ["tiny.cold"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = textwrap.dedent(f"""
        import json, sys, torch
        torch.set_num_threads(2)
        sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]
        from benchmark import harness
        assert harness.__file__.startswith({str(tmp_path)!r})
        print(json.dumps([harness.run_cell("tiny.cold", 9, 0.2, t,
                                           device="cpu")
                          for t in (False, True)]))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = json.loads(res.stdout.splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert {"solve_s", "solve_p95_s", "setup_s", "peak_mem_gb"} >= set(
        plain["metrics"]) >= {"solve_s", "setup_s", "peak_mem_gb"}
    assert traced["metrics"]["solves_seen"]["value"] >= 1
    for p, text in before.items():
        assert open(os.path.join(ROOT, "benchmark", p), "rb").read() == text
