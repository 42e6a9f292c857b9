"""The per-layer metrics that read the program's recorder: a traced run of
each cell at a small size on the CPU reports every one of them for its
cells, and the per-solve ones read the window's solves alone."""
import pytest

from benchmark import harness, plugins, spans

# the sizes of test_bench_run.py
SMALL = {"channel.steady": {"mesh": {"coarse_cells": [44, 8], "levels": 2}},
         "patch.solve": {"mesh": {"coarse_cells": 4, "levels": 3}}}
SEED = 2 ** 31 + 78

NEW = ("span_assemble_ms", "span_coarsen_ms", "span_mg_setup_ms",
       "span_krylov_ms", "span_drive_ms", "host_waits_per_solve",
       "span_setup_mesh_s", "span_setup_init_s", "span_setup_step_build_s",
       "span_setup_kernels_s")


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_reports_the_span_metrics(cell):
    out = harness.run_cell(cell, SEED, 0.2, True, device="cpu",
                           overrides=SMALL[cell])
    assert out["correct"] is True
    listed = {m["name"] for m in plugins.metrics_of(
        plugins.benchmark_spec(), cell, "per_layer")}
    assert set(NEW) <= listed
    m = out["metrics"]
    for name in NEW:
        if name == "span_setup_kernels_s":
            # no CUDA library is loaded on the host
            assert m.get(name, {"value": 0.0})["value"] == 0.0
            continue
        assert m[name]["value"] > 0, name


class _Run:
    def __init__(self, n):
        self.solves = [{"seconds": 1.0}] * n


def _record(ms, waits):
    return {"system": "s", "solve": 1.0,
            "spans": {"step.assemble": [ms * 1e-3, 1]},
            "counts": {"host_wait.a": waits, "rebuild.step": 7}}


def test_window_records_skip_the_warm_up(monkeypatch):
    from femus_tpu_torch.utils import telemetry
    warm = _record(500.0, 90)
    window = [_record(2.0, 3), _record(4.0, 5), _record(3.0, 4)]
    monkeypatch.setattr(telemetry, "solves", lambda: [warm, *window])
    run = _Run(3)
    assert spans.window_records(run) == window
    assert spans.span_ms(run, "step.assemble") == pytest.approx(3.0)
    assert spans.host_waits(run) == 4
    assert spans.span_ms(run, "step.coarsen") == 0.0
    # fewer records than solves: nothing to read
    assert spans.span_ms(_Run(5), "step.assemble") is None
    monkeypatch.delattr(telemetry, "solves")
    assert spans.host_waits(run) is None
