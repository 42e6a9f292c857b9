"""vanka_kernel_share reads the program's colour-step counters from the
window's solve records, and gives nothing where no solve took a step."""
import pytest

from benchmark import plugins

share = plugins.load_file("metrics", "vanka_kernel_share")


class _Run:
    def __init__(self, n):
        self.solves = [{"seconds": 1.0}] * n


def _record(kernel, torch_steps):
    counts = {"host_wait.a": 3}
    if kernel:
        counts["vanka.colour_kernel"] = kernel
    if torch_steps:
        counts["vanka.colour_torch"] = torch_steps
    return {"system": "s", "solve": 1.0, "spans": {}, "counts": counts}


def test_share_is_the_median_over_the_window(monkeypatch):
    from femus_tpu_torch.utils import telemetry
    warm = _record(0, 500)
    window = [_record(300, 0), _record(100, 100), _record(660, 0)]
    monkeypatch.setattr(telemetry, "solves", lambda: [warm, *window])
    assert share.read(_Run(3)) == pytest.approx(1.0)
    window[2] = _record(0, 40)
    assert share.read(_Run(3)) == pytest.approx(0.5)


def test_no_colour_step_reads_nothing(monkeypatch):
    from femus_tpu_torch.utils import telemetry
    monkeypatch.setattr(telemetry, "solves",
                        lambda: [_record(0, 0), _record(0, 0)])
    assert share.read(_Run(2)) is None
    assert share.read(_Run(3)) is None          # fewer records than solves
    monkeypatch.delattr(telemetry, "solves")
    assert share.read(_Run(2)) is None


def test_listed_for_the_channel_alone():
    m = [m for m in plugins.benchmark_spec()["per_layer"]
         if m["name"] == "vanka_kernel_share"]
    assert m and m[0]["workloads"] == ["channel.steady"]
    assert m[0]["moves"] == "solve_s" and m[0]["source"] == "program_counter"


def test_traced_channel_run_on_the_host_reads_the_plain_chain():
    """On the host the sweep runs the plain chain: the traced channel line
    reports a share of 0."""
    from benchmark import harness
    small = {"mesh": {"coarse_cells": [44, 8], "levels": 2}}
    out = harness.run_cell("channel.steady", 2 ** 31 + 91, 0.2, True,
                           device="cpu", overrides=small)
    assert out["correct"] is True
    assert out["metrics"]["vanka_kernel_share"]["value"] == 0.0
