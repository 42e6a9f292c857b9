"""The reduction of a traced window, the roofline share and the percentile
on synthetic data."""
import statistics

import pytest

from benchmark import harness, peaks, traffic
from benchmark.trace import reduce_events

SPECS = {"b1": {"kernels": ["sell_spmv_kernel"]},
         "b2": {"kernels": ["patch_stencil_kernel", "patch_combine_kernel"]}}


def _events():
    ms = 1_000_000
    return [
        # device: two overlapping kernels, a copy, a lone kernel
        ("void sell_spmv_kernel<float, float>(...)", True, 0, 2 * ms),
        ("void axpy(...)", True, 1 * ms, 3 * ms),
        ("Memcpy DtoH (Device -> Pageable)", True, 5 * ms, 6 * ms),
        ("void patch_stencil_kernel<float>(...)", True, 9 * ms, 10 * ms),
        # host
        ("cudaLaunchKernel", False, 0, ms // 10),
        ("aten::mul", False, 3 * ms + 10, 4 * ms),
        ("cudaStreamSynchronize", False, 5 * ms, 6 * ms),
        ("cudaMemcpyAsync", False, 5 * ms, 5 * ms + 10),
        ("cudaDeviceSynchronize", False, 10 * ms, 10 * ms + 5),
    ]


def test_reduce_busy_idle_and_counts():
    s = reduce_events(_events(), window_s=0.010, solves=2, specs=SPECS)
    assert s["busy_s"] == pytest.approx(0.005)      # [0,3] + [5,6] + [9,10]
    assert s["kernels"] == 3                       # the copy is not one
    assert s["syncs"] == 2
    assert s["kernel_s"]["b1"] == pytest.approx(0.002)
    assert s["kernel_s"]["b2"] == pytest.approx(0.001)
    gaps = dict(s["idle_gaps"])
    # [3, 5] and [6, 9]: aten::mul is the last host operation before each
    assert gaps == pytest.approx({"aten::mul": 0.005})
    assert s["device_ops"][0][0].startswith("void sell_spmv_kernel")
    assert len(s["device_ops"]) <= 10 and len(s["idle_gaps"]) <= 10


def _run_with(trace):
    run = harness.Run()
    run.trace = trace
    return run


def test_roofline_share_and_its_fault():
    run = _run_with({"least_s": {"b1": 0.001}, "kernel_s": {"b1": 0.002}})
    assert run.roofline_pct("b1") == pytest.approx(50.0)
    assert run.roofline_pct("b2") is None          # nothing to read
    run = _run_with({"least_s": {"b1": 0.003}, "kernel_s": {"b1": 0.002}})
    with pytest.raises(harness.RunFailed):
        run.roofline_pct("b1")


def test_idle_metric_reads_the_trace():
    from benchmark.plugins import load_file
    run = _run_with(reduce_events(_events(), 0.010, 2, SPECS))
    assert load_file("metrics", "device_idle_pct").read(run) == \
        pytest.approx(50.0)
    assert load_file("metrics", "kernels_per_solve").read(run) == 1.5
    assert load_file("metrics", "d2h_syncs_per_solve").read(run) == 1.0
    assert load_file("metrics", "device_idle_pct").read(harness.Run()) \
        is None


def test_e2e_values_and_percentile():
    run = harness.Run()
    run.solves = [{"seconds": 0.01 * (i + 1)} for i in range(100)]
    run.window_s, run.setup_s, run.peak_bytes = 5.05, 12.0, 3 * 10 ** 9
    v = harness.e2e_values(run)
    assert v["solve_s"] == pytest.approx(0.0505)
    assert v["solve_p95_s"] == pytest.approx(0.9505)
    assert v["solve_p95_s"] == statistics.quantiles(
        [s["seconds"] for s in run.solves], n=20, method="inclusive")[18]
    assert v["peak_mem_gb"] == 3.0 and v["setup_s"] == 12.0


def test_least_seconds():
    assert peaks.least_seconds(3.35e12, 0, "float32") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 34e12, "float64") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12, "bfloat16") == pytest.approx(1.0)


def test_traffic_repeats_from_the_seed():
    mix = traffic.load("cold_modes")
    big = 2 ** 31 + 12345
    a = [next(g)["modes"] for g in [traffic.requests(mix, big)] * 3]
    b = [next(g)["modes"] for g in [traffic.requests(mix, big)] * 3]
    for x, y in zip(a, b):
        assert (x == y).all() and x.shape == (8, 3)
        assert x[:, :2].min() >= 1 and x[:, :2].max() <= 8
    assert not (a[0] == a[1]).all()


def test_reservoir_is_a_seeded_sample():
    def sample(seed, n, k):
        r = traffic.Reservoir(k, traffic.rng(seed, 1))
        for i in range(n):
            r.offer(i, lambda i=i: i)
        return r.sample()
    assert sample(3, 100, 8) == sample(3, 100, 8)
    assert len(sample(3, 100, 8)) == 8 and sample(3, 5, 8) == list(range(5))
    assert sample(3, 40, -1) == list(range(40))


def test_counter_wraps_an_entry_and_keeps_its_launch_count(monkeypatch):
    """The program counts launches on the function its module holds
    (``kernel.launches += 1`` inside the kernel's own wrapper): while the
    benchmark's counter stands in, the count goes on on the original, which
    a table of the program may hold itself."""
    import sys
    import types

    import torch

    from benchmark.trace import MatvecCounter

    mod = types.ModuleType("fake_kernels")

    def kernel(op, x):
        mod.kernel.launches += 1
        return x

    kernel.launches = 5
    mod.kernel = kernel
    monkeypatch.setitem(sys.modules, "fake_kernels", mod)
    plan = types.SimpleNamespace(nnz=100, n=10, n_cols=10)
    op = types.SimpleNamespace(dev=plan, vals=torch.zeros(3))
    counter = MatvecCounter({"b1": {"entry": "fake_kernels:kernel",
                                    "kernels": ["k"], "work": "b1"}})
    counter.install()
    x = torch.zeros(10)
    mod.kernel(op, x)
    mod.kernel(op, x)
    assert mod.kernel is not kernel and kernel.launches == 7
    counter.remove()
    assert mod.kernel is kernel and kernel.launches == 7
    assert counter.calls["b1"] == 2
    # 100 nonzeros of 4-byte values and 4-byte columns, x and y of 10
    assert counter.least_s["b1"] == pytest.approx(
        2 * (100 * 8 + 20 * 4) / peaks.HBM_BYTES_PER_S)
