"""Port parity: the examples ex02, ex04 and ex07
(``femus_tpu_torch.examples``: the convergence study, the time
integrators, the PCE) against the JAX package's ``examples/`` of the same
names, in float64 on the host, at the JAX examples' own knobs (the
comparison rules of tests/test_torch_examples.py).

ex04's ``run`` and ex07's ``solve_poisson`` and PCE coefficients are
recorded on the JAX side and held at rel 1e-9.
"""
import numpy as np
import pytest
import torch

from test_torch_examples import assert_same_lines, run_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module (small torch ops spend their
    time in thread barriers beside the other test workers otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b, rtol=1e-9):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=rtol, atol=0.0)


def test_ex02_convergence_matches_jax(monkeypatch, capsys, tmp_path):
    jl, tl, got, _ = run_pair("ex02_poisson_convergence", {}, monkeypatch,
                              capsys, tmp_path)
    assert_same_lines(jl, tl)
    for fam, p in zip(("linear", "serendipity", "biquadratic"), (2, 3, 3)):
        assert abs(got[fam]["l2_orders"][-1] - p) < 0.2
        assert f"{got[fam]['l2'][-1]:12.4e}" in "\n".join(tl)


def test_ex04_time_integrators_match_jax(monkeypatch, capsys, tmp_path):
    jl, tl, got, calls = run_pair("ex04_transient_heat_rk", {}, monkeypatch,
                                  capsys, tmp_path, record=("run",))
    assert_same_lines(jl, tl)
    ref = {(a[0], a[1]): v for a, v in calls["run"]}
    for scheme in ("cn", "rk"):
        _rel(got[scheme]["l2"], [ref[scheme, 0.025], ref[scheme, 0.0125]])
    assert abs(got["cn"]["order"] - 2) < 0.2
    assert got["rk"]["l2"][-1] < got["cn"]["l2"][-1]


def test_ex07_pce_matches_jax(monkeypatch, capsys, tmp_path):
    jl, tl, got, calls = run_pair("ex07_uq_pce", {}, monkeypatch, capsys,
                                  tmp_path,
                                  record=("pce_project", "solve_poisson"))
    assert_same_lines(jl, tl)
    _rel(got["coeffs"], calls["pce_project"][0][1])
    from femus_tpu_torch.examples import ex07_uq_pce as t07
    for args, value in calls["solve_poisson"][::3]:
        _rel(t07.solve_poisson(args[0], "cpu"), value)
    assert np.isfinite([got["mean"], got["var"]]).all() and got["var"] > 0
    assert np.isfinite(got["pdf"]).all() and min(got["pdf"]) >= 0
