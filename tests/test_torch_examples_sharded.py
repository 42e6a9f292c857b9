"""Port parity: the example ex10 (``femus_tpu_torch.examples``: the
sharded transient cavity with markers and a mid-run restart) against the
JAX package's ``examples/ex10_sharded_transient_particles.py``, in float64
on the host: the port on 4 gloo ranks, and on one rank in process (the
way it runs on one card), against the JAX example on its 8 virtual
devices (run once for both), at EX_N=6, EX_STEPS=4 (the comparison rules
of tests/test_torch_examples.py, the device count masked): u within 1e-8,
the markers' positions within 1e-10 and their elements equal, the port's
restart exact.
"""
import re

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



_JAX = {}


def _ex10(n_ranks, monkeypatch, capsys, tmp_path):
    jl, tl, got, calls = run_pair(
        "ex10_sharded_transient_particles", {"EX_N": "6", "EX_STEPS": "4"},
        monkeypatch, capsys, tmp_path, record=("run",),
        port_kw={"n_ranks": n_ranks}, jax_kept=_JAX)
    assert_same_lines([re.sub(r"devices \d+", "devices #", ln) for ln in jl],
                      [re.sub(r"devices \d+", "devices #", ln) for ln in tl])
    assert f"devices {n_ranks}:" in tl[0]
    assert got["du"] == 0.0 and got["dx"] == 0.0 and got["elems_match"]
    u, px, pe, res = calls["run"][0][1]
    n = got["u"].size
    np.testing.assert_allclose(got["u"], u[:n], rtol=0,
                               atol=1e-8 * np.abs(u).max())
    from femus_tpu.particles.sharded import collect
    jx, je = collect(px, pe)
    assert len(jx) == len(got["x"]) == got["alive"] == 40
    # the ranks hold the markers in another order: match each by position
    near = np.argmin(np.linalg.norm(got["x"][:, None] - jx[None], axis=2),
                     axis=1)
    assert sorted(near) == list(range(len(jx)))
    np.testing.assert_allclose(got["x"], jx[near], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got["elem"], je[near])


def test_ex10_sharded_restart_matches_jax(monkeypatch, capsys, tmp_path):
    _ex10(4, monkeypatch, capsys, tmp_path)


def test_ex10_one_rank_matches_jax(monkeypatch, capsys, tmp_path):
    _ex10(1, monkeypatch, capsys, tmp_path)
