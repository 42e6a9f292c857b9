"""Port parity: the examples ex06, ex08 and ex09
(``femus_tpu_torch.examples``) against the JAX package's ``examples/`` of the same names, in float64 on
the host, at the JAX examples' smallest knobs (the comparison rules of
tests/test_torch_examples.py).

ex08 runs both packages on the unit disk that ``chip_smoke.disk_neu``
writes (the reference's disk.neu is absent; the JAX example's ``MESH`` is
set to it); ex09 takes one AMR cycle.
"""
import importlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_examples import assert_same_lines, run_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module (small torch ops spend their
    time in thread barriers beside the other test workers otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ex06_mpm_fsi_matches_jax(monkeypatch, capsys, tmp_path):
    jl, tl, got, _ = run_pair("ex06_mpm_fsi_block", {"EX_N": "4"},
                              monkeypatch, capsys, tmp_path)
    assert_same_lines(jl, tl)
    assert jl[-1] == (f"deformation: det(F) in [{got['det_min']:.3f}, "
                      f"{got['det_max']:.3f}]")
    assert got["com_y"][-1] < got["com_y"][0]
    assert 0.0 < got["det_min"] <= got["det_max"] < np.inf


def test_ex08_tumor_diffusion_matches_jax(monkeypatch, capsys, tmp_path):
    disk = chip_smoke.disk_neu(str(tmp_path / "disk.neu"), 4)
    monkeypatch.setattr(importlib.import_module("ex08_tumor_diffusion"),
                        "MESH", disk)
    jl, tl, got, _ = run_pair("ex08_tumor_diffusion",
                              {"EX_LEVELS": "2", "EX_STEPS": "3"},
                              monkeypatch, capsys, tmp_path,
                              port_kw={"mesh_path": disk})
    assert_same_lines(jl, tl)
    assert jl[-1] == f"mass decay: {got['mass_decay']}"
    masses = [s["mass"] for s in got["steps"]]
    assert masses == sorted(masses, reverse=True) and masses[-1] > 0


def test_ex09_amr_mg_matches_jax(monkeypatch, capsys, tmp_path):
    jl, tl, got, _ = run_pair("ex09_amr_mg", {"EX_N": "4", "EX_CYCLES": "1"},
                              monkeypatch, capsys, tmp_path)
    assert_same_lines(jl, tl)
    assert [c["dofs"] for c in got["cycles"]] == [
        int(re.search(r"dofs=(\d+)", ln).group(1)) for ln in jl[:-1]]
    assert all(c["converged"] for c in got["cycles"])
