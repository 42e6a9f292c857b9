"""Port parity: the examples ex01, ex03 and ex05
(``femus_tpu_torch.examples``)
against the JAX package's ``examples/`` of the same names, in float64 on
the host, at the JAX examples' smallest knobs.

Each JAX example runs its own ``main`` (imported with ``examples/`` on
``sys.path``, as tests/test_examples.py does); the functions that return
numbers (ex01 ``project``; ex04 ``run`` in
tests/test_torch_examples_study.py) are wrapped to record what they
return, and those numbers are held against the port's at rel 1e-9.  The
port's printed lines equal the JAX example's as text (paths masked; see
``assert_same_lines`` for the two kinds of printed number that may
differ: one unit in the last printed digit, and values below the float64
rounding floor), and the numbers the port's ``main`` returns, printed the
same way, equal the JAX example's printed digits.
"""
import importlib
import os
import re
import sys

import numpy as np
import pytest
import torch

EX_DIR = os.path.join(os.path.dirname(__file__), "..", "examples")
sys.path.insert(0, os.path.abspath(EX_DIR))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module (small torch ops spend their
    time in thread barriers beside the other test workers otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def masked(text):
    """The printed lines with paths (absolute ones: every path the
    examples print) masked."""
    return [re.sub(r"(?<!\S)/\S*", "<path>", ln)
            for ln in text.splitlines()]


NUM = re.compile(r"[-+]?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?")


def _ulp(tok):
    """One unit in the last printed digit of the number ``tok``."""
    m = re.fullmatch(r"[-+]?\d+(?:\.(\d*))?(?:[eE]([-+]?\d+))?", tok)
    return 10.0 ** (int(m.group(2) or 0) - len(m.group(1) or ""))


def assert_same_lines(jl, tl):
    """The port's lines ``tl`` against the JAX example's ``jl``: equal as
    text, except that a printed number may differ by one unit in its last
    digit (the packages sum in different orders), or when both lie below
    1e-15 (the float64 rounding floor: a Newton step's linear residual
    once the state has converged)."""
    assert len(tl) == len(jl), (tl, jl)
    for a, b in zip(jl, tl):
        if a == b:
            continue
        assert NUM.sub("#", a) == NUM.sub("#", b), (a, b)
        for x, y in zip(NUM.findall(a), NUM.findall(b)):
            fx, fy = float(x), float(y)
            assert (x == y or abs(fx - fy) <= 1.01 * max(_ulp(x), _ulp(y))
                    or max(abs(fx), abs(fy)) < 1e-15), (a, b)


def run_pair(name, env, monkeypatch, capsys, tmp_path, record=(),
             port_kw=None, jax_kept=None):
    """Run the JAX example ``name`` and the port's with the knobs ``env``:
    (JAX lines, port lines, what the port's main returned, {function:
    [(args, result), ...]} of the JAX functions in ``record``).
    ``jax_kept``: a dict that keeps the JAX example's output for the
    next call given it, which then runs the port alone."""
    for k in ("EX_N", "EX_LEVELS", "EX_STEPS", "EX_CYCLES", "EX_D2"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("EX_OUT", str(tmp_path / "out.vtu"))
    if jax_kept:
        jtext, calls = jax_kept["text"], jax_kept["calls"]
    else:
        jtext, calls = _run_jax(name, record, monkeypatch, capsys)
        if jax_kept is not None:
            jax_kept.update(text=jtext, calls=calls)
    capsys.readouterr()
    tmod = importlib.import_module(f"femus_tpu_torch.examples.{name}")
    got = tmod.main(device="cpu", **(port_kw or {}))
    ttext = capsys.readouterr().out
    assert jtext.strip()
    return masked(jtext), masked(ttext), got, calls


def _run_jax(name, record, monkeypatch, capsys):
    """The JAX example's printed text, and the calls of its functions in
    ``record``."""
    jmod = importlib.import_module(name)
    calls = {}
    for fn in record:
        orig = getattr(jmod, fn)

        def rec(*a, _orig=orig, _fn=fn, **kw):
            out = _orig(*a, **kw)
            calls.setdefault(_fn, []).append((a, out))
            return out

        monkeypatch.setattr(jmod, fn, rec)
    capsys.readouterr()
    jmod.main()
    return capsys.readouterr().out, calls


def _rel(a, b, rtol=1e-9):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=rtol, atol=0.0)


def test_ex01_projection_matches_jax(monkeypatch, capsys, tmp_path):
    jl, tl, got, calls = run_pair("ex01_function_approximation",
                                  {"EX_N": "2"}, monkeypatch, capsys,
                                  tmp_path, record=("project",))
    assert_same_lines(jl, tl)
    ref = {(a[0], a[1]): v for a, v in calls["project"]}
    assert len(ref) == 10
    for fam, row in got.items():
        _rel([row["l2_coarse"], row["l2"]], [ref[2, fam], ref[4, fam]])


def test_ex03_cavity_matches_jax(monkeypatch, capsys, tmp_path):
    jl, tl, got, _ = run_pair("ex03_navier_stokes_cavity", {"EX_N": "6"},
                              monkeypatch, capsys, tmp_path)
    assert_same_lines(jl, tl)
    assert jl[-1].startswith(f"max |u| = {got['max_abs_u']}  wrote")
    assert got["max_abs_u"] == 1.0
    assert got["max_eps"] < got["nonlinear_tol"]
    assert os.path.getsize(got["vtu"]) > 0


def test_ex05_magnetic_capture_matches_jax(monkeypatch, capsys, tmp_path):
    jl, tl, got, _ = run_pair("ex05_markers_magnetic", {}, monkeypatch,
                              capsys, tmp_path)
    assert_same_lines(jl, tl)
    assert jl[0] == (
        f"mean distance to wire: {got['mean_dist_before']:.3f} -> "
        f"{got['mean_dist_after']:.3f}; {got['captured']}/{got['markers']} "
        f"markers within capture radius; {got['in_domain']} still in domain")
    assert got["in_domain"] == got["markers"] == 50
    assert got["mean_dist_after"] < got["mean_dist_before"]
    assert got["captured"] >= 1
