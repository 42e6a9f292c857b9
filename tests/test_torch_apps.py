"""Port parity: the golden apps (``apps/ns_bench.py``, ``apps/fsi_bench.py``)
against femus_tpu, in float64 on the host (the FSI form and Newton step
in tests/test_torch_apps_fsi.py, so that a parallel run gives them a
worker of their own).

The reference meshes (nsbenc.neu, fsifirst.neu) are absent, so the test
writes a Turek-style channel (``chip_smoke.channel_neu``: 22 x 4 coarse
cells, a square obstacle, with and without the beam of element group 5)
and hands it to both packages: to the JAX apps by setting their ``MESH``,
to the port's through ``mesh_path``.  The constants and the boundary
conditions are equal; ``solid_mark``, ``smark_dof_field`` and
``initial_guess`` are equal; ``temperature_form`` (with aux U, V) and
``fsi_form`` (with smark and the solid group) give the residual and the
Jacobian data to 1e-10 at a random state; one Newton step of
``make_ns_system(levels=2)`` takes the same GMRES iterations and lands
within 1e-8, and the temperature solved in that velocity agrees to 1e-8;
one Newton step of ``make_fsi_system(levels=2, mg_cycle="K")`` likewise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import femus_tpu.apps.fsi_bench as jfsi
import femus_tpu.apps.ns_bench as jns
import femus_tpu_torch.apps.fsi_bench as tfsi
import femus_tpu_torch.apps.ns_bench as tns

NX, NY = 22, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module (small torch ops spend their
    time in thread barriers beside the other test workers otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    d = tmp_path_factory.mktemp("channel")
    return {"ns": chip_smoke.channel_neu(str(d / "channel.neu"), NX, NY),
            "fsi": chip_smoke.channel_neu(str(d / "beam.neu"), NX, NY,
                                          solid=True)}


@pytest.fixture
def jax_meshes(meshes, monkeypatch):
    monkeypatch.setattr(jns, "MESH", meshes["ns"])
    monkeypatch.setattr(jfsi, "MESH", meshes["fsi"])
    return meshes


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_constants_and_conditions_equal():
    for name in ("MESH", "GOLD", "GOLD_SOLVED_T", "IRE", "IPE"):
        assert getattr(tns, name) == getattr(jns, name), name
    for name in ("MESH", "GOLD", "TOL", "IRE", "MUS", "LAM", "SOLID_GROUP"):
        assert getattr(tfsi, name) == getattr(jfsi, name), name
    ys = np.linspace(0.0, 0.41, 7)
    for y in ys:
        assert tns.inflow_u(y) == jns.inflow_u(y)
        for grp in (1, 2, 3, 4):
            x = np.array([0.3, y])
            for var in ("U", "V", "P", "T"):
                assert tns.bc_ns(var, x, grp, 0.0) == jns.bc_ns(var, x, grp,
                                                                0.0)
                assert (tns.bc_temperature(var, x, grp, 0.0)
                        == jns.bc_temperature(var, x, grp, 0.0))
            for var in ("DX", "DY", "U", "V", "P"):
                assert tfsi.bc_fsi(var, x, grp, 0.0) == jfsi.bc_fsi(
                    var, x, grp, 0.0)


def test_marks_and_initial_guess_equal(jax_meshes):
    jm = jfsi.load_mesh(1)
    tm = tfsi.load_mesh(1, jax_meshes["fsi"])
    np.testing.assert_array_equal(tm.coords, jm.coords)
    mark = tfsi.solid_mark(tm)
    np.testing.assert_array_equal(mark, jfsi.solid_mark(jm))
    assert 0 < mark.sum() < mark.size
    ja, ta = jfsi.make_assembler(jm), tfsi.make_assembler(tm, device="cpu")
    np.testing.assert_array_equal(tfsi.smark_dof_field(ta, tm),
                                  jfsi.smark_dof_field(ja, jm))
    jm = jns.load_mesh(1)
    tm = tns.load_mesh(1, jax_meshes["ns"])
    ja = jns.make_ns_assembler(jm)
    ta = tns.make_ns_assembler(tm, device="cpu")
    u0 = tns.initial_guess(ta, tm)
    np.testing.assert_array_equal(u0, np.asarray(jns.initial_guess(ja, jm)))
    for name in ("U", "V", "P"):
        assert tns.var_norm(ta, u0, name) == jns.var_norm(ja, u0, name)
    jT, tT = jns.make_temperature_assembler(jm), \
        tns.make_temperature_assembler(tm, device="cpu")
    np.testing.assert_array_equal(tns.bdc_initialized_T(tT, tm),
                                  np.asarray(jns.bdc_initialized_T(jT, jm)))


def test_temperature_form_matches_jax(jax_meshes):
    jm = jns.load_mesh(1)
    tm = tns.load_mesh(1, jax_meshes["ns"])
    ja = jns.make_temperature_assembler(jm)
    ta = tns.make_temperature_assembler(tm, device="cpu")
    rng = np.random.default_rng(3)
    n = ta.n_dofs
    u = rng.standard_normal(n)
    aux = {k: rng.standard_normal(n) for k in ("U", "V")}
    R1, D1 = ja.make_assemble_fn()(jnp.asarray(u), {
        k: jnp.asarray(v) for k, v in aux.items()}, {})
    R2, D2 = ta.make_assemble_fn()(torch.as_tensor(u), {}, {
        k: torch.as_tensor(v) for k, v in aux.items()})
    _close(R2.numpy(), R1[:n], 1e-10)
    _close(D2.numpy(), np.asarray(D1)[:n], 1e-10)


def _one_step(js, ts):
    """One finest-level Newton step of each package from the same state."""
    u0 = js.gather(-1)
    np.testing.assert_array_equal(ts.gather(-1), u0)
    ref = js.step_fn(-1)(jnp.asarray(u0),
                         js.assemblers[-1].device_tables_cached(),
                         js._aux_arrays(-1), js._aux_scalars_traced())
    out = ts.step_fn(-1)(torch.as_tensor(u0))
    assert out.lin_iters == int(ref[3]) > 0 and out.converged
    _close(out.u.numpy(), np.asarray(ref[0]), 1e-8)
    return np.asarray(ref[0]), out


def test_ns_step_and_temperature_match_jax(jax_meshes):
    jprob, js = jns.make_ns_system(levels=2)
    tprob, ts = tns.make_ns_system(levels=2, mesh_path=jax_meshes["ns"],
                                   device="cpu")
    ref, out = _one_step(js, ts)
    js.scatter(ref, -1)
    ts.scatter(out.u.numpy(), -1)
    jT = jns.make_temperature_system(jprob)
    tT = tns.make_temperature_system(tprob, device="cpu")
    jinfo, tinfo = jT.solve(), tT.solve()
    assert tinfo["converged"] and tinfo["iters"] == int(jinfo["iters"])
    T = tprob.ml_sol.sol[-1]["T"]
    _close(T, jprob.ml_sol.sol[-1]["T"], 1e-8)
    assert T.max() == pytest.approx(5.0) and T.min() < 1.0
