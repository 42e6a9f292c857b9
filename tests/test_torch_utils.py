"""Port parity of the utilities (``femus_tpu_torch/utils``), the System
diagnostics and ``fe/tabulate.py``'s point evaluations, against femus_tpu.

- ``InputParser``, ``Files``, ``ParsedFunction``, ``PhaseTimer`` and
  ``convergence_table`` on the cases of ``tests/test_utils.py``: equal
  values and equal text; ``trace`` writes a Chrome trace on the CPU.
- Checkpoints: the cases of ``tests/test_checkpoint.py`` (npz layout),
  tensors in the state, particle clouds restored as tensors on their
  device, ``use_orbax=True`` refused, and a checkpoint written by either
  package restored by the other with equal arrays.
- Debug aids on the cases of ``tests/test_debug_aids.py``: the
  Navier-Stokes ``element_jacobian`` within 1e-12 of JAX's, the Matrix
  Market and ``FieldDumper`` files equal to JAX's.
- ``tabulate_at`` and ``inverse_map_newton`` (numpy and torch) equal to
  JAX's (1e-12); ``System.profile_step`` returns its three positive
  phase times, and ``dofmap_size`` equals JAX's.
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

from femus_tpu.utils import checkpoint as jck
from femus_tpu_torch.utils import checkpoint as tck


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module: beside the other test workers
    and the spawned ranks, the many small torch ops of these cases spend
    their time in thread barriers otherwise (the 3-D patch solve took
    minutes under a parallel run, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ---- config, files, parsed functions, telemetry ---------------------------

def test_input_parser_equals_jax(tmp_path):
    from femus_tpu.utils.config import InputParser as J
    from femus_tpu_torch.utils.config import InputParser as T
    j = tmp_path / "conf.json"
    j.write_text('{"mesh": {"n": 16, "type": "quad"}, "levels": [1, 2, 3]}')
    kv = tmp_path / "femus_conf.in"
    kv.write_text("nlevels 3  # comment\nsolver gmres\ntol 1e-8\nflag true\n")
    argv = ["prog", "--nlevels=5", "--verbose", "--x=0.5"]
    for load, arg in (("from_json", str(j)), ("from_keyvalue", str(kv)),
                      ("from_argv", argv)):
        assert getattr(T, load)(arg)._data == getattr(J, load)(arg)._data
    pt = T.from_json(str(j))
    assert pt.get("mesh.n") == 16 and pt["mesh/type"] == "quad"
    assert pt.get_size("levels") == 3 and not pt.have("missing.key")
    assert pt.get("missing.key", 7) == 7
    with pytest.raises(KeyError):
        pt["missing"]
    m = T.from_keyvalue(str(kv)).merge(T.from_argv(argv))
    assert m._data == J.from_keyvalue(str(kv)).merge(J.from_argv(argv))._data
    assert m["nlevels"] == 5 and m["verbose"] is True


def test_files_restart_equals_jax(tmp_path):
    from femus_tpu.utils.files import Files as J
    from femus_tpu_torch.utils.files import Files as T
    for cls, tag in ((J, "j"), (T, "t")):
        root = str(tmp_path / tag / "out")
        f1 = cls(output_root=root)
        d1 = f1.setup(stamp="run1")
        f1.mark_for_restart()
        f2 = cls(output_root=root)
        f2.setup(restart=True, stamp="run2")
        assert f2.restart_dir == d1 and os.path.isdir(d1)
        with f2.redirect_stdout() as logpath:
            print("hello from run2")
        assert "hello" in open(logpath).read()
        assert f2.path("a", "b") == os.path.join(root, "run2", "a", "b")
    for name in ("run_to_restart_from", "last_run"):
        assert (tmp_path / "j" / "out" / name).read_text() == \
            (tmp_path / "t" / "out" / name).read_text()


def test_parsed_function_equals_jax():
    from femus_tpu.utils.parsed_function import ParsedFunction as J
    from femus_tpu_torch.utils.parsed_function import ParsedFunction as T
    x = np.random.default_rng(0).uniform(size=(7, 3))
    for expr in ("sin(pi*x)*cos(pi*y) + t", "sqrt(x*x + y*y) - z",
                 "max(x, y) * exp(-t)"):
        ref = J(expr)(x, t=2.0)
        np.testing.assert_array_equal(T(expr)(x, t=2.0), ref)
        np.testing.assert_array_equal(T(expr)(torch.as_tensor(x), t=2.0),
                                      ref)
    assert T("sin(pi*x)*cos(pi*y) + t")(np.array([0.5, 0.0])) == \
        pytest.approx(1.0)
    for bad in ("__import__('os')", "system(x)"):
        with pytest.raises(ValueError):
            T(bad)


def test_phase_timer_and_convergence_table_equal_jax(monkeypatch):
    from femus_tpu.utils import telemetry as jt
    from femus_tpu_torch.utils import telemetry as tt
    timers = []
    for mod in (jt, tt):
        clock = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        pt = mod.PhaseTimer()
        for name in ("assembly", "solve", "solve"):
            with pt.phase(name):
                pass
        timers.append(pt)
    assert timers[1].as_dict() == timers[0].as_dict() == {
        "assembly": 0.25, "solve": 0.625}
    assert timers[1].report() == timers[0].report()
    hist = [{"level": 0, "newton_it": 0, "lin_iters": 5, "lin_res": 1e-3,
             "eps": {"u": 1e-2, "p": 3e-2}},
            {"level": 1, "newton_it": 1, "lin_iters": 4, "lin_res": 1e-8,
             "eps": {"u": 1e-7}},
            {"level": 2}]
    tab = tt.convergence_table(hist)
    assert tab == jt.convergence_table(hist)
    assert "1.000e-08" in tab and tab.count("\n") == 3


def test_trace_writes_a_chrome_trace(tmp_path):
    from femus_tpu_torch.utils.telemetry import trace
    with trace(str(tmp_path / "tr")) as h:
        a = torch.ones(64, 64, dtype=torch.float64)
        (a @ a).sum()
    assert os.path.dirname(h.path) == str(tmp_path / "tr")
    events = json.load(open(h.path))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert h.profile.key_averages()


# ---- checkpoints ----------------------------------------------------------

def _ml_sol(pkg):
    mm = _mod(pkg, "mesh.multilevel").MultiLevelMesh(
        _mod(pkg, "mesh.generation").unit_box((3, 3), "quad"), n_levels=2)
    ms = _mod(pkg, "systems.solution").MultiLevelSolution(mm)
    ms.add_solution("u", "biquadratic", time_order=1)
    ms.add_solution("p", "linear")
    for l in range(2):
        for k in ms.sol[l]:
            ms.sol[l][k][:] = np.random.default_rng(l).normal(
                size=ms.sol[l][k].shape)
        ms.sol_old[l]["u"][:] = -ms.sol[l]["u"]
    return ms


def _fields(ms):
    return [{k: v.copy() for k, v in d.items()}
            for d in ms.sol + ms.sol_old]


def _zero(ms):
    for d in ms.sol + ms.sol_old:
        for v in d.values():
            v[:] = 0.0


def _assert_fields(ms, ref):
    for d, r in zip(ms.sol + ms.sol_old, ref):
        assert d.keys() == r.keys()
        for k in d:
            np.testing.assert_array_equal(d[k], r[k])


def test_checkpoint_roundtrip_and_retention(tmp_path):
    ms = _ml_sol("femus_tpu_torch")
    ref = _fields(ms)
    mgr = tck.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    state = {"solution": tck.capture_solution(ms),
             "time": torch.tensor(1.5, dtype=torch.float64),
             "hist": [np.arange(3), {"a": np.ones(2)}]}
    for s in (3, 7, 9):
        mgr.save(s, state)
    assert mgr.latest_step() == 9
    assert sorted(os.listdir(mgr.dir)) == ["ckpt_7", "ckpt_9"]
    _zero(ms)
    back = mgr.restore()
    tck.restore_solution(ms, back["solution"])
    _assert_fields(ms, ref)
    assert float(back["time"]) == 1.5
    np.testing.assert_array_equal(back["hist"][0], np.arange(3))
    np.testing.assert_array_equal(back["hist"][1]["a"], np.ones(2))
    with pytest.raises(FileNotFoundError):
        tck.CheckpointManager(str(tmp_path / "empty")).restore()
    with pytest.raises(ValueError, match="orbax"):
        tck.CheckpointManager(str(tmp_path / "o"), use_orbax=True)


@pytest.mark.parametrize("writer", ["femus_tpu", "femus_tpu_torch"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """A checkpoint written by one package (JAX's npz path,
    ``use_orbax=False``) restores into the other's MultiLevelSolution with
    equal arrays, the system bookkeeping and a particle cloud with it."""
    reader = "femus_tpu_torch" if writer == "femus_tpu" else "femus_tpu"
    wck = jck if writer == "femus_tpu" else tck
    rck = tck if writer == "femus_tpu" else jck
    src, dst = _ml_sol(writer), _ml_sol(reader)
    _zero(dst)
    x = np.random.default_rng(0).uniform(0.1, 0.9, size=(16, 2))
    mesh = _mod(writer, "mesh.generation").unit_box((3, 3), "quad")
    cloud = _mod(writer, "particles.markers").MarkerCloud(
        mesh=mesh, x=x, elem=np.arange(16) % 9)

    class Clock:
        time, dt, step_count = 0.25, 0.01, 7

    wck.CheckpointManager(str(tmp_path), use_orbax=False).save(
        5, {"solution": wck.capture_solution(src),
            "system": wck.capture_system(Clock()),
            "cloud": wck.capture_particles(cloud)})
    back = rck.CheckpointManager(str(tmp_path), use_orbax=False).restore()
    rck.restore_solution(dst, back["solution"])
    _assert_fields(dst, _fields(src))
    clock = type("C", (), {"time": 0.0, "dt": 1.0, "step_count": 0})()
    rck.restore_system(clock, back["system"])
    assert (clock.time, clock.dt, clock.step_count) == (0.25, 0.01, 7)
    cloud_r = _mod(reader, "particles.markers").MarkerCloud(
        mesh=_mod(reader, "mesh.generation").unit_box((3, 3), "quad"),
        x=np.zeros_like(x), elem=np.zeros(16, np.int64))
    cloud_r = rck.restore_particles(cloud_r, back["cloud"])
    np.testing.assert_array_equal(np.asarray(cloud_r.x), x)
    np.testing.assert_array_equal(np.asarray(cloud_r.elem), cloud.elem)


def test_particles_restore_as_tensors_on_their_device(tmp_path):
    from femus_tpu_torch.particles.mpm import MPMState
    g = torch.Generator().manual_seed(0)
    st = MPMState(*(torch.rand(s, generator=g, dtype=torch.float64)
                    for s in ((8, 2), (8, 2), (8, 2, 2), (8,), (8,))),
                  elem=torch.arange(8))
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(0, {"mpm": tck.capture_particles(st)})
    blank = MPMState(*(torch.zeros_like(getattr(st, f)) for f in
                       ("x", "v", "F", "mass", "vol0", "elem")))
    back = tck.restore_particles(blank, mgr.restore(0)["mpm"])
    for f in ("x", "v", "F", "mass", "vol0", "elem"):
        a, b = getattr(back, f), getattr(st, f)
        assert torch.is_tensor(a) and a.device == b.device
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---- debug aids -------------------------------------------------------------

def _ns_assemblers():
    fields = [("u", "biquadratic"), ("v", "biquadratic"),
              ("p", "disc_linear")]
    out = []
    for pkg, kw in (("femus_tpu", {}), ("femus_tpu_torch", {"device": "cpu"})):
        eng, forms = _mod(pkg, "assembly.engine"), _mod(pkg, "assembly.forms")
        a = eng.Assembler(_mod(pkg, "mesh.generation").unit_box((3, 3)),
                          [eng.Unknown(n, f) for n, f in fields],
                          quad_order="fifth", **kw)
        a.set_volume_form(forms.navier_stokes(
            ("u", "v"), "p", pres_family="disc_linear", nu=0.05))
        _mod(pkg, "assembly.bc").generate_bdc(
            a, lambda var, x, grp, t: (var != "p", 0.0))
        out.append(a)
    return out


def test_element_jacobian_equals_jax():
    from femus_tpu.utils.debug import element_jacobian as jej
    from femus_tpu_torch.utils.debug import element_jacobian as tej
    ja, ta = _ns_assemblers()
    u = np.random.default_rng(0).standard_normal(ta.n_dofs)
    uj = np.concatenate([u, np.zeros(ja.n_dofs_pad - ta.n_dofs)])
    for e in (0, 4, 8):
        rj, Jj, dj = jej(ja, uj, e)
        rt, Jt, dt = tej(ta, torch.as_tensor(u), e)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_allclose(Jt, Jj, rtol=0,
                                   atol=1e-12 * np.abs(Jj).max())
        np.testing.assert_allclose(rt, rj, rtol=0,
                                   atol=1e-12 * np.abs(rj).max())


def test_element_jacobians_sum_to_the_assembled_matrix():
    from femus_tpu_torch.utils.debug import element_jacobian, op_to_scipy
    _, ta = _ns_assemblers()
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(ta.n_dofs))
    _, data = ta.make_assemble_fn()(u)
    A = op_to_scipy(ta.pattern, data, ta.n_dofs).toarray()
    S = np.zeros_like(A)
    for e in range(ta.mesh.n_elems):
        _, J, edofs = element_jacobian(ta, u, e)
        S[np.ix_(edofs, edofs)] += J
    free = ~ta.dirichlet_mask
    np.testing.assert_allclose(S[np.ix_(free, free)], A[np.ix_(free, free)],
                               rtol=0, atol=1e-12 * np.abs(A).max())


def test_matrix_market_and_printer_equal_jax(tmp_path, capsys):
    import jax.numpy as jnp
    from femus_tpu.utils import debug as jd
    from femus_tpu_torch.utils import debug as td
    ja, ta = _ns_assemblers()
    u = np.random.default_rng(2).standard_normal(ta.n_dofs)
    _, dj = ja.make_assemble_fn()(jnp.asarray(np.concatenate(
        [u, np.zeros(ja.n_dofs_pad - ta.n_dofs)])), {}, {})
    _, dt = ta.make_assemble_fn()(torch.as_tensor(u))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(dj)).max())
    # the same data through both dumpers: the same file
    pj = jd.save_matrix_market(str(tmp_path / "j" / "A.mtx"), ja.pattern,
                               np.asarray(dj), ta.n_dofs)
    pt = td.save_matrix_market(str(tmp_path / "t" / "A.mtx"), ta.pattern,
                               torch.tensor(np.asarray(dj)), ta.n_dofs)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    txt = td.print_element_jacobian(ta, u, 0)
    assert "jacobian" in txt and "element 0" in txt
    assert txt in capsys.readouterr().out


def _poisson_system(pkg, levels=1, n=3):
    ml_mesh = _mod(pkg, "mesh.multilevel").MultiLevelMesh(
        _mod(pkg, "mesh.generation").unit_box((n, n), "quad"), levels)
    ml_sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.initialize("u", lambda x: x[:, 0])
    ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
    ml_sol.generate_bdc("u")
    prob = _mod(pkg, "systems.problem").MultiLevelProblem(
        ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(_mod(pkg, "systems.system").LinearImplicitSystem,
                           "P")
    sys_.add_unknown("u")
    sys_.set_assembly(_mod(pkg, "assembly.forms").poisson(
        rhs=lambda x: 1.0 + 0.0 * x[..., 0]))
    return sys_


def test_field_dumper_files_equal_jax(tmp_path):
    from femus_tpu.utils.debug import FieldDumper as JD
    from femus_tpu_torch.utils.debug import FieldDumper as TD
    js, ts = _poisson_system("femus_tpu"), _poisson_system("femus_tpu_torch")
    for s in (js, ts):
        s.config.use_mg = False
    js.init()
    ts.init(device="cpu")
    dj, dt = JD(js, str(tmp_path / "j"), "it"), TD(ts, str(tmp_path / "t"),
                                                   "it")
    for k in range(2):
        pj, pt = dj.dump(), dt.dump()
        assert os.path.basename(pt) == f"it.{k:04d}.vtu" == \
            os.path.basename(pj)
        assert open(pj, "rb").read() == open(pt, "rb").read()


# ---- tabulation at points, System diagnostics -------------------------------

def test_tabulate_at_and_inverse_map_equal_jax():
    from femus_tpu.fe import tabulate as jtab
    from femus_tpu_torch.fe import tabulate as ttab
    from femus_tpu_torch.fe.basis import get_basis
    from femus_tpu_torch.fe.geom import nodes_from_corners
    pts = ((0.1, -0.3), (0.5, 0.5), (-0.9, 0.2))
    for geom, fam in (("quad", "biquadratic"), ("quad", "linear"),
                      ("quad", "disc_linear")):
        for a, b in zip(ttab.tabulate_at(geom, fam, pts),
                        jtab.tabulate_at(geom, fam, pts)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)
    pts3 = ((0.1, 0.2, 0.3),)
    for a, b in zip(ttab.tabulate_at("hex", "biquadratic", pts3),
                    jtab.tabulate_at("hex", "biquadratic", pts3)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)
    # the inverse map on the mildly distorted quad of tests/test_fe_core.py
    corners = np.array([[0, 0], [2, 0.1], [2.2, 1.9], [-0.1, 2.0]])
    coords = np.asarray(nodes_from_corners("quad", corners))
    xi_true = np.array([0.3, -0.4])
    x_phys = get_basis("quad", "biquadratic").eval(xi_true[None])[0] @ coords
    ref = jtab.inverse_map_newton("quad", coords, x_phys, np)
    got_np = ttab.inverse_map_newton("quad", coords, x_phys, np)
    got_t = ttab.inverse_map_newton("quad", torch.as_tensor(coords),
                                    torch.as_tensor(x_phys), torch)
    np.testing.assert_allclose(got_np, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_t.numpy(), ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ref, xi_true, rtol=0, atol=1e-10)


def test_profile_step_and_dofmap_size():
    """profile_step returns the reference's per-phase split (assembly,
    coarsening into the level, the solve step), each positive, and writes
    it into System.timing; dofmap_size equals the JAX package's."""
    js = _poisson_system("femus_tpu", levels=2, n=4)
    ts = _poisson_system("femus_tpu_torch", levels=2, n=4)
    ts.init(device="cpu")
    prof = ts.profile_step(-1, reps=2)
    assert set(prof) == {"assembly_s", "coarsen_s", "solve_step_s"}
    assert all(v > 0 for v in prof.values())
    assert {k: ts.timing[k] for k in prof} == prof
    # the coarsest level has no coarsening phase
    assert set(ts.profile_step(0, reps=1)) == {"assembly_s", "solve_step_s"}
    for level in (0, 1):
        assert ts.dofmap_size("u", level) == js.dofmap_size("u", level)
