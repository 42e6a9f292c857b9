"""Port parity of the whole slice: the steady Navier-Stokes Newton step.

Lid-driven cavity on unit_box((8,8)), 2 levels, RCM hierarchy, Q2/Q2/P1dc
(nu=0.01), operator="bell", interleave_dofs=True, Vanka-smoothed V-cycle
GMRES to rtol 1e-10, in float64 on the host in both packages.  The fine
level (2946 dofs) runs its matvecs on the BELL slab, the coarse level (770)
stays ELL.  One step: equal GMRES iterations, u_new to rtol 1e-8 (the two
packages sum in different orders inside a 1e-10 linear solve).  Four
Newton steps: u to rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch


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


def _bc(var, x, grp, t):
    if var == "p":
        return (False, 0.0)
    if var == "u" and abs(x[1] - 1.0) < 1e-9:
        return (True, 1.0)
    return (True, 0.0)


def _cavity(pkg: str):
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    ml_mesh = mod("mesh.multilevel").MultiLevelMesh(
        mod("mesh.generation").unit_box((8, 8)), 2)
    mod("mesh.reorder").rcm_reorder_hierarchy(ml_mesh)
    ml_sol = mod("systems.solution").MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.add_solution("v", "biquadratic")
    ml_sol.add_solution("p", "disc_linear")
    for n in ("u", "v", "p"):
        ml_sol.initialize(n)
    ml_sol.attach_bc(_bc)
    for n in ("u", "v", "p"):
        ml_sol.generate_bdc(n)
    ml_sol.fix_solution_at_point("p", 0, 0.0)
    prob = mod("systems.problem").MultiLevelProblem(ml_mesh, ml_sol,
                                                    quad_order="fifth")
    sys_ = prob.add_system(mod("systems.system").NonLinearImplicitSystem, "NS")
    sys_.add_unknown("u", "v", "p")
    sys_.set_assembly(mod("assembly.forms").navier_stokes(
        ("u", "v"), "p", pres_family="disc_linear", nu=0.01))
    cfg = sys_.config
    cfg.operator = "bell"
    cfg.interleave_dofs = True
    cfg.smoother = "vanka"
    cfg.rtol = 1e-10
    cfg.max_nonlinear = 4
    return sys_, ml_sol


@pytest.fixture(scope="module")
def slice_runs():
    """One step and a 4-step Newton solve from each package."""
    js, jsol = _cavity("femus_tpu")
    js.init()
    u0 = js.gather(-1)
    jstep = js.step_fn(-1)(jnp.asarray(u0),
                           js.assemblers[-1].device_tables_cached(), {}, {})
    js.solve()
    ts, tsol = _cavity("femus_tpu_torch")
    ts.init(device="cpu")
    np.testing.assert_array_equal(ts.gather(-1), u0)
    tstep = ts.step_fn(-1)(torch.as_tensor(u0))
    ts.solve()
    return dict(js=js, jsol=jsol, jstep=jstep, ts=ts, tsol=tsol, tstep=tstep)


def test_newton_step_matches_jax(slice_runs):
    jstep, tstep = slice_runs["jstep"], slice_runs["tstep"]
    assert tstep.lin_iters == int(jstep[3]) == 9
    assert tstep.converged and tstep.u.dtype == torch.float64
    ref = np.asarray(jstep[0])
    np.testing.assert_allclose(tstep.u.numpy(), ref, rtol=1e-8,
                               atol=1e-8 * np.abs(ref).max())
    np.testing.assert_allclose(tstep.delta.numpy(), np.asarray(jstep[1]),
                               rtol=1e-8, atol=1e-8 * np.abs(ref).max())


def test_newton_solve_matches_jax(slice_runs):
    js, ts = slice_runs["js"], slice_runs["ts"]
    assert len(ts.history) == len(js.history) == 4
    for a, b in zip(ts.history, js.history):
        assert a["lin_iters"] == int(b["lin_iters"])
        assert a["converged"]
    for name in ("u", "v", "p"):
        ref = slice_runs["jsol"].sol[-1][name]
        np.testing.assert_allclose(slice_runs["tsol"].sol[-1][name], ref,
                                   rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    # ||R(u)|| at each step's input falls from step to step
    res = [h["res_norm"] for h in ts.history]
    assert all(b < a for a, b in zip(res, res[1:])) and res[-1] < 1e-3 * res[0]


def test_state_carried_from_jax(slice_runs):
    """The JAX solution, carried over with convert.solution_from_numpy,
    gives the port the same stacked state, and one more step from it takes
    the JAX package's step to rtol 1e-8."""
    from femus_tpu_torch import convert

    js, jsol = slice_runs["js"], slice_runs["jsol"]
    ts, tsol = _cavity("femus_tpu_torch")
    ts.init(device="cpu")
    convert.solution_from_numpy(tsol, {n: jsol.sol[-1][n] for n in "uvp"})
    u = js.gather(-1)
    np.testing.assert_array_equal(ts.gather(-1), u)
    ref = js.step_fn(-1)(jnp.asarray(u),
                         js.assemblers[-1].device_tables_cached(), {}, {})
    out = ts.step_fn(-1)(torch.as_tensor(u))
    assert out.lin_iters == int(ref[3])
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref[0]), rtol=1e-8,
                               atol=1e-8 * np.abs(u).max())


def test_reset_restores_the_state_and_rebuilds_the_steps():
    """System.reset: the fields back to a snapshot, and a solve after it,
    with another smoother set, equals that of a System built with that
    smoother (two Newton steps each)."""
    def solved(smoother, first=None):
        ts, tsol = first or _cavity("femus_tpu_torch")
        if first is None:
            ts.config.max_nonlinear = 2
            ts.init(device="cpu")
        ts.config.smoother = smoother
        ts.solve()
        return ts, tsol

    ts, tsol = _cavity("femus_tpu_torch")
    ts.config.max_nonlinear = 2
    ts.init(device="cpu")
    start = ts.snapshot()
    solved("jacobi", (ts, tsol))
    jacobi = [h["lin_iters"] for h in ts.history]
    ts.reset(start)
    for lv, saved in zip(tsol.sol, start):
        for name, a in saved.items():
            np.testing.assert_array_equal(lv[name], a)
    # the Vanka blocks are built with the step: a kept step has none
    solved("vanka", (ts, tsol))
    ref, rsol = solved("vanka")
    iters = [h["lin_iters"] for h in ts.history]
    assert iters == [h["lin_iters"] for h in ref.history] != jacobi
    for name in ("u", "v", "p"):
        np.testing.assert_allclose(tsol.sol[-1][name], rsol.sol[-1][name],
                                   rtol=0, atol=1e-12)


def test_routing_puts_fine_level_on_bell(slice_runs):
    routing = slice_runs["ts"].solver_info()["routing"]
    note = next(r for r in routing if r["n_rows"] == 2946)
    assert (note["path"], note["order"], note["kernel"]) == (
        "bell", "identity", "bell_spmv")
    # the fill of the card's sliced-ELL layout is reported per level
    from femus_tpu_torch.algebra.bell import SELL_SIGMA
    assert note["sigma"] == SELL_SIGMA and 1.0 <= note["fill"] < 1.5
    # the coarsest level is LU-solved: no matvec of it runs on BELL or ELL
    assert any(r["n_rows"] == 770 and r["path"] == "lu" for r in routing)
    assert not any(r["n_rows"] == 770 and r["path"] != "lu" for r in routing)
    # notes are recorded once, however many steps ran
    assert len(routing) == len({tuple(sorted(r.items())) for r in routing})
    # on the host the BELL matvec is the plain version: no kernel launches
    assert all(h["kernel_launches"] == {"bell_spmv": 0, "patch_stencil": 0,
                                        "dia_spmv": 0, "stencil_spmv": 0}
               for h in slice_runs["ts"].history)


def _poisson(pkg: str, operator: str, bell_order: str, mg_type: str):
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    xp = jnp if pkg == "femus_tpu" else torch

    def rhs(x):
        return 2 * np.pi ** 2 * xp.sin(np.pi * x[:, 0]) * xp.sin(np.pi * x[:, 1])

    ml_mesh = mod("mesh.multilevel").MultiLevelMesh(
        mod("mesh.generation").unit_box((4, 4)), 3)
    ml_sol = mod("systems.solution").MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.initialize("u")
    ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
    ml_sol.generate_bdc("u")
    prob = mod("systems.problem").MultiLevelProblem(ml_mesh, ml_sol,
                                                    quad_order="fifth")
    sys_ = prob.add_system(mod("systems.system").LinearImplicitSystem,
                           "Poisson")
    sys_.add_unknown("u")
    sys_.set_assembly(mod("assembly.forms").poisson("u", "biquadratic",
                                                    rhs=rhs))
    cfg = sys_.config
    cfg.outer = "cg"
    cfg.rtol = 1e-10
    cfg.operator = operator
    cfg.bell_order = bell_order
    cfg.mg_type = mg_type
    if pkg == "femus_tpu":
        sys_.init()
    else:
        sys_.init(device="cpu")
    info = sys_.solve()
    return np.asarray(ml_sol.sol[-1]["u"]), info


@pytest.mark.parametrize("operator,bell_order,mg_type", [
    ("bell", "identity", "V"), ("bell", "rcm", "V"), ("bell", "identity", "F"),
    ("assembled", "identity", "V")])
def test_poisson_mg_cg_matches_jax(operator, bell_order, mg_type):
    """Poisson MG-CG through the system layer (3 levels; with
    operator="bell" the ~4k-dof fine level rides BELL, the coarse levels
    stay ELL) against the JAX assembled-operator solve."""
    u_ref, info_ref = _poisson("femus_tpu", "assembled", "identity", mg_type)
    u, info = _poisson("femus_tpu_torch", operator, bell_order, mg_type)
    assert info["converged"] and info["residual"] < 1e-9
    assert info["iters"] == int(info_ref["iters"])
    np.testing.assert_allclose(u, u_ref, rtol=1e-7, atol=1e-9)
