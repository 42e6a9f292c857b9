"""Port parity of the time integrators and of transient monolithic FSI.

The set-ups of the JAX package's own transient tests (theta-scheme heat
equation with backward Euler and Crank-Nicolson, 2-stage Gauss IRK, a
Dirichlet wall that switches type mid-run), a Newmark step, and two steps
of transient FSI, run in both packages on the host in float64 from the
same initial state: fields to 1e-10 (FSI: 1e-8, through MG-preconditioned
FGMRES solves).  The mask-switching run also shows that no step function
built against the old mask survives ``_refresh_bc``.
"""
import importlib

import numpy as np
import pytest
import torch

PI = np.pi


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _init(pkg, sys_):
    if pkg == "femus_tpu":
        sys_.init()
    else:
        sys_.init(device="cpu")


def _xp(pkg):
    import jax.numpy as jnp
    return jnp if pkg == "femus_tpu" else torch


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _heat(pkg, n, scheme, bc=None, cls="TransientLinearImplicitSystem"):
    """u_t - Lap u = 0 on unit_box((n,n)) from sin(pi x) sin(pi y)."""
    ml_mesh = _mod(pkg, "mesh.multilevel").MultiLevelMesh(
        _mod(pkg, "mesh.generation").unit_box((n, n), "quad"), 1)
    ml_sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic", time_order=1)
    ml_sol.initialize("u", lambda x: np.sin(PI * x[:, 0])
                      * np.sin(PI * x[:, 1]))
    ml_sol.attach_bc(bc or (lambda var, x, grp, t: (True, 0.0)))
    ml_sol.generate_bdc("u")
    prob = _mod(pkg, "systems.problem").MultiLevelProblem(ml_mesh, ml_sol,
                                                          quad_order="fifth")
    tr = _mod(pkg, "systems.transient")
    sys_ = prob.add_system(getattr(tr, cls), "Heat")
    sys_.add_unknown("u")
    base = _mod(pkg, "assembly.forms").poisson("u", "biquadratic")
    sys_.set_assembly(scheme(tr)(base, {"u": "biquadratic"}))
    sys_.config.outer = "cg"
    sys_.config.use_mg = False
    sys_.config.rtol = 1e-12
    return sys_, ml_sol


@pytest.mark.parametrize("name,scheme", [
    ("backward_euler", lambda tr: tr.backward_euler),
    ("crank_nicolson", lambda tr: tr.crank_nicolson),
    ("theta_0.7", lambda tr: lambda b, e: tr.theta_transient(b, e, 0.7))])
def test_theta_heat_matches_jax(name, scheme):
    got = {}
    for pkg in ("femus_tpu", "femus_tpu_torch"):
        sys_, ml_sol = _heat(pkg, 6, scheme)
        sys_.init_time(0.02)
        _init(pkg, sys_)
        us = []
        for _ in range(3):
            sys_.time_step()
            us.append(np.array(ml_sol.sol[-1]["u"]))
        got[pkg] = (us, sys_.time, np.array(ml_sol.sol_old[-1]["u"]))
    (us_j, t_j, old_j), (us_t, t_t, old_t) = got.values()
    assert t_t == pytest.approx(t_j) == pytest.approx(0.06)
    for a, b in zip(us_t, us_j):
        _close(a, b, 1e-10)
    _close(old_t, old_j, 1e-10)
    # the scheme decays the mode (exp(-2 pi^2 t) = 0.31 at t = 0.06)
    assert 0.2 < np.abs(us_t[-1]).max() < 0.45


def test_gauss2_irk_matches_jax():
    got = {}
    for pkg in ("femus_tpu", "femus_tpu_torch"):
        tr = _mod(pkg, "systems.transient")
        ml_mesh = _mod(pkg, "mesh.multilevel").MultiLevelMesh(
            _mod(pkg, "mesh.generation").unit_box((4, 4), "quad"), 1)
        ml_sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml_mesh)
        ml_sol.add_solution("u", "biquadratic", time_order=1)
        tr.ImplicitRungeKuttaSystem.add_stage_fields(ml_sol, ["u"], 2)
        ml_sol.initialize("u", lambda x: np.sin(PI * x[:, 0])
                          * np.sin(PI * x[:, 1]))
        ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
        ml_sol.generate_bdc()
        prob = _mod(pkg, "systems.problem").MultiLevelProblem(
            ml_mesh, ml_sol, quad_order="fifth")
        sys_ = prob.add_system(tr.ImplicitRungeKuttaSystem, "HeatRK")
        sys_.add_unknown("u@0", "u@1")
        sys_.setup_rk(["u"], 2)
        sys_.set_assembly(tr.irk_form(
            _mod(pkg, "assembly.forms").poisson("u", "biquadratic"),
            {"u": "biquadratic"}, 2))
        sys_.config.outer = "gmres"
        sys_.config.use_mg = False
        sys_.config.rtol = 1e-12
        sys_.config.max_nonlinear = 3
        sys_.init_time(0.025)
        _init(pkg, sys_)
        for _ in range(2):
            sys_.time_step()
        got[pkg] = {k: np.array(ml_sol.sol[-1][k])
                    for k in ("u", "u@0", "u@1")}
    for k in ("u", "u@0", "u@1"):
        _close(got["femus_tpu_torch"][k], got["femus_tpu"][k], 1e-10)
    # the tableau is the JAX package's
    from femus_tpu.systems.transient import gauss_legendre_tableau as jt
    from femus_tpu_torch.systems.transient import \
        gauss_legendre_tableau as tt
    for s in (1, 2, 3):
        for a, b in zip(tt(s), jt(s)):
            np.testing.assert_array_equal(a, b)


def _switching_bc(var, x, grp, t):
    if np.isclose(x[0], 1.0) and t >= 0.05:
        return False, 0.0            # right wall released (natural)
    return True, 0.0


def test_time_switching_bc_mask_matches_jax():
    """A Dirichlet wall that switches to natural at t >= 0.05: each step
    against the JAX package to 1e-10; after the switch the port's cached
    step function is rebuilt against the new mask (the old one would keep
    the wall pinned)."""
    runs = {}
    for pkg in ("femus_tpu", "femus_tpu_torch"):
        sys_, ml_sol = _heat(pkg, 6, lambda tr: tr.backward_euler,
                             bc=_switching_bc)
        sys_.init_time(0.01, time_dependent_bc=True)
        _init(pkg, sys_)
        runs[pkg] = (sys_, ml_sol, [])
    ts = runs["femus_tpu_torch"][0]
    mesh = ts.ml_mesh.finest()
    right = np.isclose(mesh.coords[mesh.dofmap("biquadratic").nodes, 0], 1.0)
    step_fns = []
    for k in range(7):
        for sys_, ml_sol, us in runs.values():
            sys_.time_step()
            us.append(np.array(ml_sol.sol[-1]["u"]))
        step_fns.append(ts._step_fns[0])
        _close(runs["femus_tpu_torch"][2][-1], runs["femus_tpu"][2][-1],
               1e-10)
    us = runs["femus_tpu_torch"][2]
    assert np.abs(us[3][right]).max() == 0.0          # t = 0.04: pinned
    assert np.abs(us[-1][right]).max() > 1e-4         # released
    # the step function is rebuilt exactly once, at the switch (t = 0.05)
    assert len({id(f) for f in step_fns}) == 2
    assert step_fns[3] is not step_fns[4] and step_fns[4] is step_fns[-1]
    assert not ts.masks[0][ts.assemblers[0].offsets["u"]:][right].any()


def test_newmark_step_matches_jax():
    """Newmark-beta (average acceleration) on the wave-like problem
    u_tt - Lap u = 0, two steps, displacement, velocity and acceleration
    fields."""
    got = {}
    for pkg in ("femus_tpu", "femus_tpu_torch"):
        tr = _mod(pkg, "systems.transient")
        ml_mesh = _mod(pkg, "mesh.multilevel").MultiLevelMesh(
            _mod(pkg, "mesh.generation").unit_box((4, 4), "quad"), 1)
        ml_sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml_mesh)
        ml_sol.add_solution("u", "biquadratic", time_order=1)
        ml_sol.add_solution("u_vel", "biquadratic")
        ml_sol.add_solution("u_acc", "biquadratic")
        ml_sol.initialize("u", lambda x: np.sin(PI * x[:, 0])
                          * np.sin(PI * x[:, 1]))
        ml_sol.initialize("u_vel", lambda x: x[:, 0] * (1 - x[:, 0])
                          * x[:, 1] * (1 - x[:, 1]))
        ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
        ml_sol.generate_bdc()
        prob = _mod(pkg, "systems.problem").MultiLevelProblem(
            ml_mesh, ml_sol, quad_order="fifth")
        sys_ = prob.add_system(tr.NewmarkTransientSystem, "Wave")
        sys_.add_unknown("u")
        sys_.setup_newmark(["u"])
        sys_.set_assembly(tr.newmark_form(
            _mod(pkg, "assembly.forms").poisson("u", "biquadratic"),
            {"u": "biquadratic"}))
        sys_.config.outer = "gmres"
        sys_.config.use_mg = False
        sys_.config.rtol = 1e-12
        sys_.config.max_nonlinear = 3
        sys_.init_time(0.05)
        _init(pkg, sys_)
        for _ in range(2):
            sys_.time_step()
        got[pkg] = {k: np.array(ml_sol.sol[-1][k])
                    for k in ("u", "u_vel", "u_acc")}
    for k in ("u", "u_vel", "u_acc"):
        _close(got["femus_tpu_torch"][k], got["femus_tpu"][k], 1e-10)
    assert np.abs(got["femus_tpu_torch"]["u_acc"]).max() > 1.0


BED, V0 = 0.25, 0.5


def transient_fsi(pkg, n=4, levels=2, dt=0.01):
    """The JAX package's transient FSI test set-up: an elastic bed
    (y < 0.25) kicked horizontally (V0 = 0.5) under a quiescent fluid,
    everything clamped, on the solver configuration of the card's
    fsi-bed-transient-64 (interleaved dofs, operator="bell", material
    Vanka, F ratchet, K-cycle FGMRES)."""
    gen = _mod(pkg, "mesh.generation")
    coarse = gen.unit_box((n, n), "quad")
    cent = coarse.coords[coarse.conn].mean(axis=1)
    coarse.elem_group = np.where(cent[:, 1] < BED, 1, 0).astype(np.int32)
    ml_mesh = _mod(pkg, "mesh.multilevel").MultiLevelMesh(coarse, levels)
    ml_sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml_mesh)
    for v in ("dx", "dy", "u", "v"):
        ml_sol.add_solution(v, "biquadratic", time_order=1)
    ml_sol.add_solution("p", "disc_linear")
    ml_sol.attach_bc(lambda var, x, grp, t: (var != "p", 0.0))

    def kick(x):
        return np.where(x[:, 1] < BED, V0 * np.sin(PI * x[:, 0])
                        * np.sin(PI * x[:, 1] / BED), 0.0)

    for v in ("dx", "dy", "v", "p"):
        ml_sol.initialize(v)
    ml_sol.initialize("u", kick)
    ml_sol.generate_bdc()
    ml_sol.fix_solution_at_point("p", 0, 0.0)
    ml_sol.pair_solution("u", "dx")
    ml_sol.pair_solution("v", "dy")
    prob = _mod(pkg, "systems.problem").MultiLevelProblem(
        ml_mesh, ml_sol, quad_order="fifth")
    fsi = _mod(pkg, "systems.fsi")
    sys_ = prob.add_system(fsi.TransientMonolithicFSI, "FSI")
    sys_.solid_groups = (1,)
    sys_.add_unknown("dx", "dy", "u", "v", "p")
    sys_.set_assembly(fsi.fsi_transient_form(
        ("dx", "dy"), ("u", "v"), "p", solid_groups=(1,),
        pres_family="disc_linear", rho_f=1.0, nu=0.05, rho_s=1.0, lam=50.0,
        mu=50.0, solid_model="neo-hookean", theta=1.0))
    cfg = sys_.config
    cfg.operator = "bell"
    cfg.interleave_dofs = True
    cfg.smoother = "vanka"
    cfg.vanka_groups = "material"
    cfg.vanka_block_elems = 2
    cfg.mg_type = "F"
    cfg.mg_cycle = "K"
    cfg.restart = 60
    cfg.max_outer = 10
    cfg.rtol = 1e-10
    cfg.nonlinear_tol = 1e-8
    cfg.max_nonlinear = 8
    sys_.init_time(dt=dt)
    _init(pkg, sys_)
    return sys_, ml_sol


def test_transient_fsi_two_steps_match_jax(tmp_path):
    """Two time steps of transient FSI (n=4, 2 levels) in both packages:
    every field to 1e-8, equal Newton steps; the bed moves.  A checkpoint
    written by the port after step 1 reads back in the JAX package."""
    got = {}
    for pkg in ("femus_tpu", "femus_tpu_torch"):
        sys_, ml_sol = transient_fsi(pkg)
        steps = []
        for k in range(2):
            sys_.time_step()
            steps.append((len(sys_.history), {
                v: np.array(ml_sol.sol[-1][v])
                for v in ("dx", "dy", "u", "v", "p")}))
            if k == 0 and pkg == "femus_tpu_torch":
                ml_sol.save(str(tmp_path / "ckpt"), time=sys_.time)
        got[pkg] = (steps, sys_, ml_sol)
    jsteps, _, jsol = got["femus_tpu"]
    tsteps, ts, tsol = got["femus_tpu_torch"]
    for (nj, fj), (nt, ft) in zip(jsteps, tsteps):
        assert nt == nj
        for v in fj:
            _close(ft[v], fj[v], 1e-8)
    assert all(h["converged"] for h in ts.history)
    # the kicked bed moves, and the old fields are the previous step's
    assert np.abs(tsol.sol[-1]["dx"]).max() > 1e-4
    _close(tsol.sol_old[-1]["u"], tsteps[0][1]["u"], 1e-12)
    # checkpoint: the JAX package reads the port's npz
    t = jsol.load(str(tmp_path / "ckpt"))
    assert t == pytest.approx(0.01)
    for v in ("dx", "u"):
        _close(jsol.sol[-1][v], tsteps[0][1][v], 1e-15)


def test_checkpoint_round_trip(tmp_path):
    """save/load restores every level's fields and old fields."""
    sys_, ml_sol = _heat("femus_tpu_torch", 4, lambda tr: tr.backward_euler)
    sys_.init_time(0.02)
    sys_.init(device="cpu")
    sys_.time_step()
    ml_sol.save(str(tmp_path / "a" / "heat.npz"), time=sys_.time)
    ref = (ml_sol.sol[-1]["u"].copy(), ml_sol.sol_old[-1]["u"].copy())
    ml_sol.sol[-1]["u"][:] = 0.0
    ml_sol.sol_old[-1]["u"][:] = 0.0
    assert ml_sol.load(str(tmp_path / "a" / "heat")) == pytest.approx(0.02)
    np.testing.assert_array_equal(ml_sol.sol[-1]["u"], ref[0])
    np.testing.assert_array_equal(ml_sol.sol_old[-1]["u"], ref[1])


def test_aux_fields_are_read_per_call():
    """A cached step function reads the aux fields of each call: the same
    step object gives the JAX package's step for two different old
    states (carried across with convert)."""
    from femus_tpu_torch import convert

    runs = {}
    for pkg in ("femus_tpu", "femus_tpu_torch"):
        sys_, ml_sol = _heat(pkg, 4, lambda tr: tr.backward_euler)
        sys_.init_time(0.02)
        _init(pkg, sys_)
        runs[pkg] = (sys_, ml_sol)
    js, jsol = runs["femus_tpu"]
    ts, tsol = runs["femus_tpu_torch"]
    step = ts.step_fn(-1)
    rng = np.random.default_rng(2)
    u = js.gather(-1)
    for _ in range(2):
        old = rng.standard_normal(u.size)
        old[js.assemblers[-1].dirichlet_mask] = 0.0
        jsol.sol_old[-1]["u"][:] = old
        convert.state_from_numpy(tsol, jsol.sol, jsol.sol_old)
        ref = js.step_fn(-1)(_xp("femus_tpu").asarray(u),
                             js.assemblers[-1].device_tables_cached(),
                             js._aux_arrays(-1), js._aux_scalars_traced())
        out = step(torch.as_tensor(u), None, ts.aux_scalars)
        assert ts.step_fn(-1) is step
        _close(out.u.numpy(), ref[0], 1e-10)
        aux = convert.aux_fields_from_numpy({"u_old": old}, device="cpu",
                                            dtype=torch.float64)
        _close(step(torch.as_tensor(u), None, ts.aux_scalars,
                    aux).u.numpy(), ref[0], 1e-10)
