"""Port parity: PDE-constrained optimal control against femus_tpu, in
float64 on the host.

The systems of tests/test_optimal_control.py, tests/test_boundary_control.py
and tests/test_theta_constraint.py on generated boxes, with the card's
solver (RCM hierarchy, operator="bell", stacked dofs, Vanka V-cycle
GMRES(60)) at rtol 1e-10: the KKT residual and Jacobian agree to 1e-12,
solutions to 1e-8, ``cost_functional`` to 1e-10, the PDAS active counts
per iteration are equal, and so are the boundary-control masks; the
bordered theta solve agrees to 1e-8 and its constraint vector to 1e-12.
The mask-editing functions raise on an interleaved system.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.systems.optimal_control as joc
import femus_tpu_torch.systems.optimal_control as toc
from femus_tpu.systems.system import NonLinearImplicitSystem as JNonLinear

PI = np.pi
ALPHA = 1e-3
CTRL_GROUP = 2          # the x = 1 face of a generated box


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _xp(pkg):
    return torch if pkg == "femus_tpu_torch" else jnp


def _y_d(pkg, skew=False):
    xp = _xp(pkg)
    if skew:      # tests/test_theta_constraint.py: a nonzero-mean control
        return lambda x: (xp.sin(PI * x[:, 0]) * xp.sin(PI * x[:, 1])
                          + x[:, 0] * x[:, 1])
    return lambda x: xp.sin(PI * x[:, 0]) * xp.sin(PI * x[:, 1])


class _RecordingNonLinear(JNonLinear):
    """Records the PDAS active counts after every KKT solve of the JAX
    package's PDAS loop (which reports only the last ones)."""

    def solve(self):
        out = super().solve()
        p = getattr(self, "_pdas", None)
        if p is None:                      # a plain KKT solve
            return out
        sol = self.ml_sol.sol[-1]
        mu = sol[p["adj"]] - p["alpha"] * sol[p["ctrl"]]
        u = sol[p["ctrl"]]
        self.pdas_counts.append(
            (int((mu + p["c"] * (u - p["ub"]) > 0).sum()),
             int((mu + p["c"] * (u - p["ua"]) < 0).sum())))
        return out


class _JPDAS(joc.PDASControlSystem, _RecordingNonLinear):
    pdas_counts: list


def _control_system(pkg, kind, coarse, levels, interleave=False,
                    rtol=1e-10):
    """kind: "distributed" (PDAS system), "boundary" (Neumann control on
    x = 1, interior control fixed), "theta" (bordered zero-mean control,
    one level, Jacobi GMRES as tests/test_theta_constraint.py)."""
    oc = _mod(pkg, "systems.optimal_control")
    ml = _mod(pkg, "mesh.multilevel").MultiLevelMesh(
        _mod(pkg, "mesh.generation").unit_box((coarse, coarse)), levels)
    if kind != "theta":
        _mod(pkg, "mesh.reorder").rcm_reorder_hierarchy(ml)
    sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml)
    for v in ("y", "l", "u"):
        sol.add_solution(v, "biquadratic")
        sol.initialize(v)
    if kind == "boundary":
        sol.attach_bc(lambda var, x, grp, t: (
            (grp != CTRL_GROUP) if var in ("y", "l") else False, 0.0))
    else:
        sol.attach_bc(lambda var, x, grp, t: (var in ("y", "l"), 0.0))
    sol.generate_bdc("y", "l", "u")
    prob = _mod(pkg, "systems.problem").MultiLevelProblem(
        ml, sol, quad_order="fifth")
    if kind == "distributed":
        cls = _JPDAS if pkg == "femus_tpu" else oc.PDASControlSystem
    elif kind == "theta":
        cls = oc.ScalarConstrainedSystem
    else:
        cls = _mod(pkg, "systems.system").NonLinearImplicitSystem
    s = prob.add_system(cls, "OC")
    s.add_unknown("y", "l", "u")
    if kind == "boundary":
        s.set_assembly(*oc.boundary_control_forms(
            y_target=_y_d(pkg), alpha=1e-2, control_groups=(CTRL_GROUP,)))
    else:
        alpha = 1e-2 if kind == "theta" else ALPHA
        s.set_assembly(oc.elliptic_control_form(
            "y", "l", "u", y_target=_y_d(pkg, kind == "theta"), alpha=alpha))
    cfg = s.config
    if kind == "theta":
        cfg.rtol = 1e-12
        cfg.use_mg = False
        cfg.smoother = "jacobi"
    else:
        cfg.operator = "bell"
        cfg.interleave_dofs = interleave
        cfg.smoother = "vanka"
        cfg.vanka_block_elems = 2
        cfg.restart = 60
        cfg.max_outer = 10
        cfg.rtol = rtol
        cfg.max_nonlinear = 1
    if pkg == "femus_tpu_torch":
        s.init(device="cpu")
    else:
        s.init()
    if kind == "distributed":
        s.pdas_counts = []
    return s, sol


def _fields(sol):
    return np.concatenate([sol.sol[-1][v] for v in ("y", "l", "u")])


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["distributed", "boundary"])
def test_kkt_residual_and_jacobian_match_jax(kind):
    out = {}
    for pkg in ("femus_tpu", "femus_tpu_torch"):
        s, _ = _control_system(pkg, kind, 4, 1)
        a = s.assemblers[-1]
        u = np.random.default_rng(0).standard_normal(a.n_dofs)
        if pkg == "femus_tpu":
            R, data = a.make_assemble_fn()(jnp.asarray(u))
        else:
            R, data = a.make_assemble_fn()(torch.as_tensor(u))
        out[pkg] = (np.asarray(R), np.asarray(data))
    for k in range(2):
        _close(out["femus_tpu_torch"][k], out["femus_tpu"][k], 1e-12)


@pytest.fixture(scope="module")
def unconstrained():
    """The distributed-control KKT solve on unit_box((8,8)), 2 levels
    (3,267 dofs: the fine level runs on the BELL frame's operator)."""
    out = {}
    for pkg in ("femus_tpu", "femus_tpu_torch"):
        s, sol = _control_system(pkg, "distributed", 8, 2)
        info = s.solve()
        J = _mod(pkg, "systems.optimal_control").cost_functional(
            s.ml_mesh.finest(), "biquadratic", sol.sol[-1]["y"],
            sol.sol[-1]["u"], _y_d(pkg), ALPHA,
            **({"device": "cpu"} if pkg == "femus_tpu_torch" else {}))
        out[pkg] = (s, sol, info, J)
    return out


def test_unconstrained_solve_matches_jax(unconstrained):
    (js, jsol, jinfo, jJ), (ts, tsol, tinfo, tJ) = (
        unconstrained["femus_tpu"], unconstrained["femus_tpu_torch"])
    assert any(n.get("path") == "bell" for n in ts.solver_info()["routing"])
    assert tinfo["converged"] and tinfo["lin_iters"] == jinfo["lin_iters"]
    _close(_fields(tsol), _fields(jsol), 1e-8)
    assert isinstance(tJ, float)
    np.testing.assert_allclose(tJ, jJ, rtol=1e-10)
    sol = tsol.sol[-1]
    # the gradient equation alpha u = l, as tests/test_optimal_control.py
    assert np.abs(ALPHA * sol["u"] - sol["l"]).max() < 1e-6


def test_pdas_active_sets_match_jax():
    """solve_pdas(max_iters=3) from zero at coarse 4, 2 levels, bounds
    (0.5, 8.0): equal active counts after every KKT solve, equal fields."""
    out = {}
    for pkg in ("femus_tpu", "femus_tpu_torch"):
        s, sol = _control_system(pkg, "distributed", 4, 2)
        s.set_control_bounds("u", 0.5, 8.0, alpha=ALPHA)
        info = s.solve_pdas(max_iters=3)
        out[pkg] = (s, sol, info)
    (js, jsol, jinfo), (ts, tsol, tinfo) = (out["femus_tpu"],
                                            out["femus_tpu_torch"])
    counts = [(h["active_hi"], h["active_lo"]) for h in ts.pdas_history]
    assert counts == js.pdas_counts and len(counts) == 3
    for key in ("pdas_iters", "active_hi", "active_lo"):
        assert tinfo[key] == jinfo[key]
    assert all(c for it in ts.pdas_history for _, c in it["linear_solves"])
    _close(_fields(tsol), _fields(jsol), 1e-8)
    u = tsol.sol[-1]["u"]
    assert u.min() >= 0.5 - 1e-8 and u.max() <= 8.0 + 1e-8
    # the mask change reached the cached step; the hierarchy's masks did not
    a = ts.assemblers[-1]
    assert a.dirichlet_mask.sum() > ts.masks[-1].sum()


def test_boundary_control_matches_jax():
    out = {}
    for pkg in ("femus_tpu", "femus_tpu_torch"):
        s, sol = _control_system(pkg, "boundary", 4, 2)
        getattr(_mod(pkg, "systems.optimal_control"),
                "fix_interior_control")(s, "u", (CTRL_GROUP,))
        masks = [np.asarray(a.dirichlet_mask)[:a.n_dofs].copy()
                 for a in s.assemblers]
        info = s.solve()
        out[pkg] = (s, sol, masks, info)
    (js, jsol, jm, jinfo), (ts, tsol, tm, tinfo) = (out["femus_tpu"],
                                                    out["femus_tpu_torch"])
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)
    assert tinfo["converged"] and tinfo["lin_iters"] == jinfo["lin_iters"]
    _close(_fields(tsol), _fields(jsol), 1e-8)
    # the control lives on the control boundary only: its eliminated
    # (identity) rows take corrections at the linear solve's 1e-10 level
    mesh = ts.ml_mesh.finest()
    xy = mesh.coords[ts.assemblers[-1].dofmaps["u"].nodes]
    on_gc = np.abs(xy[:, 0] - 1.0) < 1e-12
    uc = tsol.sol[-1]["u"]
    assert np.abs(uc).max() > 1e-3
    assert np.abs(uc[~on_gc]).max() < 1e-8 * np.abs(uc).max()


def _mean_functional(pkg):
    """The zero-mean control functional (integral of u) as a volume form."""
    def vol(ops, u, aux):
        return {"u": ops.t("biquadratic",
                           ops.pointwise(lambda x: 1.0 + 0.0 * x[:, 0]))}
    return vol


def test_scalar_constrained_system_matches_jax():
    out = {}
    for pkg in ("femus_tpu", "femus_tpu_torch"):
        s, sol = _control_system(pkg, "theta", 6, 1)
        oc = _mod(pkg, "systems.optimal_control")
        B = oc.assemble_constraint_vector(s, volume_form=_mean_functional(pkg))
        s.add_scalar_constraint("theta", B, rhs=0.0)
        info = s.solve()
        out[pkg] = (s, sol, B, info)
    (js, jsol, jB, jinfo), (ts, tsol, tB, tinfo) = (out["femus_tpu"],
                                                    out["femus_tpu_torch"])
    assert isinstance(tB, np.ndarray) and tB.shape == (ts.assemblers[0].n_dofs,)
    _close(tB, np.asarray(jB)[:tB.shape[0]], 1e-12)
    np.testing.assert_allclose(ts.get_theta_value(), js.get_theta_value(),
                               rtol=0, atol=1e-8)
    assert abs(ts.get_theta_value()) > 1e-6
    _close(_fields(tsol), _fields(jsol), 1e-8)
    x = ts.gather(0)
    assert abs(tB @ x) < 1e-9
    assert tinfo["newton_it"] == jinfo["newton_it"]


def test_control_mask_edits_raise_when_interleaved():
    """The JAX package's answer on an interleaved system is NaN or a wrong
    mask (ROADMAP C); the port refuses."""
    s, _ = _control_system("femus_tpu_torch", "distributed", 2, 1,
                           interleave=True)
    s.set_control_bounds("u", 0.5, 8.0, alpha=ALPHA)
    with pytest.raises(ValueError, match="interleave_dofs=False"):
        toc.fix_interior_control(s, "u", (CTRL_GROUP,))
    with pytest.raises(ValueError, match="interleave_dofs=False"):
        s.solve_pdas(max_iters=1)
    with pytest.raises(ValueError, match="interleave_dofs=False"):
        toc.assemble_constraint_vector(
            s, volume_form=_mean_functional("femus_tpu_torch"))
