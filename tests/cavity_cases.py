"""The lid-driven cavity with rediscretized coarse levels, built alike in
femus_tpu and its PyTorch port, and its parity check; shared by
test_torch_rediscretize.py and test_torch_rediscretize_cavity.py, which
hold one case each so that a parallel run (``--dist loadfile``) gives the
two long cases to two workers.
"""
import importlib

import numpy as np


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def cavity_bc(var, x, grp, t):
    if var == "p":
        return (False, 0.0)
    if var == "u" and abs(x[1] - 1.0) < 1e-9:
        return (True, 1.0)
    return (True, 0.0)


def cavity_system(pkg, operator, levels=3):
    """The lid-driven cavity (Re 100) on unit_box((4, 4)) refined to
    ``levels`` levels, stacked dofs, rediscretized coarse levels,
    multiplicative Vanka (2 elements), GMRES(60) to rtol 1e-8, 4 Newton
    steps from zero."""
    ml_mesh = mod(pkg, "mesh.multilevel").MultiLevelMesh(
        mod(pkg, "mesh.generation").unit_box((4, 4)), levels)
    ml_sol = mod(pkg, "systems.solution").MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.add_solution("v", "biquadratic")
    ml_sol.add_solution("p", "disc_linear")
    for n in "uvp":
        ml_sol.initialize(n)
    ml_sol.attach_bc(cavity_bc)
    for n in "uvp":
        ml_sol.generate_bdc(n)
    ml_sol.fix_solution_at_point("p", 0, 0.0)
    prob = mod(pkg, "systems.problem").MultiLevelProblem(
        ml_mesh, ml_sol, quad_order="fifth")
    s = prob.add_system(mod(pkg, "systems.system").NonLinearImplicitSystem,
                        "NS")
    s.add_unknown("u", "v", "p")
    s.set_assembly(mod(pkg, "assembly.forms").navier_stokes(
        ("u", "v"), "p", pres_family="disc_linear", nu=0.01))
    cfg = s.config
    cfg.operator, cfg.coarse_op, cfg.smoother = operator, "rediscretize", \
        "vanka"
    cfg.rtol, cfg.restart, cfg.max_outer = 1e-8, 60, 10
    cfg.max_nonlinear = 4
    s.init(**({"device": "cpu"} if pkg == "femus_tpu_torch" else {}))
    s.solve()
    return s, ml_sol


def check_cavity_rediscretized(operator):
    """Equal GMRES iterations over the 4 Newton steps, u, v, p to 1e-8;
    on the BELL operator the fine level is routed onto the BELL frame."""
    js, jsol = cavity_system("femus_tpu", operator)
    ts, tsol = cavity_system("femus_tpu_torch", operator)
    assert len(ts.history) == len(js.history) == 4
    for a, b in zip(ts.history, js.history):
        assert a["converged"] and a["lin_iters"] == int(b["lin_iters"])
    for n in "uvp":
        close(tsol.sol[-1][n], jsol.sol[-1][n], 1e-8)
    if operator == "bell":
        assert any(n.get("path") == "bell" and n["n_rows"] == 2946
                   for n in ts.solver_info()["routing"])
