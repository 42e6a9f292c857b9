"""Port parity of the remaining assembly forms and the materials module.

``materials`` is the port's own copy (plain dataclasses): the cases of
tests/test_utils.py, and every property equal to the JAX package's.  The
forms (Boussinesq, the coupled biharmonic, Willmore flow of a graph, shallow
water with a bathymetry aux field, the isopycnal layer stack, tracer
advection) are assembled by both packages in float64 on the host at the
same random state: residuals and ELL data agree to 1e-10 of their size
(only the order of the floating-point sums differs).  A small Boussinesq
Newton solve (unit_box((4,4)), 2 levels, interleaved dofs, Vanka V-cycle on
the BELL frame) has the JAX package's Vanka block tables, takes the same
GMRES iterations and lands within 1e-8, and
three Crank-Nicolson steps of 1-D shallow water agree to 1e-10.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.assembly.bc as jbc
import femus_tpu.assembly.engine as jeng
import femus_tpu.assembly.forms as jforms
import femus_tpu.assembly.sw as jsw
import femus_tpu.materials as jmat
import femus_tpu.mesh.generation as jgen
import femus_tpu_torch.assembly.bc as tbc
import femus_tpu_torch.assembly.engine as teng
import femus_tpu_torch.assembly.forms as tforms
import femus_tpu_torch.assembly.sw as tsw
import femus_tpu_torch.materials as tmat
import femus_tpu_torch.mesh.generation as tgen

pi = np.pi


# ---- materials ---------------------------------------------------------

def test_fluid_reynolds():
    f = tmat.Fluid(parameter=tmat.Parameter(lref=0.1, uref=2.0),
                   density=1000.0, viscosity=0.001)
    assert f.reynolds == pytest.approx(1000.0 * 2.0 * 0.1 / 0.001)
    assert f.ire == pytest.approx(1.0 / f.reynolds)


def test_solid_lame():
    s = tmat.Solid(young_module=210e9, poisson_coeff=0.3, model="Neo-Hookean")
    E, nu = 210e9, 0.3
    assert s.lame_lambda == pytest.approx(E * nu / ((1 + nu) * (1 - 2 * nu)))
    assert s.lame_shear_modulus == pytest.approx(E / (2 * (1 + nu)))
    assert s.physical_model == 1 and not s.penalty
    assert tmat.Solid(poisson_coeff=0.5,
                      model="Saint-Venant").lame_lambda == 1.0e100
    with pytest.raises(ValueError):
        tmat.Solid(model="Bogus")
    with pytest.raises(ValueError):
        tmat.Solid(poisson_coeff=0.5, model="Saint-Venant-Penalty")
    with pytest.raises(ValueError):
        tmat.Solid(poisson_coeff=0.7)


@pytest.mark.parametrize("model", sorted(jmat._SOLID_MODELS))
def test_materials_equal_jax(model):
    assert tmat._SOLID_MODELS == jmat._SOLID_MODELS
    nu = 0.3 if "Penalty" in model else 0.5
    kw = dict(density=7.8, thermal_conductivity=2.0, heat_capacity=3.0,
              thermal_expansion=0.1)
    for pkg, obj in (("solid", lambda m: m.Solid(
            parameter=m.Parameter(lref=0.5, uref=3.0, delta_t_ref=0.1),
            young_module=2.5e3, poisson_coeff=nu, model=model, **kw)),
                     ("fluid", lambda m: m.Fluid(
                         parameter=m.Parameter(lref=0.5, uref=3.0),
                         viscosity=0.02, **kw))):
        a, b = obj(jmat), obj(tmat)
        props = [k for k, v in vars(type(a)).items()
                 if isinstance(v, property)]
        for f in [f.name for f in dataclasses.fields(a)]:
            if f != "parameter":
                assert getattr(a, f) == getattr(b, f), (pkg, f)
        assert vars(a.parameter) == vars(b.parameter)
        for p in props:
            assert getattr(a, p) == getattr(b, p), (pkg, p)
    assert vars(jmat.Gravity((0.0, -9.81, 0.0))) == vars(
        tmat.Gravity((0.0, -9.81, 0.0)))


# ---- forms: residual and Jacobian ----------------------------------------

def _assemble_both(mesh_fn, unknowns, forms, aux=(), quad="fifth", seed=0,
                   bc=lambda var, x, grp, t: (False, 0.0)):
    """Assemble ``forms = (jax form, torch form)`` in both packages at one
    seeded state (and seeded aux fields ``aux`` = ((name, family), ...));
    returns [(jax array, torch array), ...] for R and data."""
    rng = np.random.default_rng(seed)
    aj = jeng.Assembler(mesh_fn(jgen), [jeng.Unknown(*u) for u in unknowns],
                        quad_order=quad, dtype=jnp.float64)
    at = teng.Assembler(mesh_fn(tgen), [teng.Unknown(*u) for u in unknowns],
                        quad_order=quad, dtype=torch.float64, device="cpu")
    aj.set_volume_form(forms[0])
    at.set_volume_form(forms[1])
    fields = {}
    for name, fam in aux:
        aj.add_aux_field(name, fam)
        at.add_aux_field(name, fam)
        fields[name] = rng.uniform(0.1, 0.3, aj.mesh.dofmap(fam).n_dofs)
    jbc.generate_bdc(aj, bc)
    tbc.generate_bdc(at, bc)
    u = 1.0 + 0.2 * rng.standard_normal(aj.n_dofs)
    Rj, Dj = jax.jit(aj.make_assemble_fn())(
        jnp.asarray(u), {k: jnp.asarray(v) for k, v in fields.items()}, {})
    Rt, Dt = at.make_assemble_fn()(
        torch.as_tensor(u), {}, {k: torch.as_tensor(v)
                                 for k, v in fields.items()})
    np.testing.assert_array_equal(aj.pattern.cols, at.pattern.cols)
    return [(np.asarray(Rj)[:aj.n_dofs], Rt.numpy()),
            (np.asarray(Dj), Dt.numpy())]


def _box2(g):
    return g.unit_box((3, 2))


def _edge(g):
    return g.box((6,), [(0.0, 1.0)], "edge")


def _forms(name):
    """(mesh, unknowns, (jax form, torch form), aux fields) of each form."""
    q2 = "biquadratic"
    if name == "boussinesq":
        unk = [("u", q2), ("v", q2), ("p", "disc_linear"), ("T", q2)]
        mk = lambda m: m.boussinesq(("u", "v"), "p", "T",  # noqa: E731
                                    pres_family="disc_linear", ra=1e4,
                                    pr=0.71)
        return _box2, unk, (mk(jforms), mk(tforms)), ()
    if name == "biharmonic_coupled":
        return _box2, [("u", q2), ("v", q2)], (
            jforms.biharmonic_coupled(rhs=lambda x: jnp.sin(pi * x[:, 0])),
            tforms.biharmonic_coupled(rhs=lambda x: torch.sin(pi * x[:, 0]))
        ), ()
    if name == "willmore_graph":
        return _box2, [("u", q2), ("W", q2)], (
            jforms.willmore_graph(c=0.3), tforms.willmore_graph(c=0.3)), ()
    if name == "shallow_water":
        mk = lambda m: m.shallow_water("h", ("u", "v"), g=1.5,  # noqa: E731
                                       nu=0.01, bathymetry_field="b")
        return _box2, [("h", q2), ("u", q2), ("v", q2)], (
            mk(jsw), mk(tsw)), (("b", q2),)
    if name == "shallow_water_layered":
        mk = lambda m: m.shallow_water_layered(  # noqa: E731
            2, g=1.0, rho=[1.0, 1.05], nu=5e-3, kappa=5e-3,
            bathymetry_field="b")
        return _edge, [("h1", q2), ("u1", q2), ("h2", q2), ("u2", q2)], (
            mk(jsw), mk(tsw)), (("b", q2),)
    if name == "tracer_advection":
        mk = lambda m: m.tracer_advection("c", ("u", "v"),  # noqa: E731
                                          kappa=1e-2)
        return _box2, [("c", q2)], (mk(jsw), mk(tsw)), (("u", q2),
                                                         ("v", q2))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["boussinesq", "biharmonic_coupled",
                                  "willmore_graph", "shallow_water",
                                  "shallow_water_layered",
                                  "tracer_advection"])
def test_form_residual_and_jacobian_match_jax(name):
    mesh_fn, unk, forms, aux = _forms(name)
    for ref, out in _assemble_both(mesh_fn, unk, forms, aux):
        scale = np.abs(ref).max()
        assert scale > 0
        np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-10 * scale)


def test_lake_at_rest_residual_vanishes():
    """h + b = const, U = 0: the shallow-water residual is zero up to
    rounding (well-balanced with the discrete bathymetry gradient)."""
    mesh = tgen.unit_box((3, 3))
    a = teng.Assembler(mesh, [teng.Unknown(n) for n in ("h", "u", "v")],
                       dtype=torch.float64, device="cpu")
    a.set_volume_form(tsw.shallow_water("h", ("u", "v"), g=1.0,
                                        bathymetry_field="b"))
    a.add_aux_field("b", "biquadratic")
    x = mesh.coords[mesh.dofmap("biquadratic").nodes]
    b = 0.2 * np.exp(-50 * ((x[:, 0] - 0.5) ** 2 + (x[:, 1] - 0.5) ** 2))
    u = np.zeros(a.n_dofs)
    u[:len(b)] = 1.0 - b
    R, _ = a.make_assemble_fn(with_jacobian=False)(
        torch.as_tensor(u), {}, {"b": torch.as_tensor(b)})
    assert float(R.abs().max()) < 1e-14


# ---- systems ----------------------------------------------------------

def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _heated_cavity_bc(var, x, grp, t):
    if var in ("u", "v"):
        return True, 0.0
    if var == "T":
        if abs(x[0]) < 1e-9:
            return True, 0.5                # hot left wall
        if abs(x[0] - 1.0) < 1e-9:
            return True, -0.5               # cold right wall
        return False, 0.0                   # insulated top/bottom
    return False, 0.0


def _boussinesq_system(pkg):
    """The de Vahl Davis cavity (Ra = 1e4, Pr = 0.71) on unit_box((4,4)),
    2 levels, RCM, interleaved u, v, p, T (Q2, Q2, P1dc, Q2), Vanka V-cycle
    GMRES on the BELL frame."""
    ml_mesh = _mod(pkg, "mesh.multilevel").MultiLevelMesh(
        _mod(pkg, "mesh.generation").unit_box((4, 4)), 2)
    _mod(pkg, "mesh.reorder").rcm_reorder_hierarchy(ml_mesh)
    ml_sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml_mesh)
    for n in ("u", "v", "T"):
        ml_sol.add_solution(n, "biquadratic")
    ml_sol.add_solution("p", "disc_linear")
    for n in ("u", "v", "p", "T"):
        ml_sol.initialize(n)
    ml_sol.attach_bc(_heated_cavity_bc)
    ml_sol.generate_bdc("u", "v", "p", "T")
    ml_sol.fix_solution_at_point("p", 0, 0.0)
    prob = _mod(pkg, "systems.problem").MultiLevelProblem(
        ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(_mod(pkg, "systems.system").NonLinearImplicitSystem,
                           "Boussinesq")
    sys_.add_unknown("u", "v", "p", "T")
    sys_.set_assembly(_mod(pkg, "assembly.forms").boussinesq(
        ("u", "v"), "p", "T", pres_family="disc_linear", ra=1e4, pr=0.71))
    cfg = sys_.config
    cfg.operator = "bell"
    cfg.interleave_dofs = True
    cfg.smoother = "vanka"
    cfg.rtol = 1e-10
    cfg.restart = 60
    cfg.max_nonlinear = 4
    return sys_, ml_sol


def test_boussinesq_newton_matches_jax():
    from femus_tpu.algebra.vanka import build_element_blocks as jbeb
    from femus_tpu_torch.algebra.vanka import build_element_blocks as tbeb

    js, jsol = _boussinesq_system("femus_tpu")
    js.init()
    ts, tsol = _boussinesq_system("femus_tpu_torch")
    ts.init(device="cpu")
    # the Vanka blocks of four interleaved unknowns (u, v, p, T) equal
    jb = jbeb(js.assemblers[-1], 2)
    tb = tbeb(ts.assemblers[-1], 2, device="cpu")
    assert tb.n_colors == jb.n_colors and tb.n == jb.n
    for a, b in zip(tb.color_dofs + tb.color_slots,
                    jb.color_dofs + jb.color_slots):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tb.scale.numpy(), np.asarray(jb.scale))
    js.solve()
    ts.solve()
    assert len(ts.history) == len(js.history) == 4
    assert ([h["lin_iters"] for h in ts.history]
            == [int(h["lin_iters"]) for h in js.history])
    assert all(h["converged"] for h in ts.history)
    for n in ("u", "v", "p", "T"):
        ref = jsol.sol[-1][n]
        np.testing.assert_allclose(tsol.sol[-1][n], ref, rtol=1e-8,
                                   atol=1e-8 * np.abs(ref).max())
    # a clockwise roll: the fluid rises near the hot wall
    assert np.abs(tsol.sol[-1]["v"]).max() > 1e-3


def _sw_1d(pkg, n=12):
    """tests/test_sw.py's 1-D single-layer seiche over a bump: walls u = 0,
    bathymetry aux field, Crank-Nicolson, dt 0.01, GMRES to 1e-12."""
    ml_mesh = _mod(pkg, "mesh.multilevel").MultiLevelMesh(
        _mod(pkg, "mesh.generation").box((n,), [(0.0, 1.0)], "edge"), 1)
    ml_sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("h", "biquadratic", time_order=1)
    ml_sol.add_solution("u", "biquadratic", time_order=1)
    ml_sol.add_solution("b", "biquadratic")
    ml_sol.initialize("h", lambda x: 1.0 + 1e-2 * np.cos(np.pi * x[:, 0]))
    ml_sol.initialize("u")
    ml_sol.initialize("b", lambda x: 0.2 * np.exp(-50 * (x[:, 0] - 0.5) ** 2))
    ml_sol.attach_bc(lambda var, x, grp, t: (var == "u", 0.0))
    ml_sol.generate_bdc("h", "u")
    prob = _mod(pkg, "systems.problem").MultiLevelProblem(
        ml_mesh, ml_sol, quad_order="fifth")
    tr = _mod(pkg, "systems.transient")
    sys_ = prob.add_system(tr.TransientNonlinearImplicitSystem, "SW")
    sys_.add_unknown("h", "u")
    sys_.add_aux_field("b")
    base = _mod(pkg, "assembly.sw").shallow_water(
        "h", ("u",), "biquadratic", g=1.0, bathymetry_field="b")
    sys_.set_assembly(tr.crank_nicolson(base, {"h": "biquadratic",
                                               "u": "biquadratic"}))
    cfg = sys_.config
    cfg.outer = "gmres"
    cfg.use_mg = False
    cfg.rtol = 1e-12
    cfg.max_nonlinear = 6
    return sys_, ml_sol


def test_sw_crank_nicolson_steps_match_jax():
    out = {}
    for pkg in ("femus_tpu", "femus_tpu_torch"):
        sys_, ml_sol = _sw_1d(pkg)
        sys_.init_time(0.01)
        sys_.init(**({"device": "cpu"} if pkg == "femus_tpu_torch" else {}))
        for _ in range(3):
            sys_.time_step()
        out[pkg] = {n: ml_sol.sol[-1][n].copy() for n in ("h", "u")}
    for n in ("h", "u"):
        ref = out["femus_tpu"][n]
        assert np.abs(ref).max() > 1e-4
        np.testing.assert_allclose(out["femus_tpu_torch"][n], ref,
                                   rtol=1e-10, atol=1e-10 * np.abs(ref).max())
