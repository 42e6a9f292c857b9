"""Port parity: boundary-face assembly, face forms, and the extra
right-hand sides of the solve step, against femus_tpu, in float64 on the
host.

- ``face_trace_nodes`` and the face tables (face dofs, slots, groups,
  coordinates, the volume trial tabulations) are equal, in the stacked
  and the interleaved layout;
- ``FaceOps``/``VolumeFaceOps`` give the same points, normals, weights
  and face sizes to 1e-13;
- the Neumann setups of tests/test_poisson.py and a ``nitsche_dirichlet``
  Poisson problem give the same R and Jacobian to 1e-12 and the same
  solution to 1e-8; the face Jacobian of a nonlinear face form matches a
  central difference of R;
- a 2-level System solve with a face form agrees in both layouts;
- ``extra_rhs`` columns D = A^{-1} B agree to 1e-8 on the multigrid route
  and on the coarse-direct route.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.assembly.bc as jbc
import femus_tpu.assembly.engine as jeng
import femus_tpu.assembly.forms as jforms
import femus_tpu.fe.tabulate as jtab
import femus_tpu_torch.algebra.krylov as tkry
import femus_tpu_torch.assembly.bc as tbc
import femus_tpu_torch.assembly.engine as teng
import femus_tpu_torch.assembly.forms as tforms
import femus_tpu_torch.fe.tabulate as ttab
from femus_tpu.mesh.generation import unit_box as junit_box
from femus_tpu_torch.fe.geom import GEOMS
from femus_tpu_torch.mesh.generation import unit_box as tunit_box

PI = np.pi
PKGS = {"jax": (jeng, jforms, jbc, junit_box, jnp),
        "torch": (teng, tforms, tbc, tunit_box, torch)}


def _assemble(pkg, a, u):
    """(R, ELL data) of an assembler at the numpy state ``u``, as numpy."""
    if pkg == "jax":
        R, data = jax.jit(a.make_assemble_fn())(jnp.asarray(u))
    else:
        R, data = a.make_assemble_fn()(torch.as_tensor(u))
    return np.asarray(R), np.asarray(data)


def _kw(pkg):
    return {"device": "cpu"} if pkg == "torch" else {}


@pytest.mark.parametrize("geom", ["edge", "quad", "tri", "hex", "tet",
                                  "wedge"])
def test_face_trace_nodes_equal(geom):
    g = GEOMS[geom]
    for fam in g.family_nodes:
        for iface in range(len(g.faces)):
            fj, lj = jtab.face_trace_nodes(geom, fam, iface)
            ft, lt = ttab.face_trace_nodes(geom, fam, iface)
            assert fj == ft
            np.testing.assert_array_equal(lj, lt)


def _flux_face(pkg, var, groups):
    """A nonlinear face form on ``groups``: r = t(u^3 + x0) there (the
    Jacobian is state-dependent, so a central difference tests it)."""
    def form(fops, u, fams, grp, aux):
        uq = fops.value(fams[var], u[var])
        sel = sum((grp == g) * 1.0 for g in groups)
        return {var: fops.t(fams[var], (uq ** 3 + fops.x[:, 0]) * sel)}
    return form


def _stokes_like(pkg, interleave, volume=False, mesh=None):
    """u, v Q2 and p Q1 on unit_box((3,3)) with a face form on groups 2
    and 4 (plain, or the Nitsche form on u as a volume face form)."""
    eng, forms, bc, ub, xp = PKGS[pkg]
    a = eng.Assembler(mesh if mesh is not None else ub((3, 3), "quad"),
                      [eng.Unknown("u"), eng.Unknown("v"),
                       eng.Unknown("p", "linear")], quad_order="fifth",
                      interleave=interleave, **_kw(pkg))
    a.set_volume_form(forms.navier_stokes(("u", "v"), "p", nu=0.1))
    if volume:
        a.set_face_form(forms.nitsche_dirichlet("u", groups=(2, 4)),
                        volume=True)
    else:
        a.set_face_form(_flux_face(pkg, "v", (2, 4)))
    return a


@pytest.mark.parametrize("interleave", [False, True])
@pytest.mark.parametrize("volume", [False, True])
def test_face_tables_equal(interleave, volume):
    ja = _stokes_like("jax", interleave, volume)
    ta = _stokes_like("torch", interleave, volume)
    assert len(ja.face_batches) == len(ta.face_batches) == 4
    tt = ta.device_tables()["faces"]
    for bj, bt, ft in zip(ja.face_batches, ta.face_batches, tt):
        assert (bj["fgeom"], bj["iface"], bj["fams"], bj["ndf"]) == \
            (bt["fgeom"], bt["iface"], bt["fams"], bt["ndf"])
        np.testing.assert_array_equal(bj["fdofs"], bt["fdofs"])
        np.testing.assert_array_equal(np.asarray(bj["groups"]), bt["groups"])
        np.testing.assert_array_equal(np.asarray(bj["coords"]), bt["coords"])
        np.testing.assert_array_equal(ja._face_slots(bj), ta._face_slots(bt))
        np.testing.assert_array_equal(ta._face_slots(bt).reshape(-1),
                                      ft["slots"].numpy())
        for f, (p, d) in bj["tabs"].items():
            np.testing.assert_array_equal(np.asarray(p), bt["tabs"][f][0])
            np.testing.assert_array_equal(np.asarray(d), bt["tabs"][f][1])
        if volume:
            np.testing.assert_array_equal(bj["eidx"], bt["eidx"])
            np.testing.assert_array_equal(np.asarray(bj["ecoords"]),
                                          bt["ecoords"])
            for f, (p, d) in bj["vtabs"].items():
                np.testing.assert_allclose(bt["vtabs"][f][0], p, atol=1e-15)
                np.testing.assert_allclose(bt["vtabs"][f][1], d, atol=1e-15)


def _warped(ub):
    """unit_box((3,3)) sheared and bent: no face is axis-aligned."""
    m = ub((3, 3), "quad")
    x, y = m.coords[:, 0], m.coords[:, 1]
    m.coords = np.column_stack([x + 0.3 * y + 0.05 * np.sin(PI * y),
                                1.2 * y + 0.1 * x * x])
    return m


@pytest.mark.parametrize("warped", [False, True])
def test_face_ops_match(warped):
    """FaceOps/VolumeFaceOps geometry per face: x, normal, wds and h to
    1e-13 (on a warped mesh too), and on the unit box the volume trial
    space's value, gradient and normal derivative."""
    mesh = {p: (_warped(PKGS[p][3]) if warped else PKGS[p][3]((3, 3)))
            for p in PKGS}
    ja = _stokes_like("jax", False, True, mesh["jax"])
    ta = _stokes_like("torch", False, True, mesh["torch"])
    tt = ta.device_tables()["faces"]
    ue = np.random.default_rng(2).standard_normal(ta.ndt)
    for bj, ft in zip(ja.face_batches, tt):
        def jone(ecl, fcl):
            f = jeng.VolumeFaceOps(bj["vtabs"], bj["tabs"], bj["weights"],
                                   ecl, fcl, 2, 1.0)
            p = jeng.FaceOps(bj["tabs"], bj["weights"], fcl, 2, 1.0)
            uu = jnp.asarray(ue[:9])
            return (f.x, f.normal, f.wds, f.h, p.x, p.normal, p.wds,
                    f.value("biquadratic", uu), f.grad("biquadratic", uu),
                    f.dn("biquadratic", uu), f.tn("biquadratic", f.wds))

        def tone(ecl, fcl):
            f = teng.VolumeFaceOps(ft["vtabs"], ft["tabs"], ft["weights"],
                                   ecl, fcl, 2, 1.0)
            p = teng.FaceOps(ft["tabs"], ft["weights"], fcl, 2, 1.0)
            uu = torch.as_tensor(ue[:9])
            return (f.x, f.normal, f.wds, f.h, p.x, p.normal, p.wds,
                    f.value("biquadratic", uu), f.grad("biquadratic", uu),
                    f.dn("biquadratic", uu), f.tn("biquadratic", f.wds))

        rj = jax.vmap(jone)(bj["ecoords"], bj["coords"])
        rt = torch.func.vmap(tone)(ft["ecoords"], ft["coords"])
        # the trial-space gradient is compared on the unit box only: the
        # JAX VolumeFaceOps contracts with the transposed inverse Jacobian
        # (ROADMAP C), equal there because every element map is diagonal
        for k in range(8):
            np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                       rtol=0, atol=1e-13)
        if not warped:
            for k in range(8, 11):
                np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                           rtol=0, atol=1e-12)


def test_volume_face_gradient_is_exact_on_warped_mesh():
    """The port's VolumeFaceOps gradient of u = x on a sheared, bent mesh
    is (1, 0) at every face quadrature point."""
    mesh = _warped(tunit_box)
    a = teng.Assembler(mesh, [teng.Unknown("u")], quad_order="fifth",
                       device="cpu")
    a.set_volume_form(lambda ops, u, aux: {})
    a.set_face_form(lambda fops, u, grp, aux: {"u": u["u"] * 0.0},
                    volume=True)
    x = mesh.coords[a.dofmaps["u"].nodes][:, 0]
    for ft in a.device_tables()["faces"]:
        ue = torch.as_tensor(x)[ft["eidx"]]

        def grad(ecl, fcl, ul):
            f = teng.VolumeFaceOps(ft["vtabs"], ft["tabs"], ft["weights"],
                                   ecl, fcl, 2, 1.0)
            return f.grad("biquadratic", ul)

        g = torch.func.vmap(grad)(ft["ecoords"], ft["coords"], ue)
        np.testing.assert_allclose(g[..., 0].numpy(), 1.0, atol=1e-12)
        np.testing.assert_allclose(g[..., 1].numpy(), 0.0, atol=1e-12)


@pytest.mark.parametrize("interleave", [False, True])
@pytest.mark.parametrize("volume", [False, True])
def test_face_assembly_matches_jax(interleave, volume):
    """R and the Jacobian with a face form (the nonlinear flux form, or
    the Nitsche form) at a seeded state, in both layouts."""
    ja = _stokes_like("jax", interleave, volume)
    ta = _stokes_like("torch", interleave, volume)
    u = np.random.default_rng(1).standard_normal(ta.n_dofs)
    Rj, dj = _assemble("jax", ja, u)
    Rt, dt = _assemble("torch", ta, u)
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-12 * np.abs(Rj).max())
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-12 * np.abs(dj).max())


def _ell_matvec(a, data, v):
    return (data * v[a.pattern.cols]).sum(axis=-1)


@pytest.mark.parametrize("volume", [False, True])
def test_face_jacobian_matches_central_difference(volume):
    """J v against (R(u + h v) - R(u - h v)) / 2h on the port's assembly
    (faces included, no Dirichlet rows)."""
    ta = _stokes_like("torch", True, volume)
    rng = np.random.default_rng(4)
    u, v = rng.standard_normal(ta.n_dofs), rng.standard_normal(ta.n_dofs)
    _, data = _assemble("torch", ta, u)
    h = 1e-6
    fd = (_assemble("torch", ta, u + h * v)[0]
          - _assemble("torch", ta, u - h * v)[0]) / (2 * h)
    jv = _ell_matvec(ta, data, v)
    np.testing.assert_allclose(jv, fd, rtol=0, atol=1e-7 * np.abs(jv).max())


def _poisson_neumann(pkg, n=3):
    """tests/test_poisson.py inhomogeneous Neumann setup: u = x^2 + y^2,
    Dirichlet on three sides, du/dn = 2 on x = 1 through a face form."""
    eng, forms, bc, ub, xp = PKGS[pkg]
    a = eng.Assembler(ub((n, n), "quad"), [eng.Unknown("u")],
                      quad_order="fifth", **_kw(pkg))
    a.set_volume_form(forms.poisson("u", rhs=lambda x: -4.0 + 0.0 * x[:, 0]))
    a.set_face_form(forms.neumann_faces(
        {2: lambda x, nrm: 2.0 + 0.0 * x[:, 0]}, "u"))
    bc.generate_bdc(a, lambda var, x, grp, t: (
        (False, 0.0) if grp == 2 else (True, float(x[0] ** 2 + x[1] ** 2))))
    return a


def _poisson_homogeneous_neumann(pkg, n=4):
    """tests/test_poisson.py natural-BC setup: u = cos(pi x) cos(pi y),
    Dirichlet on the y sides, homogeneous Neumann on the x sides."""
    eng, forms, bc, ub, xp = PKGS[pkg]

    def exact(x):
        return xp.cos(PI * x[:, 0]) * xp.cos(PI * x[:, 1])

    a = eng.Assembler(ub((n, n), "quad"), [eng.Unknown("u")],
                      quad_order="fifth", **_kw(pkg))
    a.set_volume_form(forms.poisson("u", rhs=lambda x: 2 * PI ** 2
                                    * exact(x)))

    def bcf(var, x, grp, t):
        if grp in (3, 4):
            return True, float(np.cos(PI * x[0]) * np.cos(PI * x[1]))
        return False, 0.0

    bc.generate_bdc(a, bcf)
    return a


def _poisson_nitsche(pkg, n=3):
    """-Lap u = 2 pi^2 sin(pi x) sin(pi y) + 0 with u = sin sin + x y
    imposed weakly on the whole boundary by Nitsche's method."""
    eng, forms, bc, ub, xp = PKGS[pkg]

    def exact(x):
        return xp.sin(PI * x[:, 0]) * xp.sin(PI * x[:, 1]) + x[:, 0] * x[:, 1]

    a = eng.Assembler(ub((n, n), "quad"), [eng.Unknown("u")],
                      quad_order="fifth", **_kw(pkg))
    a.set_volume_form(forms.poisson(
        "u", rhs=lambda x: 2 * PI ** 2 * xp.sin(PI * x[:, 0])
        * xp.sin(PI * x[:, 1])))
    a.set_face_form(forms.nitsche_dirichlet("u", g_fn=exact, gamma=20.0),
                    volume=True)
    return a


@pytest.mark.parametrize("setup", [_poisson_neumann,
                                   _poisson_homogeneous_neumann,
                                   _poisson_nitsche])
def test_poisson_face_setups_match_jax(setup):
    """R and J at the lifted zero state to 1e-12, and the solution (one
    Jacobi-CG solve to 1e-13 in each package) to 1e-8."""
    sol = {}
    for pkg in PKGS:
        a = setup(pkg)
        bc = PKGS[pkg][2]
        u0 = bc.apply_dirichlet_values(a, np.zeros(a.n_dofs))
        R, data = _assemble(pkg, a, u0)
        sol[pkg] = (R, data)
        Rt = torch.as_tensor(R)
        A = teng.SparseOp(torch.as_tensor(data),
                          torch.as_tensor(a.pattern.cols, dtype=torch.int64),
                          a.pattern.n_cols)
        d = A.diagonal()
        x, info = tkry.cg(A.matvec, -Rt, M=lambda r: r / d, tol=1e-13,
                          maxiter=2000)
        assert info.converged
        sol[pkg] += (u0 + x.numpy(),)
    (Rj, dj, uj), (Rt, dt, ut) = sol["jax"], sol["torch"]
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-12 * np.abs(Rj).max())
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-12 * np.abs(dj).max())
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8 * np.abs(uj).max())
    if setup is _poisson_neumann:
        # a quadratic solution is reproduced exactly
        a = setup("torch")
        xy = a.mesh.coords[a.dofmaps["u"].nodes]
        np.testing.assert_allclose(ut, (xy ** 2).sum(axis=1), atol=1e-9)


def _face_system(pkg, interleave):
    """A 2-level system of two coupled Poisson fields (u, w) with
    Neumann fluxes through a face form: u on x = 1, w on y = 1."""
    def mod(name):
        return importlib.import_module(
            f"{'femus_tpu' if pkg == 'jax' else 'femus_tpu_torch'}.{name}")

    xp = PKGS[pkg][4]
    ml = mod("mesh.multilevel").MultiLevelMesh(
        mod("mesh.generation").unit_box((3, 3)), 2)
    sol = mod("systems.solution").MultiLevelSolution(ml)
    for v in ("u", "w"):
        sol.add_solution(v, "biquadratic")
        sol.initialize(v)
    sol.attach_bc(lambda var, x, grp, t: (grp in (1, 3), 0.0))
    sol.generate_bdc("u", "w")
    prob = mod("systems.problem").MultiLevelProblem(ml, sol,
                                                    quad_order="fifth")
    s = prob.add_system(mod("systems.system").LinearImplicitSystem, "UW")
    s.add_unknown("u", "w")

    def vol(ops, u, aux):
        fu, fw = (ops.grad("biquadratic", u[k]) for k in ("u", "w"))
        uq, wq = (ops.value("biquadratic", u[k]) for k in ("u", "w"))
        return {"u": ops.tgrad("biquadratic", fu)
                + ops.t("biquadratic", 0.5 * wq - 1.0),
                "w": ops.tgrad("biquadratic", fw)
                + ops.t("biquadratic", 0.5 * uq)}

    def face(fops, u, fams, grp, aux):
        one = 1.0 + 0.0 * fops.x[:, 0]
        return {"u": -fops.t(fams["u"], one * ((grp == 2) * 1.0)),
                "w": -fops.t(fams["w"], xp.sin(PI * fops.x[:, 0])
                             * ((grp == 4) * 1.0))}

    s.set_assembly(vol, face)
    cfg = s.config
    cfg.interleave_dofs = interleave
    cfg.smoother = "vanka"
    cfg.rtol = 1e-11
    s.init(**_kw(pkg))
    return s, sol


@pytest.mark.parametrize("interleave", [False, True])
def test_system_with_face_form_matches_jax(interleave):
    out = {}
    for pkg in PKGS:
        s, sol = _face_system(pkg, interleave)
        info = s.solve()
        out[pkg] = (int(info["iters"]),
                    np.concatenate([sol.sol[-1][v] for v in ("u", "w")]))
    assert out["torch"][0] == out["jax"][0]
    ref = out["jax"][1]
    np.testing.assert_allclose(out["torch"][1], ref, rtol=0,
                               atol=1e-8 * np.abs(ref).max())


@pytest.mark.parametrize("level", [1, 0])
def test_extra_rhs_matches_jax(level):
    """D = A^{-1} B for two seeded columns through the step of level 1
    (V-cycle GMRES) and level 0 (the coarse-direct dense solve)."""
    got = {}
    for pkg in PKGS:
        s, _ = _face_system(pkg, False)
        a = s.assemblers[level]
        B = np.random.default_rng(9).standard_normal((a.n_dofs, 2))
        B[a.dirichlet_mask] = 0.0
        u = s.gather(level)
        step = s.step_fn(level)
        if pkg == "jax":
            out = step(jnp.asarray(u), a.device_tables_cached(),
                       s._aux_arrays(level), s._aux_scalars_traced(),
                       extra_rhs=jnp.asarray(B))
            got[pkg] = (np.asarray(out[0]), np.asarray(out[4]))
        else:
            out = step(torch.as_tensor(u), extra_rhs=B)
            assert out.extra.shape == (a.n_dofs, 2)
            got[pkg] = (out.u.numpy(), out.extra.numpy())
            if level == 1:
                # each column solves A d = b to the outer rtol
                _, data = a.make_assemble_fn()(torch.as_tensor(u))
                res = _ell_matvec(a, data.numpy(), got[pkg][1][:, 0]) \
                    - B[:, 0]
                assert np.linalg.norm(res) < 1e-9 * np.linalg.norm(B[:, 0])
    for k in range(2):
        ref = got["jax"][k]
        np.testing.assert_allclose(got["torch"][k], ref, rtol=0,
                                   atol=1e-8 * np.abs(ref).max())
