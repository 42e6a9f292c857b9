"""Port parity: error norms, integrals and the FE-convergence harness
against femus_tpu, in float64 on the host.

The same seeded field goes through both packages' ``error_norms``,
``l2_norm_field``, ``integrate_field`` and ``integrate`` for every family
on quad, tri and hex meshes, and on a hand-built embedded surface (2-D
quads with 3-D coordinates): equal to 1e-12.  ``convergence_study`` of a
serendipity Poisson problem (unit_box((3,3)), 3 levels, CG to 1e-12)
gives the same errors and orders to 1e-10, and ``incremental_convergence``
the same increments.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.assembly.norms as jn
import femus_tpu.systems.fe_convergence as jfc
import femus_tpu_torch.assembly.norms as tn
import femus_tpu_torch.systems.fe_convergence as tfc
from femus_tpu.mesh.generation import unit_box as junit_box
from femus_tpu.mesh.multilevel import MultiLevelMesh as JMLM
from femus_tpu_torch.mesh.generation import unit_box as tunit_box
from femus_tpu_torch.mesh.multilevel import MultiLevelMesh as TMLM

PI = np.pi
FAMILIES = ["linear", "serendipity", "biquadratic", "disc_constant",
            "disc_linear"]


def _exact(xp):
    """u(x) = sin(pi x0) cos(x1) + x0 x_last, and its gradient, in the
    array module ``xp`` (jnp or torch)."""
    def u(x):
        return xp.sin(PI * x[:, 0]) * xp.cos(x[:, 1]) + x[:, 0] * x[:, -1]

    def grad(x):
        g = [PI * xp.cos(PI * x[:, 0]) * xp.cos(x[:, 1]) + x[:, -1],
             -xp.sin(PI * x[:, 0]) * xp.sin(x[:, 1])]
        g += [0.0 * x[:, k] for k in range(2, x.shape[1])]
        g[-1] = g[-1] + x[:, 0]
        return xp.stack(g, -1)

    return u, grad


def _meshes(kind):
    if kind == "surface":
        # 2-D quads lifted onto the graph z = 0.3 x^2 + 0.2 y: a mesh with
        # 3-D coordinates on 2-D elements (the embedded-manifold branch)
        out = []
        for ub in (junit_box, tunit_box):
            m = ub((3, 3), "quad")
            x, y = m.coords[:, 0], m.coords[:, 1]
            m.coords = np.column_stack([x, y, 0.3 * x ** 2 + 0.2 * y])
            out.append(m)
        return out
    shape = (2, 2, 2) if kind == "hex" else (3, 3)
    return junit_box(shape, kind), tunit_box(shape, kind)


@pytest.mark.parametrize("kind", ["quad", "tri", "hex", "surface"])
@pytest.mark.parametrize("family", FAMILIES)
def test_norms_and_integrals_match_jax(kind, family):
    jm, tm = _meshes(kind)
    n = tm.dofmap(family).n_dofs
    assert n == jm.dofmap(family).n_dofs
    u = np.random.default_rng(3).standard_normal(n)
    uj, gj = _exact(jnp)
    ut, gt = _exact(torch)
    ref = jn.error_norms(jm, family, jnp.asarray(u), uj, gj)
    got = tn.error_norms(tm, family, u, ut, gt, device="cpu")
    assert isinstance(got[0], float) and isinstance(got[1], float)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_allclose(
        tn.l2_norm_field(tm, family, torch.as_tensor(u), device="cpu"),
        jn.l2_norm_field(jm, family, jnp.asarray(u)), rtol=1e-12)
    np.testing.assert_allclose(
        tn.integrate_field(tm, family, u, device="cpu"),
        jn.integrate_field(jm, family, jnp.asarray(u)), rtol=1e-12)
    np.testing.assert_allclose(tn.integrate(tm, ut, device="cpu"),
                               jn.integrate(jm, uj), rtol=1e-12)


def _poisson_solver(pkg):
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    xp = torch if pkg == "femus_tpu_torch" else jnp

    def exact(x):
        return xp.sin(PI * x[:, 0]) * xp.sin(PI * x[:, 1])

    def make_and_solve(ml_mesh):
        ml_sol = mod("systems.solution").MultiLevelSolution(ml_mesh)
        ml_sol.add_solution("u", "serendipity")
        ml_sol.initialize("u")
        ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
        ml_sol.generate_bdc("u")
        prob = mod("systems.problem").MultiLevelProblem(ml_mesh, ml_sol,
                                                        quad_order="fifth")
        sys_ = prob.add_system(mod("systems.system").LinearImplicitSystem,
                               "P")
        sys_.add_unknown("u")
        sys_.set_assembly(mod("assembly.forms").poisson(
            "u", "serendipity", rhs=lambda x: 2 * PI * PI * exact(x)))
        sys_.config.outer = "cg"
        sys_.config.rtol = 1e-12
        if pkg == "femus_tpu_torch":
            sys_.init(device="cpu")
        else:
            sys_.init()
        sys_.solve()
        return ml_sol, {"u": "serendipity"}

    return make_and_solve, exact


def test_convergence_study_matches_jax():
    pi = PI

    def grad(xp):
        return lambda x: xp.stack(
            [pi * xp.cos(pi * x[:, 0]) * xp.sin(pi * x[:, 1]),
             pi * xp.sin(pi * x[:, 0]) * xp.cos(pi * x[:, 1])], axis=-1)

    mj, ej = _poisson_solver("femus_tpu")
    mt, et = _poisson_solver("femus_tpu_torch")
    ref = jfc.convergence_study(mj, junit_box((3, 3), "quad"), 3, {"u": ej},
                                {"u": grad(jnp)})
    got = tfc.convergence_study(mt, tunit_box((3, 3), "quad"), 3, {"u": et},
                                {"u": grad(torch)}, device="cpu")
    assert got.levels == ref.levels
    for key in ("l2_errors", "h1_errors", "l2_orders", "h1_orders"):
        np.testing.assert_allclose(getattr(got, key)["u"],
                                   getattr(ref, key)["u"], rtol=1e-10)
    assert got.l2_orders["u"][-1] > 2.7 and got.h1_orders["u"][-1] > 1.8
    assert got.report() == ref.report()


def test_incremental_convergence_matches_jax():
    jm, tm = JMLM(junit_box((3, 3)), 3), TMLM(tunit_box((3, 3)), 3)
    rng = np.random.default_rng(4)
    sols = [rng.standard_normal(m.dofmap("biquadratic").n_dofs)
            for m in tm.levels]
    np.testing.assert_allclose(
        tfc.incremental_convergence(sols, tm, "u", "biquadratic"),
        jfc.incremental_convergence(sols, jm, "u", "biquadratic"),
        rtol=1e-12)
