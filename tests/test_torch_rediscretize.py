"""Port parity: rediscretized coarse levels for the assembled and BELL
operators, the matrix-free operator with a face form, and the
mixed-precision builds of the explicit-operator hierarchies, against
femus_tpu, in float64 on the host.

- ``build_hierarchy_from_ops`` with multiplicative Vanka blocks on each
  level's own pattern: one V-cycle to 1e-10; with ``compute_dtype``
  float32 to 1e-5; bfloat16 builds (float32 coarse LU and vectors) and
  stays within bfloat16 rounding of the float64 cycle;
- ``System`` solves with ``coarse_op="rediscretize"`` and ``operator``
  "assembled" or "bell" (the plain path on the host) on Poisson and on a
  stacked Navier-Stokes cavity: equal iteration counts, u to 1e-8 (the
  cavity with "bell" in test_torch_rediscretize_cavity.py);
- the refusals: interleaved dofs, the additive Vanka sweep and
  "vanka_gmres" (the reference's rediscretized hierarchy silently runs
  multiplicative Vanka and Chebyshev for these two);
- ``operator="matrix_free"`` ignores ``coarse_op`` as the reference does,
  and solves with a Neumann face form (the linearised residual carries
  the face terms), held against the reference's matrix-free step;
- ``build_hierarchy_matfree`` with ``compute_dtype``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import femus_tpu.algebra.mg as jmg
import femus_tpu.algebra.transfer as jtr
import femus_tpu.algebra.vanka as jva
import femus_tpu.assembly.bc as jbc
import femus_tpu.assembly.engine as jeng
import femus_tpu.assembly.forms as jforms
import femus_tpu_torch.algebra.krylov as tkry
import femus_tpu_torch.algebra.mg as tmg
import femus_tpu_torch.algebra.transfer as ttr
import femus_tpu_torch.algebra.vanka as tva
import femus_tpu_torch.assembly.bc as tbc
import femus_tpu_torch.assembly.engine as teng
import femus_tpu_torch.assembly.forms as tforms
from femus_tpu.mesh.generation import unit_box as junit_box
from femus_tpu.mesh.multilevel import MultiLevelMesh as JMLM
from femus_tpu_torch import convert
from femus_tpu_torch.mesh.generation import unit_box as tunit_box
from femus_tpu_torch.mesh.multilevel import MultiLevelMesh as TMLM

from cavity_cases import cavity_bc as _cavity_bc
from cavity_cases import check_cavity_rediscretized
from cavity_cases import close as _close
from cavity_cases import mod as _mod


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


PI = np.pi


# ---------------------------------------------------------------------------
# build_hierarchy_from_ops
# ---------------------------------------------------------------------------

def _cavity_asm(eng, forms, bc, mesh, **kw):
    """The stacked Q2/Q2/P1dc cavity assembler with the pressure gauge."""
    U = eng.Unknown
    a = eng.Assembler(mesh, [U("u"), U("v"), U("p", "disc_linear")], **kw)
    a.set_volume_form(forms.navier_stokes(("u", "v"), "p",
                                          pres_family="disc_linear",
                                          nu=0.01))
    codes = bc.generate_bdc(a, _cavity_bc)
    mask = np.concatenate([codes[n][0] == 0 for n in "uvp"])
    vals = np.concatenate([codes[n][1] for n in "uvp"])
    mask[a.offsets["p"]] = True
    a.set_dirichlet(mask, vals)
    return a


def _op_levels(levels=3, vanka=True):
    """Per-level cavity Jacobians at a seeded state (assembled by the port
    on every level and handed to both packages; assembly parity is held in
    tests/test_torch_assembly.py), masked transfers and Vanka blocks on
    each level's own pattern: (JAX ops, port ops, JAX pairs, port pairs,
    JAX blocks, port blocks)."""
    jm, tm = JMLM(junit_box((2, 2)), levels), TMLM(tunit_box((2, 2)), levels)
    ja = [_cavity_asm(jeng, jforms, jbc, m) for m in jm.levels]
    ta = [_cavity_asm(teng, tforms, tbc, m, device="cpu") for m in tm.levels]
    rng = np.random.default_rng(0)
    jops, tops = [], []
    for aj, at in zip(ja, ta):
        u = tbc.apply_dirichlet_values(at, rng.standard_normal(at.n_dofs)
                                       * 0.3)
        data = at.make_assemble_fn()(torch.as_tensor(u))[1].numpy()
        jops.append(jeng.SparseOp(jnp.asarray(data),
                                  jnp.asarray(aj.pattern.cols),
                                  aj.pattern.n_cols))
        tops.append(convert.sparse_op_from_numpy(
            data, at.pattern.cols, at.pattern.n_cols, device="cpu"))
    jpr, tpr = [], []
    for l in range(levels - 1):
        Pl = jtr.mask_prolongation(
            jtr.block_diag_prolongation(jm.levels[l], jm.levels[l + 1],
                                        ja[l].unknowns),
            ja[l + 1].dirichlet_mask, ja[l].dirichlet_mask)
        jpr.append(jtr.op_pair_from_scipy(Pl))
        tpr.append(ttr.op_pair_from_scipy(Pl, device="cpu"))
    vj = vt = None
    if vanka:
        vj = [jva.build_element_blocks(a, 2) for a in ja]
        vt = [None] + [tva.build_element_blocks(a, 2, device="cpu")
                       for a in ta[1:]]
    return jops, tops, jpr, tpr, vj, vt


@pytest.fixture(scope="module")
def op_levels():
    return _op_levels()


def test_from_ops_vanka_matches_jax(op_levels):
    jops, tops, jpr, tpr, vj, vt = op_levels
    hj = jmg.build_hierarchy_from_ops(jops, jpr, smoother="vanka",
                                      vanka_blocks=vj, vanka_omega=0.9)
    ht = tmg.build_hierarchy_from_ops(tops, tpr, smoother="vanka",
                                      vanka_blocks=vt, vanka_omega=0.9)
    r = np.random.default_rng(5).standard_normal(tops[-1].n_rows)
    _close(ht.as_preconditioner("V")(torch.as_tensor(r)).numpy(),
           hj.as_preconditioner("V")(jnp.asarray(r)), 1e-10)
    # the fine smoother alone, from a non-zero iterate
    b_, x_ = np.random.default_rng(9).standard_normal((2, tops[-1].n_rows))
    _close(ht.levels[-1].smoother(torch.as_tensor(b_),
                                  torch.as_tensor(x_)).numpy(),
           hj.levels[-1].smoother(jnp.asarray(b_), jnp.asarray(x_)), 1e-10)
    # the LU-solved coarsest level gets no smoother
    assert ht.levels[0].smoother is None


@pytest.mark.parametrize("smoother", ["chebyshev", "jacobi"])
def test_from_ops_point_smoothers_match_jax(op_levels, smoother):
    """Without blocks (and for a Vanka request on a level without blocks)
    the levels smooth with Chebyshev or Jacobi, as in the reference."""
    jops, tops, jpr, tpr, _, _ = op_levels
    r = np.random.default_rng(4).standard_normal(tops[-1].n_rows)
    hj = jmg.build_hierarchy_from_ops(jops, jpr, smoother=smoother)
    ht = tmg.build_hierarchy_from_ops(tops, tpr, smoother=smoother)
    _close(ht.as_preconditioner("V")(torch.as_tensor(r)).numpy(),
           hj.as_preconditioner("V")(jnp.asarray(r)), 1e-10)


def test_from_ops_float32_matches_jax(op_levels):
    """compute_dtype=float32 casts every level, the finest included, and
    the transfers; the correction comes back in float64."""
    jops, tops, jpr, tpr, vj, vt = op_levels
    hj = jmg.build_hierarchy_from_ops(jops, jpr, smoother="vanka",
                                      vanka_blocks=vj,
                                      compute_dtype=jnp.float32)
    ht = tmg.build_hierarchy_from_ops(tops, tpr, smoother="vanka",
                                      vanka_blocks=vt,
                                      compute_dtype=torch.float32)
    assert all(lv.A.data.dtype == torch.float32 for lv in ht.levels)
    assert ht.levels[1].P.data.dtype == torch.float32
    r = np.random.default_rng(5).standard_normal(tops[-1].n_rows)
    got = ht.as_preconditioner("V")(torch.as_tensor(r))
    assert got.dtype == torch.float64
    _close(got.numpy(), hj.as_preconditioner("V")(jnp.asarray(r)), 1e-5)


def test_from_ops_bf16_builds_on_float32():
    """compute_dtype=bfloat16: values stored in bfloat16, the coarse LU
    and the Vanka block inverses in float32, the cycle's vectors float32;
    one V-cycle stays within bfloat16 rounding of the float64 one (the
    reference cannot build it: its host LAPACK takes no bfloat16)."""
    _, tops, _, tpr, _, vt = _op_levels()
    h16 = tmg.build_hierarchy_from_ops(tops, tpr, smoother="vanka",
                                       vanka_blocks=vt,
                                       compute_dtype=torch.bfloat16)
    h64 = tmg.build_hierarchy_from_ops(tops, tpr, smoother="vanka",
                                       vanka_blocks=vt)
    assert h16.levels[-1].A.data.dtype == torch.bfloat16
    assert h16.coarse_lu[0].dtype == torch.float32
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(
        tops[-1].n_rows))
    got = h16.as_preconditioner("V")(r)
    assert got.dtype == torch.float64
    ref = h64.as_preconditioner("V")(r).numpy()
    assert np.abs(got.numpy() - ref).max() < 5e-2 * np.abs(ref).max()


def test_from_ops_bell_levels_cast_both_layouts():
    """A level on the BELL frame casts its ELL and its sliced-ELL values."""
    from femus_tpu_torch.algebra.bell import (BellBackedOp, bell_backed,
                                              build_sell_plan)
    a = teng.Assembler(tunit_box((8, 8)), [teng.Unknown("u")], device="cpu")
    a.set_volume_form(tforms.poisson("u"))
    tbc.generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
    _, data = a.make_assemble_fn()(torch.zeros(a.n_dofs, dtype=torch.float64))
    # an RCM frame, as the rescue gives this 289-row pattern
    A = bell_backed(build_sell_plan(a.pattern), a.op_with(data))
    A16 = tmg._cast_level(A, torch.bfloat16)
    assert isinstance(A16, BellBackedOp)
    assert A16.data.dtype == A16.bell.vals.dtype == torch.bfloat16
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(a.n_dofs),
                        dtype=torch.float32)
    y = A16.matvec(x)
    assert y.dtype == torch.float32
    ref = A.matvec(x.double()).numpy()
    assert np.abs(y.numpy() - ref).max() < 2e-2 * np.abs(ref).max()


def test_from_ops_refusals(op_levels):
    """The reference runs multiplicative Vanka for an additive request and
    Chebyshev for "vanka_gmres" on a rediscretized hierarchy; the port
    refuses both."""
    _, tops, _, tpr, _, vt = op_levels
    with pytest.raises(ValueError, match="multiplicative"):
        tmg.build_hierarchy_from_ops(tops, tpr, smoother="vanka",
                                     vanka_blocks=vt,
                                     vanka_multiplicative=False)
    with pytest.raises(ValueError, match="vanka_gmres"):
        tmg.build_hierarchy_from_ops(tops, tpr, smoother="vanka_gmres",
                                     vanka_blocks=vt, krylov_m=3)
    with pytest.raises(ValueError, match="smoother"):
        tmg.build_hierarchy_from_ops(tops, tpr, smoother="ilu")


# ---------------------------------------------------------------------------
# System solves with rediscretized coarse levels
# ---------------------------------------------------------------------------

def _poisson_system(pkg, operator, smoother, coarse=12, levels=3,
                    coarse_op="rediscretize"):
    """-Lap u = 2 pi^2 sin(pi x) sin(pi y) on unit_box((coarse, coarse))
    refined to ``levels`` levels, GMRES to rtol 1e-10; at 12 x 12 the
    middle level (2,401 dofs) is above the BELL threshold."""
    xp = jnp if pkg == "femus_tpu" else torch
    ml_mesh = _mod(pkg, "mesh.multilevel").MultiLevelMesh(
        _mod(pkg, "mesh.generation").unit_box((coarse, coarse), "quad"),
        levels)
    ml_sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.initialize("u")
    ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
    ml_sol.generate_bdc("u")
    prob = _mod(pkg, "systems.problem").MultiLevelProblem(
        ml_mesh, ml_sol, quad_order="fifth")
    s = prob.add_system(_mod(pkg, "systems.system").LinearImplicitSystem,
                        "P")
    s.add_unknown("u")
    s.set_assembly(_mod(pkg, "assembly.forms").poisson(
        "u", "biquadratic", rhs=lambda x: 2 * PI ** 2
        * xp.sin(PI * x[:, 0]) * xp.sin(PI * x[:, 1])))
    cfg = s.config
    cfg.operator, cfg.coarse_op, cfg.smoother = operator, coarse_op, smoother
    cfg.rtol = 1e-10
    s.init(**({"device": "cpu"} if pkg == "femus_tpu_torch" else {}))
    info = s.solve()
    return np.asarray(ml_sol.sol[-1]["u"]), info, s


@pytest.mark.parametrize("operator,smoother", [
    ("assembled", "chebyshev"), ("bell", "chebyshev"), ("bell", "jacobi"),
    ("assembled", "vanka")])
def test_poisson_rediscretized_matches_jax(operator, smoother):
    u_ref, info_ref, _ = _poisson_system("femus_tpu", operator, smoother)
    u, info, s = _poisson_system("femus_tpu_torch", operator, smoother)
    assert info["converged"] and info["iters"] == int(info_ref["iters"])
    _close(u, u_ref, 1e-8)
    assert all(t[2] is None for t in s.transfers)
    routing = s.solver_info()["routing"]
    assert {"n_rows": 625, "path": "lu",
            "reason": "coarsest V-cycle level: dense LU solve"} in routing
    if operator == "bell":
        # the middle level rides the BELL frame, as the fine one
        paths = {n["n_rows"]: n["path"] for n in routing
                 if n.get("path") == "bell"}
        assert set(paths) == {2401, 9409}


# the "bell" case is in test_torch_rediscretize_cavity.py, so that a
# parallel run gives the two long cases to two workers
@pytest.mark.parametrize("operator", ["assembled"])
def test_cavity_rediscretized_matches_jax(operator):
    check_cavity_rediscretized(operator)


def test_rediscretize_refusals():
    for config, exc, match in (
            ({"interleave_dofs": True, "operator": "bell"}, ValueError,
             "galerkin"),
            ({"smoother": "vanka", "vanka_multiplicative": False},
             ValueError, "multiplicative vanka"),
            ({"smoother": "vanka_gmres"}, ValueError,
             "multiplicative vanka")):
        ml_mesh = TMLM(tunit_box((2, 2)), 2)
        sol = _mod("femus_tpu_torch", "systems.solution").MultiLevelSolution(
            ml_mesh)
        sol.add_solution("u")
        s = _mod("femus_tpu_torch", "systems.problem").MultiLevelProblem(
            ml_mesh, sol).add_system(
            _mod("femus_tpu_torch", "systems.system").LinearImplicitSystem,
            "P")
        s.add_unknown("u")
        s.config.coarse_op = "rediscretize"
        for k, v in config.items():
            setattr(s.config, k, v)
        with pytest.raises(exc, match=match):
            s.init(device="cpu")


def test_rediscretize_with_max_mg_levels_raises():
    """Truncated hierarchies stay Galerkin-only, as in the reference."""
    ml = TMLM(tunit_box((2, 2)), 3)
    sol = _mod("femus_tpu_torch", "systems.solution").MultiLevelSolution(ml)
    sol.add_solution("u")
    sol.initialize("u")
    sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
    sol.generate_bdc("u")
    s = _mod("femus_tpu_torch", "systems.problem").MultiLevelProblem(
        ml, sol).add_system(
        _mod("femus_tpu_torch", "systems.system").LinearImplicitSystem, "P")
    s.add_unknown("u")
    s.set_assembly(tforms.poisson("u"))
    s.config.coarse_op = "rediscretize"
    s.config.max_mg_levels = 2
    s.init(device="cpu")
    with pytest.raises(NotImplementedError, match="max_mg_levels"):
        s.step_fn(-1)


# ---------------------------------------------------------------------------
# The matrix-free operator
# ---------------------------------------------------------------------------

def test_matrix_free_ignores_coarse_op_as_jax_does():
    """operator="matrix_free" with coarse_op="rediscretize": the reference's
    matrix-free step does not read coarse_op (first coarse level
    re-assembled, deeper ones Galerkin); the port gives the same solve and
    the same solve as with coarse_op="galerkin"."""
    kw = dict(coarse=4, levels=3)
    u_ref, info_ref, _ = _poisson_system("femus_tpu", "matrix_free",
                                         "chebyshev", **kw)
    u, info, s = _poisson_system("femus_tpu_torch", "matrix_free",
                                 "chebyshev", **kw)
    assert info["converged"] and info["iters"] == int(info_ref["iters"])
    _close(u, u_ref, 1e-8)
    u_g, info_g, _ = _poisson_system("femus_tpu_torch", "matrix_free",
                                     "chebyshev", coarse_op="galerkin", **kw)
    assert info_g["iters"] == info["iters"]
    _close(u, u_g, 1e-12)


def _neumann_system(pkg, operator):
    """tests/test_poisson.py's inhomogeneous Neumann problem as a 3-level
    system from unit_box((3, 3)): u = x^2 + y^2, Dirichlet on three sides,
    du/dn = 2 on x = 1 through a face form; GMRES to rtol 1e-11."""
    ml_mesh = _mod(pkg, "mesh.multilevel").MultiLevelMesh(
        _mod(pkg, "mesh.generation").unit_box((3, 3), "quad"), 3)
    ml_sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.initialize("u")
    ml_sol.attach_bc(lambda var, x, grp, t: (
        (False, 0.0) if grp == 2 else (True, float(x[0] ** 2 + x[1] ** 2))))
    ml_sol.generate_bdc("u")
    prob = _mod(pkg, "systems.problem").MultiLevelProblem(
        ml_mesh, ml_sol, quad_order="fifth")
    s = prob.add_system(_mod(pkg, "systems.system").LinearImplicitSystem,
                        "P")
    s.add_unknown("u")
    forms = _mod(pkg, "assembly.forms")
    s.set_assembly(forms.poisson("u", rhs=lambda x: -4.0 + 0.0 * x[:, 0]),
                   forms.neumann_faces({2: lambda x, nrm: 2.0
                                        + 0.0 * x[:, 0]}, "u"))
    s.config.operator = operator
    s.config.rtol = 1e-11
    s.init(**({"device": "cpu"} if pkg == "femus_tpu_torch" else {}))
    info = s.solve()
    return np.asarray(ml_sol.sol[-1]["u"]), info, ml_mesh


def test_matrix_free_face_form_matches_jax():
    u_ref, info_ref, _ = _neumann_system("femus_tpu", "matrix_free")
    u, info, ml_mesh = _neumann_system("femus_tpu_torch", "matrix_free")
    assert info["converged"] and info["iters"] == int(info_ref["iters"])
    _close(u, u_ref, 1e-8)
    # the face terms are in: the quadratic solution is reproduced
    xy = ml_mesh.levels[-1].node_coords_of("biquadratic")
    np.testing.assert_allclose(u, (xy ** 2).sum(axis=1), atol=1e-9)
    u_a, _, _ = _neumann_system("femus_tpu_torch", "assembled")
    _close(u, u_a, 1e-9)


@pytest.mark.parametrize("volume", [False, True])
def test_linearized_residual_carries_face_terms(volume):
    """R of the linearised residual equals the assembled R, and jv(v)
    equals the assembled Jacobian times v on the free rows and columns,
    with a plain face form and with a volume face form (Nitsche); R and
    jv agree with the reference's jax.linearize of its residual."""
    pk = {"jax": (jeng, jforms, jbc, junit_box),
          "torch": (teng, tforms, tbc, tunit_box)}
    got = {}
    v = None
    for name, (eng, forms, bc, ub) in pk.items():
        kw = {"device": "cpu"} if name == "torch" else {}
        a = eng.Assembler(ub((3, 3), "quad"), [eng.Unknown("u")],
                          quad_order="fifth", **kw)
        a.set_volume_form(forms.nonlinear_diffusion("u"))
        if volume:
            a.set_face_form(forms.nitsche_dirichlet(
                "u", g_fn=lambda x: x[:, 0] * x[:, 1], gamma=20.0),
                volume=True)
        else:
            a.set_face_form(forms.neumann_faces(
                {2: lambda x, nrm: 2.0 + 0.0 * x[:, 0]}, "u"))
            bc.generate_bdc(a, lambda var, x, grp, t: (grp == 1, 0.3))
        rng = np.random.default_rng(1)
        u = bc.apply_dirichlet_values(a, rng.standard_normal(a.n_dofs))
        if v is None:
            v = np.where(a.dirichlet_mask, 0.0,
                         rng.standard_normal(a.n_dofs))
        if name == "jax":
            res = a.make_assemble_fn(with_jacobian=False, pass_tables=True)
            tab = a.device_tables_cached()
            R, lin = jax.linearize(lambda uu: res(uu, tab, {}, {})[0],
                                   jnp.asarray(u))
            got[name] = (np.asarray(R), np.asarray(lin(jnp.asarray(v))))
        else:
            R, jv = a.make_linearized_fn()(torch.as_tensor(u),
                                            a.device_tables_cached())
            Ra, data = a.make_assemble_fn()(torch.as_tensor(u))
            _close(R.numpy(), Ra.numpy(), 1e-13)
            Jv = jv(torch.as_tensor(v)).numpy()
            A = sp.csr_matrix((data.numpy()[a.pattern.valid],
                               a.pattern.cols[a.pattern.valid]
                               .astype(np.int64),
                               a.pattern.indptr), shape=(a.n_dofs,) * 2)
            free = ~a.dirichlet_mask
            _close(Jv[free], (A @ v)[free], 1e-12)
            got[name] = (R.numpy(), Jv)
    # the reference linearises the residual with its Dirichlet rows zeroed
    _close(got["torch"][0], got["jax"][0], 1e-12)
    _close(got["torch"][1][free], got["jax"][1][free], 1e-12)


def test_matfree_hierarchy_compute_dtype():
    """build_hierarchy_matfree with compute_dtype: sub-levels and
    transfers stored low, the fine J.v in the ambient precision on the
    cycle's vectors; the float32 cycle lies within float32 rounding of the
    float64 one, the bfloat16 one within bfloat16 rounding, and an outer
    FGMRES with either reaches the float64 solution."""
    _, _, s = _poisson_system("femus_tpu_torch", "matrix_free", "chebyshev",
                              coarse=4, levels=3)
    a = s.assemblers[-1]
    u = torch.as_tensor(s.gather(-1))
    tables = a.device_tables_cached()
    R, jv = a.make_linearized_fn()(u, tables)
    diag = a.make_diag_fn()(u, tables)
    m_f = torch.as_tensor(a.dirichlet_mask)

    def Amv(x):
        return torch.where(m_f, x, jv(torch.where(m_f, 0.0, x)))

    sub_tr = s._transfers_for(1)
    a_c = s.assemblers[1]
    Rsol, winv = s._state_restriction(s._physical_pair(1)[0])
    _, data_c = a_c.make_assemble_fn()((Rsol @ u) * winv)
    out = {}
    for dt in (None, torch.float32, torch.bfloat16):
        h = tmg.build_hierarchy_matfree(
            Amv, diag, a_c.op_with(data_c), list(sub_tr) + [
                s.transfers[1][:2]],
            dir_masks=[torch.as_tensor(m) for m in s.masks[:1]],
            compute_dtype=dt, device="cpu")
        if dt is not None:
            assert h.levels[1].A.data.dtype == dt
            assert h.levels[-1].P.data.dtype == dt
        r = torch.as_tensor(np.random.default_rng(3).standard_normal(
            a.n_dofs))
        got = h.as_preconditioner("V")(r)
        assert got.dtype == torch.float64
        b = torch.where(m_f, 0.0, r)
        # flexible: a low-precision cycle is a linear map only to its
        # rounding
        x, info = tkry.fgmres(Amv, b, M=h.as_preconditioner("V"), tol=1e-10,
                              restart=30, max_restarts=4)
        assert info.converged
        out[dt] = (got.numpy(), x.numpy())
    ref, xref = out[None]
    # bfloat16 values: ~7e-2 from the float64 cycle, as the Galerkin
    # bfloat16 cycle (tests/test_torch_cycles.py)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-1)):
        assert np.abs(out[dt][0] - ref).max() < tol * np.abs(ref).max()
        _close(out[dt][1], xref, 1e-8)
