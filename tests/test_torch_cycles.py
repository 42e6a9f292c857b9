"""Port parity, slice 3: the solver routes beside the V-cycle (FGMRES,
Richardson, W/F/K/additive/kaskade cycles, mixed-precision cycles, the
Krylov-wrapped Vanka smoother, the matrix-free operator) against
femus_tpu, in float64 on the host.

Operators are handed over as numpy arrays (convert.py), so both packages
compute on the same matrix.  Krylov solutions agree to 1e-10 with equal
iteration counts; one application of a cycle to 1e-10 (1e-5 for a float32
cycle); system solves to 1e-8 with equal iteration counts.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.algebra.krylov as jkry
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

PI = np.pi


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _system(kind: str, n: int = 40):
    """A seeded dense system: "spd" (condition ~30) or "nonsym"
    (diagonally dominant, non-symmetric); (A, b, Jacobi diagonal)."""
    rng = np.random.default_rng(7)
    if kind == "spd":
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = Q @ np.diag(np.logspace(0, 1.5, n)) @ Q.T
    else:
        A = 4.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
    return A, rng.standard_normal(n), np.diag(A).copy()


@pytest.mark.parametrize("kind", ["spd", "nonsym"])
@pytest.mark.parametrize("precond", [False, True])
def test_fgmres_matches_jax(kind, precond):
    A, b, d = _system(kind)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    Mj = (lambda r: r / jnp.asarray(d)) if precond else None
    Mt = (lambda r: r / torch.as_tensor(d)) if precond else None
    xj, ij = jkry.fgmres(lambda v: Aj @ v, jnp.asarray(b), M=Mj, tol=1e-11,
                         restart=12, max_restarts=40)
    xt, it = tkry.fgmres(lambda v: At @ v, torch.as_tensor(b), M=Mt,
                         tol=1e-11, restart=12, max_restarts=40)
    assert it.converged and it.iters == int(ij.iters) and it.iters > 12
    _close(xt.numpy(), xj, 1e-10)
    # right preconditioning: the residual is the unpreconditioned one
    np.testing.assert_allclose(it.residual, np.linalg.norm(b - A @ xt.numpy()),
                               rtol=1e-6, atol=1e-14)
    assert it.target == pytest.approx(1e-11 * np.linalg.norm(b))


@pytest.mark.parametrize("kind", ["spd", "nonsym"])
def test_richardson_matches_jax(kind):
    A, b, d = _system(kind)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    x0 = np.random.default_rng(8).standard_normal(len(b))
    xj = jkry.richardson(lambda v: Aj @ v, jnp.asarray(b), jnp.asarray(x0),
                         M=lambda r: r / jnp.asarray(d), scale=0.7, iters=7)
    xt = tkry.richardson(lambda v: At @ v, torch.as_tensor(b),
                         torch.as_tensor(x0),
                         M=lambda r: r / torch.as_tensor(d), scale=0.7,
                         iters=7)
    _close(xt.numpy(), xj, 1e-10)
    # from the zero guess, unpreconditioned
    _close(tkry.richardson(lambda v: At @ v, torch.as_tensor(b), scale=0.01,
                           iters=3).numpy(),
           jkry.richardson(lambda v: Aj @ v, jnp.asarray(b), scale=0.01,
                           iters=3), 1e-10)


def _cavity_bc(var, x, grp, t):
    if var == "p":
        return (False, 0.0)
    if var == "u" and abs(x[1] - 1.0) < 1e-9:
        return (True, 1.0)
    return (True, 0.0)


def _asm(eng, forms, bc, mesh, problem, **kw):
    U = eng.Unknown
    if problem == "poisson":
        a = eng.Assembler(mesh, [U("u")], **kw)
        a.set_volume_form(forms.poisson("u"))
        bc.generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
        return a
    a = eng.Assembler(mesh, [U("u"), U("v"), U("p", "disc_linear")],
                      interleave=True, **kw)
    a.set_volume_form(forms.navier_stokes(("u", "v"), "p",
                                          pres_family="disc_linear", nu=0.01))
    codes = bc.generate_bdc(a, _cavity_bc)
    # pin one pressure dof (the gauge), or the coarse LU is singular
    mask = np.concatenate([codes[n][0] == 0 for n in "uvp"])
    vals = np.concatenate([codes[n][1] for n in "uvp"])
    mask[a.offsets["p"]] = True
    a.set_dirichlet(mask, vals)
    return a


def _hierarchies(problem, smoother, levels, jax_side=True, **kw):
    """One Galerkin hierarchy from each package on the same fine operator
    (a seeded state's Jacobian, assembled by the JAX package): ``levels``
    mesh levels from unit_box((4, 4)), PtAP chains built top-down.  With
    ``jax_side=False`` only the port's hierarchy is built (None for the
    JAX one)."""
    jm, tm = JMLM(junit_box((4, 4)), levels), TMLM(tunit_box((4, 4)), levels)
    ja = [_asm(jeng, jforms, jbc, m, problem) for m in jm.levels]
    ta = [_asm(teng, tforms, tbc, m, problem, device="cpu")
          for m in tm.levels]
    u = np.random.default_rng(0).standard_normal(ja[-1].n_dofs) * 0.3
    u = jbc.apply_dirichlet_values(ja[-1], u)
    data = np.asarray(ja[-1].make_assemble_fn()(jnp.asarray(u))[1])
    jop = jeng.SparseOp(jnp.asarray(data), jnp.asarray(ja[-1].pattern.cols),
                        ja[-1].pattern.n_cols)
    top = convert.sparse_op_from_numpy(data, ta[-1].pattern.cols,
                                       ta[-1].pattern.n_cols, device="cpu")
    jt, tt = [None] * (levels - 1), [None] * (levels - 1)
    jpat, tpat = ja[-1].pattern, ta[-1].pattern
    for l in range(levels - 2, -1, -1):
        P = []
        for tr, m, a in ((jtr, jm, ja), (ttr, tm, ta)):
            Pl = tr.block_diag_prolongation(m.levels[l], m.levels[l + 1],
                                            a[l].unknowns)
            pf, pc = a[l + 1].stack_perm, a[l].stack_perm
            if pf is not None:
                import scipy.sparse as sp
                coo = Pl.tocoo()
                Pl = sp.csr_matrix((coo.data, (pf[coo.row], pc[coo.col])),
                                   shape=Pl.shape)
                Pl.sort_indices()
            P.append(tr.mask_prolongation(Pl, a[l + 1].dirichlet_mask,
                                          a[l].dirichlet_mask))
        jt[l] = (*jtr.op_pair_from_scipy(P[0]),
                 jtr.build_ptap_schedule(jpat, P[0]))
        tt[l] = (*ttr.op_pair_from_scipy(P[1], device="cpu"),
                 ttr.build_ptap_schedule(tpat, P[1], device="cpu"))
        jpat, tpat = jt[l][2].coarse_pattern, tt[l][2].coarse_pattern
    vb_j = vb_t = None
    if smoother.startswith("vanka"):
        vb_j = [jva.build_element_blocks(
            ja[l], 2, pattern=jt[l][2].coarse_pattern if l < levels - 1
            else None) for l in range(levels)]
        vb_t = [tva.build_element_blocks(
            ta[l], 2, pattern=tt[l][2].coarse_pattern if l < levels - 1
            else None, device="cpu") for l in range(levels)]
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    jkw = {k: (jdt[v] if k == "compute_dtype" else v)
           for k, v in kw.items()}
    hj = jmg.build_hierarchy(
        jop, jt, smoother=smoother, vanka_blocks=vb_j,
        dir_masks=[jnp.asarray(a.dirichlet_mask) for a in ja[:-1]],
        **jkw) if jax_side else None
    ht = tmg.build_hierarchy(
        top, tt, smoother=smoother, vanka_blocks=vb_t,
        dir_masks=[a.dirichlet_mask for a in ta[:-1]], device="cpu", **kw)
    return jop, top, hj, ht


@pytest.fixture(scope="module")
def poisson3():
    """Three-level Poisson hierarchies (Chebyshev), built once."""
    return _hierarchies("poisson", "chebyshev", 3)


@pytest.mark.parametrize("cycle", ["V", "W", "F", "K", "ADDITIVE",
                                   "KASKADE"])
def test_cycles_match_jax(poisson3, cycle):
    """One application of each cycle shape on a 3-level hierarchy (W and K
    differ from V only below the second level)."""
    _, _, hj, ht = poisson3
    r = np.random.default_rng(5).standard_normal(hj.levels[-1].A.n_rows)
    ref = np.asarray(hj.as_preconditioner(cycle)(jnp.asarray(r)))
    got = ht.as_preconditioner(cycle)(torch.as_tensor(r)).numpy()
    _close(got, ref, 1e-10)
    if cycle != "V":
        v = ht.as_preconditioner("V")(torch.as_tensor(r)).numpy()
        assert np.abs(got - v).max() > 1e-6 * np.abs(v).max()


def test_k_cycle_inner_iterations_match_jax(poisson3):
    _, _, hj, ht = poisson3
    r = np.random.default_rng(6).standard_normal(hj.levels[-1].A.n_rows)
    hj.k_inner = ht.k_inner = 3
    try:
        _close(ht.k_cycle(torch.as_tensor(r)).numpy(),
               hj.k_cycle(jnp.asarray(r)), 1e-10)
    finally:
        hj.k_inner = ht.k_inner = 2


def test_mixed_precision_cycle_matches_jax():
    """compute_dtype=float32: the PtAP chain runs in float64, the cycle in
    float32, the correction comes back in float64."""
    _, _, hj, ht = _hierarchies("poisson", "chebyshev", 3,
                                compute_dtype=torch.float32)
    assert ht.levels[-1].A.data.dtype == torch.float32
    assert ht.levels[1].P.data.dtype == torch.float32
    r = np.random.default_rng(5).standard_normal(hj.levels[-1].A.n_rows)
    ref = np.asarray(hj.as_preconditioner("V")(jnp.asarray(r)))
    got = ht.as_preconditioner("V")(torch.as_tensor(r))
    assert got.dtype == torch.float64
    _close(got.numpy(), ref, 1e-5)


def test_bf16_cycle_builds_and_matches_jax():
    """compute_dtype=bfloat16: operators and transfers are stored in
    bfloat16, the dense coarsest operator is LU-factored in float32 (there
    is no bfloat16 LU) and the cycle's vectors are float32.  One V-cycle
    lies within bfloat16 rounding of the float64 cycle, no further than
    the JAX package's bfloat16 cycle (bfloat16 vectors); an outer CG with it reaches the float64
    solution to 1e-9 within the iteration budget of the JAX package's
    bfloat16 test (tests/test_mg.py::test_mixed_precision_vcycle)."""
    jop, top, hj, ht = _hierarchies("poisson", "chebyshev", 3,
                                    compute_dtype=torch.bfloat16)
    _, _, _, h64 = _hierarchies("poisson", "chebyshev", 3)
    assert ht.levels[-1].A.data.dtype == torch.bfloat16
    assert ht.levels[1].P.data.dtype == torch.bfloat16
    assert ht.coarse_lu[0].dtype == torch.float32
    r = np.random.default_rng(5).standard_normal(jop.n_rows)
    got = ht.as_preconditioner("V")(torch.as_tensor(r))
    assert got.dtype == torch.float64
    ref64 = h64.as_preconditioner("V")(torch.as_tensor(r)).numpy()
    ref_j = np.asarray(hj.as_preconditioner("V")(jnp.asarray(r)),
                       np.float64)
    err_t = np.abs(got.numpy() - ref64).max() / np.abs(ref64).max()
    err_j = np.abs(ref_j - ref64).max() / np.abs(ref64).max()
    # the bfloat16 values dominate: both packages' cycles sit ~7e-2 from
    # the float64 cycle, the port's no further than the JAX package's
    assert err_t < 1e-1 and err_t <= 1.1 * err_j, (err_t, err_j)
    b = torch.as_tensor(np.random.default_rng(6).standard_normal(
        jop.n_rows))
    x64, i64 = tkry.cg(top.matvec, b, M=h64.as_preconditioner("V"),
                       tol=1e-11, maxiter=200)
    xlo, ilo = tkry.cg(top.matvec, b, M=ht.as_preconditioner("V"),
                       tol=1e-11, maxiter=200)
    assert ilo.converged and ilo.iters <= 2 * i64.iters + 6, (ilo, i64)
    np.testing.assert_allclose(xlo.numpy(), x64.numpy(), rtol=0, atol=1e-9)


def test_vanka_bf16_blocks_invert_in_float32():
    """A Vanka-smoothed bfloat16 hierarchy (cavity, 2 levels) builds: its
    blocks are inverted in float32 and one cycle stays within bfloat16
    rounding of the float64 one (the JAX package cannot build this one:
    its host LAPACK takes no bfloat16 block inverse)."""
    _, top, _, ht = _hierarchies("ns", "vanka", 2, jax_side=False,
                                 compute_dtype=torch.bfloat16)
    _, _, _, h64 = _hierarchies("ns", "vanka", 2, jax_side=False)
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(
        top.n_rows))
    got = ht.as_preconditioner("V")(r).numpy()
    ref = h64.as_preconditioner("V")(r).numpy()
    assert np.abs(got - ref).max() < 5e-2 * np.abs(ref).max()


def test_vanka_gmres_smoother_matches_jax():
    """The Vanka sweep inside krylov_m FGMRES iterations per level, on the
    cavity Jacobian (2 levels)."""
    jop, top, hj, ht = _hierarchies("ns", "vanka_gmres", 2, krylov_m=3)
    r = np.random.default_rng(5).standard_normal(jop.n_rows)
    ref = np.asarray(hj.as_preconditioner("V")(jnp.asarray(r)))
    got = ht.as_preconditioner("V")(torch.as_tensor(r)).numpy()
    _close(got, ref, 1e-10)
    # the fine level's smoother alone, from a non-zero iterate
    b_, x_ = np.random.default_rng(9).standard_normal((2, jop.n_rows))
    _close(ht.levels[1].smoother(torch.as_tensor(b_),
                                 torch.as_tensor(x_)).numpy(),
           hj.levels[1].smoother(jnp.asarray(b_), jnp.asarray(x_)), 1e-10)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _poisson_system(pkg: str, operator: str, mg_cycle: str = "V"):
    """The set-up of tests/test_matrix_free.py: unit_box((4, 4)), 3 levels,
    -Lap u = 2 pi^2 sin(pi x) sin(pi y), GMRES to rtol 1e-10."""
    xp = jnp if pkg == "femus_tpu" else torch
    ml_mesh = _mod(pkg, "mesh.multilevel").MultiLevelMesh(
        _mod(pkg, "mesh.generation").unit_box((4, 4), "quad"), 3)
    ml_sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.initialize("u")
    ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
    ml_sol.generate_bdc("u")
    prob = _mod(pkg, "systems.problem").MultiLevelProblem(
        ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(_mod(pkg, "systems.system").LinearImplicitSystem,
                           "Poisson")
    sys_.add_unknown("u")
    sys_.set_assembly(_mod(pkg, "assembly.forms").poisson(
        "u", "biquadratic", rhs=lambda x: 2 * PI ** 2
        * xp.sin(PI * x[:, 0]) * xp.sin(PI * x[:, 1])))
    sys_.config.operator = operator
    sys_.config.mg_cycle = mg_cycle
    sys_.config.rtol = 1e-10
    if pkg == "femus_tpu":
        sys_.init()
    else:
        sys_.init(device="cpu")
    info = sys_.solve()
    return np.asarray(ml_sol.sol[-1]["u"]), info, sys_


def test_poisson_matrix_free_matches_jax():
    u_ref, info_ref, _ = _poisson_system("femus_tpu", "matrix_free")
    u, info, sys_ = _poisson_system("femus_tpu_torch", "matrix_free")
    assert info["converged"] and info["iters"] == int(info_ref["iters"])
    _close(u, u_ref, 1e-8)
    assert {"n_rows": 1089, "path": "matrix_free"} in \
        sys_.solver_info()["routing"]
    # and the port's own assembled route gives the same solution
    u_a, info_a, _ = _poisson_system("femus_tpu_torch", "assembled")
    _close(u, u_a, 1e-8)


@pytest.mark.parametrize("mg_cycle", ["W", "F", "K"])
def test_system_mg_cycles_match_jax(mg_cycle):
    """SolverConfig.mg_cycle through the system layer; "K" runs FGMRES."""
    u_ref, info_ref, _ = _poisson_system("femus_tpu", "assembled", mg_cycle)
    u, info, sys_ = _poisson_system("femus_tpu_torch", "assembled", mg_cycle)
    assert info["converged"] and info["iters"] == int(info_ref["iters"])
    _close(u, u_ref, 1e-8)
    assert sys_.solver_info()["mg_cycle"] == mg_cycle


def _ns_force(xp):
    """Body force of the manufactured solution u = sin(pi x) cos(pi y),
    v = -cos(pi x) sin(pi y), p = sin(pi x) sin(pi y) at nu = 1."""
    def force(xq):
        sx, cx = xp.sin(PI * xq[:, 0]), xp.cos(PI * xq[:, 0])
        sy, cy = xp.sin(PI * xq[:, 1]), xp.cos(PI * xq[:, 1])
        fu = 2 * PI ** 2 * sx * cy + PI * sx * cx + PI * cx * sy
        fv = -2 * PI ** 2 * cx * sy + PI * sy * cy + PI * sx * cy
        return xp.stack([fu, fv], axis=1) if xp is jnp else \
            xp.stack([fu, fv], dim=1)
    return force


def _ns_system(pkg: str):
    """The set-up of tests/test_matrix_free.py's Newton test: Q2/Q2/P1
    manufactured Navier-Stokes on unit_box((6, 6)), 2 levels,
    operator="matrix_free", smoother="vanka", GMRES(80) to rtol 1e-10."""
    xp = jnp if pkg == "femus_tpu" else torch
    ml_mesh = _mod(pkg, "mesh.multilevel").MultiLevelMesh(
        _mod(pkg, "mesh.generation").unit_box((6, 6), "quad"), 2)
    ml_sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u", "biquadratic")
    ml_sol.add_solution("v", "biquadratic")
    ml_sol.add_solution("p", "linear")

    def bc(var, x, grp, t):
        if var == "u":
            return True, float(np.sin(PI * x[0]) * np.cos(PI * x[1]))
        if var == "v":
            return True, float(-np.cos(PI * x[0]) * np.sin(PI * x[1]))
        return False, 0.0

    ml_sol.attach_bc(bc)
    for name in ("u", "v", "p"):
        ml_sol.initialize(name)
    for name in ("u", "v", "p"):
        ml_sol.generate_bdc(name)
    pnode = ml_mesh.levels[-1].dofmap("linear").nodes[0]
    px = ml_mesh.levels[-1].coords[pnode]
    ml_sol.fix_solution_at_point(
        "p", 0, float(np.sin(PI * px[0]) * np.sin(PI * px[1])))
    prob = _mod(pkg, "systems.problem").MultiLevelProblem(
        ml_mesh, ml_sol, quad_order="fifth")
    sys_ = prob.add_system(
        _mod(pkg, "systems.system").NonLinearImplicitSystem, "NS")
    sys_.add_unknown("u", "v", "p")
    sys_.set_assembly(_mod(pkg, "assembly.forms").navier_stokes(
        ("u", "v"), "p", nu=1.0, force=_ns_force(xp)))
    cfg = sys_.config
    cfg.operator = "matrix_free"
    cfg.smoother = "vanka"
    cfg.restart = 80
    cfg.max_outer = 20
    cfg.rtol = 1e-10
    cfg.nonlinear_tol = 1e-9
    if pkg == "femus_tpu":
        sys_.init()
    else:
        sys_.init(device="cpu")
    sys_.solve()
    return sys_, ml_sol, ml_mesh


def test_ns_matrix_free_newton_matches_jax():
    js, jsol, _ = _ns_system("femus_tpu")
    ts, tsol, tmesh = _ns_system("femus_tpu_torch")
    assert len(ts.history) == len(js.history)
    for a, b in zip(ts.history, js.history):
        assert a["converged"]
        # a step whose residual target is far below 1e-16 of the first one
        # iterates on rounding noise: there the count may differ by one
        noise = a["lin_target"] < 1e-12 * ts.history[0]["lin_target"]
        assert abs(a["lin_iters"] - int(b["lin_iters"])) <= int(noise)
    assert max(ts.history[-1]["eps"].values()) < 1e-9
    for name in ("u", "v", "p"):
        _close(tsol.sol[-1][name], jsol.sol[-1][name], 1e-8)
    xy = tmesh.levels[-1].node_coords_of("biquadratic")
    exact = np.sin(PI * xy[:, 0]) * np.cos(PI * xy[:, 1])
    assert np.abs(tsol.sol[-1]["u"] - exact).max() < 2e-3


def test_incompatible_pairings_raise():
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import LinearImplicitSystem

    def fresh(**config):
        ml_mesh = TMLM(tunit_box((2, 2)), 2)
        ml_sol = MultiLevelSolution(ml_mesh)
        ml_sol.add_solution("u")
        sys_ = MultiLevelProblem(ml_mesh, ml_sol).add_system(
            LinearImplicitSystem, "P")
        sys_.add_unknown("u")
        for k, v in config.items():
            setattr(sys_.config, k, v)
        return sys_

    with pytest.raises(ValueError, match="interleave_dofs"):
        fresh(operator="matrix_free", interleave_dofs=True).init(device="cpu")
    # the matrix-free step ignores coarse_op, as the reference's does (its
    # first coarse level is re-assembled, the deeper ones Galerkin); the
    # solve is held against the reference in tests/test_torch_rediscretize.py
    mf = fresh(operator="matrix_free", coarse_op="rediscretize")
    mf.init(device="cpu")
    assert all(t[2] is not None for t in mf.transfers)
    with pytest.raises(ValueError, match="galerkin"):
        fresh(coarse_op="rediscretize", interleave_dofs=True,
              operator="bell").init(device="cpu")
    with pytest.raises(ValueError, match="multiplicative vanka"):
        fresh(coarse_op="rediscretize",
              smoother="vanka_gmres").init(device="cpu")
    with pytest.raises(ValueError, match="operator"):
        fresh(operator="dense").init(device="cpu")
    with pytest.raises(ValueError, match="jacobi/chebyshev"):
        fresh(operator="patch", coarse_op="rediscretize",
              smoother="vanka_gmres").init(device="cpu")
