"""Port parity of monolithic FSI (steady) and its machinery.

The JAX package (CPU, float64) against the port on the host (float64), on
inputs made from a numpy seed: the moved geometry, the solid constitutive
models, finite-strain elasticity and the FSI forms (residual AND Jacobian
data: the Jacobian carries the shape derivatives of the moved geometry),
the Petrov-Galerkin restriction and its R A P coarse operators,
material-split Vanka blocks, max_mg_levels, and the whole steady FSI
multigrid Newton solve.  Tolerances: 1e-12 for pointwise quantities,
1e-10 for assembled data and coarse operators, arrays from host set-up
code equal, solve 1e-8 (the packages sum in different orders).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import femus_tpu.assembly.engine as jeng
import femus_tpu.assembly.forms as jforms
import femus_tpu.mesh.generation as jgen
import femus_tpu_torch.assembly.engine as teng
import femus_tpu_torch.assembly.forms as tforms
import femus_tpu_torch.mesh.generation as tgen

BED = 0.25                       # solid: element centroid y < BED
FIELDS = ("dx", "dy", "u", "v", "p")


def _bed_mesh(gen, n):
    mesh = gen.unit_box((n, n), "quad")
    cent = mesh.coords[mesh.conn].mean(axis=1)
    mesh.elem_group = np.where(cent[:, 1] < BED, 1, 0).astype(np.int32)
    return mesh


def _fsi_assembler(eng, gen, form, pres_family, aux=(), **kw):
    U = eng.Unknown
    a = eng.Assembler(_bed_mesh(gen, 4),
                      [U("dx"), U("dy"), U("u"), U("v"), U("p", pres_family)],
                      interleave=True, **kw)
    a.set_volume_form(form)
    for name in aux:
        a.add_aux_field(name, "biquadratic")
    return a


def _fsi_state(a, rng, dscale=0.02):
    """Random logical state: small displacements (det F > 0 on
    unit_box((4,4)) at the default ``dscale``), O(1) velocity and pressure;
    stacked in the physical (interleaved) frame."""
    x = np.zeros(a.n_dofs)
    for name in FIELDS:
        n = a.dofmaps[name].n_dofs
        scale = dscale if name in ("dx", "dy") else 1.0
        x[a.offsets[name]:a.offsets[name] + n] = \
            scale * rng.standard_normal(n)
    phys = np.zeros(a.n_dofs)
    phys[a.stack_perm] = x
    return phys


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


# ---- moved geometry ---------------------------------------------------------

def test_moved_ops_match_jax():
    ja = jeng.Assembler(jgen.unit_box((3, 4)), [jeng.Unknown("u")])
    ta = teng.Assembler(tgen.unit_box((3, 4)), [teng.Unknown("u")],
                        device="cpu")
    jt, tt = ja.device_tables(), ta.device_tables_cached()
    rng = np.random.default_rng(11)
    ne = ta.mesh.n_elems
    disp = 0.03 * rng.standard_normal((9, 2, ne))
    jops = jeng.ElemOpsBatched(jt["tabs"], jt["qweights"], jnp.transpose(
        jt["coords_e"], (1, 2, 0)), 2).moved(jnp.asarray(disp))
    tops = teng.ElemOpsBatched(tt["tabs"], tt["qweights"],
                               tt["coords_e"].permute(1, 2, 0), 2
                               ).moved(torch.as_tensor(disp))
    _close(tops.wdet.numpy(), jops.wdet, 1e-12)
    _close(tops.x.numpy(), jops.x, 1e-12)
    f = rng.standard_normal((9, ne))
    _close(tops.value("biquadratic", torch.as_tensor(f)).numpy(),
           jops.value("biquadratic", jnp.asarray(f)), 1e-12)
    _close(tops.grad("biquadratic", torch.as_tensor(f)).numpy(),
           jops.grad("biquadratic", jnp.asarray(f)), 1e-12)
    s = rng.standard_normal((tops.wdet.shape[0], ne))
    _close(tops.tgrad_d("biquadratic", torch.as_tensor(s), 1).numpy(),
           jops.tgrad_d("biquadratic", jnp.asarray(s), 1), 1e-12)
    # the displacement really moves the geometry
    rest = teng.ElemOpsBatched(tt["tabs"], tt["qweights"],
                               tt["coords_e"].permute(1, 2, 0), 2)
    assert float((rest.wdet - tops.wdet).abs().max()) > 1e-4


# ---- constitutive models ----------------------------------------------------

@pytest.mark.parametrize("model", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("dim", [2, 3])
def test_constitutive_models_match_jax(model, dim):
    import femus_tpu.systems.constitutive as jc
    import femus_tpu_torch.systems.constitutive as tc

    rng = np.random.default_rng(100 + 10 * model + dim)
    G = 0.2 * rng.standard_normal((4, dim, dim, 6))
    p = rng.standard_normal((4, 6))
    for pq, inc in ((None, True), (p, True), (p, False)):
        args_j = (jnp.asarray(G), 1.3, 0.7,
                  None if pq is None else jnp.asarray(pq), inc)
        args_t = (torch.as_tensor(G), 1.3, 0.7,
                  None if pq is None else torch.as_tensor(pq), inc)
        _close(tc.cauchy_stress(model, *args_t).numpy(),
               jc.cauchy_stress(model, *args_j), 1e-12)
        _close(tc.first_piola(model, *args_t).numpy(),
               jc.first_piola(model, *args_j), 1e-12)
    names = [k for k, v in tc.MODEL_IDS.items() if v == model]
    assert tc.MODEL_IDS == jc.MODEL_IDS and names
    _close(tc.cauchy_stress(names[-1].upper(), torch.as_tensor(G), 1.3,
                            0.7).numpy(),
           jc.cauchy_stress(names[-1], jnp.asarray(G), 1.3, 0.7), 1e-12)


# ---- finite-strain elasticity -----------------------------------------------

@pytest.mark.parametrize("model,pres,incompressible", [
    ("saint-venant", None, False), ("neo-hookean", None, False),
    ("neo-hookean-bw", None, False), ("mooney-rivlin", None, False),
    ("neo-hookean", "p", True), ("saint-venant", "p", False),
    ("linear", "p", False), ("neo-hookean-ab-penalty", "p", True)])
def test_elasticity_models_assembly_matches_jax(model, pres, incompressible):
    def build(eng, forms, gen, **kw):
        U = eng.Unknown
        unk = [U("dx"), U("dy")] + ([U("p", "linear")] if pres else [])
        a = eng.Assembler(gen.unit_box((3, 3)), unk, **kw)
        a.set_volume_form(forms.elasticity(
            ("dx", "dy"), model=model, lam=1.7, mu=0.9, pres=pres,
            incompressible=incompressible,
            force=lambda x: 0.5 * x + 0.1))
        return a

    ja = build(jeng, jforms, jgen)
    ta = build(teng, tforms, tgen, device="cpu")
    rng = np.random.default_rng(5)
    u = 0.01 * rng.standard_normal(ja.n_dofs)     # det F > 0
    R1, D1 = ja.make_assemble_fn()(jnp.asarray(u))
    R2, D2 = ta.make_assemble_fn()(torch.as_tensor(u))
    _close(R2.numpy(), R1, 1e-10)
    _close(D2.numpy(), D1, 1e-10)


# ---- FSI forms ----------------------------------------------------------------

def _fsi_forms(pkg):
    return importlib.import_module(f"{pkg}.systems.fsi")


@pytest.mark.parametrize("pres_family", ["disc_linear", "linear"])
@pytest.mark.parametrize("variant", [
    "steady", "steady-sv-incompressible", "transient", "transient-cn"])
def test_fsi_form_assembly_matches_jax(variant, pres_family):
    """R and Jacobian data of the FSI forms at a random state on
    unit_box((4,4)) (one solid element row), with random '_old' aux fields
    for the transient forms; plus the port's Jacobian against a central
    difference of its residual (the shape derivatives of the moved
    geometry are in it)."""
    aux = ()
    kw = dict(solid_groups=(1,), pres_family=pres_family, nu=0.05,
              lam=50.0, mu=50.0, force=lambda x: 0.3 * x)
    if variant.startswith("steady"):
        make = "fsi_steady_form"
        if variant == "steady-sv-incompressible":
            kw.update(solid_model="saint-venant", incompressible_solid=True)
    else:
        make = "fsi_transient_form"
        kw.update(rho_f=1.2, rho_s=0.8,
                  theta=0.5 if variant == "transient-cn" else 1.0)
        aux = ("dx_old", "dy_old", "u_old", "v_old")
    ja = _fsi_assembler(jeng, jgen, getattr(_fsi_forms("femus_tpu"), make)(
        **kw), pres_family, aux)
    ta = _fsi_assembler(teng, tgen, getattr(_fsi_forms("femus_tpu_torch"),
                                            make)(**kw),
                        pres_family, aux, device="cpu")
    np.testing.assert_array_equal(ja.pattern.cols, ta.pattern.cols)
    np.testing.assert_array_equal(ja.slots, ta.slots)
    rng = np.random.default_rng(17)
    u = _fsi_state(ta, rng)
    nq = ta.mesh.dofmap("biquadratic").n_dofs
    fields = {k: (0.02 if k.startswith("d") else 1.0)
              * rng.standard_normal(nq) for k in aux}
    scal = {"dt": 0.05}
    R1, D1 = ja.make_assemble_fn()(jnp.asarray(u), {
        k: jnp.asarray(v) for k, v in fields.items()}, scal)
    asm = ta.make_assemble_fn()
    tfields = {k: torch.as_tensor(v) for k, v in fields.items()}
    R2, D2 = asm(torch.as_tensor(u), scal, tfields)
    _close(R2.numpy(), R1, 1e-10)
    _close(D2.numpy(), D1, 1e-10)
    # the Jacobian is the derivative of the residual (interior rows)
    v = rng.standard_normal(ta.n_dofs)
    v[ta.dirichlet_mask] = 0.0
    h = 1e-6
    Rp, _ = asm(torch.as_tensor(u + h * v), scal, tfields)
    Rm, _ = asm(torch.as_tensor(u - h * v), scal, tfields)
    fd = ((Rp - Rm) / (2 * h)).numpy()
    Jv = ta.op_with(D2).matvec(torch.as_tensor(v)).numpy()
    free = ~ta.dirichlet_mask
    np.testing.assert_allclose(Jv[free], fd[free], rtol=1e-6,
                               atol=1e-6 * np.abs(fd).max())


# ---- the FSI problem through the systems layer ---------------------------------

def _bc(lid):
    def bc(var, x, grp, t):
        if var == "p":
            return (False, 0.0)
        if var in ("dx", "dy"):
            return (True, 0.0)
        if var == "u" and grp == 4:
            return (True, lid)
        return (True, 0.0)
    return bc


def fsi_problem(pkg, n=4, levels=2, lid=1.0, pres_family="disc_linear",
                **config):
    """fsi-bed at a small size in either package: lid-driven flow over an
    elastic bed (y < 0.25), neo-Hookean lam = mu = 50, nu = 0.01, pairs
    u->dx, v->dy, material Vanka, F ratchet, K-cycle, interleaved dofs."""

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    gen = jgen if pkg == "femus_tpu" else tgen
    ml_mesh = mod("mesh.multilevel").MultiLevelMesh(_bed_mesh(gen, n),
                                                    levels)
    ml_sol = mod("systems.solution").MultiLevelSolution(ml_mesh)
    for v in ("dx", "dy", "u", "v"):
        ml_sol.add_solution(v, "biquadratic")
    ml_sol.add_solution("p", pres_family)
    ml_sol.attach_bc(_bc(lid))
    for v in FIELDS:
        ml_sol.initialize(v)
    ml_sol.generate_bdc()
    ml_sol.fix_solution_at_point("p", 0, 0.0)
    ml_sol.pair_solution("u", "dx")
    ml_sol.pair_solution("v", "dy")
    prob = mod("systems.problem").MultiLevelProblem(ml_mesh, ml_sol,
                                                    quad_order="fifth")
    fsi = mod("systems.fsi")
    sys_ = prob.add_system(fsi.MonolithicFSISystem, "FSI")
    sys_.solid_groups = (1,)
    sys_.add_unknown(*FIELDS)
    sys_.set_assembly(fsi.fsi_steady_form(
        ("dx", "dy"), ("u", "v"), "p", solid_groups=(1,),
        pres_family=pres_family, nu=0.01, lam=50.0, mu=50.0,
        solid_model="neo-hookean"))
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
    cfg.max_nonlinear = 8
    cfg.nonlinear_tol = 1e-8
    for k, v in config.items():
        setattr(cfg, k, v)
    if pkg == "femus_tpu":
        sys_.init()
    else:
        sys_.init(device="cpu")
    return sys_, ml_sol


@pytest.fixture(scope="module")
def systems():
    js, jsol = fsi_problem("femus_tpu")
    ts, tsol = fsi_problem("femus_tpu_torch")
    return js, jsol, ts, tsol


def _jax_frame_pair(js, l):
    P, R = js._make_transfer_pair(l)
    pf, pc = js.assemblers[l + 1].stack_perm, js.assemblers[l].stack_perm
    return js._permute_transfer(P, pf, pc), js._permute_transfer(R, pc, pf)


def _assert_csr_equal(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    a.sort_indices()
    b.sort_indices()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def test_fsi_restriction_matches_jax(systems):
    """R^T in the block layout equals the JAX package's; with pairs it
    differs from P (entries moved across blocks and dropped); in the
    interleaved frame R is permuted with the coarse permutation on its
    rows and the fine one on its columns, masked with the masks swapped."""
    from femus_tpu.algebra.transfer import \
        fsi_restriction_transpose as jfrt
    from femus_tpu.algebra.transfer import mask_prolongation as jmask
    from femus_tpu_torch.algebra.transfer import \
        fsi_restriction_transpose as tfrt
    from femus_tpu_torch.algebra.transfer import mask_prolongation as tmask

    js, _, ts, tsol = systems
    cm, fm = ts.ml_mesh.levels
    jcm, jfm = js.ml_mesh.levels
    pairs = {"u": "dx", "v": "dy"}
    for groups in ((1,), ()):
        ref = jfrt(jcm, jfm, js.unknowns, pairs, groups)
        got = tfrt(cm, fm, ts.unknowns, pairs, groups)
        _assert_csr_equal(got, ref)
    P, _ = ts._make_transfer_pair(0)
    Rt = tfrt(cm, fm, ts.unknowns, pairs, (1,))
    assert (abs(Rt - P) > 0).nnz > 0
    assert tsol.pairs == pairs
    # the interleaved frame, unmasked and masked
    Pj, Rj = _jax_frame_pair(js, 0)
    Pt, Rt = ts._physical_pair(0)
    _assert_csr_equal(Pt, Pj)
    _assert_csr_equal(Rt, Rj)
    assert Rt.shape == (ts.assemblers[0].n_dofs, ts.assemblers[1].n_dofs)
    _assert_csr_equal(tmask(Rt, ts.masks[0], ts.masks[1]),
                      jmask(Rj, js.masks[0], js.masks[1]))
    np.testing.assert_array_equal(ts.masks[0], js.masks[0])


def test_rap_coarse_operators_match_jax(systems):
    """The R A P schedule's coarse operators from the same fine Jacobian:
    coarse patterns equal, coarse data to 1e-10, and the restriction
    operator R of the cycle."""
    js, _, ts, _ = systems
    a = ts.assemblers[-1]
    u = _fsi_state(a, np.random.default_rng(3), dscale=0.002)
    _, D1 = js.assemblers[-1].make_assemble_fn()(jnp.asarray(u))
    _, D2 = a.make_assemble_fn()(torch.as_tensor(u))
    assert np.isfinite(np.asarray(D1)).all()
    jsched, tsched = js.transfers[0][2], ts.transfers[0][2]
    np.testing.assert_array_equal(jsched.coarse_pattern.cols,
                                  tsched.coarse_pattern.cols)
    _close(tsched.apply(D2).numpy(), jsched.apply(D1), 1e-10)
    # the cycle restricts with R, which is not P^T
    from femus_tpu_torch.algebra.transfer import mask_prolongation
    Rop = ts.transfers[0][1]
    x = np.random.default_rng(4).standard_normal(a.n_dofs)
    Rx = (Rop @ torch.as_tensor(x)).numpy()
    _close(Rx, js.transfers[0][1] @ jnp.asarray(x), 1e-12)
    Pm = mask_prolongation(ts._physical_pair(0)[0], ts.masks[1], ts.masks[0])
    assert np.abs(Rx - Pm.T @ x).max() > 1e-6


@pytest.mark.parametrize("groups", [None, "material", (1,), (0,)])
@pytest.mark.parametrize("filtered", [False, True])
def test_material_vanka_blocks_match_jax(systems, groups, filtered):
    from femus_tpu.algebra.vanka import build_element_blocks as jbeb
    from femus_tpu_torch.algebra.vanka import build_element_blocks as tbeb

    js, _, ts, _ = systems
    ja, ta = js.assemblers[-1], ts.assemblers[-1]
    filt = None
    if filtered:   # velocity and pressure rows only (a field split)
        logical = np.zeros(ta.n_dofs, bool)
        logical[ta.offsets["u"]:] = True
        filt = np.zeros(ta.n_dofs, bool)
        filt[ta.stack_perm] = logical
    jb = jbeb(ja, 2, dof_filter=filt, groups=groups)
    tb = tbeb(ta, 2, dof_filter=filt, groups=groups, device="cpu")
    assert tb.n_colors == jb.n_colors and tb.n == jb.n
    for a, b in zip(tb.color_dofs, jb.color_dofs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tb.color_slots, jb.color_slots):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tb.scale.numpy(), np.asarray(jb.scale))
    if groups == "material":
        # no block spans the fluid/solid interface's two element groups
        eg = ta.mesh.elem_group
        ed = ta.edofs
        for d in torch.cat(tb.color_dofs).numpy():
            d = d[d < tb.n]
            touch = {int(g) for g in eg[np.isin(ed, d).all(axis=1)]}
            assert len(touch) <= 1


def test_vanka_groups_reject_unknown_mode(systems):
    from femus_tpu_torch.algebra.vanka import build_element_blocks
    with pytest.raises(ValueError):
        build_element_blocks(systems[2].assemblers[-1], 2, groups="fluid",
                             device="cpu")


def test_zero_forcing_gives_zero_solution():
    ts, tsol = fsi_problem("femus_tpu_torch", levels=1, lid=0.0,
                           mg_type="V", use_mg=False, mg_cycle="V")
    ts.solve()
    for v in ("dx", "dy", "u", "v"):
        assert np.abs(tsol.sol[-1][v]).max() < 1e-9, v


def test_steady_fsi_mg_solve_matches_jax(systems):
    """Steady FSI, n=4, 2 levels, pairs, material Vanka, F ratchet,
    K-cycle FGMRES, operator="bell" in both packages: equal Newton steps,
    FGMRES iterations within 1, solution to 1e-8."""
    js, jsol, ts, tsol = systems
    js.solve()
    ts.solve()
    assert len(ts.history) == len(js.history)
    for a, b in zip(ts.history, js.history):
        assert a["level"] == b["level"]
        assert abs(a["lin_iters"] - int(b["lin_iters"])) <= 1
        assert a["converged"]
    for name in FIELDS:
        _close(tsol.sol[-1][name], jsol.sol[-1][name], 1e-8)
    sol = tsol.sol[-1]
    assert np.abs(sol["u"]).max() == pytest.approx(1.0)
    assert np.abs(sol["dx"]).max() > 1e-6           # the bed is dragged
    # the coarsest level is LU-solved; K-cycle => flexible outer solve
    assert any(r["path"] == "lu" for r in ts.solver_info()["routing"])


def test_fsi_operator_on_the_bell_frame():
    """A 16x16 FSI Jacobian (5,124 rows, rows of 39-112 entries) through
    the sliced-ELL frame operator: the frame matvec (B1's plain version
    here) equals the ELL matvec, and the plan's fill is reported."""
    from femus_tpu_torch.algebra.bell import bell_backed

    ts, _ = fsi_problem("femus_tpu_torch", n=16, levels=1, use_mg=False,
                        mg_type="V")
    a = ts.assemblers[-1]
    counts = a.pattern.valid.sum(axis=1)
    assert counts.min() == 39 and counts.max() == 112
    u = _fsi_state(a, np.random.default_rng(9), dscale=0.002)
    _, data = a.make_assemble_fn()(torch.as_tensor(u))
    assert bool(torch.isfinite(data).all())
    dev = ts._bell_dev(a.pattern)
    op = bell_backed(dev, a.op_with(data))
    x = torch.as_tensor(np.random.default_rng(10).standard_normal(a.n_dofs))
    ref = a.op_with(data).matvec(x)
    # rounding budget of a reordered sum: 1e-12 of max(|A| |x|)
    scale = float(a.op_with(data.abs()).matvec(x.abs()).max())
    assert float((op.matvec(x) - ref).abs().max()) <= 1e-12 * scale
    note = [r for r in ts.solver_info()["routing"]
            if r["n_rows"] == a.n_dofs][0]
    assert note["path"] == "bell" and 1.0 <= note["fill"] < 1.5


def test_max_mg_levels_matches_jax():
    """A 3-level Poisson MG-CG whose cycle is cut to the top 2 levels
    (max_mg_levels=2); the truncated coarsest level is smoothed (above
    coarse_dense_max_dofs) in one case and LU-solved in the other."""
    def run(pkg, dense_max):
        def mod(name):
            return importlib.import_module(f"{pkg}.{name}")
        xp = jnp if pkg == "femus_tpu" else torch
        gen = jgen if pkg == "femus_tpu" else tgen
        ml_mesh = mod("mesh.multilevel").MultiLevelMesh(gen.unit_box((2, 2)),
                                                        3)
        ml_sol = mod("systems.solution").MultiLevelSolution(ml_mesh)
        ml_sol.add_solution("u")
        ml_sol.initialize("u")
        ml_sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
        ml_sol.generate_bdc("u")
        prob = mod("systems.problem").MultiLevelProblem(ml_mesh, ml_sol)
        s = prob.add_system(mod("systems.system").LinearImplicitSystem, "P")
        s.add_unknown("u")
        s.set_assembly(mod("assembly.forms").poisson(
            "u", rhs=lambda x: 1.0 + 0.0 * xp.sin(x[:, 0])))
        s.config.outer = "cg"
        s.config.rtol = 1e-10
        s.config.max_mg_levels = 2
        s.config.coarse_dense_max_dofs = dense_max
        if pkg == "femus_tpu":
            s.init()
        else:
            s.init(device="cpu")
        info = s.solve()
        return np.array(ml_sol.sol[-1]["u"]), int(info["iters"])

    for dense_max in (10, 20000):
        u_ref, it_ref = run("femus_tpu", dense_max)
        u, it = run("femus_tpu_torch", dense_max)
        assert it == it_ref
        _close(u, u_ref, 1e-8)
