"""Port parity: transfers, PtAP, smoothers, Vanka, V-cycle and Krylov
solvers against femus_tpu, in float64 on the host.

Operators are handed over as numpy arrays (convert.py), so both packages
compute on the same matrix.  Index arrays built on the host must be EQUAL.
Floating-point results differ only in the order of sums: PtAP rtol 1e-12,
one smoother sweep / one V-cycle rtol 1e-10 (a batched LU per block on each
side), Krylov solutions rtol 1e-9 with equal iteration counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.algebra.krylov as jkry
import femus_tpu.algebra.mg as jmg
import femus_tpu.algebra.smoothers as jsm
import femus_tpu.algebra.transfer as jtr
import femus_tpu.algebra.vanka as jva
import femus_tpu.assembly.bc as jbc
import femus_tpu.assembly.engine as jeng
import femus_tpu.assembly.forms as jforms
import femus_tpu_torch.algebra.krylov as tkry
import femus_tpu_torch.algebra.mg as tmg
import femus_tpu_torch.algebra.smoothers as tsm
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
    else:
        a = eng.Assembler(mesh, [U("u"), U("v"), U("p", "disc_linear")],
                          interleave=True, **kw)
        a.set_volume_form(forms.navier_stokes(("u", "v"), "p",
                                              pres_family="disc_linear",
                                              nu=0.01))
        codes = bc.generate_bdc(a, _cavity_bc)
        # pin one pressure dof (the gauge), or the coarse LU is singular
        mask = np.concatenate([codes[n][0] == 0 for n in "uvp"])
        vals = np.concatenate([codes[n][1] for n in "uvp"])
        mask[a.offsets["p"]] = True
        a.set_dirichlet(mask, vals)
    return a


def _pair(problem, ns=(4, 4), levels=2):
    """(JAX assemblers, port assemblers) on every level of one hierarchy."""
    jm, tm = JMLM(junit_box(ns), levels), TMLM(tunit_box(ns), levels)
    ja = [_asm(jeng, jforms, jbc, m, problem) for m in jm.levels]
    ta = [_asm(teng, tforms, tbc, m, problem, device="cpu")
          for m in tm.levels]
    return jm, tm, ja, ta


def _operator(ja, seed=0):
    """Fine-level JAX Jacobian at a seeded state, as numpy data."""
    u = np.random.default_rng(seed).standard_normal(ja.n_dofs) * 0.3
    u = jbc.apply_dirichlet_values(ja, u)
    _, data = ja.make_assemble_fn()(jnp.asarray(u))
    return np.asarray(data)


def _masked_P(jm, tm, ja, ta, l):
    """The system-layer transfer of level l -> l+1 (physical frame, masked)
    from both packages."""
    out = []
    for tr, m, a in ((jtr, jm, ja), (ttr, tm, ta)):
        unk = a[l].unknowns
        P = tr.block_diag_prolongation(m.levels[l], m.levels[l + 1], unk)
        pf, pc = a[l + 1].stack_perm, a[l].stack_perm
        if pf is not None:
            coo = P.tocoo()
            import scipy.sparse as sp
            P = sp.csr_matrix((coo.data, (pf[coo.row], pc[coo.col])),
                              shape=P.shape)
            P.sort_indices()
        out.append(tr.mask_prolongation(P, a[l + 1].dirichlet_mask,
                                        a[l].dirichlet_mask))
    return out


@pytest.mark.parametrize("problem", ["poisson", "ns"])
def test_prolongation_and_ptap_schedule(problem):
    jm, tm, ja, ta = _pair(problem)
    Pj, Pt = _masked_P(jm, tm, ja, ta, 0)
    assert (Pj != Pt).nnz == 0
    js = jtr.build_ptap_schedule(ja[1].pattern, Pj)
    ts = ttr.build_ptap_schedule(ta[1].pattern, Pt, device="cpu")
    np.testing.assert_array_equal(np.asarray(js.src), ts.src.numpy())
    np.testing.assert_array_equal(np.asarray(js.dst), ts.dst.numpy())
    np.testing.assert_array_equal(np.asarray(js.coeff), ts.coeff.numpy())
    np.testing.assert_array_equal(js.coarse_pattern.cols,
                                  ts.coarse_pattern.cols)
    data = _operator(ja[1])
    ref = np.asarray(js.apply(jnp.asarray(data)))
    got = ts.apply(torch.as_tensor(data)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_ptap_schedule_f32_mixed_scales_exact_per_segment():
    """float32 PtAP must reduce PER SEGMENT, never by differencing a global
    prefix sum: with alternating 1e4/1e-4 row scales every float32 coarse
    slot matches the float64 result to float32 accuracy of the segment's
    own magnitude, and zero slots stay exactly zero."""
    ml = TMLM(tunit_box((2, 2)), 2)
    cm, fm = ml.levels
    asm = teng.Assembler(fm, [teng.Unknown("u")], device="cpu")
    asm.set_volume_form(tforms.poisson("u"))
    _, data = asm.make_assemble_fn()(torch.zeros(asm.n_dofs,
                                                 dtype=torch.float64))
    scale = np.where(np.arange(asm.pattern.n_rows) % 2 == 0, 1e4, 1e-4)
    data = data * torch.as_tensor(scale)[:, None]
    P = ttr.prolongation_scipy(cm, fm, "biquadratic")
    sched = ttr.build_ptap_schedule(asm.pattern, P, device="cpu")
    ref = sched.apply(data).numpy()
    got = sched.apply(data.float()).double().numpy()
    tol = 2e-5 * np.maximum(np.abs(ref),
                            np.abs(ref).max(axis=1, keepdims=True) * 1e-6)
    assert (np.abs(got - ref) <= tol + 1e-30).all(), np.abs(got - ref).max()
    assert ((ref == 0) == (got == 0)).all()


def _vanka_pair(ja, ta, data):
    jb = jva.build_element_blocks(ja, 2)
    tb = tva.build_element_blocks(ta, 2, device="cpu")
    assert jb.n_colors == tb.n_colors
    for x, y in zip(jb.color_dofs, tb.color_dofs):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    for x, y in zip(jb.color_slots, tb.color_slots):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    A_j = jeng.SparseOp(jnp.asarray(data), jnp.asarray(ja.pattern.cols),
                        ja.pattern.n_cols)
    A_t = convert.sparse_op_from_numpy(data, ta.pattern.cols,
                                       ta.pattern.n_cols, device="cpu")
    return jb, tb, A_j, A_t


@pytest.mark.parametrize("multiplicative", [True, False])
def test_vanka_sweep_matches_jax(multiplicative):
    _, _, ja, ta = _pair("ns", (8, 8), 1)
    data = _operator(ja[0])
    jb, tb, A_j, A_t = _vanka_pair(ja[0], ta[0], data)
    rng = np.random.default_rng(3)
    b, x = rng.standard_normal((2, ja[0].n_dofs))
    omega = 0.9 if multiplicative else 0.5
    ref = jva.vanka_smoother(A_j, jb, omega=omega,
                             multiplicative=multiplicative)(
        jnp.asarray(b), jnp.asarray(x))
    got = tva.vanka_smoother(A_t, tb, omega=omega,
                             multiplicative=multiplicative)(
        torch.as_tensor(b), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("kind", ["jacobi", "chebyshev"])
def test_point_smoothers_match_jax(kind):
    _, _, ja, ta = _pair("poisson", (8, 8), 1)
    data = _operator(ja[0])
    A_j = jeng.SparseOp(jnp.asarray(data), jnp.asarray(ja[0].pattern.cols),
                        ja[0].pattern.n_cols)
    A_t = convert.sparse_op_from_numpy(data, ta[0].pattern.cols,
                                       ta[0].pattern.n_cols, device="cpu")
    dj, dt = A_j.diagonal(), A_t.diagonal()
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-14)
    lj = jsm.power_lambda_max(A_j.matvec, 1.0 / dj, A_j.n_rows)
    lt = tsm.power_lambda_max(A_t.matvec, 1.0 / dt, A_t.n_rows)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)
    if kind == "jacobi":
        sj = jsm.jacobi_smoother(A_j.matvec, dj, 0.8, iters=2)
        st = tsm.jacobi_smoother(A_t.matvec, dt, 0.8, iters=2)
    else:
        sj = jsm.chebyshev_smoother(A_j.matvec, dj, lj)
        st = tsm.chebyshev_smoother(A_t.matvec, dt, lt)
    rng = np.random.default_rng(4)
    b, x = rng.standard_normal((2, A_j.n_rows))
    np.testing.assert_allclose(
        st(torch.as_tensor(b), torch.as_tensor(x)).numpy(),
        np.asarray(sj(jnp.asarray(b), jnp.asarray(x))), rtol=1e-10,
        atol=1e-12)


def _hierarchies(problem, smoother):
    """One Galerkin hierarchy from each package on the same fine data."""
    jm, tm, ja, ta = _pair(problem, (4, 4), 2)
    Pj, Pt = _masked_P(jm, tm, ja, ta, 0)
    data = _operator(ja[1])
    jop = jeng.SparseOp(jnp.asarray(data), jnp.asarray(ja[1].pattern.cols),
                        ja[1].pattern.n_cols)
    top = convert.sparse_op_from_numpy(data, ta[1].pattern.cols,
                                       ta[1].pattern.n_cols, device="cpu")
    jt = [(*jtr.op_pair_from_scipy(Pj),
           jtr.build_ptap_schedule(ja[1].pattern, Pj))]
    tt = [(*ttr.op_pair_from_scipy(Pt, device="cpu"),
           ttr.build_ptap_schedule(ta[1].pattern, Pt, device="cpu"))]
    kw = {}
    vb_j = vb_t = None
    if smoother == "vanka":
        vb_j = [jva.build_element_blocks(ja[0], 2, pattern=jt[0][2]
                                         .coarse_pattern),
                jva.build_element_blocks(ja[1], 2)]
        vb_t = [tva.build_element_blocks(ta[0], 2, pattern=tt[0][2]
                                         .coarse_pattern, device="cpu"),
                tva.build_element_blocks(ta[1], 2, device="cpu")]
    hj = jmg.build_hierarchy(jop, jt, smoother=smoother,
                             dir_masks=[jnp.asarray(ja[0].dirichlet_mask)],
                             vanka_blocks=vb_j, **kw)
    ht = tmg.build_hierarchy(top, tt, smoother=smoother,
                             dir_masks=[ta[0].dirichlet_mask],
                             vanka_blocks=vb_t, device="cpu", **kw)
    return jop, top, hj, ht


@pytest.mark.parametrize("problem,smoother", [("poisson", "chebyshev"),
                                              ("poisson", "jacobi"),
                                              ("ns", "vanka")])
def test_v_cycle_matches_jax(problem, smoother):
    _, _, hj, ht = _hierarchies(problem, smoother)
    np.testing.assert_allclose(ht.levels[0].A.data.numpy(),
                               np.asarray(hj.levels[0].A.data), rtol=1e-12,
                               atol=1e-12)
    # the LU-solved coarsest level is never smoothed: it gets no smoother
    assert ht.coarse_lu is not None and ht.levels[0].smoother is None
    r = np.random.default_rng(5).standard_normal(hj.levels[-1].A.n_rows)
    ref = np.asarray(hj.as_preconditioner("V")(jnp.asarray(r)))
    got = ht.as_preconditioner()(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("problem,smoother,outer", [
    ("poisson", "chebyshev", "cg"), ("poisson", "jacobi", "gmres"),
    ("ns", "vanka", "gmres")])
def test_krylov_matches_jax(problem, smoother, outer):
    jop, top, hj, ht = _hierarchies(problem, smoother)
    b = np.random.default_rng(6).standard_normal(jop.n_rows)
    if outer == "cg":
        xj, ij = jkry.cg(jop.matvec, jnp.asarray(b),
                         M=hj.as_preconditioner("V"), tol=1e-10,
                         maxiter=200)
        xt, it = tkry.cg(top.matvec, torch.as_tensor(b),
                         M=ht.as_preconditioner(), tol=1e-10,
                         maxiter=200)
    else:
        xj, ij = jkry.gmres(jop.matvec, jnp.asarray(b),
                            M=hj.as_preconditioner("V"), tol=1e-10,
                            restart=8, max_restarts=20)
        xt, it = tkry.gmres(top.matvec, torch.as_tensor(b),
                            M=ht.as_preconditioner(), tol=1e-10,
                            restart=8, max_restarts=20)
    assert it.converged
    assert it.iters == int(ij.iters)
    # the final residual is a difference of nearly equal vectors: its
    # relative rounding is far above the solution's
    np.testing.assert_allclose(it.residual, float(ij.residual), rtol=1e-3)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(xj)).max())
