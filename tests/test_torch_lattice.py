"""Port parity, slice 3: the lattice operator path (DIA and 2-D stencil
formats, scatter-free lattice assembly, condition estimate) against
femus_tpu, in float64 on the host.

Host-built index arrays and plans must be EQUAL.  Assembled values differ
only in the order of sums (1e-14 relayouts, 1e-11 assembly).  The plain
PyTorch versions of kernels B4 (DIA) and B3 (stencil) are held against the
JAX package's Pallas kernels run in interpret mode, as its own tests run
them on the CPU: 1e-12 in float64, 1e-5 in float32, scaled by max|y|.
"""
import unittest.mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import femus_tpu.algebra.condest as jcond
import femus_tpu.algebra.dia as jdia
import femus_tpu.algebra.krylov as jkry
import femus_tpu.algebra.smoothers as jsm
import femus_tpu.algebra.stencil as jst
import femus_tpu.assembly.bc as jbc
import femus_tpu.assembly.engine as jeng
import femus_tpu.assembly.forms as jforms
import femus_tpu.assembly.lattice as jlat
import femus_tpu_torch.algebra.condest as tcond
import femus_tpu_torch.algebra.dia as tdia
import femus_tpu_torch.algebra.krylov as tkry
import femus_tpu_torch.algebra.smoothers as tsm
import femus_tpu_torch.algebra.stencil as tst
import femus_tpu_torch.assembly.bc as tbc
import femus_tpu_torch.assembly.engine as teng
import femus_tpu_torch.assembly.forms as tforms
import femus_tpu_torch.assembly.lattice as tlat
from femus_tpu.mesh.generation import unit_box as junit_box
from femus_tpu_torch import convert
from femus_tpu_torch.mesh.generation import unit_box as tunit_box

PI = np.pi


def _forms(kind: str, family: str):
    """The same weak form for both packages: (JAX form, port form)."""
    if kind == "poisson":
        return (jforms.poisson("u", family,
                               rhs=lambda x: jnp.sin(3 * x[:, 0]) + x[:, 1]),
                tforms.poisson("u", family,
                               rhs=lambda x: torch.sin(3 * x[:, 0]) + x[:, 1]))
    if kind == "sine":        # -Lap u = 2 pi^2 sin(pi x) sin(pi y)
        return (jforms.poisson("u", family, rhs=lambda x: 2 * PI ** 2
                               * jnp.sin(PI * x[:, 0]) * jnp.sin(PI * x[:, 1])),
                tforms.poisson("u", family, rhs=lambda x: 2 * PI ** 2
                               * torch.sin(PI * x[:, 0])
                               * torch.sin(PI * x[:, 1])))
    if kind == "nonlinear_diffusion":
        return (jforms.nonlinear_diffusion("u", family),
                tforms.nonlinear_diffusion("u", family))
    assert kind == "helmholtz"             # poisson + 2.5 * mass
    jp, jm = jforms.poisson("u", family), jforms.mass("u", family, 2.5)
    tp, tm = tforms.poisson("u", family), tforms.mass("u", family, 2.5)
    return (lambda o, u, a: {"u": jp(o, u, a)["u"] + jm(o, u, a)["u"]},
            lambda o, u, a: {"u": tp(o, u, a)["u"] + tm(o, u, a)["u"]})


def _pair(n: int, kind: str = "poisson", family: str = "biquadratic",
          geom: str = "quad"):
    """(JAX assembler, port assembler) of one all-Dirichlet n x n box."""
    jform, tform = _forms(kind, family)
    ja = jeng.Assembler(junit_box((n, n), geom), [jeng.Unknown("u", family)],
                        quad_order="fifth")
    ja.set_volume_form(jform)
    jbc.generate_bdc(ja, lambda var, x, grp, t: (True, 0.0))
    ta = teng.Assembler(tunit_box((n, n), geom), [teng.Unknown("u", family)],
                        quad_order="fifth", device="cpu")
    ta.set_volume_form(tform)
    tbc.generate_bdc(ta, lambda var, x, grp, t: (True, 0.0))
    return ja, ta


def _state(ja, seed: int, scale: float) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, scale, ja.n_dofs)


def _generic(ja, ta, u):
    """(JAX (R, data), port (R, data)) of the generic ELL assembly at u."""
    uj = jnp.zeros(ja.n_dofs_pad).at[:ja.n_dofs].set(jnp.asarray(u))
    return (ja.make_assemble_fn()(uj),
            ta.make_assemble_fn()(torch.as_tensor(u)))


def _interpret():
    """Run pl.pallas_call in interpret mode, as the JAX package's own CPU
    tests of its kernels do."""
    orig = pl.pallas_call
    return unittest.mock.patch.object(
        pl, "pallas_call", lambda *a, **k: orig(*a, interpret=True, **k))


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("n", [4, 7])
def test_dia_plan_relayout_and_stencil_equal(n):
    ja, ta = _pair(n)
    (_, dj), (_, dt) = _generic(ja, ta, _state(ja, 0, 0.3))
    pj = jdia.build_dia_plan(ja.pattern, max_diags=64)
    pt = tdia.build_dia_plan(ta.pattern, max_diags=64)
    assert pj.offsets == pt.offsets and len(pt.offsets) == 25
    np.testing.assert_array_equal(pj.src, pt.src)
    Dj = pj.apply(dj, ja.pattern.n_rows)
    Dt = pt.apply(dt, ta.pattern.n_rows)
    assert Dt.n_rows == Dj.n_rows == ta.n_dofs
    _close(Dt.data.numpy(), Dj.data, 1e-14)
    _close(Dt.diagonal().numpy(), Dj.diagonal(), 1e-14)
    Sj = jst.build_stencil(Dj, 2 * n + 1)
    St = tst.build_stencil(Dt, 2 * n + 1)
    assert St.offsets == Sj.offsets and St.grid == Sj.grid
    N, M = St.grid
    # the port stores the logical block, the JAX package pads it to tiles
    assert tuple(St.data.shape) == (25, N, M)
    _close(St.data.numpy(), np.asarray(Sj.data)[:, :N, :M], 1e-14)
    assert St.data.data_ptr() == Dt.data.data_ptr()      # a view, no copy
    x = np.random.default_rng(1).standard_normal(ta.n_dofs)
    _close((St @ torch.as_tensor(x)).numpy(), Sj @ jnp.asarray(x), 1e-13)
    _close((Dt @ torch.as_tensor(x)).numpy(), Dj @ jnp.asarray(x), 1e-13)
    # carried across from the JAX objects as numpy arrays
    Dc = convert.dia_op_from_numpy(np.asarray(Dj.data), Dj.offsets, Dj.n,
                                   device="cpu")
    Sc = convert.stencil_op_from_numpy(np.asarray(Sj.data), Sj.offsets,
                                       Sj.grid, device="cpu")
    assert tuple(Sc.data.shape) == (25, N, M) and Sc.data.is_contiguous()
    _close((Dc @ torch.as_tensor(x)).numpy(), Dj @ jnp.asarray(x), 1e-13)
    _close((Sc @ torch.as_tensor(x)).numpy(), Sj @ jnp.asarray(x), 1e-13)


@pytest.mark.parametrize("case,dtype,rtol", [
    ("assembled", np.float64, 1e-12), ("random", np.float64, 1e-12),
    ("random", np.float32, 1e-5), ("single", np.float64, 1e-12)])
def test_plain_dia_matches_pallas_kernel(case, dtype, rtol):
    """Plain B4 against spmv_dia_pallas (interpret mode).  Random data
    shows the flattened form's wrap across lattice rows; "single" has one
    negative offset."""
    if case == "assembled":
        ja, ta = _pair(4)
        (_, dj), _ = _generic(ja, ta, _state(ja, 0, 0.3))
        Dj = jdia.build_dia_plan(ja.pattern, 64).apply(dj, ja.pattern.n_rows)
        data, offs, n = np.asarray(Dj.data), Dj.offsets, Dj.n
    else:
        n, offs = {"random": (1024, (-33, -1, 0, 1, 33)),
                   "single": (700, (-5,))}[case]
        data = np.random.default_rng(1).normal(size=(len(offs), n))
    data = data.astype(dtype)
    x = np.random.default_rng(2).normal(size=n).astype(dtype)
    with _interpret():
        ref = np.asarray(jdia.spmv_dia_pallas(
            jdia.DiaOp(jnp.asarray(data), offs, n), jnp.asarray(x), tile=256))
    op = convert.dia_op_from_numpy(data, offs, n, device="cpu")
    got = op.matvec(torch.as_tensor(x))
    assert got.dtype == torch.as_tensor(x).dtype and got.shape == (n,)
    _close(got.numpy(), ref, rtol)


@pytest.mark.parametrize("case,dtype,rtol", [
    ("assembled", np.float64, 1e-12), ("assembled", np.float32, 1e-5),
    ("random", np.float64, 1e-12)])
def test_plain_stencil_matches_pallas_kernel(case, dtype, rtol):
    """Plain B3 against spmv_stencil_pallas (interpret mode).  Random data
    on a non-square lattice with offsets out to the kernel's halo shows
    that x reads zero wherever i+di or j+dj leaves the lattice."""
    if case == "assembled":
        ja, ta = _pair(4)
        (_, dj), _ = _generic(ja, ta, _state(ja, 0, 0.3))
        Dj = jdia.build_dia_plan(ja.pattern, 64).apply(dj, ja.pattern.n_rows)
        Sj = jst.build_stencil(Dj, 9, rows_per_tile=8)
        Sj = jst.StencilOp(Sj.data.astype(dtype), Sj.offsets, Sj.grid)
    else:
        grid, offs = (11, 19), ((-8, -8), (-8, 8), (-1, 0), (0, -3), (0, 0),
                                (0, 1), (2, -5), (8, -8), (8, 8))
        data = np.zeros((len(offs), 16, 128), dtype)     # the JAX tiling
        data[:, :11, :19] = np.random.default_rng(3).normal(
            size=(len(offs),) + grid)
        Sj = jst.StencilOp(jnp.asarray(data), offs, grid)
    x = np.random.default_rng(4).normal(size=Sj.n_rows).astype(dtype)
    with _interpret():
        ref = np.asarray(jst.spmv_stencil_pallas(Sj, jnp.asarray(x),
                                                 rows_per_tile=8))
    _close(np.asarray(Sj @ jnp.asarray(x)), ref, rtol)
    op = convert.stencil_op_from_numpy(np.asarray(Sj.data), Sj.offsets,
                                       Sj.grid, device="cpu")
    got = op.matvec(torch.as_tensor(x))
    assert got.dtype == torch.as_tensor(x).dtype
    _close(got.numpy(), ref, rtol)


def test_build_stencil_rejects_what_is_no_lattice():
    ja, ta = _pair(4)
    _, (_, dt) = _generic(ja, ta, _state(ja, 0, 0.3))
    D = tdia.build_dia_plan(ta.pattern, 64).apply(dt, ta.n_dofs)
    assert tst.build_stencil(D, 9) is not None
    assert tst.build_stencil(D, 10) is None               # indivisible
    assert tst.build_stencil(D, 3, max_halo=2) is None    # no decomposition
    assert tst.build_stencil(D, 0) is None
    assert tdia.build_dia_plan(ta.pattern, max_diags=24) is None


@pytest.mark.parametrize("family", ["linear", "biquadratic"])
def test_lattice_plan_fields_equal(family):
    ja, ta = _pair(5, family=family)
    pj, pt = jlat.build_lattice_plan(ja), tlat.build_lattice_plan(ta)
    assert pt is not None
    for f in ("grid", "egrid", "s", "offsets"):
        assert getattr(pt, f) == getattr(pj, f), f
    for f in ("a", "b", "kij"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))


def test_lattice_plan_is_none_off_the_lattice():
    _, ta = _pair(3, geom="tri")
    assert tlat.build_lattice_plan(ta) is None
    two = teng.Assembler(tunit_box((3, 3)), [teng.Unknown("u"),
                                             teng.Unknown("v")], device="cpu")
    assert tlat.build_lattice_plan(two) is None


@pytest.mark.parametrize("kind,family,n,scale", [
    ("poisson", "linear", 5, 0.3), ("poisson", "biquadratic", 5, 0.3),
    ("nonlinear_diffusion", "biquadratic", 4, 0.2),
    ("helmholtz", "biquadratic", 4, 0.3)])
def test_lattice_assembly_matches_jax(kind, family, n, scale):
    """(R, S) of the scatter-free assembly at a non-zero state against the
    JAX package's, and against the port's own generic ELL route."""
    ja, ta = _pair(n, kind, family)
    u = _state(ja, 3, scale)
    pj, pt = jlat.build_lattice_plan(ja), tlat.build_lattice_plan(ta)
    uj = jnp.zeros(ja.n_dofs_pad).at[:ja.n_dofs].set(jnp.asarray(u))
    Rj, Sj = jlat.make_lattice_assemble_fn(ja, pj)(uj, ja.device_tables())
    Rt, St = tlat.make_lattice_assemble_fn(ta, pt)(
        torch.as_tensor(u), ta.device_tables_cached())
    N, M = St.grid
    assert St.offsets == Sj.offsets and St.grid == Sj.grid
    assert Rt.shape == (ta.n_dofs,) and St.data.is_contiguous()
    _close(Rt.numpy(), np.asarray(Rj)[:ta.n_dofs], 1e-11)
    _close(St.data.numpy(), np.asarray(Sj.data)[:, :N, :M], 1e-11)
    _, (Rg, dg) = _generic(ja, ta, u)
    _close(Rt.numpy(), Rg.numpy(), 1e-11)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(ta.n_dofs))
    _close((St @ x).numpy(), (ta.op_with(dg) @ x).numpy(), 1e-11)


def test_cond_2norm_matches_jax():
    ja, ta = _pair(4)
    (_, dj), (_, dt) = _generic(ja, ta, np.zeros(ja.n_dofs))
    Dj = jdia.build_dia_plan(ja.pattern).apply(dj, ja.pattern.n_rows)
    Dt = tdia.build_dia_plan(ta.pattern).apply(dt, ta.n_dofs)
    ref = jcond.cond_2norm(Dj)
    got = tcond.cond_2norm(Dt)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    dense = ta.op_with(dt).to_dense().numpy()
    sv = np.linalg.svd(dense, compute_uv=False)
    np.testing.assert_allclose(got[1:], (sv[0], sv[-1]), rtol=1e-3)


def _sweep(matvec, x, steps, maxabs):
    for _ in range(steps):
        w = matvec(x)
        x = w / maxabs(w)
    return x


def test_lattice_slice_matches_jax():
    """The slice as a whole at n = 8: set-up by both routes, the 10-step
    normalised power sweep through the stencil, DIA and ELL operators, and
    the Chebyshev-preconditioned CG solve of -Lap u = 2 pi^2 sin sin, as
    the same composition of each package's functions (1e-8, equal
    iteration counts)."""
    n = 8
    ja, ta = _pair(n, "sine")
    zero = np.zeros(ja.n_dofs)
    (_, dj), (_, dt) = _generic(ja, ta, zero)
    Aj, At = ja.op_with(dj), ta.op_with(dt)
    Dj = jdia.build_dia_plan(ja.pattern, 64).apply(dj, ja.pattern.n_rows)
    Dt = tdia.build_dia_plan(ta.pattern, 64).apply(dt, ta.n_dofs)
    Sj, St = jst.build_stencil(Dj, 2 * n + 1), tst.build_stencil(Dt, 2 * n + 1)
    Rj, Sj2 = jlat.make_lattice_assemble_fn(
        ja, jlat.build_lattice_plan(ja))(jnp.asarray(zero),
                                         ja.device_tables())
    Rt, St2 = tlat.make_lattice_assemble_fn(
        ta, tlat.build_lattice_plan(ta))(torch.as_tensor(zero),
                                         ta.device_tables_cached())
    nd = ta.n_dofs
    for oj, ot in ((Sj, St), (Dj, Dt), (Aj, At), (Sj2, St2)):
        ref = _sweep(oj.matvec, jnp.ones(nd), 10, lambda w: jnp.abs(w).max())
        got = _sweep(ot.matvec, torch.ones(nd, dtype=torch.float64), 10,
                     lambda w: w.abs().max())
        _close(got.numpy(), ref, 1e-8)
    # Chebyshev-CG with each package's own pieces
    lj = jsm.power_lambda_max(Sj2.matvec, 1.0 / Dj.diagonal(), nd)
    lt = tsm.power_lambda_max(St2.matvec, 1.0 / Dt.diagonal(), nd)
    smj = jsm.chebyshev_smoother(Sj2.matvec, Dj.diagonal(), lj, degree=3)
    smt = tsm.chebyshev_smoother(St2.matvec, Dt.diagonal(), lt, degree=3)
    # the right-hand side is close to an eigenvector, so CG ends in a few
    # steps; a perturbed one (seeded) makes it work through the spectrum
    for rhs in (-np.asarray(Rj)[:nd],
                np.random.default_rng(5).standard_normal(nd)
                * ~ta.dirichlet_mask):
        xj, ij = jkry.cg(Sj2.matvec, jnp.asarray(rhs),
                         M=lambda r: smj(r, jnp.zeros_like(r)), tol=1e-8,
                         maxiter=500)
        xt, it = tkry.cg(St2.matvec, torch.as_tensor(rhs),
                         M=lambda r: smt(r, torch.zeros_like(r)), tol=1e-8,
                         maxiter=500)
        assert it.converged and it.iters == int(ij.iters)
        _close(xt.numpy(), xj, 1e-8)
    xy = ta.mesh.coords[ta.dofmaps["u"].nodes]
    exact = np.sin(PI * xy[:, 0]) * np.sin(PI * xy[:, 1])
    u, info = tkry.cg(St2.matvec, -Rt,
                      M=lambda r: smt(r, torch.zeros_like(r)), tol=1e-8)
    assert np.abs(u.numpy() - exact).max() < 1e-4
