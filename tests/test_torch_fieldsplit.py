"""Port parity: block (field-split / Schur) preconditioners against
femus_tpu, in float64 on the host.

Two saddle operators, each assembled by the JAX package and carried into
the port with ``convert.sparse_op_from_numpy``, so both packages apply
their preconditioners to the same matrix: the lid-driven cavity Jacobian
of tests/test_fieldsplit_tree.py (nu 0.1, pressure gauge) and the Stokes
operator of tests/test_saddle.py, both on unit_box((4,4)) with u, v Q2 and
p Q1.  Split indices are equal; one application of every combinator to
the same seeded r agrees to 1e-10; FGMRES with the nested tree takes the
same iterations and gives the same correction to 1e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.algebra.fieldsplit as jfs
import femus_tpu.algebra.krylov as jkry
import femus_tpu.assembly.bc as jbc
import femus_tpu.assembly.engine as jeng
import femus_tpu.assembly.forms as jforms
import femus_tpu_torch.algebra.fieldsplit as tfs
import femus_tpu_torch.algebra.krylov as tkry
import femus_tpu_torch.assembly.engine as teng
from femus_tpu.mesh.generation import unit_box as junit_box
from femus_tpu_torch import convert
from femus_tpu_torch.mesh.generation import unit_box as tunit_box

PI = np.pi
FIELDS = [("u", "biquadratic"), ("v", "biquadratic"), ("p", "linear")]


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _cavity_bc(var, x, grp, t):
    if var == "u":
        return True, (1.0 if x[1] > 1 - 1e-12 else 0.0)
    if var == "v":
        return True, 0.0
    return False, 0.0


def _stokes_bc(var, x, grp, t):
    if var == "p":
        return False, 0.0
    return True, (1.0 if (var == "u" and grp == 4) else 0.0)


def _setup(problem):
    """(JAX assembler, JAX operator, port assembler, port operator, R)."""
    ja = jeng.Assembler(junit_box((4, 4), "quad"),
                        [jeng.Unknown(*f) for f in FIELDS],
                        quad_order="fifth")
    if problem == "cavity":
        ja.set_volume_form(jforms.navier_stokes(("u", "v"), "p", nu=0.1))
        jbc.generate_bdc(ja, _cavity_bc)
    else:
        def force(x):
            return jnp.stack([jnp.sin(PI * x[:, 1]), jnp.cos(PI * x[:, 0])],
                             axis=-1)
        ja.set_volume_form(jforms.navier_stokes(("u", "v"), "p", nu=1.0,
                                                force=force, stokes=True))
        jbc.generate_bdc(ja, _stokes_bc)
    mask = np.asarray(ja.dirichlet_mask).copy()
    vals = np.asarray(ja.dirichlet_values).copy()
    mask[ja.offsets["p"]] = True                  # the pressure gauge
    vals[ja.offsets["p"]] = 0.0
    ja.set_dirichlet(mask, vals)
    u0 = jnp.asarray(jbc.apply_dirichlet_values(ja, np.zeros(ja.n_dofs)))
    R, data = jax.jit(ja.make_assemble_fn())(u0)
    jop = ja.op_with(data)
    ta = teng.Assembler(tunit_box((4, 4), "quad"),
                        [teng.Unknown(*f) for f in FIELDS],
                        quad_order="fifth", device="cpu")
    ta.set_dirichlet(mask, vals)
    top = convert.sparse_op_from_numpy(np.asarray(data),
                                       np.asarray(ja.pattern.cols),
                                       ja.pattern.n_cols, device="cpu")
    return ja, jop, ta, top, np.asarray(R)


@pytest.fixture(scope="module", params=["cavity", "stokes"])
def saddle(request):
    return _setup(request.param)


def _apply(Mj, Mt, ta, seed=5):
    """Both preconditioners applied to one seeded residual, zero on the
    Dirichlet rows as every residual of a solve is.  (A nonzero entry at
    the pressure gauge makes the Schur CG indefinite: its iterates then
    amplify rounding differences to ~1e-7 at that one dof in either
    package.)"""
    r = np.random.default_rng(seed).standard_normal(ta.n_dofs)
    r[ta.dirichlet_mask] = 0.0
    return (Mt(torch.as_tensor(r)).numpy(),
            np.asarray(Mj(jnp.asarray(r))))


def test_split_indices_equal(saddle):
    ja, _, ta, _, _ = saddle
    groups = {"vel": ["u", "v"], "press": ["p"]}
    for sj, st in zip(jfs.splits_from_offsets(ja, groups),
                      tfs.splits_from_offsets(ta, groups)):
        assert sj.name == st.name
        np.testing.assert_array_equal(sj.idx, st.idx)
    node = tfs.FieldSplitNode("vel", vars=["v", "u"])
    np.testing.assert_array_equal(
        tfs._node_idx(node, ta),
        jfs._node_idx(jfs.FieldSplitNode("vel", vars=["v", "u"]), ja))


@pytest.mark.parametrize("combine", ["additive", "multiplicative"])
def test_flat_combinators_match_jax(saddle, combine):
    ja, jop, ta, top, _ = saddle
    groups = {"vel": ["u", "v"], "press": ["p"]}
    sj, st = jfs.splits_from_offsets(ja, groups), \
        tfs.splits_from_offsets(ta, groups)
    fj = getattr(jfs, f"{combine}_fieldsplit")
    ft = getattr(tfs, f"{combine}_fieldsplit")
    Mj = fj(jop, sj, [jfs.jacobi_pc(jop, jnp.asarray(s.idx)) for s in sj])
    Mt = ft(top, st, [tfs.jacobi_pc(top, s.idx) for s in st])
    _close(*_apply(Mj, Mt, ta), 1e-10)


@pytest.mark.parametrize("fact", ["diag", "lower", "upper", "full"])
def test_schur_fieldsplit_matches_jax(saddle, fact):
    ja, jop, ta, top, _ = saddle
    groups = {"vel": ["u", "v"], "press": ["p"]}
    (ju, jp), (tu, tp) = jfs.splits_from_offsets(ja, groups), \
        tfs.splits_from_offsets(ta, groups)
    Mj = jfs.schur_fieldsplit(jop, ju, jp,
                              jfs.jacobi_pc(jop, jnp.asarray(ju.idx)),
                              fact=fact, schur_iters=15, u_iters=6)
    Mt = tfs.schur_fieldsplit(top, tu, tp, tfs.jacobi_pc(top, tu.idx),
                              fact=fact, schur_iters=15, u_iters=6)
    _close(*_apply(Mj, Mt, ta), 1e-10)


def _trees(fs, fact="full"):
    """The nested Schur tree of tests/test_fieldsplit_tree.py (Vanka
    velocity leaf, Jacobi pressure leaf), and the multiplicative tree over
    an additive velocity node with CG leaves."""
    N = fs.FieldSplitNode
    schur = N("root", combine="schur", schur_fact=fact, schur_iters=12,
              children=[N("vel", vars=["u", "v"], pc="vanka", iters=2,
                          vanka_block_elems=2),
                        N("press", vars=["p"], pc="jacobi", iters=2)])
    mult = N("root", combine="multiplicative", children=[
        N("vel", combine="additive", children=[
            N("u", vars=["u"], pc="cg", iters=6),
            N("v", vars=["v"], pc="cg", iters=6)]),
        N("press", vars=["p"], pc="jacobi", iters=3)])
    return {"schur": schur, "mult": mult}


@pytest.mark.parametrize("tree,fact", [
    ("schur", "diag"), ("schur", "lower"), ("schur", "upper"),
    ("schur", "full"), ("mult", None)])
def test_fieldsplit_trees_match_jax(saddle, tree, fact):
    ja, jop, ta, top, _ = saddle
    Mj = jfs.build_fieldsplit_tree(jop, ja, _trees(jfs, fact)[tree])
    Mt = tfs.build_fieldsplit_tree(top, ta, _trees(tfs, fact)[tree])
    _close(*_apply(Mj, Mt, ta), 1e-10)


def test_fgmres_with_tree_matches_jax():
    """FGMRES(50) on the cavity with the nested Schur tree: the same
    iterations and the same correction to 1e-8."""
    ja, jop, ta, top, R = _setup("cavity")
    Mj = jfs.build_fieldsplit_tree(jop, ja, _trees(jfs)["schur"])
    Mt = tfs.build_fieldsplit_tree(top, ta, _trees(tfs)["schur"])
    dj, ij = jkry.fgmres(jop.matvec, -jnp.asarray(R), M=Mj, tol=1e-8,
                         restart=50, max_restarts=8)
    dt, it = tkry.fgmres(top.matvec, -torch.as_tensor(R), M=Mt, tol=1e-8,
                         restart=50, max_restarts=8)
    assert it.iters == int(ij.iters) and it.converged
    _close(dt.numpy(), dj, 1e-8)
    res = float(torch.linalg.norm(top @ dt + torch.as_tensor(R)))
    assert res < 1e-6 * np.linalg.norm(R)
