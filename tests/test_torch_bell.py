"""Port parity: blocked-ELL plans and the plain BELL matvec against femus_tpu.

The plan builder is copied, so every plan array must be EQUAL.  The plain
matvec and the JAX XLA path compute the same products and differ only in
the order of the sums: rtol 1e-12.  The CUDA kernel itself is held against
the plain version on the card (tests/test_torch_kernels.py); here a numpy
emulation of its walk (one warp per tile over tile_row_ptr/tile_rows)
checks the host arrays it reads.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.algebra.bell as jbell
import femus_tpu_torch.algebra.bell as tbell
from femus_tpu.algebra.sparse import SparseOp as JSparseOp
from femus_tpu.algebra.sparse import pattern_from_pairs as jpairs
from femus_tpu_torch import convert
from femus_tpu_torch.algebra.sparse import EllPattern

PLAN_ARRAYS = ("block_ids", "tile_ids", "dest", "diag_src", "tile_start",
               "win_start", "twin_start", "perm", "iperm")


def _tpat(p):
    """The same pattern as a port EllPattern."""
    return EllPattern(p.n_rows, p.n_cols, p.width, p.cols, p.valid,
                      p.indptr, p.indices)


def _random_pattern(seed=0, n_nodes=200, deg=9):
    rng = np.random.default_rng(seed)
    rows, cols = [np.arange(n_nodes)], [np.arange(n_nodes)]
    for _ in range(deg):
        r = np.arange(n_nodes)
        c = rng.integers(0, n_nodes, n_nodes)
        rows += [r, c]
        cols += [c, r]
    return jpairs(np.concatenate(rows), np.concatenate(cols), n_nodes,
                  n_nodes)


def _mesh_pattern(kind, ns):
    import femus_tpu.assembly.engine as jeng
    from femus_tpu.mesh.generation import unit_box
    U = jeng.Unknown
    unk = ([U("u")] if kind == "poisson"
           else [U("u"), U("v"), U("p", "disc_linear")])
    return jeng.Assembler(unit_box(ns), unk, interleave=True).pattern


CASES = [("random", None), ("poisson", (7, 5)), ("poisson", (8, 8)),
         ("ns", (8, 8))]


def _pattern(kind, ns):
    return _random_pattern() if kind == "random" else _mesh_pattern(kind, ns)


@pytest.mark.parametrize("kind,ns", CASES)
@pytest.mark.parametrize("order", ["identity", None])
@pytest.mark.parametrize("tile", [8, 16])
def test_plan_arrays_equal(kind, ns, order, tile):
    pat = _pattern(kind, ns)
    jp = jbell.build_bell_plan(pat, tile=tile, perm=order)
    tp = tbell.build_bell_plan(_tpat(pat), tile=tile, perm=order)
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f),
                                      err_msg=f)
    for f in ("n", "tile", "n_tiles", "n_xblocks", "col_block", "nb", "win",
              "twin", "chunk", "tile_widths"):
        assert getattr(jp, f) == getattr(tp, f), f
    assert jp.slab_rows == tp.slab_rows
    # the kernel's walk covers exactly the real slab rows, tile by tile
    ptr, rows = tp.tile_row_ptr, tp.tile_rows
    assert ptr[0] == 0 and ptr[-1] == len(rows) and np.all(np.diff(ptr) >= 0)
    assert np.all(tp.tile_ids[rows] == np.repeat(np.arange(tp.n_tiles),
                                                 np.diff(ptr)))


@pytest.mark.parametrize("kind,ns", CASES)
def test_rcm_permutation_equal(kind, ns):
    pat = _pattern(kind, ns)
    np.testing.assert_array_equal(jbell.rcm_permutation(pat),
                                  tbell.rcm_permutation(_tpat(pat)))


def _fem_data(pat, seed=1):
    return np.random.default_rng(seed).standard_normal(pat.cols.shape) \
        * pat.valid


@pytest.mark.parametrize("kind,ns", [("random", None), ("poisson", (7, 5))])
@pytest.mark.parametrize("order", ["identity", None])
@pytest.mark.parametrize("tile", [8, 16])
def test_plain_matvec_matches_jax(kind, ns, order, tile):
    pat = _pattern(kind, ns)
    data = _fem_data(pat)
    x = np.random.default_rng(2).standard_normal(pat.n_rows)
    jp = jbell.build_bell_plan(pat, tile=tile, perm=order)
    jop = jbell.relayout_ell(jp, jnp.asarray(data))
    top = tbell.relayout_ell(tbell.build_bell_plan(_tpat(pat), tile=tile,
                                                   perm=order),
                             torch.as_tensor(data), device="cpu")
    np.testing.assert_array_equal(np.asarray(jop.blocks), top.blocks.numpy())
    y_ref = np.asarray(jop.matvec(jnp.asarray(x)))
    y = top.matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12)
    # frame-resident form against _matvec_xla_frame
    xf = np.asarray(jop.to_frame(jnp.asarray(x)))
    np.testing.assert_allclose(
        tbell._matvec_plain_frame(top, torch.as_tensor(xf)).numpy(),
        np.asarray(jbell._matvec_xla_frame(jop, jnp.asarray(xf))),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(top.diagonal().numpy(),
                               np.asarray(jop.diagonal()), rtol=1e-12)
    # against the plain ELL product too
    A = JSparseOp(jnp.asarray(data), jnp.asarray(pat.cols), pat.n_cols)
    np.testing.assert_allclose(y, np.asarray(A @ jnp.asarray(x)),
                               rtol=1e-11, atol=1e-11)


def _kernel_walk(op, xf):
    """numpy emulation of bell_spmv.cu: per tile, per listed slab row, the
    C-wide x segment of each packed block times the slab row."""
    p = op.dev
    slab = op.blocks.numpy()
    bids = p.block_ids.numpy().reshape(p.slab_rows, p.pack)
    ptr, rows = p.tile_row_ptr.numpy(), p.tile_rows.numpy()
    C = p.col_block
    xp = np.zeros(p.n_xblocks * C)
    xp[:p.n] = xf
    y = np.zeros(p.n_tiles * p.tile)
    for t in range(p.n_tiles):
        acc = np.zeros(p.tile)
        for r in rows[ptr[t]:ptr[t + 1]]:
            xs = np.concatenate([xp[b * C:(b + 1) * C] for b in bids[r]])
            acc += slab[r] @ xs
        y[t * p.tile:(t + 1) * p.tile] = acc
    return y[:p.n]


@pytest.mark.parametrize("kind,ns", [("random", None), ("ns", (8, 8))])
def test_kernel_walk_matches_plain(kind, ns):
    pat = _pattern(kind, ns)
    plan = tbell.build_bell_plan(_tpat(pat), perm="identity")
    op = tbell.relayout_ell(plan, torch.as_tensor(_fem_data(pat)),
                            device="cpu")
    x = np.random.default_rng(3).standard_normal(plan.n)
    np.testing.assert_allclose(
        _kernel_walk(op, x),
        tbell._matvec_plain_frame(op, torch.as_tensor(x)).numpy(),
        rtol=1e-12, atol=1e-12)


def test_convert_bell_op_from_jax_plan():
    """The JAX plan's arrays and slab, carried over with convert.py, give
    the JAX matvec; the derived walk order includes the padding rows."""
    pat = _mesh_pattern("poisson", (7, 5))
    jp = jbell.build_bell_plan(pat, perm=None)
    jop = jbell.relayout_ell(jp, jnp.asarray(_fem_data(pat)))
    arrays = {f: getattr(jp, f) for f in
              ("n", "tile", "n_tiles", "n_xblocks", "col_block", "perm",
               "block_ids", "tile_ids", "dest", "diag_src")}
    top = convert.bell_op_from_numpy(arrays, np.asarray(jop.blocks),
                                     device="cpu")
    x = np.random.default_rng(4).standard_normal(pat.n_rows)
    np.testing.assert_allclose(top.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    assert len(top.dev.tile_rows) == jp.slab_rows
    xf = top.to_frame(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(
        _kernel_walk(top, xf),
        tbell._matvec_plain_frame(top, torch.as_tensor(xf)).numpy(),
        rtol=1e-12, atol=1e-12)


def test_relayout_dtypes_and_backed_op():
    """f32/f64/bf16 slabs hold the ELL data rounded to the slab type;
    BellBackedOp keeps the ELL side for rmatvec and to_dense."""
    from femus_tpu_torch.algebra.sparse import SparseOp
    pat = _mesh_pattern("ns", (8, 8))
    data = torch.as_tensor(_fem_data(pat))
    plan = tbell.build_bell_plan(_tpat(pat), perm="identity")
    ref = tbell.relayout_ell(plan, data, device="cpu").blocks
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        op = tbell.relayout_ell(plan, data, dtype=dt, device="cpu")
        assert op.blocks.dtype == dt
        assert torch.equal(op.blocks, ref.to(dt))
    A = SparseOp(data, torch.as_tensor(pat.cols, dtype=torch.int64),
                 pat.n_cols)
    B = tbell.bell_backed(plan, A)
    y = torch.as_tensor(np.random.default_rng(5).standard_normal(pat.n_rows))
    np.testing.assert_allclose(B.matvec(y).numpy(), A.matvec(y).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(B.rmatvec(y).numpy(), A.rmatvec(y).numpy(),
                               rtol=1e-12, atol=1e-12)
    assert torch.equal(B.to_dense(), A.to_dense())
    assert torch.equal(B.diagonal(), A.diagonal())


def test_cuda_tensor_without_card_raises():
    """A CUDA entry point never falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pat = _random_pattern()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbell.relayout_ell(tbell.build_bell_plan(_tpat(pat)),
                           torch.as_tensor(_fem_data(pat)))


def test_sparse_op_and_pad_pattern_match_jax():
    """ELL SparseOp (gather matvec, index_add_ rmatvec, diagonal, to_dense)
    and identity-row padding against femus_tpu.algebra.sparse."""
    from femus_tpu.algebra.sparse import pad_pattern as jpad
    from femus_tpu_torch.algebra.sparse import pad_pattern as tpad

    pat = _mesh_pattern("ns", (8, 8))
    data = _fem_data(pat)
    A = JSparseOp(jnp.asarray(data), jnp.asarray(pat.cols), pat.n_cols)
    B = convert.sparse_op_from_numpy(data, pat.cols, pat.n_cols,
                                     device="cpu")
    x = np.random.default_rng(6).standard_normal(pat.n_rows)
    for jf, tf in ((A.matvec, B.matvec), (A.rmatvec, B.rmatvec)):
        np.testing.assert_allclose(tf(torch.as_tensor(x)).numpy(),
                                   np.asarray(jf(jnp.asarray(x))),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(B.diagonal().numpy(),
                                  np.asarray(A.diagonal()))
    np.testing.assert_array_equal(B.to_dense().numpy(),
                                  np.asarray(A.to_dense()))
    jp, tp = jpad(pat, pat.n_rows + 5, pat.n_cols + 5), \
        tpad(_tpat(pat), pat.n_rows + 5, pat.n_cols + 5)
    for f in ("cols", "valid", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f))
