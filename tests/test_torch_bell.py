"""Port parity: the BELL frame, the sliced-ELL layout of the card and its
plain matvec against femus_tpu.

The frame must EQUAL the JAX package's blocked-ELL plan's (``perm`` and
``iperm``), and the port's slab density, computed without a slab, the JAX
plan's ``nnz_bytes_ratio`` to the last bit: it decides the RCM rescue,
whose frame and note must be the JAX System's.  The port's own layout
(sliced ELL, ``SellPlan``) has no JAX counterpart: its invariants are
checked here, and its plain matvec against the JAX package's
``BellOp.matvec`` and ``_matvec_xla_frame`` in float64 — the same products
in another order: rtol 1e-12.  The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_kernels.py); here a numpy
emulation of its walk (one warp per slice, lane = row, groups of four
columns) checks the arrays it reads.
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
@pytest.mark.parametrize("sigma", [32, 512])
def test_frame_equals_jax_plan(kind, ns, order, sigma):
    """The sliced-ELL plan lives in the JAX blocked-ELL plan's frame, and
    the slab density of that frame equals the JAX plan's exactly."""
    pat = _pattern(kind, ns)
    jp = jbell.build_bell_plan(pat, tile=16, perm=order)
    sp = tbell.build_sell_plan(_tpat(pat), order, sigma)
    np.testing.assert_array_equal(sp.perm, jp.perm)
    np.testing.assert_array_equal(sp.iperm, jp.iperm)
    assert tbell.slab_bytes_per_nnz(_tpat(pat), sp.perm) == jp.nnz_bytes_ratio


def _wide_pattern(n=40000, seed=0):
    """A band, random entries, and a first row tile of 32,000 entries: a
    slab of some 130-150 chunks, one tile wider than a chunk."""
    rng = np.random.default_rng(seed)
    r = [np.arange(n), np.repeat(np.arange(16), 2000), np.arange(n),
         rng.integers(0, n, 3 * n)]
    c = [np.arange(n), rng.integers(0, n, 32000),
         np.minimum(np.arange(n) + 40, n - 1), rng.integers(0, n, 3 * n)]
    return jpairs(np.concatenate(r), np.concatenate(c), n, n)


@pytest.mark.parametrize("order", ["identity", None])
def test_slab_density_over_many_chunks(order):
    """The chunk cuts of a slab of many chunks, a tile wider than a chunk
    cut inside it: the density equals the JAX plan's exactly."""
    pat = _wide_pattern()
    jp = jbell.build_bell_plan(pat, perm=order)
    assert jp.slab_rows > 100 * jp.chunk
    assert tbell.slab_bytes_per_nnz(_tpat(pat), np.asarray(jp.perm)) \
        == jp.nnz_bytes_ratio


@pytest.mark.parametrize("kind,ns", CASES)
def test_rcm_permutation_equal(kind, ns):
    pat = _pattern(kind, ns)
    np.testing.assert_array_equal(jbell.rcm_permutation(pat),
                                  tbell.rcm_permutation(_tpat(pat)))


def _fem_data(pat, seed=1):
    return np.random.default_rng(seed).standard_normal(pat.cols.shape) \
        * pat.valid


def _holed_pattern():
    """Random pattern with empty rows, rows without a diagonal entry and a
    row count that is no multiple of 32."""
    rng = np.random.default_rng(7)
    n = 301
    r = np.concatenate([np.arange(5, n), rng.integers(0, n, 2000)])
    c = np.concatenate([np.arange(5, n), rng.integers(0, n, 2000)])
    keep = (r != 7) & (r != 100)
    return jpairs(r[keep], c[keep], n, n)


SELL_CASES = CASES + [("holed", None)]


def _sell_pattern(kind, ns):
    return _holed_pattern() if kind == "holed" else _pattern(kind, ns)


@pytest.mark.parametrize("kind,ns", SELL_CASES)
@pytest.mark.parametrize("order", ["identity", None])
@pytest.mark.parametrize("sigma", [32, 512])
def test_sell_plan_invariants(kind, ns, order, sigma):
    """Every nonzero stored once at the slot the kernel computes, padding
    reads the zero, the row order is a permutation sorted by length inside
    each window, diagonal slots right, fill reported."""
    pat = _tpat(_sell_pattern(kind, ns))
    sp = tbell.build_sell_plan(pat, order, sigma)
    n, C, V = pat.n_rows, tbell.SELL_C, tbell.SELL_V
    assert sp.n == n and sp.nnz == pat.nnz and sp.sigma == sigma
    assert sp.n_slices == -(-n // C)
    ptr = sp.slice_ptr.astype(np.int64)
    assert ptr[0] == 0 and np.all(np.diff(ptr) >= 0)
    assert sp.total == ptr[-1] * C * V == len(sp.cols) == len(sp.src) - 1
    assert sp.fill == sp.total / pat.nnz >= 1.0
    assert sp.cols.dtype == np.int32 and sp.row_order.dtype == np.int32
    # row order: a permutation of the frame rows, -1 only beyond row n
    ro = sp.row_order
    assert len(ro) == sp.n_slices * C
    np.testing.assert_array_equal(np.sort(ro[ro >= 0]), np.arange(n))
    assert (ro < 0).sum() == sp.n_slices * C - n
    lens = np.zeros(len(ro), np.int64)
    lens[ro >= 0] = np.diff(pat.indptr)[sp.perm[ro[ro >= 0]]]
    for w0 in range(0, len(ro), sigma):          # sorted inside each window
        assert np.all(np.diff(lens[w0:w0 + sigma]) <= 0)
        real = ro[w0:w0 + sigma]
        assert np.all((real[real >= 0] >= w0) & (real[real >= 0] < w0 + sigma))
    # a slice is as wide as its longest row, rounded up to V columns
    np.testing.assert_array_equal(
        np.diff(ptr), -(-lens.reshape(-1, C).max(axis=1) // V))
    # every ELL slot of a nonzero is the source of exactly one stored slot;
    # all other stored slots (and the extra last one) read the zero
    ell_size = n * pat.width
    stored = sp.src[:-1]
    np.testing.assert_array_equal(np.sort(stored[stored < ell_size]),
                                  np.sort(pat.csr_to_ell_slots()))
    assert sp.src[-1] == ell_size and stored.max() <= ell_size
    # slot formula of the kernel: (slice_ptr[s] + k/V)*C*V + r*V + k%V holds
    # row ro[s*C + r]'s k-th nonzero, column in frame numbering
    A = np.zeros((n, n))
    slot_val = np.arange(1, sp.total + 1, dtype=np.float64)
    slot_val[stored == ell_size] = 0.0
    for s_ in range(sp.n_slices):
        for r in range(C):
            row = ro[s_ * C + r]
            for k in range((ptr[s_ + 1] - ptr[s_]) * V):
                slot = (ptr[s_] + k // V) * C * V + r * V + k % V
                if row < 0:
                    assert slot_val[slot] == 0.0
                    continue
                A[row, sp.cols[slot]] += slot_val[slot]
    ref = np.zeros((n, n))
    counts = np.diff(pat.indptr)
    rows_o = np.repeat(np.arange(n), counts)
    np.add.at(ref, (sp.iperm[rows_o], sp.iperm[pat.indices]), 1.0)
    np.testing.assert_array_equal(A != 0, ref != 0)
    assert np.all(ref <= 1.0)
    # diagonal slots, by ORIGINAL row; rows without one read the zero
    has_diag = np.zeros(n, bool)
    has_diag[rows_o[pat.indices == rows_o]] = True
    for i in range(n):
        d = sp.diag_slot[i]
        if has_diag[i]:
            assert sp.cols[d] == sp.iperm[i] and stored[d] < ell_size
            s_ = np.searchsorted(ptr, d // (C * V), side="right") - 1
            assert ro[s_ * C + (d // V) % C] == sp.iperm[i]
        else:
            assert d == sp.total
    assert not has_diag.all() or kind != "holed"
    with pytest.raises(ValueError, match="multiple"):
        tbell.build_sell_plan(pat, order, 48)


@pytest.mark.parametrize("kind,ns", SELL_CASES)
@pytest.mark.parametrize("order", ["identity", None])
@pytest.mark.parametrize("sigma", [32, None])
def test_plain_matvec_matches_jax(kind, ns, order, sigma):
    """The plain sliced-ELL matvec against femus_tpu's BellOp.matvec and
    _matvec_xla_frame in float64 (1e-12): random patterns (one with empty
    rows and n no multiple of 32), Poisson, the 8x8 NS pattern; identity
    and RCM frames; a one-slice window and the default one."""
    pat = _sell_pattern(kind, ns)
    data = _fem_data(pat)
    x = np.random.default_rng(2).standard_normal(pat.n_rows)
    jp = jbell.build_bell_plan(pat, perm=order)
    jop = jbell.relayout_ell(jp, jnp.asarray(data))
    plan = tbell.build_sell_plan(_tpat(pat), order,
                                 **({} if sigma is None else {"sigma": sigma}))
    top = tbell.relayout_ell(plan, torch.as_tensor(data), device="cpu")
    assert top.dev.sigma == (tbell.SELL_SIGMA if sigma is None else sigma)
    assert top.vals.shape == (top.dev.total + 1,) and top.vals[-1] == 0
    y_ref = np.asarray(jop.matvec(jnp.asarray(x)))
    y = top.matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12)
    # frame-resident form against _matvec_xla_frame
    xf = np.asarray(jop.to_frame(jnp.asarray(x)))
    np.testing.assert_array_equal(
        top.to_frame(torch.as_tensor(x)).numpy(), xf)
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


@pytest.mark.parametrize("kind,ns", SELL_CASES)
def test_rcm_rescue_matches_jax(monkeypatch, kind, ns):
    """bell_order="identity": the frame and the routing note of the JAX
    System's rule (an identity slab above 24 B a nonzero is rebuilt with
    RCM, both densities in the note).  At these sizes one 256-row chunk
    of slab outweighs the nonzeros: the random and the Poisson patterns
    (36-64 B a nonzero) take the rescue, the 8 x 8 NS pattern (5.5) keeps
    the identity."""
    pat = _sell_pattern(kind, ns)
    monkeypatch.setattr(tbell, "BELL_MIN_ROWS", 1)
    dev, note = tbell.bell_device_plan(_tpat(pat), "identity", "cpu")
    jp = jbell.build_bell_plan(pat, perm="identity")
    ratio = jp.nnz_bytes_ratio
    rescued = ratio > 24.0
    assert rescued == (kind != "ns")
    if rescued:
        jp = jbell.build_bell_plan(pat)
        assert note["order"] == "rcm-rescue"
        assert note["reason"] == (
            f"identity slab {ratio:.1f} B/nnz > 24.0, rebuilt with RCM "
            f"({jp.nnz_bytes_ratio:.1f})")
        np.testing.assert_array_equal(dev.perm.numpy(), jp.perm)
        np.testing.assert_array_equal(dev.iperm.numpy(), jp.iperm)
    else:
        assert note["order"] == "identity" and "reason" not in note
        assert dev.perm is None and dev.iperm is None
    assert note["path"] == "bell" and note["n_rows"] == pat.n_rows
    assert dev.n == pat.n_rows and dev.sigma == tbell.SELL_SIGMA


def _kernel_walk(op, xf):
    """numpy emulation of sell_spmv.cu: per slice, per lane, the groups of
    four columns in order, one running sum per lane, y through
    row_order."""
    p = op.dev
    C, V = tbell.SELL_C, tbell.SELL_V
    vals, cols = op.vals.numpy(), p.cols.numpy()
    ptr, ro = p.slice_ptr.numpy(), p.row_order.numpy()
    y = np.full(p.n, np.nan)
    for s in range(p.n_slices):
        for lane in range(C):
            acc = 0.0
            for g in range(ptr[s], ptr[s + 1]):
                base = g * C * V + lane * V
                for k in range(V):
                    acc += vals[base + k] * xf[cols[base + k]]
            if ro[s * C + lane] >= 0:
                y[ro[s * C + lane]] = acc
    return y


@pytest.mark.parametrize("kind,ns", [("random", None), ("ns", (8, 8)),
                                     ("holed", None)])
def test_kernel_walk_matches_plain(kind, ns):
    pat = _sell_pattern(kind, ns)
    plan = tbell.build_sell_plan(_tpat(pat), "identity")
    op = tbell.relayout_ell(plan, torch.as_tensor(_fem_data(pat)),
                            device="cpu")
    x = np.random.default_rng(3).standard_normal(plan.n)
    np.testing.assert_allclose(
        _kernel_walk(op, x),
        tbell._matvec_plain_frame(op, torch.as_tensor(x)).numpy(),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("order", ["identity", None])
def test_convert_bell_op_from_jax_plan(order):
    """The JAX plan's arrays and slab, carried over with convert.py (the
    slab read back through ``dest``), give the JAX matvec."""
    pat = _mesh_pattern("poisson", (7, 5))
    jp = jbell.build_bell_plan(pat, perm=order)
    jop = jbell.relayout_ell(jp, jnp.asarray(_fem_data(pat)))
    arrays = {"perm": None if jp.identity else jp.perm, "dest": jp.dest}
    top = convert.bell_op_from_numpy(arrays, np.asarray(jop.blocks), pat,
                                     device="cpu")
    assert (top.dev.perm is None) == (order == "identity")
    x = np.random.default_rng(4).standard_normal(pat.n_rows)
    np.testing.assert_allclose(top.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(top.diagonal().numpy(),
                               np.asarray(jop.diagonal()), rtol=1e-12)
    xf = top.to_frame(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(
        _kernel_walk(top, xf),
        tbell._matvec_plain_frame(top, torch.as_tensor(xf)).numpy(),
        rtol=1e-12, atol=1e-12)


def test_relayout_dtypes_and_backed_op():
    """f32/f64/bf16 values hold the ELL data rounded to the storage type
    (padding and the last slot zero); the matvec accumulates in x's type;
    BellBackedOp keeps the ELL side for rmatvec and to_dense."""
    from femus_tpu_torch.algebra.sparse import SparseOp
    pat = _mesh_pattern("ns", (8, 8))
    data = torch.as_tensor(_fem_data(pat))
    plan = tbell.build_sell_plan(_tpat(pat), "identity")
    ref = tbell.relayout_ell(plan, data, device="cpu").vals
    flat = torch.cat([data.reshape(-1), data.new_zeros(1)])
    assert torch.equal(ref, flat[torch.as_tensor(plan.src)])
    # invalid ELL slots may hold anything: they are never a source
    noisy = torch.where(torch.as_tensor(pat.valid), data, 99.0)
    assert torch.equal(tbell.relayout_ell(plan, noisy, device="cpu").vals,
                       ref)
    x32 = torch.as_tensor(np.random.default_rng(5).standard_normal(
        pat.n_rows), dtype=torch.float32)
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        op = tbell.relayout_ell(plan, data, dtype=dt, device="cpu")
        assert op.vals.dtype == dt
        assert torch.equal(op.vals, ref.to(dt))
        y = op.matvec_frame(x32)
        assert y.dtype == torch.float32
        want = tbell.BellOp(ref.to(dt).double(), op.dev).matvec_frame(
            x32.double())
        np.testing.assert_allclose(y.double().numpy(), want.numpy(),
                                   rtol=0, atol=1e-5 * float(want.abs().max()))
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
        tbell.relayout_ell(tbell.build_sell_plan(_tpat(pat)),
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
