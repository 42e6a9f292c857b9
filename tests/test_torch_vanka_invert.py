"""The Vanka block inverses: kernel V2 (``csrc/vanka_invert.cu``, through
``vanka.vanka_invert_cuda``) and the plain chain (``vanka.invert_plain``,
gather, batched LU, LU solves of the identity), both behind
``vanka._invert_blocks``.

The host tests hold the plain chain against numpy's float64 inverse on
padded, zero-pivot and bfloat16 blocks, walk the kernel's Gauss-Jordan
arithmetic in numpy (pivot rule, in-place update, the column unscramble,
the transposed write) against the same inverse, and check the counters of
the host path.  The tests marked ``cuda`` need an NVIDIA card and the CUDA
toolkit; without a card they skip.  On the card (no JAX there, so skip the
repo's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_vanka_invert.py
"""
import numpy as np
import pytest
import torch

import test_torch_vanka_kernel as vk
from femus_tpu_torch.algebra import vanka
from femus_tpu_torch.algebra.sparse import SparseOp, pattern_from_pairs
from femus_tpu_torch.assembly.engine import Assembler, Unknown
from femus_tpu_torch.assembly.forms import boussinesq
from femus_tpu_torch.mesh.generation import unit_box
from femus_tpu_torch.utils import telemetry


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def _saddle_case(device, dtype=torch.float64):
    """Ten dofs, seven velocities and three pressures with no
    pressure-pressure entry in the pattern (a miss), and blocks that start
    at a pressure dof (a zero first pivot), padded with n."""
    n, nu = 10, 7
    rng = np.random.default_rng(7)
    M = rng.uniform(-1, 1, (n, n))
    M[:nu, :nu] += 6 * np.eye(nu)
    M[nu:, nu:] = 0.0
    r, c = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = ~((r >= nu) & (c >= nu))
    pat = pattern_from_pairs(r[keep], c[keep], n, n)
    data = np.where(pat.valid, M[np.arange(n)[:, None], pat.cols], 0.0)
    dofs = np.array([[7, 0, 1, 2, 3], [8, 4, 5, 6, n], [9, 1, 4, n, n],
                     [n, 3, n, 5, n]])
    return _case(M, pat, data, dofs, device, dtype)


def _case(M, pat, data, dofs, device, dtype):
    """(values, dofs, slots, n, the dense blocks in float64) of blocks
    ``dofs`` of the dense ``M`` on the ELL pattern ``pat``."""
    n, bs = M.shape[0], dofs.shape[1]
    lut = vanka.lut_with_miss(pat)
    bi = np.repeat(dofs, bs, axis=1).reshape(-1, bs, bs)
    bj = np.tile(dofs, (1, bs)).reshape(-1, bs, bs)
    slots = lut(bi.ravel(), bj.ravel()).reshape(bi.shape)
    vals = torch.as_tensor(data, dtype=dtype)
    dense = _dense_blocks(vals.double().numpy().ravel(), dofs, slots, n)
    return (vals.to(device), torch.as_tensor(dofs, device=device),
            torch.as_tensor(slots, device=device), n, dense)


def _dense_blocks(flat, dofs, slots, n):
    """The blocks as both paths build them, in float64 (numpy): the
    gathered values, zero at a miss, identity on padding."""
    miss = flat.size
    vals = np.where(slots < miss, flat[np.minimum(slots, miss - 1)], 0.0)
    valid = dofs < n
    eye = np.eye(dofs.shape[1])
    return np.where(valid[:, :, None] & valid[:, None, :], vals, eye)


def _ns_case(device, dtype=torch.float64):
    """The Navier-Stokes Jacobian of ``test_torch_vanka_kernel`` (rows of
    up to 62 ELL slots) and its two-element blocks, all colours."""
    A, blocks = vk._ns_case("cpu")
    return _from_operator(A, blocks, device, dtype)


def _cavity_case(device, dtype=torch.float64):
    """The Boussinesq cavity's Jacobian (u, v, T Q2 and P1dc p,
    interleaved, Ra = 1e5) at a seeded state on unit_box((4, 4)), and its
    two-element blocks: 60 dofs at the widest."""
    asm = Assembler(unit_box((4, 4)), [Unknown("u"), Unknown("v"),
                                       Unknown("p", "disc_linear"),
                                       Unknown("T")],
                    dtype=torch.float64, interleave=True, device="cpu")
    asm.set_volume_form(boussinesq(("u", "v"), "p", "T",
                                   pres_family="disc_linear", ra=1e5,
                                   pr=0.71))
    u = np.random.default_rng(4).standard_normal(asm.n_dofs)
    _, data = asm.make_assemble_fn()(torch.as_tensor(u))
    A = SparseOp(data, torch.as_tensor(asm.pattern.cols, dtype=torch.int64),
                 asm.pattern.n_cols)
    return _from_operator(A, vanka.build_element_blocks(asm, 2,
                                                        device="cpu"),
                          device, dtype)


def _from_operator(A, blocks, device, dtype):
    dofs = torch.cat(blocks.color_dofs)
    slots = torch.cat(blocks.color_slots)
    vals = A.data.to(dtype)
    dense = _dense_blocks(vals.double().numpy().ravel(), dofs.numpy(),
                          slots.numpy(), blocks.n)
    return vals.to(device), dofs.to(device), slots.to(device), blocks.n, \
        dense


CASES = {"saddle": _saddle_case, "ns": _ns_case, "cavity": _cavity_case}


def _rel_err(got, dense):
    """Per block: max |got - inv| over cond_inf * max |inv| (inv the
    float64 inverse), so float rounding reads about eps times a small
    factor."""
    ref = np.linalg.inv(dense)
    cond = (np.abs(dense).sum(-1).max(-1) * np.abs(ref).sum(-1).max(-1))
    err = np.abs(got - ref).max(axis=(1, 2))
    return err / (cond * np.abs(ref).max(axis=(1, 2)))


# ---------------------------------------------------------------- host ----

def _walk_invert(flat, dofs, slots, n):
    """numpy emulation of vanka_invert.cu, one block after the other:
    (ainv_t, rv, the pivot row of each step).  The gather (zero at a miss,
    identity on padding), then in-place Gauss-Jordan: at step c the pivot
    is the first row i >= c of the largest |a[i, c]| (a NaN never wins),
    rows c and p swap, column c leaves as the factors (0 for row c) and
    takes the identity's column c, row c is scaled by the pivot's
    reciprocal, and every row loses its factor times row c; the row swaps
    are undone as column swaps in reverse order and the inverse is written
    transposed."""
    nb, bs = dofs.shape
    dense = _dense_blocks(flat, dofs, slots, n)
    ainv_t = np.empty((nb, bs, bs))
    perms = np.empty((nb, bs), np.int64)
    for k in range(nb):
        a = dense[k].copy()
        for c in range(bs):
            best, p = -1.0, c
            for i in range(c, bs):
                if abs(a[i, c]) > best:
                    best, p = abs(a[i, c]), i
            a[[c, p]] = a[[p, c]]
            inv = 1.0 / a[c, c]
            fcol = a[:, c].copy()
            fcol[c] = 0.0
            a[:, c] = 0.0
            a[c, c] = 1.0
            a[c] = a[c] * inv
            a = a - fcol[:, None] * a[c][None, :]
            perms[k, c] = p
        col = list(range(bs))
        for c in reversed(range(bs)):
            q = perms[k, c]
            col[c], col[q] = col[q], col[c]
        ainv_t[k] = a[:, col].T
    return ainv_t, (dofs < n).astype(float), perms


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_walk_matches_numpy(case):
    data, dofs, slots, n, dense = CASES[case]("cpu")
    ainv_t, rv, _ = _walk_invert(data.numpy().ravel(), dofs.numpy(),
                                 slots.numpy(), n)
    assert (_rel_err(ainv_t.transpose(0, 2, 1), dense) <= 1e-13).all()
    np.testing.assert_array_equal(rv, (dofs < n).numpy())


def test_walk_pivots_on_the_largest_magnitude_lowest_row_first():
    """Column 0 of the first block ties at |1| in rows 0 and 2 (the first
    wins) and is zero in row 1; the second block starts on a zero pivot."""
    blocks = np.array([[[1.0, 2.0, 0.0], [0.0, 1.0, 1.0], [-1.0, 0.0, 3.0]],
                       [[0.0, 1.0, 2.0], [1.0, 0.0, 0.0], [2.0, 0.0, 1.0]]])
    flat = blocks.reshape(-1)
    dofs = np.array([[0, 1, 2], [0, 1, 2]])
    slots = np.arange(18).reshape(2, 3, 3)
    ainv_t, _, perms = _walk_invert(flat, dofs, slots, 3)
    assert perms[0, 0] == 0 and perms[1, 0] == 2
    np.testing.assert_allclose(ainv_t.transpose(0, 2, 1),
                               np.linalg.inv(blocks), rtol=0, atol=1e-15)


def test_walk_of_a_singular_block_is_not_finite():
    flat = np.array([1.0, 2.0, 2.0, 4.0])
    with np.errstate(divide="ignore", invalid="ignore"):
        ainv_t, _, _ = _walk_invert(flat, np.array([[0, 1]]),
                                    np.arange(4).reshape(1, 2, 2), 2)
    assert not np.isfinite(ainv_t).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("case", ["saddle", "cavity"])
def test_plain_inverse_matches_numpy(case, dtype, tol):
    """The host path, on padded blocks with a zero first pivot (saddle) and
    on the cavity's 60-dof blocks: float64 values in float64, float32 and
    bfloat16 values in float32 (the inverses float32 too)."""
    data, dofs, slots, n, dense = CASES[case]("cpu", dtype)
    Ainv, rv = vanka._invert_blocks(data, dofs, slots, n)
    want = torch.float64 if dtype == torch.float64 else torch.float32
    assert Ainv.dtype == rv.dtype == want
    assert (_rel_err(Ainv.double().numpy(), dense) <= tol).all()
    assert torch.equal(rv, (dofs < n).to(want))
    if case == "saddle":
        assert (dense[:3, 0, 0] == 0).all() and (dofs == n).any()


def test_host_path_counts_no_wait_and_no_kernel():
    """The plain chain counts the blocks it inverts, and no host wait and
    no V2 inversion."""
    A, blocks = vk._ns_case("cpu")
    sites = telemetry.RECORDER.sites
    before = dict(sites)
    vanka.vanka_smoother(A, blocks)
    added = {k: v - before.get(k, 0) for k, v in sites.items()
             if v != before.get(k, 0)}
    assert not [k for k in added if k.startswith("host_wait.")]
    assert "vanka.invert_kernel" not in added
    assert added["vanka.blocks_inverted"] == sum(
        d.shape[0] for d in blocks.color_dofs) > 0


def test_kernel_wrapper_refuses_host_values():
    data, dofs, slots, n, _ = _saddle_case("cpu")
    with pytest.raises(ValueError):
        vanka.vanka_invert_cuda(data, dofs, slots, n)


def test_shared_memory_limit_covers_the_configurations():
    """V2's largest blocks: 238 dofs in float32, 168 in float64.  The
    widest block the card's configurations build is fsi's, 2 x 9 nodes of
    DX, DY, U and V and 2 x 3 pressures (78 dofs, float64)."""
    fits = [vanka.invert_smem_bytes(bs, dt) <= vanka._MAX_INVERT_SMEM
            for bs, dt in ((238, torch.float32), (239, torch.float32),
                           (238, torch.bfloat16), (168, torch.float64),
                           (169, torch.float64), (78, torch.float64))]
    assert fits == [True, False, True, True, False, True]


# ---------------------------------------------------------------- card ----

def _held(case, dtype, device):
    """V2 against torch.linalg.inv of the same blocks in float64 on the
    card: the worst error over cond * max |inv| of a block (a float
    rounding reads a few hundredths of the working type's eps: numpy's
    float32 Gauss-Jordan 0.9e-9 to 3.6e-9 on these cases, the LU chain
    0.5e-9 to 4.2e-9)."""
    data, dofs, slots, n, dense = CASES[case](device, dtype)
    Ainv, rv = vanka._invert_blocks(data, dofs, slots, n)
    want = torch.float64 if dtype == torch.float64 else torch.float32
    assert Ainv.dtype == rv.dtype == want
    assert torch.equal(rv, (dofs < n).to(want))
    ref = torch.linalg.inv(torch.as_tensor(dense, device=device))
    assert torch.allclose(ref.cpu(), torch.as_tensor(np.linalg.inv(dense)),
                          rtol=1e-9, atol=1e-12)
    return float(_rel_err(Ainv.double().cpu().numpy(), dense).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_inverse(cuda, case, dtype):
    """Padded blocks with a zero first pivot (saddle), the Navier-Stokes
    blocks, the cavity's 60-dof blocks; float64 values in float64,
    float32 and bfloat16 values in float32."""
    worst = _held(case, dtype, cuda)
    eps = torch.finfo(torch.float64 if dtype == torch.float64
                      else torch.float32).eps
    print(f"{case} {dtype}: {worst:.3e} (limit {eps:.3e})")
    assert worst <= eps


@pytest.fixture(scope="module")
def hierarchies():
    """The levels of each case, built once for the module's tests."""
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_inverse_on_channel_levels(cuda, hierarchies, dtype):
    """The DFG channel's three captured Vanka levels (42-dof blocks)."""
    levels = vk._levels("channel", cuda, hierarchies)
    assert len(levels) >= 2
    for A, blocks in levels:
        vals = A.data.to(dtype).contiguous()
        flat = vals.double().cpu().numpy().ravel()
        for d, s in zip(blocks.color_dofs, blocks.color_slots):
            Ainv, _ = vanka._invert_blocks(vals, d, s, blocks.n)
            dense = _dense_blocks(flat, d.cpu().numpy(), s.cpu().numpy(),
                                  blocks.n)
            worst = float(_rel_err(Ainv.double().cpu().numpy(), dense).max())
            assert worst <= torch.finfo(dtype).eps, (A.n_rows, worst)
    assert max(b.color_dofs[0].shape[1] for _, b in levels) == 42


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_singular_block_gives_non_finite_entries(cuda, dtype):
    data, dofs, slots, n, _ = _saddle_case(cuda, dtype)
    data = data.clone()
    data[dofs[1, 1]] = 0.0        # block 1's row of dof 4 is now zero
    Ainv, _ = vanka._invert_blocks(data, dofs, slots, n)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(Ainv[1]).all())
    assert bool(torch.isfinite(Ainv[0]).all())


@pytest.mark.cuda
def test_layout_repeats_and_launches(cuda):
    """Ainv is the transposed view of V2's contiguous output, so the colour
    plan copies nothing; the same inputs give the same bits; one launch a
    call, counted."""
    data, dofs, slots, n, _ = _ns_case(cuda, torch.float32)
    n0 = vanka.vanka_invert_cuda.launches
    kern = telemetry.RECORDER.sites.get("vanka.invert_kernel", 0)
    Ainv, rv = vanka._invert_blocks(data, dofs, slots, n)
    assert vanka.vanka_invert_cuda.launches == n0 + 1
    assert telemetry.RECORDER.sites["vanka.invert_kernel"] == kern + \
        dofs.shape[0]
    assert not Ainv.is_contiguous() and Ainv.transpose(1, 2).is_contiguous()
    cols = torch.zeros(n, 1, dtype=torch.int64, device=cuda)
    ops = torch.zeros(n, 1, dtype=torch.float32, device=cuda)
    plan = vanka.colour_plan(ops, cols, [(dofs, Ainv, rv)], n)
    assert plan.ainv_t[0].data_ptr() == Ainv.data_ptr()
    again, rv2 = vanka._invert_blocks(data, dofs, slots, n)
    assert torch.equal(again, Ainv) and torch.equal(rv2, rv)


@pytest.mark.cuda
def test_smoother_setup_waits_for_nothing(cuda):
    """A whole multiplicative Vanka set-up on the card (V2 a colour, V1's
    plan) under torch's sync debug mode "error": any host wait raises."""
    A, blocks = vk._ns_case(cuda, torch.float32)
    vanka.vanka_smoother(A, blocks)          # the libraries load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vanka.vanka_smoother(A, blocks, omega=0.9, iters=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ns", "race"])
def test_sweep_over_kernel_inverses_matches_plain(cuda, case):
    """V1 over V2's inverses and sweep_plain over the LU chain's, two
    sweeps in float32, each against the float64 sweep over float64
    inverses: both within float32 rounding of it.  On the seeded
    Navier-Stokes Jacobian the blocks are poorly conditioned and the sweep
    grows to 2.9e6; numpy's float32 Gauss-Jordan reads 3.6e-5 of that, the
    LU chain 7.9e-6 (the race case 1.2e-7 both)."""
    A, blocks = (vk._ns_case if case == "ns" else vk._race_case)(
        cuda, torch.float32)
    pairs = list(zip(blocks.color_dofs, blocks.color_slots))
    kern = [(d, *vanka._invert_blocks(A.data, d, s, blocks.n))
            for d, s in pairs]
    plain = [(d, *vanka.invert_plain(A.data, d, s, blocks.n))
             for d, s in pairs]
    A64 = SparseOp(A.data.double(), A.cols, A.n_cols)
    exact = [(d, *vanka.invert_plain(A64.data, d, s, blocks.n))
             for d, s in pairs]
    b, x = vk._vectors(A.n_rows, torch.float32, cuda)
    plan = vanka.colour_plan(A.data.contiguous(), A.cols.contiguous(), kern,
                             A.n_rows)
    got = vanka.vanka_sweep_cuda(plan, b, x, 0.9, 2).double()
    ref = vanka.sweep_plain(A, plain, b, x, 0.9, 2).double()
    r64 = vanka.sweep_plain(A64, exact, b.double(), x.double(), 0.9, 2)
    scale = float(r64.abs().max())
    err_k = float((got - r64).abs().max()) / scale
    err_p = float((ref - r64).abs().max()) / scale
    print(f"{case}: V1 over V2 {err_k:.3e}, plain over LU {err_p:.3e}")
    assert err_k <= 2e-4 and err_p <= 2e-4
