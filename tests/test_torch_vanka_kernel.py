"""The multiplicative Vanka sweep's CUDA kernel (``csrc/vanka_colour.cu``)
against its plain PyTorch version (``vanka.sweep_plain``).

The host tests walk the kernel's arithmetic in numpy (one warp a block row,
lanes striding the ELL slots, the shuffle tree; one thread a row of a block
inverse, in column order) and check that the plain path still serves host
tensors.  The tests marked ``cuda`` need an NVIDIA card and the CUDA
toolkit; without a card they skip.  On the card (no JAX there, so skip the repo's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_vanka_kernel.py
"""
import os
import sys

import numpy as np
import pytest
import torch

from femus_tpu_torch.algebra import vanka
from femus_tpu_torch.algebra.sparse import SparseOp, pattern_from_pairs
from femus_tpu_torch.assembly.engine import Assembler, Unknown
from femus_tpu_torch.assembly.forms import navier_stokes
from femus_tpu_torch.mesh.generation import unit_box
from femus_tpu_torch.utils import telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def _ns_case(device, dtype=torch.float64):
    """Q2/Q2/P1dc Navier-Stokes Jacobian at a seeded state (rows of up to
    62 ELL slots, padded) and its two-element Vanka blocks."""
    asm = Assembler(unit_box((6, 6)), [Unknown("u"), Unknown("v"),
                                       Unknown("p", "disc_linear")],
                    interleave=True, device="cpu")
    asm.set_volume_form(navier_stokes(("u", "v"), "p",
                                      pres_family="disc_linear", nu=0.01))
    u = np.random.default_rng(0).standard_normal(asm.n_dofs)
    _, data = asm.make_assemble_fn()(torch.as_tensor(u))
    A = SparseOp(data.to(device=device, dtype=dtype),
                 torch.as_tensor(asm.pattern.cols, dtype=torch.int64,
                                 device=device), asm.pattern.n_cols)
    return A, vanka.build_element_blocks(asm, 2, device=device)


def _race_case(device, dtype=torch.float64):
    """Eight dofs, a dense operator, blocks {0, 1, 2} and {3, 4} of colour
    0 and {5, 6} and {7} of colour 1 (padded to 3 dofs): every row of a
    block reads x at the dofs the other block of its colour updates."""
    n = 8
    rng = np.random.default_rng(5)
    r, c = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pat = pattern_from_pairs(r.ravel(), c.ravel(), n, n)
    dense = rng.uniform(-1, 1, (n, n)) + 4 * np.eye(n)
    data = dense[np.arange(n)[:, None], pat.cols]
    colours = [np.array([[0, 1, 2], [3, 4, n]]),
               np.array([[5, 6, n], [7, n, n]])]
    lut = vanka.lut_with_miss(pat)
    dofs, slots = [], []
    for d in colours:
        bi = np.repeat(d, 3, axis=1).reshape(-1, 3, 3)
        bj = np.tile(d, (1, 3)).reshape(-1, 3, 3)
        dofs.append(torch.as_tensor(d, device=device))
        slots.append(torch.as_tensor(
            lut(bi.ravel(), bj.ravel()).reshape(bi.shape), device=device))
    blocks = vanka.VankaBlocks(tuple(dofs), tuple(slots),
                               torch.ones(n, dtype=dtype, device=device), n)
    A = SparseOp(torch.as_tensor(data, dtype=dtype, device=device),
                 torch.as_tensor(pat.cols, dtype=torch.int64, device=device),
                 n)
    return A, blocks


def _per_color(A, blocks):
    return [(d, *vanka._invert_blocks(A.data, d, s, blocks.n))
            for d, s in zip(blocks.color_dofs, blocks.color_slots)]


def _vectors(n, dtype, device, seed=11):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                            device=device)
            for _ in range(2))


# ---------------------------------------------------------------- host ----

def _lane_tree(v):
    """The kernel's shuffle tree over the last axis (32 lanes): every lane
    ends with the same sum; lane 0's is returned."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def _lane_sums(prod):
    """Each lane's running sum over the slots j = lane, lane + 32, ...
    (prod: (..., width)), in the kernel's order."""
    w = prod.shape[-1]
    pad = np.zeros(prod.shape[:-1] + (-(-w // 32) * 32,))
    pad[..., :w] = prod
    chunks = pad.reshape(prod.shape[:-1] + (-1, 32))
    acc = np.zeros(prod.shape[:-1] + (32,))
    for c in range(chunks.shape[-2]):
        acc = acc + chunks[..., c, :]
    return acc


def _kernel_walk(data, cols, per_color, b, x, omega, iters, n):
    """numpy emulation of vanka_colour.cu: per colour, the residual
    kernel's block rows (a zero slot reads nothing), then the update
    kernel's block solves and writes, on a copy of x."""
    y = x.copy()
    for _ in range(iters):
        for d, ainv in per_color:
            bs = d.shape[1]
            rows = d.reshape(-1)
            real = rows < n
            dr = np.where(real, rows, 0)
            v = data[dr]
            prod = np.where(v != 0, v * y[cols[dr]], 0.0)
            r = np.where(real, b[dr] - _lane_tree(_lane_sums(prod)), 0.0)
            r = r.reshape(-1, bs)
            delta = np.zeros(r.shape)
            for j in range(bs):          # one thread a row, column order
                delta = delta + ainv[:, :, j] * r[:, j][:, None]
            ok = d < n
            y[d[ok]] += omega * delta[ok]
    return y


def _walk(A, per_color, b, x, omega, iters):
    return _kernel_walk(A.data.numpy(), A.cols.numpy(),
                        [(d.numpy(), a.numpy()) for d, a, _ in per_color],
                        b.numpy(), x.numpy(), omega, iters, A.n_rows)


@pytest.mark.parametrize("case", ["ns", "race"])
def test_kernel_walk_matches_plain(case):
    A, blocks = (_ns_case if case == "ns" else _race_case)("cpu")
    per_color = _per_color(A, blocks)
    b, x = _vectors(A.n_rows, torch.float64, "cpu")
    ref = vanka.sweep_plain(A, per_color, b, x, 0.9, 2).numpy()
    got = _walk(A, per_color, b, x, 0.9, 2)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_race_case_tells_jacobi_from_gauss_seidel_in_a_colour():
    """Updating a colour's blocks one after the other (what a kernel that
    reads x while the colour's other blocks write it may do) gives another
    answer on the race case: the case can see that race."""
    A, blocks = _race_case("cpu")
    per_color = _per_color(A, blocks)
    b, x = _vectors(A.n_rows, torch.float64, "cpu")
    ref = vanka.sweep_plain(A, per_color, b, x, 1.0, 1)
    one_by_one = [(d[k:k + 1], a[k:k + 1], rv[k:k + 1])
                  for d, a, rv in per_color for k in range(d.shape[0])]
    raced = vanka.sweep_plain(A, one_by_one, b, x, 1.0, 1)
    assert float((raced - ref).abs().max()) > 1e-3 * float(ref.abs().max())


def test_plain_path_serves_host_tensors():
    A, blocks = _ns_case("cpu")
    sm = vanka.vanka_smoother(A, blocks, omega=0.9, iters=2)
    b, x = _vectors(A.n_rows, torch.float64, "cpu")
    x0 = x.clone()
    sites = telemetry.RECORDER.sites
    kern, plain = (sites.get("vanka.colour_kernel", 0),
                   sites.get("vanka.colour_torch", 0))
    y = sm(b, x)
    assert sites.get("vanka.colour_torch", 0) == plain + 2 * blocks.n_colors
    assert sites.get("vanka.colour_kernel", 0) == kern
    assert torch.equal(x, x0)
    per_color = _per_color(A, blocks)
    assert torch.equal(y, vanka.sweep_plain(A, per_color, b, x, 0.9, 2))


def test_kernel_wrapper_refuses_a_host_operator():
    A, blocks = _ns_case("cpu")
    per_color = _per_color(A, blocks)
    with pytest.raises(ValueError):
        vanka.colour_plan(A.data, A.cols, per_color, A.n_rows)


# ---------------------------------------------------------------- card ----

def _budget(A, colour, b, x, omega):
    """A rounding budget of one colour step: |x| + omega |Ainv| (|b| +
    |A| |x|) at the colour's dofs (0 elsewhere)."""
    d, ainv, rv = colour
    n = x.shape[0]
    acc = ainv.dtype
    absA = SparseOp(A.data.abs(), A.cols, A.n_cols)
    rb = (b.abs() + (absA @ x.abs()).to(acc))
    rb = torch.cat([rb, rb.new_zeros(1)])[d] * rv
    u = torch.bmm(ainv.abs(), rb[:, :, None])[:, :, 0] * rv
    upd = x.new_zeros(n + 1).index_add_(0, d.reshape(-1), u.reshape(-1))[:n]
    return x.abs() + abs(omega) * upd


def _check_sweep(A, blocks, dtype, rtol, omega=0.9):
    """Each colour step from the same x, then two whole sweeps: the kernel
    against the plain chain with the same inverses.  A colour step is held
    to rtol times its rounding budget; the whole sweeps to rtol times the
    budget of their largest step times the steps taken."""
    dev = A.data.device
    vec = torch.float64 if dtype == torch.float64 else torch.float32
    A = SparseOp(A.data.to(dtype).contiguous(), A.cols.contiguous(),
                 A.n_cols)
    per_color = _per_color(A, blocks)
    b, x = _vectors(A.n_rows, vec, dev)
    worst, steps = 0.0, []
    for colour in per_color:
        plan = vanka.colour_plan(A.data, A.cols, [colour], A.n_rows)
        got = vanka.vanka_sweep_cuda(plan, b, x, omega)
        ref = vanka.sweep_plain(A, [colour], b, x, omega)
        budget = float(_budget(A, colour, b, x, omega).max())
        steps.append(budget)
        worst = max(worst, float((got - ref).abs().max()) / budget)
    assert worst <= rtol, (worst, rtol)
    plan = vanka.colour_plan(A.data, A.cols, per_color, A.n_rows)
    n0 = vanka.vanka_sweep_cuda.launches
    got = vanka.vanka_sweep_cuda(plan, b, x, omega, 2)
    torch.cuda.synchronize()
    assert vanka.vanka_sweep_cuda.launches == n0 + 4 * len(per_color)
    ref = vanka.sweep_plain(A, per_color, b, x, omega, 2)
    whole = float((got - ref).abs().max()) / (max(steps) * 2 * len(steps))
    assert whole <= rtol, (whole, rtol)
    # the same inputs give the same bits
    assert torch.equal(vanka.vanka_sweep_cuda(plan, b, x, omega, 2), got)
    return worst, whole


def _captured_levels(build):
    """(operator, blocks) of every multiplicative Vanka smoother that one
    solve of ``build()``'s system builds, the finest solve's last."""
    sys.path.insert(0, ROOT)
    from chip_smoke import recorded_vanka

    with recorded_vanka([]) as seen:
        build().solve()
    return [(A, blocks) for A, blocks, _ in seen]


@pytest.fixture(scope="module")
def hierarchies():
    """The levels of each case, built once for the module's tests."""
    return {}


def _levels(case, device, cache):
    """The Vanka levels of the last hierarchy a small solve built: the
    DFG channel of ns_bench (44 x 8 coarse cells, 3 levels, float32, the
    finest on the BELL frame, the middle one a Galerkin PtAP pattern) or
    fsi-bed (4 x 4, 3 levels, float64, material blocks)."""
    if case not in cache:
        if case == "channel":
            sys.path.insert(0, ROOT)      # chip_smoke's channel writer
            import tempfile
            from chip_smoke import channel_neu
            from femus_tpu_torch.apps import ns_bench

            def build():
                path = channel_neu(os.path.join(tempfile.mkdtemp(),
                                                "channel.neu"), 44, 8)
                _, s = ns_bench.make_ns_system(
                    levels=3, rtol=1e-4, interleave=True, mesh_path=path,
                    device=device, dtype=torch.float32)
                s.config.operator = "bell"
                s.config.max_nonlinear = 1
                return s
        else:
            from femus_tpu_torch.parallel import cases

            def build():
                return cases.fsi_bed(4, 3, device, torch.float64, 1e-6,
                                     transient=False, lid=0.02,
                                     max_nonlinear=1)
        seen = _captured_levels(build)
        ns = sorted({A.n_rows for A, _ in seen})
        last = {A.n_rows: (A, blocks) for A, blocks in seen}
        cache[case] = [last[k] for k in ns]
    return cache[case]


# f64: a float64 rounding budget; f32 and bf16-stored values: float32
# vectors, inverses and sums, so a float32 budget
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("case", ["channel", "fsi"])
def test_sweep_kernel_matches_plain(cuda, hierarchies, case, dtype, rtol):
    levels = _levels(case, cuda, hierarchies)
    assert len(levels) >= 2
    for A, blocks in levels:
        worst, whole = _check_sweep(A, blocks, dtype, rtol)
        print(f"{case} n={A.n_rows} bs={blocks.color_dofs[0].shape[1]} "
              f"colours={blocks.n_colors} {dtype}: step {worst:.3e}, "
              f"sweeps {whole:.3e} of the budget")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
def test_race_case_on_card(cuda, dtype, rtol):
    A, blocks = _race_case(cuda, dtype)
    _check_sweep(A, blocks, dtype, rtol, omega=1.0)


@pytest.mark.cuda
def test_smoother_leaves_the_callers_x_unwritten(cuda):
    A, blocks = _ns_case(cuda, torch.float32)
    sm = vanka.vanka_smoother(A, blocks, omega=0.9, iters=2)
    b, x = _vectors(A.n_rows, torch.float32, cuda)
    x0 = x.clone()
    sites = telemetry.RECORDER.sites
    kern, plain = (sites.get("vanka.colour_kernel", 0),
                   sites.get("vanka.colour_torch", 0))
    y = sm(b, x)
    torch.cuda.synchronize()
    assert torch.equal(x, x0) and y.data_ptr() != x.data_ptr()
    assert sites.get("vanka.colour_kernel", 0) == kern + 2 * blocks.n_colors
    assert sites.get("vanka.colour_torch", 0) == plain
    assert not torch.equal(y, x0)


@pytest.mark.cuda
def test_sweep_kernel_rejects_bad_input(cuda):
    A, blocks = _ns_case(cuda, torch.float32)
    per_color = _per_color(A, blocks)
    plan = vanka.colour_plan(A.data, A.cols, per_color, A.n_rows)
    b, x = _vectors(A.n_rows, torch.float32, cuda)
    with pytest.raises(ValueError):          # a host tensor
        vanka.vanka_sweep_cuda(plan, b, x.cpu())
    with pytest.raises(TypeError):           # not the inverses' dtype
        vanka.vanka_sweep_cuda(plan, b, x.double())
    with pytest.raises(TypeError):
        vanka.vanka_sweep_cuda(plan, b.half(), x)
    with pytest.raises(ValueError):          # not contiguous
        vanka.vanka_sweep_cuda(plan, b, torch.stack([x, x], 1)[:, 0])
    with pytest.raises(ValueError):          # not n long
        vanka.vanka_sweep_cuda(plan, b, x[:-1])
    with pytest.raises(ValueError):          # a non-contiguous operator
        vanka.colour_plan(A.data.t().contiguous().t(), A.cols, per_color,
                          A.n_rows)
    with pytest.raises(TypeError):           # half-precision values
        vanka.colour_plan(A.data.half(), A.cols, per_color, A.n_rows)
    with pytest.raises(TypeError):           # int32 columns
        vanka.colour_plan(A.data, A.cols.int(), per_color, A.n_rows)
