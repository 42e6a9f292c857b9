"""CUDA kernels of the port against their plain PyTorch versions.

These tests need an NVIDIA card and the CUDA toolkit; without a card they
skip.  On the card (where JAX is absent, so the repo's conftest is skipped):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from femus_tpu_torch.algebra import bell
from femus_tpu_torch.algebra import dia
from femus_tpu_torch.algebra import patchstencil as ps
from femus_tpu_torch.algebra import stencil
from femus_tpu_torch.assembly.bc import generate_bdc
from femus_tpu_torch.assembly.engine import Assembler, Unknown
from femus_tpu_torch.assembly.forms import elasticity, navier_stokes, poisson
from femus_tpu_torch.assembly.lattice import (build_lattice_plan,
                                              make_lattice_assemble_fn)
from femus_tpu_torch.mesh.generation import unit_box
from femus_tpu_torch.mesh.patches import refine_patched


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def _ns_jacobian():
    """Q2/Q2/P1dc Navier-Stokes Jacobian at a seeded random state (host)."""
    asm = Assembler(unit_box((8, 8)), [Unknown("u"), Unknown("v"),
                                       Unknown("p", "disc_linear")],
                    interleave=True, device="cpu")
    asm.set_volume_form(navier_stokes(("u", "v"), "p",
                                      pres_family="disc_linear", nu=0.01))
    u = np.random.default_rng(0).standard_normal(asm.n_dofs)
    _, data = asm.make_assemble_fn()(torch.as_tensor(u))
    return asm.pattern, data


# f32: the kernel and the plain version sum in different orders, so the
# error is held at a float32 rounding budget of max(|A| |x|); f64 likewise
# at a float64 budget; a bf16 slab multiplies into float32 in both
@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype,x_dtype,rtol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.float64, torch.float64, 1e-12),
    (torch.bfloat16, torch.float32, 1e-5),
])
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("order", ["identity", None])
def test_bell_kernel_matches_plain(cuda, slab_dtype, x_dtype, rtol, tile,
                                   order):
    pattern, data = _ns_jacobian()
    plan = bell.build_bell_plan(pattern, tile=tile, perm=order)
    op = bell.relayout_ell(plan, data, dtype=slab_dtype, device=cuda)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(plan.n),
                        dtype=x_dtype, device=cuda)
    n0 = bell.spmv_bell_cuda.launches
    y = op.matvec_frame(x)
    torch.cuda.synchronize()
    assert bell.spmv_bell_cuda.launches == n0 + 1
    y_ref = bell._matvec_plain_frame(op, x)
    scale = bell._matvec_plain_frame(bell.BellOp(op.blocks.abs(), op.dev),
                                     x.abs()).abs().max()
    assert y.dtype == x_dtype and y.shape == (plan.n,)
    assert float((y - y_ref).abs().max()) <= rtol * float(scale)
    # deterministic: no atomics, so a second launch repeats bit for bit
    assert torch.equal(op.matvec_frame(x), y)


@pytest.mark.cuda
def test_bell_kernel_rejects_bad_input(cuda):
    pattern, data = _ns_jacobian()
    plan = bell.build_bell_plan(pattern, perm="identity")
    op = bell.relayout_ell(plan, data, dtype=torch.float32, device=cuda)
    x = torch.ones(plan.n, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        op.matvec_frame(x)
    with pytest.raises(ValueError):
        op.matvec_frame(torch.ones(plan.n + 1, device=cuda))


def _patch_op(nv: int, dtype, device):
    """Eliminated patch operator on refine_patched(unit_box((5, 3)), 3)
    (H=17, P=15 padded to 128): Poisson (nv=1) or elasticity (nv=2) at a
    seeded random state, assembled on the host."""
    mesh, plan = refine_patched(unit_box((5, 3)), 3)
    names = ["u"] if nv == 1 else ["DX", "DY"]
    asm = Assembler(mesh, [Unknown(n) for n in names], device="cpu")
    asm.set_volume_form(poisson("u") if nv == 1 else
                        elasticity(("DX", "DY"), lam=1.2, mu=0.8))
    generate_bdc(asm, lambda var, x, grp, t: (grp == 1, 0.0))
    asm.set_patch_layout(plan)
    u = np.random.default_rng(2).standard_normal(asm.n_dofs)
    _, data = asm.make_assemble_fn()(torch.as_tensor(u))
    op = asm.op_with(data)
    return ps.make_block_patch_op(asm.patch_tab, op.wt.to(device, dtype), nv) \
        if nv > 1 else ps.make_patch_op(asm.patch_tab, op.wt.to(device, dtype))


# same float32/float64 budgets as B1: the kernel fuses multiply-adds and
# skips the zero ring, the plain version does neither
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("nv", [1, 2])
def test_patch_kernel_matches_plain(cuda, dtype, rtol, nv):
    op = _patch_op(nv, dtype, cuda)
    nb = op.meta[6]
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(nb * nv),
                        dtype=dtype, device=cuda)
    absop = dataclasses.replace(op, wt=op.wt.abs())
    for vr in range(nv):
        acc = acc_ref = scale = None
        for vc in range(nv):
            ins = op._inputs(x[vc * nb:(vc + 1) * nb])
            n0 = ps.spmv_patch_cuda.launches
            acc = ps.spmv_patch_cuda(op._pair(vr, vc) if nv > 1 else op.wt,
                                     *ins, out=acc)
            torch.cuda.synchronize()
            assert ps.spmv_patch_cuda.launches == n0 + 1
            ref = ps._patch_chunk_plain(op._pair(vr, vc) if nv > 1
                                        else op.wt, *ins)
            acc_ref = ref if acc_ref is None else tuple(
                a + b for a, b in zip(acc_ref, ref))
            ab = ps._patch_chunk_plain(
                absop._pair(vr, vc) if nv > 1 else absop.wt,
                *(t.abs() for t in ins))
            scale = ab if scale is None else tuple(
                a + b for a, b in zip(scale, ab))
        for got, want, s in zip(acc, acc_ref, scale):
            assert got.dtype == dtype and got.shape == want.shape
            assert float((got - want).abs().max()) <= rtol * float(s.max())
    # the operator's CUDA matvec runs the kernel, nv*nv launches, and
    # repeats bit for bit (no atomics)
    n0 = ps.spmv_patch_cuda.launches
    y = op.matvec(x)
    assert ps.spmv_patch_cuda.launches == n0 + nv * nv
    assert torch.equal(op.matvec(x), y)


@pytest.mark.cuda
def test_patch_kernel_rejects_bad_input(cuda):
    op = _patch_op(1, torch.float32, cuda)
    xi, ln, cv = op._inputs(torch.ones(op.n_rows, device=cuda))
    with pytest.raises(TypeError):
        ps.spmv_patch_cuda(op.wt, xi.double(), ln, cv)
    with pytest.raises(ValueError):
        ps.spmv_patch_cuda(op.wt, xi[:-1], ln, cv)
    with pytest.raises(ValueError):
        ps.spmv_patch_cuda(op.wt, xi.cpu(), ln, cv)


def _dia_case(case: str, dtype, device):
    """A DIA operator: "assembled" = Q2 Poisson on unit_box((6, 6)) through
    the ELL -> DIA relayout; the others hold seeded random data, where the
    flattened form wraps across lattice rows: "random" (n = 4099, not a
    multiple of the block size, offsets of both signs), "single" (K = 1,
    one negative offset), "wide" (offsets beyond n on both sides)."""
    if case == "assembled":
        asm = Assembler(unit_box((6, 6)), [Unknown("u")], device="cpu")
        asm.set_volume_form(poisson("u"))
        generate_bdc(asm, lambda var, x, grp, t: (True, 0.0))
        _, data = asm.make_assemble_fn()(torch.zeros(asm.n_dofs,
                                                     dtype=torch.float64))
        op = dia.build_dia_plan(asm.pattern).apply(data, asm.n_dofs)
        return dia.DiaOp(op.data.to(device, dtype).contiguous(), op.offsets,
                         op.n)
    n, offs = {"random": (4099, (-33, -1, 0, 1, 33)),
               "single": (1000, (-7,)),
               "wide": (300, (-400, -299, 0, 5, 299, 400))}[case]
    data = np.random.default_rng(3).standard_normal((len(offs), n))
    return dia.DiaOp(torch.as_tensor(data, dtype=dtype, device=device),
                     offs, n)


# same float32/float64 budgets as B1: the kernel fuses multiply-adds and
# skips out-of-range terms, the plain version pads x with zeros
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("case", ["assembled", "random", "single", "wide"])
def test_dia_kernel_matches_plain(cuda, dtype, rtol, case):
    op = _dia_case(case, dtype, cuda)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(op.n),
                        dtype=dtype, device=cuda)
    n0 = dia.spmv_dia_cuda.launches
    y = op.matvec(x)
    torch.cuda.synchronize()
    assert dia.spmv_dia_cuda.launches == n0 + 1
    ref = dia._matvec_plain(op.data, op.offsets, x)
    scale = dia._matvec_plain(op.data.abs(), op.offsets, x.abs()).max()
    assert y.dtype == dtype and y.shape == (op.n,)
    assert float((y - ref).abs().max()) <= rtol * float(scale)
    assert torch.equal(op.matvec(x), y)       # no atomics: bit-identical


def _stencil_case(case: str, dtype, device):
    """A lattice-stencil operator: "assembled" = Q2 Poisson on
    unit_box((6, 6)) from the scatter-free lattice assembly; "random" =
    seeded random data on a 37 x 53 lattice with offsets reaching +-8
    (odd sizes; x must read zero wherever i+di or j+dj leaves the
    lattice); "single" = one offset on a lattice narrower than a warp."""
    if case == "assembled":
        asm = Assembler(unit_box((6, 6)), [Unknown("u")], device="cpu")
        asm.set_volume_form(poisson("u"))
        generate_bdc(asm, lambda var, x, grp, t: (True, 0.0))
        plan = build_lattice_plan(asm)
        _, op = make_lattice_assemble_fn(asm, plan)(
            torch.zeros(asm.n_dofs, dtype=torch.float64),
            asm.device_tables_cached())
        return stencil.StencilOp(op.data.to(device, dtype).contiguous(),
                                 op.offsets, op.grid)
    grid, offs = {"random": ((37, 53), ((-8, -8), (-8, 8), (-3, 0), (0, -8),
                                        (0, 0), (0, 1), (2, -5), (8, -8),
                                        (8, 8))),
                  "single": ((9, 5), ((1, -2),))}[case]
    data = np.random.default_rng(4).standard_normal((len(offs),) + grid)
    return stencil.StencilOp(torch.as_tensor(data, dtype=dtype,
                                             device=device), offs, grid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("case", ["assembled", "random", "single"])
def test_stencil_kernel_matches_plain(cuda, dtype, rtol, case):
    op = _stencil_case(case, dtype, cuda)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(op.n_rows),
                        dtype=dtype, device=cuda)
    n0 = stencil.spmv_stencil_cuda.launches
    y = op.matvec(x)
    torch.cuda.synchronize()
    assert stencil.spmv_stencil_cuda.launches == n0 + 1
    ref = stencil._matvec_plain(op.data, op.offsets, op.grid, x)
    scale = stencil._matvec_plain(op.data.abs(), op.offsets, op.grid,
                                  x.abs()).max()
    assert y.dtype == dtype and y.shape == (op.n_rows,)
    assert float((y - ref).abs().max()) <= rtol * float(scale)
    assert torch.equal(op.matvec(x), y)       # no atomics: bit-identical


@pytest.mark.cuda
def test_lattice_kernels_reject_bad_input(cuda):
    d = _dia_case("random", torch.float32, cuda)
    with pytest.raises(TypeError):
        d.matvec(torch.ones(d.n, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        d.matvec(torch.ones(d.n + 1, device=cuda))
    with pytest.raises(ValueError):
        dia.spmv_dia_cuda(d, torch.ones(d.n))
    s = _stencil_case("random", torch.float32, cuda)
    with pytest.raises(TypeError):
        s.matvec(torch.ones(s.n_rows, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        s.matvec(torch.ones(s.n_rows - 1, device=cuda))
    far = stencil.StencilOp(s.data[:1].contiguous(), ((9, 0),), s.grid)
    with pytest.raises(ValueError):
        far.matvec(torch.ones(s.n_rows, device=cuda))


@pytest.mark.parametrize("H,P", [(3, 1), (17, 15), (33, 1024)])
def test_patch_bound_counts_what_the_kernel_reads(H, P):
    """chip_smoke's B2 bound: every weight whose window position lies in
    the H x H lattice (the rest multiply the zero ring), the inputs and
    the partials once each."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import patch_kernel_work

    E = H - 2
    ones = (torch.ones(E, E, P), torch.ones(E, 4, P), torch.ones(4, P))
    X = ps._window(*ones)
    read = sum(int(X[a:a + H, b:b + H].count_nonzero())
               for a, b in (divmod(k, 5) for k in range(ps.K)))
    vectors = 2 * sum(t.numel() for t in ones)
    assert patch_kernel_work(H, P, 4) == (4 * (read + vectors), 2 * read)
