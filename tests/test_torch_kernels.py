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
from femus_tpu_torch.algebra import patchstencil as ps
from femus_tpu_torch.assembly.bc import generate_bdc
from femus_tpu_torch.assembly.engine import Assembler, Unknown
from femus_tpu_torch.assembly.forms import elasticity, navier_stokes, poisson
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
