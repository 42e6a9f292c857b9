"""CUDA kernels of the port against their plain PyTorch versions.

These tests need an NVIDIA card and the CUDA toolkit; without a card they
skip.  On the card (where JAX is absent, so the repo's conftest is skipped):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from femus_tpu_torch.algebra import bell
from femus_tpu_torch.assembly.engine import Assembler, Unknown
from femus_tpu_torch.assembly.forms import navier_stokes
from femus_tpu_torch.mesh.generation import unit_box


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
