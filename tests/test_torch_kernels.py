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


def _holed_pattern():
    """Random pattern with empty rows, rows without a diagonal entry and a
    row count (301) that is no multiple of the slice height."""
    from femus_tpu_torch.algebra.sparse import pattern_from_pairs
    rng = np.random.default_rng(7)
    n = 301
    r = np.concatenate([np.arange(5, n), rng.integers(0, n, 2000)])
    c = np.concatenate([np.arange(5, n), rng.integers(0, n, 2000)])
    keep = (r != 7) & (r != 100)
    pat = pattern_from_pairs(r[keep], c[keep], n, n)
    data = torch.as_tensor(rng.standard_normal(pat.cols.shape) * pat.valid)
    return pat, data


def _abs_op(op):
    return bell.BellOp(op.vals.abs(), op.dev)


# f32: the kernel and the plain version sum in different orders, so the
# error is held at a float32 rounding budget of max(|A| |x|); f64 likewise
# at a float64 budget; bf16 values multiply into float32 in both
@pytest.mark.cuda
@pytest.mark.parametrize("val_dtype,x_dtype,rtol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.float64, torch.float64, 1e-12),
    (torch.bfloat16, torch.float32, 1e-5),
    (torch.float32, torch.float64, 1e-12),
])
@pytest.mark.parametrize("case", ["ns", "holed"])
@pytest.mark.parametrize("order", ["identity", None])
@pytest.mark.parametrize("sigma", [32, None])
def test_bell_kernel_matches_plain(cuda, val_dtype, x_dtype, rtol, case,
                                   order, sigma):
    pattern, data = _ns_jacobian() if case == "ns" else _holed_pattern()
    plan = bell.build_sell_plan(pattern, order,
                                **({} if sigma is None else {"sigma": sigma}))
    op = bell.relayout_ell(plan, data, dtype=val_dtype, device=cuda)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(plan.n),
                        dtype=x_dtype, device=cuda)
    n0 = bell.spmv_bell_cuda.launches
    y = op.matvec_frame(x)
    torch.cuda.synchronize()
    assert bell.spmv_bell_cuda.launches == n0 + 1
    y_ref = bell._matvec_plain_frame(op, x)
    scale = bell._matvec_plain_frame(_abs_op(op), x.abs()).abs().max()
    assert y.dtype == x_dtype and y.shape == (plan.n,)
    assert float((y - y_ref).abs().max()) <= rtol * float(scale)
    # deterministic: no atomics, so a second launch repeats bit for bit
    assert torch.equal(op.matvec_frame(x), y)
    # the whole operator interface rides the kernel
    n0 = bell.spmv_bell_cuda.launches
    assert torch.equal(op.matvec(op.from_frame(x)), op.from_frame(y))
    assert bell.spmv_bell_cuda.launches == n0 + 1


@pytest.mark.cuda
def test_bell_kernel_rejects_bad_input(cuda):
    pattern, data = _ns_jacobian()
    plan = bell.build_sell_plan(pattern, "identity")
    op = bell.relayout_ell(plan, data, dtype=torch.float32, device=cuda)
    x = torch.ones(plan.n, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        op.matvec_frame(x)
    with pytest.raises(ValueError):
        op.matvec_frame(torch.ones(plan.n + 1, device=cuda))
    with pytest.raises(ValueError):
        bell.spmv_bell_cuda(bell.BellOp(op.vals[:-1], op.dev),
                            torch.ones(plan.n, device=cuda))
    with pytest.raises(ValueError):
        bell.spmv_bell_cuda(op, torch.ones(plan.n))
    with pytest.raises(TypeError):
        bell.spmv_bell_cuda(bell.BellOp(op.vals.half(), op.dev),
                            torch.ones(plan.n, device=cuda))


def _fsi_jacobian():
    """Monolithic FSI Jacobian (dx, dy, u, v Q2, p P1dc, interleaved; an
    elastic bed in the bottom quarter) at a seeded random state (host):
    rows of 39 to 112 entries."""
    from femus_tpu_torch.systems.fsi import fsi_steady_form
    mesh = unit_box((8, 8))
    cent = mesh.coords[mesh.conn].mean(axis=1)
    mesh.elem_group = np.where(cent[:, 1] < 0.25, 1, 0).astype(np.int32)
    asm = Assembler(mesh, [Unknown(n) for n in ("dx", "dy", "u", "v")]
                    + [Unknown("p", "disc_linear")], interleave=True,
                    device="cpu")
    asm.set_volume_form(fsi_steady_form(
        solid_groups=(1,), pres_family="disc_linear", nu=0.05, lam=50.0,
        mu=50.0))
    rng = np.random.default_rng(3)
    u = rng.standard_normal(asm.n_dofs)
    for name in ("dx", "dy"):
        off, n = asm.offsets[name], asm.dofmaps[name].n_dofs
        u[asm.stack_perm[off:off + n]] *= 0.002      # det F > 0
    _, data = asm.make_assemble_fn()(torch.as_tensor(u))
    assert bool(torch.isfinite(data).all())
    return asm.pattern, data


@pytest.mark.cuda
@pytest.mark.parametrize("val_dtype,rtol", [(torch.float32, 1e-5),
                                            (torch.float64, 1e-12)])
@pytest.mark.parametrize("order", ["identity", None])
def test_bell_kernel_on_fsi_jacobian(cuda, val_dtype, rtol, order):
    """B1 on the uneven rows of an FSI Jacobian, in the plan a solve
    builds, against its plain version; the layout's fill is reported."""
    pattern, data = _fsi_jacobian()
    counts = pattern.valid.sum(axis=1)
    assert counts.min() == 39 and counts.max() == 112
    sell = bell.build_sell_plan(pattern, order)
    assert 1.0 <= sell.fill < 1.5
    op = bell.relayout_ell(sell, data, dtype=val_dtype, device=cuda)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(sell.n),
                        dtype=val_dtype, device=cuda)
    n0 = bell.spmv_bell_cuda.launches
    y = op.matvec_frame(x)
    torch.cuda.synchronize()
    assert bell.spmv_bell_cuda.launches == n0 + 1
    y_ref = bell._matvec_plain_frame(op, x)
    scale = bell._matvec_plain_frame(_abs_op(op), x.abs()).abs().max()
    assert float((y - y_ref).abs().max()) <= rtol * float(scale)
    assert torch.equal(op.matvec_frame(x), y)


def _rotated(coarse):
    """The same coarse quad mesh with every second element's local frame
    turned a quarter (corners, mid-edge nodes and boundary face ids shifted
    alike): neighbouring patches then disagree on the direction of their
    shared edge, which a generated box never has."""
    rot = np.arange(coarse.n_elems) % 2 == 1
    conn = coarse.conn.copy()
    conn[rot] = coarse.conn[rot][:, [1, 2, 3, 0, 5, 6, 7, 4, 8]]
    return dataclasses.replace(coarse, conn=conn, boundary={
        k: dataclasses.replace(b, iface=np.where(
            rot[b.elem], (b.iface - 1) % 4, b.iface).astype(b.iface.dtype))
        for k, b in coarse.boundary.items()})


def _patch_op(nv: int, dtype, device, ns=(5, 3), levels=3, rotate=False):
    """Eliminated patch operator on refine_patched(unit_box(ns), levels)
    (default H=17, P=15 padded to 128): Poisson (nv=1) or elasticity
    (nv=2) at a seeded random state, assembled on the host; ``rotate``:
    every second coarse element's local frame turned a quarter, so patch
    faces run against their edges."""
    coarse = _rotated(unit_box(ns)) if rotate else unit_box(ns)
    mesh, plan = refine_patched(coarse, levels)
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


def _random_patch_op(H: int, P: int, nv: int, dtype, device):
    """Patch operator with seeded random weights (zero in the padding
    patches) on a strip of P coarse elements with H lattice nodes per
    side; rotated frames, so some faces are flipped.  The coarse topology
    does not depend on the depth, so the plan is the once-refined one with
    H set."""
    _, plan = refine_patched(_rotated(unit_box((P, 1))), 1)
    plan = dataclasses.replace(plan, H=H, E=H - 2, n_int=P * (H - 2) ** 2)
    tab = ps.build_patch_tables(plan)
    assert (tab.H, tab.P) == (H, P)
    assert P == 1 or (tab.face_code % 2 == 1).any()
    gen = torch.Generator().manual_seed(5)
    wt = torch.randn(nv * nv * ps.K, H, H, tab.Pp, generator=gen,
                     dtype=torch.float64)
    wt[..., P:] = 0.0
    wt = wt.to(device, dtype)
    return ps.make_block_patch_op(tab, wt, nv) if nv > 1 \
        else ps.make_patch_op(tab, wt)


def _check_patch_matvec(op, dtype, rtol):
    """The whole CUDA matvec of ``op`` against the plain version on the
    same tensors, at a rounding budget of max(|A| |x|)."""
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(op.n_rows),
                        dtype=dtype, device=op.wt.device)
    n0 = ps.spmv_patch_cuda.launches
    y = op.matvec(x)
    torch.cuda.synchronize()
    # one wrapper call per matvec, scalar or block
    assert ps.spmv_patch_cuda.launches == n0 + 1
    ref = ps._patch_matvec_plain(op, x)
    scale = ps._patch_matvec_plain(dataclasses.replace(op, wt=op.wt.abs()),
                                   x.abs()).max()
    assert y.dtype == dtype and y.shape == ref.shape
    assert float((y - ref).abs().max()) <= rtol * float(scale)
    # no atomics: a second matvec repeats bit for bit
    assert torch.equal(op.matvec(x), y)
    # the two launches alone, partials carried in the scratch arrays
    H, P, Pp, E = op.meta[:4]
    scratch = (torch.zeros((op.nv, E, 4, Pp), dtype=dtype, device=x.device),
               torch.zeros((op.nv, 4, Pp), dtype=dtype, device=x.device))
    y1 = ps.spmv_patch_cuda(op, x, stages=ps.STENCIL, scratch=scratch)
    y2 = ps.spmv_patch_cuda(op, x, stages=ps.COMBINE, scratch=scratch)
    nb, n_int = op.meta[6], E * E * P
    for v in range(op.nv):
        assert torch.equal(y1[v * nb:v * nb + n_int], y[v * nb:v * nb + n_int])
        assert torch.equal(y2[v * nb + n_int:(v + 1) * nb],
                           y[v * nb + n_int:(v + 1) * nb])


# same float32/float64 budgets as B1: the kernel fuses multiply-adds and
# skips the zero ring, the plain version does neither
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("rotate", [False, True])
def test_patch_kernel_matches_plain(cuda, dtype, rtol, nv, rotate):
    _check_patch_matvec(_patch_op(nv, dtype, cuda, rotate=rotate), dtype,
                        rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("H,P", [(3, 1), (17, 15), (33, 1024), (9, 130)])
def test_patch_kernel_random_weights(cuda, dtype, rtol, nv, H, P):
    _check_patch_matvec(_random_patch_op(H, P, nv, dtype, cuda), dtype, rtol)


@pytest.mark.cuda
def test_patch_kernel_rejects_bad_input(cuda):
    op = _patch_op(1, torch.float32, cuda)
    x = torch.ones(op.n_rows, device=cuda)
    with pytest.raises(TypeError):
        ps.spmv_patch_cuda(op, x.double())
    with pytest.raises(ValueError):
        ps.spmv_patch_cuda(op, x[:-1])
    with pytest.raises(ValueError):
        ps.spmv_patch_cuda(op, x.cpu())
    with pytest.raises(ValueError):
        ps.spmv_patch_cuda(dataclasses.replace(op, wt=op.wt[:-1]), x)
    bad = dataclasses.replace(op.routing,
                              face_code=op.routing.face_code.long())
    with pytest.raises(TypeError):
        ps.spmv_patch_cuda(dataclasses.replace(op, routing=bad), x)


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
    the H x H lattice (the rest multiply the zero ring), x and y once
    each, and the four int32 routing tables."""
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
    n_edges, n_verts, maxval, Pp = 2 * P + 3, P + 2, 4, 128 * -(-P // 128)
    n = E * E * P + E * n_edges + n_verts
    tables = 8 * Pp + 2 * n_edges + maxval * n_verts
    assert patch_kernel_work(H, P, 4, n, tables) == (
        4 * (read + 2 * n) + 4 * tables, 2 * read)
    assert patch_kernel_work(H, P, 4, n, tables, nv=2) == (
        4 * (4 * read + 4 * n) + 4 * tables, 8 * read)


# ---- slice 6: block solvers, face assembly and the bf16 cycle on the card

def _fieldsplit_cases(device, dtype):
    """The field-split cavity (unit_box((16,16)), 2,467 dofs) on the BELL
    frame (kernel B1 on the card) and as the plain ELL operator, and the
    flat and nested preconditioners over each."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import fieldsplit_cavity, fieldsplit_preconditioners
    from femus_tpu_torch.algebra.sparse import SparseOp

    a, A, _, note = fieldsplit_cavity(16, device, dtype)
    assert note["path"] == "bell"
    plain = SparseOp(A.data, A.cols, A.n_cols)
    return (a, fieldsplit_preconditioners(a, A),
            fieldsplit_preconditioners(a, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_fieldsplit_on_bell_matches_plain(cuda, dtype, rtol):
    """One application of the flat Schur split and of the nested tree with
    every matvec through B1, against the same trees on the ELL operator."""
    a, on_bell, on_ell = _fieldsplit_cases(cuda, dtype)
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(a.n_dofs),
                        dtype=dtype, device=cuda)
    r[torch.as_tensor(a.dirichlet_mask, device=cuda)] = 0.0
    for name in on_bell:
        n0 = bell.spmv_bell_cuda.launches
        z_k = on_bell[name](r)
        assert bell.spmv_bell_cuda.launches > n0
        z_p = on_ell[name](r)
        err = float((z_k - z_p).abs().max())
        assert err <= rtol * float(z_p.abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("volume", [False, True])
def test_face_assembly_on_card_matches_host(cuda, volume):
    """R and the Jacobian with a face form (boundary-control KKT faces,
    or the Nitsche form) on the card against the host, in float64."""
    from femus_tpu_torch.assembly.forms import nitsche_dirichlet
    from femus_tpu_torch.systems.optimal_control import (
        boundary_control_forms)

    out = {}
    for dev in (cuda, torch.device("cpu")):
        a = Assembler(unit_box((6, 6)), [Unknown("y"), Unknown("l"),
                                         Unknown("u")],
                      dtype=torch.float64, device=dev)
        vol, face = boundary_control_forms(
            y_target=lambda x: torch.sin(np.pi * x[:, 0]), alpha=1e-2,
            control_groups=(2,))
        a.set_volume_form(vol)
        if volume:
            a.set_face_form(nitsche_dirichlet("y", groups=(1, 3)),
                            volume=True)
        else:
            a.set_face_form(face)
        u = torch.as_tensor(np.random.default_rng(3).standard_normal(
            a.n_dofs), device=dev)
        R, data = a.make_assemble_fn()(u)
        out[dev.type] = (R.cpu(), data.cpu())
    for k in range(2):
        ref = out["cpu"][k]
        assert float((out["cuda"][k] - ref).abs().max()) <= \
            1e-12 * float(ref.abs().max())


@pytest.mark.cuda
def test_bf16_cycle_on_card(cuda):
    """compute_dtype=bfloat16 with BELL plans: B1 multiplies bfloat16
    values into float32 vectors, the coarse LU is float32; the outer
    GMRES converges to the float32 V-cycle's solution of the small
    cavity."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import bf16_newton, cavity_system

    ref_sys, ref_sol = cavity_system(4, 3, cuda, torch.float32, rtol=1e-6,
                                     max_nonlinear=3)
    ref_sys.solve()
    sys_, sol = cavity_system(4, 3, cuda, torch.float32, rtol=1e-6,
                              max_nonlinear=3)
    n0 = bell.spmv_bell_cuda.launches
    hist = bf16_newton(sys_)
    assert bell.spmv_bell_cuda.launches > n0
    assert all(h["converged"] for h in hist)
    f = np.concatenate([sol.sol[-1][n] for n in ("u", "v", "p")])
    ref = np.concatenate([ref_sol.sol[-1][n] for n in ("u", "v", "p")])
    assert np.linalg.norm(f - ref) <= 1e-3 * np.linalg.norm(ref)


def _amr_reduced_operator():
    """The hanging-constraint-reduced Q2 Poisson operator C^T A C of a
    selectively refined unit_box((24, 24)) (the corner quarter refined
    twice), with the Dirichlet identity restored (host, float64)."""
    from femus_tpu_torch.mesh.amr import refine_selective
    from femus_tpu_torch.systems import amr
    from femus_tpu_torch.algebra.bell import BELL_MIN_ROWS

    mesh = unit_box((24, 24))
    for _ in range(2):
        cent = mesh.coords[mesh.conn[:, :4]].mean(axis=1)
        mesh = refine_selective(mesh, (cent < 0.25).all(axis=1))
    asm, C, free_idx, mask_f, sched = amr._reduced_system(
        mesh, [Unknown("u")], poisson("u", rhs=lambda x: 1.0 + 0.0 * x[:, 0]),
        lambda var, x, grp, t: (True, 0.0), device="cpu")
    u0 = amr._start(asm, C, free_idx, torch.float64, torch.device("cpu"))
    A, _, _ = amr._reduced_op(asm, C, free_idx, mask_f, sched, u0)
    assert C.shape[0] > C.shape[1] and A.n_rows >= BELL_MIN_ROWS
    return sched.coarse_pattern, A.data


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["amr", "rediscretized"])
def test_bell_kernel_on_new_callers(cuda, case):
    """B1 in float64 (the AMR solves' type; float32 too on a rediscretized
    level) on an AMR reduced operator and on a rediscretized coarse level
    (the middle level of a 12 x 12 -> 48 x 48 Poisson hierarchy, 2,401
    rows), in the plan the solve builds, against its plain version."""
    from femus_tpu_torch.algebra.bell import bell_device_plan
    if case == "amr":
        pattern, data = _amr_reduced_operator()
        dtypes = [(torch.float64, 1e-12)]
    else:
        a = Assembler(unit_box((24, 24)), [Unknown("u")], device="cpu")
        a.set_volume_form(poisson("u", rhs=lambda x: 1.0 + 0.0 * x[:, 0]))
        generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
        _, data = a.make_assemble_fn()(torch.zeros(a.n_dofs,
                                                   dtype=torch.float64))
        pattern = a.pattern
        assert pattern.n_rows == 2401
        dtypes = [(torch.float64, 1e-12), (torch.float32, 1e-5)]
    dev, note = bell_device_plan(pattern, "identity", cuda)
    assert note["path"] == "bell"
    for val_dtype, rtol in dtypes:
        op = bell.relayout_ell(dev, data, dtype=val_dtype, device=cuda)
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(dev.n),
                            dtype=val_dtype, device=cuda)
        n0 = bell.spmv_bell_cuda.launches
        y = op.matvec_frame(x)
        torch.cuda.synchronize()
        assert bell.spmv_bell_cuda.launches == n0 + 1
        y_ref = bell._matvec_plain_frame(op, x)
        scale = bell._matvec_plain_frame(_abs_op(op), x.abs()).abs().max()
        assert float((y - y_ref).abs().max()) <= rtol * float(scale)


@pytest.mark.cuda
def test_rediscretized_bell_solve_on_card(cuda):
    """A rediscretized Poisson V-cycle on the card runs B1 on the fine
    level and on the middle level, and agrees with the host solve."""
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import LinearImplicitSystem

    out = {}
    for device, dtype in ((cuda, torch.float64), ("cpu", torch.float64)):
        ml = MultiLevelMesh(unit_box((12, 12)), 3)
        sol = MultiLevelSolution(ml)
        sol.add_solution("u")
        sol.initialize("u")
        sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
        sol.generate_bdc("u")
        s = MultiLevelProblem(ml, sol).add_system(LinearImplicitSystem, "P")
        s.add_unknown("u")
        s.set_assembly(poisson("u", rhs=lambda x: 1.0 + 0.0 * x[:, 0]))
        s.config.operator = "bell"
        s.config.coarse_op = "rediscretize"
        s.config.rtol = 1e-10
        s.init(device=device, dtype=dtype)
        n0 = bell.spmv_bell_cuda.launches
        info = s.solve()
        assert info["converged"]
        out[str(device)] = (sol.sol[-1]["u"].copy(),
                            bell.spmv_bell_cuda.launches - n0, info)
        assert {n["n_rows"] for n in s.solver_info()["routing"]
                if n.get("path") == "bell"} == {2401, 9409}
    (u_c, k_c, i_c), (u_h, k_h, i_h) = out[str(cuda)], out["cpu"]
    assert k_c > 0 and k_h == 0
    assert i_c["iters"] == i_h["iters"]
    assert np.abs(u_c - u_h).max() <= 1e-10 * np.abs(u_h).max()


def _boussinesq_jacobian():
    """Boussinesq Jacobian (u, v, T Q2, p P1dc, interleaved: four unknowns
    per node) at a seeded random state (host)."""
    from femus_tpu_torch.assembly.forms import boussinesq
    asm = Assembler(unit_box((8, 8)), [Unknown("u"), Unknown("v"),
                                       Unknown("p", "disc_linear"),
                                       Unknown("T")],
                    interleave=True, device="cpu")
    asm.set_volume_form(boussinesq(("u", "v"), "p", "T",
                                   pres_family="disc_linear", ra=1e4,
                                   pr=0.71))
    u = np.random.default_rng(5).standard_normal(asm.n_dofs)
    _, data = asm.make_assemble_fn()(torch.as_tensor(u))
    return asm.pattern, data


def _nonlocal_operator(device):
    """The nonlocal-64 operator of chip_smoke.py: linear elements on
    unit_box((64, 64)), delta 0.1, 4,225 rows of up to 357 entries."""
    from femus_tpu_torch.assembly.nonlocal_diffusion import NonlocalOperator
    op = NonlocalOperator(unit_box((64, 64)), "linear", delta=0.1,
                          quad_order=3, device=device, dtype=torch.float64)
    assert op.pattern.width == 357
    return op.pattern, op._data


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["boussinesq", "nonlocal"])
def test_bell_kernel_on_slice8_operators(cuda, case, monkeypatch):
    """B1 on the Boussinesq Jacobian (float32 and bfloat16 values, the
    cavity solve's types) and on the width-357 nonlocal operator (float64),
    in the plan a solve builds, against its plain version."""
    from femus_tpu_torch.algebra.bell import bell_device_plan
    if case == "boussinesq":
        pattern, data = _boussinesq_jacobian()
        # 1,059 rows, under B1's row threshold: the plan in the frame a
        # larger cavity's solve would choose, built all the same
        monkeypatch.setattr(bell, "BELL_MIN_ROWS", 0)
        dtypes = [(torch.float32, torch.float32, 1e-5),
                  (torch.bfloat16, torch.float32, 1e-5)]
    else:
        pattern, data = _nonlocal_operator(cuda)
        dtypes = [(torch.float64, torch.float64, 1e-12)]
    dev, note = bell_device_plan(pattern, "identity", cuda)
    assert note["path"] == "bell"
    for val_dtype, x_dtype, rtol in dtypes:
        op = bell.relayout_ell(dev, data.to(cuda), dtype=val_dtype,
                               device=cuda)
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(dev.n),
                            dtype=x_dtype, device=cuda)
        n0 = bell.spmv_bell_cuda.launches
        y = op.matvec_frame(x)
        torch.cuda.synchronize()
        assert bell.spmv_bell_cuda.launches == n0 + 1
        y_ref = bell._matvec_plain_frame(op, x)
        scale = bell._matvec_plain_frame(_abs_op(op), x.abs()).abs().max()
        assert float((y - y_ref).abs().max()) <= rtol * float(scale)
        assert torch.equal(op.matvec_frame(x), y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["laplace_beltrami", "conformal"])
def test_manifold_assembly_on_card_matches_host(cuda, case):
    """Surface FE on the card against the host in float64: Laplace-Beltrami
    on the embedded half cylinder (element-last, first fundamental form)
    and the conformal energy's gradient and Hessian there (batch-first,
    vmap of jacfwd over torch.func.grad)."""
    from femus_tpu_torch.assembly.conformal import conformal_minimization
    from femus_tpu_torch.mesh.generation import map_to_surface

    def cyl(p):
        phi = np.pi * p[:, 0]
        return np.stack([np.cos(phi), np.sin(phi), p[:, 1]], axis=-1)

    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = map_to_surface(unit_box((6, 6)), cyl)
        if case == "laplace_beltrami":
            a = Assembler(mesh, [Unknown("u")], quad_order="seventh",
                          dtype=torch.float64, device=dev)
            a.set_volume_form(poisson("u", rhs=lambda x: x[:, 1] * torch.sin(
                np.pi * x[:, 2])))
            generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
        else:
            a = Assembler(mesh, [Unknown(n) for n in ("Dx1", "Dx2", "Dx3")],
                          dtype=torch.float64, device=dev)
            a.set_volume_form(conformal_minimization())
        u = torch.as_tensor(0.05 * np.random.default_rng(3).standard_normal(
            a.n_dofs), device=dev)
        R, data = a.make_assemble_fn()(u)
        out[dev.type] = (R.cpu(), data.cpu())
    for k in range(2):
        ref = out["cpu"][k]
        assert float((out["cuda"][k] - ref).abs().max()) <= \
            1e-12 * float(ref.abs().max())


@pytest.mark.cuda
def test_bell_kernel_on_read_mesh_operator(cuda, tmp_path):
    """B1 on the Q2 Poisson operator of a mesh read from a Gambit .neu file
    (unit_box((16,16)) written by chip_smoke.write_neu, read back, refined
    twice: 16,641 rows), in the plan a solve builds, against its plain
    version in float64 and float32."""
    from chip_smoke import write_neu
    from femus_tpu_torch.algebra.bell import bell_device_plan
    from femus_tpu_torch.mesh.gambit import read_neu
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh

    path = str(tmp_path / "box.neu")
    write_neu(unit_box((16, 16)), path)
    mesh = MultiLevelMesh(read_neu(path), 3).finest()
    a = Assembler(mesh, [Unknown("u")], device="cpu")
    a.set_volume_form(poisson("u", rhs=lambda x: 1.0 + 0.0 * x[:, 0]))
    generate_bdc(a, lambda var, x, grp, t: (grp in (1, 2, 3, 4), 0.0))
    _, data = a.make_assemble_fn()(torch.zeros(a.n_dofs,
                                               dtype=torch.float64))
    dev, note = bell_device_plan(a.pattern, "identity", cuda)
    assert note["path"] == "bell" and dev.n == 16641
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(dev.n),
                        device=cuda)
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        op = bell.relayout_ell(dev, data.to(cuda), dtype=dt, device=cuda)
        xv = x.to(dt)
        n0 = bell.spmv_bell_cuda.launches
        y = op.matvec_frame(xv)
        torch.cuda.synchronize()
        assert bell.spmv_bell_cuda.launches == n0 + 1
        y_ref = bell._matvec_plain_frame(op, xv)
        scale = bell._matvec_plain_frame(_abs_op(op), xv.abs()).abs().max()
        assert float((y - y_ref).abs().max()) <= rtol * float(scale)


@pytest.mark.cuda
def test_particle_form_assembly_on_card_matches_host(cuda):
    """MonolithicMPMFSI's assembly with the particle form (vmap of jacfwd
    over the (ne, ppe) slots) on the card against the host in float64, on
    the same particles and state."""
    from femus_tpu_torch.particles.mpm import init_particles, neo_hookean_stress
    from femus_tpu_torch.systems.mpm_fsi import MonolithicMPMFSI

    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = unit_box((5, 5))
        fsi = MonolithicMPMFSI(mesh, neo_hookean_stress(50.0, 50.0), 4.0,
                               1.0, 0.5,
                               lambda var, x, grp, t: (var != "P", 0.0),
                               0.01, ppe=16, device=dev, dtype=torch.float64)
        s = init_particles(mesh, lambda x: (x[:, 0] > 0.3) & (x[:, 1] > 0.4),
                           ppc=2, density=4.0, device=dev,
                           dtype=torch.float64)
        phi, gphi = fsi._shape_at(s.x, s.elem)
        tables = dict(fsi._tables)
        tables["particles"] = fsi.asm.particle_tables(
            s.elem, {"phi": phi, "gphi": gphi, "F": s.F, "vol0": s.vol0,
                     "mass": s.mass, "v_old": s.v}, fsi.ppe)
        rng = np.random.default_rng(2)
        u = torch.as_tensor(rng.normal(0, 0.1, fsi.asm.n_dofs), device=dev)
        old = {vn + "_old": torch.as_tensor(
            rng.normal(0, 0.1, fsi.asm.dofmaps[vn].n_dofs), device=dev)
            for vn in fsi.vel_names}
        R, data = fsi._assemble(u, tables, {"dt": torch.tensor(
            0.01, dtype=torch.float64, device=dev)}, old)
        out[dev.type] = (R.cpu(), data.cpu())
    for k in range(2):
        ref = out["cpu"][k]
        assert float((out["cuda"][k] - ref).abs().max()) <= \
            1e-12 * float(ref.abs().max())


# ---- the multi-device layer's blocks --------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("val_dtype,rtol", [(torch.float32, 1e-5),
                                            (torch.float64, 1e-12)])
@pytest.mark.parametrize("rank", [0, 2, 3])
def test_bell_kernel_on_rank_blocks(cuda, val_dtype, rtol, rank):
    """B1 on one rank's interior (R x R) and boundary (B x (R + S m))
    sliced-ELL blocks of the 4-way halo plan of the NS Jacobian: the
    rectangular blocks the halo SpMV runs, against the plain version."""
    from femus_tpu_torch.algebra.sparse import pad_pattern
    from femus_tpu_torch.parallel import halo
    pattern, data = _ns_jacobian()
    n_pad = -(-pattern.n_rows // 4) * 4
    pat = pad_pattern(pattern, n_pad, n_pad)
    full = torch.zeros((n_pad, pat.width), dtype=torch.float64)
    full[:pattern.n_rows, :pattern.width] = data
    full[pattern.n_rows:, 0] = 1.0
    plan = halo.build_halo_plan(pat, 4)
    lb = halo.build_local_sell(plan, pat, rank)
    R = plan.rows_per_shard
    blk = full[rank * R:(rank + 1) * R]
    assert lb.boundary.n_cols == lb.C > lb.R == lb.interior.n_cols
    rng = np.random.default_rng(rank)
    for sell, n_cols in ((lb.interior, lb.R), (lb.boundary, lb.C)):
        op_c = bell.relayout_ell(sell.to_device(cuda), blk.to(cuda),
                                 dtype=val_dtype, device=cuda)
        op_h = bell.relayout_ell(sell.to_device("cpu"), blk,
                                 dtype=val_dtype, device="cpu")
        x = torch.as_tensor(rng.standard_normal(n_cols), dtype=val_dtype)
        n0 = bell.spmv_bell_cuda.launches
        y = op_c.matvec_frame(x.to(cuda))
        torch.cuda.synchronize()
        assert bell.spmv_bell_cuda.launches == n0 + 1
        assert y.shape == (sell.n,)
        ref = op_h.matvec_frame(x)
        scale = _abs_op(op_h).matvec_frame(x.abs()).max()
        assert float((y.cpu() - ref).abs().max()) <= rtol * float(scale)
    with pytest.raises(ValueError):
        op_c.matvec_frame(torch.ones(lb.R, dtype=val_dtype, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_patch_kernel_on_a_slab(cuda, dtype, rtol, rank):
    """B2 on one rank's slab of patches (``parallel.patch_spmd``): the
    slab's own operator (restricted routing, sides of other slabs
    dropped) against its plain version, and the interior rows of the
    slab equal to the whole operator's."""
    from femus_tpu_torch.parallel import patch_spmd as pspmd
    op = _patch_op(1, dtype, "cpu", rotate=True)
    lo, hi = pspmd.slab_bounds(op.meta[1], 4)[rank]
    part = pspmd.patch_slab(op, lo, hi)
    slab_c = pspmd.slab_operator(part, cuda)
    _check_patch_matvec(slab_c, dtype, rtol)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(op.n_rows),
                        dtype=dtype)
    xi, xe, xv = pspmd.split_vector(op.meta, x)
    xl = torch.cat([xi[:, :, lo:hi].reshape(-1), xe.reshape(-1), xv])
    y = slab_c.matvec(xl.to(cuda)).cpu()
    E, P = op.meta[3], op.meta[1]
    y_full = op.matvec(x)[:E * E * P].view(E, E, P)[:, :, lo:hi]
    n_int = E * E * (hi - lo)
    assert float((y[:n_int].view(E, E, hi - lo) - y_full).abs().max()) <= \
        rtol * float(x.abs().max() * op.wt.abs().sum(0).max())
