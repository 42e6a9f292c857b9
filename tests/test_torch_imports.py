"""Import hygiene and device policy of the PyTorch port.

The port imports neither JAX nor anything of the JAX package, and its
entry points run on the card unless the caller asks for the host: without
CUDA they raise instead of falling back.
"""
import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import femus_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(femus_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="femus_tpu_torch."))


def test_importing_every_module_pulls_in_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'femus_tpu' or "
            "k.startswith('femus_tpu.'))\n"
            "print(len(sys.modules), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("[]"), out.stdout
    assert len(_modules()) >= 20


def test_fsi_and_transient_modules_are_covered():
    """The FSI and time-integrator modules are among those the two checks
    above import and parse."""
    mods = set(_modules())
    for m in ("systems.fsi", "systems.transient", "systems.constitutive",
              "algebra.transfer", "algebra.vanka", "convert"):
        assert f"femus_tpu_torch.{m}" in mods, m


def test_slice6_modules_are_covered():
    """The block-solver, norm, convergence and optimal-control modules are
    among those the import checks walk."""
    mods = set(_modules())
    for m in ("algebra.fieldsplit", "assembly.norms",
              "systems.fe_convergence", "systems.optimal_control",
              "fe.tabulate", "assembly.forms"):
        assert f"femus_tpu_torch.{m}" in mods, m


def test_multi_device_and_3d_patch_modules_are_covered():
    """The multi-device layer, the native set-up kernels, the sharded
    particles and the 3-D patch operator are among the modules the import
    checks walk (no jax, no femus_tpu)."""
    mods = set(_modules())
    for m in ("native", "parallel.partition", "parallel.ranks",
              "parallel.halo", "parallel.spmd", "parallel.patch_spmd",
              "parallel.cases", "particles.sharded", "mesh.patches3d",
              "algebra.patchstencil3d"):
        assert f"femus_tpu_torch.{m}" in mods, m


def test_multi_device_entry_points_default_to_the_card(no_cuda):
    """device_mesh and the parallel problems run on the card unless asked
    for the host; outside a launch, device_mesh is one rank."""
    from femus_tpu_torch.parallel import cases
    from femus_tpu_torch.parallel.ranks import device_mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mesh()
    one = device_mesh(1, "cpu")
    assert (one.world_size, one.rank, one.backend) == (1, 0, "none")
    with pytest.raises(ValueError):
        device_mesh(4, "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cases.poisson_assembler(2, "cuda")


def test_no_source_file_imports_the_jax_package():
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                for n in names:
                    root = n.split(".")[0]
                    assert root not in ("jax", "jaxlib", "femus_tpu"), \
                        f"{path}: imports {n}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from femus_tpu_torch.algebra.bell import build_sell_plan, relayout_ell
    from femus_tpu_torch.algebra.condest import sigma_max, sigma_min
    from femus_tpu_torch.algebra.mg import build_hierarchy
    from femus_tpu_torch.assembly.engine import Assembler, Unknown
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import LinearImplicitSystem

    mesh = unit_box((2, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Assembler(mesh, [Unknown("u")])
    a = Assembler(mesh, [Unknown("u")], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        relayout_ell(build_sell_plan(a.pattern),
                     torch.zeros(a.pattern.cols.shape, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_hierarchy(None, [])
    for est in (sigma_max, sigma_min):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            est(lambda x: x, lambda x: x, 8)
        assert float(est(lambda x: 2 * x, lambda x: 2 * x, 8,
                         device="cpu")) == pytest.approx(2.0, rel=1e-8)
    ml_mesh = MultiLevelMesh(unit_box((2, 2)), 2)
    ml_sol = MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u")
    prob = MultiLevelProblem(ml_mesh, ml_sol)
    sys_ = prob.add_system(LinearImplicitSystem, "P")
    sys_.add_unknown("u")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sys_.init()
    sys_.init(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sys_.solve(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sys_.step_fn(device="cuda")


def test_norm_entry_points_raise_without_cuda(no_cuda):
    """error_norms, l2_norm_field, integrate_field, integrate and
    cost_functional run on the card unless asked for the host."""
    from femus_tpu_torch.assembly import norms
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.systems.optimal_control import cost_functional

    mesh = unit_box((2, 2))
    u = np.ones(mesh.dofmap("biquadratic").n_dofs)
    one = lambda x: 1.0 + 0.0 * x[:, 0]            # noqa: E731
    calls = {
        "error_norms": lambda **kw: norms.error_norms(
            mesh, "biquadratic", u, one, **kw),
        "l2_norm_field": lambda **kw: norms.l2_norm_field(
            mesh, "biquadratic", u, **kw),
        "integrate_field": lambda **kw: norms.integrate_field(
            mesh, "biquadratic", u, **kw),
        "integrate": lambda **kw: norms.integrate(mesh, one, **kw),
        "cost_functional": lambda **kw: cost_functional(
            mesh, "biquadratic", u, u, one, 1e-3, **kw)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        call(device="cpu")
    assert norms.integrate(mesh, one, device="cpu") == pytest.approx(1.0)
    assert norms.integrate_field(mesh, "biquadratic", u, device="cpu") == \
        pytest.approx(1.0)


def test_cuda_matvec_never_falls_back_to_the_host(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: here (no card, or a
    mismatched plan) it raises rather than running the plain version."""
    from femus_tpu_torch.algebra import bell
    from femus_tpu_torch.algebra import patchstencil as ps
    from femus_tpu_torch.algebra.sparse import pattern_from_pairs
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.patches import refine_patched

    pat = pattern_from_pairs(np.arange(64), np.arange(64), 64, 64)
    op = bell.relayout_ell(bell.build_sell_plan(pat),
                           torch.ones(64, 1, dtype=torch.float64),
                           device="cpu")
    with pytest.raises((ValueError, RuntimeError, AssertionError)):
        bell.spmv_bell_cuda(op, torch.ones(64, dtype=torch.float64))

    _, plan = refine_patched(unit_box((2, 2)), 1)
    tab = ps.build_patch_tables(plan)
    pop = ps.make_patch_op(tab, torch.ones(ps.K, tab.H, tab.H, tab.Pp,
                                           dtype=torch.float64))
    with pytest.raises((ValueError, RuntimeError)):
        ps.spmv_patch_cuda(pop, torch.ones(tab.n, dtype=torch.float64))
    from femus_tpu_torch.algebra import dia, stencil
    d = dia.DiaOp(torch.ones(3, 12, dtype=torch.float64), (-4, 0, 4), 12)
    st = stencil.build_stencil(d, 4)
    with pytest.raises(ValueError):
        dia.spmv_dia_cuda(d, torch.ones(12, dtype=torch.float64))
    with pytest.raises(ValueError):
        stencil.spmv_stencil_cuda(st, torch.ones(12, dtype=torch.float64))
    # CUDA-routed frame and patch matvecs (scalar and block) whose kernel
    # cannot launch raise instead of returning the plain result
    plain = []
    monkeypatch.setattr(bell, "_matvec_plain_frame",
                        lambda *a: plain.append(1))
    monkeypatch.setattr(ps, "_patch_matvec_plain",
                        lambda *a: plain.append(1))
    monkeypatch.setattr(ps, "_patch_chunk_plain",
                        lambda *a: plain.append(1))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))

    def on_meta(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to("meta")
            for f in dataclasses.fields(obj)
            if torch.is_tensor(getattr(obj, f.name))})

    mop = bell.BellOp(op.vals.to("meta"), on_meta(op.dev))
    bop = ps.make_block_patch_op(tab, torch.ones(4 * ps.K, tab.H, tab.H,
                                                 tab.Pp, dtype=torch.float64),
                                 2)
    for fn, call in (
            (bell.spmv_bell_cuda, lambda: mop.matvec_frame(
                torch.ones(64, dtype=torch.float64, device="meta"))),
            (ps.spmv_patch_cuda, lambda: dataclasses.replace(
                pop, wt=pop.wt.to("meta"), routing=on_meta(pop.routing)
            ).matvec(torch.ones(tab.n, dtype=torch.float64, device="meta"))),
            (ps.spmv_patch_cuda, lambda: dataclasses.replace(
                bop, wt=bop.wt.to("meta"), routing=on_meta(bop.routing)
            ).matvec(torch.ones(2 * tab.n, dtype=torch.float64,
                                device="meta")))):
        n0 = fn.launches
        with pytest.raises(RuntimeError, match="nvcc|CUDA"):
            call()
        assert not plain and fn.launches == n0
    # the same for the DIA and lattice-stencil matvecs (kernels B4 and B3)
    monkeypatch.setattr(dia, "_matvec_plain", lambda *a: plain.append(1))
    monkeypatch.setattr(stencil, "_matvec_plain",
                        lambda *a: plain.append(1))
    for op, fn in ((d, dia.spmv_dia_cuda), (st, stencil.spmv_stencil_cuda)):
        n0 = fn.launches
        with pytest.raises(RuntimeError, match="nvcc|CUDA"):
            type(op)(op.data.to("meta"), *dataclasses.astuple(op)[1:]) \
                .matvec(torch.ones(12, dtype=torch.float64, device="meta"))
        assert not plain and fn.launches == n0


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_amr_modules_are_covered():
    """The AMR mesh and solve modules (the port's own copy of the
    numpy-only mesh/amr.py included) are among those the import checks
    walk."""
    mods = set(_modules())
    for m in ("mesh.amr", "systems.amr", "algebra.mg", "algebra.sparse"):
        assert f"femus_tpu_torch.{m}" in mods, m


def test_slice8_modules_are_covered():
    """The remaining forms, the materials, surface/conformal, nonlocal and
    mixed-mesh modules (the port's own copies of the numpy-only
    materials.py and mesh/mixed.py included) are among those the import
    checks walk."""
    mods = set(_modules())
    for m in ("materials", "assembly.sw", "assembly.conformal",
              "assembly.nonlocal_diffusion", "assembly.mixed", "mesh.mixed",
              "mesh.mesh", "mesh.generation"):
        assert f"femus_tpu_torch.{m}" in mods, m


def test_slice8_entry_points_raise_without_cuda(no_cuda):
    """NonlocalOperator and MixedAssembler run on the card unless asked
    for the host."""
    from femus_tpu_torch.assembly.engine import Unknown
    from femus_tpu_torch.assembly.mixed import MixedAssembler
    from femus_tpu_torch.assembly.nonlocal_diffusion import NonlocalOperator
    from femus_tpu_torch.mesh.generation import box
    from femus_tpu_torch.mesh.mixed import mixed_unit_box

    mesh = box((4,), [(0.0, 1.0)], "edge")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NonlocalOperator(mesh, delta=0.3)
    op = NonlocalOperator(mesh, delta=0.3, device="cpu")
    assert op._data.device.type == "cpu" and op._data.dtype == torch.float64
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MixedAssembler(mixed_unit_box((2, 2)), [Unknown("u")])
    MixedAssembler(mixed_unit_box((2, 2)), [Unknown("u")], device="cpu")


def test_slice9_modules_are_covered():
    """The mesh readers (the port's own copies of the numpy-only
    mesh/gambit.py and mesh/med.py), markers, forces, MPM, MPM-FSI,
    projection and UQ modules are among those the import checks walk."""
    mods = set(_modules())
    for m in ("mesh.gambit", "mesh.med", "mesh.projection",
              "particles.markers", "particles.forces", "particles.mpm",
              "systems.mpm_fsi", "uq.pce", "uq.sparse_grid"):
        assert f"femus_tpu_torch.{m}" in mods, m


def test_slice9_entry_points_raise_without_cuda(no_cuda):
    """locate, make_advect_fn, init_particles, make_mpm_step,
    MonolithicMPMFSI, projection_matrix, the PCE tables and fit_pdf run on
    the card unless asked for the host."""
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.projection import projection_matrix
    from femus_tpu_torch.particles.markers import (MarkerCloud, locate,
                                                   make_advect_fn)
    from femus_tpu_torch.particles.mpm import (init_particles, make_mpm_step,
                                               neo_hookean_stress)
    from femus_tpu_torch.systems.mpm_fsi import MonolithicMPMFSI
    from femus_tpu_torch.uq.pce import stochastic_mass_matrix
    from femus_tpu_torch.uq.sparse_grid import fit_pdf

    mesh = unit_box((2, 2))
    cloud = MarkerCloud(mesh, np.array([[0.3, 0.6]]), np.zeros(1, np.int64))
    block = lambda x: x[:, 1] > 0.5                     # noqa: E731
    samples = np.random.default_rng(0).normal(size=(50, 1))
    calls = {
        "locate": lambda **kw: locate(cloud, **kw),
        "make_advect_fn": lambda **kw: make_advect_fn(
            mesh, ["biquadratic"] * 2, **kw),
        "init_particles": lambda **kw: init_particles(mesh, block, 2, **kw),
        "make_mpm_step": lambda **kw: make_mpm_step(
            mesh, neo_hookean_stress(1.0, 1.0), **kw),
        "MonolithicMPMFSI": lambda **kw: MonolithicMPMFSI(
            mesh, neo_hookean_stress(1.0, 1.0), 2.0, 1.0, 0.1,
            lambda var, x, grp, t: (var != "P", 0.0), 0.01, **kw),
        "projection_matrix": lambda **kw: projection_matrix(
            mesh, "biquadratic", unit_box((1, 1)), **kw),
        "stochastic_mass_matrix": lambda **kw: stochastic_mass_matrix(
            "hermite", np.array([[0], [1]]), 3, **kw),
        "fit_pdf": lambda **kw: fit_pdf(samples, 3, **kw)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        call(device="cpu")
    assert cloud.elem[0] >= 0


def test_slice11_modules_are_covered():
    """The writers, the utilities and the sharded step are among the
    modules the import checks walk (no jax, no femus_tpu)."""
    mods = set(_modules())
    for m in ("io", "io.vtk", "io.gmv", "io.xdmf", "utils.checkpoint",
              "utils.config", "utils.debug", "utils.files",
              "utils.parsed_function", "utils.telemetry", "parallel.spmd"):
        assert f"femus_tpu_torch.{m}" in mods, m


def test_importing_the_writers_needs_no_h5py():
    """``femus_tpu_torch.io.xdmf`` imports h5py only inside the functions
    that write or read the heavy data: the card's machine has no h5py."""
    code = ("import sys, femus_tpu_torch.io.xdmf, femus_tpu_torch.io, "
            "femus_tpu_torch.utils.debug\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] == "
            "'h5py'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


EXAMPLES = ("ex01_function_approximation", "ex02_poisson_convergence",
            "ex03_navier_stokes_cavity", "ex04_transient_heat_rk",
            "ex05_markers_magnetic", "ex06_mpm_fsi_block", "ex07_uq_pce",
            "ex08_tumor_diffusion", "ex09_amr_mg",
            "ex10_sharded_transient_particles")


def test_slice12_modules_are_covered():
    """The golden apps and the ten examples are among the modules the
    import checks walk (no jax, no femus_tpu, no work at import)."""
    mods = set(_modules())
    for m in ("apps", "apps.ns_bench", "apps.fsi_bench", "examples") + tuple(
            "examples." + e for e in EXAMPLES):
        assert f"femus_tpu_torch.{m}" in mods, m


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_raise_without_cuda(no_cuda, name):
    """An example's ``main()`` runs on the card unless asked for the host:
    without CUDA it raises before any work."""
    import importlib
    mod = importlib.import_module(f"femus_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main()


def test_apps_raise_without_cuda(no_cuda, tmp_path):
    """The apps' systems and assemblers run on the card unless asked for
    the host (a written channel mesh stands in for the absent ones)."""
    import chip_smoke
    from femus_tpu_torch.apps import fsi_bench, ns_bench
    path = chip_smoke.channel_neu(str(tmp_path / "c.neu"), 22, 4, solid=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ns_bench.make_ns_system(levels=1, mesh_path=path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fsi_bench.make_fsi_system(levels=1, mesh_path=path)
    mesh = ns_bench.load_mesh(0, path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ns_bench.make_temperature_assembler(mesh)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fsi_bench.make_assembler(mesh)
