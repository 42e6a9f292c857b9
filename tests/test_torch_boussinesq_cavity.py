"""The de Vahl Davis heated cavity on the port's normal path, held against
the benchmark's plain reference (``benchmark/references/
boussinesq_cavity.py``, PyTorch in float64, no code of the port), in
float64 on the host; and the Vanka set-up's span and counter.

- The port's assembled Boussinesq residual (``assembly.forms.boussinesq``
  through ``assembly.engine.Assembler``) at seeded random fields equals the
  reference's at every row.
- The benchmark's driver of the cell (``benchmark/systems/
  boussinesq_cavity.py``: the port's public entry points) solves the cavity
  at Ra = 1e5 to the reference's discrete solution (the F drive on 16 x 16
  elements; the V drive from rest diverges at that mesh).
- ``smoothers.vanka_invert`` opens inside ``mg_setup.smoothers`` and
  ``vanka.blocks_inverted`` adds the blocks each smoother set-up inverts,
  on the multiplicative and the additive path.
"""
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from benchmark import plugins
from benchmark.references import boussinesq_cavity as ref_mod
from benchmark.systems.boussinesq_cavity import Driver
from femus_tpu_torch.algebra import vanka
from femus_tpu_torch.algebra.sparse import SparseOp
from femus_tpu_torch.assembly.engine import Assembler, Unknown
from femus_tpu_torch.assembly.forms import boussinesq
from femus_tpu_torch.mesh.generation import unit_box
from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
from femus_tpu_torch.mesh.reorder import rcm_reorder_hierarchy
from femus_tpu_torch.utils import telemetry

RA, PR = 1e5, 0.71
FIELDS = ("u", "v", "p", "T")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, the solve's
    many small torch ops spend their time in thread barriers otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assembler(mesh, interleave=False):
    asm = Assembler(mesh, [Unknown("u"), Unknown("v"),
                           Unknown("p", "disc_linear"), Unknown("T")],
                    dtype=torch.float64, interleave=interleave, device="cpu")
    asm.set_volume_form(boussinesq(("u", "v"), "p", "T",
                                   pres_family="disc_linear", ra=RA, pr=PR))
    return asm


def test_residual_equals_the_reference():
    ml = MultiLevelMesh(unit_box((4, 4)), 2)
    rcm_reorder_hierarchy(ml)
    mesh = ml.levels[-1]
    asm = _assembler(mesh)
    U = np.random.default_rng(17).standard_normal(asm.n_dofs)
    R, _ = asm.make_assemble_fn(with_jacobian=False)(torch.as_tensor(U))
    R = R.numpy()
    part = {n: slice(asm.offsets[n], asm.offsets[n]
                     + asm.dofmaps[n].n_dofs) for n in FIELDS}
    ref = ref_mod.CavityReference(8, RA, PR, "fifth")
    xy = mesh.node_coords_of("biquadratic")
    corners = mesh.coords[mesh.conn[:, :4]]
    Rr = ref.residual(ref.state_from_program(
        xy, {n: U[part[n]] for n in FIELDS}, corners))
    N = ref.n_nodes
    _, at = cKDTree(ref.xy).query(xy)
    for k, name in enumerate(("u", "v", "T")):
        want = Rr[k * N + at]
        assert np.abs(R[part[name]] - want).max() <= 1e-10 * np.abs(
            want).max(), name
    # the pressure rows test (1, xi, eta) in each frame: the program's
    # (xi, eta) = J^-1 (h / 2) times the reference's, J = [C1 - C0, C3 -
    # C0] / 2 (the refined elements' frames are rotated)
    el = ref.element_at(corners.mean(axis=1))
    want = Rr[3 * N:].reshape(-1, 3)[el]
    J = np.stack([corners[:, 1] - corners[:, 0],
                  corners[:, 3] - corners[:, 0]], axis=2) / 2
    want[:, 1:] = np.linalg.solve(J, want[:, 1:, None])[..., 0] * (
        ref.h / 2)
    got = R[part["p"]].reshape(-1, 3)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.fixture(scope="module")
def solved():
    """The cell's driver on unit_box((4, 4)), 3 levels, float64, the F
    drive, with the stacks seen at each Vanka inversion and the blocks of
    each smoother built."""
    cfg = plugins.config(plugins.benchmark_spec(),
                         "de-vahl-davis-ra1e5-q2-128")
    cfg.update(mesh={"coarse_cells": 4, "levels": 3}, dtype="float64",
               solver={**cfg["solver"], "mg_type": "F"})
    seen = {"stacks": [], "blocks": []}
    invert, smoother = vanka._invert_blocks, vanka.vanka_smoother

    def invert_seen(*args):
        seen["stacks"].append(list(telemetry.RECORDER._stack))
        return invert(*args)

    def smoother_seen(A, blocks, *args, **kw):
        seen["blocks"].append(blocks)
        return smoother(A, blocks, *args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(vanka, "_invert_blocks", invert_seen)
    mp.setattr(vanka, "vanka_smoother", smoother_seen)
    try:
        drv = Driver(cfg, "", "cpu")
        info = drv.solve({})
    finally:
        mp.undo()
    return cfg, drv, info, telemetry.solves()[-1], seen


def test_driver_solve_meets_the_reference(solved):
    cfg, drv, info, _, _ = solved
    assert info["converged"]
    ref = ref_mod.reference_of(cfg)
    layout = drv.layout()
    read = ref_mod.check(cfg, "", layout, [{"fields": drv.output()}])
    assert read["rel_residual"] <= 1e-8
    own = ref.observables(ref.newton(cfg["solver"]["newton_steps"]))
    got = ref.observables(ref.state_from_program(
        layout["vel_xy"], drv.output(), layout["elem_corners"]))
    for k in ("u_max", "v_max"):
        assert got[k] == pytest.approx(own[k], rel=1e-6), k


def test_vanka_setup_records_its_span_and_blocks(solved):
    _, drv, _, rec, seen = solved
    assert seen["stacks"] and all(
        "mg_setup.smoothers" in s and s[-1] == "smoothers.vanka_invert"
        for s in seen["stacks"])
    spans, counts = rec["spans"], rec["counts"]
    assert spans["smoothers.vanka_invert"][1] == len(seen["blocks"])
    assert spans["smoothers.vanka_invert"][0] <= \
        spans["mg_setup.smoothers"][0]
    assert counts["vanka.blocks_inverted"] == sum(
        d.shape[0] for b in seen["blocks"] for d in b.color_dofs)
    # the finest level's widest block: two elements' 9 nodes of u, v and T
    # and their 2 x 3 pressure coefficients
    assert max(b.color_dofs[0].shape[1] for b in seen["blocks"]) == 60


@pytest.mark.parametrize("multiplicative", [True, False])
def test_both_vanka_paths_record_the_inversions(multiplicative):
    asm = _assembler(unit_box((4, 4)), interleave=True)
    u = np.random.default_rng(3).standard_normal(asm.n_dofs)
    _, data = asm.make_assemble_fn()(torch.as_tensor(u))
    A = SparseOp(data, torch.as_tensor(asm.pattern.cols, dtype=torch.int64),
                 asm.pattern.n_cols)
    blocks = vanka.build_element_blocks(asm, 2, device="cpu")
    before = telemetry.totals()
    vanka.vanka_smoother(A, blocks, multiplicative=multiplicative)
    after = telemetry.totals()

    def delta(kind, name, i=None):
        a, b = before[kind].get(name), after[kind].get(name)
        if i is not None:
            a, b = a and a[i], b[i]
        return b - (a or 0)

    assert delta("spans", "smoothers.vanka_invert", 1) == 1
    assert delta("counts", "vanka.blocks_inverted") == sum(
        d.shape[0] for d in blocks.color_dofs) == 8
