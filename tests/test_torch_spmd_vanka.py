"""Port parity: the sharded step's restriction, multiplicative Vanka
smoother and aux fields (``parallel/spmd.py``) against femus_tpu's
``make_sharded_step`` on ``device_mesh(4)``, in float64.

Four gloo ranks (one launch) run every case; the JAX package's step runs
on its 4-device CPU mesh (``local_format`` "ell") with the same
transfers, blocks and aux fields.  Each case's solution is within 1e-9 of
the JAX package's, and its iterations equal the port's step on one rank:

- the transient fsi-bed (``cases.fsi_bed``, unit_box((4, 4)), 2 levels,
  after the coarse-level ratchet of ``dryrun_multichip``: the
  Petrov-Galerkin R·A·P transfers (R != P^T), the K-cycle under
  FGMRES(15) for one cycle, the old fields as aux fields) with a Jacobi
  smoother: the finest transfer's own R restricts, not P^T;
- the two-level cavity of ``dryrun_multichip`` with ``smoother="vanka"``
  (blocks of 2 elements on both levels; the multiplicative sweep across
  the row partition);
- the fsi-bed with material Vanka on every level, at 2 levels and at 3
  (where the middle level's replicated Vanka runs inside the K-cycle;
  two FGMRES(15) cycles);
- ex10's backward-Euler cavity at unit_box((8, 8)) (Jacobi, no
  transfers, two steps, each step's velocities the next one's aux
  fields ``u_old``, ``v_old``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from femus_tpu.algebra.transfer import (block_diag_prolongation,
                                        build_ptap_schedule,
                                        op_pair_from_scipy)
from femus_tpu.algebra.vanka import build_element_blocks
from femus_tpu.assembly.bc import apply_dirichlet_values, generate_bdc
from femus_tpu.assembly.engine import Assembler, Unknown
from femus_tpu.assembly.forms import navier_stokes
from femus_tpu.mesh.generation import unit_box
from femus_tpu.mesh.multilevel import MultiLevelMesh
from femus_tpu.parallel.spmd import (device_mesh, make_sharded_step,
                                     pad_prolongation)
from femus_tpu_torch.parallel import cases
from femus_tpu_torch.parallel.ranks import device_mesh as tdevice_mesh
from femus_tpu_torch.parallel.ranks import launch

S = 4
DRYRUN = dict(case="dryrun", n=4, outer="gmres", rtol=1e-6, restart=20,
              max_outer=3, local_format="ell")
FSI = dict(case="fsi", n=4, levels=2, outer="fgmres", rtol=1e-6,
           restart=15, max_outer=1, mg_cycle="K", local_format="ell")
CONFIGS = {
    "fsi-jacobi-R": dict(FSI, smoother="jacobi"),
    "dryrun-vanka": dict(DRYRUN, smoother="vanka"),
    "fsi-vanka-aux": dict(FSI, smoother="vanka"),
    "fsi-vanka-aux-3": dict(FSI, levels=3, max_outer=2, smoother="vanka"),
    "ns-aux": dict(case="ns-aux", n=8, outer="gmres", rtol=1e-10,
                   restart=60, max_outer=5, local_format="ell", steps=2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module: beside the other test workers
    and the spawned ranks, the many small torch ops of these cases spend
    their time in thread barriers otherwise (the 3-D patch solve took
    minutes under a parallel run, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _put(mesh, u):
    return jax.device_put(jnp.asarray(u), NamedSharding(mesh, P("mesh")))


def _jax_dryrun():
    """The JAX package's dryrun_multichip cavity step at 4 devices, with
    Vanka blocks (2 elements) on both levels."""
    mesh = device_mesh(S)
    ml = MultiLevelMesh(unit_box((4, 4), "quad"), 2)
    unknowns = [Unknown("u", "biquadratic"), Unknown("v", "biquadratic"),
                Unknown("p", "linear")]

    def bc(var, x, grp, t):
        if var == "p":
            return False, 0.0
        return True, (1.0 if (var == "u" and grp == 4) else 0.0)

    asms, masks = [], []
    for lmesh in ml.levels:
        a = Assembler(lmesh, unknowns, quad_order="fifth", pad_dofs_to=S,
                      pad_elems_to=S)
        a.set_volume_form(navier_stokes(("u", "v"), "p", nu=0.1))
        generate_bdc(a, bc)
        a.dirichlet_mask[a.offsets["p"]] = True
        asms.append(a)
        masks.append(a.dirichlet_mask)
    coarse, fine = asms
    Praw = block_diag_prolongation(ml.levels[0], ml.levels[1], unknowns)
    Pm = Praw.tolil()
    Pm[masks[1][:Praw.shape[0]], :] = 0.0
    Pm[:, masks[0][:Praw.shape[1]]] = 0.0
    Pm = pad_prolongation(Pm.tocsr(), fine.n_dofs_pad, coarse.n_dofs_pad)
    Pm.eliminate_zeros()
    Pop, Rop = op_pair_from_scipy(Pm)
    sched = build_ptap_schedule(fine.pattern, Pm)
    vblocks = [build_element_blocks(coarse, 2, pattern=sched.coarse_pattern),
               build_element_blocks(fine, 2)]
    step = make_sharded_step(
        fine, mesh, transfers=[(Pop, Rop, sched)],
        dir_masks=[jnp.asarray(masks[0])], outer="gmres", rtol=1e-6,
        restart=20, max_outer=3, smoother="vanka", vanka_blocks=vblocks,
        vanka_omega=0.9)
    u1, res = step(_put(mesh, apply_dirichlet_values(
        fine, np.zeros(fine.n_dofs_pad))))
    return np.asarray(u1)[:fine.n_dofs], float(res)


def _jax_fsi_bed(coarse, levels):
    """cases.fsi_bed in the JAX package."""
    from femus_tpu.systems.fsi import (TransientMonolithicFSI,
                                       fsi_transient_form)
    from femus_tpu.systems.problem import MultiLevelProblem
    from femus_tpu.systems.solution import MultiLevelSolution

    bed = cases.FSI_BED
    mesh = unit_box((coarse, coarse), "quad")
    cent = mesh.coords[mesh.conn].mean(axis=1)
    mesh.elem_group = np.where(cent[:, 1] < bed, 1, 0).astype(np.int32)
    ml_mesh = MultiLevelMesh(mesh, levels)
    ml_sol = MultiLevelSolution(ml_mesh)
    for v in ("dx", "dy", "u", "v"):
        ml_sol.add_solution(v, "biquadratic", time_order=1)
    ml_sol.add_solution("p", "disc_linear")
    ml_sol.attach_bc(lambda var, x, grp, t: (var != "p", 0.0))
    for v in cases.FSI_FIELDS:
        ml_sol.initialize(v)
    ml_sol.initialize("u", lambda x: np.where(
        x[:, 1] < bed, cases.FSI_KICK * np.sin(np.pi * x[:, 0])
        * np.sin(np.pi * x[:, 1] / bed), 0.0))
    ml_sol.generate_bdc()
    ml_sol.fix_solution_at_point("p", cases.FSI_PIN, 0.0)
    ml_sol.pair_solution("u", "dx")
    ml_sol.pair_solution("v", "dy")
    prob = MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    fsys = prob.add_system(TransientMonolithicFSI, "FSI")
    fsys.solid_groups = (1,)
    fsys.add_unknown(*cases.FSI_FIELDS)
    fsys.set_assembly(fsi_transient_form(
        ("dx", "dy"), ("u", "v"), "p", solid_groups=(1,),
        pres_family="disc_linear", rho_f=1.0, nu=0.05, rho_s=1.0, lam=50.0,
        mu=50.0, solid_model="neo-hookean", theta=1.0))
    cfg = fsys.config
    cfg.interleave_dofs = True
    cfg.smoother = "vanka"
    cfg.vanka_groups = "material"
    cfg.vanka_block_elems = 2
    cfg.mg_type = "F"
    cfg.mg_cycle = "K"
    cfg.restart = 60
    cfg.max_outer = cases.FSI_MAX_OUTER
    cfg.rtol = 1e-10
    cfg.nonlinear_tol = cases.FSI_NONLINEAR_TOL
    fsys.init_time(cases.FSI_DT)
    fsys.init()
    ml_sol.copy_to_old()
    return fsys


def _jax_fsi(name):
    """The FSI K-cycle step of dryrun_multichip on the transient bed:
    ratchet the levels below the finest, then one sharded step at the
    finest level with the R·A·P transfers, the config's smoother (material
    Vanka on every level, or Jacobi) and the old fields as aux fields."""
    cfg = CONFIGS[name]
    L = cfg["levels"]
    mesh = device_mesh(S)
    fsys = _jax_fsi_bed(cfg["n"], L)
    for l in range(L - 1):
        step_l = fsys.step_fn(l)
        for _ in range(2):
            out = step_l(jnp.asarray(fsys.gather(l)),
                         fsys.assemblers[l].device_tables_cached(),
                         fsys._aux_arrays(l), fsys._aux_scalars_traced())
            fsys.scatter(np.asarray(out[0]), l)
        fsys.ml_sol.refine_from(l)
        fsys._apply_bc_values(l + 1)
    fine_a = fsys.assemblers[L - 1]
    assert fine_a.n_dofs_pad == fine_a.n_dofs and fine_a.n_dofs % S == 0
    # the pairs u->dx, v->dy make the finest restriction Petrov-Galerkin
    P, R = fsys._make_transfer_pair(L - 2)
    assert R is not None and abs(R - P.T).max() > 0.1
    transfers = fsys._transfers_for(L - 1)
    vblocks = None
    if cfg["smoother"] == "vanka":
        vblocks = [build_element_blocks(
            fsys.assemblers[l], 2, groups="material",
            pattern=transfers[l][2].coarse_pattern if l < L - 1 else None)
            for l in range(L)]
    step = make_sharded_step(
        fine_a, mesh, transfers=list(transfers),
        dir_masks=[jnp.asarray(m) for m in fsys.masks[:L - 1]],
        outer="fgmres", rtol=cfg["rtol"], restart=cfg["restart"],
        max_outer=cfg["max_outer"], smoother=cfg["smoother"],
        vanka_blocks=vblocks, vanka_omega=fsys.config.vanka_omega,
        mg_cycle="K", aux_scalars=fsys.aux_scalars, with_aux=True)
    u1, res = step(_put(mesh, fsys.gather(L - 1)), fsys._aux_arrays(L - 1))
    return np.asarray(u1), float(res)


def _jax_ns_aux():
    """ex10's sharded backward-Euler step, two steps from the lid's
    boundary values (its build and march, without the markers)."""
    cfg = CONFIGS["ns-aux"]
    mesh = device_mesh(S)
    n = cfg["n"]
    asm = Assembler(unit_box((n, n), "quad"),
                    [Unknown("u", "biquadratic"), Unknown("v", "biquadratic"),
                     Unknown("p", "linear")],
                    quad_order="fifth", pad_dofs_to=S, pad_elems_to=S)
    for c in ("u", "v"):
        asm.add_aux_field(c + "_old", "biquadratic")
    steady = navier_stokes(("u", "v"), "p", nu=cases.NS_NU)

    def form(ops, u, aux):
        out = steady(ops, u, aux)
        for c in ("u", "v"):
            du = (ops.value("biquadratic", u[c])
                  - ops.value("biquadratic", aux[c + "_old"])) / cases.NS_DT
            out[c] = out[c] + ops.t("biquadratic", du)
        return out

    asm.set_volume_form(form)

    def bc(var, x, grp, t):
        if var == "p":
            return False, 0.0
        return True, (1.0 if var == "u" and abs(x[1] - 1.0) < 1e-9 else 0.0)

    generate_bdc(asm, bc)
    asm.dirichlet_mask[asm.offsets["p"]] = True
    step = make_sharded_step(asm, mesh, outer="gmres", rtol=cfg["rtol"],
                             restart=cfg["restart"],
                             max_outer=cfg["max_outer"], smoother="jacobi",
                             with_aux=True)
    nd = asm.dofmaps["u"].n_dofs
    ou, ov = asm.offsets["u"], asm.offsets["v"]
    u = _put(mesh, apply_dirichlet_values(asm, np.zeros(asm.n_dofs_pad)))
    for _ in range(cfg["steps"]):
        u, res = step(u, {"u_old": u[ou:ou + nd], "v_old": u[ov:ov + nd]})
    return np.asarray(u)[:asm.n_dofs], float(res)


@pytest.fixture(scope="module")
def ranks():
    """One launch of 4 gloo ranks running every config."""
    out = launch(cases.step_rank, S, (list(CONFIGS.values()),),
                 device="cpu", timeout=400, quiet=True)
    return {name: [r[i] for r in out] for i, name in enumerate(CONFIGS)}


@pytest.fixture(scope="module")
def reference():
    return {"fsi-jacobi-R": _jax_fsi("fsi-jacobi-R"),
            "dryrun-vanka": _jax_dryrun(),
            "fsi-vanka-aux": _jax_fsi("fsi-vanka-aux"),
            "fsi-vanka-aux-3": _jax_fsi("fsi-vanka-aux-3"),
            "ns-aux": _jax_ns_aux()}


def _check(ranks, reference, name):
    res = ranks[name]
    u4 = cases.join_rows(res)
    u_ref, r_ref = reference[name]
    np.testing.assert_allclose(u4, u_ref, rtol=0, atol=1e-9)
    assert abs(res[0]["residual"] - r_ref) <= 1e-9 * max(1.0, abs(r_ref))
    assert len({tuple(r["step_iters"]) for r in res}) == 1
    # the same step on one rank (no process group: reductions are local)
    one = cases.sharded_step_case(tdevice_mesh(1, "cpu"), **CONFIGS[name])
    np.testing.assert_allclose(u4, one["u"][:one["n"]], rtol=0, atol=1e-9)
    assert one["step_iters"] == res[0]["step_iters"]
    return res


def test_sharded_restriction_is_the_transfers_R(ranks, reference):
    """The finest transfer's own R restricts (R != P^T here, asserted in
    the reference): the step equals the JAX package's, whose hierarchy
    restricts with the given R and coarsens R A P."""
    res = _check(ranks, reference, "fsi-jacobi-R")
    assert res[0]["step_iters"] == [CONFIGS["fsi-jacobi-R"]["restart"]]


@pytest.mark.parametrize("name", ["dryrun-vanka", "fsi-vanka-aux",
                                  "fsi-vanka-aux-3", "ns-aux"])
def test_sharded_vanka_and_aux_match_jax_and_one_rank(ranks, reference,
                                                      name):
    res = _check(ranks, reference, name)
    if CONFIGS[name].get("smoother") == "vanka":
        # the blocks straddle the row partition: ranks fetch residuals
        # and block rows beyond their SpMV halo
        notes = [r["note"]["vanka"] for r in res]
        assert sum(nt["ghosts"] > 0 for nt in notes) >= 2
        assert res[0]["converged"]
    if name == "ns-aux":
        assert len(res[0]["step_iters"]) == 2


def test_sharded_step_refuses_what_it_cannot_run():
    """smoother='vanka' without blocks or transfers, an unknown smoother
    and a step called without its aux fields raise; nothing falls back to
    Jacobi."""
    from femus_tpu_torch.parallel.spmd import make_sharded_step as tstep
    group = tdevice_mesh(1, "cpu")
    fine = cases.transient_ns_assembler(2, "cpu")
    with pytest.raises(ValueError, match="vanka"):
        tstep(fine, group, smoother="vanka")
    with pytest.raises(ValueError, match="smoother"):
        tstep(fine, group, smoother="ilu")
    ml, asms = cases.dryrun_levels(2, "cpu")
    tr, masks = cases.galerkin_transfers(ml, asms, asms[-1].n_dofs, "cpu")
    with pytest.raises(ValueError, match="vanka_blocks"):
        tstep(asms[-1], group, transfers=tr, dir_masks=masks,
              smoother="vanka", vanka_blocks=[None, None])
    step = tstep(fine, group, with_aux=True)
    u = torch.zeros(fine.n_dofs, dtype=torch.float64)
    with pytest.raises(TypeError, match="aux_fields"):
        step(u)
