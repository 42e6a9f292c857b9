"""Port parity: the sharded solve step (``parallel/spmd.py``) against
femus_tpu's ``make_sharded_step`` on ``device_mesh(4)``, in float64.

Four gloo ranks (one launch) run one step of each case: the Q2 Poisson CG
step of ``tests/test_distributed.py`` (halo SpMV with the ELL gather and
with the sliced-ELL blocks, and the all-gather route ``use_halo=False``)
and the two-level Navier-Stokes cavity step of ``dryrun_multichip``
(GMRES with a Jacobi-smoothed Galerkin V-cycle; the same with the K-cycle
under FGMRES).  Each solution is within 1e-9 of the JAX package's and of
the port's step on one rank, with the same iteration count.  A
three-level Galerkin MG-CG Poisson step (B1's plain version on the rank
blocks, replicated coarser levels) holds against the JAX package's step
on the same three-level ``block_diag_prolongation``/``build_ptap_schedule``
chain (1e-9, the same CG iteration count) and equals the port's unsharded
``build_hierarchy`` solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from femus_tpu.algebra.transfer import (block_diag_prolongation,
                                        build_ptap_schedule,
                                        mask_prolongation,
                                        op_pair_from_scipy)
from femus_tpu.assembly.bc import apply_dirichlet_values, generate_bdc
from femus_tpu.assembly.engine import Assembler, Unknown
from femus_tpu.assembly.forms import navier_stokes, poisson
from femus_tpu.mesh.generation import unit_box
from femus_tpu.mesh.multilevel import MultiLevelMesh
from femus_tpu.parallel.spmd import (device_mesh, make_sharded_step,
                                     pad_prolongation)
from femus_tpu_torch.parallel import cases
from femus_tpu_torch.parallel.ranks import device_mesh as tdevice_mesh
from femus_tpu_torch.parallel.ranks import launch

S = 4
POISSON = dict(case="poisson", n=8, outer="cg", rtol=1e-10, max_outer=40)
DRYRUN = dict(case="dryrun", n=4, outer="gmres", rtol=1e-6, restart=20,
              max_outer=3)
CONFIGS = {
    "poisson-halo-ell": dict(POISSON, local_format="ell"),
    "poisson-halo-bell": dict(POISSON, local_format="bell"),
    "poisson-allgather": dict(POISSON, use_halo=False),
    "dryrun-halo-ell": dict(DRYRUN, local_format="ell"),
    "dryrun-halo-bell": dict(DRYRUN, local_format="bell"),
    "dryrun-allgather": dict(DRYRUN, use_halo=False),
    "dryrun-kcycle": dict(DRYRUN, local_format="ell", mg_cycle="K"),
    "poisson-mg3": dict(POISSON, n=16, levels=3, local_format="bell",
                        timed=True),
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



def _jax_poisson(use_halo):
    mesh = device_mesh(S)
    asm = Assembler(unit_box((8, 8), "quad"), [Unknown("u", "biquadratic")],
                    quad_order="fifth", pad_dofs_to=S, pad_elems_to=S)
    asm.set_volume_form(poisson("u", "biquadratic",
                                rhs=lambda x: 1.0 + 0.0 * x[:, 0]))
    generate_bdc(asm, lambda var, x, grp, t: (True, 0.0))
    u0 = jax.device_put(jnp.asarray(apply_dirichlet_values(
        asm, np.zeros(asm.n_dofs_pad))), NamedSharding(mesh, P("mesh")))
    step = make_sharded_step(asm, mesh, outer="cg", rtol=1e-10,
                             max_outer=40, use_halo=use_halo)
    u1, res = step(u0)
    return np.asarray(u1)[:asm.n_dofs], float(res)


def _jax_dryrun(mg_cycle):
    """The JAX package's dryrun_multichip step at 4 devices (its code)."""
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
    step = make_sharded_step(
        fine, mesh, transfers=[(Pop, Rop, sched)],
        dir_masks=[jnp.asarray(masks[0])], outer="gmres", rtol=1e-6,
        restart=20, max_outer=3, smoother="jacobi", mg_cycle=mg_cycle)
    u0 = jax.device_put(jnp.asarray(apply_dirichlet_values(
        fine, np.zeros(fine.n_dofs_pad))), NamedSharding(mesh, P("mesh")))
    u1, res = step(u0)
    return np.asarray(u1)[:fine.n_dofs], float(res)


def _jax_mg3():
    """The JAX package's sharded MG-CG step of "poisson-mg3" at 4
    devices: a three-level Galerkin chain (the finest P padded to the
    padded fine rows, each coarser schedule on the Galerkin pattern of the
    finer one, P zeroed at Dirichlet rows and columns).  Returns (u,
    residual, CG iterations); the JAX step returns no SolveInfo, so the
    iterations come from the body of the step (assembly, build_hierarchy
    on the same transfers, cg) run unsharded, whose solution must equal
    the sharded one."""
    cfg = CONFIGS["poisson-mg3"]
    mesh = device_mesh(S)
    ml = MultiLevelMesh(unit_box((cfg["n"] // 4, cfg["n"] // 4), "quad"), 3)
    asms = []
    for l, lm in enumerate(ml.levels):
        pad = dict(pad_dofs_to=S, pad_elems_to=S) if l == 2 else {}
        a = Assembler(lm, [Unknown("u", "biquadratic")], quad_order="fifth",
                      **pad)
        a.set_volume_form(poisson("u", "biquadratic",
                                  rhs=lambda x: 1.0 + 0.0 * x[:, 0]))
        generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
        asms.append(a)
    fine = asms[-1]
    transfers, masks = [None, None], [None, None]
    pat = fine.pattern
    for l in (1, 0):
        c, f = asms[l], asms[l + 1]
        Pm = mask_prolongation(block_diag_prolongation(
            ml.levels[l], ml.levels[l + 1], f.unknowns),
            f.dirichlet_mask, c.dirichlet_mask)
        if l == 1:
            Pm = pad_prolongation(Pm, fine.n_dofs_pad, c.n_dofs)
        Pop, Rop = op_pair_from_scipy(Pm)
        sched = build_ptap_schedule(pat, Pm)
        transfers[l] = (Pop, Rop, sched)
        masks[l] = jnp.asarray(c.dirichlet_mask[:c.n_dofs])
        pat = sched.coarse_pattern
    step = make_sharded_step(fine, mesh, transfers=transfers,
                             dir_masks=masks, outer="cg", rtol=cfg["rtol"],
                             max_outer=cfg["max_outer"], smoother="jacobi")
    u0 = jax.device_put(jnp.asarray(apply_dirichlet_values(
        fine, np.zeros(fine.n_dofs_pad))), NamedSharding(mesh, P("mesh")))
    u1, res = step(u0)
    u1 = np.asarray(u1)
    from femus_tpu.algebra.krylov import cg as jcg
    from femus_tpu.algebra.mg import build_hierarchy as jbuild
    R, data = fine.make_assemble_fn()(jnp.asarray(np.asarray(u0)), {}, {})
    A = fine.op_with(data)
    h = jbuild(A, transfers, smoother="jacobi", dir_masks=masks)
    delta, info = jcg(A.matvec, -R, M=h.as_preconditioner("V"),
                      tol=cfg["rtol"], maxiter=cfg["max_outer"] * 30)
    np.testing.assert_allclose(np.asarray(u0) + np.asarray(delta), u1,
                               rtol=0, atol=1e-12)
    return u1[:fine.n_dofs], float(res), int(info.iters)


@pytest.fixture(scope="module")
def ranks():
    """One launch of 4 gloo ranks running every config."""
    out = launch(cases.step_rank, S, (list(CONFIGS.values()),),
                 device="cpu", timeout=400, quiet=True)
    return {name: [r[i] for r in out] for i, name in enumerate(CONFIGS)}


@pytest.fixture(scope="module")
def reference():
    return {"poisson-halo": _jax_poisson(True),
            "poisson-allgather": _jax_poisson(False),
            "dryrun": _jax_dryrun("V"), "dryrun-kcycle": _jax_dryrun("K"),
            "poisson-mg3": _jax_mg3(), "poisson-mg3-port": _port_mg3()}


def _port_mg3():
    """The three-level Galerkin MG-CG solve of "poisson-mg3" on the whole
    problem through the port's own hierarchy (``mg.build_hierarchy``)."""
    from femus_tpu_torch.algebra.krylov import cg
    from femus_tpu_torch.algebra.mg import build_hierarchy
    from femus_tpu_torch.mesh.generation import unit_box as tunit_box
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh as TML
    cfg = CONFIGS["poisson-mg3"]
    ml = TML(tunit_box((cfg["n"] // 4, cfg["n"] // 4), "quad"), 3)
    asms = []
    for lm in ml.levels:
        a = cases.Assembler(lm, [cases.Unknown("u", "biquadratic")],
                            quad_order="fifth", device="cpu")
        a.set_volume_form(cases.poisson("u", "biquadratic",
                                        rhs=lambda x: 1.0 + 0.0 * x[:, 0]))
        cases.generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
        asms.append(a)
    fine = asms[-1]
    transfers, masks = cases.galerkin_transfers(ml, asms, fine.n_dofs,
                                                "cpu")
    u0 = torch.zeros(fine.n_dofs, dtype=torch.float64)
    R, data = fine.make_assemble_fn()(u0)
    h = build_hierarchy(fine.op_with(data), transfers, smoother="jacobi",
                        dir_masks=masks, device="cpu")
    u, info = cg(fine.op_with(data).matvec, -R,
                 M=h.as_preconditioner("V"), tol=cfg["rtol"],
                 maxiter=cfg["max_outer"] * 30)
    return u.numpy(), info.residual, info.iters


def _ref_key(name):
    if name == "poisson-mg3":
        return name
    if name.startswith("poisson"):
        return "poisson-allgather" if "allgather" in name else "poisson-halo"
    return "dryrun-kcycle" if "kcycle" in name else "dryrun"


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_step_matches_jax_and_one_rank(ranks, reference, name):
    res = ranks[name]
    u4 = cases.join_rows(res)
    u_ref, r_ref, *iters = reference[_ref_key(name)]
    np.testing.assert_allclose(u4, u_ref, rtol=0, atol=1e-9)
    if iters:                           # the JAX chain's CG iterations
        assert res[0]["iters"] == iters[0] and res[0]["converged"]
        assert iters[0] <= 10
        # and the port's unsharded MG-CG solve
        u_p, _, it_p = reference["poisson-mg3-port"]
        np.testing.assert_allclose(u4, u_p, rtol=0, atol=1e-9)
        assert it_p == iters[0]
        # timed: cold and warm production calls, then an instrumented one
        # whose sections are all counted and whose solution is the same
        assert all(len(r["step_s"]) == 2 and min(r["clock"].values()) > 0
                   and r["timed_diff"] <= 1e-9 for r in res)
    assert abs(res[0]["residual"] - r_ref) <= 1e-9 * max(1.0, abs(r_ref))
    assert len({r["iters"] for r in res}) == 1
    # the same step on one rank (no process group: reductions are local)
    one = cases.sharded_step_case(tdevice_mesh(1, "cpu"), **CONFIGS[name])
    np.testing.assert_allclose(u4, one["u"][:one["n"]], rtol=0, atol=1e-9)
    assert one["iters"] == res[0]["iters"]
    note = res[0]["note"]
    assert note["world_size"] == S and note["use_halo"] == \
        CONFIGS[name].get("use_halo", True)
    if note["use_halo"]:
        assert note["local_format"] == CONFIGS[name]["local_format"]
        assert note["transport"] == "ppermute"       # banded, on the CPU
    # each rank assembles only the elements touching its rows
    n = CONFIGS[name]["n"] * (2 if name.startswith("dryrun") else 1)
    assert sum(r["note"]["elements"] < n * n for r in res) >= 2
