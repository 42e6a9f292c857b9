"""Sharded transient Navier-Stokes + Lagrangian marker advection with a
mid-run checkpoint/restore — the integration seam of three subsystems that
are otherwise tested piecewise:

- halo-exchanged sharded assembly + solve per time step
  (parallel/spmd.make_sharded_step over ranks of torch.distributed; the
  reference's per-rank owner-computes loop + PETSc ghost updates),
- sharded marker advection with all_to_all migration in the freshly
  computed velocity field (particles/sharded.make_sharded_advect_fn;
  reference Line::AdvectionParallel, ism/Line.cpp),
- checkpoint at mid-run + restore into a FRESH run that must land on the
  exact same final state (utils/checkpoint, the npz layout; reference
  SaveSolution / Files::ConfigureRestart restart bookkeeping).

The problem is ``parallel.cases.transient_ns_assembler`` (the
backward-Euler lid-driven cavity, the old velocities as aux fields).
``n_ranks`` rank processes (``parallel.ranks.launch``: gloo when they
share one card or run on the host) run both marches in one launch: the
uninterrupted one, which checkpoints at the halfway step, and the one
restored from that checkpoint.  One rank runs in this process (a group
of world size 1, as the JAX example does on a machine of one device).

Run: python -m femus_tpu_torch.examples.ex10_sharded_transient_particles
Env: EX_N (mesh cells/axis, default 8), EX_STEPS (default 6), EX_OUT (its
directory holds the checkpoints).
"""
import os
import shutil
import tempfile

import numpy as np
import torch

from .. import resolve_device
from ..assembly.bc import apply_dirichlet_values
from ..parallel import cases
from ..parallel.ranks import device_mesh, launch
from ..parallel.spmd import make_sharded_step
from ..particles.markers import MarkerCloud, locate
from ..particles.sharded import collect, distribute, make_plan, \
    make_sharded_advect_fn
from ..utils.checkpoint import CheckpointManager
from ._common import DTYPE, cli, env_int

DT = cases.NS_DT


def run_rank(group, n, n_steps, ckpt_dir):
    """Both marches on this rank: from the start to ``n_steps`` with a
    checkpoint (u, marker x and elem, gathered; written by rank 0) at the
    halfway step, then from that checkpoint to ``n_steps`` again.  Returns
    the global state at the end of each: u, the sharded marker x and elem,
    the last linear residual."""
    dev = group.device
    S, me = group.world_size, group.rank
    asm = cases.transient_ns_assembler(n, dev, DTYPE)
    step = make_sharded_step(asm, group, outer="gmres", rtol=1e-10,
                             restart=60, max_outer=5, smoother="jacobi",
                             with_aux=True)
    mesh = asm.mesh
    plan = make_plan(mesh, S, n_particles=64)
    advect = make_sharded_advect_fn(mesh, plan, group,
                                    ["biquadratic", "biquadratic"], order=2,
                                    dtype=DTYPE)
    off_u, off_v = asm.offsets["u"], asm.offsets["v"]
    ndv = asm.dofmaps["u"].n_dofs
    blk = slice(me * plan.capacity, (me + 1) * plan.capacity)
    half = n_steps // 2

    def whole(u_blk):
        return group.all_gather(u_blk)[:asm.n_dofs]

    def velocity(u, suffix=""):
        return {"u" + suffix: u[off_u:off_u + ndv],
                "v" + suffix: u[off_v:off_v + ndv]}

    def march(first, u, px, pe, save):
        u_blk, res = step.own(u), float("nan")
        for it in range(first, n_steps):
            u_blk, res = step(u_blk, velocity(whole(u_blk), "_old"))
            u = whole(u_blk)
            px, pe, _ = advect(px, pe, tuple(velocity(u).values()), DT)
            if save and it + 1 == half:
                state = {"u": u, "px": group.all_gather(px),
                         "pe": group.all_gather(pe)}
                if me == 0:
                    CheckpointManager(ckpt_dir).save(it + 1, state)
                group.barrier()
        return {"u": u.cpu().numpy(), "px": group.all_gather(px).cpu().numpy(),
                "pe": group.all_gather(pe).cpu().numpy(), "res": float(res)}

    u0 = torch.as_tensor(apply_dirichlet_values(asm, np.zeros(asm.n_dofs)),
                         dtype=DTYPE, device=dev)
    rng = np.random.default_rng(42)
    pts = 0.5 + rng.uniform(-0.3, 0.3, size=(40, 2))
    cloud = MarkerCloud(mesh, pts.copy(), np.zeros(len(pts), np.int64))
    locate(cloud, device=dev)
    X, E = distribute(cloud, plan)
    a = march(0, u0, torch.as_tensor(X[blk], dtype=DTYPE, device=dev),
              torch.as_tensor(E[blk], device=dev), save=True)

    # a fresh march restored from the checkpoint, continuing to the end
    mgr = CheckpointManager(ckpt_dir)
    first = mgr.latest_step()
    assert first == half, (first, half)
    state = mgr.restore(first)
    b = march(first, torch.as_tensor(state["u"], dtype=DTYPE, device=dev),
              torch.as_tensor(state["px"][blk], dtype=DTYPE, device=dev),
              torch.as_tensor(state["pe"][blk], device=dev), save=False)
    return {"a": a, "b": b, "restored_at": first}


def main(device="cuda", n_ranks=4):
    device = resolve_device(device)
    n = env_int("EX_N", 8)
    n_steps = env_int("EX_STEPS", 6)
    ckpt = os.environ.get("EX_OUT", os.path.join(tempfile.gettempdir(),
                                                 "ex10_ckpt"))
    ckpt = os.path.join(os.path.dirname(ckpt) or ckpt, "ex10_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)   # stale runs must not alias

    args = (n, n_steps, ckpt)
    out = (run_rank(device_mesh(1, device), *args) if n_ranks == 1 else
           launch(run_rank, n_ranks, args, device=device.type, quiet=True)[0])
    a, b = out["a"], out["b"]
    du = np.abs(a["u"] - b["u"]).max()
    dx = np.abs(a["px"] - b["px"]).max()
    same_elem = (a["pe"] == b["pe"]).all()
    alive = int((a["pe"] >= 0).sum())
    print(f"steps {n_steps} devices {n_ranks}: |u|max "
          f"{np.abs(a['u']).max():.4f} lin_res {a['res']:.2e}; markers alive "
          f"{alive}; restore drift |du| {du:.2e} |dx| {dx:.2e} elems_match "
          f"{same_elem}")
    assert du < 1e-12 and dx < 1e-12 and same_elem, "restart must be exact"
    x, elem = collect(a["px"], a["pe"])
    return {"u": a["u"], "x": x, "elem": elem, "lin_res": a["res"],
            "alive": alive, "du": float(du), "dx": float(dx),
            "elems_match": bool(same_elem), "max_abs_u":
            float(np.abs(a["u"]).max()), "restored_at": out["restored_at"]}


if __name__ == "__main__":
    cli(main)
