"""The dryrun cavity's Vanka-preconditioned GMRES in both packages, on the host.

    python tools/dryrun_vanka_stagnation.py [--coarse 4 8 32]
                                            [--smoother vanka jacobi]

The two-level Q2/Q2/Q1 cavity of ``dryrun_multichip`` (nu = 0.1, the lid
at u = 1, the first pressure dof pinned) from unit_box((coarse, coarse)),
one sharded step from the boundary values: GMRES(20), 3 restarts, rtol
1e-6, a V-cycle whose smoother is ``jacobi`` or ``vanka`` (blocks of 2
elements on both levels, damping 0.9), as ``chip_smoke.py``'s dist_step
configs dryrun and dryrun-vanka run it.  The JAX package's
``make_sharded_step`` runs on a 4-device CPU mesh (``local_format``
"ell"), the port's (``femus_tpu_torch.parallel.cases.sharded_step_case``)
on one CPU rank, in float64.  Prints one line per size and smoother:
dofs, each package's residual, the port's iterations, and the largest
difference of the two solutions.
"""
import argparse
import os
import sys
import time

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

S = 4
GMRES = dict(outer="gmres", rtol=1e-6, restart=20, max_outer=3)


def jax_step(coarse: int, smoother: str):
    """(u, residual) of the JAX package's sharded step (it reports no
    iteration count)."""
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

    mesh = device_mesh(S)
    ml = MultiLevelMesh(unit_box((coarse, coarse), "quad"), 2)
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
    c, f = asms
    Pm = block_diag_prolongation(ml.levels[0], ml.levels[1],
                                 unknowns).tolil()
    Pm[masks[1][:Pm.shape[0]], :] = 0.0
    Pm[:, masks[0][:Pm.shape[1]]] = 0.0
    Pm = pad_prolongation(Pm.tocsr(), f.n_dofs_pad, c.n_dofs_pad)
    Pm.eliminate_zeros()
    Pop, Rop = op_pair_from_scipy(Pm)
    sched = build_ptap_schedule(f.pattern, Pm)
    vblocks = None
    if smoother == "vanka":
        vblocks = [build_element_blocks(c, 2, pattern=sched.coarse_pattern),
                   build_element_blocks(f, 2)]
    step = make_sharded_step(
        f, mesh, transfers=[(Pop, Rop, sched)],
        dir_masks=[jnp.asarray(masks[0])], smoother=smoother,
        vanka_blocks=vblocks, vanka_omega=0.9, **GMRES)
    u0 = jax.device_put(
        jnp.asarray(apply_dirichlet_values(f, np.zeros(f.n_dofs_pad))),
        NamedSharding(mesh, P("mesh")))
    u1, res = step(u0)
    return np.asarray(u1)[:f.n_dofs], float(res)


def port_step(coarse: int, smoother: str):
    """(u, residual, iterations) of the port's step on one CPU rank."""
    from femus_tpu_torch.parallel import cases
    from femus_tpu_torch.parallel.ranks import device_mesh

    out = cases.sharded_step_case(device_mesh(1, "cpu"), "dryrun", coarse,
                                  smoother=smoother, local_format="ell",
                                  **GMRES)
    return out["u"][:out["n"]], float(out["residual"]), out["iters"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coarse", type=int, nargs="+", default=[4, 8, 32])
    ap.add_argument("--smoother", nargs="+", default=["vanka", "jacobi"])
    args = ap.parse_args()
    for coarse in args.coarse:
        for smoother in args.smoother:
            t0 = time.perf_counter()
            uj, rj = jax_step(coarse, smoother)
            up, rp, ip = port_step(coarse, smoother)
            print(f"coarse {coarse} {smoother}: {uj.size} dofs, "
                  f"jax residual {rj!r}, "
                  f"port {ip} iterations residual {rp!r}, "
                  f"max |u_jax - u_port| {float(np.abs(uj - up).max())!r}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
