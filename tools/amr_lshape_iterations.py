"""The JAX package's multigrid across AMR levels on the L-shape, on the host.

    python tools/amr_lshape_iterations.py [--cycles 7] [--coarse 32]
                                          [--test-formula]

Runs ``femus_tpu.systems.amr.solve_mg_amr`` over the AMR chain of
amr-lshape (``chip_smoke.py``): (-1, 1)^2 minus (0, 1)^2 from
box((coarse, coarse)), Q2 Poisson with the harmonic corner function
r^(2/3) sin(2 (theta - pi/2) / 3), theta in [pi/2, 5 pi/2), as Dirichlet
data; each cycle Kelly, the worst 20 % flagged, refine_selective.  Prints
one line per cycle: elements, dofs, CG iterations, residual, L2 error.
``--test-formula`` takes tests/test_amr.py's r^(2/3) sin(2 (theta + pi/2)
/ 3), theta cut at -pi/2, instead: that cut crosses the domain along
x = 0, y < 0, and the L2 error does not converge.  Seven cycles take a few
minutes on the host.
"""
import argparse
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from femus_tpu.assembly.engine import Unknown  # noqa: E402
from femus_tpu.assembly.forms import poisson  # noqa: E402
from femus_tpu.assembly.norms import error_norms  # noqa: E402
from femus_tpu.mesh.amr import flag_by_error, refine_selective  # noqa: E402
from femus_tpu.mesh.generation import box  # noqa: E402
from femus_tpu.mesh.mesh import Mesh, build_boundary_faces  # noqa: E402
from femus_tpu.systems.amr import kelly_indicator, solve_mg_amr  # noqa: E402


def lshape(n):
    m0 = box((n, n), [(-1.0, 1.0), (-1.0, 1.0)], "quad")
    cent = m0.coords[m0.conn[:, :4]].mean(axis=1)
    keep = ~((cent[:, 0] > 0) & (cent[:, 1] > 0))
    used = np.unique(m0.conn[keep])
    remap = -np.ones(m0.coords.shape[0], np.int64)
    remap[used] = np.arange(len(used))
    m = Mesh(dim=2, geom="quad", coords=m0.coords[used],
             conn=remap[m0.conn[keep]].astype(np.int32),
             elem_group=m0.elem_group[keep])
    build_boundary_faces(m, group_fn=lambda c: 1)
    return m


def exact(x, xp, test_formula):
    th = xp.arctan2(x[:, 1], x[:, 0])
    if test_formula:
        th = xp.where(th < -np.pi / 2, th + 2 * np.pi, th)
        phi = th + np.pi / 2
    else:
        th = xp.where(th < np.pi / 2 - 1e-12, th + 2 * np.pi, th)
        phi = th - np.pi / 2
    return xp.hypot(x[:, 0], x[:, 1]) ** (2.0 / 3) * xp.sin(2 * phi / 3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=7)
    ap.add_argument("--coarse", type=int, default=32)
    ap.add_argument("--test-formula", action="store_true")
    args = ap.parse_args()
    tf = args.test_formula
    bc = lambda var, x, grp, t: (                     # noqa: E731
        True, float(exact(x[None, :], np, tf)[0]))
    meshes = [lshape(args.coarse)]
    for cyc in range(args.cycles):
        m = meshes[-1]
        t0 = time.perf_counter()
        u, info = solve_mg_amr(meshes, [Unknown("u")], poisson("u"), bc)
        n = m.dofmap("biquadratic").n_dofs
        l2, _ = error_norms(m, "biquadratic", jnp.asarray(u[:n]),
                            lambda x: exact(x, jnp, tf), None)
        print(f"cycle {cyc}: elements {m.n_elems}, dofs {n}, CG "
              f"{info['iterations']} iterations, residual "
              f"{info['residual']:.3e}, L2 error {float(l2):.4e}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        eta = kelly_indicator(m, "biquadratic", np.asarray(u[:n]))
        meshes.append(refine_selective(m, flag_by_error(eta, 0.2,
                                                        mode="fraction")))


if __name__ == "__main__":
    main()
