"""Two behaviours of the JAX package's optimal-control systems that the
PyTorch port does not copy, shown on the host in float64.

1. Interleaved dofs: ``fix_interior_control`` and ``solve_pdas`` edit the
   PHYSICAL Dirichlet mask at LOGICAL offsets and hand it back to
   ``set_dirichlet``, which permutes it again.  With
   ``interleave_dofs=True`` the boundary-control solve returns NaN at once;
   with the stacked layout it converges.  (The port raises ValueError for
   an interleaved system instead.)
2. PDAS at depth: from the same start, ``solve_pdas`` stops after a few
   iterations on a coarse mesh but is still changing its active sets after
   ``max_iters`` on a 16x16 mesh, while every linear solve converges and
   the bounds hold.

Prints one JSON line per case: the layout or mesh, the GMRES iterations
and residuals, whether the fields are finite, and the PDAS active counts
after every KKT solve.

    python tools/oc_reference_caveats.py                # both findings
    python tools/oc_reference_caveats.py --pdas-iters 20 --pdas-coarse 4 8

Needs JAX (it drives ``femus_tpu``); about a minute with the defaults.
"""
import argparse
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from femus_tpu.mesh.generation import unit_box  # noqa: E402
from femus_tpu.mesh.multilevel import MultiLevelMesh  # noqa: E402
from femus_tpu.mesh.reorder import rcm_reorder_hierarchy  # noqa: E402
from femus_tpu.systems import optimal_control as oc  # noqa: E402
from femus_tpu.systems.problem import MultiLevelProblem  # noqa: E402
from femus_tpu.systems.solution import MultiLevelSolution  # noqa: E402
from femus_tpu.systems.system import NonLinearImplicitSystem  # noqa: E402

PI = np.pi


def y_d(x):
    return jnp.sin(PI * x[:, 0]) * jnp.sin(PI * x[:, 1])


class Recording(NonLinearImplicitSystem):
    """Records the PDAS active counts after every KKT solve."""

    def solve(self):
        out = super().solve()
        p = getattr(self, "_pdas", None)
        if p is not None:
            s = self.ml_sol.sol[-1]
            u = s[p["ctrl"]]
            mu = s[p["adj"]] - p["alpha"] * u
            self.counts.append(
                (int((mu + p["c"] * (u - p["ub"]) > 0).sum()),
                 int((mu + p["c"] * (u - p["ua"]) < 0).sum())))
        return out


class PDAS(oc.PDASControlSystem, Recording):
    pass


def system(kind, coarse, levels, interleave):
    ml = MultiLevelMesh(unit_box((coarse, coarse)), levels)
    rcm_reorder_hierarchy(ml)
    sol = MultiLevelSolution(ml)
    for v in ("y", "l", "u"):
        sol.add_solution(v, "biquadratic")
        sol.initialize(v)
    if kind == "boundary":
        sol.attach_bc(lambda var, x, grp, t: (
            (grp != 2) if var in ("y", "l") else False, 0.0))
    else:
        sol.attach_bc(lambda var, x, grp, t: (var in ("y", "l"), 0.0))
    sol.generate_bdc("y", "l", "u")
    prob = MultiLevelProblem(ml, sol, quad_order="fifth")
    s = prob.add_system(PDAS if kind == "pdas" else Recording, kind)
    s.counts = []
    s.add_unknown("y", "l", "u")
    if kind == "boundary":
        s.set_assembly(*oc.boundary_control_forms(
            y_target=y_d, alpha=1e-2, control_groups=(2,)))
    else:
        s.set_assembly(oc.elliptic_control_form("y", "l", "u",
                                                y_target=y_d, alpha=1e-3))
    cfg = s.config
    cfg.operator = "bell"
    cfg.interleave_dofs = interleave
    cfg.smoother = "vanka"
    cfg.restart = 60
    cfg.max_outer = 10
    cfg.rtol = 1e-8
    cfg.max_nonlinear = 1
    s.init()
    if kind == "boundary":
        oc.fix_interior_control(s, "u", (2,))
    return s, sol


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pdas-iters", type=int, default=20)
    ap.add_argument("--pdas-coarse", type=int, nargs="+", default=[3, 8])
    args = ap.parse_args()
    for interleave in (True, False):
        s, sol = system("boundary", 4, 3, interleave)
        h = s.solve()
        fields = np.concatenate([sol.sol[-1][v] for v in ("y", "l", "u")])
        print(json.dumps({"case": "boundary-control", "coarse": 4,
                          "levels": 3, "interleave_dofs": interleave,
                          "gmres_iters": int(h["lin_iters"]),
                          "lin_res": float(h["lin_res"]),
                          "fields_finite": bool(np.isfinite(fields).all())}),
              flush=True)
    for coarse in args.pdas_coarse:
        s, sol = system("pdas", coarse, 2, False)
        s.set_control_bounds("u", 0.5, 8.0, alpha=1e-3)
        info = s.solve_pdas(max_iters=args.pdas_iters)
        u = sol.sol[-1]["u"]
        print(json.dumps({"case": "pdas", "finest": 2 * coarse,
                          "max_iters": args.pdas_iters,
                          "pdas_iters": info["pdas_iters"],
                          "active_counts": s.counts,
                          "last_lin_res": float(info["lin_res"]),
                          "u_range": [float(u.min()), float(u.max())]}),
              flush=True)


if __name__ == "__main__":
    main()
