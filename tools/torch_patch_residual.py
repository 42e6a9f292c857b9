"""How far does float32 GMRES get on the full-size patch solves?

Runs the poisson-patch-1M and elasticity-patch solves of ``chip_smoke.py``
(``LinearImplicitSystem.solve``, rediscretized V-cycle GMRES(30) in
float32 at rtol 1e-6) on one CUDA card.  After the solve's own GMRES has
stopped, it runs further restart cycles from the returned solution (5
iterations each, no early exit) and prints, per cycle, the true
preconditioned residual ||M (b - A x)|| against the solve's target
rtol * ||M b||, and for Poisson the max nodal error against
sin(pi x) sin(pi y).  A residual that stops falling is the float32 floor
of the residual itself; an error that falls with it means the solve's own
stop came early.

    python tools/torch_patch_residual.py          # both problems, 8 cycles
    python tools/torch_patch_residual.py --cycles 4 --repeat 2

``--repeat`` solves each problem again from scratch, to show the spread
between solves of the same data on the card.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (ELAST_COARSE, ELAST_LEVELS, PATCH_COARSE,  # noqa: E402
                        PATCH_LEVELS, patch_system)
import femus_tpu_torch.systems.system as system  # noqa: E402


def run(problem: str, coarse: int, levels: int, cycles: int,
        device="cuda") -> dict:
    sys_, ml_mesh, _, _ = patch_system(problem, coarse, levels, device,
                                       torch.float32, rtol=1e-6)
    exact = None
    if problem == "poisson":
        xy = ml_mesh.levels[-1].node_coords_of("biquadratic")
        exact = torch.as_tensor(np.sin(np.pi * xy[:, 0])
                                * np.sin(np.pi * xy[:, 1]),
                                dtype=torch.float32, device=device)
    rows = []
    gmres = system.gmres

    def spy(A, b, x0=None, M=None, **kw):
        x, info = gmres(A, b, x0=x0, M=M, **kw)
        row = {"cycle": 0, "iters": info.iters, "residual": info.residual,
               "target": info.target, "converged": info.converged}
        y = x
        for c in range(cycles + 1):
            if c:
                y, more = gmres(A, b, x0=y, M=M, tol=0.0, restart=5,
                                max_restarts=1)
                row = {"cycle": c, "iters": more.iters,
                       "residual": more.residual}
            row["ratio"] = row["residual"] / info.target
            if exact is not None:             # zero initial state: u = x
                row["max_nodal_err"] = float((y - exact).abs().max())
            rows.append(row)
        return x, info

    system.gmres = spy
    try:
        sys_.solve()
    finally:
        system.gmres = gmres
    return {"problem": problem, "n_dofs": sys_.assemblers[-1].n_dofs,
            "cycles": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_patch_residual: no CUDA device", file=sys.stderr)
        return 2
    for _ in range(args.repeat):
        for problem, coarse, levels in (
                ("poisson", PATCH_COARSE, PATCH_LEVELS),
                ("elasticity", ELAST_COARSE, ELAST_LEVELS)):
            print(json.dumps(run(problem, coarse, levels, args.cycles)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
