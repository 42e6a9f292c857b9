"""The program's steady DFG channel (the square-obstacle variant), as the
benchmark drives it.

``femus_tpu_torch.apps.ns_bench.make_ns_system`` (the port's golden app:
Q2/Q2/P1dc, Vanka-smoothed MG-GMRES(60), an F-cycle Newton ratchet over
the levels) on the mesh file that ``references/channel_mesh.py`` writes,
with the configuration's levels, tolerance, operator, dof layout and
Newton steps a level.  One solve is one whole ``NonLinearImplicitSystem.
solve()`` from the app's own initial guess: every level's fields are put
back before it, while the built steps, plans, tables and kernels stay.
"""
from __future__ import annotations

import os
from typing import Dict

import torch

from ..references.channel_mesh import write_neu


class Driver:
    def __init__(self, cfg: Dict, workdir: str, device: str):
        from femus_tpu_torch.apps import ns_bench

        mesh, solver = cfg["mesh"], cfg["solver"]
        path = write_neu(os.path.join(workdir, "channel.neu"),
                         *mesh["coarse_cells"])
        self.prob, self.sys = ns_bench.make_ns_system(
            levels=mesh["levels"], rtol=solver["rtol"],
            interleave=solver["interleave"], mesh_path=path, device=device,
            dtype=getattr(torch, cfg["dtype"]))
        self.sys.config.operator = solver["operator"]
        self.sys.config.max_nonlinear = solver["max_newton_per_level"]
        self.sol = self.prob.ml_sol.sol
        self.initial = [{n: a.copy() for n, a in lv.items()}
                        for lv in self.sol]

    def solve(self, request: Dict) -> Dict:
        for lv, saved in zip(self.sol, self.initial):
            for n, a in saved.items():
                lv[n][:] = a
        self.sys.solve()
        hist = self.sys.history
        return {"newton_steps": len(hist),
                "krylov_iters": sum(h["lin_iters"] for h in hist),
                "converged": all(h["converged"] for h in hist)}

    def output(self) -> Dict:
        """The finest level's fields, copied to the host."""
        return {n: self.sol[-1][n].copy() for n in ("U", "V", "P")}

    def layout(self) -> Dict:
        """Where the fields sit: the velocity dofs' points and each
        element's corners (the frame of its pressure coefficients)."""
        m = self.sys.ml_mesh.levels[-1]
        return {"vel_xy": m.node_coords_of("biquadratic"),
                "elem_corners": m.coords[m.conn[:, :4]]}

    def profile(self) -> Dict:
        return self.sys.profile_step(-1, reps=3)
