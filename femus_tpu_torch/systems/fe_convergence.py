"""FE h-convergence study harness.

Equivalent of ``FE_convergence<real>::convergence_study``
(FE_convergence.hpp:29-139): run the same problem over a refinement
hierarchy, compute per-unknown L2/H1 error norms — against an analytic
solution or the next-finer level — and report observed orders
(output_convergence_order, FE_convergence.hpp:400-471).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..algebra.transfer import prolongation_scipy
from ..assembly.norms import error_norms
from ..mesh.multilevel import MultiLevelMesh


@dataclasses.dataclass
class ConvergenceResult:
    levels: List[int]
    l2_errors: Dict[str, List[float]]
    h1_errors: Dict[str, List[float]]
    l2_orders: Dict[str, List[float]]
    h1_orders: Dict[str, List[float]]

    def report(self) -> str:
        out = []
        for v in self.l2_errors:
            out.append(f"unknown '{v}':")
            out.append("  lvl      L2 error   order      H1 error   order")
            for i, l in enumerate(self.levels):
                o2 = self.l2_orders[v][i - 1] if i else float("nan")
                o1 = self.h1_orders[v][i - 1] if i else float("nan")
                out.append(f"  {l:3d}  {self.l2_errors[v][i]:12.4e} {o2:6.2f}"
                           f"  {self.h1_errors[v][i]:12.4e} {o1:6.2f}")
        return "\n".join(out)


def convergence_study(make_and_solve: Callable, coarse_mesh, n_levels: int,
                      exacts: Dict[str, Callable],
                      exact_grads: Optional[Dict[str, Callable]] = None,
                      quad_order="ninth", device="cuda") -> ConvergenceResult:
    """make_and_solve(ml_mesh) -> (ml_sol, families: dict var->family); run
    it on hierarchies of increasing depth, compare vs analytic fields (the
    norms are computed on ``device``)."""
    l2: Dict[str, List[float]] = {}
    h1: Dict[str, List[float]] = {}
    levels = list(range(1, n_levels + 1))
    for nl in levels:
        ml_mesh = MultiLevelMesh(coarse_mesh, nl)
        ml_sol, fams = make_and_solve(ml_mesh)
        for v, fam in fams.items():
            eg = (exact_grads or {}).get(v)
            e2, e1 = error_norms(ml_mesh.finest(), fam, ml_sol.sol[-1][v],
                                 exacts[v], eg, quad_order, device)
            l2.setdefault(v, []).append(e2)
            h1.setdefault(v, []).append(e1)
    l2o = {v: [float(np.log2(l2[v][i] / l2[v][i + 1]))
               for i in range(len(levels) - 1)] for v in l2}
    h1o = {v: [float(np.log2(h1[v][i] / max(h1[v][i + 1], 1e-300)))
               for i in range(len(levels) - 1)] for v in h1}
    return ConvergenceResult(levels, l2, h1, l2o, h1o)


def incremental_convergence(sols: Sequence, ml_mesh: MultiLevelMesh,
                            var: str, family: str) -> List[float]:
    """Fine-vs-coarse incremental errors (reference
    solution_generation_single_level.hpp mode): || P u_l - u_{l+1} ||."""
    errs = []
    for l in range(len(sols) - 1):
        P = prolongation_scipy(ml_mesh.levels[l], ml_mesh.levels[l + 1],
                               family)
        diff = P @ np.asarray(sols[l]) - np.asarray(sols[l + 1])
        errs.append(float(np.linalg.norm(diff)))
    return errs
