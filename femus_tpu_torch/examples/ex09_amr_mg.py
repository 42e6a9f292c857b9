"""Adaptive refinement with multigrid across the AMR level chain.

Reference: applications/AMR + applications/MGAMR (and the AMR branch of
LinearImplicitSystem::MGsolve, LinearImplicitSystem.cpp:529-577, where
_PPamr/_RRamr fold the hanging-node constraints into the transfer chain).

Drive: Poisson with a corner-layer source on the unit square.  Each cycle
solves with the V-cycle preconditioner built ACROSS the AMR levels
(systems/amr.solve_mg_amr — every level assembles on its own mixed-level
mesh, reduces by its hanging constraints, and the transfers are the
embedding prolongation composed with the coarse constraint interpolation),
estimates per-element error with the Kelly gradient-jump indicator, flags
the top fraction, and selectively refines with 1-irregularity closure.

The printout shows the two claims that matter: the error concentrates the
dofs near the layer (dof counts grow far slower than uniform refinement),
and the MG-preconditioned CG iteration counts stay flat as AMR levels pile
up — the mesh-independence property the reference's MGAMR app exercises.
"""
import numpy as np
import torch

from .. import resolve_device
from ..assembly.engine import Unknown
from ..assembly.forms import poisson
from ..mesh.amr import flag_by_error, refine_selective
from ..mesh.generation import unit_box
from ..systems.amr import kelly_indicator, solve_mg_amr
from ._common import DTYPE, cli, env_int

FAM = "biquadratic"


def rhs(x):
    # sharp source concentrated at the corner (0, 0)
    r2 = torch.sum(x * x, dim=-1)
    return torch.exp(-r2 / 0.005)


def bc(var, x, grp, t):
    return True, 0.0


def main(device="cuda"):
    device = resolve_device(device)
    n0 = env_int("EX_N", 4)
    cycles = env_int("EX_CYCLES", 3)
    frac = 0.25

    meshes = [unit_box((n0, n0), "quad")]
    unks = [Unknown("u", FAM)]
    form = poisson("u", FAM, rhs=rhs)
    out = []
    for cyc in range(cycles + 1):
        u, info = solve_mg_amr(meshes, unks, form, bc, device=device,
                               dtype=DTYPE)
        m = meshes[-1]
        dm = m.dofmap(FAM)
        eta = kelly_indicator(m, FAM, u[:dm.n_dofs])
        eta_norm = float(np.linalg.norm(eta))
        print(f"cycle {cyc}: levels={info['n_levels']} dofs={dm.n_dofs} "
              f"cg_iters={info['iterations']} res={info['residual']:.2e} "
              f"eta={eta_norm:.3e}")
        out.append({"levels": info["n_levels"], "dofs": dm.n_dofs,
                    "cg_iters": info["iterations"],
                    "residual": info["residual"],
                    "converged": info["converged"], "eta": eta_norm})
        if cyc < cycles:
            meshes.append(refine_selective(
                m, flag_by_error(eta, frac, mode="fraction")))
    # flat iteration counts = mesh-independent MG across AMR levels
    assert info["iterations"] <= 20, info
    print("final: AMR chain of", len(meshes), "levels,",
          meshes[-1].n_elems, "elements on the finest")
    return {"cycles": out, "chain": len(meshes),
            "elements": meshes[-1].n_elems, "u": u}


if __name__ == "__main__":
    cli(main)
