"""Stochastic Poisson via polynomial chaos + sparse-grid PDF estimation.

Reference: applications/UQ (src/uq Hermite/Legendre PCE tables,
sparseGrid.hpp density estimation).
"""
import numpy as np
import torch

from .. import resolve_device
from ..algebra.bell import on_bell_frame
from ..algebra.krylov import cg
from ..assembly.bc import generate_bdc
from ..assembly.engine import Assembler, Unknown
from ..mesh.generation import unit_box
from ..uq.pce import multivariate_polys, pce_project, total_degree_set
from ..uq.sparse_grid import fit_pdf
from ._common import DTYPE, cli


def poisson_solver(n, device="cuda", dtype=DTYPE, bell=False, maxiter=500):
    """The stochastic Poisson -div(kappa grad u) = 1 on unit_box((n, n))
    Q2, homogeneous Dirichlet: (solve(kappa) -> (u at (1/2, 1/2), CG
    report), the assembled operator at kappa = 1, its pattern).  Each solve
    assembles with ``kappa`` as an aux scalar and runs diagonal-
    preconditioned CG to 1e-12; ``bell``: on the BELL frame (kernel B1 on
    the card)."""
    mesh = unit_box((n, n), "quad")
    fam = "biquadratic"
    a = Assembler(mesh, [Unknown("u", fam)], quad_order="fifth",
                  dtype=dtype, device=device)

    def form(ops, u, aux):
        g = ops.grad(fam, u["u"])
        one = ops.pointwise(lambda x: 1.0 + 0.0 * x[..., 0])
        return {"u": aux["kappa"] * ops.tgrad(fam, g) - ops.t(fam, one)}

    a.set_volume_form(form)
    generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
    assemble = a.make_assemble_fn()
    xy = mesh.coords[mesh.dofmap(fam).nodes]
    centre = int(np.argmin(np.abs(xy - 0.5).sum(axis=1)))
    u0 = torch.zeros(a.n_dofs, dtype=dtype, device=a.device)

    def solve(kappa: float):
        R, data = assemble(u0, {"kappa": kappa})
        A = a.op_with(data)
        if bell:
            A = on_bell_frame(A, a.pattern, a.device)
        d = A.diagonal()
        u, info = cg(A.matvec, -R, M=lambda r: r / d, tol=1e-12,
                     maxiter=maxiter)
        return float(u[centre]), info

    _, data1 = assemble(u0, {"kappa": 1.0})
    return solve, data1, a.pattern


def solve_poisson(log_kappa, device="cuda"):
    """u(0.5, 0.5) for -div(e^xi grad u) = 1, homogeneous Dirichlet."""
    solve, _, _ = poisson_solver(8, device)
    return solve(float(np.exp(log_kappa)))[0]


def main(device="cuda"):
    device = resolve_device(device)
    # PCE of xi -> u_center(xi), xi ~ N(0, 0.5^2) via Hermite chaos
    idx = total_degree_set(1, 4)
    coeffs = pce_project(
        "hermite", idx,
        lambda pts: torch.tensor([solve_poisson(0.5 * float(p[0]), device)
                                  for p in pts], dtype=DTYPE),
        nq_1d=7, device=device)
    mean = float(coeffs[0])
    var = float(torch.sum(coeffs[1:] ** 2))
    print(f"PCE: E[u_c] = {mean:.5f}, Var[u_c] = {var:.3e}")

    # Monte-Carlo samples through the PCE surrogate -> sparse-grid PDF
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 1, 4000)
    vals = coeffs @ multivariate_polys("hermite", idx, xi[:, None], device)
    pdf = fit_pdf(vals[:, None], max_level=4, device=device)
    vals = vals.cpu().numpy()
    lo, hi = vals.min(), vals.max()
    grid = np.linspace(lo, hi, 5)[1:-1]
    dens = [float(pdf.evaluate(np.array([[g]]))[0]) for g in grid]
    print("sparse-grid PDF at", [f"{g:.3f}" for g in grid], "=",
          [f"{d:.2f}" for d in dens])
    return {"coeffs": coeffs.cpu().numpy(), "mean": mean, "var": var,
            "grid": grid, "pdf": dens}


if __name__ == "__main__":
    cli(main)
