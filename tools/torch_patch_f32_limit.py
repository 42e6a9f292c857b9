"""How accurate can a float32 solve of the patch Poisson problem be?

Builds the poisson-patch system of ``chip_smoke.py`` (-Lap u = 2 pi^2
sin(pi x) sin(pi y), homogeneous Dirichlet, rediscretized V-cycle GMRES at
rtol 1e-6) on the host at cut sizes and prints, per size, the max nodal
error against sin(pi x) sin(pi y) of

- the float32 MG-GMRES solve (the card's working precision),
- an exact (sparse direct, float64) solve of the float32-ASSEMBLED matrix
  and right-hand side: the floor that rounding the assembled data to
  float32 sets, whatever the solver,
- the float64 MG-GMRES solve (discretisation error only).

    python tools/torch_patch_f32_limit.py              # 64^2 and 128^2 Q2
    python tools/torch_patch_f32_limit.py 64 128 256   # elements per side
    python tools/torch_patch_f32_limit.py --device cuda 256 512

On the host (the default) keep to cut sizes of the 512^2 slice cell; with
``--device cuda`` the solves and the float32 assembly run on the card and
the direct solve on the card's host.
"""
import argparse
import json
import os
import sys

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import patch_system  # noqa: E402
from femus_tpu_torch.assembly.engine import Assembler  # noqa: E402


def max_err(ml_mesh, u):
    xy = ml_mesh.levels[-1].node_coords_of("biquadratic")
    return float(np.abs(u - np.sin(np.pi * xy[:, 0])
                        * np.sin(np.pi * xy[:, 1])).max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sides", type=int, nargs="*", default=[64, 128],
                    help="Q2 elements per side (multiples of 8)")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    for side in args.sides:
        coarse, levels = side // 8, 4
        out = {"elements_per_side": coarse * 2 ** (levels - 1),
               "device": args.device}
        for dt in (torch.float32, torch.float64):
            sys_, ml_mesh, ml_sol, _ = patch_system("poisson", coarse, levels,
                                                    args.device, dt,
                                                    rtol=1e-6)
            info = sys_.solve()
            out[f"mg_gmres_{str(dt)[6:]}"] = max_err(ml_mesh,
                                                    ml_sol.sol[-1]["u"])
            out[f"iters_{str(dt)[6:]}"] = info["iters"]
        a = sys_.assemblers[-1]
        ell = Assembler(a.mesh, a.unknowns, quad_order=a.quad_order,
                        dtype=torch.float32, device=args.device)
        ell.set_volume_form(a.volume_form)
        ell.set_dirichlet(a.dirichlet_mask)
        R, data = ell.make_assemble_fn()(torch.zeros(
            a.n_dofs, dtype=torch.float32, device=args.device))
        R, data = R.cpu(), data.cpu()
        pat = ell.pattern
        A = sp.csr_matrix((data.numpy().astype(np.float64).ravel(),
                           (np.repeat(np.arange(pat.n_rows), pat.width),
                            pat.cols.ravel())), shape=(a.n_dofs, a.n_dofs))
        u = spl.spsolve(A.tocsc(), -R.numpy().astype(np.float64))
        out["exact_solve_of_f32_data"] = max_err(ml_mesh, u)
        out["n_dofs"] = a.n_dofs
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
