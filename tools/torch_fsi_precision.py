"""Why the card's FSI phases solve in float64: the steady fsi-bed solve of
``chip_smoke.py`` in float32 and in float64, step by step.

For each Newton step of the F ratchet it prints one JSON line: the level,
the FGMRES iterations, the solve's target rtol * ||R||, the TRUE residual
||b - A x|| at the returned correction, whether FGMRES reported
convergence (its Givens estimate), ||R(u)|| at the step's input and the
largest relative Newton correction.  A float32 run whose true residual
sits far above its target while the estimate reports convergence, or one
whose Vanka block factorisation meets an exact zero pivot, is printed as
such instead of raising.

    python tools/torch_fsi_precision.py                       # host, 4x4, 3 levels
    python tools/torch_fsi_precision.py --device cuda --coarse 16 --levels 4

On the host keep to 4x4 coarse and 2-3 levels (minutes per level); the
lid defaults to 0.02, where the 8x8 level of a 4x4-coarse hierarchy
converges in float64 (``--lid 0.2`` is fsi-bed-128's).
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import fsi_system  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--coarse", type=int, default=4)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--lid", type=float, default=0.02)
    ap.add_argument("--max-nonlinear", type=int, default=4)
    ap.add_argument("--dtypes", default="float32,float64")
    args = ap.parse_args()
    for name in args.dtypes.split(","):
        dtype = getattr(torch, name)
        sys_, _ = fsi_system(args.coarse, args.levels, args.device, dtype,
                             rtol=1e-4, max_nonlinear=args.max_nonlinear,
                             lid=args.lid)
        try:
            sys_.solve()
            error = None
        except RuntimeError as exc:          # e.g. a zero pivot in Vanka
            error = str(exc).splitlines()[0]
        for h in getattr(sys_, "history", []):
            print(json.dumps({
                "dtype": name, "level": h["level"], "it": h["newton_it"],
                "fgmres_iters": h["lin_iters"], "target": h["lin_target"],
                "true_residual": h["lin_res"],
                "estimate_converged": h["converged"],
                "res_norm": h["res_norm"],
                "max_eps": max(h["eps"].values())}), flush=True)
        print(json.dumps({"dtype": name, "coarse": args.coarse,
                          "levels": args.levels, "lid": args.lid,
                          "error": error}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
