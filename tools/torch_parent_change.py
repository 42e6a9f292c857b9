"""Compare two checkouts of the port on one card: the cavity-128 Newton
solve (5 steps) and five poisson-patch-1M solves from zero, each checkout
in its own process, in the order parent, change, change, parent, parent,
change.

    python tools/torch_parent_change.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR is an unpacked checkout (e.g. ``git archive <commit> | tar -x
-C build/parent``, a directory ``.gitignore`` lists); CHANGE_DIR defaults
to this checkout.  Each process builds its own kernels and prints one JSON
line: the Newton step seconds and GMRES iterations, the patch solve
seconds and iterations.  Card only; about ten minutes.
"""
import json
import os
import subprocess
import sys
import time

ORDER = ("parent", "change", "change", "parent", "parent", "change")


def one(root: str) -> dict:
    """Both solves of the checkout at ``root``, in this process."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from femus_tpu_torch._cuda_build import KERNEL_SOURCES, build

    assert cs.__file__.startswith(root), cs.__file__
    build(KERNEL_SOURCES)
    sys_, _ = cs.cavity_system(16, 4, "cuda", torch.float32, rtol=1e-4,
                               max_nonlinear=5)
    sys_.solve()
    out = {"root": root,
           "cavity_steps": [h["seconds"] for h in sys_.history],
           "cavity_iters": [h["lin_iters"] for h in sys_.history]}
    del sys_
    psys, _, psol, _ = cs.patch_system("poisson", 32, 5, "cuda",
                                       torch.float32, 1e-6)
    out["patch_solve_s"], out["patch_iters"] = [], []
    for _ in range(5):
        psol.sol[-1]["u"][:] = 0.0
        t0 = time.perf_counter()
        info = psys.solve()
        torch.cuda.synchronize()
        out["patch_solve_s"].append(time.perf_counter() - t0)
        out["patch_iters"].append(info["iters"])
    return out


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(os.path.abspath(sys.argv[2]))), flush=True)
        return
    roots = {"parent": os.path.abspath(sys.argv[1]),
             "change": os.path.abspath(sys.argv[2] if len(sys.argv) > 2
                                       else os.path.dirname(os.path.dirname(
                                           os.path.abspath(__file__))))}
    for side in ORDER:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", roots[side]], capture_output=True,
                             text=True, check=True)
        print(json.dumps({"side": side,
                          **json.loads(res.stdout.splitlines()[-1])}),
              flush=True)


if __name__ == "__main__":
    main()
