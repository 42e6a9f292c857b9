"""How far Newton steps from one float32 state differ on the card.

    python tools/torch_checkpoint_step_gap.py [--steps 5]

Solves cavity-128 as ``chip_smoke.py``'s main path does (slice 1:
unit_box((16, 16)), 4 levels, float32, kernel B1), saves its solution
through ``CheckpointManager``, restores it into a freshly initialised
System, and takes ``--steps`` Newton steps (the solve step, state left
alone) from each, first from the state as it is, then from the kicked
state of ``chip_smoke.kicked_start`` (free dofs scaled by 1 +
CKPT_KICK).  For each start prints the largest and smallest relative gap
between the updates (end - start) of two steps from the saved state, and
of a step from the saved state against one from the restored state, the
update's norm relative to the end, and the GMRES iterations: the spread
behind ``chip_smoke.py``'s CKPT_UPDATE_RTOL.  Needs a CUDA card and the
kernels' toolchain.
"""
import argparse
import itertools
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    from femus_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                  capture_solution,
                                                  restore_solution)
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    card = cs.card_line()
    print(card)
    cs.phase_build(card)
    sys_, ml_sol = cs.cavity_system(cs.COARSE_CELLS, cs.LEVELS, "cuda",
                                    torch.float32, rtol=1e-4,
                                    max_nonlinear=5)
    cs.phase_main(sys_, ml_sol)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, max_to_keep=1)
        mgr.save(5, {"solution": capture_solution(ml_sol)})
        sys2, sol2 = cs.cavity_system(
            cs.COARSE_CELLS, cs.LEVELS, "cuda", torch.float32,
            rtol=sys_.config.rtol, max_nonlinear=sys_.config.max_nonlinear)
        restore_solution(sol2, mgr.restore()["solution"])
    def norm(x):
        return float(torch.linalg.norm(x))

    for kick in (False, True):
        upd, iters, size = {}, [], []
        for tag, s in (("saved", sys_), ("restored", sys2)):
            u = (cs.kicked_start(s) if kick else torch.as_tensor(
                s.gather(-1), dtype=s.dtype, device=s.device))
            step = s.step_fn(-1)
            upd[tag] = []
            for _ in range(args.steps):
                out = step(u)
                upd[tag].append(out.u.double() - u.double())
                iters.append(out.lin_iters)
                size.append(norm(upd[tag][-1]) / norm(out.u.double()))
        same = [norm(a - b) / norm(a)
                for a, b in itertools.combinations(upd["saved"], 2)]
        cross = [norm(a - b) / norm(a)
                 for a in upd["saved"] for b in upd["restored"]]
        print(f"{'kicked' if kick else 'as saved'}: saved vs saved: "
              f"{min(same)!r} .. {max(same)!r}; saved vs restored: "
              f"{min(cross)!r} .. {max(cross)!r}; ||update||/||end|| "
              f"{min(size)!r} .. {max(size)!r}; GMRES iterations "
              f"{sorted(set(iters))}", flush=True)

if __name__ == "__main__":
    main()
