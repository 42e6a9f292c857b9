"""Which sorting window (sigma) for the sliced-ELL layout of the BELL frame?

Builds the fine pattern of the lid-driven cavity of ``chip_smoke.py``
(Q2/Q2/P1dc, interleaved dofs, RCM-reordered mesh, identity frame; default
16 coarse cells refined to 4 levels = the 128x128 cavity) and prints, per
sigma, the fill of the layout (stored slots / nonzeros) and its bytes.
The fill is a count and needs no card:

    python tools/torch_sell_sigma.py --device cpu

With a CUDA card it also lays seeded random values out in each sigma's
plan and times the matvec kernel (median device time of one call, CUDA
events; back to back, and with the L2 flushed before each call), with one
torch.sparse CSR matvec of the same matrix beside it:

    python tools/torch_sell_sigma.py

``SELL_SIGMA`` in ``femus_tpu_torch/algebra/bell.py`` is fixed from this
output.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line, time_cold_ms, time_ms  # noqa: E402
from femus_tpu_torch.algebra import bell  # noqa: E402
from femus_tpu_torch.assembly.engine import Assembler, Unknown  # noqa: E402
from femus_tpu_torch.mesh.generation import unit_box  # noqa: E402
from femus_tpu_torch.mesh.multilevel import MultiLevelMesh  # noqa: E402
from femus_tpu_torch.mesh.reorder import rcm_reorder_hierarchy  # noqa: E402


def cavity_pattern(coarse: int, levels: int):
    ml_mesh = MultiLevelMesh(unit_box((coarse, coarse)), levels)
    rcm_reorder_hierarchy(ml_mesh)
    asm = Assembler(ml_mesh.levels[-1],
                    [Unknown("u"), Unknown("v"), Unknown("p", "disc_linear")],
                    interleave=True, device="cpu")
    return asm.pattern


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coarse", type=int, default=16)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--sigmas", type=int, nargs="+",
                    default=[32, 64, 128, 256, 512, 1024, 4096])
    ap.add_argument("--repeat", type=int, default=1,
                    help="run the sweep this many times (spread of a time)")
    args = ap.parse_args()
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("torch_sell_sigma: no CUDA device", file=sys.stderr)
        return 2
    pat = cavity_pattern(args.coarse, args.levels)
    lens = np.diff(pat.indptr)
    head = {"n": int(pat.n_rows), "nnz": int(pat.nnz),
            "ell_width": int(pat.width),
            "row_length": {"min": int(lens.min()), "max": int(lens.max()),
                           "mean": float(lens.mean())}}
    if on_card:
        head["card"] = card_line()
        rng = np.random.default_rng(0)
        data = torch.as_tensor(rng.standard_normal(pat.cols.shape)
                               * pat.valid, dtype=torch.float32)
        x = torch.as_tensor(rng.standard_normal(pat.n_rows),
                            dtype=torch.float32, device="cuda")
        valid = torch.as_tensor(pat.valid, device="cuda")
        cols = torch.as_tensor(pat.cols, dtype=torch.int64, device="cuda")
        counts = valid.sum(dim=1)
        crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        csr = torch.sparse_csr_tensor(crow, cols[valid], data.cuda()[valid],
                                      check_invariants=False,
                                      size=(pat.n_rows, pat.n_rows))
        y_ref = csr @ x
        head["csr_ms"] = time_ms(lambda: csr @ x)
        head["csr_cold_ms"] = time_cold_ms(lambda: csr @ x)
    print(json.dumps(head), flush=True)
    for sigma in args.sigmas * args.repeat:
        plan = bell.build_sell_plan(pat, "identity", sigma)
        row = {"sigma": sigma, "fill": plan.fill, "slots": plan.total,
               "bytes_f32": plan.total * 8 + (plan.n_slices + 1) * 4
               + plan.n_slices * 32 * 4 + 2 * plan.n * 4}
        if on_card:
            for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                op = bell.relayout_ell(plan, data, dtype=dt, device="cuda")
                y = bell.spmv_bell_cuda(op, x)
                torch.cuda.synchronize()
                if name == "f32":
                    row["max_abs_diff_csr"] = float((y - y_ref).abs().max())
                row[name + "_ms"] = time_ms(
                    lambda: bell.spmv_bell_cuda(op, x))
                row[name + "_cold_ms"] = time_cold_ms(
                    lambda: bell.spmv_bell_cuda(op, x))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
