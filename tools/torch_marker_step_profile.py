"""Profile one batch of RK4 marker steps of markers-256 on the card.

    python tools/torch_marker_step_profile.py [--markers 1048576] [--steps 3]

Builds the chip_smoke.py markers-256 configuration (markers in the disk of
radius 0.4 on unit_box((256,256)), the Q2 rigid rotation, float64), takes
two warm steps, then prints torch.profiler's device-time table of
``--steps`` steps and the seconds per step of 20 more.  Run from the
checkout root (it imports chip_smoke)."""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from femus_tpu_torch.mesh.generation import unit_box  # noqa: E402
from femus_tpu_torch.particles.markers import (MarkerCloud, locate,  # noqa: E402
                                               make_advect_fn)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--markers", type=int, default=chip_smoke.MARKERS_COUNT)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    print(chip_smoke.card_line())
    mesh = unit_box((chip_smoke.MARKERS_N, chip_smoke.MARKERS_N))
    pts = chip_smoke.disk_markers(args.markers)
    cloud = MarkerCloud(mesh, pts.copy(), np.zeros(len(pts), np.int64))
    locate(cloud, device="cuda")
    u, v = chip_smoke.rotation_field(mesh)
    f64 = dict(dtype=torch.float64, device="cuda")
    step = make_advect_fn(mesh, ["biquadratic"] * 2, order=4, **f64)
    vd = (torch.as_tensor(u, **f64), torch.as_tensor(v, **f64))
    x = torch.as_tensor(cloud.x, **f64)
    e = torch.as_tensor(cloud.elem, device="cuda")
    dt = 2 * np.pi / chip_smoke.MARKERS_STEPS
    for _ in range(2):
        x, e = step(x, e, vd, dt)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            x, e = step(x, e, vd, dt)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=15))
    t0 = time.perf_counter()
    for _ in range(20):
        x, e = step(x, e, vd, dt)
    torch.cuda.synchronize()
    print(f"seconds per step: {(time.perf_counter() - t0) / 20:.4f} "
          f"({args.markers} markers)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
