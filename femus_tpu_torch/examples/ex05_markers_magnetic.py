"""Lagrangian markers in a rotating flow with magnetic capture.

Reference: applications/ISM (marker advection ex1-ex5 + the
magnetic_force_test / magnetic_stents capture scenario).
"""
import numpy as np
import torch

from .. import resolve_device
from ..mesh.generation import unit_box
from ..particles.forces import magnetic_force, wire_H
from ..particles.markers import MarkerCloud, advect, locate
from ._common import DTYPE, cli

WIRE = (0.95, 0.5)          # the wire's trace in the plane, along z


def capture_force():
    """The wire's magnetic force on a marker, drag-limited: the capture
    velocity is clipped so markers park at the wire instead of overshooting
    through it in one step.  Batched: (N, 2) positions -> (N, 2)."""
    fm0 = magnetic_force(wire_H([*WIRE, 0.0], [0.0, 0.0, 1.0], I=1.857e5),
                         D=2e-4, mu_f=3.5e-3, dim=2)

    def fm(x):
        f = fm0(x)
        n = torch.linalg.norm(f, dim=1, keepdim=True) + 1e-30
        return f * torch.clamp(0.5 / n, max=1.0)

    return fm


def main(device="cuda"):
    device = resolve_device(device)
    mesh = unit_box((8, 8), "quad")
    dm = mesh.dofmap("biquadratic")
    xy = mesh.coords[dm.nodes]
    u = -0.2 * (xy[:, 1] - 0.5)              # slow rotation about center
    v = 0.2 * (xy[:, 0] - 0.5)
    rng = np.random.default_rng(0)
    pts = 0.5 + rng.uniform(-0.25, 0.25, size=(50, 2))
    cloud = MarkerCloud(mesh, pts.copy(), np.zeros(len(pts), np.int64))
    locate(cloud, device=device)
    d0 = np.linalg.norm(cloud.x - WIRE, axis=1).mean()
    advect(cloud, [u, v], ["biquadratic"] * 2, T=4.0, n_steps=200,
           order=4, force_fn=capture_force(), dtype=DTYPE, device=device)
    dist = np.linalg.norm(cloud.x - WIRE, axis=1)
    d1 = dist.mean()
    captured = (dist < 0.15).sum()
    alive = (cloud.elem >= 0).sum()
    print(f"mean distance to wire: {d0:.3f} -> {d1:.3f}; "
          f"{captured}/{cloud.n} markers within capture radius; "
          f"{alive} still in domain")
    return {"mean_dist_before": float(d0), "mean_dist_after": float(d1),
            "captured": int(captured), "markers": int(cloud.n),
            "in_domain": int(alive), "x": cloud.x.copy(),
            "elem": cloud.elem.copy()}


if __name__ == "__main__":
    cli(main)
