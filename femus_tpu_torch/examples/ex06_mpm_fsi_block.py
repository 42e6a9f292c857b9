"""Monolithic implicit MPM-FSI: an elastic block sinking through viscous
fluid (reference applications/MPM_FSI scenario class)."""
import torch

from .. import resolve_device
from ..mesh.generation import unit_box
from ..particles.mpm import init_particles, neo_hookean_stress
from ..systems.mpm_fsi import MonolithicMPMFSI
from ._common import DTYPE, cli, env_int


def bc(var, x, grp, t):
    return (var != "P"), 0.0            # no-slip walls, natural pressure


def build(n, device="cuda", newton_iters=6):
    """The sinking block on unit_box((n, n)): Q2 velocity, P1 pressure,
    rho_s 4, rho_f 1, mu_f 0.5, neo-Hookean(50, 50), dt 0.01, ppe 24, the
    block (0.35, 0.65) x (0.55, 0.85) at ppc 2, float64.  Returns (fsi,
    material points, zero grid state)."""
    mesh = unit_box((n, n), "quad")
    fsi = MonolithicMPMFSI(mesh, neo_hookean_stress(50.0, 50.0),
                           rho_s=4.0, rho_f=1.0, mu_f=0.5,
                           bc_fn=bc, dt=0.01, ppe=24,
                           newton_iters=newton_iters, device=device,
                           dtype=DTYPE)

    def region(x):
        return ((x[:, 0] > 0.35) & (x[:, 0] < 0.65)
                & (x[:, 1] > 0.55) & (x[:, 1] < 0.85))

    s = init_particles(mesh, region, ppc=2, density=4.0, device=device,
                       dtype=DTYPE)
    u = torch.zeros(fsi.asm.n_dofs, dtype=DTYPE, device=fsi.asm.device)
    return fsi, s, u


def main(device="cuda"):
    device = resolve_device(device)
    fsi, s, u = build(env_int("EX_N", 6), device)
    print(f"{s.x.shape[0]} material points; stepping...")
    coms = []
    for k in range(10):
        s, u = fsi.step(s, u)
        com = float(torch.mean(s.x[:, 1]))
        coms.append(com)
        if k % 2 == 1:
            print(f"  step {k+1}: solid center of mass y = {com:.4f}, "
                  f"max grid |v| = {float(torch.abs(u).max()):.3f}")
    J = torch.linalg.det(s.F).cpu().numpy()
    print(f"deformation: det(F) in [{J.min():.3f}, {J.max():.3f}]")
    return {"points": int(s.x.shape[0]), "com_y": coms,
            "max_v": float(torch.abs(u).max()),
            "det_min": float(J.min()), "det_max": float(J.max())}


if __name__ == "__main__":
    cli(main)
