"""L2 projection of an analytic function onto every FE family.

Reference: applications/000_tutorial/ex01* (function approximation): solve
(u, phi) = (f, phi) per family and report the L2 error.
"""
import numpy as np
import torch

from .. import resolve_device
from ..algebra.krylov import cg
from ..assembly.engine import Assembler, Unknown
from ..assembly.norms import error_norms
from ..mesh.generation import unit_box
from ._common import DTYPE, cli, env_int

FAMILIES = ("linear", "serendipity", "biquadratic", "disc_constant",
            "disc_linear")


def f(x):
    return torch.sin(np.pi * x[:, 0]) * torch.cos(np.pi * x[:, 1])


def project(n, family, device="cuda"):
    mesh = unit_box((n, n), "quad")
    asm = Assembler(mesh, [Unknown("u", family)], quad_order="seventh",
                    dtype=DTYPE, device=device)

    def form(ops, u, aux):
        return {"u": ops.t(family, ops.value(family, u["u"]) - f(ops.x))}

    asm.set_volume_form(form)
    R, data = asm.make_assemble_fn()(
        torch.zeros(asm.n_dofs, dtype=DTYPE, device=asm.device))
    A = asm.op_with(data)
    d = A.diagonal()
    u, info = cg(A.matvec, -R, M=lambda r: r / d, tol=1e-12, maxiter=400)
    l2, _ = error_norms(mesh, family, u, f, device=device)
    return l2


def main(device="cuda"):
    device = resolve_device(device)
    n = env_int("EX_N", 8)
    out = {}
    for family in FAMILIES:
        e_c = project(n, family, device)
        e_f = project(2 * n, family, device)
        order = np.log2(e_c / e_f)
        print(f"{family:<14} L2 {e_f:.3e}  order {order:.2f}")
        out[family] = {"l2_coarse": e_c, "l2": e_f, "order": float(order)}
    return out


if __name__ == "__main__":
    cli(main)
