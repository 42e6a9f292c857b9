"""Port parity: ``apps/fsi_bench.py``'s form and Newton step against
femus_tpu, in float64 on the host, on the written channel with a beam of
tests/test_torch_apps.py: ``fsi_form`` (with smark and the solid group)
gives the residual and the Jacobian data to 1e-10 at a random state; one
Newton step of ``make_fsi_system(levels=2, mg_cycle="K")`` takes the same
GMRES iterations and lands within 1e-8.

``python tests/test_torch_apps_fsi.py 44 8 3`` (from the repository root
on the path, e.g. ``PYTHONPATH=.``) runs ``depth_witness``: the JAX
package's FSI drive at the card's fsi-channel configuration of 3 levels,
step by step, for comparison with the port's readings on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.apps.fsi_bench as jfsi
import femus_tpu_torch.apps.fsi_bench as tfsi
from test_torch_apps import _close, _one_step, jax_meshes, meshes  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module (small torch ops spend their
    time in thread barriers beside the other test workers otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fsi_form_matches_jax(jax_meshes):
    jm = jfsi.load_mesh(1)
    tm = tfsi.load_mesh(1, jax_meshes["fsi"])
    ja = jfsi.make_assembler(jm)
    ta = tfsi.make_assembler(tm, device="cpu")
    np.testing.assert_array_equal(ja.pattern.cols, ta.pattern.cols)
    rng = np.random.default_rng(4)
    u = np.zeros(ta.n_dofs)
    for name in ("DX", "DY", "U", "V", "P"):
        off, k = ta.offsets[name], ta.dofmaps[name].n_dofs
        scale = 0.002 if name in ("DX", "DY") else 1.0
        u[off:off + k] = scale * rng.standard_normal(k)
    smark = tfsi.smark_dof_field(ta, tm)
    R1, D1 = ja.make_assemble_fn()(jnp.asarray(u),
                                   {"smark": jnp.asarray(smark)}, {})
    R2, D2 = ta.make_assemble_fn()(torch.as_tensor(u), {},
                                   {"smark": torch.as_tensor(smark)})
    n = ta.n_dofs
    _close(R2.numpy(), np.asarray(R1)[:n], 1e-10)
    _close(D2.numpy(), np.asarray(D1)[:n], 1e-10)


def test_fsi_step_matches_jax(jax_meshes):
    _, js = jfsi.make_fsi_system(levels=2, mg_cycle="K")
    _, ts = tfsi.make_fsi_system(levels=2, mg_cycle="K",
                                 mesh_path=jax_meshes["fsi"], device="cpu")
    _one_step(js, ts)


def depth_witness(nx=44, ny=8, levels=3, max_lin_iters=20):
    """The JAX package's ``make_fsi_system`` at fsi-channel's card
    configuration (the beam channel at ``nx`` x ``ny`` coarse cells,
    ``levels`` levels, K-cycle, ``max_lin_iters`` GMRES iterations a Newton
    step): the F-cycle ratchet of ``System.solve`` step by step, printing
    each step's GMRES iterations and linear residual and ||R(u)|| of the
    level after it, then the finest level's fall from the initial guess
    (the number chip_smoke.py's fsi_channel gates at 10^3)."""
    import tempfile
    import time

    import chip_smoke

    with tempfile.TemporaryDirectory() as d:
        jfsi.MESH = chip_smoke.channel_neu(f"{d}/beam.neu", nx, ny,
                                           solid=True)
        _, js = jfsi.make_fsi_system(levels=levels, mg_cycle="K",
                                     max_lin_iters=max_lin_iters)
    cfg, top = js.config, len(js.assemblers) - 1

    def res_norm(l):
        R, _ = js.assemblers[l].make_assemble_fn(with_jacobian=False)(
            jnp.asarray(js.gather(l)), js._aux_arrays(l),
            js._aux_scalars_traced())
        return float(jnp.linalg.norm(R))

    res0 = res_norm(top)
    print(f"n_dofs {[a.n_dofs for a in js.assemblers]}; finest ||R(u0)|| "
          f"{res0:.6e}")
    for l in range(top + 1):
        step = js.step_fn(l)
        for it in range(cfg.max_nonlinear):
            t0 = time.perf_counter()
            u, delta, res, iters = step(
                jnp.asarray(js.gather(l)),
                js.assemblers[l].device_tables_cached(), js._aux_arrays(l),
                js._aux_scalars_traced())
            js.scatter(np.asarray(u), l)
            worst = max(js.eps_norms(np.asarray(delta), np.asarray(u),
                                     l).values())
            print(f"level {l} step {it}: gmres {int(iters)} lin_res "
                  f"{float(res):.3e} ||R|| {res_norm(l):.6e} max_eps "
                  f"{worst:.3e} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            if worst < cfg.nonlinear_tol:
                break
        if l < top:
            js.ml_sol.refine_from(l)
            js._apply_bc_values(l + 1)
    print(f"finest ||R|| falls {res0 / res_norm(top):.4g}x")


if __name__ == "__main__":
    # python tests/test_torch_apps_fsi.py [nx ny levels]: depth_witness
    import sys

    import jax

    jax.config.update("jax_enable_x64", True)
    depth_witness(*map(int, sys.argv[1:4]))
