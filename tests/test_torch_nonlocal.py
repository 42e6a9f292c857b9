"""Port parity of the nonlocal (peridynamic-type) diffusion operator.

The host part (pair search, sparsity pattern, the four slot tables) is
copied and must be EQUAL; the batched pair kernel's ELL values agree to
1e-12 of their size (1-D and 2-D) and ``solve_dirichlet`` to 1e-9.  The
operator is symmetric, positive semi-definite and annihilates constants;
from BELL_MIN_ROWS rows the Dirichlet solve multiplies on the BELL frame
(kernel B1's plain version on the host) and gives the ELL solve's answer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.assembly.nonlocal_diffusion as jnl
import femus_tpu.mesh.generation as jgen
import femus_tpu_torch.algebra.bell as tbell
import femus_tpu_torch.assembly.nonlocal_diffusion as tnl
import femus_tpu_torch.mesh.generation as tgen
from femus_tpu_torch.algebra.bell import BELL_MIN_ROWS

pi = np.pi

CASES = {
    "1d": (lambda g: g.box((20,), [(0.0, 1.0)], "edge"),
           dict(delta=0.15, quad_order=5),
           (lambda x: jnp.pi ** 2 * jnp.sin(jnp.pi * x[:, 0]),
            lambda x: pi ** 2 * torch.sin(pi * x[:, 0]))),
    "2d": (lambda g: g.unit_box((12, 12), "quad"),
           dict(delta=0.18, quad_order=3),
           (lambda x: 2 * jnp.pi ** 2 * jnp.sin(jnp.pi * x[:, 0])
            * jnp.sin(jnp.pi * x[:, 1]),
            lambda x: 2 * pi ** 2 * torch.sin(pi * x[:, 0])
            * torch.sin(pi * x[:, 1]))),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def ops(request):
    mesh_fn, kw, rhs = CASES[request.param]
    oj = jnl.NonlocalOperator(mesh_fn(jgen), "linear", **kw)
    ot = tnl.NonlocalOperator(mesh_fn(tgen), "linear", device="cpu",
                              dtype=torch.float64, **kw)
    return oj, ot, rhs


def _dense(op):
    data = op._data.numpy() if torch.is_tensor(op._data) else np.asarray(
        op._data)
    A = np.zeros((op.pattern.n_rows, op.pattern.n_rows))
    for r in range(op.pattern.n_rows):
        for k in range(op.pattern.width):
            if op.pattern.valid[r, k]:
                A[r, op.pattern.cols[r, k]] += data[r, k]
    return A


def test_host_tables_equal(ops):
    oj, ot, _ = ops
    assert len(ot.pairs) > ot.mesh.n_elems        # interactions beyond self
    np.testing.assert_array_equal(ot.pairs, oj.pairs)
    for f in ("cols", "valid", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(ot.pattern, f),
                                      getattr(oj.pattern, f))
    assert ot._slots.keys() == oj._slots.keys()
    for k in oj._slots:
        np.testing.assert_array_equal(ot._slots[k], oj._slots[k])


def test_pair_kernel_matches_jax(ops):
    oj, ot, _ = ops
    ref = np.asarray(oj._data)
    np.testing.assert_allclose(ot._data.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    assert ot.op().data is ot._data


def test_operator_symmetric_psd_and_kills_constants(ops):
    A = _dense(ops[1])
    scale = np.abs(A).max()
    assert np.abs(A - A.T).max() < 1e-10 * scale
    w = np.linalg.eigvalsh(A)
    assert w.min() > -1e-8 * w.max()
    assert np.abs(A @ np.ones(A.shape[0])).max() < 1e-8 * scale


def test_solve_dirichlet_matches_jax(ops):
    oj, ot, (fj, ft) = ops
    zero = lambda x: np.zeros(len(x))      # noqa: E731
    uj, ij = oj.solve_dirichlet(fj, zero)
    ut, it = ot.solve_dirichlet(ft, zero)
    assert it.converged and it.iters == int(ij.iters)
    np.testing.assert_allclose(ut, np.asarray(uj), rtol=1e-9,
                               atol=1e-9 * np.abs(uj).max())
    assert ot.routing["path"] == "ell"   # below BELL_MIN_ROWS rows
    if ot.mesh.dim == 2:
        # the collar forces zero near the boundary; in the core the
        # solution has the local one's shape (tests/test_nonlocal.py)
        x = ot.mesh.coords[ot.dofmap.nodes]
        exact = np.sin(pi * x[:, 0]) * np.sin(pi * x[:, 1])
        core = ((x[:, 0] > 0.3) & (x[:, 0] < 0.7) & (x[:, 1] > 0.3)
                & (x[:, 1] < 0.7))
        ratio = ut[core] / exact[core]
        assert ratio.std() / ratio.mean() < 0.15


def test_solve_on_the_bell_frame(monkeypatch):
    """2,116 rows: the Dirichlet solve routes its matvec onto the BELL
    frame and reaches the solution of the same CG on the ELL operator."""
    op = tnl.NonlocalOperator(tgen.unit_box((45, 45), "quad"), "linear",
                              delta=0.03, quad_order=2, device="cpu",
                              dtype=torch.float64)
    assert op.pattern.n_rows >= BELL_MIN_ROWS
    f = lambda x: torch.sin(pi * x[:, 0]) * torch.sin(pi * x[:, 1])  # noqa
    zero = lambda x: np.zeros(len(x))      # noqa: E731
    u, info = op.solve_dirichlet(f, zero, tol=1e-12)
    assert info.converged and op.routing["path"] == "bell"
    monkeypatch.setattr(tbell, "BELL_MIN_ROWS", op.pattern.n_rows + 1)
    u_ell, info_ell = op.solve_dirichlet(f, zero, tol=1e-12)
    assert op.routing["path"] == "ell" and info_ell.iters == info.iters
    assert np.abs(u).max() > 0
    np.testing.assert_allclose(u, u_ell, rtol=1e-9,
                               atol=1e-9 * np.abs(u_ell).max())
