"""Port parity: polynomial chaos tables and sparse-grid density estimation
against femus_tpu, in float64 on the host.

Every ``uq/pce.py`` function agrees with femus_tpu to 1e-13 (quadrature
nodes and index sets equal), Hermite and Legendre, 1 to 3 dimensions;
``fit_pdf`` gives the same basis, bounds and coefficients to 1e-12 and
its Galerkin mass matrix equals the one femus_tpu's ``_overlap`` loops
build, at max_level 4 in 1-D and 2-D; the densities and the Monte-Carlo L2
errors agree.
"""
import numpy as np
import pytest
import torch

from femus_tpu.uq import pce as jpce
from femus_tpu.uq import sparse_grid as jsg
from femus_tpu_torch.uq import pce as tpce
from femus_tpu_torch.uq import sparse_grid as tsg

KINDS = ["hermite", "legendre"]


def _close(a, b, tol=1e-13):
    b = b.numpy() if torch.is_tensor(b) else b
    a = np.asarray(a)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1.0)


@pytest.mark.parametrize("kind", KINDS)
def test_quadrature_and_sets_equal(kind):
    for n in (1, 4, 9):
        for a, b in zip(jpce.quadrature_1d(kind, n),
                        tpce.quadrature_1d(kind, n)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jpce.tensor_product_set(3, 3),
                                  tpce.tensor_product_set(3, 3))
    np.testing.assert_array_equal(jpce.total_degree_set(3, 4),
                                  tpce.total_degree_set(3, 4))


@pytest.mark.parametrize("kind", KINDS)
def test_polynomials_match_jax(kind):
    x = np.linspace(-2.5, 2.5, 23)
    _close(jpce.polys_1d(kind, 8, x), tpce.polys_1d(kind, 8, x, "cpu"))
    iset = jpce.total_degree_set(3, 3)
    s = np.random.default_rng(0).normal(size=(17, 3))
    _close(jpce.multivariate_polys(kind, iset, s),
           tpce.multivariate_polys(kind, iset, s, "cpu"))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dims,deg,nq", [(1, 5, 8), (2, 3, 6)])
def test_galerkin_tables_match_jax(kind, dims, deg, nq):
    iset = jpce.total_degree_set(dims, deg)
    G = tpce.stochastic_mass_matrix(kind, iset, nq, "cpu")
    _close(jpce.stochastic_mass_matrix(kind, iset, nq), G)
    C = tpce.triple_product_tensor(kind, iset, nq, "cpu")
    _close(jpce.triple_product_tensor(kind, iset, nq), C)
    assert torch.allclose(C, C.transpose(0, 2), atol=1e-13)


@pytest.mark.parametrize("kind", KINDS)
def test_pce_project_matches_jax(kind):
    iset = jpce.total_degree_set(2, 3)

    def f(x):
        return 1.0 + 2 * x[:, 0] + 3 * x[:, 0] * x[:, 1] - x[:, 1] ** 2

    c = tpce.pce_project(kind, iset, f, 8, "cpu")
    _close(jpce.pce_project(kind, iset, f, 8), c)
    # a degree-2 polynomial is reproduced exactly
    pts = np.random.default_rng(1).normal(size=(20, 2))
    P = tpce.multivariate_polys(kind, iset, pts, "cpu")
    assert np.abs((c @ P).numpy() - f(pts)).max() <= 1e-10


@pytest.mark.parametrize("dim", [1, 2])
def test_fit_pdf_matches_jax(dim, monkeypatch):
    monkeypatch.setattr(tsg, "CHUNK", 1500)     # several sample chunks
    samples = np.random.default_rng(dim).normal(size=(4000, dim))
    a = jsg.fit_pdf(samples, max_level=4)
    b = tsg.fit_pdf(samples, max_level=4, device="cpu")
    assert a.levels == b.levels
    np.testing.assert_array_equal(a.bounds, b.bounds)
    _close(a.coeff, b.coeff, 1e-12)
    lv, nb = a.levels, len(a.levels)
    M = np.ones((nb, nb))
    for d in range(dim):
        M *= np.array([[jsg._overlap(lv[i][0][d], lv[i][1][d], lv[j][0][d],
                                     lv[j][1][d]) for j in range(nb)]
                       for i in range(nb)])
    _close(M, tsg.mass_matrix(lv, "cpu"), 1e-12)
    x = np.random.default_rng(5).uniform(-2, 2, size=(50, dim))
    _close(a.evaluate(x), b.evaluate(x), 1e-12)

    def true(x):
        return np.exp(-(x ** 2).sum(1) / 2) / (2 * np.pi) ** (dim / 2)

    assert tsg.avg_l2_error(b, true, 3000) == pytest.approx(
        jsg.avg_l2_error(a, true, 3000), rel=1e-10)


def test_fit_pdf_given_bounds_and_tensor_samples():
    samples = np.random.default_rng(7).uniform(-1, 1, size=(2000, 2))
    bounds = np.array([[-1.5, 1.5], [-1.0, 1.2]])
    a = jsg.fit_pdf(samples, max_level=3, bounds=bounds)
    b = tsg.fit_pdf(torch.as_tensor(samples), max_level=3, bounds=bounds,
                    device="cpu")
    _close(a.coeff, b.coeff, 1e-12)
