"""Port parity: the native (g++) set-up kernels and their numpy versions
against femus_tpu's, in one process on the host.

The port builds its own copy of ``femus_native.cpp`` into ``build/``; RCB,
the greedy graph partition (with its refinement sweeps), the edge cut and
``csr_from_coo`` give arrays EQUAL to the JAX package's native library, and
the port's numpy versions EQUAL the JAX package's numpy fallbacks (reached
there by hiding its library).
"""
import contextlib

import numpy as np
import pytest

import femus_tpu.native as jnative
from femus_tpu.mesh import generation as jgen
from femus_tpu.mesh.mesh import elem_neighbors as jneighbors
from femus_tpu_torch import native as tnative

MESHES = [("quad", (12, 9)), ("tri", (7, 6)), ("hex", (4, 3, 5))]


def _centroids(mesh):
    return mesh.coords[mesh.conn[:, :4]].mean(axis=1)


@contextlib.contextmanager
def jax_numpy_fallback():
    """The JAX package's module with its library hidden: its numpy
    fallbacks run."""
    saved = jnative._build_and_load
    jnative._build_and_load = lambda: None
    try:
        yield
    finally:
        jnative._build_and_load = saved


def test_native_library_builds_into_build_dir():
    assert tnative.available() and tnative.impl() == "native"
    assert "/build/femus_native-" in tnative.library_path()


@pytest.mark.parametrize("geom,ns", MESHES)
@pytest.mark.parametrize("nparts", [2, 3, 4, 7])
def test_rcb_equal(geom, ns, nparts):
    cent = _centroids(jgen.unit_box(ns, geom))
    np.testing.assert_array_equal(tnative.rcb_partition(cent, nparts),
                                  jnative.rcb_partition(cent, nparts))
    with jax_numpy_fallback():
        want = jnative.rcb_partition(cent, nparts)
    np.testing.assert_array_equal(tnative.rcb_partition_numpy(cent, nparts),
                                  want)


@pytest.mark.parametrize("geom,ns", MESHES)
@pytest.mark.parametrize("nparts", [2, 4, 5])
def test_graph_partition_and_edge_cut_equal(geom, ns, nparts):
    nb = jneighbors(jgen.unit_box(ns, geom))
    part = tnative.greedy_graph_partition(nb, nparts)
    np.testing.assert_array_equal(part,
                                  jnative.greedy_graph_partition(nb, nparts))
    assert tnative.edge_cut(nb, part) == jnative.edge_cut(nb, part)
    part_np = tnative.greedy_graph_partition_numpy(nb, nparts)
    with jax_numpy_fallback():
        want = jnative.greedy_graph_partition(nb, nparts)
        cut = jnative.edge_cut(nb, part_np)
    np.testing.assert_array_equal(part_np, want)
    assert tnative.edge_cut_numpy(nb, part_np) == cut
    assert tnative.edge_cut(nb, part_np) == tnative.edge_cut_numpy(nb,
                                                                   part_np)


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_from_coo_equal(seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 50, 600)
    cols = rng.integers(0, 70, 600)
    got = tnative.csr_from_coo(rows, cols, 50)
    for g, w in zip(got, jnative.csr_from_coo(rows, cols, 50)):
        np.testing.assert_array_equal(g, w)
    with jax_numpy_fallback():
        want = jnative.csr_from_coo(rows, cols, 50)
    for g, w in zip(tnative.csr_from_coo_numpy(rows, cols, 50), want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, tnative.csr_from_coo_numpy(rows, cols, 50)):
        np.testing.assert_array_equal(g, w)
