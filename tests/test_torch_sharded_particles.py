"""Port parity: sharded marker clouds with all_to_all migration
(``particles/sharded.py``) against femus_tpu's on ``device_mesh(4)``, in
float64 on the host.

The plan and the distributed layout EQUAL the JAX package's.  Four gloo
ranks advect a disk of markers through a Q2 rotation that carries them
across the ranks' element slabs: with room to migrate, the collected cloud
equals the JAX package's sharded cloud and the one-rank advection (to
1e-12, elements equal) and nothing is dropped; with two migration slots
per rank pair, the per-step drop counts equal the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femus_tpu.mesh import generation as jgen
from femus_tpu.particles import markers as jmarkers
from femus_tpu.particles import sharded as jsharded
from femus_tpu.parallel.spmd import device_mesh
from femus_tpu_torch.mesh import generation as tgen
from femus_tpu_torch.parallel import cases
from femus_tpu_torch.parallel.ranks import launch
from femus_tpu_torch.particles import markers as tmarkers
from femus_tpu_torch.particles import sharded as tsharded

S, N_CELLS, N_MARKERS = 4, 8, 240
RUNS = [dict(steps=12, dt=0.15, order=2, cap_migrate=0, slack=2.0),
        dict(steps=6, dt=0.4, order=2, cap_migrate=2, slack=2.0)]

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module: beside the other test workers
    and the spawned ranks, the many small torch ops of these cases spend
    their time in thread barriers otherwise (the 3-D patch solve took
    minutes under a parallel run, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _cloud():
    rng = np.random.default_rng(4)
    r = 0.35 * np.sqrt(rng.uniform(size=N_MARKERS))
    th = 2 * np.pi * rng.uniform(size=N_MARKERS)
    pts = 0.5 + np.stack([r * np.cos(th), r * np.sin(th)], axis=1)
    cloud = tmarkers.MarkerCloud(tgen.unit_box((N_CELLS, N_CELLS)), pts,
                                 np.zeros(N_MARKERS, np.int64))
    tmarkers.locate(cloud, device="cpu")
    return cloud


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cloud = _cloud()
    path = str(tmp_path_factory.mktemp("cloud"))
    np.savez(f"{path}/cloud.npz", x=cloud.x, elem=cloud.elem)
    ranks = launch(cases.markers_rank, S, (path, N_CELLS, RUNS),
                   device="cpu", timeout=240, quiet=True)
    return cloud, [[r[i] for r in ranks] for i in range(len(RUNS))]


def _jax_run(cloud, run):
    mesh = jgen.unit_box((N_CELLS, N_CELLS))
    plan = jsharded.make_plan(mesh, S, cloud.n, run["cap_migrate"],
                              run["slack"])
    jc = jmarkers.MarkerCloud(mesh, cloud.x.copy(), cloud.elem.copy())
    x, e = jsharded.distribute(jc, plan)
    step = jsharded.make_sharded_advect_fn(
        mesh, plan, device_mesh(S), ["biquadratic"] * 2, order=run["order"])
    vel = tuple(jnp.asarray(v) for v in cases.rotation_field(mesh))
    x, e = jnp.asarray(x), jnp.asarray(e)
    drops = []
    for _ in range(run["steps"]):
        x, e, d = step(x, e, vel, run["dt"])
        drops.append(int(d))
    return plan, np.asarray(x), np.asarray(e), drops


def test_plan_and_layout_equal():
    cloud = _cloud()
    tm = tgen.unit_box((N_CELLS, N_CELLS))
    jm = jgen.unit_box((N_CELLS, N_CELLS))
    for cap in (0, 3):
        tp = tsharded.make_plan(tm, S, cloud.n, cap)
        jp = jsharded.make_plan(jm, S, cloud.n, cap)
        assert (tp.n_shards, tp.capacity, tp.cap_migrate) == \
            (jp.n_shards, jp.capacity, jp.cap_migrate)
        np.testing.assert_array_equal(tp.elem_owner, jp.elem_owner)
        tx, te = tsharded.distribute(cloud, tp)
        jx, je = jsharded.distribute(
            jmarkers.MarkerCloud(jm, cloud.x, cloud.elem), jp)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(te, je)
    with pytest.raises(ValueError, match="over capacity"):
        tsharded.distribute(cloud, tsharded.make_plan(tm, S, 8, 0, 0.5))


@pytest.mark.parametrize("i", range(len(RUNS)))
def test_sharded_advection_matches_jax(setup, i):
    cloud, results = setup
    run = RUNS[i]
    plan, jx, je, jdrops = _jax_run(cloud, run)
    tx = np.concatenate([r["x"] for r in results[i]])
    te = np.concatenate([r["elem"] for r in results[i]])
    np.testing.assert_array_equal(te, je)
    live = te >= 0
    np.testing.assert_allclose(tx[live], jx[live], rtol=0, atol=1e-12)
    assert all(r["dropped"] == jdrops for r in results[i])
    assert len({tuple(r["migrated"]) for r in results[i]}) == 1
    assert sum(results[i][0]["migrated"]) > 0
    if run["cap_migrate"]:
        assert sum(jdrops) > 0           # overflow is counted, not silent
        assert int(live.sum()) == cloud.n - sum(jdrops)
    else:
        assert sum(jdrops) == 0 and int(live.sum()) == cloud.n


def test_sharded_advection_equals_one_rank(setup):
    """With nothing dropped, every marker lands where the unsharded
    advection puts it (compared in (element, x, y) order)."""
    cloud, results = setup
    run = RUNS[0]
    step = tmarkers.make_advect_fn(cloud.mesh, ["biquadratic"] * 2,
                                   order=run["order"], dtype=torch.float64,
                                   device="cpu")
    vel = tuple(torch.as_tensor(v) for v in cases.rotation_field(cloud.mesh))
    x = torch.as_tensor(cloud.x)
    e = torch.as_tensor(cloud.elem)
    for _ in range(run["steps"]):
        x, e = step(x, e, vel, run["dt"])
    tx, te = tsharded.collect(
        np.concatenate([r["x"] for r in results[0]]),
        np.concatenate([r["elem"] for r in results[0]]))
    x1, e1 = x.numpy(), e.numpy()
    o1 = np.lexsort((x1[:, 1], x1[:, 0], e1))
    o4 = np.lexsort((tx[:, 1], tx[:, 0], te))
    np.testing.assert_array_equal(te[o4], e1[o1])
    np.testing.assert_allclose(tx[o4], x1[o1], rtol=0, atol=1e-12)
