"""Port parity: the sharded patch-stencil matvec (``parallel/patch_spmd.py``)
against femus_tpu's on ``device_mesh(4)``, in float64 on the host.

The patch Poisson operator lives on a generated coarse mesh whose every
second element is rotated (flipped patch faces), refined patch-coherently
two levels.  Four gloo ranks each run their slab of patches as a patch
operator of its own (kernel B2's plain version on the CPU) and close the
skeleton with one all_reduce; the joined product is within 1e-12 of the
global matvec, of the ELL operator and of the JAX package's sharded
matvec.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femus_tpu.assembly import bc as jbc
from femus_tpu.assembly import engine as jeng
from femus_tpu.assembly import forms as jforms
from femus_tpu.mesh import generation as jgen
from femus_tpu.mesh import patches as jpatches
from femus_tpu.parallel import patch_spmd as jps
from femus_tpu.parallel.spmd import device_mesh
from femus_tpu_torch.assembly import bc as tbc
from femus_tpu_torch.assembly import engine as teng
from femus_tpu_torch.assembly import forms as tforms
from femus_tpu_torch.mesh import generation as tgen
from femus_tpu_torch.mesh import patches as tpatches
from femus_tpu_torch.parallel import cases
from femus_tpu_torch.parallel import patch_spmd as tps
from femus_tpu_torch.parallel.ranks import launch

S = 4
NS, LEVELS = (4, 3), 2

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



def _rotated_box(gen):
    mesh = gen.unit_box(NS)
    rot = np.arange(mesh.n_elems) % 2 == 1
    conn = mesh.conn.copy()
    conn[rot] = mesh.conn[rot][:, [1, 2, 3, 0, 5, 6, 7, 4, 8]]
    boundary = {k: dataclasses.replace(
        b, iface=np.where(rot[b.elem], (b.iface - 1) % 4, b.iface
                          ).astype(b.iface.dtype))
        for k, b in mesh.boundary.items()}
    return dataclasses.replace(mesh, conn=conn, boundary=boundary)


def _assembled(pkg):
    gen, patches, eng, forms, bcm = (
        (jgen, jpatches, jeng, jforms, jbc) if pkg == "jax" else
        (tgen, tpatches, teng, tforms, tbc))
    mesh, plan = patches.refine_patched(_rotated_box(gen), LEVELS)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    out = []
    for patch in ((True,) if pkg == "jax" else (True, False)):
        a = eng.Assembler(mesh, [eng.Unknown("u")], quad_order="fifth", **kw)
        a.set_volume_form(forms.poisson("u", "biquadratic"))
        bcm.generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
        if patch:
            a.set_patch_layout(plan)
        u = np.zeros(a.n_dofs)
        R, d = a.make_assemble_fn()(jnp.asarray(u) if pkg == "jax"
                                    else torch.as_tensor(u))
        out.append(a.op_with(d))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    top, tell = _assembled("torch")
    x = np.random.default_rng(5).standard_normal(top.n_rows)
    path = str(tmp_path_factory.mktemp("patch_parts"))
    bounds = tps.slab_bounds(top.meta[1], S)
    cases.save_parts(path, [tps.patch_slab(top, lo, hi)
                            for lo, hi in bounds], x=x)
    ranks = launch(cases.patch_rank, S, (path,), device="cpu", timeout=240,
                   quiet=True)
    return top, tell, x, ranks, bounds


def _joined(top, ranks):
    E, P = top.meta[3], top.meta[1]
    y_int = np.concatenate([r["y_int"] for r in ranks], axis=2)
    assert y_int.shape == (E, E, P)
    return np.concatenate([y_int.reshape(-1), ranks[0]["y_e"].reshape(-1),
                           ranks[0]["y_v"]])


def test_slabs_cover_the_patches(setup):
    top, _, _, ranks, bounds = setup
    assert bounds[0][0] == 0 and bounds[-1][1] == top.meta[1]
    assert all(b[1] > b[0] for b in bounds)
    assert [(r["lo"], r["hi"]) for r in ranks] == bounds
    for r in ranks[1:]:                  # every rank holds the closed sums
        np.testing.assert_array_equal(r["y_e"], ranks[0]["y_e"])
        np.testing.assert_array_equal(r["y_v"], ranks[0]["y_v"])


def test_sharded_patch_matvec_matches_global_and_ell(setup):
    top, tell, x, ranks, _ = setup
    y = _joined(top, ranks)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(y, (top @ xt).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(y, (tell @ xt).numpy(), rtol=0, atol=1e-12)


def test_sharded_patch_matvec_matches_jax(setup):
    top, _, x, ranks, _ = setup
    (jop,) = _assembled("jax")
    dm = device_mesh(S)
    parts = jps.shard_patch_op(jop, dm)
    mv = jax.jit(jps.make_sharded_patch_matvec(jop.meta, dm))
    yi, ye, yv = mv(parts["wt"], parts["G_face"], parts["G_edge"],
                    parts["M_cs"], parts["M_vs"],
                    *jps.split_vector(jop.meta, jnp.asarray(x)))
    want = np.asarray(jps.join_vector(jop.meta, yi, ye, yv))
    np.testing.assert_allclose(_joined(top, ranks), want, rtol=0, atol=1e-12)


def test_split_join_round_trip():
    top, _ = _assembled("torch")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(top.n_rows))
    xi, xe, xv = tps.split_vector(top.meta, x)
    assert xi.shape == (top.meta[3], top.meta[3], top.meta[2])
    np.testing.assert_array_equal(tps.join_vector(top.meta, xi, xe, xv), x)
    # one rank: the slab is the whole operator
    one = tps.shard_patch_op(top, cases.RankGroup(1, 0, torch.device("cpu"),
                                                  "none"))
    np.testing.assert_array_equal(one.wt[..., :top.meta[1]],
                                  top.wt[..., :top.meta[1]])


def test_patch_csr_matches_the_slab_matvec(setup):
    """The library yardstick of B2 on a slab: one CSR of the slab's own
    operator gives the slab's product (interior rows and skeleton partial
    sums) within 1e-12, and the whole level's CSR the ELL operator's."""
    top, tell, x, _, bounds = setup
    meta = top.meta
    xi, xe, xv = tps.split_vector(meta, torch.as_tensor(x))
    for lo, hi in bounds:
        op = tps.slab_operator(tps.patch_slab(top, lo, hi), "cpu")
        xl = torch.cat([xi[:, :, lo:hi].reshape(-1), xe.reshape(-1), xv])
        csr = cases.patch_csr(op)
        assert csr.layout == torch.sparse_csr and csr.shape == (
            op.n_rows, op.n_rows)
        np.testing.assert_allclose((csr @ xl).numpy(), op.matvec(xl).numpy(),
                                   rtol=0, atol=1e-12)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose((cases.patch_csr(top) @ xt).numpy(),
                               (tell @ xt).numpy(), rtol=0, atol=1e-12)
