"""Port parity: explicit MPM, the engine's particle forms and monolithic
MPM-FSI against femus_tpu, in float64 on the host.

``init_particles`` gives EQUAL states (quad and tri meshes); from the same
state (carried across by ``convert.mpm_state_from_numpy``) 10 explicit MPM
steps agree to 1e-10 and ``grid_fields`` to 1e-14; ``particle_tables``
gives equal masks and gathered payloads over the ``ne`` element rows and
the same overflow error; the particle-form residual and Jacobian at
unit_box((3,3)) agree to 1e-12; two ``MonolithicMPMFSI.step`` calls agree
to 1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femus_tpu.mesh.generation import unit_box as junit
from femus_tpu.particles import mpm as jmpm
from femus_tpu.systems.mpm_fsi import MonolithicMPMFSI as JFSI
from femus_tpu_torch.convert import MPM_FIELDS, mpm_state_from_numpy
from femus_tpu_torch.mesh.generation import unit_box as tunit
from femus_tpu_torch.particles import mpm as tmpm
from femus_tpu_torch.systems.mpm_fsi import MonolithicMPMFSI as TFSI


def _carry(js):
    return mpm_state_from_numpy({k: np.asarray(getattr(js, k))
                                 for k in MPM_FIELDS}, device="cpu")


def _block(x):
    return (x[:, 1] < 0.45) & (x[:, 0] > 0.2) & (x[:, 0] < 0.8)


@pytest.mark.parametrize("geom", ["quad", "tri"])
def test_init_particles_equal(geom):
    vel = lambda x: np.stack([x[:, 1], -x[:, 0]], 1)     # noqa: E731
    js = jmpm.init_particles(junit((4, 3), geom), _block, ppc=3,
                             density=2.0, vel_fn=vel)
    ts = tmpm.init_particles(tunit((4, 3), geom), _block, ppc=3,
                             density=2.0, vel_fn=vel, device="cpu",
                             dtype=torch.float64)
    for k in MPM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, k)),
                                      getattr(ts, k).numpy())


@pytest.mark.parametrize("flip", [0.9, 1.0])
def test_explicit_steps_match_jax(flip):
    jm, tm = junit((8, 8)), tunit((8, 8))
    js = jmpm.init_particles(jm, _block, ppc=2)
    js.v = jnp.asarray(np.random.default_rng(0).normal(0, 0.1, js.v.shape))
    ts = _carry(js)
    fixed = tm.coords[tm.dofmap("linear").nodes][:, 1] < 1e-9
    kw = dict(gravity=(0.0, -1.0), flip=flip, fixed_dofs=fixed)
    jstep = jmpm.make_mpm_step(jm, jmpm.neo_hookean_stress(50.0, 50.0), **kw)
    tstep = tmpm.make_mpm_step(tm, tmpm.neo_hookean_stress(50.0, 50.0),
                               device="cpu", dtype=torch.float64, **kw)
    for _ in range(10):
        js, ts = jstep(js, 2e-3), tstep(ts, 2e-3)
    for k in MPM_FIELDS:
        a, b = np.asarray(getattr(js, k)), getattr(ts, k).numpy()
        assert np.abs(a - b).max() <= 1e-10 * max(np.abs(a).max(), 1.0), k
    ja, jb = jmpm.grid_fields(jm, js)
    ta, tb = tmpm.grid_fields(tm, ts)
    assert np.abs(ja - ta).max() <= 1e-14 and np.abs(jb - tb).max() <= 1e-14
    assert ta.sum() == pytest.approx(float(ts.mass.sum()), rel=1e-12)


def _fsi_pair(stress=(5.0, 5.0), rho_s=2.0, ppe=8, n=3):
    def bc(var, x, grp, t):
        return (var != "P"), 0.0

    kw = dict(rho_s=rho_s, rho_f=1.0, mu_f=0.1, bc_fn=bc, dt=0.05, ppe=ppe)
    jf = JFSI(junit((n, n)), jmpm.neo_hookean_stress(*stress), **kw)
    tf = TFSI(tunit((n, n)), tmpm.neo_hookean_stress(*stress), device="cpu",
              dtype=torch.float64, **kw)
    return jf, tf


def _state_pair(jf, region, density):
    js = jmpm.init_particles(jf.mesh, region, ppc=2, density=density)
    js.v = jnp.asarray(np.random.default_rng(0).normal(0, 0.1, js.v.shape))
    return js, _carry(js)


def _payloads(jf, tf, js, ts):
    phi, gphi = jf._shape_at(js.x, js.elem)
    jp = {"phi": phi, "gphi": gphi, "F": js.F, "vol0": js.vol0,
          "mass": js.mass, "v_old": js.v}
    phi, gphi = tf._shape_at(ts.x, ts.elem)
    tp = {"phi": phi, "gphi": gphi, "F": ts.F, "vol0": ts.vol0,
          "mass": ts.mass, "v_old": ts.v}
    return jp, tp


def test_particle_tables_equal():
    jf, tf = _fsi_pair()
    js, ts = _state_pair(jf, lambda x: x[:, 1] > 0.3, 2.0)
    jp, tp = _payloads(jf, tf, js, ts)
    elems = np.asarray(js.elem).copy()
    elems[::5] = -1                                   # some inactive
    jt = jf.asm.particle_tables(elems, jp, jf.ppe)
    tt = tf.asm.particle_tables(torch.as_tensor(elems), tp, tf.ppe)
    ne = tf.mesh.n_elems
    np.testing.assert_array_equal(np.asarray(jt["mask"])[:ne],
                                  tt["mask"].numpy())
    for k in jp:
        # the same particles in the same slots: the gathered values differ
        # only by the shape functions' rounding (Newton inverse maps)
        a = np.asarray(jt["payload"][k])[:ne]
        assert np.abs(a - tt["payload"][k].numpy()).max() <= \
            1e-13 * np.abs(a).max(), k
    with pytest.raises(ValueError) as je:
        jf.asm.particle_tables(np.asarray(js.elem), jp, 2)
    with pytest.raises(ValueError) as te:
        tf.asm.particle_tables(ts.elem, tp, 2)
    assert str(je.value) == str(te.value)


def _dense(pattern, data):
    A = np.zeros((pattern.n_rows, pattern.n_cols))
    rows = np.repeat(np.arange(pattern.n_rows), pattern.width)
    np.add.at(A, (rows, np.asarray(pattern.cols).ravel()),
              np.asarray(data).ravel())
    return A


@pytest.mark.parametrize("with_jacobian", [True, False])
def test_particle_form_residual_and_jacobian_match_jax(with_jacobian):
    jf, tf = _fsi_pair()
    js, ts = _state_pair(jf, lambda x: (x[:, 0] > 0.3) & (x[:, 0] < 0.7)
                         & (x[:, 1] > 0.4), 2.0)
    jp, tp = _payloads(jf, tf, js, ts)
    jt = dict(jf._tables)
    jt["particles"] = jf.asm.particle_tables(np.asarray(js.elem), jp, jf.ppe)
    tt = dict(tf._tables)
    tt["particles"] = tf.asm.particle_tables(ts.elem, tp, tf.ppe)
    n = tf.asm.n_dofs
    rng = np.random.default_rng(1)
    u = rng.normal(0, 0.1, n)
    old = {vn + "_old": rng.normal(0, 0.1, tf.asm.dofmaps[vn].n_dofs)
           for vn in tf.vel_names}
    u[tf.asm.dirichlet_mask] = 0.0
    ju = jnp.zeros(jf.asm.n_dofs_pad).at[:n].set(u)
    dt = {"dt": torch.tensor(0.05, dtype=torch.float64)}
    R1, d1 = jf._assemble(ju, jt, {k: jnp.asarray(v) for k, v in old.items()},
                          {"dt": jnp.asarray(0.05)})
    tasm = tf.asm.make_assemble_fn(with_jacobian=with_jacobian,
                                   pass_tables=True)
    R2, d2 = tasm(torch.as_tensor(u), tt, dt,
                  {k: torch.as_tensor(v) for k, v in old.items()})
    R1 = np.asarray(R1)[:n]
    assert np.abs(R1 - R2.numpy()).max() <= 1e-12 * np.abs(R1).max()
    if with_jacobian:
        A1 = _dense(jf.asm.pattern, d1)[:n, :n]
        A2 = _dense(tf.asm.pattern, d2.numpy())
        assert np.abs(A1 - A2).max() <= 1e-12 * np.abs(A1).max()
    else:
        assert d2 is None
    # without the particle table the particle terms are absent
    R0, _ = tasm(torch.as_tensor(u), tf._tables, dt,
                 {k: torch.as_tensor(v) for k, v in old.items()})
    assert np.abs(R0.numpy() - R2.numpy()).max() > 1e-6


def test_mpm_fsi_steps_match_jax():
    jf, tf = _fsi_pair(stress=(50.0, 50.0), rho_s=4.0, ppe=20, n=6)
    region = lambda x: ((x[:, 0] > 0.35) & (x[:, 0] < 0.65)    # noqa: E731
                        & (x[:, 1] > 0.55) & (x[:, 1] < 0.85))
    js = jmpm.init_particles(jf.mesh, region, ppc=2, density=4.0)
    ts = _carry(js)
    ju = jnp.zeros(jf.asm.n_dofs_pad)
    tu = torch.zeros(tf.asm.n_dofs, dtype=torch.float64)
    n = tf.asm.n_dofs
    for _ in range(2):
        js, ju = jf.step(js, ju)
        ts, tu = tf.step(ts, tu)
        a = np.asarray(ju)[:n]
        assert np.abs(a - tu.numpy()).max() <= 1e-9 * np.abs(a).max()
        for k in ("x", "v", "F"):
            a, b = np.asarray(getattr(js, k)), getattr(ts, k).numpy()
            assert np.abs(a - b).max() <= 1e-9 * np.abs(a).max(), k
        np.testing.assert_array_equal(np.asarray(js.elem), ts.elem.numpy())
    h = tf.history
    assert len(h) == 2 and all(r["converged"] for r in h)
    assert all(r["res_norms"][-1] < tf.newton_tol for r in h)
