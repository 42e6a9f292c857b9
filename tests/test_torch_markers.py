"""Port parity: markers, magnetic forces and mesh-to-mesh projection against
femus_tpu, in float64 on the host.

``elem_neighbors`` and ``locate`` give EQUAL arrays (quad, tri, hex and tet
meshes, with markers on a shared face and a shared vertex, where the walk's
first-maximum tie rule decides, and a marker outside); RK2 and RK4
advection through a Q2 rotation, with and without a magnetic force, stays
within 1e-12 of femus_tpu over 20 steps (a marker the force draws out of
the domain parks at the same place to 1e-9); the elliptic integrals, the wire
and loop fields and the force law agree to 1e-12; projection matrices agree
to 1e-12 entry by entry with the same empty rows (2-D, 3-D, across
families, with outside="zero" and "nearest").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femus_tpu.mesh import generation as jgen
from femus_tpu.mesh import projection as jproj
from femus_tpu.mesh.mesh import elem_neighbors as jneighbors
from femus_tpu.particles import forces as jforces
from femus_tpu.particles import markers as jmarkers
from femus_tpu_torch.convert import marker_cloud_from_numpy
from femus_tpu_torch.mesh import generation as tgen
from femus_tpu_torch.mesh import projection as tproj
from femus_tpu_torch.mesh.mesh import elem_neighbors as tneighbors
from femus_tpu_torch.particles import forces as tforces
from femus_tpu_torch.particles import markers as tmarkers

# (wedge meshes are left out: their faces of two arities make both
# packages' elem_neighbors fail, ROADMAP C)
GEOMS = [("quad", (3, 3)), ("tri", (3, 2)), ("hex", (2, 3, 2)),
         ("tet", (2, 2, 2))]


@pytest.mark.parametrize("geom,ns", GEOMS)
def test_elem_neighbors_equal(geom, ns):
    a = jneighbors(jgen.unit_box(ns, geom))
    b = tneighbors(tgen.unit_box(ns, geom))
    np.testing.assert_array_equal(a, b)
    assert b.dtype == np.int32 and (b >= 0).any() and (b < 0).any()


@pytest.mark.parametrize("geom,ns", GEOMS)
def test_locate_equal(geom, ns):
    dim = len(ns)
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.02, 0.98, size=(60, dim))
    # on a shared face, on a shared vertex, and outside the domain
    face = np.full(dim, 0.5 / ns[1] + 0.01)
    face[0] = 1.0 / ns[0]
    vertex = np.array([1.0 / n for n in ns])
    pts = np.vstack([pts, face, vertex, np.full(dim, 2.0)])
    jc = jmarkers.MarkerCloud(jgen.unit_box(ns, geom), pts.copy(),
                              np.zeros(len(pts), np.int64))
    jmarkers.locate(jc)
    tc = tmarkers.MarkerCloud(tgen.unit_box(ns, geom), pts.copy(),
                              np.zeros(len(pts), np.int64))
    tmarkers.locate(tc, device="cpu")
    np.testing.assert_array_equal(jc.elem, tc.elem)
    assert tc.elem[-1] == -1 and (tc.elem[:-1] >= 0).all()


def _rotation(mesh):
    xy = mesh.coords[mesh.dofmap("biquadratic").nodes]
    return -(xy[:, 1] - 0.5), xy[:, 0] - 0.5


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("force", [False, True])
def test_advection_matches_jax(order, force):
    jm, tm = jgen.unit_box((6, 6)), tgen.unit_box((6, 6))
    u, v = _rotation(jm)
    rng = np.random.default_rng(1)
    pts = np.vstack([0.5 + rng.uniform(-0.3, 0.3, size=(30, 2)),
                     [[0.9, 0.5]]])          # leaves the domain with a force
    jf = tf = None
    if force:
        wire = ([0.95, 0.5, 0.0], [0.0, 0.0, 1.0], 1.857e5)
        jf = jforces.magnetic_force(jforces.wire_H(*wire), D=1e-4, dim=2)
        tf = tforces.magnetic_force(tforces.wire_H(*wire), D=1e-4, dim=2)
    jc = jmarkers.MarkerCloud(jm, pts.copy(), np.zeros(len(pts), np.int64))
    jmarkers.locate(jc)
    tc = marker_cloud_from_numpy(tm, jc.x, jc.elem)
    jmarkers.advect(jc, [u, v], ["biquadratic"] * 2, 1.0, 20, order=order,
                    force_fn=jf)
    tmarkers.advect(tc, [u, v], ["biquadratic"] * 2, 1.0, 20, order=order,
                    force_fn=tf, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(jc.elem, tc.elem)
    alive = tc.elem >= 0
    assert np.abs(jc.x - tc.x)[alive].max() <= 1e-12
    if force:
        # the marker drawn into the wire left the domain in one step of a
        # 1/d^3 force, which amplifies rounding: parked at the same place
        # to 1e-9
        assert not alive.all()
        assert np.abs(jc.x - tc.x)[~alive].max() <= 1e-9


def test_advect_step_fn_matches_jax():
    """make_advect_fn's step on tensors equals the JAX step (linear
    velocity family, a field that is not a rigid rotation)."""
    jm, tm = jgen.unit_box((4, 5)), tgen.unit_box((4, 5))
    xy = jm.coords[jm.dofmap("linear").nodes]
    vel = [0.3 * xy[:, 1] ** 2 - 0.1, 0.2 * xy[:, 0] - 0.05]
    rng = np.random.default_rng(2)
    x = rng.uniform(0.1, 0.9, size=(25, 2))
    jc = jmarkers.MarkerCloud(jm, x.copy(), np.zeros(25, np.int64))
    jmarkers.locate(jc)
    js = jmarkers.make_advect_fn(jm, ["linear"] * 2, order=4)
    ts = tmarkers.make_advect_fn(tm, ["linear"] * 2, order=4,
                                 dtype=torch.float64, device="cpu")
    jx, je = jnp.asarray(jc.x), jnp.asarray(jc.elem)
    tx, te = torch.tensor(jc.x), torch.tensor(jc.elem)
    tv = tuple(torch.as_tensor(a) for a in vel)
    for _ in range(5):
        jx, je = js(jx, je, tuple(jnp.asarray(a) for a in vel), 0.1)
        tx, te = ts(tx, te, tv, 0.1)
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    assert np.abs(np.asarray(jx) - tx.numpy()).max() <= 1e-12


def test_elliptic_integrals_match_jax():
    m = np.linspace(0.0, 0.97, 50)
    K, E = jforces.ellipk_ellipe(jnp.asarray(m))
    k, e = tforces.ellipk_ellipe(torch.as_tensor(m))
    np.testing.assert_allclose(k.numpy(), np.asarray(K), rtol=1e-12)
    np.testing.assert_allclose(e.numpy(), np.asarray(E), rtol=1e-12)


@pytest.mark.parametrize("field", ["wire", "loop"])
@pytest.mark.parametrize("dim", [2, 3])
def test_magnetic_force_matches_jax(field, dim):
    def make(mod):
        if field == "wire":
            return mod.wire_H([0.9, 0.5, 0.0], [0.0, 0.2, 1.0], 1.857e5)
        return mod.loop_H([0.5, 0.5, 0.1], [0.0, 0.3, 1.0], 0.04, 1.857e5)

    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 1.0, size=(40, dim))
    x[0, :2] = (0.5, 0.5)                      # on the loop's axis
    jH, tH = make(jforces), make(tforces)
    x3 = np.hstack([x, np.zeros((40, 3 - dim))])
    hj = np.asarray(jax.vmap(jH)(jnp.asarray(x3)))
    ht = torch.func.vmap(tH)(torch.as_tensor(x3)).numpy()
    np.testing.assert_allclose(ht, hj, rtol=1e-12)
    for kw in ({}, {"D": 1e-4, "attractive": False}):
        fj = np.asarray(jax.vmap(jforces.magnetic_force(jH, dim=dim, **kw))(
            jnp.asarray(x)))
        ft = tforces.magnetic_force(tH, dim=dim, **kw)(torch.as_tensor(x))
        assert np.abs(ft.numpy() - fj).max() <= 1e-12 * np.abs(fj).max()


def _proj_cases():
    return {
        "quad": (lambda g: g.unit_box((7, 5)), lambda g: g.unit_box((4, 9)),
                 "biquadratic", "biquadratic", "zero"),
        "cross_family": (lambda g: g.unit_box((6, 6)),
                         lambda g: g.unit_box((5, 5)), "biquadratic",
                         "linear", "zero"),
        "outside_zero": (lambda g: g.unit_box((4, 4)),
                         lambda g: g.box((4, 4), [(0.5, 1.5), (0.0, 1.0)]),
                         "biquadratic", "biquadratic", "zero"),
        "outside_nearest": (lambda g: g.unit_box((4, 4)),
                            lambda g: g.box((4, 4), [(0.5, 1.5), (0.0, 1.0)]),
                            "biquadratic", "biquadratic", "nearest"),
        "tri_to_quad": (lambda g: g.unit_box((4, 4), "tri"),
                        lambda g: g.unit_box((3, 5)), "biquadratic",
                        "linear", "zero"),
        "hex": (lambda g: g.unit_box((3, 3, 3), "hex"),
                lambda g: g.unit_box((2, 4, 2), "hex"), "biquadratic",
                "biquadratic", "zero")}


@pytest.mark.parametrize("case", list(_proj_cases()))
def test_projection_matrix_matches_jax(case):
    src, dst, sf, df, outside = _proj_cases()[case]
    A = jproj.projection_matrix(src(jgen), sf, dst(jgen), df, outside=outside)
    B = tproj.projection_matrix(src(tgen), sf, dst(tgen), df, outside=outside,
                                device="cpu")
    assert A.shape == B.shape
    # entries agree to rounding; an entry that is exactly 0 in one package
    # may be ~1e-17 in the other (eliminate_zeros keeps it), so the
    # patterns are compared on entries above 1e-12
    assert abs(A - B).max() <= 1e-12
    for M in (A, B):
        M.data[np.abs(M.data) < 1e-12] = 0
        M.eliminate_zeros()
    np.testing.assert_array_equal(A.indptr, B.indptr)
    np.testing.assert_array_equal(A.indices, B.indices)
    if case.startswith("outside"):
        empty = np.diff(B.indptr) == 0
        assert empty.any() == (outside == "zero")


def test_project_is_exact_on_the_source_space():
    src, dst = tgen.unit_box((5, 4)), tgen.box((3, 3), [(0.1, 0.9),
                                                        (0.2, 0.7)])
    f = lambda x: 1 + x[:, 0] - 2 * x[:, 1] + x[:, 0] ** 2 * x[:, 1] ** 2  # noqa: E731
    got = tproj.project(src, "biquadratic", f(src.node_coords_of(
        "biquadratic")), dst, device="cpu")
    want = f(dst.node_coords_of("biquadratic"))
    assert np.abs(got - want).max() <= 1e-12
