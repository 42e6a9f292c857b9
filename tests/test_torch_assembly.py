"""Port parity: meshes, dof maps, orderings and assembly against femus_tpu.

Host set-up code is copied, so its arrays must be EQUAL.  Assembly runs
the same quadrature in float64 in both packages; only the order of the
floating-point sums differs, so residuals and ELL data agree to rtol 1e-12
with an absolute floor of 1e-12 * max|data|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.assembly.bc as jbc
import femus_tpu.assembly.engine as jeng
import femus_tpu.assembly.forms as jforms
import femus_tpu.mesh.generation as jgen
import femus_tpu.mesh.multilevel as jml
import femus_tpu.mesh.reorder as jreo
import femus_tpu_torch.assembly.bc as tbc
import femus_tpu_torch.assembly.engine as teng
import femus_tpu_torch.assembly.forms as tforms
import femus_tpu_torch.mesh.generation as tgen
import femus_tpu_torch.mesh.multilevel as tml
import femus_tpu_torch.mesh.reorder as treo

MESHES = [(7, 5), (8, 8)]
FAMILIES = ["biquadratic", "linear", "disc_linear"]


def _assert_mesh_equal(jm, tm):
    for f in ("coords", "conn", "elem_group"):
        np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f))
    for f in ("parent_elem", "child_slot"):
        a, b = getattr(jm, f), getattr(tm, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert jm.boundary.keys() == tm.boundary.keys()
    for k in jm.boundary:
        for f in ("elem", "iface", "group", "conn"):
            np.testing.assert_array_equal(getattr(jm.boundary[k], f),
                                          getattr(tm.boundary[k], f))
    for fam in FAMILIES:
        jd, td = jm.dofmap(fam), tm.dofmap(fam)
        assert jd.n_dofs == td.n_dofs
        for f in ("conn", "nodes", "node_to_dof"):
            np.testing.assert_array_equal(getattr(jd, f), getattr(td, f))


@pytest.mark.parametrize("ns", MESHES)
def test_mesh_hierarchy_copies_equal(ns):
    jmm = jml.MultiLevelMesh(jgen.unit_box(ns), 2)
    tmm = tml.MultiLevelMesh(tgen.unit_box(ns), 2)
    for jm, tm in zip(jmm.levels, tmm.levels):
        _assert_mesh_equal(jm, tm)


@pytest.mark.parametrize("ns", MESHES)
def test_rcm_orderings_equal(ns):
    jm, tm = jgen.unit_box(ns), tgen.unit_box(ns)
    np.testing.assert_array_equal(jreo.node_rcm_permutation(jm),
                                  treo.node_rcm_permutation(tm))
    jmm = jml.MultiLevelMesh(jm, 2)
    tmm = tml.MultiLevelMesh(tm, 2)
    jreo.rcm_reorder_hierarchy(jmm)
    treo.rcm_reorder_hierarchy(tmm)
    for a, b in zip(jmm.levels, tmm.levels):
        _assert_mesh_equal(a, b)


def _cavity_bc(var, x, grp, t):
    if var == "p":
        return (False, 0.0)
    if var == "u" and abs(x[1] - 1.0) < 1e-9:
        return (True, 1.0)
    return (True, 0.0)


def _poisson(mod_eng, mod_forms, mod_bc, mesh, **kw):
    a = mod_eng.Assembler(mesh, [mod_eng.Unknown("u", "biquadratic")], **kw)
    a.set_volume_form(mod_forms.poisson("u", "biquadratic"))
    mod_bc.generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
    return a


def _ns(mod_eng, mod_forms, mod_bc, mesh, **kw):
    U = mod_eng.Unknown
    a = mod_eng.Assembler(mesh, [U("u"), U("v"), U("p", "disc_linear")],
                          interleave=True, **kw)
    a.set_volume_form(mod_forms.navier_stokes(("u", "v"), "p",
                                              pres_family="disc_linear",
                                              nu=0.01))
    mod_bc.generate_bdc(a, _cavity_bc)
    return a


@pytest.mark.parametrize("ns", MESHES)
@pytest.mark.parametrize("problem", ["poisson", "ns"])
def test_assembly_matches_jax(ns, problem):
    build = _poisson if problem == "poisson" else _ns
    ja = build(jeng, jforms, jbc, jgen.unit_box(ns))
    ta = build(teng, tforms, tbc, tgen.unit_box(ns), device="cpu")
    # host layout: patterns, slots, stacked permutation, Dirichlet rows
    np.testing.assert_array_equal(ja.pattern.cols, ta.pattern.cols)
    np.testing.assert_array_equal(ja.pattern.valid, ta.pattern.valid)
    np.testing.assert_array_equal(ja.slots, ta.slots)
    np.testing.assert_array_equal(ja.edofs, ta.edofs)
    np.testing.assert_array_equal(ja.dirichlet_mask, ta.dirichlet_mask)
    if problem == "ns":
        np.testing.assert_array_equal(ja.stack_perm, ta.stack_perm)
    u = np.random.default_rng(7).standard_normal(ja.n_dofs)
    u = jbc.apply_dirichlet_values(ja, u)
    np.testing.assert_array_equal(u, tbc.apply_dirichlet_values(ta, u))
    R1, D1 = ja.make_assemble_fn()(jnp.asarray(u))
    R2, D2 = ta.make_assemble_fn()(torch.as_tensor(u))
    R1, D1 = np.asarray(R1), np.asarray(D1)
    np.testing.assert_allclose(R2.numpy(), R1, rtol=1e-12,
                               atol=1e-12 * np.abs(R1).max())
    np.testing.assert_allclose(D2.numpy(), D1, rtol=1e-12,
                               atol=1e-12 * np.abs(D1).max())


def test_assembly_pass_tables_form_and_dtype():
    """pass_tables=True takes the tables per call; float32 assembly tracks
    the float64 one to float32 accuracy (full-precision matmuls, centred
    coordinates)."""
    mesh = tgen.unit_box((8, 8))
    a64 = _ns(teng, tforms, tbc, mesh, device="cpu")
    a32 = _ns(teng, tforms, tbc, mesh, device="cpu", dtype=torch.float32)
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(a64.n_dofs))
    R, D = a64.make_assemble_fn(pass_tables=True)(
        u, a64.device_tables_cached())
    R32, D32 = a32.make_assemble_fn()(u)
    assert D32.dtype == torch.float32 and D32.shape == D.shape
    np.testing.assert_allclose(D32.double().numpy(), D.numpy(), rtol=1e-4,
                               atol=1e-5 * float(D.abs().max()))
    np.testing.assert_allclose(R32.double().numpy(), R.numpy(), rtol=1e-4,
                               atol=1e-5 * float(R.abs().max()))


def test_generate_bdc_matches_jax():
    ja = _ns(jeng, jforms, jbc, jgen.unit_box((7, 5)))
    ta = _ns(teng, tforms, tbc, tgen.unit_box((7, 5)), device="cpu")
    jc = jbc.generate_bdc(ja, _cavity_bc)
    tc = tbc.generate_bdc(ta, _cavity_bc)
    for name in jc:
        for x, y in zip(jc[name], tc[name]):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(ja.dirichlet_values, ta.dirichlet_values)


def test_tensor_helpers_match_jax():
    """Batched element-last small-tensor algebra (qp-matrices with a
    trailing element axis) against femus_tpu.assembly.tensors."""
    import femus_tpu.assembly.tensors as jt
    import femus_tpu_torch.assembly.tensors as tt

    rng = np.random.default_rng(8)
    for dim in (2, 3):
        F = rng.standard_normal((4, dim, dim, 5)) + 2 * np.eye(dim)[
            None, :, :, None]
        G = rng.standard_normal((4, dim, dim, 5))
        v = rng.standard_normal((4, dim, 5))
        Fj, Gj, vj = jnp.asarray(F), jnp.asarray(G), jnp.asarray(v)
        Ft, Gt, vt = torch.as_tensor(F), torch.as_tensor(G), torch.as_tensor(v)
        pairs = [(jt.det(Fj), tt.det(Ft)), (jt.inv(Fj), tt.inv(Ft)),
                 (jt.trace(Fj), tt.trace(Ft)),
                 (jt.transpose(Fj), tt.transpose(Ft)),
                 (jt.matmul(Fj, Gj), tt.matmul(Ft, Gt)),
                 (jt.matTmul(Fj, Gj), tt.matTmul(Ft, Gt)),
                 (jt.matmulT(Fj, Gj), tt.matmulT(Ft, Gt)),
                 (jt.matvec(Fj, vj), tt.matvec(Ft, vt)),
                 (jt.vdot(vj, vj), tt.vdot(vt, vt)),
                 (jt.qpm(jt.det(Fj)) * jt.eye_like(dim, Fj),
                  tt.qpm(tt.det(Ft)) * tt.eye_like(dim, Ft)),
                 (jt.qp(jt.det(Fj)) * vj, tt.qp(tt.det(Ft)) * vt)]
        for a, b in pairs:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                       atol=1e-12)
