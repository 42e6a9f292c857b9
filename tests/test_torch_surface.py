"""Port parity of surface (embedded-manifold) FE and the batch-first layout.

``map_to_surface`` is copied: its arrays are EQUAL.  The manifold branch of
the element geometry (first fundamental form: area element sqrt(det G),
tangential gradients G^-1 J) in ``ElemOpsBatched`` and the per-element
``ElemOps`` matches the JAX package's to 1e-12; the Laplace-Beltrami solve on
the half cylinder of tests/test_surface.py agrees to 1e-10 at 4x4.  Forms
with ``layout = "batch_first"`` (vmap of the per-element residual, vmap of
jacfwd for the Jacobian) assemble, give their diagonal and linearise like
the JAX package; the conformal energy, residual and Jacobian agree to 1e-12
of their size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import femus_tpu.assembly.bc as jbc
import femus_tpu.assembly.conformal as jconf
import femus_tpu.assembly.engine as jeng
import femus_tpu.assembly.forms as jforms
import femus_tpu.assembly.norms as jnorms
import femus_tpu.mesh.generation as jgen
import femus_tpu_torch.assembly.bc as tbc
import femus_tpu_torch.assembly.conformal as tconf
import femus_tpu_torch.assembly.engine as teng
import femus_tpu_torch.assembly.forms as tforms
import femus_tpu_torch.assembly.norms as tnorms
import femus_tpu_torch.mesh.generation as tgen

pi = np.pi


def cyl(p):
    phi = np.pi * p[:, 0]
    return np.stack([np.cos(phi), np.sin(phi), p[:, 1]], axis=-1)


def _surface(g, n):
    return g.map_to_surface(g.unit_box((n, n), "quad"), cyl)


def _close(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def test_map_to_surface_arrays_equal():
    jm, tm = _surface(jgen, 3), _surface(tgen, 3)
    assert tm.coords.shape == (jm.n_nodes, 3) and tm.dim == 2
    for f in ("coords", "conn", "elem_group"):
        np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f))
    for k in jm.boundary:
        for f in ("elem", "iface", "group", "conn"):
            np.testing.assert_array_equal(getattr(jm.boundary[k], f),
                                          getattr(tm.boundary[k], f))
    for fam in ("biquadratic", "linear"):
        np.testing.assert_array_equal(jm.dofmap(fam).conn,
                                      tm.dofmap(fam).conn)


def _asm_pair(mesh_fn, unknowns, quad="seventh"):
    aj = jeng.Assembler(mesh_fn(jgen), [jeng.Unknown(*u) for u in unknowns],
                        quad_order=quad, dtype=jnp.float64)
    at = teng.Assembler(mesh_fn(tgen), [teng.Unknown(*u) for u in unknowns],
                        quad_order=quad, dtype=torch.float64, device="cpu")
    return aj, at


@pytest.mark.parametrize("shape", ["cylinder", "curve"])
def test_manifold_geometry_matches_jax(shape):
    """wdet, physical quadrature points and tangential gradients of every
    family, element-last and per element, against the JAX package."""
    if shape == "cylinder":
        mk, unk = (lambda g: _surface(g, 3)), [("u", "biquadratic"),
                                                ("p", "linear")]
    else:
        def mk(g):   # a helix arc: an edge mesh embedded in 3-D
            return g.map_to_surface(g.box((5,), [(0.0, 1.0)], "edge"),
                                    lambda p: np.stack(
                                        [np.cos(2 * p[:, 0]),
                                         np.sin(2 * p[:, 0]), p[:, 0]], -1))
        unk = [("u", "biquadratic")]
    aj, at = _asm_pair(mk, unk)
    tj, tt = aj.device_tables(), at.device_tables()
    ne = aj.mesh.n_elems
    cj = tj["coords_e"][:ne]
    oj = jeng.ElemOpsBatched(tj["tabs"], tj["qweights"],
                             jnp.transpose(cj, (1, 2, 0)), aj.dim)
    ot = teng.ElemOpsBatched(tt["tabs"], tt["qweights"],
                             tt["coords_e"].permute(1, 2, 0), at.dim)
    _close(ot.wdet, oj.wdet, 1e-12)
    _close(ot.x, oj.x, 1e-12)
    for fam in tj["tabs"]:
        _close(ot.dphi(fam), oj.dphi(fam), 1e-12)
    # per element (the batch-first layout), under each package's vmap
    def jone(c):
        o = jeng.ElemOps(tj["tabs"], tj["qweights"], c, aj.dim)
        return o.wdet, o.x, [o.dphi(f) for f in sorted(tj["tabs"])]

    def tone(c):
        o = teng.ElemOps(tt["tabs"], tt["qweights"], c, at.dim)
        return o.wdet, o.x, [o.dphi(f) for f in sorted(tt["tabs"])]

    rj, rt = jax.vmap(jone)(cj), torch.func.vmap(tone)(tt["coords_e"])
    for a, b in zip(jax.tree_util.tree_leaves(rj),
                    [rt[0], rt[1]] + list(rt[2])):
        _close(b, a, 1e-12)


def test_surface_area_element():
    """Area of the half cylinder (radius 1, height 1) = pi through the
    port's norms, as in tests/test_surface.py (isoparametric Q2: O(h^4))."""
    mesh = _surface(tgen, 8)
    one = torch.ones(mesh.dofmap("biquadratic").n_dofs, dtype=torch.float64)
    area = tnorms.integrate_field(mesh, "biquadratic", one, device="cpu")
    assert abs(area - pi) < 1e-4, area


def exact_lb(x, xp):
    return x[:, 1] * xp.sin(np.pi * x[:, 2])


def _lb_solve(mod_gen, mod_eng, mod_forms, mod_bc, xp, n, **kw):
    """Laplace-Beltrami -Lap_G u = (1 + pi^2) u on the half cylinder,
    u = sin(phi) sin(pi z), one assembly + one sparse solve on the host."""
    mesh = _surface(mod_gen, n)
    a = mod_eng.Assembler(mesh, [mod_eng.Unknown("u", "biquadratic")],
                          quad_order="seventh", **kw)
    a.set_volume_form(mod_forms.poisson(
        "u", rhs=lambda x: (1 + np.pi ** 2) * exact_lb(x, xp)))
    mod_bc.generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
    u = mod_bc.apply_dirichlet_values(a, np.zeros(a.n_dofs))
    R, data = a.make_assemble_fn()(
        jnp.asarray(u) if xp is jnp else torch.as_tensor(u))
    pat = a.pattern
    rows = np.repeat(np.arange(pat.n_rows), pat.width)
    valid = np.asarray(pat.valid).ravel()
    J = sp.csr_matrix((np.asarray(data).ravel()[valid],
                       (rows[valid], np.asarray(pat.cols).ravel()[valid])),
                      shape=(pat.n_rows,) * 2)[:a.n_dofs, :a.n_dofs]
    return mesh, u - spla.spsolve(J.tocsc(), np.asarray(R)[:a.n_dofs])


def test_laplace_beltrami_solve_matches_jax():
    jm, uj = _lb_solve(jgen, jeng, jforms, jbc, jnp, 4, dtype=jnp.float64)
    tm, ut = _lb_solve(tgen, teng, tforms, tbc, torch, 4,
                       dtype=torch.float64, device="cpu")
    _close(ut, uj, 1e-10)
    lj, _ = jnorms.error_norms(jm, "biquadratic", jnp.asarray(uj),
                               lambda x: exact_lb(x, jnp))
    lt, _ = tnorms.error_norms(tm, "biquadratic", torch.as_tensor(ut),
                               lambda x: exact_lb(x, torch), device="cpu")
    assert lt == pytest.approx(lj, rel=1e-9) and lt < 5e-3


# ---- the batch-first layout --------------------------------------------

def _willmore_pair():
    aj, at = _asm_pair(lambda g: g.unit_box((3, 2)),
                       [("u", "biquadratic"), ("W", "biquadratic")])
    aj.set_volume_form(jforms.willmore_graph(c=0.2))
    at.set_volume_form(tforms.willmore_graph(c=0.2))
    bc = lambda var, x, grp, t: (x[0] < 1e-9, 0.5)   # noqa: E731
    jbc.generate_bdc(aj, bc)
    tbc.generate_bdc(at, bc)
    u = 1.0 + 0.2 * np.random.default_rng(3).standard_normal(aj.n_dofs)
    return aj, at, u


def test_batch_first_assembly_and_diagonal_match_jax():
    aj, at, u = _willmore_pair()
    Rj, Dj = jax.jit(aj.make_assemble_fn(layout="batch_first"))(
        jnp.asarray(u))
    fb = at.make_assemble_fn(layout="batch_first")
    Rt, Dt = fb(torch.as_tensor(u))
    _close(Rt, np.asarray(Rj)[:aj.n_dofs], 1e-12)
    _close(Dt, Dj, 1e-12)
    # the element-last layout gives the same operator
    Re, De = at.make_assemble_fn()(torch.as_tensor(u))
    _close(Rt, Re, 1e-12)
    _close(Dt, De, 1e-12)
    # the diagonal follows the form's own layout attribute
    form = tforms.willmore_graph(c=0.2)

    def per_element(ops, u, aux):
        return form(ops, u, aux)

    per_element.layout = "batch_first"
    at.set_volume_form(per_element)
    dj = jax.jit(aj.make_diag_fn(pass_tables=False))(jnp.asarray(u))
    dt = at.make_diag_fn()(torch.as_tensor(u), at.device_tables())
    _close(dt, np.asarray(dj)[:aj.n_dofs], 1e-12)


def _conformal_pair(mesh_fn, disp, normal=None):
    aj, at = _asm_pair(mesh_fn, [(d, "biquadratic") for d in disp],
                       quad="fifth")
    aj.set_volume_form(jconf.conformal_minimization(disp, normal=normal))
    at.set_volume_form(tconf.conformal_minimization(disp, normal=normal))
    assert at.volume_form.layout == "batch_first"
    rng = np.random.default_rng(7)
    x = aj.mesh.coords[aj.dofmaps[disp[0]].nodes]
    u = np.concatenate([0.1 * x[:, 0] * x[:, 1] + 0.02 * rng.standard_normal(
        len(x)) for _ in disp])
    return aj, at, u


@pytest.mark.parametrize("case", ["planar", "planar_normal", "surface"])
def test_conformal_energy_residual_jacobian_match_jax(case):
    if case == "surface":
        aj, at, u = _conformal_pair(lambda g: _surface(g, 2),
                                    ("Dx1", "Dx2", "Dx3"))
    else:
        aj, at, u = _conformal_pair(
            lambda g: g.unit_box((2, 2), "quad"), ("Dx1", "Dx2"),
            (0.0, 0.0, 1.0) if case == "planar_normal" else None)
    Rj, Dj = jax.jit(aj.make_assemble_fn())(jnp.asarray(u))
    Rt, Dt = at.make_assemble_fn()(torch.as_tensor(u))
    _close(Rt, np.asarray(Rj)[:aj.n_dofs], 1e-12)
    _close(Dt, Dj, 1e-12)
    # the element energies themselves
    names = [un.name for un in at.unknowns]
    tj, tt = aj.device_tables(), at.device_tables()
    conn = aj.dofmaps[names[0]].conn

    def parts(xp, uu):
        return [xp.asarray(uu)[aj.offsets[n]:aj.offsets[n] + conn.max() + 1]
                [conn] for n in names] if xp is jnp else [
            torch.as_tensor(uu)[aj.offsets[n]:aj.offsets[n] + conn.max() + 1]
            [torch.as_tensor(conn, dtype=torch.int64)] for n in names]

    normal = (0.0, 0.0, 1.0) if case == "planar_normal" else None
    Ej = jax.jit(jax.vmap(lambda c, *d: jconf.conformal_energy(
        jeng.ElemOps(tj["tabs"], tj["qweights"], c, aj.dim),
        dict(zip(names, d)), tuple(names), normal=normal)))(
        tj["coords_e"][:aj.mesh.n_elems], *parts(jnp, u))
    Et = torch.func.vmap(lambda c, *d: tconf.conformal_energy(
        teng.ElemOps(tt["tabs"], tt["qweights"], c, at.dim),
        dict(zip(names, d)), tuple(names), normal=normal))(
        tt["coords_e"], *parts(torch, u))
    _close(Et, Ej, 1e-12)


def test_batch_first_linearized_matches_assembled():
    """The matrix-free linearisation of a batch-first form applies the
    assembled Jacobian (before Dirichlet elimination, on free columns)."""
    _, at, u = _conformal_pair(lambda g: g.unit_box((2, 2), "quad"),
                               ("Dx1", "Dx2"))
    tbc.generate_bdc(at, lambda var, x, grp, t: (True, 0.0))
    tables = at.device_tables()
    ut = torch.as_tensor(u)
    R, jv = at.make_linearized_fn()(ut, tables)
    Ra, data = at.make_assemble_fn(pass_tables=True)(ut, tables)
    _close(R, Ra, 1e-12)
    mask = torch.as_tensor(at.dirichlet_mask)
    v = torch.where(mask, 0.0, torch.as_tensor(
        np.random.default_rng(1).standard_normal(at.n_dofs)))
    ref = torch.where(mask, 0.0, at.op_with(data) @ v)
    _close(torch.where(mask, 0.0, jv(v)), ref, 1e-12)
    assert at.new_op().data.abs().sum() == 0
    assert at.new_op().data.shape == data.shape


def test_face_form_on_manifold_matches_jax():
    """A boundary-face form on the embedded cylinder computes what the JAX
    package computes (the length element of the face trace in 3-D)."""
    aj, at = _asm_pair(lambda g: _surface(g, 3), [("u", "biquadratic")])
    aj.set_volume_form(jforms.poisson("u"))
    at.set_volume_form(tforms.poisson("u"))
    aj.set_face_form(jforms.neumann_faces({3: lambda x, n: 1.0 + x[:, 0]}))
    at.set_face_form(tforms.neumann_faces({3: lambda x, n: 1.0 + x[:, 0]}))
    u = np.random.default_rng(2).standard_normal(aj.n_dofs)
    Rj, _ = jax.jit(aj.make_assemble_fn())(jnp.asarray(u))
    Rt, _ = at.make_assemble_fn()(torch.as_tensor(u))
    _close(Rt, np.asarray(Rj)[:aj.n_dofs], 1e-12)
    # the flux alone integrates (1 + x) over the bottom rim, a half circle
    # of length pi on which x = cos(phi) integrates to 0 (isoparametric
    # Q2 trace of 8 segments)
    at0 = teng.Assembler(_surface(tgen, 8), [teng.Unknown("u")],
                         quad_order="seventh", dtype=torch.float64,
                         device="cpu")
    at0.set_volume_form(lambda ops, u, aux: {})
    at0.set_face_form(tforms.neumann_faces({3: lambda x, n: 1.0 + x[:, 0]}))
    R0, _ = at0.make_assemble_fn(with_jacobian=False)(
        torch.zeros(at0.n_dofs, dtype=torch.float64))
    assert abs(float(-R0.sum()) - pi) < 1e-4
