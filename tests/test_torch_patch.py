"""Port parity of slice 2: the patch-stencil operator path.

Generated unit_box coarse meshes only.  Host set-up code is copied, so the
patch plans, one-hot routing tables and weight slots must be EQUAL to the
JAX package's; the port's index routing (what the card reads) must give
exactly what the one-hot products give.  Assembly, matvecs and solves run in float64 in both packages;
only the order of the floating-point sums differs, so assembled data agree
to 1e-12 (relative to max|data|), matvecs to 1e-10, a V-cycle to 1e-10 and
1e-10-rtol GMRES solves to 1e-8.  The port's plain version of kernel B2 is
held against the JAX package's Pallas kernel itself, run in interpret mode.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.algebra.mg as jmg
import femus_tpu.algebra.patchstencil as jps
import femus_tpu.algebra.transfer as jtr
import femus_tpu.assembly.bc as jbc
import femus_tpu.assembly.engine as jeng
import femus_tpu.assembly.forms as jforms
import femus_tpu.mesh.generation as jgen
import femus_tpu.mesh.multilevel as jml
import femus_tpu.mesh.patches as jpatches
import femus_tpu.systems.problem as jprob
import femus_tpu.systems.solution as jsol
import femus_tpu.systems.system as jsys
import femus_tpu_torch.algebra.mg as tmg
import femus_tpu_torch.algebra.patchstencil as tps
import femus_tpu_torch.assembly.bc as tbc
import femus_tpu_torch.assembly.engine as teng
import femus_tpu_torch.assembly.forms as tforms
import femus_tpu_torch.mesh.generation as tgen
import femus_tpu_torch.mesh.multilevel as tml
import femus_tpu_torch.mesh.patches as tpatches
import femus_tpu_torch.systems.problem as tprob
import femus_tpu_torch.systems.solution as tsol
import femus_tpu_torch.systems.system as tsys
from femus_tpu_torch import convert

pi = np.pi
CASES = [((3, 2), 1), ((3, 2), 2), ((4, 3), 2)]
PROBLEMS = ["poisson", "elasticity"]


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


# ---- host set-up: plans, tables, slots ---------------------------------


@pytest.mark.parametrize("ns,levels", CASES)
def test_refine_patched_equal(ns, levels):
    jm, jplan = jpatches.refine_patched(jgen.unit_box(ns), levels)
    tm, tplan = tpatches.refine_patched(tgen.unit_box(ns), levels)
    for f in ("coords", "conn", "elem_group", "parent_elem", "child_slot"):
        np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f))
    assert jm.boundary.keys() == tm.boundary.keys()
    for k in jm.boundary:
        for f in ("elem", "iface", "group", "conn"):
            np.testing.assert_array_equal(getattr(jm.boundary[k], f),
                                          getattr(tm.boundary[k], f))
    for f in jpatches.PatchPlan.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(jplan, f), getattr(tplan, f))
    for p, i, j in [(0, 0, 0), (1, 0, 2), (2, tplan.H - 1, 1), (0, 2, 2)]:
        assert jplan.node_of(p, i, j) == tplan.node_of(p, i, j)


@pytest.mark.parametrize("ns,levels", CASES)
def test_patch_tables_and_slots_equal(ns, levels):
    _, jplan = jpatches.refine_patched(jgen.unit_box(ns), levels)
    _, tplan = tpatches.refine_patched(tgen.unit_box(ns), levels)
    jt, tt = jps.build_patch_tables(jplan), tps.build_patch_tables(tplan)
    for f in jps.PatchTables.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f))
    for nv in (1, 2):
        js, jsize = jps.build_patch_slots(jplan, jt, nv=nv)
        ts, tsize = tps.build_patch_slots(tplan, tt, nv=nv)
        assert jsize == tsize
        np.testing.assert_array_equal(js, ts)


def _onehot_inputs(tab, x):
    """numpy: the JAX package's one-hot routing of x into face lines and
    corners, (E, 4, P) and (4, P)."""
    E, P, ne = tab.E, tab.P, tab.n_edges
    n_int = E * E * P
    xe = x[n_int:n_int + E * ne].reshape(E, ne)
    xef = np.concatenate([xe, xe[::-1]], axis=1)
    ln = (xef @ tab.G_face.astype(np.float64)).reshape(E, 4, P)
    cn = (tab.M_cs.astype(np.float64) @ x[n_int + E * ne:]).reshape(4, P)
    return ln, cn


def _onehot_combine(tab, yl, yc):
    """numpy: the one-hot sums of line and corner partials onto edges and
    vertices."""
    E, P = tab.E, tab.P
    lf = yl[:, :, :P].reshape(E, 4 * P)
    lfl = np.concatenate([lf, lf[::-1]], axis=1)
    return (lfl @ tab.G_edge.astype(np.float64),
            tab.M_vs.astype(np.float64) @ yc[:, :P].reshape(-1))


def _rotated_box(gen, ns):
    """unit_box(ns) with the local frame of every second element rotated a
    quarter turn (corners, mid-edge nodes and boundary face ids shifted
    alike; same mesh, same geometry): neighbouring patches then disagree
    on the direction of their shared edge (``patch_edge_flip``), which a
    generated box never has."""
    import dataclasses
    mesh = gen.unit_box(ns)
    rot = np.arange(mesh.n_elems) % 2 == 1
    conn = mesh.conn.copy()
    conn[rot] = mesh.conn[rot][:, [1, 2, 3, 0, 5, 6, 7, 4, 8]]
    boundary = {k: dataclasses.replace(
        b, iface=np.where(rot[b.elem], (b.iface - 1) % 4, b.iface
                          ).astype(b.iface.dtype))
        for k, b in mesh.boundary.items()}
    return dataclasses.replace(mesh, conn=conn, boundary=boundary)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("ns,levels", CASES + [((1, 1), 1), ((130, 1), 1)])
def test_index_routing_equals_onehot_products(ns, levels, shuffle):
    """The int32 tables route random vectors exactly as the one-hot
    matrices do: flipped edges (rotated element frames), boundary edges
    (one side), P < Pp, and P > 128 (Pp = 256).  The tables read back from
    the one-hot matrices hold the same sides."""
    coarse = _rotated_box(tgen, ns) if shuffle else tgen.unit_box(ns)
    _, plan = tpatches.refine_patched(coarse, levels)
    tab = tps.build_patch_tables(plan)
    assert tab.P < tab.Pp and tab.Pp % 128 == 0
    assert bool(plan.patch_edge_flip.any()) == (shuffle and ns != (1, 1))
    assert (plan.edge_sides[:, 1, 0] < 0).any()
    meta = tps.patch_meta(tab)
    routing = tps.patch_routing(tab, "cpu")
    rng = np.random.default_rng(13)
    x = rng.standard_normal(tab.n)
    xi, ln, cn = tps._patch_inputs(meta, routing, torch.as_tensor(x))
    ln_ref, cn_ref = _onehot_inputs(tab, x)
    np.testing.assert_array_equal(ln[:, :, :tab.P].numpy(), ln_ref)
    np.testing.assert_array_equal(cn[:, :tab.P].numpy(), cn_ref)
    assert not ln[:, :, tab.P:].any() and not cn[:, tab.P:].any()
    assert not xi[:, :, tab.P:].any()
    np.testing.assert_array_equal(
        xi[:, :, :tab.P].numpy().ravel(), x[:plan.n_int])
    E, Pp = tab.E, tab.Pp
    yi = rng.standard_normal((E, E, Pp))
    yl = rng.standard_normal((E, 4, Pp))
    yc = rng.standard_normal((4, Pp))
    y = tps._patch_combine(meta, routing, *map(torch.as_tensor,
                                               (yi, yl, yc))).numpy()
    ye_ref, yv_ref = _onehot_combine(tab, yl, yc)
    np.testing.assert_array_equal(y[:plan.n_int],
                                  yi[:, :, :tab.P].ravel())
    n_e = E * tab.n_edges
    np.testing.assert_array_equal(y[plan.n_int:plan.n_int + n_e],
                                  ye_ref.ravel())
    _close(y[plan.n_int + n_e:], yv_ref, 1e-14)
    # read back from the one-hot matrices: the same tables, sides as sets
    back = tps.routing_from_onehot(tab.G_face, tab.G_edge, tab.M_cs,
                                   tab.M_vs, meta)
    np.testing.assert_array_equal(back[0], tab.face_code)
    np.testing.assert_array_equal(back[1], tab.corner_vert)
    np.testing.assert_array_equal(np.sort(back[2], axis=1),
                                  np.sort(tab.edge_sides, axis=1))
    np.testing.assert_array_equal(np.sort(back[3], axis=1),
                                  np.sort(tab.vert_sides, axis=1))
    for t in (tab.face_code, tab.corner_vert, tab.edge_sides,
              tab.vert_sides):
        assert t.dtype == np.int32


def test_patched_hierarchy_levels():
    jmm = jml.PatchedMultiLevelMesh(jgen.unit_box((3, 3)), 3)
    tmm = tml.PatchedMultiLevelMesh(tgen.unit_box((3, 3)), 3)
    assert tmm.levels[0].patch_plan is None
    for jm, tm in zip(jmm.levels[1:], tmm.levels[1:]):
        np.testing.assert_array_equal(jm.conn, tm.conn)
        np.testing.assert_array_equal(jm.coords, tm.coords)
        assert jm.patch_plan.H == tm.patch_plan.H
    # a hex coarse mesh gets the 3-D plans (the JAX package's hex branch)
    jmm = jml.PatchedMultiLevelMesh(jgen.unit_box((1, 1, 1), "hex"), 2)
    tmm = tml.PatchedMultiLevelMesh(tgen.unit_box((1, 1, 1), "hex"), 2)
    for jm, tm in zip(jmm.levels[1:], tmm.levels[1:]):
        np.testing.assert_array_equal(jm.conn, tm.conn)
        np.testing.assert_array_equal(jm.coords, tm.coords)
        assert jm.patch_plan.H == tm.patch_plan.H


# ---- assembly and operators --------------------------------------------


def _problem(pkg, problem):
    """(unknown names, form, bc) of one problem for one package."""
    forms = jforms if pkg == "jax" else tforms
    xp = jnp if pkg == "jax" else torch
    if problem == "poisson":
        def rhs(x):
            return 2 * pi ** 2 * xp.sin(pi * x[:, 0]) * xp.sin(pi * x[:, 1])
        return (["u"], forms.poisson("u", "biquadratic", rhs=rhs),
                lambda var, x, grp, t: (True, 0.0))

    def force(x):
        return xp.stack([0.0 * x[:, 0], -1.0 + 0.0 * x[:, 1]], 1)
    return (["DX", "DY"],
            forms.elasticity(("DX", "DY"), model="linear", lam=1.2, mu=0.8,
                             force=force),
            lambda var, x, grp, t: (grp == 1, 0.0))     # clamped at x = 0


def _assemblers(problem, ns=(3, 2), levels=2, shuffle=False):
    """JAX patch assembler, port patch assembler and port ELL assembler on
    the same patched fine mesh, with the same Dirichlet rows; ``shuffle``:
    on a coarse mesh with flipped patch faces."""
    jc, tc = ((_rotated_box(jgen, ns), _rotated_box(tgen, ns)) if shuffle
              else (jgen.unit_box(ns), tgen.unit_box(ns)))
    jm, jplan = jpatches.refine_patched(jc, levels)
    tm, tplan = tpatches.refine_patched(tc, levels)
    names, jform, bc = _problem("jax", problem)
    _, tform, _ = _problem("torch", problem)
    ja = jeng.Assembler(jm, [jeng.Unknown(n) for n in names],
                        quad_order="fifth")
    ja.set_volume_form(jform)
    jbc.generate_bdc(ja, bc)
    ja.set_patch_layout(jplan)
    out = [ja]
    for patch in (True, False):
        ta = teng.Assembler(tm, [teng.Unknown(n) for n in names],
                            quad_order="fifth", device="cpu")
        ta.set_volume_form(tform)
        tbc.generate_bdc(ta, bc)
        if patch:
            ta.set_patch_layout(tplan)
        out.append(ta)
    return out


@pytest.fixture(scope="module", params=PROBLEMS)
def assembled(request):
    ja, ta, te = _assemblers(request.param)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(ta.n_dofs)
    jR, jd = ja.make_assemble_fn()(jnp.asarray(u))
    tR, td = ta.make_assemble_fn()(torch.as_tensor(u))
    _, te_d = te.make_assemble_fn()(torch.as_tensor(u))
    return dict(problem=request.param, ja=ja, ta=ta, te=te, jR=jR, jd=jd,
                tR=tR, td=td, jop=ja.op_with(jd), top=ta.op_with(td),
                tell=te.op_with(te_d))


def test_patch_assembly_matches_jax(assembled):
    a = assembled
    assert a["td"].shape == (a["ta"]._patch_size,)
    _close(a["tR"].numpy(), a["jR"], 1e-12)
    _close(a["td"].numpy(), a["jd"], 1e-12)
    # the patch layout never builds the ELL pattern
    assert "_ell" not in vars(a["ta"])


def test_patch_dirichlet_elimination_equal(assembled):
    """The same raw weights give the same eliminated weights."""
    a = assembled
    ta, jop = a["ta"], a["jop"]
    tab = ta.patch_tab
    nv = len(ta.unknowns)
    raw = torch.as_tensor(np.array(a["jd"])).view(nv * nv * tps.K, tab.H,
                                                    tab.H, tab.Pp)
    t = ta.device_tables_cached()
    if nv == 1:
        op = tps.dirichlet_eliminate(tps.make_patch_op(tab, raw),
                                     t["dir_mask"], t["patch_owner"])
    else:
        op = tps.dirichlet_eliminate_block(
            tps.make_block_patch_op(tab, raw, nv), t["dir_mask"],
            t["patch_owner"])
    np.testing.assert_array_equal(op.wt.numpy(), np.asarray(jop.wt))
    # the masks the engine builds once per level, as op_with applies them
    np.testing.assert_array_equal(tps.apply_dirichlet(
        raw, t["patch_dir_bad"], t["patch_dir_ident"]).numpy(),
        np.asarray(jop.wt))


def test_patch_matvec_matches_jax_and_ell(assembled):
    a = assembled
    jop, top, tell = a["jop"], a["top"], a["tell"]
    assert top.n_rows == tell.n_rows == a["ta"].n_dofs
    # the operator holds int32 index tables and no one-hot matrix
    assert all(t.dtype == torch.int32 for t in (
        top.routing.face_code, top.routing.corner_vert,
        top.routing.edge_sides, top.routing.vert_sides))
    assert not hasattr(top, "G_face")
    rng = np.random.default_rng(7)
    for _ in range(3):
        x = rng.standard_normal(top.n_rows)
        y = top @ torch.as_tensor(x)
        _close(y.numpy(), jop._matvec_xla(jnp.asarray(x)), 1e-10)
        _close(y.numpy(), (tell @ torch.as_tensor(x)).numpy(), 1e-10)
    _close(top.diagonal().numpy(), jop.diagonal(), 1e-10)
    _close(top.diagonal().numpy(), tell.diagonal().numpy(), 1e-10)
    _close(top.to_dense().numpy(), tell.to_dense().numpy(), 1e-10)


@pytest.mark.parametrize("problem", PROBLEMS)
def test_patch_matvec_with_flipped_faces(problem):
    """On a coarse mesh whose patch faces run against their edges the
    plain matvec still equals the JAX package's and the port's own ELL
    matvec of the same mesh (which knows nothing of patches)."""
    ja, ta, te = _assemblers(problem, (3, 2), 2, shuffle=True)
    assert (ta.patch_tab.face_code[:, :ta.patch_tab.P] % 2 == 1).any()
    u = np.random.default_rng(3).standard_normal(ta.n_dofs)
    _, jd = ja.make_assemble_fn()(jnp.asarray(u))
    _, td = ta.make_assemble_fn()(torch.as_tensor(u))
    _, ed = te.make_assemble_fn()(torch.as_tensor(u))
    jop, top, tell = ja.op_with(jd), ta.op_with(td), te.op_with(ed)
    x = np.random.default_rng(8).standard_normal(top.n_rows)
    y = top @ torch.as_tensor(x)
    _close(y.numpy(), jop._matvec_xla(jnp.asarray(x)), 1e-10)
    _close(y.numpy(), (tell @ torch.as_tensor(x)).numpy(), 1e-10)
    _close(top.diagonal().numpy(), tell.diagonal().numpy(), 1e-10)


def _kernel_walk(op, x):
    """numpy emulation of patch_stencil.cu, address by address: the window
    value of (patch, lattice position) straight from x through face_code
    and corner_vert, the 25 products inside the lattice summed over the
    column variables in order, interior rows into y, line and corner
    partials into scratch, then the combine through edge_sides and
    vert_sides."""
    H, P, Pp, E, ne, nvt, n = op.meta[:7]
    nv = op.nv
    fc, cvt = op.routing.face_code.numpy(), op.routing.corner_vert.numpy()
    es, vs = op.routing.edge_sides.numpy(), op.routing.vert_sides.numpy()
    wt = op.wt.numpy()
    n_int = E * E * P

    def window(xv, gi, gj, p):
        if not (0 <= gi < H and 0 <= gj < H):
            return 0.0
        ii, jj = 0 < gi < H - 1, 0 < gj < H - 1
        if ii and jj:
            return xv[((gi - 1) * E + gj - 1) * P + p]
        if ii or jj:
            f = (0 if gj == 0 else 2) if ii else (1 if gi == H - 1 else 3)
            r = (gi if ii else gj) - 1
            code = fc[f, p]
            if code & 1:
                r = E - 1 - r
            return xv[n_int + r * ne + (code >> 1)]
        c = (0 if gi == 0 else 1) if gj == 0 else (3 if gi == 0 else 2)
        return xv[n_int + E * ne + cvt[c, p]]

    y = np.full(nv * n, np.nan)
    yl = np.full((nv, E, 4, Pp), np.nan)
    yc = np.full((nv, 4, Pp), np.nan)
    for vr in range(nv):
        for p in range(P):
            for i in range(H):
                for j in range(H):
                    acc = 0.0
                    for vc in range(nv):
                        xv = x[vc * n:(vc + 1) * n]
                        for k in range(25):
                            a, b = i + k // 5 - 2, j + k % 5 - 2
                            if 0 <= a < H and 0 <= b < H:
                                acc += wt[(vr * nv + vc) * 25 + k, i, j, p] \
                                    * window(xv, a, b, p)
                    ii, jj = 0 < i < H - 1, 0 < j < H - 1
                    if ii and jj:
                        y[vr * n + ((i - 1) * E + j - 1) * P + p] = acc
                    elif ii or jj:
                        f = (0 if j == 0 else 2) if ii \
                            else (1 if i == H - 1 else 3)
                        yl[vr, (i if ii else j) - 1, f, p] = acc
                    else:
                        c = (0 if i == 0 else 1) if j == 0 \
                            else (3 if i == 0 else 2)
                        yc[vr, c, p] = acc
        for t in range(E * ne + nvt):
            acc = 0.0
            if t < E * ne:
                r, e = divmod(t, ne)
                for code in es[e]:
                    if code >= 0:
                        rr = E - 1 - r if code & 1 else r
                        acc += yl[vr, rr, (code >> 1) & 3, code >> 3]
            else:
                for code in vs[t - E * ne]:
                    if code >= 0:
                        acc += yc[vr, code & 3, code >> 2]
            y[vr * n + n_int + t] = acc
    return y


@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("shuffle", [False, True])
def test_kernel_walk_matches_plain(problem, shuffle):
    """The addresses the CUDA kernel computes (emulated in numpy from the
    int32 tables) give the plain matvec, with and without flipped faces."""
    _, ta, _ = _assemblers(problem, (3, 2), 1, shuffle=shuffle)
    u = np.random.default_rng(3).standard_normal(ta.n_dofs)
    _, td = ta.make_assemble_fn()(torch.as_tensor(u))
    top = ta.op_with(td)
    x = np.random.default_rng(9).standard_normal(top.n_rows)
    _close(_kernel_walk(top, x), (top @ torch.as_tensor(x)).numpy(), 1e-12)


@pytest.mark.parametrize("ns,levels", [((3, 2), 2), ((4, 3), 1)])
@pytest.mark.parametrize("problem", PROBLEMS)
def test_plain_kernel_matches_pallas_interpret(problem, ns, levels,
                                               monkeypatch):
    """``_patch_chunk_plain`` against JAX's Pallas ``_patch_chunk_call``
    run in interpret mode, for every (row var, col var) weight pair of the
    eliminated operator; and the port's per-patch inputs against JAX's."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    ja, _, _ = _assemblers(problem, ns, levels)
    jR, jd = ja.make_assemble_fn()(jnp.zeros(ja.n_dofs_pad))
    jop = ja.op_with(jd)
    top = convert.patch_op_from_numpy(
        np.asarray(jop.wt), np.asarray(jop.G_face), np.asarray(jop.G_edge),
        np.asarray(jop.M_cs), np.asarray(jop.M_vs), jop.meta, device="cpu",
        dtype=torch.float64)
    meta7 = jop.meta[:7]
    nb, nv = meta7[6], len(ja.unknowns)
    x = np.random.default_rng(11).standard_normal(nb * nv)
    for vc in range(nv):
        xs = x[vc * nb:(vc + 1) * nb]
        j_in = jps._patch_inputs(meta7, jop.G_face, jop.M_cs,
                                 jnp.asarray(xs))
        t_in = tps._patch_inputs(meta7, top.routing, torch.as_tensor(xs))
        for jv, tv in zip(j_in, t_in):
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        for vr in range(nv):
            q = vr * nv + vc
            wt = jop.wt[q * tps.K:(q + 1) * tps.K]
            ref = jps._patch_chunk_call(wt, *j_in, meta7)
            got = tps._patch_chunk_plain(torch.as_tensor(np.asarray(wt)),
                                         *t_in)
            for r, g in zip(ref, got):
                assert g.shape == r.shape
                _close(g.numpy(), r, 1e-13)
    # the whole matvec, plain chunks plus the skeleton combine
    _close((top @ torch.as_tensor(x)).numpy(), jop._matvec_xla(
        jnp.asarray(x)), 1e-10)


# ---- multigrid ----------------------------------------------------------


def _level_ops(problem):
    """Per-level operators (patch stencils above level 0, ELL at level 0)
    and masked (P, R) pairs of a 3-level patched hierarchy, in JAX, plus
    the same carried into the port."""
    names, jform, bc = _problem("jax", problem)
    jmm = jml.PatchedMultiLevelMesh(jgen.unit_box((3, 3)), 3)
    unks = [jeng.Unknown(n) for n in names]
    jas, jops, tops = [], [], []
    for mesh in jmm.levels:
        a = jeng.Assembler(mesh, unks, quad_order="fifth")
        a.set_volume_form(jform)
        jbc.generate_bdc(a, bc)
        if mesh.patch_plan is not None:
            a.set_patch_layout(mesh.patch_plan)
        _, d = a.make_assemble_fn()(jnp.zeros(a.n_dofs_pad))
        op = a.op_with(d)
        jas.append(a)
        jops.append(op)
        if mesh.patch_plan is None:
            tops.append(convert.sparse_op_from_numpy(
                np.asarray(op.data), np.asarray(op.cols), op.n_cols,
                device="cpu"))
        else:
            tops.append(convert.patch_op_from_numpy(
                np.asarray(op.wt), np.asarray(op.G_face),
                np.asarray(op.G_edge), np.asarray(op.M_cs),
                np.asarray(op.M_vs), op.meta, device="cpu"))
    jpr, tpr = [], []
    for l in range(len(jmm.levels) - 1):
        P = jtr.block_diag_prolongation(jmm.levels[l], jmm.levels[l + 1],
                                        unks)
        Pm = jtr.mask_prolongation(P, jas[l + 1].dirichlet_mask,
                                   jas[l].dirichlet_mask)
        pr = jtr.op_pair_from_scipy(Pm)
        jpr.append(pr)
        tpr.append(tuple(convert.sparse_op_from_numpy(
            np.asarray(o.data), np.asarray(o.cols), o.n_cols, device="cpu")
            for o in pr))
    return jops, jpr, tops, tpr


@pytest.mark.parametrize("problem", PROBLEMS)
def test_v_cycle_from_ops_matches_jax(problem):
    jops, jpr, tops, tpr = _level_ops(problem)
    jh = jmg.build_hierarchy_from_ops(jops, jpr, smoother="chebyshev")
    th = tmg.build_hierarchy_from_ops(tops, tpr, smoother="chebyshev")
    assert th.coarse_lu is not None and th.levels[0].smoother is None
    b = np.random.default_rng(5).standard_normal(tops[-1].n_rows)
    ref = np.asarray(jh.as_preconditioner("V")(jnp.asarray(b)))
    _close(th.as_preconditioner()(torch.as_tensor(b)).numpy(), ref, 1e-10)


# ---- the System path ------------------------------------------------------


def _system(pkg, problem, solve=True):
    gen, ml, sol, prob, sysm = ((jgen, jml, jsol, jprob, jsys) if pkg == "jax"
                                else (tgen, tml, tsol, tprob, tsys))
    names, form, bc = _problem(pkg, problem)
    ml_mesh = ml.PatchedMultiLevelMesh(gen.unit_box((3, 3)), 3)
    ml_sol = sol.MultiLevelSolution(ml_mesh)
    for n in names:
        ml_sol.add_solution(n, "biquadratic")
        ml_sol.initialize(n)
    ml_sol.attach_bc(bc)
    for n in names:
        ml_sol.generate_bdc(n)
    pr = prob.MultiLevelProblem(ml_mesh, ml_sol, quad_order="fifth")
    s = pr.add_system(sysm.LinearImplicitSystem, problem)
    s.add_unknown(*names)
    s.set_assembly(form)
    cfg = s.config
    cfg.operator = "patch"
    cfg.coarse_op = "rediscretize"
    cfg.smoother = "chebyshev"
    cfg.mg_type = "V"
    cfg.rtol = 1e-10
    if not solve:
        return s
    if pkg == "jax":
        s.init()
    else:
        s.init(device="cpu")
    info = s.solve()
    return s, ml_mesh, ml_sol, names, info


@pytest.fixture(scope="module", params=PROBLEMS)
def patch_solves(request):
    return dict(problem=request.param, jax=_system("jax", request.param),
                port=_system("torch", request.param))


def test_patch_system_matches_jax(patch_solves):
    _, _, jsol_, names, jinfo = patch_solves["jax"]
    _, ml_mesh, tsol_, _, tinfo = patch_solves["port"]
    assert tinfo["converged"] and tinfo["residual"] < 1e-9
    assert tinfo["iters"] == int(jinfo["iters"]) <= 12
    for n in names:
        _close(tsol_.sol[-1][n], jsol_.sol[-1][n], 1e-8)
    if patch_solves["problem"] == "poisson":
        x = ml_mesh.levels[-1].node_coords_of("biquadratic")
        exact = np.sin(pi * x[:, 0]) * np.sin(pi * x[:, 1])
        assert np.abs(tsol_.sol[-1]["u"] - exact).max() < 2e-5


def test_patch_step_reports_kernel_launches_and_routing(patch_solves):
    s, ml_mesh, _, _, info = patch_solves["port"]
    # every kernel has its own count; on the host both stay 0
    assert info["kernel_launches"] == dict.fromkeys(tsys.KERNELS, 0)
    assert set(tsys.launch_counts()) == {"bell_spmv", "patch_stencil",
                                         "dia_spmv", "stencil_spmv",
                                         "vanka_colour", "vanka_invert"}
    routing = s.solver_info()["routing"]
    sizes = [a.n_dofs for a in s.assemblers]
    assert {"n_rows": sizes[0], "path": "lu",
            "reason": "coarsest V-cycle level: dense LU solve"} in routing
    for n in sizes[1:]:
        assert {"n_rows": n, "path": "patch",
                "kernel": "patch_stencil"} in routing
    # rediscretized levels: P and R only, no PtAP schedule
    assert all(t[2] is None for t in s.transfers)


def test_patch_config_errors():
    s = _system("torch", "poisson", solve=False)
    s.config.coarse_op = "galerkin"
    with pytest.raises(ValueError, match="rediscretize"):
        s.init(device="cpu")
    s.config.coarse_op = "rediscretize"
    s.config.smoother = "vanka"
    with pytest.raises(ValueError, match="chebyshev"):
        s.init(device="cpu")
    # rediscretized coarse operators are ported for the assembled and BELL
    # operators too: P and R only, no PtAP schedule, ELL levels; the
    # additive Vanka sweep raises there (tests/test_torch_rediscretize.py)
    s.config.smoother = "chebyshev"
    for op in ("assembled", "bell"):
        s.config.operator = op
        s.init(device="cpu")
        assert all(t[2] is None for t in s.transfers)
        assert all(a.patch_tab is None for a in s.assemblers)
    s.config.smoother = "vanka"
    s.config.vanka_multiplicative = False
    with pytest.raises(ValueError, match="multiplicative"):
        s.init(device="cpu")
    # the finite-strain models are ported (tests/test_torch_fsi.py); a
    # model outside the Solid registry raises
    from femus_tpu_torch.systems.constitutive import cauchy_stress
    assert callable(tforms.elasticity(("DX", "DY"), model="neo-hookean"))
    with pytest.raises(KeyError):
        cauchy_stress("no-such-model", torch.zeros(4, 2, 2, 1), 1.0)
