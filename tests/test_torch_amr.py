"""Port parity: adaptive mesh refinement against femus_tpu, in float64 on
the host.

- ``prolongation_scipy`` on a selectively refined mesh (copied elements
  take the identity block) equals the reference's, quad and tri;
- ``refine_selective`` (arrays, lineage, boundary groups), ``close_flags``,
  ``flag_by_error`` and ``hanging_constraints`` (quad, tri, hex) are equal;
- ``kelly_indicator`` agrees to 1e-12;
- ``solve_conforming`` (u to 1e-10, equal CG iteration counts),
  ``solve_mg_amr`` on a 2-cycle chain from unit_box((4,4)) (u to 1e-9,
  equal counts) and a short ``amr_loop`` agree;
- the reduced operator keeps the Dirichlet identity and the hierarchy's
  routing notes name the LU-solved coarsest level.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.mesh.amr as jamr
import femus_tpu.systems.amr as jsamr
import femus_tpu_torch.mesh.amr as tamr
import femus_tpu_torch.systems.amr as tsamr
from femus_tpu.algebra.transfer import prolongation_scipy as jprolong
from femus_tpu.assembly.engine import Unknown as JUnknown
from femus_tpu.assembly.forms import poisson as jpoisson
from femus_tpu.mesh.generation import unit_box as junit_box
from femus_tpu_torch.algebra.transfer import prolongation_scipy as tprolong
from femus_tpu_torch.assembly.engine import Unknown as TUnknown
from femus_tpu_torch.assembly.forms import poisson as tpoisson
from femus_tpu_torch.mesh.generation import unit_box as tunit_box

PI = np.pi
MESH_ARRAYS = ("coords", "conn", "parent_elem", "child_slot", "elem_level",
               "elem_group")


def _meshes(shape, geom, refined):
    """The same box in both packages and its selective refinement."""
    mj, mt = junit_box(shape, geom), tunit_box(shape, geom)
    flags = np.zeros(mj.n_elems, bool)
    flags[list(refined)] = True
    return mj, mt, jamr.refine_selective(mj, flags), \
        tamr.refine_selective(mt, flags)


def _same_mesh(fj, ft):
    for k in MESH_ARRAYS:
        assert np.array_equal(getattr(fj, k), getattr(ft, k)), k
    assert set(fj.boundary) == set(ft.boundary)
    for fg in fj.boundary:
        for k in ("elem", "iface", "group", "conn"):
            assert np.array_equal(getattr(fj.boundary[fg], k),
                                  getattr(ft.boundary[fg], k)), (fg, k)


def _same_sparse(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data, b.data)


@pytest.mark.parametrize("geom", ["quad", "tri"])
@pytest.mark.parametrize("family", ["linear", "biquadratic"])
def test_prolongation_on_selective_mesh_equals_reference(geom, family):
    """Copied elements (child_slot -1) take the identity block: indexing
    the child blocks with -1 would give them the last child's block."""
    mj, mt, fj, ft = _meshes((3, 3), geom, (0, 4))
    assert (ft.child_slot < 0).any()
    Pt = tprolong(mt, ft, family)
    _same_sparse(jprolong(mj, fj, family), Pt)
    # an unrefined element's dofs keep their coarse values exactly
    cop = np.where(ft.child_slot < 0)[0][0]
    dmf, dmc = ft.dofmap(family), mt.dofmap(family)
    sub = Pt[dmf.conn[cop]][:, dmc.conn[ft.parent_elem[cop]]].toarray()
    assert np.array_equal(sub, np.eye(sub.shape[0]))


@pytest.mark.parametrize("geom,shape,refined", [
    ("quad", (3, 3), (4,)), ("quad", (4, 4), (0, 5, 6)),
    ("tri", (3, 3), (0, 7)), ("hex", (2, 2, 2), (0,))])
def test_refine_selective_equals_reference(geom, shape, refined):
    _, _, fj, ft = _meshes(shape, geom, refined)
    _same_mesh(fj, ft)
    groups = {int(g) for bf in ft.boundary.values() for g in bf.group}
    assert groups == set(range(1, 2 * len(shape) + 1))


@pytest.mark.parametrize("geom,shape,refined", [
    ("quad", (3, 3), (0, 4)), ("tri", (3, 3), (0, 7)),
    ("hex", (2, 2, 2), (0,))])
def test_hanging_constraints_equal_reference(geom, shape, refined):
    _, _, fj, ft = _meshes(shape, geom, refined)
    for family in ("linear", "biquadratic", "disc_linear"):
        Cj, free_j = jamr.hanging_constraints(fj, family)
        Ct, free_t = tamr.hanging_constraints(ft, family)
        assert np.array_equal(free_j, free_t), family
        _same_sparse(Cj, Ct)
        if family != "disc_linear":
            assert Ct.shape[0] > Ct.shape[1], "expected hanging dofs"


def test_close_flags_and_flag_by_error_equal_reference():
    mj, mt, fj, ft = _meshes((4, 4), "quad", (0,))
    flags = np.zeros(ft.n_elems, bool)
    flags[3] = True                       # a level-1 child beside level-0
    closed = tamr.close_flags(ft, flags)
    assert np.array_equal(closed, jamr.close_flags(fj, flags))
    assert closed.sum() > 1
    _same_mesh(jamr.refine_selective(fj, flags),
               tamr.refine_selective(ft, flags))
    err = np.random.default_rng(3).random(40)
    for thr, mode in ((0.4, "absolute"), (0.25, "fraction"),
                      (0.01, "fraction")):
        assert np.array_equal(tamr.flag_by_error(err, thr, mode),
                              jamr.flag_by_error(err, thr, mode))


def test_kelly_indicator_matches_reference():
    _, _, fj, ft = _meshes((4, 4), "quad", (0, 5))
    x = ft.coords[ft.dofmap("biquadratic").nodes]
    u = np.abs(x[:, 0] - 0.4) + np.sin(3 * x[:, 1])
    ej = jsamr.kelly_indicator(fj, "biquadratic", u)
    et = tsamr.kelly_indicator(ft, "biquadratic", u)
    assert np.abs(ej - et).max() <= 1e-12 * np.abs(ej).max()
    assert et.max() > 0


def _exact(xp):
    return lambda x: xp.sin(PI * x[:, 0]) * xp.sin(PI * x[:, 1])


def _problem(pkg):
    """The Poisson problem of tests/test_mg_amr.py in one package."""
    xp = jnp if pkg == "jax" else torch
    ex = _exact(xp)
    form = (jpoisson if pkg == "jax" else tpoisson)(
        "u", "biquadratic", rhs=lambda x: 2 * PI ** 2 * ex(x))
    unk = (JUnknown if pkg == "jax" else TUnknown)("u", "biquadratic")
    return [unk], form, (lambda var, x, grp, t: (True, 0.0))


def _kw(pkg):
    return {"device": "cpu"} if pkg == "torch" else {}


@pytest.mark.parametrize("refined", [(), (0, 1, 5)])
def test_solve_conforming_matches_reference(refined):
    """u to 1e-10 and equal iteration counts, on a uniform mesh (no
    hanging dofs) and on a selectively refined one."""
    out = {}
    for pkg, amr, ub in (("jax", jamr, junit_box), ("torch", tamr,
                                                    tunit_box)):
        m = ub((4, 4), "quad")
        if refined:
            flags = np.zeros(m.n_elems, bool)
            flags[list(refined)] = True
            m = amr.refine_selective(m, flags)
        solve = (jsamr if pkg == "jax" else tsamr).solve_conforming
        out[pkg] = solve(m, *_problem(pkg), **_kw(pkg))
    (uj, ij), (ut, it) = out["jax"], out["torch"]
    assert it["n_hanging"] == ij["n_hanging"]
    assert (it["n_hanging"] > 0) == bool(refined)
    assert it["iterations"] == ij["iterations"]
    assert np.abs(ut - np.asarray(uj)).max() <= 1e-10 * np.abs(uj).max()
    assert it["residual"] < 1e-9


def _chain(cycles):
    """The MG-AMR drive of tests/test_mg_amr.py in both packages:
    ``cycles`` rounds of solve_mg_amr -> Kelly -> flag the worst 30 % ->
    refine_selective.  Both chains refine by the reference's flags: the
    symmetric problem has indicators that tie to rounding, and the worst
    fraction would split such ties differently."""
    meshes = {"jax": [junit_box((4, 4), "quad")],
              "torch": [tunit_box((4, 4), "quad")]}
    out = {"jax": [], "torch": []}
    for cyc in range(cycles + 1):
        for pkg, amr in (("jax", jsamr), ("torch", tsamr)):
            u, info = amr.solve_mg_amr(meshes[pkg], *_problem(pkg),
                                       **_kw(pkg))
            out[pkg].append((np.asarray(u), info))
        if cyc == cycles:
            break
        m = meshes["jax"][-1]
        eta = jsamr.kelly_indicator(
            m, "biquadratic", out["jax"][-1][0][:m.dofmap(
                "biquadratic").n_dofs])
        flags = jamr.flag_by_error(eta, 0.3, "fraction")
        meshes["jax"].append(jamr.refine_selective(m, flags))
        meshes["torch"].append(tamr.refine_selective(meshes["torch"][-1],
                                                     flags))
    return meshes, out


def test_solve_mg_amr_matches_reference():
    meshes, out = _chain(2)
    for a, b in zip(meshes["jax"], meshes["torch"]):
        _same_mesh(a, b)
    assert meshes["torch"][-1].elem_level.max() == 2
    for (uj, ij), (ut, it) in zip(out["jax"], out["torch"]):
        assert it["iterations"] == ij["iterations"]
        assert it["n_levels"] == ij["n_levels"]
        assert np.abs(ut - uj).max() <= 1e-9 * np.abs(uj).max()
        assert it["residual"] < 1e-9
    # below the B1 threshold every level is ELL, the coarsest LU-solved
    routing = out["torch"][-1][1]["routing"]
    assert routing[0]["path"] == "lu"
    assert [r["path"] for r in routing[1:]] == ["ell", "ell"]


def test_amr_loop_matches_reference():
    """Three cycles of the error-driven loop on the 4x4 box with an
    asymmetric source (no tied indicators): equal meshes every cycle, u
    to 1e-10, equal indicators to 1e-12 and iteration counts."""
    res = {}
    for pkg, ub in (("jax", junit_box), ("torch", tunit_box)):
        xp = jnp if pkg == "jax" else torch
        amr = jsamr if pkg == "jax" else tsamr
        unk, _, bc = _problem(pkg)
        form = (jpoisson if pkg == "jax" else tpoisson)(
            "u", "biquadratic",
            rhs=lambda x: 20 * xp.exp(3 * x[:, 0] + 1.3 * x[:, 1]))
        res[pkg] = amr.amr_loop(ub((4, 4), "quad"), unk, form, bc,
                                max_cycles=3, threshold=0.2,
                                mode="fraction", **_kw(pkg))
    assert len(res["torch"]) == len(res["jax"]) == 3
    for rj, rt in zip(res["jax"], res["torch"]):
        _same_mesh(rj.mesh, rt.mesh)
        assert np.abs(rt.u - np.asarray(rj.u)).max() <= 1e-10 * np.abs(
            rj.u).max()
        assert np.abs(rt.eta - rj.eta).max() <= 1e-12 * rj.eta.max()
        assert rt.info["iterations"] == rj.info["iterations"]
    assert res["torch"][-1].mesh.elem_level.max() == 2


def test_reduced_operator_keeps_dirichlet_identity():
    """Dirichlet rows and columns of C^T A C are identity after the
    reduction (the restoration runs on the ELL values, before any
    sliced-ELL relayout)."""
    _, mt, _, ft = _meshes((4, 4), "quad", (0, 3, 12, 15))
    asm, C, free_idx, mask_f, sched = tsamr._reduced_system(
        ft, *_problem("torch"), device="cpu")
    u0 = tsamr._start(asm, C, free_idx, torch.float64, torch.device("cpu"))
    A, Rr, _ = tsamr._reduced_op(asm, C, free_idx, mask_f, sched, u0)
    Ad = A.to_dense().numpy()
    assert mask_f.any()
    sub = Ad[mask_f]
    assert np.array_equal(sub[:, mask_f], np.eye(int(mask_f.sum())))
    assert not sub[:, ~mask_f].any() and not Ad[~mask_f][:, mask_f].any()
    assert not Rr.numpy()[mask_f].any()
    assert np.abs(Ad - Ad.T).max() < 1e-12
