"""Port parity of mixed element-type meshes and their assembly.

``mesh.fix_orientation``, ``mesh.boundary_node_groups`` and
``mesh/mixed.py`` (``MixedMesh``, ``build_global_dofmaps``, ``_face_key``,
``merge_meshes``, ``mixed_unit_box``) are the port's own copies: their
arrays are EQUAL to the JAX package's.  ``MixedAssembler`` (one Assembler
per geometry block over the global numbering, one union ELL pattern,
Dirichlet elimination once at the union level) builds the JAX package's
union pattern and assembles its values to 1e-12; a Jacobi-CG solve of the
hybrid Poisson problem converges at the biquadratic order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femus_tpu.assembly.engine as jeng
import femus_tpu.assembly.forms as jforms
import femus_tpu.assembly.mixed as jmixed
import femus_tpu.mesh.generation as jgen
import femus_tpu.mesh.mesh as jmesh
import femus_tpu.mesh.mixed as jmm
import femus_tpu_torch.assembly.engine as teng
import femus_tpu_torch.assembly.forms as tforms
import femus_tpu_torch.assembly.mixed as tmixed
import femus_tpu_torch.assembly.norms as tnorms
import femus_tpu_torch.mesh.generation as tgen
import femus_tpu_torch.mesh.mesh as tmesh
import femus_tpu_torch.mesh.mixed as tmm
from femus_tpu_torch.algebra.krylov import cg

pi = np.pi


@pytest.mark.parametrize("ns,geom", [((3, 2), "quad"), ((3, 2), "tri"),
                                     ((2, 2, 1), "hex"), ((4,), "edge")])
def test_fix_orientation_equal(ns, geom):
    """Elements flipped by the mirror permutation are flipped back, in both
    packages alike; an embedded surface mesh is left as it is."""
    m = jgen.unit_box(ns, geom)
    flip = np.array(jmesh._FLIP[geom][:m.conn.shape[1]], int)
    assert tmesh._FLIP == jmesh._FLIP
    conn = m.conn.copy()
    conn[::2] = conn[::2][:, flip]
    out_j = jmesh.fix_orientation(geom, conn, m.coords)
    out_t = tmesh.fix_orientation(geom, conn, m.coords)
    np.testing.assert_array_equal(out_t, out_j)
    assert not np.array_equal(out_t, conn)
    if geom == "quad":
        c3 = np.c_[m.coords, np.zeros(m.n_nodes)]
        assert tmesh.fix_orientation(geom, conn, c3) is conn


@pytest.mark.parametrize("ns", [(3, 2), (2, 2, 2)])
def test_boundary_node_groups_equal(ns):
    gj = jmesh.boundary_node_groups(jgen.unit_box(ns))
    gt = tmesh.boundary_node_groups(tgen.unit_box(ns))
    assert gj.keys() == gt.keys() and len(gt) == 2 * len(ns)
    for k in gj:
        np.testing.assert_array_equal(gt[k], gj[k])


def _blocks_equal(mj, mt):
    assert mt.dim == mj.dim and mt.geoms == mj.geoms
    assert (mt.n_nodes, mt.n_elems) == (mj.n_nodes, mj.n_elems)
    np.testing.assert_array_equal(mt.coords, mj.coords)
    for bj, bt in zip(mj.blocks, mt.blocks):
        assert bt.coords is mt.coords          # one shared node array
        for f in ("conn", "elem_group"):
            np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f))
        assert bt.boundary.keys() == bj.boundary.keys()
        for k in bj.boundary:
            for f in ("elem", "iface", "group", "conn"):
                np.testing.assert_array_equal(getattr(bt.boundary[k], f),
                                              getattr(bj.boundary[k], f))


@pytest.mark.parametrize("ns,geoms", [((4, 4), ("quad", "tri")),
                                      ((2, 2, 2), ("hex", "wedge"))])
def test_mixed_unit_box_and_dofmaps_equal(ns, geoms):
    mj = jmm.mixed_unit_box(ns, geoms)
    mt = tmm.mixed_unit_box(ns, geoms)
    _blocks_equal(mj, mt)
    for fam in ("biquadratic", "linear", "disc_linear", "disc_constant"):
        assert (tmm.build_global_dofmaps(mt, fam)
                == jmm.build_global_dofmaps(mj, fam))
        for bj, bt in zip(mj.blocks, mt.blocks):
            dj, dt = bj.dofmap(fam), bt.dofmap(fam)
            assert dt.n_dofs == dj.n_dofs
            for f in ("conn", "nodes", "node_to_dof"):
                np.testing.assert_array_equal(getattr(dt, f),
                                              getattr(dj, f))
    # the glue interface left no boundary face behind
    keys = [{tmm._face_key(c, fg) for fg, bf in b.boundary.items()
             for c in bf.conn} for b in mt.blocks]
    assert not keys[0] & keys[1]
    assert tmm._face_key(np.array([5, 2, 9]), "edge") == \
        jmm._face_key(np.array([5, 2, 9]), "edge") == (2, 5)


def test_merge_meshes_equal():
    a_j = jgen.box((2, 3), [(0.0, 1.0), (0.0, 1.0)], "tri")
    b_j = jgen.box((3, 3), [(1.0, 2.0), (0.0, 1.0)], "quad")
    a_t = tgen.box((2, 3), [(0.0, 1.0), (0.0, 1.0)], "tri")
    b_t = tgen.box((3, 3), [(1.0, 2.0), (0.0, 1.0)], "quad")
    _blocks_equal(jmm.merge_meshes(a_j, b_j), tmm.merge_meshes(a_t, b_t))


def _exact(x, xp):
    return xp.sin(pi * x[:, 0]) * xp.sin(pi * x[:, 1])


def _mixed_pair(ns):
    aj = jmixed.MixedAssembler(jmm.mixed_unit_box(ns),
                               [jeng.Unknown("u", "biquadratic")])
    at = tmixed.MixedAssembler(tmm.mixed_unit_box(ns),
                               [teng.Unknown("u", "biquadratic")],
                               dtype=torch.float64, device="cpu")
    aj.set_volume_form(jforms.poisson(
        "u", rhs=lambda x: 2 * pi ** 2 * _exact(x, jnp)))
    at.set_volume_form(tforms.poisson(
        "u", rhs=lambda x: 2 * pi ** 2 * _exact(x, torch)))
    bc = lambda var, x, grp, t: (True, 0.0)     # noqa: E731
    jmixed.generate_bdc_mixed(aj, bc)
    tmixed.generate_bdc_mixed(at, bc)
    return aj, at


def test_mixed_assembler_matches_jax():
    aj, at = _mixed_pair((4, 4))
    assert at.n_dofs == aj.n_dofs and at.offsets == aj.offsets
    for f in ("cols", "valid", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(at.pattern, f),
                                      getattr(aj.pattern, f))
    np.testing.assert_array_equal(at.dirichlet_mask,
                                  aj.dirichlet_mask[:aj.n_dofs])
    np.testing.assert_array_equal(at.dirichlet_values,
                                  aj.dirichlet_values[:aj.n_dofs])
    for rj, rt in zip(aj.remaps, at.remaps):
        oob_j = aj.pattern.n_rows * aj.pattern.width
        np.testing.assert_array_equal(np.minimum(np.asarray(rj), oob_j),
                                      rt.numpy())
    # the blocks keep no elimination of their own
    assert not any(s.dirichlet_mask.any() for s in at.subs)
    u = np.random.default_rng(5).standard_normal(at.n_dofs)
    Rj, Dj = jax.jit(aj.make_assemble_fn())(
        jnp.asarray(np.r_[u, np.zeros(aj.n_dofs_pad - aj.n_dofs)]))
    Rt, Dt = at.make_assemble_fn()(torch.as_tensor(u))
    for ref, out in ((np.asarray(Rj)[:at.n_dofs], Rt), (np.asarray(Dj), Dt)):
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
    A = at.op_with(Dt)
    # the union operator is symmetric (Laplace after symmetric elimination)
    dense = A.to_dense().numpy()
    assert np.abs(dense - dense.T).max() < 1e-11 * np.abs(dense).max()


def test_mixed_poisson_converges():
    """Jacobi-CG on the hybrid quad+tri Poisson problem at 4x4 and 8x8:
    the L2 error falls at the biquadratic order (the gate of
    tests/test_mixed_mesh.py's slow convergence test)."""
    errs = []
    for ns in (4, 8):
        _, at = _mixed_pair((ns, ns))
        R, data = at.make_assemble_fn()(torch.zeros(at.n_dofs,
                                                    dtype=torch.float64))
        A = at.op_with(data)
        d = A.diagonal()
        u, info = cg(A.matvec, -R, M=lambda r: r / d, tol=1e-12,
                     maxiter=2000)
        assert info.converged
        errs.append(np.sqrt(sum(tnorms.error_norms(
            s.mesh, "biquadratic", u, lambda x: _exact(x, torch),
            device="cpu")[0] ** 2 for s in at.subs)))
    assert np.log2(errs[0] / errs[1]) > 2.5, errs
