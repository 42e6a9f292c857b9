"""Port parity: the 3-D (hex) patch operator (``mesh/patches3d.py``,
``algebra/patchstencil3d.py``, the 3-D patch layout of the assembler and
of ``PatchedMultiLevelMesh``) against femus_tpu, in float64 on the host.

On a hex box whose every second element is rotated (so neighbouring patch
frames disagree across faces: D4 face transforms and edge flips), refined
one and two levels: the refined meshes and the plans EQUAL the JAX
package's, ``node_of_3d`` numbers every element node as the mesh does,
the host tables (one-hot routing, owner mask) and the weight slots EQUAL
the JAX package's, and the port's index routing reaches the same dofs.
The assembled stencil weights (after Dirichlet elimination) and the
matvec and diagonal agree with the JAX package's patch operator and with
the port's ELL operator to 1e-12 (the JAX operator at one level); a
System solve with
``operator="patch"`` on a three-level hex hierarchy matches a direct
solve of the ELL system.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from femus_tpu.algebra import patchstencil3d as jps3
from femus_tpu.assembly import bc as jbc
from femus_tpu.assembly import engine as jeng
from femus_tpu.assembly import forms as jforms
from femus_tpu.fe.geom import GEOMS
from femus_tpu.mesh import generation as jgen
from femus_tpu.mesh import patches3d as jp3
from femus_tpu_torch.algebra import patchstencil3d as tps3
from femus_tpu_torch.assembly import bc as tbc
from femus_tpu_torch.assembly import engine as teng
from femus_tpu_torch.assembly import forms as tforms
from femus_tpu_torch.mesh import generation as tgen
from femus_tpu_torch.mesh import patches3d as tp3

pi = np.pi

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



def _rot_perm(R):
    g = GEOMS["hex"]
    tgt = (R @ g.ref_nodes.T).T
    perm = np.empty(g.n_nodes_bq, np.int64)
    for a in range(g.n_nodes_bq):
        d = np.abs(g.ref_nodes - tgt[a]).sum(axis=1)
        perm[a] = np.argmin(d)
    return perm


def _rotated_box(gen, n=(2, 2, 2)):
    Rz = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], float)
    Rx = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], float)
    perms = [_rot_perm(Rz), _rot_perm(Rx), _rot_perm(Rz @ Rx),
             _rot_perm(Rx @ Rx)]
    mesh = gen.unit_box(n, "hex")
    conn = mesh.conn.copy()
    for e in range(mesh.n_elems):
        if e % 2 == 1:
            conn[e] = conn[e][perms[e % len(perms)]]
    mesh.conn = conn
    mesh._dofmaps = {}
    return mesh


@pytest.fixture(scope="module", params=[1, 2])
def refined(request):
    L = request.param
    jm, jplan = jp3.refine_patched_hex(_rotated_box(jgen), L)
    tm, tplan = tp3.refine_patched_hex(_rotated_box(tgen), L)
    return L, jm, jplan, tm, tplan


def test_refine_and_plan_equal(refined):
    _, jm, jplan, tm, tplan = refined
    np.testing.assert_array_equal(jm.conn, tm.conn)
    np.testing.assert_array_equal(jm.coords, tm.coords)
    for f in ("levels", "H", "P", "E", "n_int", "n_faces", "n_edges",
              "n_verts"):
        assert getattr(jplan, f) == getattr(tplan, f), f
    for f in ("elem_patch", "elem_node_lat", "patch_faces", "patch_face_tf",
              "patch_edges", "patch_edge_flip", "patch_verts", "face_sides",
              "edge_sides", "vert_sides"):
        np.testing.assert_array_equal(getattr(jplan, f), getattr(tplan, f))
    assert len(set(tplan.patch_face_tf.ravel())) > 1   # D4 transforms hit
    assert tplan.patch_edge_flip.any()


def test_numbering_consistency(refined):
    _, _, _, tm, tplan = refined
    lat = tplan.elem_node_lat
    for e in range(0, tm.n_elems, 3):
        p = int(tplan.elem_patch[e])
        for a in range(27):
            i, j, k = (int(v) for v in lat[e, a])
            assert tp3.node_of_3d(tplan, p, i, j, k) == tm.conn[e, a]


def test_tables_and_slots_equal(refined):
    _, _, jplan, tm, tplan = refined
    jt = jps3.build_patch_tables_3d(jplan)
    tt = tps3.build_patch_tables_3d(tplan)
    for f in ("H", "P", "Pp", "E", "n_faces", "n_edges", "n_verts", "n"):
        assert getattr(jt, f) == getattr(tt, f), f
    for f in ("G_face_in", "G_face_out", "G_edge_in", "G_edge_out", "M_cs",
              "M_vs", "owner"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f))
    js, jsize = jps3.build_patch_slots_3d(jplan, jt)
    ts, tsize = tps3.build_patch_slots_3d(tplan, tt)
    assert jsize == tsize
    np.testing.assert_array_equal(js, ts)
    # the index routing: every element node at its lattice point, and
    # every skeleton dof's copies in ascending patch order
    lat = tplan.elem_node_lat
    np.testing.assert_array_equal(
        tt.lat_dof[lat[..., 0], lat[..., 1], lat[..., 2],
                   tplan.elem_patch[:, None]], tm.conn)
    assert (tt.lat_dof[..., tt.P:] == tt.n).all()
    cp = tt.copies
    real = cp < tt.H ** 3 * tt.Pp
    np.testing.assert_array_equal(
        tt.lat_dof.reshape(-1)[np.where(real, cp, 0)][real],
        np.broadcast_to(tplan.n_int + np.arange(cp.shape[1]), cp.shape)[real])
    pat = np.where(real, cp % tt.Pp, 1 << 40)
    assert ((np.diff(pat, axis=0) > 0) | ~real[1:]).all()
    n_face = tplan.n_faces * tt.E ** 2
    sides = (tplan.face_sides[:, :, 0] >= 0).sum(axis=1)
    np.testing.assert_array_equal(real[:, :n_face].sum(axis=0),
                                  np.tile(sides, tt.E ** 2))
    assert real[0].all() and (sides == 2).any() and (sides == 1).any()


def _assemblers(L):
    rhs_j = lambda x: (3 * pi ** 2 * jnp.sin(pi * x[:, 0])      # noqa: E731
                       * jnp.sin(pi * x[:, 1]) * jnp.sin(pi * x[:, 2]))
    rhs_t = lambda x: (3 * pi ** 2 * torch.sin(pi * x[:, 0])    # noqa: E731
                       * torch.sin(pi * x[:, 1]) * torch.sin(pi * x[:, 2]))
    jm, jplan = jp3.refine_patched_hex(_rotated_box(jgen), L)
    tm, tplan = tp3.refine_patched_hex(_rotated_box(tgen), L)
    ja = jeng.Assembler(jm, [jeng.Unknown("u")], quad_order="fifth")
    ja.set_volume_form(jforms.poisson("u", "biquadratic", rhs=rhs_j))
    jbc.generate_bdc(ja, lambda var, x, grp, t: (True, 0.0))
    ja.set_patch_layout(jplan)
    out = [ja]
    for patch in (True, False):
        ta = teng.Assembler(tm, [teng.Unknown("u")], quad_order="fifth",
                            device="cpu")
        ta.set_volume_form(tforms.poisson("u", "biquadratic", rhs=rhs_t))
        tbc.generate_bdc(ta, lambda var, x, grp, t: (True, 0.0))
        if patch:
            ta.set_patch_layout(tplan)
        out.append(ta)
    return out


@pytest.mark.parametrize("L", [1, 2])
def test_patch3d_operator_matches_jax_and_ell(L):
    """Against the port's ELL operator at one and two levels, and against
    the JAX package's patch operator at one level (its eager 125-slice
    operator takes seconds per call on the host)."""
    ja, ta, te = _assemblers(L)
    rng = np.random.default_rng(L)
    u = rng.standard_normal(ta.n_dofs)
    tR, td = ta.make_assemble_fn()(torch.as_tensor(u))
    eR, ed = te.make_assemble_fn()(torch.as_tensor(u))
    np.testing.assert_allclose(tR.numpy(), eR.numpy(), rtol=0, atol=1e-12)
    top, eop = ta.op_with(td), te.op_with(ed)
    assert isinstance(top, tps3.PatchStencilOp3D)
    x = rng.standard_normal((2, ta.n_dofs))
    y = [(top @ torch.as_tensor(v)).numpy() for v in x]
    for v, yv in zip(x, y):
        np.testing.assert_allclose(yv, (eop @ torch.as_tensor(v)).numpy(),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(top.diagonal().numpy(),
                               eop.diagonal().numpy(), rtol=0, atol=1e-12)
    if L > 1:
        return
    jR, jd = jax.jit(ja.make_assemble_fn())(jnp.asarray(u))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR)[:ta.n_dofs],
                               rtol=0, atol=1e-12)
    jop = ja.op_with(jd)
    np.testing.assert_allclose(top.wt.numpy(), np.asarray(jop.wt),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(y[0], np.asarray(jop @ jnp.asarray(x[0])),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(top.diagonal().numpy(),
                               np.asarray(jop.diagonal()), rtol=0,
                               atol=1e-12)


def test_patch3d_system_solve():
    """LinearImplicitSystem, operator="patch", coarse_op="rediscretize",
    Chebyshev V-cycle GMRES, on PatchedMultiLevelMesh of a hex box (three
    levels): the solution of the direct ELL solve to the solver's
    tolerance."""
    from femus_tpu_torch.mesh.multilevel import PatchedMultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import LinearImplicitSystem
    rhs = lambda x: (3 * pi ** 2 * torch.sin(pi * x[:, 0])      # noqa: E731
                     * torch.sin(pi * x[:, 1]) * torch.sin(pi * x[:, 2]))
    ml = PatchedMultiLevelMesh(tgen.unit_box((2, 2, 2), "hex"), 3)
    assert isinstance(ml.levels[-1].patch_plan, tp3.PatchPlan3D)
    sol = MultiLevelSolution(ml)
    sol.add_solution("u", "biquadratic")
    sol.initialize("u")
    sol.attach_bc(lambda var, x, grp, t: (True, 0.0))
    sol.generate_bdc("u")
    prob = MultiLevelProblem(ml, sol, quad_order="fifth")
    s = prob.add_system(LinearImplicitSystem, "p3")
    s.add_unknown("u")
    s.set_assembly(tforms.poisson("u", rhs=rhs))
    cfg = s.config
    cfg.operator, cfg.coarse_op = "patch", "rediscretize"
    cfg.smoother, cfg.mg_type, cfg.rtol = "chebyshev", "V", 1e-10
    s.init(device="cpu", dtype=torch.float64)
    assert isinstance(s.assemblers[-1].patch_tab, tps3.PatchTables3D)
    s.solve()
    u = sol.sol[-1]["u"]
    # the direct solve of the same system on the ELL layout
    a = teng.Assembler(ml.levels[-1], [teng.Unknown("u")],
                       quad_order="fifth", device="cpu")
    a.set_volume_form(tforms.poisson("u", rhs=rhs))
    tbc.generate_bdc(a, lambda var, x, grp, t: (True, 0.0))
    R, d = a.make_assemble_fn()(torch.zeros(a.n_dofs, dtype=torch.float64))
    pat = a.pattern
    A = sp.csr_matrix((d.numpy().ravel()[pat.csr_to_ell_slots()],
                       pat.indices, pat.indptr))
    want = spla.spsolve(A.tocsc(), -R.numpy())
    assert np.abs(u - want).max() < 1e-8 * np.abs(want).max()
    assert np.abs(u).max() > 0.5            # a real solution, not zeros
