"""Port parity: the mesh readers against femus_tpu, in float64 on the host.

Gambit neutral files (quad9 with four boundary groups, tri6 completed to
biquadratic, hex27, and a hex8 file without boundary sets) are written by
``chip_smoke.write_neu``; SALOME .med files (QU9 with SE3 boundary groups,
a linear QU4/TR3 hybrid, and HE8) are written here with h5py in the layout
``mesh/med.py`` reads.  Both packages read each file and must give EQUAL
arrays.  A Poisson solve on a read mesh agrees with femus_tpu to 1e-12.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_neu
from femus_tpu.assembly.bc import generate_bdc as jbdc
from femus_tpu.assembly.engine import Assembler as JAssembler
from femus_tpu.assembly.engine import Unknown as JUnknown
from femus_tpu.assembly.forms import poisson as jpoisson
from femus_tpu.mesh.gambit import read_neu as jread_neu
from femus_tpu.mesh.med import read_med as jread_med
from femus_tpu_torch.assembly.bc import generate_bdc as tbdc
from femus_tpu_torch.assembly.engine import Assembler as TAssembler
from femus_tpu_torch.assembly.engine import Unknown as TUnknown
from femus_tpu_torch.assembly.forms import poisson as tpoisson
from femus_tpu_torch.mesh.gambit import _PERMS
from femus_tpu_torch.mesh.gambit import read_neu as tread_neu
from femus_tpu_torch.mesh.generation import unit_box
from femus_tpu_torch.mesh.med import _med_perm
from femus_tpu_torch.mesh.med import read_med as tread_med
from femus_tpu_torch.mesh.mixed import mixed_unit_box

h5py = pytest.importorskip("h5py")


def _assert_mesh_equal(a, b):
    assert (a.dim, a.geom) == (b.dim, b.geom)
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.conn, b.conn)
    np.testing.assert_array_equal(a.elem_group, b.elem_group)
    if a.elem_material is None:
        assert b.elem_material is None
    else:
        np.testing.assert_array_equal(a.elem_material, b.elem_material)
    assert sorted(a.boundary) == sorted(b.boundary)
    for fg in a.boundary:
        for f in ("elem", "iface", "group", "conn"):
            np.testing.assert_array_equal(getattr(a.boundary[fg], f),
                                          getattr(b.boundary[fg], f))


@pytest.mark.parametrize("case", ["quad9", "tri6", "hex27", "hex8_no_bc"])
def test_neu_reads_equal(case, tmp_path):
    geom, ns, family, bc = {
        "quad9": ("quad", (3, 2), "biquadratic", True),
        "tri6": ("tri", (2, 2), "serendipity", True),
        "hex27": ("hex", (2, 1, 2), "biquadratic", True),
        "hex8_no_bc": ("hex", (2, 2, 1), "linear", False)}[case]
    mesh = unit_box(ns, geom)
    mesh.elem_group = (np.arange(mesh.n_elems) % 2 + 1).astype(np.int32)
    path = str(tmp_path / f"{case}.neu")
    write_neu(mesh, path, family, boundary=bc)
    jm, tm = jread_neu(path), tread_neu(path)
    _assert_mesh_equal(jm, tm)
    np.testing.assert_array_equal(tm.elem_group, mesh.elem_group)
    if family == "biquadratic":
        # a full-order file reads back as the mesh that was written
        np.testing.assert_array_equal(tm.coords, mesh.coords)
        np.testing.assert_array_equal(tm.conn, mesh.conn)
        _assert_mesh_equal(
            tm, dataclasses.replace(mesh, elem_material=tm.elem_material))
    else:
        # the completion synthesised the missing nodes at the same places
        np.testing.assert_allclose(tm.coords[tm.conn], mesh.coords[mesh.conn],
                                   atol=1e-14)
    if bc:
        groups = {int(g) for bf in tm.boundary.values() for g in bf.group}
        assert groups == set(range(1, 2 * mesh.dim + 1))


def test_perm_tables_are_femus_tpu_s():
    from femus_tpu.mesh.gambit import _PERMS as JPERMS
    assert sorted(JPERMS) == sorted(_PERMS)
    for k in JPERMS:
        np.testing.assert_array_equal(JPERMS[k], _PERMS[k])


# ---- .med files ----------------------------------------------------------

def _med_write(path, coords, cells, fams, groups):
    """A MED file in the layout mesh/med.py reads: ``cells`` MED type ->
    (n, nn) 0-based connectivity, ``fams`` type -> (n,) family ids,
    ``groups`` family id -> group directory name."""
    dim = coords.shape[1]
    with h5py.File(path, "w") as f:
        m = f.create_group("ENS_MAA/box")
        m.attrs["ESP"] = dim
        t = m.create_group("0000000000000000000100000000000000000001")
        t.create_dataset("NOE/COO", data=coords.T.reshape(-1))
        for name, conn in cells.items():
            c = t.create_group(f"MAI/{name}")
            c.create_dataset("NOD", data=(conn + 1).T.reshape(-1))
            c.create_dataset("FAM", data=fams[name])
        for num, gname in groups.items():
            f.create_group(f"FAS/box/ELEME/{gname}").attrs["NUM"] = num


def _boundary_cells(mesh, nvf):
    """(conn, family) of the boundary faces of a generated box: the face
    corner nodes (and, for quadratic faces, the midpoints) with family
    -group."""
    conns, fams = [], []
    for bf in mesh.boundary.values():
        conns.append(bf.conn[:, :nvf])
        fams.append(-bf.group.astype(np.int64))
    return np.concatenate(conns), np.concatenate(fams)


def test_med_quad9_with_groups(tmp_path):
    mesh = unit_box((3, 2))
    bconn, bfam = _boundary_cells(mesh, 3)
    vol_fam = np.where(np.arange(mesh.n_elems) < 3, 3, 4)
    path = str(tmp_path / "quad9.med")
    _med_write(path, mesh.coords, {"QU9": mesh.conn, "SE3": bconn},
               {"QU9": vol_fam, "SE3": bfam},
               {-g: f"FAM_{-g}_Side_{g}_0" for g in range(1, 5)}
               | {3: "FAM_3_Left_0_7", 4: "FAM_4_Right_0_8"})
    jm, tm = jread_med(path), tread_med(path)
    _assert_mesh_equal(jm, tm)
    np.testing.assert_array_equal(tm.elem_group, np.where(vol_fam == 3, 7, 8))
    assert {int(g) for g in tm.boundary["edge"].group} == {1, 2, 3, 4}


def test_med_hex8(tmp_path):
    mesh = unit_box((2, 1, 1), "hex")
    bconn, bfam = _boundary_cells(mesh, 4)
    corners = np.unique(mesh.conn[:, :8])
    remap = np.full(mesh.n_nodes, -1)
    remap[corners] = np.arange(len(corners))
    # MED's own corner order (MEDToFemusVertexIndex)
    conn = remap[mesh.conn[:, :8]]
    med = np.empty_like(conn)
    med[:, _med_perm("hex", 8)] = conn
    path = str(tmp_path / "hex8.med")
    _med_write(path, mesh.coords[corners],
               {"HE8": med, "QU4": remap[bconn]},
               {"HE8": np.zeros(len(conn), int), "QU4": bfam},
               {-g: f"FAM_{-g}_Side_{g}_0" for g in range(1, 7)})
    jm, tm = jread_med(path), tread_med(path)
    _assert_mesh_equal(jm, tm)
    assert len(tm.boundary) == 1 and tm.n_elems == 2
    # the completed hex27 nodes sit where the generated mesh has them
    np.testing.assert_allclose(tm.coords[tm.conn], mesh.coords[mesh.conn],
                               atol=1e-14)


def test_med_hybrid_quad_tri(tmp_path):
    """A linear QU4 + TR3 file reads as a MixedMesh (one block per cell
    type, shared completed nodes) with boundary groups on both blocks."""
    mm = mixed_unit_box((2, 2))
    blocks = {b.geom: b for b in mm.blocks}
    nv = {"quad": 4, "tri": 3}
    corners = np.unique(np.concatenate(
        [blocks[g].conn[:, :nv[g]].ravel() for g in blocks]))
    remap = np.full(len(mm.coords), -1)
    remap[corners] = np.arange(len(corners))
    bconn, bfam = [], []
    for b in mm.blocks:
        c, f = _boundary_cells(b, 2)
        bconn.append(c)
        bfam.append(f)
    bconn, bfam = np.concatenate(bconn), np.concatenate(bfam)
    cells = {"QU4": remap[blocks["quad"].conn[:, :4]],
             "TR3": remap[blocks["tri"].conn[:, :3]],
             "SE2": remap[bconn]}
    path = str(tmp_path / "hybrid.med")
    _med_write(path, mm.coords[corners], cells,
               {"QU4": np.zeros(len(cells["QU4"]), int),
                "TR3": np.full(len(cells["TR3"]), 5),
                "SE2": bfam},
               {-g: f"FAM_{-g}_Side_{g}_0" for g in range(1, 5)}
               | {5: "FAM_5_Tris_0_9"})
    jm, tm = jread_med(path), tread_med(path)
    assert [b.geom for b in jm.blocks] == [b.geom for b in tm.blocks]
    for a, b in zip(jm.blocks, tm.blocks):
        _assert_mesh_equal(a, b)
    assert {int(g) for b in tm.blocks for bf in b.boundary.values()
            for g in bf.group} == {1, 2, 3, 4}


# ---- a solve on a read mesh ---------------------------------------------

def _groups_bc(var, x, grp, t):
    """Dirichlet on the read groups 1 and 3 (x = 0, y = 0), natural on the
    others."""
    return grp in (1, 3), 0.0


def test_poisson_on_read_mesh_matches_jax(tmp_path):
    path = str(tmp_path / "box.neu")
    write_neu(unit_box((4, 3)), path)
    rhs_np = lambda x: 1.0 + x[:, 0] * x[:, 1]             # noqa: E731
    sols = []
    # femus_tpu
    jm = jread_neu(path)
    ja = JAssembler(jm, [JUnknown("u")], quad_order="fifth")
    ja.set_volume_form(jpoisson("u", rhs=rhs_np))
    jbdc(ja, _groups_bc)
    R, data = jax.jit(ja.make_assemble_fn())(jnp.zeros(ja.n_dofs_pad))
    sols.append(_dense_solve(ja.pattern, np.asarray(data), np.asarray(R),
                             ja.n_dofs))
    # the port
    tm = tread_neu(path)
    ta = TAssembler(tm, [TUnknown("u")], quad_order="fifth", device="cpu")
    ta.set_volume_form(tpoisson("u", rhs=rhs_np))
    tbdc(ta, _groups_bc)
    R, data = ta.make_assemble_fn()(torch.zeros(ta.n_dofs,
                                                dtype=torch.float64))
    sols.append(_dense_solve(ta.pattern, data.numpy(), R.numpy(), ta.n_dofs))
    np.testing.assert_array_equal(ja.dirichlet_mask[:ja.n_dofs],
                                  ta.dirichlet_mask)
    assert ta.dirichlet_mask.sum() > 0
    assert np.abs(sols[0] - sols[1]).max() <= 1e-12 * np.abs(sols[0]).max()


def _dense_solve(pattern, data, R, n):
    A = np.zeros((pattern.n_rows, pattern.n_rows))
    rows = np.repeat(np.arange(pattern.n_rows), pattern.width)
    np.add.at(A, (rows, np.asarray(pattern.cols).ravel()), data.ravel())
    return -np.linalg.solve(A[:n, :n], R[:n])
