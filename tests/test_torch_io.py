"""Port parity of the writers (``femus_tpu_torch/io``): the files are byte
for byte femus_tpu's for the same mesh and fields, and the read-backs
equal.

Cases: VTU through ``VTKWriter`` on quad, tri, hex, tet and wedge meshes
(the cases of ``tests/test_dia_io.py``) and on a Q2/Q2/P1dc cavity
(``nodal_field``'s disc_linear branch); ``write_parallel``'s pieces and
``.pvtu`` on an RCB partition; GMV in 2-D and 3-D and XDMF with its time
series (the cases of ``tests/test_writers.py``); ``build_writer``.  Field
values are handed to the port as torch tensors, to JAX's as numpy arrays.
"""
import importlib
import os

import numpy as np
import pytest
import torch

from femus_tpu.io import build_writer as jbuild_writer
from femus_tpu.io import gmv as jgmv
from femus_tpu.io import vtk as jvtk
from femus_tpu.io import xdmf as jxdmf
from femus_tpu_torch.io import build_writer as tbuild_writer
from femus_tpu_torch.io import gmv as tgmv
from femus_tpu_torch.io import vtk as tvtk
from femus_tpu_torch.io import xdmf as txdmf


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


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _ml_sol(pkg, geom="quad", n=(3, 3), fields=(("u", "biquadratic"),
                                                ("p", "disc_constant"))):
    """A one-level MultiLevelSolution of ``pkg`` with seeded fields."""
    mesh = _mod(pkg, "mesh.generation").unit_box(n, geom)
    ml = _mod(pkg, "mesh.multilevel").MultiLevelMesh(mesh, 1)
    sol = _mod(pkg, "systems.solution").MultiLevelSolution(ml)
    for i, (name, fam) in enumerate(fields):
        sol.add_solution(name, fam)
        v = sol.sol[0][name]
        v[:] = np.random.default_rng(i).standard_normal(v.shape)
    return sol


def _same_files(dir_a, dir_b, names):
    for name in names:
        a = open(os.path.join(dir_a, name), "rb").read()
        b = open(os.path.join(dir_b, name), "rb").read()
        assert a == b, name


@pytest.mark.parametrize("geom", ["quad", "tri", "hex", "tet", "wedge"])
def test_vtk_writer_files_equal_jax(tmp_path, geom):
    dim = 2 if geom in ("quad", "tri") else 3
    fields = (("u", "biquadratic"), ("p", "linear"))
    js = _ml_sol("femus_tpu", geom, (2,) * dim, fields)
    ts = _ml_sol("femus_tpu_torch", geom, (2,) * dim, fields)
    for order in ("biquadratic", "quadratic", "linear"):
        pj = jvtk.VTKWriter(js).write(str(tmp_path / "j"), step=3,
                                      order=order)
        pt = tvtk.VTKWriter(ts).write(str(tmp_path / "t"), step=3,
                                      order=order)
        assert os.path.basename(pj) == os.path.basename(pt)
        _same_files(tmp_path / "j", tmp_path / "t", ["sol_00003.vtu"])
    # the nodal lift of each family, from a tensor
    mesh_j, mesh_t = js.ml_mesh.levels[0], ts.ml_mesh.levels[0]
    for name, fam in fields:
        got = tvtk.nodal_field(mesh_t, fam, torch.as_tensor(ts.sol[0][name]))
        np.testing.assert_array_equal(
            got, jvtk.nodal_field(mesh_j, fam, js.sol[0][name]))


def test_vtk_writer_cavity_disc_linear(tmp_path):
    """Q2/Q2/P1dc fields: the disc_linear pressure painted per element."""
    fields = (("u", "biquadratic"), ("v", "biquadratic"),
              ("p", "disc_linear"))
    js = _ml_sol("femus_tpu", fields=fields, n=(4, 4))
    ts = _ml_sol("femus_tpu_torch", fields=fields, n=(4, 4))
    jvtk.VTKWriter(js).write(str(tmp_path / "j"))
    tvtk.VTKWriter(ts).write(str(tmp_path / "t"), "u", "v", "p")
    _same_files(tmp_path / "j", tmp_path / "t", ["sol.vtu"])
    mesh = ts.ml_mesh.levels[0]
    got = tvtk.nodal_field(mesh, "disc_linear", torch.as_tensor(
        ts.sol[0]["p"]))
    np.testing.assert_array_equal(got, jvtk.nodal_field(
        js.ml_mesh.levels[0], "disc_linear", js.sol[0]["p"]))
    # a discontinuous field: the element's own value at its centre node
    c = mesh.conn[:, 8]
    np.testing.assert_allclose(got[c[-1]], ts.sol[0]["p"].reshape(
        mesh.n_elems, 3)[-1, 0], rtol=1e-14)


def test_parallel_pieces_equal_jax(tmp_path):
    from femus_tpu.mesh.generation import unit_box as jub
    from femus_tpu.parallel.partition import partition_mesh as jpart
    from femus_tpu_torch.mesh.generation import unit_box as tub
    from femus_tpu_torch.parallel.partition import partition_mesh as tpart
    jm, ji = jpart(jub((6, 6), "quad"), 4, method="rcb")
    tm, ti = tpart(tub((6, 6), "quad"), 4, method="rcb")
    np.testing.assert_array_equal(ji.elem_shard, ti.elem_shard)
    u = tm.coords[:, 0] + 2.0 * tm.coords[:, 1]
    p = np.arange(tm.n_elems, dtype=float)
    jvtk.write_parallel(str(tmp_path / "j" / "out"), jm, ji.elem_shard,
                        point_data={"u": u}, cell_data={"p": p})
    tvtk.write_parallel(str(tmp_path / "t" / "out"), tm,
                        torch.as_tensor(ti.elem_shard),
                        point_data={"u": torch.as_tensor(u)},
                        cell_data={"p": torch.as_tensor(p)})
    names = ["out.pvtu"] + [f"out_{s:04d}.vtu" for s in range(4)]
    _same_files(tmp_path / "j", tmp_path / "t", names)


@pytest.mark.parametrize("dim", [2, 3])
def test_gmv_files_and_readback_equal_jax(tmp_path, dim):
    geom = "quad" if dim == 2 else "hex"
    js = _ml_sol("femus_tpu", geom, (3,) * dim)
    ts = _ml_sol("femus_tpu_torch", geom, (3,) * dim)
    mj, mt = js.ml_mesh.levels[0], ts.ml_mesh.levels[0]
    for order in ("quadratic", "linear"):
        pd_j = {"u": jvtk.nodal_field(mj, "biquadratic", js.sol[0]["u"])}
        pd_t = {"u": torch.as_tensor(tvtk.nodal_field(mt, "biquadratic",
                                                      ts.sol[0]["u"]))}
        part = np.arange(mt.n_elems) % 3
        pj = jgmv.write_gmv(str(tmp_path / f"j{order}.gmv"), mj,
                            point_data=pd_j, cell_data={"p": js.sol[0]["p"]},
                            order=order, partition=part)
        pt = tgmv.write_gmv(str(tmp_path / f"t{order}.gmv"), mt,
                            point_data=pd_t,
                            cell_data={"p": torch.as_tensor(ts.sol[0]["p"])},
                            order=order, partition=torch.as_tensor(part))
        assert open(pj, "rb").read() == open(pt, "rb").read()
        ref, got = jgmv.read_gmv(pj), tgmv.read_gmv(pt)
        for a, b in zip(ref[:2], got[:2]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ref[2:], got[2:]):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    # the writer facade (disc_constant as cell data)
    tgmv.GMVWriter(ts).write(str(tmp_path / "wt"), step=1)
    jgmv.GMVWriter(js).write(str(tmp_path / "wj"), step=1)
    _same_files(tmp_path / "wj", tmp_path / "wt", ["sol_00001.gmv"])
    with pytest.raises(ValueError, match="not a GMV file"):
        tgmv.read_gmv(_not_gmv(tmp_path))


def _not_gmv(tmp_path):
    p = tmp_path / "bad.gmv"
    p.write_bytes(b"notagmv!" + bytes(64))
    return str(p)


def _h5_equal(pj, pt):
    """The XDMF light data byte for byte; the heavy data: the same groups
    and datasets, equal values and dtypes (and the .h5 bytes too)."""
    assert open(pj).read() == open(pt).read()
    hj = pj[:-4] + ".h5"
    ht = pt[:-4] + ".h5"
    assert open(hj, "rb").read() == open(ht, "rb").read()
    rj, rt = jxdmf.read_xdmf_h5(pj), txdmf.read_xdmf_h5(pt)
    assert rj.keys() == rt.keys()
    for g in rj:
        assert rj[g].keys() == rt[g].keys()
        for k in rj[g]:
            assert rj[g][k].dtype == rt[g][k].dtype
            np.testing.assert_array_equal(rj[g][k], rt[g][k])


def test_xdmf_and_time_series_equal_jax(tmp_path):
    js = _ml_sol("femus_tpu")
    ts = _ml_sol("femus_tpu_torch")
    mj, mt = js.ml_mesh.levels[0], ts.ml_mesh.levels[0]
    pj = jxdmf.write_xdmf(str(tmp_path / "j" / "out.xmf"), mj,
                          point_data={"u": jvtk.nodal_field(
                              mj, "biquadratic", js.sol[0]["u"])},
                          cell_data={"p": js.sol[0]["p"]})
    pt = txdmf.write_xdmf(str(tmp_path / "t" / "out.xmf"), mt,
                          point_data={"u": torch.as_tensor(tvtk.nodal_field(
                              mt, "biquadratic", ts.sol[0]["u"]))},
                          cell_data={"p": torch.as_tensor(ts.sol[0]["p"])})
    _h5_equal(pj, pt)
    # the time series: three steps appended to one master file
    wj, wt = jbuild_writer("xdmf", js), tbuild_writer("xdmf", ts)
    for t in (0.0, 0.5, 1.0):
        js.sol[0]["u"][:] = t
        ts.sol[0]["u"][:] = t
        mj_path = wj.write_series(str(tmp_path / "sj"), "u", "p", time=t)
        mt_path = wt.write_series(str(tmp_path / "st"), "u", "p", time=t)
    _h5_equal(mj_path, mt_path)
    assert open(mt_path).read().count('<Grid Name="t') == 3
    np.testing.assert_allclose(
        txdmf.read_xdmf_h5(mt_path)["t00002"]["u"], 1.0)


def test_build_writer_equal_jax(tmp_path):
    js = _ml_sol("femus_tpu")
    ts = _ml_sol("femus_tpu_torch")
    for kind, suffix, name in (("vtk", ".vtu", "sol.vtu"),
                               ("gmv", ".gmv", "sol.gmv"),
                               ("xdmf", ".xmf", "sol.xmf")):
        pj = jbuild_writer(kind, js).write(str(tmp_path / "j" / kind))
        pt = tbuild_writer(kind.upper(), ts).write(str(tmp_path / "t" / kind))
        assert pt.endswith(suffix) and os.path.basename(pj) == name
        _same_files(tmp_path / "j" / kind, tmp_path / "t" / kind, [name])
    with pytest.raises(ValueError, match="unknown writer"):
        tbuild_writer("nope", ts)
