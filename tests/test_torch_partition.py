"""Port parity: element partitioning (``parallel/partition.py``) against
femus_tpu, on the host.

For the three partitioners (RCB, dual-graph, contiguous) and the two-level
(node x card) split, the PartitionInfo arrays and the reordered meshes
(coordinates, connectivity, groups, lineage, boundary faces) are EQUAL to
the JAX package's; ``impl`` records the native library.
"""
import numpy as np
import pytest

from femus_tpu.mesh import generation as jgen
from femus_tpu.mesh.refine import refine as jrefine
from femus_tpu.parallel import partition as jpart
from femus_tpu_torch.mesh import generation as tgen
from femus_tpu_torch.mesh.refine import refine as trefine
from femus_tpu_torch.parallel import partition as tpart

MESHES = [("quad", (10, 7)), ("tri", (6, 5)), ("hex", (3, 4, 3))]


def _meshes(geom, ns, refined):
    j, t = jgen.unit_box(ns, geom), tgen.unit_box(ns, geom)
    if refined:
        j, t = jrefine(j), trefine(t)
    return j, t


def _same_mesh(a, b):
    for f in ("coords", "conn", "elem_group", "elem_shard", "parent_elem",
              "child_slot", "elem_level", "elem_material"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=f)
    assert sorted(a.boundary) == sorted(b.boundary)
    for fg in a.boundary:
        for f in ("elem", "iface", "group", "conn"):
            np.testing.assert_array_equal(getattr(a.boundary[fg], f),
                                          getattr(b.boundary[fg], f))


def _same_info(a, b):
    assert (a.n_shards, a.edge_cut, a.dcn_cut, a.ici_cut) == \
        (b.n_shards, b.edge_cut, b.dcn_cut, b.ici_cut)
    for f in ("elem_shard", "elem_offsets", "node_shard"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("geom,ns", MESHES)
@pytest.mark.parametrize("method", ["rcb", "graph", "contiguous"])
@pytest.mark.parametrize("renumber", [True, False])
def test_partition_mesh_equal(geom, ns, method, renumber):
    jm, tm = _meshes(geom, ns, refined=(method == "rcb"))
    jo, ji = jpart.partition_mesh(jm, 4, method, renumber_nodes=renumber)
    to, ti = tpart.partition_mesh(tm, 4, method, renumber_nodes=renumber)
    _same_mesh(jo, to)
    _same_info(ji, ti)
    assert ti.impl == "native"
    assert np.all(np.diff(to.elem_shard) >= 0)


@pytest.mark.parametrize("outer,inner", [("graph", "rcb"), ("rcb", "rcb"),
                                         ("rcb", "graph")])
def test_partition_hierarchical_equal(outer, inner):
    jm, tm = jgen.unit_box((24, 8), "quad"), tgen.unit_box((24, 8), "quad")
    jo, ji = jpart.partition_mesh_hierarchical(jm, 2, 4, outer, inner)
    to, ti = tpart.partition_mesh_hierarchical(tm, 2, 4, outer, inner)
    _same_mesh(jo, to)
    _same_info(ji, ti)
    assert ti.n_shards == 8 and ti.dcn_cut + ti.ici_cut == ti.edge_cut
    assert ti.dcn_cut <= ti.ici_cut
