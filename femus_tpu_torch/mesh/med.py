"""SALOME MED (HDF5) coarse-mesh reader.

Equivalent of the reference ``MED_IO`` (MED_IO.hpp:53, MED_IO.cpp):

- HDF5 layout (MED_IO.cpp:45-55): ``ENS_MAA/<mesh>/<ts>/NOE/COO`` coordinates
  (no-interlace: x-block, y-block, z-block), ``MAI/<TYPE>/NOD`` connectivity
  (node-major: all elements' node 0, then node 1, ..., 1-based,
  MED_IO.cpp:1035-1038), ``MAI/<TYPE>/FAM`` per-cell family ids, and
  ``FAS/<mesh>/ELEME/FAM_<med>_<name>_<flag>_<prop>`` group directories whose
  underscore-separated numbers are (salome family id, user group flag, user
  material/property) (MED_IO.cpp:1096-1112).
- MED->native node reordering from the MEDToFemusVertexIndex tables
  (MED_IO.cpp:101-117) composed with our hex face-center convention
  (mesh/gambit.py).
- Volume cells of the highest dimension become the mesh; cells one dimension
  lower become labeled boundary faces (set_elem_group_ownership_boundary,
  MED_IO.cpp:322-330), matched to owning elements by corner sets.

Lower-order files are completed to biquadratic like the reference's
``AddBiquadraticNodesNotInMeshFile`` (shared helper in gambit.py).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..fe.geom import GEOMS
from .gambit import _MY_FROM_FEMUS_HEX, _NN_TO_FAMILY, _complete_biquadratic
from .mesh import BoundaryFaces, Mesh, fix_orientation

# MED cell type name -> (geom, n_nodes)
_MED_TYPES = {
    "SE2": ("edge", 2), "SE3": ("edge", 3),
    "TR3": ("tri", 3), "TR6": ("tri", 6), "TR7": ("tri", 7),
    "QU4": ("quad", 4), "QU8": ("quad", 8), "QU9": ("quad", 9),
    "TE4": ("tet", 4), "T10": ("tet", 10),
    "HE8": ("hex", 8), "H20": ("hex", 20), "H27": ("hex", 27),
    "PE6": ("wedge", 6), "P15": ("wedge", 15), "P18": ("wedge", 18),
}
_GEOM_DIM = {"edge": 1, "tri": 2, "quad": 2, "tet": 3, "hex": 3, "wedge": 3}

# femus node index of each MED list position, biquadratic order. For hex
# this is MEDToFemusVertexIndex (MED_IO.cpp:101-117); for the other
# geometries MED's role layout (corners, edge midpoints, face centers,
# center) coincides with ours position-by-position, so the map is identity —
# element *orientation* is normalized separately (SALOME emits mixed
# clockwise/counterclockwise cells; see mesh.fix_orientation).
_MED2FEMUS = {
    "hex": [4, 7, 3, 0, 5, 6, 2, 1, 15, 19, 11, 16, 13, 18, 9, 17,
            12, 14, 10, 8, 23, 25, 22, 24, 20, 21, 26],
    "tet": list(range(10)),
    "wedge": list(range(18)),
    "quad": list(range(9)),
    "tri": list(range(7)),
    "edge": list(range(3)),
}


def _med_perm(geom: str, nn: int) -> np.ndarray:
    """Permutation p with my_conn[:, i] = med_conn[:, p[i]]."""
    femus_from_med = _MED2FEMUS[geom]
    my_from_femus = (_MY_FROM_FEMUS_HEX if geom == "hex"
                     else list(range(len(femus_from_med))))
    pos_of_femus = {f: p for p, f in enumerate(femus_from_med) if f < nn}
    return np.array([pos_of_femus[f] for f in my_from_femus if f in
                     pos_of_femus], int)


def _parse_group_dir(name: str) -> Tuple[int, int, int]:
    """'FAM_-7_Group_2_1' -> (med flag -7, user flag 2, property 1)
    (MED_IO.cpp get_group_flags_per_mesh:1096-1112)."""
    nums = re.findall(r"_(-?\d+)", name)
    med = int(nums[0]) if nums else 0
    flag = int(nums[1]) if len(nums) > 1 else 0
    prop = int(nums[2]) if len(nums) > 2 else 0
    return med, flag, prop


def read_med(path: str, mesh_name: Optional[str] = None,
             scale: float = 1.0) -> Mesh:
    import h5py
    with h5py.File(path, "r") as f:
        if mesh_name is None:
            mesh_name = sorted(f["ENS_MAA"].keys())[0]
        mgrp = f["ENS_MAA"][mesh_name]
        ts = sorted(mgrp.keys())[0]
        tgrp = mgrp[ts]
        space_dim = int(mgrp.attrs.get("ESP", mgrp.attrs.get("DIM", 3)))

        coo = np.asarray(tgrp["NOE"]["COO"])
        n_nodes = coo.size // space_dim
        coords = coo.reshape(space_dim, n_nodes).T.copy()

        # cells by type
        cells: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for tname, tgrp_c in tgrp["MAI"].items():
            if tname not in _MED_TYPES:
                continue
            geom, nn = _MED_TYPES[tname]
            nod = np.asarray(tgrp_c["NOD"])
            nel = nod.size // nn
            conn_med = nod.reshape(nn, nel).T - 1          # node-major, 1-based
            fam = (np.asarray(tgrp_c["FAM"]) if "FAM" in tgrp_c
                   else np.zeros(nel, np.int32))
            cells[tname] = (conn_med, fam)

        # group info: med family id -> (user flag, property)
        fam_info: Dict[int, Tuple[int, int]] = {}
        fas = f.get(f"FAS/{mesh_name}/ELEME")
        if fas is not None:
            for gname, ggrp in fas.items():
                med = int(ggrp.attrs.get("NUM", _parse_group_dir(gname)[0]))
                _, flag, prop = _parse_group_dir(gname)
                fam_info[med] = (flag, prop)

    # volume type = highest-dimension geometry present
    vol_types = [t for t in cells if _GEOM_DIM[_MED_TYPES[t][0]] ==
                 max(_GEOM_DIM[_MED_TYPES[t][0]] for t in cells)]
    if len(vol_types) != 1:
        # hybrid mesh (reference per-element types, Elem.hpp:45; e.g. the
        # shipped 00_salome/2d/zzz_hybrid_meshes): one block per cell type
        return _read_med_mixed(vol_types, cells, fam_info, coords, scale)
    vt = vol_types[0]
    geom, nn = _MED_TYPES[vt]
    dim = _GEOM_DIM[geom]
    conn_med, vol_fam = cells[vt]
    conn = conn_med[:, _med_perm(geom, nn)]
    family = _NN_TO_FAMILY[(geom, nn)]
    conn = fix_orientation(geom, conn, coords[:, :dim])

    elem_group = np.zeros(len(conn), np.int32)
    for med, (flag, prop) in fam_info.items():
        elem_group[vol_fam == med] = prop or flag

    conn_bq, coords_bq = _complete_biquadratic(geom, family, conn,
                                               coords[:, :dim])
    mesh = Mesh(dim=dim, geom=geom, coords=coords_bq * scale,
                conn=conn_bq.astype(np.int32), elem_group=elem_group)

    _attach_med_boundary(mesh, cells, fam_info, dim)
    return mesh


def _read_med_mixed(vol_types, cells, fam_info, coords, scale):
    """Hybrid volume cell lists -> MixedMesh: one single-geom block per MED
    cell type over one shared (deduplicated) node array; boundary cells
    attach to whichever block owns the matching element face."""
    from .mixed import MixedMesh

    dim = max(_GEOM_DIM[_MED_TYPES[t][0]] for t in vol_types)
    cur = coords[:, :dim].copy()
    raw = []
    for vt in sorted(vol_types):
        geom, nn = _MED_TYPES[vt]
        conn_med, vol_fam = cells[vt]
        conn = conn_med[:, _med_perm(geom, nn)]
        conn = fix_orientation(geom, conn, cur)
        family = _NN_TO_FAMILY[(geom, nn)]
        elem_group = np.zeros(len(conn), np.int32)
        for med, (flag, prop) in fam_info.items():
            elem_group[vol_fam == med] = prop or flag
        # biquadratic completion grows the SHARED coords sequentially so
        # later blocks can reuse nodes added by earlier ones
        conn_bq, cur = _complete_biquadratic(geom, family, conn, cur)
        raw.append((geom, conn_bq, elem_group))
    # dedupe nodes completion may have duplicated on shared faces
    keys = np.round(cur, 9)
    uniq, idx, inv = np.unique(keys, axis=0, return_index=True,
                               return_inverse=True)
    new_coords = cur[idx] * scale
    remap = inv.astype(np.int32)
    blocks = []
    for geom, conn_bq, elem_group in raw:
        m = Mesh(dim=dim, geom=geom, coords=new_coords,
                 conn=remap[conn_bq].astype(np.int32), elem_group=elem_group)
        # boundary matching needs original node ids inside `cells`: remap the
        # boundary cell lists too (done per block inside _attach: keys are
        # corner node ids, so rebuild a remapped view once)
        cells_r = {t: (remap[np.asarray(c, np.int64)]
                       if _GEOM_DIM[_MED_TYPES[t][0]] == dim - 1 else c, f)
                   for t, (c, f) in cells.items()}
        _attach_med_boundary(m, cells_r, fam_info, dim)
        blocks.append(m)
    return MixedMesh(dim=dim, blocks=blocks)


def _attach_med_boundary(mesh: Mesh, cells, fam_info, dim: int) -> None:
    """Label boundary faces from the (dim-1) MED cell lists: match each MED
    boundary cell's corner set to a volume element face; face connectivity is
    taken from the (biquadratic-complete) volume element so lower-order files
    still get full face nodes."""
    g = GEOMS[mesh.geom]
    # corner-key -> (elem, iface) over all element faces
    face_of: Dict[Tuple[int, ...], Tuple[int, int]] = {}
    for fi, (fg, f_bq) in enumerate(g.faces):
        nvf = GEOMS[fg].n_verts
        corners = np.sort(mesh.conn[:, np.asarray(f_bq[:nvf])], axis=1)
        for e in range(mesh.n_elems):
            face_of[tuple(corners[e])] = (e, fi)

    by_geom: Dict[str, List] = {}
    for tname, (conn_med, fam) in cells.items():
        fgeom, nnf = _MED_TYPES[tname]
        if _GEOM_DIM[fgeom] != dim - 1:
            continue
        nvf = GEOMS[fgeom].n_verts
        perm = _med_perm(fgeom, nnf)
        bconn = conn_med[:, perm]
        for r in range(len(bconn)):
            flag = fam_info.get(int(fam[r]), (0, 0))[0]
            if flag == 0:
                continue
            key = tuple(sorted(int(v) for v in bconn[r, :nvf]))
            if key not in face_of:
                continue                     # internal group surface: skip
            e, fi = face_of[key]
            fg, f_bq = g.faces[fi]
            by_geom.setdefault(fg, []).append(
                (e, fi, flag, mesh.conn[e][np.asarray(f_bq)]))

    mesh.boundary = {}
    for fg, items in by_geom.items():
        items.sort(key=lambda t: (t[0], t[1]))
        mesh.boundary[fg] = BoundaryFaces(
            face_geom=fg,
            elem=np.array([t[0] for t in items], np.int32),
            iface=np.array([t[1] for t in items], np.int32),
            group=np.array([t[2] for t in items], np.int32),
            conn=np.stack([t[3] for t in items]).astype(np.int32))
    if not by_geom:
        from .mesh import build_boundary_faces
        build_boundary_faces(mesh)
