"""Gambit neutral file (.neu) reader.

Equivalent of the reference ``GambitIO`` (GambitIO.hpp:36, .cpp:95 read;
node-order tables GambitIO.cpp:56-90).  Reads coarse meshes at linear,
serendipity, or biquadratic order, converts node ordering to ours, completes
the mesh to biquadratic by synthesizing missing nodes (reference
``AddBiquadraticNodesNotInMeshFile``, Mesh.hpp:401), and converts BOUNDARY
CONDITIONS sets into labeled boundary faces (group = set name number).

Gambit element type codes: 1 edge, 2 quad, 3 tri, 4 brick, 5 wedge, 6 tet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..fe.basis import get_basis
from ..fe.geom import GEOMS
from .mesh import BoundaryFaces, Mesh, build_boundary_faces

_GTYPE = {1: "edge", 2: "quad", 3: "tri", 4: "hex", 5: "wedge", 6: "tet"}

# FEMuS gambit->femus vertex tables (GambitIO.cpp:56-80) for the biquadratic
# types; our node ordering equals the reference's except hex face centers
# (ours: bottom,top,front,right,back,left = theirs 24,25,20,21,22,23).
_F_HEX27 = [4, 16, 0, 15, 23, 11, 7, 19, 3,
            12, 20, 8, 25, 26, 24, 14, 22, 10,
            5, 17, 1, 13, 21, 9, 6, 18, 2]
_MY_FROM_FEMUS_HEX = list(range(20)) + [24, 25, 20, 21, 22, 23] + [26]
_F_WEDGE18 = [3, 11, 5, 9, 10, 4, 12, 17, 14, 15, 16, 13, 0, 8, 2, 6, 7, 1]


def _perm_from_femus_table(ftable: List[int], my_from_femus: List[int],
                           keep_femus_below: Optional[int] = None) -> np.ndarray:
    """my-order permutation: my node i sits at gambit list position perm[i].

    keep_femus_below: drop gambit entries whose femus index >= bound (to get
    the serendipity/linear subsets of a biquadratic table) and renumber
    positions compactly.
    """
    pairs = [(p, f) for p, f in enumerate(ftable)
             if keep_femus_below is None or f < keep_femus_below]
    pos_of_femus = {}
    for newp, (p, f) in enumerate(pairs):
        pos_of_femus[f] = newp
    out = []
    for my_i, f in enumerate(my_from_femus):
        if f in pos_of_femus:
            out.append(pos_of_femus[f])
    return np.array(out, int)


def _perms() -> Dict[Tuple[str, int], np.ndarray]:
    p: Dict[Tuple[str, int], np.ndarray] = {}
    p[("edge", 2)] = np.array([0, 1])
    p[("edge", 3)] = np.array([0, 2, 1])
    p[("quad", 4)] = np.arange(4)
    p[("quad", 8)] = np.array([0, 2, 4, 6, 1, 3, 5, 7])
    p[("quad", 9)] = np.array([0, 2, 4, 6, 1, 3, 5, 7, 8])
    p[("tri", 3)] = np.arange(3)
    p[("tri", 6)] = np.array([0, 2, 4, 1, 3, 5])
    p[("tet", 4)] = np.arange(4)
    p[("tet", 10)] = np.array([0, 2, 5, 9, 1, 4, 3, 6, 7, 8])
    p[("hex", 27)] = _perm_from_femus_table(_F_HEX27, _MY_FROM_FEMUS_HEX)
    p[("hex", 20)] = _perm_from_femus_table(_F_HEX27, _MY_FROM_FEMUS_HEX, 20)
    p[("hex", 8)] = _perm_from_femus_table(_F_HEX27, _MY_FROM_FEMUS_HEX, 8)
    p[("wedge", 18)] = _perm_from_femus_table(_F_WEDGE18, list(range(18)))
    p[("wedge", 15)] = _perm_from_femus_table(_F_WEDGE18, list(range(18)), 15)
    p[("wedge", 6)] = _perm_from_femus_table(_F_WEDGE18, list(range(18)), 6)
    return p


_PERMS = _perms()

_NN_TO_FAMILY = {
    ("edge", 2): "linear", ("edge", 3): "biquadratic",
    ("quad", 4): "linear", ("quad", 8): "serendipity", ("quad", 9): "biquadratic",
    ("tri", 3): "linear", ("tri", 6): "serendipity", ("tri", 7): "biquadratic",
    ("hex", 8): "linear", ("hex", 20): "serendipity", ("hex", 27): "biquadratic",
    ("tet", 4): "linear", ("tet", 10): "serendipity",
    ("wedge", 6): "linear", ("wedge", 15): "serendipity", ("wedge", 18): "biquadratic",
}


def read_neu(path: str, scale: float = 1.0) -> Mesh:
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0

    def seek(tag):
        nonlocal i
        while i < len(lines) and tag not in lines[i]:
            i += 1
        i += 1

    seek("CONTROL INFO")
    seek("NUMNP")
    numnp, nelem, ngrps, nbsets, ndfcd, _ = map(int, lines[i].split())
    dim = ndfcd
    seek("NODAL COORDINATES")
    coords = np.zeros((numnp, dim))
    for k in range(numnp):
        parts = lines[i + k].split()
        coords[int(parts[0]) - 1] = [float(v) for v in parts[1:1 + dim]]
    i += numnp
    seek("ELEMENTS/CELLS")
    conns: List[np.ndarray] = []
    gtypes: List[int] = []
    row = 0
    while row < nelem:
        parts = lines[i].split()
        i += 1
        eid, gt, nn = int(parts[0]), int(parts[1]), int(parts[2])
        nodes = [int(v) for v in parts[3:]]
        while len(nodes) < nn:
            nodes += [int(v) for v in lines[i].split()]
            i += 1
        conns.append(np.array(nodes, int) - 1)
        gtypes.append(gt)
        row += 1
    assert len(set(gtypes)) == 1, "mixed-type meshes not yet supported"
    geom = _GTYPE[gtypes[0]]
    nn = len(conns[0])
    perm = _PERMS[(geom, nn)]
    family = _NN_TO_FAMILY[(geom, nn)]
    conn = np.stack(conns)[:, perm]                     # my ordering, family order

    # element groups: the GROUP section's *name line* is the group label the
    # reference exposes as GetElementGroup (GambitIO.cpp:298-310 — gr_name is
    # the token after the NFLAGS value, i.e. the line below the header); the
    # MATERIAL field is a separate property (SetElementMaterial)
    elem_group = np.zeros(nelem, np.int32)
    elem_material = np.zeros(nelem, np.int32)
    for _ in range(ngrps):
        seek("ELEMENT GROUP")
        hdr = lines[i].split()
        # GROUP: n ELEMENTS: m MATERIAL: mat NFLAGS: k
        n_in = int(hdr[3])
        mat = int(hdr[5])
        nflags = int(hdr[7]) if len(hdr) > 7 else 1
        try:
            gr_name = int(lines[i + 1].split()[0])
        except (ValueError, IndexError):
            gr_name = int(hdr[1])
        i += 2                                  # header + name line
        # skip the solver-flag line(s): nflags values
        nseen = 0
        while nseen < nflags:
            nseen += len(lines[i].split())
            i += 1
        ids: List[int] = []
        while len(ids) < n_in:
            ids += [int(v) for v in lines[i].split()]
            i += 1
        elem_group[np.array(ids) - 1] = gr_name
        elem_material[np.array(ids) - 1] = mat

    # boundary condition sets -> (elem, gambit face, group)
    bcs: List[Tuple[int, int, int]] = []
    for _ in range(nbsets):
        seek("BOUNDARY CONDITIONS")
        hdr = lines[i].split()
        name, itype, nent = int(hdr[0]), int(hdr[1]), int(hdr[2])
        i += 1
        for k in range(nent):
            e, _t, fidx = map(int, lines[i + k].split()[:3])
            bcs.append((e - 1, fidx - 1, name))
        i += nent

    # complete to biquadratic
    conn_bq, coords_bq = _complete_biquadratic(geom, family, conn, coords)
    mesh = Mesh(dim=dim, geom=geom, coords=coords_bq * scale,
                conn=conn_bq.astype(np.int32), elem_group=elem_group,
                elem_material=elem_material)
    if bcs:
        _attach_bc_faces(mesh, bcs)
    else:
        build_boundary_faces(mesh)
    return mesh


def _complete_biquadratic(geom, family, conn, coords):
    g = GEOMS[geom]
    if family == "biquadratic":
        return conn, coords
    fam_local = g.family_nodes[family]
    missing = [k for k in range(g.n_nodes_bq) if k not in set(fam_local.tolist())]
    if not missing:
        return conn, coords
    b = get_basis(geom, family)
    W = np.asarray(b.eval(g.ref_nodes[missing]))        # (n_missing, nd_family)
    new_pos = np.einsum("mn,end->emd", W, coords[conn])  # (ne, n_missing, dim)
    scale = max(float(np.abs(coords).max()), 1.0)
    keys = np.rint(new_pos / (1e-9 * scale)).astype(np.int64).reshape(-1, coords.shape[1])
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    first = np.full(len(uniq), keys.shape[0], np.int64)
    np.minimum.at(first, inv, np.arange(keys.shape[0]))
    new_coords = new_pos.reshape(-1, coords.shape[1])[first]
    new_ids = coords.shape[0] + inv.reshape(conn.shape[0], len(missing))
    conn_bq = np.zeros((conn.shape[0], g.n_nodes_bq), int)
    conn_bq[:, fam_local] = conn
    conn_bq[:, missing] = new_ids
    return conn_bq, np.vstack([coords, new_coords])


# Gambit face -> our face index per geometry (derived from GambitIO
# GambitToFemusFaceIndex + the reference GeomElem*_faces tables)
_MY_FACE_FROM_GAMBIT = {
    "quad": [0, 1, 2, 3],
    "tri": [0, 1, 2],
    "tet": [0, 1, 2, 3],
    "hex": [2, 0, 4, 1, 5, 3],
    "edge": [0, 1],
    # wedge: resolved by corner-set matching (no reference table exists)
}
_GAMBIT_WEDGE_FACES = [(0, 1, 4, 3), (1, 2, 5, 4), (2, 0, 3, 5), (0, 2, 1), (3, 4, 5)]


def _attach_bc_faces(mesh: Mesh, bcs):
    g = GEOMS[mesh.geom]
    by_geom: Dict[str, list] = {}
    for (e, gf, grp) in bcs:
        if mesh.geom == "wedge":
            # match by corner set: gambit corner k = k-th corner encountered
            # in the gambit node list (appearance order [3,5,4,0,2,1] in our
            # numbering, consistent with the wedge6 table)
            appearance = [3, 5, 4, 0, 2, 1]
            gcorners = _GAMBIT_WEDGE_FACES[gf]
            nodeset = {int(mesh.conn[e, appearance[c]]) for c in gcorners}
            iface = None
            for fi, (fg, f_bq) in enumerate(g.faces):
                nvf = GEOMS[fg].n_verts
                if {int(mesh.conn[e, v]) for v in f_bq[:nvf]} == nodeset:
                    iface = fi
                    break
            assert iface is not None, "wedge BC face not matched"
        else:
            iface = _MY_FACE_FROM_GAMBIT[mesh.geom][gf]
        fg, f_bq = g.faces[iface]
        by_geom.setdefault(fg, []).append(
            (e, iface, grp, mesh.conn[e][np.asarray(f_bq)]))
    mesh.boundary = {}
    for fg, items in by_geom.items():
        items.sort(key=lambda t: (t[0], t[1]))
        mesh.boundary[fg] = BoundaryFaces(
            face_geom=fg,
            elem=np.array([t[0] for t in items], np.int32),
            iface=np.array([t[1] for t in items], np.int32),
            group=np.array([t[2] for t in items], np.int32),
            conn=np.stack([t[3] for t in items]).astype(np.int32),
        )
