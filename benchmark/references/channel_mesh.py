"""The DFG channel's coarse mesh as a Gambit neutral file, in plain NumPy.

A frozen copy of the Turek-style channel that the repository's
``chip_smoke.channel_neu`` writes, made without the program: the
box (0, 2.2) x (0, 0.41) cut into ``nx`` x ``ny`` biquadratic quads, less
the cells whose centroids lie within 0.06 of (0.2, 0.2) in the max norm (at
44 x 8 a square obstacle of 2 x 2 cells, x 0.15-0.25 and y 0.15375-0.25625,
centred at (0.2, 0.205), where the DFG benchmark has a cylinder of radius
0.05 at (0.2, 0.2)).  Boundary groups: 1 inflow
x = 0, 2 outflow x = 2.2, 3 the walls y = 0 and y = 0.41, 4 the obstacle.

The program reads the file with its own Gambit reader; the reference
(``ns_channel.py``) reads it with :func:`read_neu`.  Both sides get the
same file and nothing else.
"""
from __future__ import annotations

import numpy as np

LENGTH, HEIGHT = 2.2, 0.41
OBSTACLE_CENTRE, OBSTACLE_HALF = 0.2, 0.06

# quad corners counter-clockwise from the lower left, then the edge
# midpoints 01, 12, 23, 30 and the centre, in units of half a cell
_Q9_OFF = np.array([[0, 0], [2, 0], [2, 2], [0, 2], [1, 0], [2, 1], [1, 2],
                    [0, 1], [1, 1]])
# Gambit's quad9 order: position of each of the nodes above in the file
_GAMBIT_POS = np.array([0, 2, 4, 6, 1, 3, 5, 7, 8])


def _group(cx: float, cy: float) -> int:
    if cx < 1e-9:
        return 1
    if cx > LENGTH - 1e-9:
        return 2
    if cy < 1e-9 or cy > HEIGHT - 1e-9:
        return 3
    return 4


def channel_mesh(nx: int, ny: int):
    """(coords (N, 2), conn (E, 9) in the order of ``_Q9_OFF``, boundary
    faces (F, 3) of (element, face, group)); face f joins corners f and
    f + 1."""
    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    lower = np.stack([ix.ravel(), iy.ravel()], axis=1)          # cells
    keys = 2 * lower[:, None, :] + _Q9_OFF[None]                # half cells
    cent = (lower + 0.5) * np.array([LENGTH / nx, HEIGHT / ny])
    keep = np.abs(cent - OBSTACLE_CENTRE).max(axis=1) >= OBSTACLE_HALF
    keys = keys[keep]
    uniq, inv = np.unique(keys.reshape(-1, 2), axis=0, return_inverse=True)
    conn = inv.reshape(-1, 9)
    # the arithmetic of the program's box(), so that the coordinates agree
    # with the original writer's to the last bit
    cells = (uniq * 3).astype(np.float64) / 6.0
    coords = np.stack([0.0 + cells[:, 0] * (LENGTH - 0.0) / nx,
                       0.0 + cells[:, 1] * (HEIGHT - 0.0) / ny], axis=1)
    # boundary faces: the corner pairs that only one element holds
    pairs = np.stack([np.sort(conn[:, [f, (f + 1) % 4]], axis=1)
                      for f in range(4)], axis=1)               # (E, 4, 2)
    flat = pairs.reshape(-1, 2)
    _, finv, cnt = np.unique(flat, axis=0, return_inverse=True,
                             return_counts=True)
    once = np.nonzero(cnt[finv.ravel()] == 1)[0]
    faces = []
    for k in once:
        e, f = divmod(int(k), 4)
        mid = coords[conn[e, [f, (f + 1) % 4]]].mean(axis=0)
        faces.append((e, f, _group(*mid)))
    return coords, conn, np.array(faces, np.int64)


def write_neu(path: str, nx: int, ny: int) -> str:
    """Write the channel at ``nx`` x ``ny`` coarse cells to ``path``."""
    coords, conn, faces = channel_mesh(nx, ny)
    gconn = np.empty_like(conn)
    gconn[:, _GAMBIT_POS] = conn + 1
    groups = sorted(set(faces[:, 2].tolist()))
    out = ["        CONTROL INFO 2.4.6", "** GAMBIT NEUTRAL FILE",
           "DFG channel", "PROGRAM:  Gambit  VERSION:  2.4.6", "",
           "     NUMNP     NELEM     NGRPS    NBSETS     NDFCD     NDFVL",
           f"{len(coords):10d}{len(conn):10d}{1:10d}{len(groups):10d}"
           f"{2:10d}{2:10d}", "ENDOFSECTION", "   NODAL COORDINATES 2.4.6"]
    out += [f"{k + 1:10d} {x:.17e} {y:.17e}" for k, (x, y) in
            enumerate(coords)]
    out += ["ENDOFSECTION", "      ELEMENTS/CELLS 2.4.6"]
    for e, row in enumerate(gconn):
        out.append(f"{e + 1:8d}  2  9 " + " ".join(str(v) for v in row[:7]))
        out.append(" " * 15 + " ".join(str(v) for v in row[7:]))
    out += ["ENDOFSECTION", "       ELEMENT GROUP 2.4.6",
            f"GROUP: {1:10d} ELEMENTS: {len(conn):10d} MATERIAL: {2:10d} "
            f"NFLAGS: {1:10d}", f"{0:32d}", "       0"]
    ids = np.arange(1, len(conn) + 1)
    out += [" ".join(f"{v:7d}" for v in ids[k:k + 10])
            for k in range(0, len(ids), 10)]
    out.append("ENDOFSECTION")
    for g in groups:
        sel = faces[faces[:, 2] == g]
        out += [" BOUNDARY CONDITIONS 2.4.6",
                f"{g:>32d}{1:8d}{len(sel):8d}{0:8d}{6:8d}"]
        out += [f"{e + 1:10d}{2:5d}{f + 1:5d}" for e, f, _ in sel]
        out.append("ENDOFSECTION")
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
    return path


def read_neu(path: str):
    """(coords (N, 2), conn (E, 9) in the order of ``_Q9_OFF``, boundary
    faces (F, 3) of (element, face, group)) of a quad9 Gambit file."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    head = lines.index("     NUMNP     NELEM     NGRPS    NBSETS     NDFCD"
                       "     NDFVL")
    n_nodes, n_elems = (int(v) for v in lines[head + 1].split()[:2])
    at = lines.index("   NODAL COORDINATES 2.4.6") + 1
    coords = np.array([[float(v) for v in ln.split()[1:3]]
                       for ln in lines[at:at + n_nodes]])
    at = lines.index("      ELEMENTS/CELLS 2.4.6") + 1
    conn = []
    while len(conn) < n_elems:
        toks = lines[at].split()
        at += 1
        ids = [int(v) for v in toks[3:]]
        while len(ids) < int(toks[2]):
            ids += [int(v) for v in lines[at].split()]
            at += 1
        if int(toks[1]) != 2 or len(ids) != 9:
            raise ValueError("read_neu: quad9 elements only")
        conn.append(ids)
    conn = np.array(conn, np.int64)[:, _GAMBIT_POS] - 1
    faces = []
    for k, ln in enumerate(lines):
        if ln.strip() != "BOUNDARY CONDITIONS 2.4.6":
            continue
        hdr = lines[k + 1].split()
        g, n = int(hdr[0]), int(hdr[2])
        for row in lines[k + 2:k + 2 + n]:
            e, _, f = (int(v) for v in row.split())
            faces.append((e - 1, f - 1, g))
    return coords, conn, np.array(faces, np.int64)
