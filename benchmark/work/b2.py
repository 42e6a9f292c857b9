"""The least work of one matvec of a patch operator (kernel B2's class),
from its shapes.  A frozen copy of the repository's
``chip_smoke.patch_kernel_work`` (checked against the plain window of
the stencil): the weights whose window position lies inside the H x H
lattice (a weight on the zero ring multiplies zero and is not read), each
read once; x read once and y written once; the int32 entries of the four
routing tables read once; two flops a weight.  Padding patches beyond P
are not counted."""

# the biquadratic patch stencil: offsets (di, dj) of -2..2 each
OFFSETS = [(di, dj) for di in range(-2, 3) for dj in range(-2, 3)]


def work(op, x):
    """(bytes, flops, dtype) of ``y = A x`` for ``op`` (``meta`` = H, P,
    Pp, E, n_edges, n_verts, n; ``nv`` variables of n rows each)."""
    H, P, n = op.meta[0], op.meta[1], op.meta[6]
    nv, isz = op.nv, op.wt.element_size()
    rt = op.routing
    tables = sum(int(t.numel()) for t in (rt.face_code, rt.corner_vert,
                                           rt.edge_sides, rt.vert_sides))
    weights = nv * nv * P * sum((H - abs(di)) * (H - abs(dj))
                                for di, dj in OFFSETS)
    dtype = "float64" if str(op.wt.dtype) == "torch.float64" else "float32"
    return (weights + 2 * nv * n) * isz + 4 * tables, 2 * weights, dtype
