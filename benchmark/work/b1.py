"""The least work of one matvec of an assembled operator (kernel B1's
class), from its shapes: each nonzero's value at its stored type and one
4-byte column index, x read once and y written once; two flops a
nonzero.  A frozen copy of the count of the repository's
``chip_smoke.b1_rows`` (``bound_ms``), for a square operator or a
rectangular block of ``n`` rows and ``n_cols`` columns."""


def work(op, x):
    """(bytes, flops, dtype) of ``y = A x`` for a sliced-ELL operator
    ``op`` (its device plan ``op.dev``: ``nnz``, ``n``, ``n_cols``)."""
    plan = op.dev
    vsz, xsz = op.vals.element_size(), x.element_size()
    nbytes = plan.nnz * (vsz + 4) + (plan.n_cols + plan.n) * xsz
    dtype = "float64" if str(op.vals.dtype) == "torch.float64" else "float32"
    return nbytes, 2 * plan.nnz, dtype
