"""b1_roofline_pct (matvec kernels): the least time that the traced
solves' assembled-operator matvecs need (``work/b1.py``) as a share of the
device time of the kernels that run them (``kernels/b1.json``)."""


def read(run):
    return run.roofline_pct("b1")
