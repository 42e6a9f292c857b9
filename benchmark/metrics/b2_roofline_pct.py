"""b2_roofline_pct (matvec kernels): the least time that the traced
solves' patch-operator matvecs need (``work/b2.py``) as a share of the
device time of the kernels that run them (``kernels/b2.json``)."""


def read(run):
    return run.roofline_pct("b2")
