"""kernels_per_solve (multigrid and Krylov, host side): device kernels in the
traced window (copies and sets left out) per traced solve."""


def read(run):
    if not run.trace or not run.trace["kernels"]:
        return None
    return run.trace["kernels"] / run.trace["solves"]
