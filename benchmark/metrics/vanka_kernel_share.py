"""vanka_kernel_share (multigrid and Krylov): the share of the multiplicative
Vanka sweep's colour steps that ran in the program's CUDA kernel, the
counters ``vanka.colour_kernel`` over ``vanka.colour_kernel`` plus
``vanka.colour_torch`` of a solve, median over the window's solves that
took a colour step.  None where no solve took one (a cell without Vanka)
or the program keeps no such counters."""
import statistics

from benchmark.spans import window_records


def read(run):
    recs = window_records(run)
    if recs is None:
        return None
    shares = []
    for r in recs:
        kernel = r["counts"].get("vanka.colour_kernel", 0)
        steps = kernel + r["counts"].get("vanka.colour_torch", 0)
        if steps:
            shares.append(kernel / steps)
    return statistics.median(shares) if shares else None
