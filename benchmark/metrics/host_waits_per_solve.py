"""host_waits_per_solve (multigrid and Krylov, host side): the program's
``host_wait.*`` counters (each site that blocks on the device: reads to the
host, pageable uploads, error checks of factorisations, the step's
synchronise) summed over a solve, median over the window's solves.  The
benchmark's own waits (its synchronise after each solve, a system file's
uploads) are not counted here."""
from benchmark.spans import host_waits


def read(run):
    return host_waits(run)
