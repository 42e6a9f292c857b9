"""span_mg_setup_ms (multigrid and Krylov): the program span
``step.mg_setup`` (coarse BELL re-layout, Vanka block inverses, Chebyshev
lambda_max, Jacobi diagonals, the coarsest dense LU), summed over a solve,
median over the window's solves, in ms."""
from benchmark.spans import span_ms


def read(run):
    return span_ms(run, "step.mg_setup")
