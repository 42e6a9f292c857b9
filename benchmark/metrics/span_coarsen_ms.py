"""span_coarsen_ms (coarsening): the program span ``step.coarsen`` (every
coarse level's Galerkin PtAP and Dirichlet identity, or each rediscretized
level's state restriction and assembly), summed over a solve, median over
the window's solves, in ms."""
from benchmark.spans import span_ms


def read(run):
    return span_ms(run, "step.coarsen")
