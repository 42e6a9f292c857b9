"""span_krylov_ms (multigrid and Krylov): the program span ``step.krylov``
(the outer Krylov solve, preconditioner applications included), summed
over a solve, median over the window's solves, in ms."""
from benchmark.spans import span_ms


def read(run):
    return span_ms(run, "step.krylov")
