"""span_assemble_ms (assembly): the program span ``step.assemble`` (fine
assembly, the residual norm read, the fine operator and its BELL frame),
summed over a solve, median over the window's solves, in ms."""
from benchmark.spans import span_ms


def read(run):
    return span_ms(run, "step.assemble")
