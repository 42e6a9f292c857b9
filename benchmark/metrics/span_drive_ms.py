"""span_drive_ms (drive): the program span ``drive`` (the solve's host work
around its steps: gather and upload, copies to the host, correction norms,
scatter, prolongation to the next level), summed over a solve, median over
the window's solves, in ms."""
from benchmark.spans import span_ms


def read(run):
    return span_ms(run, "drive")
