"""span_setup_init_s (set-up): the program span ``setup.init``
(``System.init``: assemblers, Dirichlet masks, transfers and PtAP
schedules), its total over the run, in s."""
from benchmark.spans import setup_s


def read(run):
    return setup_s("setup.init")
