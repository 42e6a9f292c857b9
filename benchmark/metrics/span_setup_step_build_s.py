"""span_setup_step_build_s (set-up): the program span ``setup.step_build``
(the lazy build of each level's solve step: BELL plans, Vanka blocks,
transfer chains, the assembly's device tables), its total over the run,
in s (the warm-up solve builds; the window's solves read no rebuild)."""
from benchmark.spans import setup_s


def read(run):
    return setup_s("setup.step_build")
