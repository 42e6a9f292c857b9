"""newton_steps (drive): Newton steps per solve, the length of
``System.history`` after each solve of the window, averaged."""


def read(run):
    return run.mean("newton_steps")
