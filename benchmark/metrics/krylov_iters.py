"""krylov_iters (multigrid and Krylov): GMRES iterations per solve, summed
over its Newton steps (``System.history``) or read from the linear
solve's ``info``, averaged over the window's solves."""


def read(run):
    return run.mean("krylov_iters")
