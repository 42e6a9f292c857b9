"""coarsen_ms (coarsening): ``System.profile_step(level=-1)["coarsen_s"]``
in milliseconds (the Galerkin PtAP into the finest level), as
assembly_ms; nothing where the hierarchy has no Galerkin coarsening."""


def read(run):
    if not run.profile or "coarsen_s" not in run.profile:
        return None
    return 1e3 * run.profile["coarsen_s"]
