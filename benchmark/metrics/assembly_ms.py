"""assembly_ms (assembly): ``System.profile_step(level=-1)["assembly_s"]``
in milliseconds, taken after the window closes, at the last solve's
state (best of three, each ending in a synchronise)."""


def read(run):
    if not run.profile or "assembly_s" not in run.profile:
        return None
    return 1e3 * run.profile["assembly_s"]
