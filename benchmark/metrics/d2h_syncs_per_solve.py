"""d2h_syncs_per_solve (multigrid and Krylov, host side): host calls that wait
for the device (stream, device and event synchronisations and blocking
copies, the end of every read to the host) in the traced window, per
traced solve."""


def read(run):
    if not run.trace or not run.trace["syncs"]:
        return None
    return run.trace["syncs"] / run.trace["solves"]
