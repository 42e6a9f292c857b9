"""device_idle_pct (device): the share of the traced window in which no
kernel, copy or set runs on the card, from the union of their intervals
on the profiler's timeline."""


def read(run):
    if not run.trace or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
