"""What the per-layer span and host-wait metrics read of the program's
recorder (``femus_tpu_torch.utils.telemetry``): the window's solve
records, one per solve the window timed (the warm-up's and any earlier
record left out), and the process's totals.  A program that keeps no
such records gives nothing, and the metric is left out of the line."""
from __future__ import annotations

import importlib
import statistics
from typing import Callable, List, Optional


def _recorder(name: str) -> Optional[Callable]:
    tel = importlib.import_module("femus_tpu_torch.utils.telemetry")
    return getattr(tel, name, None)


def window_records(run) -> Optional[List[dict]]:
    """The records of the window's solves, or None where the program
    kept fewer."""
    solves = _recorder("solves")
    if solves is None or not run.solves:
        return None
    recs = solves()
    n = len(run.solves)
    return recs[-n:] if len(recs) >= n else None


def span_ms(run, name: str) -> Optional[float]:
    """The median over the window's solves of the span's milliseconds (its
    calls in a solve summed)."""
    recs = window_records(run)
    if recs is None:
        return None
    return statistics.median(1e3 * r["spans"].get(name, [0.0])[0]
                             for r in recs)


def host_waits(run) -> Optional[float]:
    """The median over the window's solves of the ``host_wait.*`` counts
    summed."""
    recs = window_records(run)
    if recs is None:
        return None
    return statistics.median(
        sum(n for k, n in r["counts"].items() if k.startswith("host_wait."))
        for r in recs)


def setup_s(name: str) -> Optional[float]:
    """The process's total seconds in the span ``name``; None where it
    never ran."""
    totals = _recorder("totals")
    if totals is None:
        return None
    entry = totals()["spans"].get(name)
    return None if entry is None else entry[0]
