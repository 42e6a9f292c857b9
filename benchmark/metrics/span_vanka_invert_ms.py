"""span_vanka_invert_ms (multigrid and Krylov): the program span
``smoothers.vanka_invert`` (each level's Vanka blocks gathered from the
operator, LU-factorised and inverted, every colour), summed over a solve,
median over the window's solves, in ms.  None where no solve of the window
opened it (a program without the span, or a cell without Vanka)."""
from benchmark.spans import span_ms, window_records

SPAN = "smoothers.vanka_invert"


def read(run):
    recs = window_records(run)
    if recs is None or not any(SPAN in r["spans"] for r in recs):
        return None
    return span_ms(run, SPAN)
