"""vanka_blocks_per_solve (multigrid and Krylov): the program counter
``vanka.blocks_inverted`` (the Vanka blocks each level's smoother set-up
inverts) summed over a solve, median over the window's solves.  None where
no solve counted it (a program without the counter, or a cell without
Vanka)."""
import statistics

from benchmark.spans import window_records


def read(run):
    recs = window_records(run)
    if recs is None:
        return None
    counts = [r["counts"].get("vanka.blocks_inverted", 0) for r in recs]
    return statistics.median(counts) if any(counts) else None
