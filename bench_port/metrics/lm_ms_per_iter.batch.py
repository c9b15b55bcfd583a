"""lm_ms_per_iter.batch: the program's ``solve_seconds`` span summed over
the window's dives, over their LM iterations (``LMStats.iterations``), in
ms."""

LAYER = "LM"
UNIT = "ms"
MOVES = "batch_realtime_x"


def read(run):
    secs = sum(r["metrics"]["solve_seconds"] for r in run.records)
    iters = sum(r["metrics"]["lm_iterations"] for r in run.records)
    return 1e3 * secs / iters if iters else None
