"""lm_iters.batch: LM iterations per solve (``LMStats.iterations``), mean
over the window's dives. A count."""

LAYER = "LM"
UNIT = "iterations"
MOVES = "batch_realtime_x"


def read(run):
    xs = [r["metrics"]["lm_iterations"] for r in run.records]
    return sum(xs) / len(xs) if xs else None
