"""batch_realtime_x: dive seconds of every dive completed in the window
over the seconds from the window's start to the last completion (the
reference's real-time factor, over all the work). Host clock."""

import harness

LAYER = "entry, offline"
UNIT = "x"


def read(run):
    return harness.completed_rate([(r["done"], r["dive_s"]) for r in run.records], run.t_start)
