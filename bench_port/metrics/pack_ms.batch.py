"""pack_ms.batch: the program's ``pack_seconds`` span (time join, packing
and upload in ``pipeline.run_sequence``), mean over the window's dives, in
ms."""

LAYER = "ingest and packing"
UNIT = "ms"
MOVES = "batch_realtime_x"


def read(run):
    xs = [r["metrics"]["pack_seconds"] for r in run.records if "pack_seconds" in r["metrics"]]
    return 1e3 * sum(xs) / len(xs) if xs else None
