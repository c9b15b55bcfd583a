"""Reduction of a ``torch.profiler`` trace (chrome trace JSON) to the
device's busy seconds, the traced window and the breakdown.

The profiler sees every kernel the host launches and every kernel node of
a replayed CUDA graph, but none inside a conditional node's body (the LM's
WHILE loop, its IF node, the CG's loop): their time counts as idle here.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def device_intervals(events: list) -> list:
    """(start_us, end_us, name) of every device operation."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", "?"))
            for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def merged(intervals: list) -> list:
    """Union of (start, end, ...) intervals as sorted disjoint (start, end)."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_label(events: list, t: float) -> str:
    """The innermost host operation running at time t (latest start)."""
    best, best_ts = "host work outside any recorded op (numpy, Python)", -1.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("cpu_op", "python_function"):
            continue
        ts = float(e["ts"])
        if ts <= t <= ts + float(e.get("dur", 0.0)) and ts > best_ts:
            best, best_ts = e.get("name", "?"), ts
    return best


def reduce(events: list, window_us: tuple) -> dict:
    """busy_s, window_s and the breakdown over the window (start, end) in
    the trace's microseconds."""
    w0, w1 = window_us
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in device_intervals(events) if e > w0 and s < w1]
    spans = merged(dev)
    busy_us = sum(e - s for s, e in spans)
    by_name: dict = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    gaps = []
    prev = w0
    for s, e in spans + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.get("cat") != "kernel"]
    idle = [[_host_label(host, 0.5 * (a + b)), (b - a) * 1e-6] for a, b in gaps[:TOP]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "breakdown": {"device_ops": [[n, t * 1e-6] for n, t in top], "idle_gaps": idle},
    }


def load_events(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def profile(fn, workdir) -> dict:
    """Run ``fn()`` under torch.profiler (host and device activity) and
    reduce its trace; the window is the profiled call's own span. The trace
    file goes to ``workdir`` and is removed."""
    import os
    import tempfile
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(suffix=".json", dir=workdir)
    os.close(fd)
    try:
        with tprofile(activities=acts) as prof:
            with record_function("bench_port.profiled_slice"):
                t0 = time.perf_counter()
                fn()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        events = load_events(path)
    finally:
        os.unlink(path)
    marks = [e for e in events if e.get("name") == "bench_port.profiled_slice"
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if marks:
        w0 = float(marks[0]["ts"])
        window = (w0, w0 + float(marks[0]["dur"]))
    else:
        ts = [float(e["ts"]) for e in events if "ts" in e]
        window = (min(ts), min(ts) + wall * 1e6)
    return reduce(events, window)
