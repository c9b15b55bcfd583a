"""Stage timing and device traces (port of :mod:`uslam_tpu.utils.profiling`).

Wall-clock time accumulated per named stage. Given a CUDA ``device``, a
stage synchronizes that device when it starts and when it ends, so its time
includes the device work it queued (PyTorch returns before the card
finishes). :func:`device_trace` records a ``torch.profiler`` trace into a
directory (view it with TensorBoard or Perfetto).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

from uslam_tpu_torch.device import resolve_device, synchronize
from uslam_tpu_torch.utils.logging import get_logger

log = get_logger("profiling")


def _sync_fn(device):
    """A function that waits for ``device``'s queued work (None: no wait)."""
    if device is None:
        return lambda: None
    dev = resolve_device(device)
    return lambda: synchronize(dev)


class Profiler:
    """Accumulates wall-clock time per named stage; ``summary()`` for metrics."""

    def __init__(self, device=None) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._sync = _sync_fn(device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }


@contextlib.contextmanager
def stage_timer(name: str, device=None):
    """One-off stage timer that logs at DEBUG."""
    sync = _sync_fn(device)
    sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync()
        log.debug("%s took %.4fs", name, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """``torch.profiler`` trace of the block, written into ``log_dir`` when
    it ends: host activity, and the card's kernels and copies when
    ``device`` is CUDA."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof
