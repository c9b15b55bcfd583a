"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Each run makes its inputs from ``--seed``, sets up and warms every shape
the cell's traffic uses (``setup_s``), measures for ``--seconds``, checks
what the timed path produced against the plain reference in
``bench_port/reference`` and prints one JSON line as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (with ``--trace 1`` also ``busy_s``, ``window_s`` and a
``breakdown``) and, last, ``checks``: each number compared beside its
limit. The same numbers are the last lines of standard error.

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, and one unit of the traffic is
profiled after the window.

It needs a CUDA device (``--rehearse`` runs the cell on the CPU at the
configuration's rehearsal size, with every device number null) and exits
non-zero with no result line without one, or when a module of JAX or of
the JAX package is loaded at the end.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

T_IMPORT = time.perf_counter()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _process_age_s() -> float:
    """Seconds since this process started (from /proc where it exists)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into uslam_tpu_torch/_build/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))


class Run:
    """What one run knows: its arguments, its cell, its device, and what
    the driver records; readers of metrics read from it."""

    def __init__(self, args, cell, device):
        self.args = args
        self.cell = cell
        self.device = device
        self.rehearse = args.rehearse
        self.seed = args.seed
        self.state: dict = {}      # the driver's inputs and program objects
        self.records: list = []    # one per unit of work completed in the window
        self.t_start = 0.0
        self.attempted = 0
        self.failed = 0
        self.profile: dict | None = None

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="CPU rehearsal at the configuration's rehearsal size")
    args = p.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload, ROOT)
    chips = int(cell.workload["chips"])

    import torch

    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            Run.log(f"bench_port: needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    run = Run(args, cell, device)
    driver = cell.driver
    driver.setup(run)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = _process_age_s()
    run.log(f"bench_port: {cell.name} seed {args.seed}: set-up {setup_s!r} s")

    driver.window(run, args.seconds)
    memory_peak = None
    if device.type == "cuda":
        torch.cuda.synchronize()
        memory_peak = int(max(torch.cuda.max_memory_allocated(i) for i in range(chips)))

    if args.trace:
        run.profile = driver.profile(run)
        kinds = "per_layer"
    else:
        kinds = "end_to_end"
    metrics = {}
    for m in cell.metrics(kinds):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = cell.reader(m).read(run)
        if value is None:
            continue
        if run.rehearse and m["source"] == "device_trace":
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    driver.release(run)
    t_check = time.perf_counter()
    numbers = driver.check(run)
    run.log(f"bench_port: the check took {time.perf_counter() - t_check!r} s")
    ok, checks = harness.compare(numbers, cell.limits)
    correct = ok and run.failed == 0 and run.attempted > 0

    found = harness.forbidden_loaded()
    if found:
        run.log(f"bench_port: forbidden modules loaded: {found}")
        return 4

    if run.rehearse:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    else:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
               "memory_peak_bytes": memory_peak}
    breakdown = None
    if args.trace and run.profile is not None:
        dev["busy_s"] = None if run.rehearse else run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        breakdown = None if run.rehearse else run.profile["breakdown"]
    run.log(f"bench_port: attempted {run.attempted}, failed {run.failed}, correct {correct}")
    for name, c in checks.items():
        run.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(harness.result_line(correct, run.attempted, run.failed, metrics, dev, checks,
                              breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
