"""The harness's general parts: it finds a cell's configuration, traffic
mix, driver, metric readers and limits by the names in ``BENCHMARK.json``,
computes the statistics the end-to-end metrics are made of, checks that
no JAX module was loaded, and writes the result line.

Layout (everything found by name, so a later cell adds files and edits
none):

- ``configs/<config>.json``: the deployment (``uslam`` the program's
  configuration, ``dive`` the generated dive, ``rehearse`` the overrides of
  a CPU rehearsal);
- ``traffic/<traffic>.json``: the parameters of a traffic mix; its
  ``driver`` names the driver that feeds it to the program, so a second
  traffic kind on a configuration is new files too;
- ``drivers/<driver>.py``: set-up, the driver loop of the window, the
  profiled slice and the check against the reference;
- ``metrics/<metric>.py``: one reader per metric (end-to-end or per
  layer): ``read(run) -> float | None``;
- ``limits/<workload>.json``: the limit of each number the check compares.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "uslam_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file under a private module name (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"bench_port_{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, bench: dict, workload: str, root: Path, here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.bench = bench
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(here / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(here / "limits" / f"{workload}.json")
        self.driver = load_module(here / "drivers" / f"{self.traffic['driver']}.py",
                                  "driver_" + self.traffic["driver"])
        self.here = here

    def metrics(self, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: dict):
        return load_module(self.here / "metrics" / f"{metric['name']}.py", "metric_" + metric["name"])


def completed_rate(units: list, t_start: float) -> float | None:
    """Work units (each ``(done_at, amount)``) completed, over the seconds
    from the window's start to the last completion: all the work over all
    the time it took."""
    if not units:
        return None
    span = max(t for t, _ in units) - t_start
    return sum(a for _, a in units) / span if span > 0 else None


def forbidden_loaded(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN_MODULES`, compared whole: ``uslam_tpu_torch``
    passes, ``uslam_tpu.x`` does not."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def compare(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number of ``limits`` against its limit (value <= limit; a
    missing value or NaN fails): (all within, {name: {"value", "limit"}}),
    a value that is not finite given as its string ("inf", "nan") so the
    line stays JSON."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        within = value is not None and not math.isnan(value) and value <= limit
        ok = ok and within
        shown = value if value is None or math.isfinite(value) else str(float(value))
        out[name] = {"value": shown, "limit": limit}
    return ok, out


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The contract's last line; ``checks`` (each number beside its limit)
    comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out, allow_nan=False)
