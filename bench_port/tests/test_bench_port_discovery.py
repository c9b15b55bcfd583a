"""A configuration, a traffic mix, a driver and a metric are added as new
files plus new BENCHMARK.json entries, and the harness runs the new cell
with no edit to any file it already had."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

DRIVER = '''
import time

def setup(run):
    # The cell's configuration and traffic, found by their names.
    assert run.cell.config["dive"]["duration"] > 0
    run.state["units"] = int(run.cell.traffic["units_per_step"])

def window(run, seconds):
    run.t_start = time.perf_counter()
    while time.perf_counter() - run.t_start < seconds:
        run.attempted += 1
        time.sleep(0.01)
        run.records.append({"done": time.perf_counter(), "units": run.state["units"]})

def profile(run):
    return {"busy_s": 0.0, "window_s": 0.01, "breakdown": {"device_ops": [], "idle_gaps": []}}

def release(run):
    pass

def check(run):
    return {"dummy_gap": 0.0 if run.records else 1.0}
'''
E2E = '''
import harness
def read(run):
    return harness.completed_rate([(r["done"], r["units"]) for r in run.records], run.t_start)
'''
LAYER = '''
def read(run):
    return float(len(run.records))
'''


def _tree_digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp: Path) -> Path:
    shutil.copytree(BENCH, tmp / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


def _run(tmp: Path, *args):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, str(tmp / "bench_port" / "run.py"), *args],
                          cwd=tmp, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("config", ["dummy_cfg", "dive_batch_1k"],
                         ids=["new_config", "new_traffic_on_an_existing_config"])
def test_new_cell_from_new_files_only(tmp_path, config):
    tmp = _copy(tmp_path)
    before = _tree_digest(tmp / "bench_port")
    b = tmp / "bench_port"
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    if config == "dummy_cfg":
        (b / "configs" / "dummy_cfg.json").write_text(json.dumps(
            {"source": "a test", "assumed": {}, "reduced": [], "dive": {"duration": 1.0}}))
        bench["configs"].append({"name": "dummy_cfg", "source": "a test",
                                 "file": "bench_port/configs/dummy_cfg.json", "reduced": [],
                                 "why": "a test"})
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"driver": "dummy", "units_per_step": 3}))
    (b / "drivers" / "dummy.py").write_text(DRIVER)
    (b / "metrics" / "dummy_rate.py").write_text(E2E)
    (b / "metrics" / "dummy_steps.layer.py").write_text(LAYER)
    (b / "limits" / "dummy.cell.json").write_text(json.dumps({"dummy_gap": 0.0}))
    bench["workloads"].append({"name": "dummy.cell", "config": config,
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_rate", "unit": "units/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy.cell"]})
    bench["per_layer"].append({"name": "dummy_steps.layer", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "dummy",
                               "moves": "dummy_rate", "workloads": ["dummy.cell"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _tree_digest(b)
    assert {k: v for k, v in after.items() if k in before} == before   # nothing edited

    for trace in ("0", "1"):
        p = _run(tmp, "--workload", "dummy.cell", "--seed", "2147483659", "--seconds", "0.3",
                 "--trace", trace, "--rehearse")
        assert p.returncode == 0, p.stderr
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] is True and line["attempted"] > 5
        want = {"dummy_rate", "setup_s"} if trace == "0" else {"dummy_steps.layer"}
        assert set(line["metrics"]) == want
        assert line["device"]["platform"] == "cpu"
        assert line["device"]["memory_peak_bytes"] is None
        assert list(line)[-1] == "checks"
        assert p.stderr.strip().splitlines()[-1] == "check dummy_gap: 0.0 (limit 0.0)"


def test_no_device_and_no_program_give_no_result(tmp_path):
    import torch

    tmp = _copy(tmp_path)
    if not torch.cuda.is_available():
        p = _run(tmp, "--workload", "batch_1k.features", "--seed", "1", "--seconds", "1")
        assert p.returncode != 0 and p.stdout.strip() == ""
    # Only BENCHMARK.json and bench_port/: the program is missing.
    p = _run(tmp, "--workload", "batch_1k.features", "--seed", "1", "--seconds", "1",
             "--rehearse")
    assert p.returncode != 0 and p.stdout.strip() == ""
