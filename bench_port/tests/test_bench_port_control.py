"""The check of ``batch_1k.features`` fails what it must.

- The control, the reference in the program's place with each stage one
  precision below the configuration's (bfloat16 leaves and residuals, TF32
  products, a float32 solve), fails the cell's limits: on the CPU at the
  rehearsal size, and on the card at the cell's own size (``cuda``), where
  it fails every number. (The solve stage alone at those precisions, from
  the stated float32 leaves, reads no worse than the program: the
  benchmark's PERF.md gives the readings.)
- A run whose timed path is broken underneath comes out not correct: a
  solve that returns its state unchanged, half of the stereo observations
  left out of the packed graph, and one pose of the answer moved where the
  solve produces it.
"""

import argparse
import json

import numpy as np
import pytest

import harness
import readings
from run import Run, main

from conftest import ROOT

WORKLOAD = "batch_1k.features"


def _control(device, seed: int, rehearse: bool):
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"), WORKLOAD, ROOT)
    run = Run(argparse.Namespace(rehearse=rehearse, seed=seed), cell, device)
    run.state["dives"] = cell.driver.make_dives(run)
    dives = cell.driver.check_dives(run, range(len(run.state["dives"])))
    refs = cell.driver.reference_solutions(run, dives)
    numbers = cell.driver.judge(run, refs, readings.control_records(run, refs))
    return cell, numbers


def test_control_fails_on_the_cpu():
    cell, numbers = _control("cpu", 5, True)
    assert not harness.compare(numbers, cell.limits)[0]
    assert numbers["graph_gap"] > cell.limits["graph_gap"], numbers


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3000000019, 3000000037, 3000000041])
def test_control_fails_at_the_cells_size(cuda_device, seed):
    cell, numbers = _control(cuda_device, seed, False)
    print(f"control seed {seed}: {numbers}")
    for name, value in numbers.items():
        assert value > cell.limits[name], (name, value, cell.limits[name])


def _broken_run(capsys, monkeypatch, patch):
    import uslam_tpu_torch.pipeline as pipeline

    patch(monkeypatch, pipeline)
    rc = main(["--workload", WORKLOAD, "--seed", "2718281829", "--seconds", "1", "--rehearse"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _unchanged(monkeypatch, pipeline):
    from uslam_tpu_torch.solvers.lm import LMStats

    monkeypatch.setattr(pipeline, "run_solver", lambda graph, initial, *a, **k: (
        initial, LMStats(0.0, 0.0, 1, 0.0, True)))


def _half_left_out(monkeypatch, pipeline):
    real = pipeline.pack_sequence

    def pack(seq, cfg, **kw):
        graph, values, odom, rows = real(seq, cfg, **kw)
        mask = np.array(graph.stereo.mask)
        mask[np.flatnonzero(mask)[::2]] = 0.0
        return graph._replace(stereo=graph.stereo._replace(mask=mask)), values, odom, rows

    monkeypatch.setattr(pipeline, "pack_sequence", pack)


def _answer_altered(monkeypatch, pipeline):
    real = pipeline.run_solver

    def solve(*a, **k):
        values, stats = real(*a, **k)
        pt = values.pose_trans.clone()
        pt[pt.shape[0] // 2] += 0.5
        return values._replace(pose_trans=pt), stats

    monkeypatch.setattr(pipeline, "run_solver", solve)


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _answer_altered],
                         ids=["state_unchanged", "half_left_out", "answer_altered"])
def test_broken_timed_path_is_not_correct(capsys, monkeypatch, fault):
    line = _broken_run(capsys, monkeypatch, fault)
    assert line["correct"] is False
    assert line["attempted"] > 0 and line["failed"] == 0


def test_sound_run_is_correct(capsys, monkeypatch):
    line = _broken_run(capsys, monkeypatch, lambda mp, pipeline: None)
    assert line["correct"] is True, line["checks"]
