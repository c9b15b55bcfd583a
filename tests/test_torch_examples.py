"""The port's examples (examples/*_torch.py) on the CPU, each in a child
process where ``jax`` and ``uslam_tpu`` cannot be imported
(``sys.modules`` holds None for both before the script runs), so a stray
import of either fails the run.

The four children start together in one module fixture and the tests read
their outputs: run_synthetic_torch.py (4 s, precomputed features: the
metrics, the marginals, trajectory.png and graph.dot), run_online_torch.py
(3 s of rendered frames: its ATE line below the DVL odometry's on the same
sequence), and run_from_rosbag_torch.py on a small features bag written
with ``uslam_tpu_torch.io.rosbag.write_bag``, beside the JAX package's
examples/run_from_rosbag.py on the same bag (``JAX_PLATFORMS=cpu``). Both
bag runs must report the same keyframes, landmarks and convergence, and
their metrics in metres within BAG_ATOL_M, the trajectory tolerance of
tests/test_torch_offline_api.py:104 (two float32 solves that stop on their
error floor).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import write_features_bag
from uslam_tpu_torch.eval.metrics import ate_rmse
from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
# The child: block both JAX packages, then run the script as __main__.
BLOCKED = (
    "import runpy, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['uslam_tpu'] = None\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(path, run_name='__main__')\n"
)
ONLINE_SECONDS = 3.0
BAG_SPEC = dict(duration=4.0, num_landmarks=60, odom_drift_rate=0.03, seed=11)
BAG_ATOL_M = 2e-2
TIMEOUT_S = 600


def _port(script: str, *args: str) -> list:
    return [sys.executable, "-c", BLOCKED, str(EXAMPLES / script), *args]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (exit code, stdout, stderr)} of the four children, run at
    once; and the output folders."""
    tmp = tmp_path_factory.mktemp("examples")
    bag = tmp / "features.bag"
    write_features_bag(generate_synthetic_sequence(SyntheticSpec(**BAG_SPEC)), str(bag))
    # Two torch threads per child: the four share the test worker's cores.
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    cmds = {
        "synthetic": _port("run_synthetic_torch.py", "--duration", "4", "--out",
                           str(tmp / "synthetic"), "--cpu"),
        "online": _port("run_online_torch.py", "--duration", str(ONLINE_SECONDS), "--cpu"),
        "bag": _port("run_from_rosbag_torch.py", str(bag), "--cpu", "--dot", str(tmp / "bag.dot")),
        "bag_jax": [sys.executable, str(EXAMPLES / "run_from_rosbag.py"), str(bag)],
    }
    procs = {k: subprocess.Popen(c, cwd=tmp, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, c in cmds.items()}
    out = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            out[k] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
    return out, tmp


def _ok(runs, name: str) -> str:
    rc, stdout, stderr = runs[0][name]
    assert rc == 0, stderr[-4000:]
    return stdout


def _metrics_dict(stdout: str) -> dict:
    """The metrics dict the bag examples print on their last dict line."""
    return ast.literal_eval([ln for ln in stdout.splitlines() if ln.startswith("{")][-1])


def test_run_synthetic_torch(runs):
    stdout = _ok(runs, "synthetic")
    lines = stdout.splitlines()
    assert lines[0] == "metrics:"
    metrics = dict(ln.strip().split(": ", 1) for ln in lines[1:lines.index(
        "pose 1-sigma [rot(rad) | trans(m)]:")])
    assert int(metrics["num_poses"]) == 20 and metrics["converged"] == "True"
    assert float(metrics["final_error"]) < 1e-3 * float(metrics["initial_error"])
    assert sum(ln.strip().startswith("pose ") and " trans (" in ln for ln in lines) == 3
    out_dir = runs[1] / "synthetic"
    assert lines[-1] == f"wrote {out_dir}/trajectory.png and graph.dot"
    assert (out_dir / "trajectory.png").stat().st_size > 0
    assert (out_dir / "graph.dot").read_text().startswith("graph")


def test_run_online_torch(runs):
    stdout = _ok(runs, "online")
    lines = stdout.splitlines()
    keyframes = [ln for ln in lines if ln.startswith("t=")]
    assert len(keyframes) == int(ONLINE_SECONDS * 5)
    (ate_line,) = [ln for ln in lines if ln.startswith("ATE vs ground truth: ")]
    ate = float(ate_line.split(": ")[1].split()[0])
    seq = generate_synthetic_sequence(SyntheticSpec(duration=ONLINE_SECONDS, odom_drift_rate=0.03,
                                                    seed=3))
    n = len(keyframes)
    assert ate < ate_rmse(seq.dvl_pose_pos[:n], seq.gt_pos[:n])
    assert lines[-1].startswith(f"{n} keyframes in ")


def test_run_from_rosbag_torch_matches_jax_example(runs):
    stdout = _ok(runs, "bag")
    ref_stdout = _ok(runs, "bag_jax")
    header = [ln for ln in stdout.splitlines() if ln.startswith("bag: ")]
    assert header == [ln for ln in ref_stdout.splitlines() if ln.startswith("bag: ")]
    assert header == ["bag: 800 imu, 20 pressure, 20 dvl poses, 20 twists, 20 feature frames"]
    got, ref = _metrics_dict(stdout), _metrics_dict(ref_stdout)
    for k in ("num_poses", "num_landmarks", "converged"):
        assert got[k] == ref[k], k
    assert got["converged"]
    np.testing.assert_allclose(got["ate_rmse_vs_odom"], ref["ate_rmse_vs_odom"], atol=BAG_ATOL_M)
    assert stdout.splitlines()[-1] == f"wrote {runs[1] / 'bag.dot'}"
    assert (runs[1] / "bag.dot").is_file()
