"""The port's command line and runtime utilities against the JAX package's,
and ``SolverConfig.debug_nans``.

- ``utils.logging``: the same ``uslam`` logger hierarchy.
- ``utils.profiling``: ``Profiler.summary()`` with the JAX package's keys and
  call counts for the same stages.
- ``utils.checkpoint``: ``save_state`` of a ``Values`` carried over from the
  JAX package writes the JAX package's leaves; each package loads the
  other's file; the round trip is bit-identical; a structure mismatch
  raises ValueError.
- ``__main__``: ``synth`` writes the JAX package's npz for the same
  arguments, array for array; ``info`` prints the JAX package's lines for
  the same bag and npz; ``run --cpu`` prints the metrics of the port's
  ``run_sequence(device="cpu")`` on the same npz and config, and writes
  ``--save-values``, ``--dot`` and ``--plot``; the device, ``--config``,
  ``--banded``, ``--polish`` and ``--no-landmarks`` reach ``run_sequence``;
  without ``--cpu`` and with no GPU, ``run`` raises the ``RuntimeError`` of
  ``resolve_device``.
- ``debug_nans`` (port only: the JAX package's sanitizer reruns the jitted
  LM op by op, minutes on a CPU): with the flag on a clean solve is
  bit-identical to the solve with it off, under every linear solver; a NaN
  in one IMU sample raises FloatingPointError naming ``linearize``; with
  the flag off no check runs.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uslam_tpu.__main__ import main as jmain
from uslam_tpu.graph.values import Values as JValues
from uslam_tpu.utils import checkpoint as jcheckpoint, logging as jlogging, profiling as jprofiling
from uslam_tpu_torch import config as tconfig
from uslam_tpu_torch.__main__ import main
from uslam_tpu_torch.graph.builder import DvlMeasurements
from uslam_tpu_torch.graph.values import Values
from uslam_tpu_torch.interop import to_port
from uslam_tpu_torch.io.sequence import load_sequence
from uslam_tpu_torch.pipeline import run_sequence
from uslam_tpu_torch.solvers import lm
from uslam_tpu_torch.utils import checkpoint, get_logger, profiling

from tests.test_rosbag import make_bag

ROOT = Path(__file__).resolve().parent.parent
TIMING_KEYS = {"solve_seconds", "pack_seconds", "polish_seconds"}


@pytest.fixture(scope="module")
def synth_npz(tmp_path_factory):
    """A 4 s precomputed-feature sequence written by the port's ``synth``."""
    path = str(tmp_path_factory.mktemp("synth") / "seq.npz")
    assert main(["synth", "--duration", "4", "--landmarks", "32", "--seed", "2", "--out", path]) == 0
    return path


@pytest.fixture(scope="module")
def short_npz(tmp_path_factory):
    """A 1.6 s precomputed-feature sequence (8 keyframes) for the solver flags."""
    path = str(tmp_path_factory.mktemp("short") / "seq.npz")
    assert main(["synth", "--duration", "1.6", "--landmarks", "24", "--seed", "3", "--out", path]) == 0
    return path


# --- utils --------------------------------------------------------------------


def test_logger_hierarchy_is_jax_packages():
    assert get_logger("ingest") is jlogging.get_logger("ingest")
    assert get_logger("ingest").name == "uslam.ingest"


def test_profiler_summary_matches_jax():
    ours, ref = profiling.Profiler(device="cpu"), jprofiling.Profiler()
    for name in ("ingest", "solve", "ingest", "ingest"):
        for p in (ours, ref):
            with p.stage(name):
                sum(range(1000))
    s, r = ours.summary(), ref.summary()
    assert s.keys() == r.keys() == {"ingest", "solve"}
    for k in s:
        assert s[k].keys() == r[k].keys()
        assert s[k]["calls"] == r[k]["calls"]
        assert s[k]["total_s"] > 0 and s[k]["mean_s"] == s[k]["total_s"] / s[k]["calls"]
    with profiling.stage_timer("ingest", device="cpu"):
        pass
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.Profiler(device="cuda")


def _values_pair():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    jv = JValues(
        pose_quat=jnp.asarray(q / np.linalg.norm(q, axis=1, keepdims=True)),
        pose_trans=jnp.asarray(rng.normal(size=(5, 3)), jnp.float32),
        vel=jnp.asarray(rng.normal(size=(5, 3)), jnp.float32),
        bias=jnp.asarray(rng.normal(size=6), jnp.float32),
        landmarks=jnp.asarray(rng.normal(size=(9, 3)), jnp.float32),
    )
    return jv, to_port(jax.device_get(jv), "cpu")


def test_checkpoint_leaves_equal_jax_and_cross_load(tmp_path):
    jv, tv = _values_pair()
    pj, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcheckpoint.save_state(pj, jv)
    checkpoint.save_state(pp, tv)
    with np.load(pj) as zj, np.load(pp) as zp:
        leaves = sorted(k for k in zj.files if k.startswith("leaf_"))
        assert leaves == sorted(k for k in zp.files if k.startswith("leaf_")) and len(leaves) == 5
        for k in leaves:
            assert zj[k].dtype == zp[k].dtype
            np.testing.assert_array_equal(zj[k], zp[k])
    back = checkpoint.load_state(pp, tv, device="cpu")
    assert type(back) is Values
    for a, b in zip(back, tv):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(checkpoint.load_state(pj, tv, device="cpu"), tv):
        assert torch.equal(a, b)
    for a, b in zip(jcheckpoint.load_state(pp, jv), jv):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_structure_mismatch_raises(tmp_path):
    _, tv = _values_pair()
    path = str(tmp_path / "v.npz")
    checkpoint.save_state(path, tv)
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load_state(path, DvlMeasurements(tv.vel, tv.bias), device="cpu")
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load_state(path, Values(*tv[:4], landmarks=Values(*tv)), device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_load_state_onto_the_card(cuda, tmp_path):
    _, tv = _values_pair()
    path = str(tmp_path / "v.npz")
    checkpoint.save_state(path, tv)
    back = checkpoint.load_state(path, tv, device="cuda")
    for a, b in zip(back, tv):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


# --- __main__ -----------------------------------------------------------------


def test_synth_writes_jax_packages_npz(tmp_path, synth_npz, capsys):
    ref = str(tmp_path / "jax.npz")
    capsys.readouterr()
    assert jmain(["synth", "--duration", "4", "--landmarks", "32", "--seed", "2", "--out", ref]) == 0
    line = capsys.readouterr().out
    assert line.replace(ref, synth_npz) == f"wrote {synth_npz}: 20 keyframes, 800 imu samples\n"
    with np.load(ref) as zj, np.load(synth_npz) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype, k
            np.testing.assert_array_equal(zj[k], zp[k], err_msg=k)


def test_info_prints_jax_packages_lines(tmp_path, synth_npz, capsys):
    bag = str(tmp_path / "ref.bag")
    make_bag(bag, "bz2")
    for path in (bag, synth_npz):
        capsys.readouterr()
        assert main(["info", path]) == 0
        ours = capsys.readouterr().out
        assert jmain(["info", path]) == 0
        assert ours == capsys.readouterr().out and ours


def _cli_metrics(out: str) -> dict:
    return {k: v for k, v in json.loads(out).items() if k not in TIMING_KEYS}


def test_run_cpu_prints_run_sequence_metrics_and_writes_files(tmp_path, synth_npz, capsys):
    cfg = tconfig.UslamConfig(solver=tconfig.SolverConfig(max_iterations=2))
    cfg_path = str(tmp_path / "cfg.json")
    cfg.save_json(cfg_path)
    files = {flag: str(tmp_path / name) for flag, name in
             (("--save-values", "v.npz"), ("--dot", "g.dot"), ("--plot", "p.png"))}
    capsys.readouterr()
    argv = ["run", synth_npz, "--cpu", "--config", cfg_path]
    assert main(argv + [x for kv in files.items() for x in kv]) == 0
    printed = _cli_metrics(capsys.readouterr().out)
    ref = run_sequence(load_sequence(synth_npz), cfg, device="cpu")
    assert printed == json.loads(json.dumps(
        {k: v for k, v in ref.metrics.items() if k not in TIMING_KEYS}, default=float))
    assert printed["final_error"] < printed["initial_error"]
    for path in files.values():
        assert os.path.getsize(path) > 0
    values = checkpoint.load_state(files["--save-values"], ref.values, device="cpu")
    for a, b in zip(values, ref.values):
        assert torch.equal(a, b)
    assert Path(files["--dot"]).read_text().startswith("graph")


@pytest.mark.parametrize("flags", [[], ["--cpu", "--banded", "--polish", "--no-landmarks"]])
def test_run_flags_reach_run_sequence(tmp_path, short_npz, monkeypatch, flags):
    """What ``run`` hands ``run_sequence``: the device, the solver flags on
    top of the ``--config`` file (YAML), and ``with_landmarks``."""
    import uslam_tpu_torch.pipeline as pipeline

    class Handed(Exception):
        pass

    seen = {}

    def fake_run_sequence(seq, cfg, *, device, with_landmarks):
        seen.update(cfg=cfg, device=device, with_landmarks=with_landmarks, n=len(seq.dvl_pose_t))
        raise Handed

    monkeypatch.setattr(pipeline, "run_sequence", fake_run_sequence)
    cfg_path = str(tmp_path / "cfg.yaml")
    given = tconfig.UslamConfig(solver=tconfig.SolverConfig(max_iterations=2, band_width=9))
    given.save_yaml(cfg_path)
    with pytest.raises(Handed):
        main(["run", short_npz, "--config", cfg_path, *flags])
    expect = given
    if flags:
        expect = dataclasses.replace(given, solver=dataclasses.replace(
            given.solver, reduced_solver="banded", band_width=0, f64_polish=True))
    assert seen == dict(cfg=expect, device="cpu" if flags else "cuda",
                        with_landmarks=not flags, n=8)


def test_run_without_cpu_needs_a_gpu(tmp_path, synth_npz):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg_path = str(tmp_path / "cfg.yaml")
    tconfig.UslamConfig().save_yaml(cfg_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["run", synth_npz, "--config", cfg_path])


def test_module_entry_point(synth_npz):
    out = subprocess.run(
        [sys.executable, "-m", "uslam_tpu_torch", "info", synth_npz], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "dvl_pose_t   20 msgs" in out.stdout


# --- debug_nans ---------------------------------------------------------------

SOLVERS = {
    "schur": {},
    "dense": {"linear_solver": "dense"},
    "banded": {"reduced_solver": "banded"},
}


def _solve(seq, debug_nans: bool, **solver):
    cfg = tconfig.UslamConfig(
        solver=tconfig.SolverConfig(max_iterations=1, debug_nans=debug_nans, **solver))
    return run_sequence(seq, cfg, device="cpu")


@pytest.fixture
def counted_checks(monkeypatch):
    calls = []

    def counting(stage, *tensors):
        calls.append(stage)
        return real(stage, *tensors)

    real = lm.check_finite
    monkeypatch.setattr(lm, "check_finite", counting)
    return calls


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_debug_nans_clean_solve_bit_identical(short_npz, counted_checks, name):
    seq = load_sequence(short_npz)
    off = _solve(seq, False, **SOLVERS[name])
    assert counted_checks == []
    on = _solve(seq, True, **SOLVERS[name])
    assert {"linearize", "reduced solve", "step"} <= set(counted_checks)
    assert {"schur": "landmark Schur", "dense": "dense assembly",
            "banded": "banded reduction"}[name] in counted_checks
    assert on.stats == off.stats
    for a, b in zip(on.values, off.values):
        assert torch.equal(a, b)


def test_debug_nans_names_the_stage(short_npz, counted_checks):
    seq = load_sequence(short_npz)
    seq.imu_acc[37, 1] = np.nan
    with pytest.raises(FloatingPointError, match="linearize"):
        _solve(seq, True)
    del counted_checks[:]
    # Off, the NaN goes through unchecked, as it does in the JAX package.
    result = _solve(seq, False)
    assert counted_checks == [] and not np.isfinite(result.metrics["initial_error"])

