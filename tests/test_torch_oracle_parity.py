"""ATE parity of the port's production solve against an exact float64
oracle (tests/test_oracle_parity.py on ``uslam_tpu_torch``, on the CPU).

The oracle (``chip_smoke.exact_f64_optimize``, where the card's run uses
it too) is tests/test_oracle_parity.py:29-68 on the port's linearization,
error, dense assembly and retraction: the same graph in float64, every
step the exact dense solve of the whole tangent space (numpy
``np.linalg.solve``), GTSAM's lambda policy. It stands in for the
survey's "ATE within 1% of GTSAM" (BASELINE.md, "Oracle substitution").

Tolerances, with their reasons:
- the port's oracle against the JAX package's on the same float64 graph
  (tests/test_oracle_parity.py:216's spec): final error within
  ORACLE_ERROR_RTOL and pose translations within ORACLE_POSE_ATOL. Both
  are exact float64 dense solves; only the order of float64 sums differs
  (measured: 4.5e-14 relative and 1.8e-15 m);
- every other bound is the JAX test's own, unchanged: the oracle below half
  the initial ATE; the float32 solve's ATE within 3.5x the oracle's (a
  regression canary); the polished ATE within 1.01x the oracle's + 1e-4 m;
  the identity-damped float64 policy within 1 + 5e-4 of the oracle's error
  and 5e-3 m of its poses.

The canary is a test of its own: the port's float32 solve misses it on
this input (ROADMAP C9: 0.0967 m against 3.5 x 0.0275 m), where JAX's
float32 solve passes it. The iteration-by-iteration trace found the same
policy on both sides and no port fault: JAX's own LM step with a float64
Schur solve (the port's design, ROADMAP §C) follows the port to the same
end point (ATE 0.0975 m), and the port with a float32 Schur solve ends at
0.0895 m; the float32 error's rounding (3e-4 relative on the port, 1e-3
on JAX) is of the size of the plateau band in that flat valley.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ORACLE_CANARY, ORACLE_PARITY, exact_f64_optimize, oracle_solves
from tests.test_oracle_parity import _exact_f64_optimize
from uslam_tpu.config import UslamConfig as JaxUslamConfig
from uslam_tpu.geometry.camera import StereoCamera as JaxStereoCamera
from uslam_tpu.graph.packing import pack_sequence as jax_pack
from uslam_tpu.io.synthetic import SyntheticSpec as JaxSpec
from uslam_tpu.io.synthetic import generate_synthetic_sequence as jax_generate
from uslam_tpu_torch.config import UslamConfig
from uslam_tpu_torch.device import cast_tree
from uslam_tpu_torch.eval.metrics import ate_rmse
from uslam_tpu_torch.geometry.camera import StereoCamera
from uslam_tpu_torch.graph.packing import pack_sequence
from uslam_tpu_torch.interop import to_port
from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
from uslam_tpu_torch.pipeline import run_solver
from uslam_tpu_torch.solvers.lm import optimize_lm
from uslam_tpu_torch.solvers.polish import polish_f64

# tests/test_oracle_parity.py:225-232: 20 keyframes at 5 Hz, a small graph.
SMALL_SPEC = dict(duration=4.0, keyframe_rate=5.0, num_landmarks=32, odom_drift_rate=0.05,
                  feature_noise_px=0.3, seed=7)
ORACLE_ERROR_RTOL = 1e-12
ORACLE_POSE_ATOL = 1e-9
# tests/test_oracle_parity.py:159-167: the 1k bench spec.
BENCH_SPEC = dict(duration=200.0, keyframe_rate=5.0, num_landmarks=512, omega=0.15,
                  odom_drift_rate=0.02, feature_noise_px=0.3, seed=0)
CACHE_DIR = Path(__file__).resolve().parent / ".oracle_cache"


def _small_problem():
    """tests/test_oracle_parity.py:216's graph on the port, in float64 on
    the CPU: (config, graph, initial, camera)."""
    seq = generate_synthetic_sequence(SyntheticSpec(**SMALL_SPEC))
    cfg = UslamConfig()
    g_np, v_np, _, _ = pack_sequence(seq, cfg)
    f64 = torch.float64
    return (cfg, cast_tree(to_port(g_np, "cpu"), f64, "cpu"),
            cast_tree(to_port(v_np, "cpu"), f64, "cpu"),
            cast_tree(StereoCamera.from_config(cfg.camera, device="cpu"), f64, "cpu"))


@pytest.fixture(scope="module")
def parity():
    """The 100-keyframe solves of tests/test_oracle_parity.py:71, shared by
    its checks: float32 ``run_solver``, ``polish_f64`` and the oracle, all
    on the CPU."""
    return oracle_solves("cpu")


def test_exact_oracle_matches_jax():
    """The port's oracle equals the JAX package's on the same float64 graph
    (the JAX package's float64 packing, taken to the port)."""
    spec = JaxSpec(**SMALL_SPEC)
    jcfg = JaxUslamConfig()
    jcam = JaxStereoCamera.from_config(jcfg.camera)
    with jax.enable_x64():
        graph, initial, _, _ = jax_pack(jax_generate(spec), jcfg, dtype=jnp.float64)
        ref_vals, ref_error = _exact_f64_optimize(graph, initial, jcam, jcfg)
        ref_pos = np.asarray(ref_vals.pose_trans, np.float64)
        graph_np, initial_np = jax.device_get((graph, initial))
    cfg = UslamConfig()
    cam = cast_tree(StereoCamera.from_config(cfg.camera, device="cpu"), torch.float64, "cpu")
    vals, error = exact_f64_optimize(to_port(graph_np, "cpu"), to_port(initial_np, "cpu"),
                                     cam, cfg)
    assert vals.pose_trans.dtype == torch.float64
    np.testing.assert_allclose(error, ref_error, rtol=ORACLE_ERROR_RTOL)
    np.testing.assert_allclose(vals.pose_trans.numpy(), ref_pos, atol=ORACLE_POSE_ATOL)


def test_ate_parity_vs_exact_oracle(parity):
    """tests/test_oracle_parity.py:127,137: the oracle beats the drifting
    odometry by a wide margin, and the production float64-polished
    estimate lands within 1% ATE of it."""
    assert parity["f32_converged"]
    assert parity["ate_oracle"] < 0.5 * parity["ate_init"]
    factor, metres = ORACLE_PARITY
    assert parity["ate_polished"] <= parity["ate_oracle"] * factor + metres, (
        parity["ate_polished"], parity["ate_oracle"])


def test_f32_canary_vs_exact_oracle(parity):
    """tests/test_oracle_parity.py:133: the float32 solve's ATE within 3.5x
    the oracle's (a regression bound, not a quality claim). Fails on the
    port: ROADMAP C9."""
    assert parity["ate_f32"] <= parity["ate_oracle"] * ORACLE_CANARY, (
        parity["ate_f32"], parity["ate_oracle"])


def test_reference_default_policy_converges():
    """tests/test_oracle_parity.py:216 on the port: the reference-default LM
    mapping (identity damping, no lambda floor, no plateau stop) in float64
    reaches the exact oracle's optimum."""
    cfg, graph, initial, cam = _small_problem()
    ref_solver = dataclasses.replace(cfg.solver, damping_mode="identity", lambda_lower_bound=0.0,
                                     plateau_patience=0, max_iterations=40)
    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    vals, stats = optimize_lm(graph, initial, cam, *sig, ref_solver)
    oracle_vals, oracle_error = exact_f64_optimize(graph, initial, cam, cfg)
    assert stats.converged
    assert stats.final_error <= oracle_error * (1.0 + 5e-4), (stats.final_error, oracle_error)
    np.testing.assert_allclose(vals.pose_trans.numpy(), oracle_vals.pose_trans.numpy(),
                               atol=5e-3)


@pytest.mark.slow
def test_ate_parity_vs_exact_oracle_1k_bench_scale():
    """tests/test_oracle_parity.py:146 on the port: the 1% parity at the
    bench scale (1k poses). Slow-marked as in the JAX package: its float64
    oracle (``polish_f64`` from the initial values, 40 iterations, as the
    JAX test takes it) runs for minutes on the CPU; its solution is cached
    under tests/.oracle_cache, so re-runs pay the production solve alone."""
    seq = generate_synthetic_sequence(SyntheticSpec(**BENCH_SPEC))
    cfg = UslamConfig()
    cam = StereoCamera.from_config(cfg.camera, device="cpu")
    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    g_np, v_np, _, _ = pack_sequence(seq, cfg)
    graph, initial = to_port(g_np, "cpu"), to_port(v_np, "cpu")
    values, _stats = run_solver(graph, initial, cam, *sig, cfg.solver)
    polished, _info = polish_f64(graph, values, cam, *sig, cfg.solver, device="cpu")

    cache = CACHE_DIR / (f"uslam_torch_oracle_1k_s{BENCH_SPEC['seed']}"
                         f"_m{BENCH_SPEC['num_landmarks']}_d{int(BENCH_SPEC['duration'])}.npz")
    if cache.exists():
        oracle_pos = np.load(cache)["pose_trans"]
    else:
        oracle, _ = polish_f64(graph, initial, cam, *sig, cfg.solver, max_iters=40,
                               device="cpu")
        oracle_pos = oracle.pose_trans.numpy().astype(np.float64)
        CACHE_DIR.mkdir(exist_ok=True)
        np.savez_compressed(cache, pose_trans=oracle_pos)

    n = initial.num_poses
    gt = np.asarray(seq.gt_pos[:n], np.float64)
    ate_oracle = ate_rmse(oracle_pos[:n], gt)
    ate_polished = ate_rmse(polished.pose_trans.numpy()[:n], gt)
    ate_f32 = ate_rmse(values.pose_trans.numpy()[:n], gt)
    assert ate_f32 <= ate_oracle * ORACLE_CANARY, (ate_f32, ate_oracle)
    factor, metres = ORACLE_PARITY
    assert ate_polished <= ate_oracle * factor + metres, (ate_polished, ate_oracle)
