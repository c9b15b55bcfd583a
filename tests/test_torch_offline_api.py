"""The port's offline API beyond the default solve, against the JAX package:
the per-keyframe ``AUVSlam``/``GraphBuilder`` path, ``run_sequence(
fast_ingest=False)``, the float64 polish, marginal covariances, the
Graphviz export, the trajectory metrics and the plot.

Tolerances, with their reasons:
- GraphBuilder leaves: integers exact, floats 1e-6 relative plus 1e-12 of
  the leaf's largest entry (the JAX package's IMU whiteners come from its
  native C++ recursion, the port's from numpy; see test_torch_backend.py);
- fast_ingest=False against fast_ingest=True: the graph leaves to 1e-5 and
  the solved positions to 2e-2 m, tests/test_packing.py's own tolerances;
- the float64 polish: equal iteration counts, final error 1e-9 relative
  (float64 rounding order only);
- marginals: 1e-8 relative to the largest entry against JAX in float64;
  against the dense-inverse oracle, tests/test_marginals.py's rtol 1e-6;
- metrics and Graphviz text: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_backend import SIGMAS, _cams, _jax64, _rel, problem  # noqa: F401
from uslam_tpu.config import UslamConfig
from uslam_tpu.eval import graphviz as jgraphviz
from uslam_tpu.eval import metrics as jmetrics
from uslam_tpu.geometry.camera import StereoCamera as JaxCam
from uslam_tpu.io.synthetic import SyntheticSpec, generate_synthetic_sequence
from uslam_tpu.pipeline import AUVSlam as JaxAUVSlam
from uslam_tpu.solvers import marginals as jmarg
from uslam_tpu.solvers.polish import polish_f64 as jax_polish_f64
from uslam_tpu_torch import pipeline
from uslam_tpu_torch.eval import graphviz, metrics
from uslam_tpu_torch.eval.plot import plot_trajectory_3d
from uslam_tpu_torch.geometry.camera import StereoCamera
from uslam_tpu_torch.graph.values import BIAS_DIM, FRAME_DIM, LM_DIM, POSE_DIM, VEL_DIM
from uslam_tpu_torch.interop import config_to_port, to_port
from uslam_tpu_torch.io import synthetic as tsynth
from uslam_tpu_torch.solvers import dense, linearize, marginals
from uslam_tpu_torch.solvers.polish import polish_f64

CFG = UslamConfig()


def _feed(slam, seq):
    """The keyframe loop of tests/test_solver.py::build_graph, through either
    package's AUVSlam."""
    prev_t = None
    for i, t in enumerate(seq.dvl_pose_t):
        depth = slam.process_depth(seq.pressure_mbar[i])
        lo = prev_t if prev_t is not None else -np.inf
        for k in np.nonzero((seq.imu_t >= lo) & (seq.imu_t < t))[0]:
            slam.update_imu(seq.imu_acc[k], seq.imu_gyro[k], 0.005)
        prev_t = float(t)
        ff = seq.features[i]
        slam.batch_update(seq.dvl_pose_quat[i], seq.dvl_pose_pos[i], seq.dvl_twist_vel[i],
                          depth, (ff.ids, ff.u0, ff.v0, ff.u1, ff.v1))


def test_graph_builder_matches_jax(tmp_path):
    spec = dict(duration=3.0, odom_drift_rate=0.02, feature_noise_px=0.2, num_landmarks=80, seed=3)
    ref, ours = JaxAUVSlam(CFG), pipeline.AUVSlam(config_to_port(CFG), device="cpu")
    _feed(ref, generate_synthetic_sequence(SyntheticSpec(**spec)))
    _feed(ours, tsynth.generate_synthetic_sequence(tsynth.SyntheticSpec(**spec)))
    jg, jv = ref.builder.finalize(as_numpy=True)
    tg, tv = ours.batch_create()
    leaves_ref, leaves = jax.tree.leaves((jg, jv)), jax.tree.leaves((tg, tv))
    assert len(leaves_ref) == len(leaves) == 31
    for a, b in zip(leaves_ref, leaves):
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-12 * np.abs(a).max())
    assert ours.builder.landmark_rows() == ref.builder.landmark_rows()
    np.testing.assert_array_equal(np.stack(ours.odom_compare), np.stack(ref.odom_compare))
    assert tv.num_landmarks >= 8 and int(tg.stereo.mask.sum()) >= 20
    ours.save_graph_dot(str(tmp_path / "g.dot"))
    assert (tmp_path / "g.dot").read_text() == jgraphviz.graph_to_dot(
        jg, jv.pose_quat.shape[0], jv.landmarks.shape[0]
    )


def test_keyframe_ingest_matches_packer():
    """run_sequence(fast_ingest=False) replays the per-keyframe API and must
    give the vectorized packer's graph and solution."""
    spec = tsynth.SyntheticSpec(duration=4.0, odom_drift_rate=0.03, num_landmarks=60, seed=11)
    cfg = config_to_port(UslamConfig())
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, max_iterations=12))
    r_fast = pipeline.run_sequence(tsynth.generate_synthetic_sequence(spec), cfg, device="cpu")
    r_slow = pipeline.run_sequence(
        tsynth.generate_synthetic_sequence(spec), cfg, device="cpu", fast_ingest=False
    )
    fast_leaves, slow_leaves = jax.tree.leaves(r_fast.graph), jax.tree.leaves(r_slow.graph)
    assert len(fast_leaves) == len(slow_leaves) == 26
    for a, b in zip(fast_leaves, slow_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)
    np.testing.assert_allclose(r_slow.trajectory, r_fast.trajectory, atol=2e-2)
    np.testing.assert_allclose(r_slow.odom_compare, r_fast.odom_compare, atol=1e-9)
    assert r_slow.metrics["final_error"] < 1e-3 * r_slow.metrics["initial_error"]


def test_polish_matches_jax_f64(problem):  # noqa: F811
    """polish_f64 from the same float32 start: same iterations, same final
    error (both run in float64; the port on the CPU device it is given)."""
    cfg = problem["cfg"]
    g32 = problem["jax_out"][0]
    start = jax.tree.map(lambda a: np.asarray(a, np.float32), problem["values64"])
    vals_ref, info_ref = jax_polish_f64(
        jax.device_get(g32), start, JaxCam.from_config(cfg.camera), *SIGMAS, cfg.solver
    )
    vals, info = polish_f64(
        to_port(jax.device_get(g32), "cpu"), to_port(start, "cpu"),
        StereoCamera.from_config(config_to_port(cfg.camera), device="cpu"), *SIGMAS,
        config_to_port(cfg.solver), device="cpu",
    )
    assert info["polish_iterations"] == info_ref["polish_iterations"] >= 2
    assert info["polish_final_error"] < 1e-2 * info["polish_initial_error"]
    assert abs(info["polish_final_error"] - info_ref["polish_final_error"]) < (
        1e-9 * info_ref["polish_final_error"]
    )
    assert vals.pose_trans.dtype == torch.float64
    assert _rel(vals.pose_trans.numpy(), np.asarray(vals_ref.pose_trans)) < 1e-9


def _dense_cov_oracle(graph, values, cam):
    """inv(H + 1e-8 I) of the port's dense assembly, interleaved layout."""
    lin = linearize.linearize_graph(graph, values, cam, *SIGMAS)
    H, _ = dense.assemble_dense_with_landmarks(
        lin, graph.stereo.cam_idx, graph.stereo.lm_idx, values.num_poses, values.num_landmarks
    )
    H = H.numpy()
    return np.linalg.inv(H + 1e-8 * np.eye(H.shape[0]))


def test_marginals_match_jax_and_dense_inverse_f64(problem):  # noqa: F811
    """At the packed initial estimate, as tests/test_marginals.py."""
    cj, ct = _cams(problem["cfg"])
    g = problem["graph64"]
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), jax.device_get(problem["jax_out"][1]))
    n = v.pose_quat.shape[0]
    lms = tuple(int(j) for j in np.nonzero(g.stereo.lm_obs_mask.sum(1) > 0)[0][:3])
    sel = dict(pose_indices=(0, 1, n - 1), vel_indices=(0, n - 2), landmark_indices=lms,
               include_bias=True, jitter=0.0, refine_iters=2)
    keys = (("pose", 0), ("pose", n - 1), ("vel", 1), ("bias",),
            ("landmark", lms[0]), ("landmark", lms[1]))

    def jax_both(graph, values, cam):
        return (
            jmarg.marginal_covariances(graph, values, cam, *SIGMAS, **sel),
            jmarg.joint_marginal_covariance(graph, values, cam, *SIGMAS, keys,
                                            jitter=0.0, refine_iters=2),
        )

    with jax.enable_x64(True):
        ref, ref_joint = jax.device_get(jax.jit(jax_both)(_jax64(g), _jax64(v), cj))
    gt, vt = to_port(g, "cpu"), to_port(v, "cpu")
    out = marginals.marginal_covariances(gt, vt, ct, *SIGMAS, **sel, device="cpu")
    joint = marginals.joint_marginal_covariance(
        gt, vt, ct, *SIGMAS, keys, jitter=0.0, refine_iters=2, device="cpu"
    )
    for f in ("pose", "vel", "landmark", "bias"):
        assert _rel(getattr(out, f).numpy(), getattr(ref, f)) < 1e-8, f
    assert _rel(joint.numpy(), ref_joint) < 1e-8
    with jax.enable_x64(True):
        sig_ref = jmarg.marginal_sigmas(jnp.asarray(ref.pose))
    np.testing.assert_allclose(marginals.marginal_sigmas(out.pose), sig_ref, rtol=1e-8)

    Sigma = _dense_cov_oracle(gt, vt, ct)
    lm_base = FRAME_DIM * n + BIAS_DIM
    idx = np.concatenate([
        np.arange(0, POSE_DIM),
        np.arange(FRAME_DIM * (n - 1), FRAME_DIM * (n - 1) + POSE_DIM),
        np.arange(FRAME_DIM + POSE_DIM, FRAME_DIM + POSE_DIM + VEL_DIM),
        np.arange(FRAME_DIM * n, FRAME_DIM * n + BIAS_DIM),
        np.arange(lm_base + LM_DIM * lms[0], lm_base + LM_DIM * lms[0] + LM_DIM),
        np.arange(lm_base + LM_DIM * lms[1], lm_base + LM_DIM * lms[1] + LM_DIM),
    ])
    np.testing.assert_allclose(joint.numpy(), Sigma[np.ix_(idx, idx)], rtol=1e-6, atol=1e-9)
    for a, i in enumerate(sel["pose_indices"]):
        s = slice(FRAME_DIM * i, FRAME_DIM * i + POSE_DIM)
        np.testing.assert_allclose(out.pose[a].numpy(), Sigma[s, s], rtol=1e-6, atol=1e-9)
    for a, j in enumerate(lms):
        s = slice(lm_base + LM_DIM * j, lm_base + LM_DIM * j + LM_DIM)
        np.testing.assert_allclose(out.landmark[a].numpy(), Sigma[s, s], rtol=1e-6, atol=1e-9)
    s = slice(FRAME_DIM * n, FRAME_DIM * n + BIAS_DIM)
    np.testing.assert_allclose(out.bias.numpy(), Sigma[s, s], rtol=1e-6, atol=1e-9)


def test_graph_to_dot_and_metrics_match_jax(problem):  # noqa: F811
    jg, jv = jax.device_get(problem["jax_out"][:2])
    tg, tv = problem["ours"][:2]
    n, m = tv.pose_quat.shape[0], tv.landmarks.shape[0]
    assert graphviz.graph_to_dot(to_port(tg, "cpu"), n, m) == jgraphviz.graph_to_dot(jg, n, m)
    rng = np.random.default_rng(9)
    est, gt = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    assert metrics.rpe_rmse(est, gt, 2) == jmetrics.rpe_rmse(est, gt, 2)
    assert metrics.ate_rmse(est, gt, align=True) == jmetrics.ate_rmse(est, gt, align=True)
    np.testing.assert_array_equal(metrics.trajectory_from_values(to_port(tv, "cpu")),
                                  np.asarray(tv.pose_trans, np.float64))


def test_plot_returns_figure_or_none(tmp_path):
    xyz = np.cumsum(np.random.default_rng(1).normal(size=(20, 3)), axis=0)
    fig = plot_trajectory_3d(xyz, xyz + 0.1, save_path=str(tmp_path / "t.png"))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert fig is None
    else:
        assert fig is not None and (tmp_path / "t.png").stat().st_size > 0
