"""Offline SLAM pipeline on PyTorch (port of :mod:`uslam_tpu.pipeline`).

``run_sequence(seq, config)`` replays a sequence: the ORB front end over raw
stereo imagery in chunks of ``offline_chunk`` pairs (when the sequence
carries images and no precomputed features), host numpy time join and
graph packing (or, with ``fast_ingest=False``, the reference-shaped
per-keyframe :class:`AUVSlam` API), then one Levenberg-Marquardt solve,
optionally followed by the float64 polish.

Every entry point runs on ``device``, the card unless the caller asks for
the CPU; nothing here picks the CPU on its own, and asking for CUDA without
a GPU raises. ``FrontendConfig.use_pallas`` is ignored: the front-end
kernels dispatch on the device of their tensors.

Method map to the reference (batch.py): process_depth :122, process_odom
:128, update_imu :138, get_landmarks :144, batch_update :253, batch_create
:270, solve :337, save_graph_dot :338, plot and MSE :345.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from uslam_tpu_torch.config import DEFAULT_CONFIG, SolverConfig, UslamConfig
from uslam_tpu_torch.device import cast_tree, resolve_device, synchronize
from uslam_tpu_torch.eval.graphviz import save_graph_dot as _save_dot
from uslam_tpu_torch.eval.metrics import ate_rmse, mse_reference_compat, trajectory_from_values
from uslam_tpu_torch.eval.plot import plot_trajectory_3d
from uslam_tpu_torch.factors.depth import pressure_to_depth
from uslam_tpu_torch.frontend.tracker import StereoFrontend, integrate_gyro_rotvec
from uslam_tpu_torch.geometry.camera import StereoCamera, triangulate_stereo_np
from uslam_tpu_torch.graph.builder import GraphArrays, GraphBuilder
from uslam_tpu_torch.graph.packing import pack_sequence
from uslam_tpu_torch.graph.values import Values
from uslam_tpu_torch.interop import to_port
from uslam_tpu_torch.io.sequence import SensorSequence
from uslam_tpu_torch.io.timesync import approximate_time_join, slice_stream
from uslam_tpu_torch.solvers.banded import measure_band_width, measure_corr_window
from uslam_tpu_torch.solvers.lm import LMStats, optimize_lm
from uslam_tpu_torch.solvers.marginals import joint_marginal_covariance, marginal_covariances
from uslam_tpu_torch.solvers.polish import polish_f64

log = logging.getLogger("uslam_tpu_torch.pipeline")


@dataclass
class SlamResult:
    values: Values
    stats: LMStats
    graph: GraphArrays
    odom_compare: np.ndarray      # unmodified DVL odometry (eval baseline)
    solve_seconds: float
    metrics: dict = field(default_factory=dict)

    @property
    def trajectory(self) -> np.ndarray:
        """(N, 3) keyframe positions, float64 numpy."""
        return trajectory_from_values(self.values)


def require_full_float32(device: torch.device) -> None:
    """The normal equations must be solved in full float32 (the JAX package
    pins matmul precision to 'highest'): TF32 matmuls on the card would
    keep ~3 decimal digits. Raises if they are allowed."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be False")


def run_solver(graph, initial, cam, dvl_sigma, stereo_sigma, gravity,
               solver_cfg: SolverConfig, huber_delta=None):
    """LM entry (:func:`uslam_tpu_torch.solvers.lm.optimize_lm`: one CUDA
    graph per solve on the card, its loop a WHILE node), in full float32
    (:func:`require_full_float32`).
    ``solver_cfg.debug_nans`` checks every LM stage for non-finite values
    (:mod:`uslam_tpu_torch.solvers.lm`)."""
    require_full_float32(initial.pose_trans.device)
    return optimize_lm(
        graph, initial, cam, dvl_sigma, stereo_sigma, gravity, solver_cfg, huber_delta
    )


def banded_solver_config(solver_cfg: SolverConfig, graph: GraphArrays) -> SolverConfig:
    """For ``reduced_solver="banded"``: with ``band_width <= 0``, the config
    with ``band_width`` and ``banded_corr_window`` measured off the packed
    graph (host numpy); otherwise the given band width, and a correction
    window if set, checked against the measured ones, raising when
    undersized (an undersized band drops Hessian mass without a sign).
    Other configs come back unchanged."""
    if solver_cfg.reduced_solver != "banded":
        return solver_cfg
    bw = measure_band_width(graph.stereo)
    if solver_cfg.band_width <= 0:
        return dataclasses.replace(
            solver_cfg, band_width=bw, banded_corr_window=measure_corr_window(graph.stereo)
        )
    if solver_cfg.band_width < bw:
        raise ValueError(
            f"band_width {solver_cfg.band_width} < max landmark track span {bw} "
            "(measure_band_width)"
        )
    if solver_cfg.banded_corr_window > 0:
        cw = measure_corr_window(graph.stereo)
        if solver_cfg.banded_corr_window < cw:
            raise ValueError(
                f"banded_corr_window {solver_cfg.banded_corr_window} < measured chunk "
                f"frame span {cw} (measure_corr_window)"
            )
    return solver_cfg


class AUVSlam:
    """Batch SLAM with the reference's public surface: per-keyframe
    accumulation, one solve, marginals, graph export and plot."""

    def __init__(self, config: UslamConfig = DEFAULT_CONFIG, *, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.cam = StereoCamera.from_config(config.camera, device=self.device)
        self.builder = GraphBuilder(config)
        self.depth: float | None = None
        self._imu_buffer: list = []
        self.odom_compare: list = []   # unmodified DVL positions (batch.py:257)
        self._graph_cache = None

    # ---- measurement processing ------------------------------------------

    def process_depth(self, press_abs_mbar: float) -> float:
        """Pressure (mbar) -> depth (m), latched like the reference's
        callback (batch.py:37-38,122-126)."""
        self.depth = float(pressure_to_depth(press_abs_mbar, self.config.pressure))
        return self.depth

    def process_odom(self, quat_wxyz, pos_xyz, depth):
        """DVL pose -> (pose_adjust, pose_norm): z replaced by the pressure
        depth for the initial estimate, the untouched copy kept as the eval
        baseline (batch.py:128-136)."""
        quat = np.asarray(quat_wxyz, np.float64)
        pos = np.asarray(pos_xyz, np.float64)
        return (quat, np.array([pos[0], pos[1], depth])), (quat, pos)

    def update_imu(self, acc, gyro, dt: float | None = None):
        """Buffer one IMU sample (batch.py:138-141); ``dt`` defaults to the
        reference's fixed 0.005 s."""
        if dt is None:
            dt = self.config.imu.default_dt
        self._imu_buffer.append(np.concatenate([np.asarray(acc), np.asarray(gyro), [dt]]))

    def get_landmarks(self, ids, u0, v0, u1, v1, pose_quat, pose_trans):
        """De-normalize features and triangulate them from the given
        keyframe pose (batch.py:144-176). Returns (id, uL, uR, v, world_xyz)
        tuples."""
        cfg = self.config.camera
        u0, v0, u1, v1 = (np.asarray(a, np.float64) for a in (u0, v0, u1, v1))
        uL = (u0 + 1.0) * 0.5 * cfg.resolution_x
        uR = (u1 + 1.0) * 0.5 * cfg.resolution_x
        v = ((v0 + v1) / 2.0 + 1.0) * 0.5 * cfg.resolution_y
        world = triangulate_stereo_np(
            cfg, np.asarray(pose_quat, np.float64), np.asarray(pose_trans, np.float64),
            np.stack([uL, uR, v], axis=-1),
        ).astype(np.float32)
        return [
            (int(ids[k]), float(uL[k]), float(uR[k]), float(v[k]), world[k])
            for k in range(len(ids))
        ]

    def batch_update(self, odom_quat, odom_pos, dvl_vel_body, depth, features=None):
        """Add one synchronized keyframe; ``features`` is (ids, u0, v0, u1,
        v1) in normalized coordinates or None. Takes the IMU buffer, as
        batch.py:261-262 does."""
        (quat, pos_adj), (_quat, pos_n) = self.process_odom(odom_quat, odom_pos, depth)
        self.odom_compare.append(pos_n)
        imu = np.stack(self._imu_buffer) if self._imu_buffer else None
        self._imu_buffer = []
        feats = None
        if features is not None and len(features[0]) > 0:
            feats = self.get_landmarks(*features, quat, pos_adj)
        self.builder.add_keyframe(quat, pos_adj, imu, np.asarray(dvl_vel_body), feats)
        self._graph_cache = None
        return self.builder.num_keyframes - 1

    # ---- graph build and solve --------------------------------------------

    def batch_create(self, with_landmark: bool = True):
        """Accumulated keyframes -> (GraphArrays, Values) on the device
        (batch.py:270-305)."""
        graph, initial = self.builder.finalize(with_landmarks=with_landmark, device=self.device)
        self._graph_cache = (graph, initial)
        return graph, initial

    def solve(self, with_landmark: bool = True) -> SlamResult:
        """LM solve (batch.py:336-338), then the float64 polish when
        ``SolverConfig.f64_polish``. ``solve_seconds`` covers both; the
        metrics also carry ``polish_seconds`` and the ``polish_*`` info.
        With ``reduced_solver="banded"`` the band parameters are measured
        off the graph or checked (:func:`banded_solver_config`) and the
        metrics carry the ``band_width`` and ``banded_corr_window`` used."""
        if self._graph_cache is None:
            self.batch_create(with_landmark)
        graph, initial = self._graph_cache
        cfg = self.config
        solver_cfg = banded_solver_config(cfg.solver, graph)
        args = (self.cam, cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity, solver_cfg)
        t0 = time.perf_counter()
        values, stats = run_solver(graph, initial, *args, cfg.noise.stereo_huber_delta)
        synchronize(self.device)
        polish_info = None
        if cfg.solver.f64_polish:
            t1 = time.perf_counter()
            values, polish_info = polish_f64(
                graph, values, *args, huber_delta=cfg.noise.stereo_huber_delta,
                device=self.device,
            )
            synchronize(self.device)
            polish_info["polish_seconds"] = time.perf_counter() - t1
        odom = np.stack(self.odom_compare) if self.odom_compare else np.zeros((0, 3))
        result = SlamResult(
            values=values, stats=stats, graph=graph, odom_compare=odom,
            solve_seconds=time.perf_counter() - t0,
        )
        result.metrics = self.evaluate(result)
        if polish_info is not None:
            result.metrics.update(polish_info)
        if solver_cfg.reduced_solver == "banded":
            result.metrics.update(band_width=solver_cfg.band_width,
                                  banded_corr_window=solver_cfg.banded_corr_window)
        log.info(
            "solve: %d poses, %d landmarks, %d LM iters, error %.3e -> %.3e, %.2fs",
            initial.num_poses, initial.num_landmarks, stats.iterations,
            stats.initial_error, stats.final_error, result.solve_seconds,
        )
        return result

    def marginals(self, result: SlamResult, pose_indices=(), vel_indices=(),
                  landmark_indices=(), include_bias: bool = False):
        """Marginal covariances at the solution (GTSAM ``Marginals``); see
        :func:`compute_marginals`."""
        return compute_marginals(
            result, self.config, pose_indices=pose_indices, vel_indices=vel_indices,
            landmark_indices=landmark_indices, include_bias=include_bias,
        )

    def joint_marginals(self, result: SlamResult, keys):
        """Joint covariance over ``("pose", i)``, ``("vel", i)``,
        ``("bias",)``, ``("landmark", j)`` keys (GTSAM
        ``Marginals::jointMarginalCovariance``); see
        :func:`compute_joint_marginals`."""
        return compute_joint_marginals(result, self.config, keys)

    # ---- evaluation and export ----------------------------------------------

    def evaluate(self, result: SlamResult) -> dict[str, Any]:
        traj = result.trajectory
        metrics: dict[str, Any] = {
            "num_poses": int(result.values.num_poses),
            "num_landmarks": int(result.values.num_landmarks),
            "lm_iterations": int(result.stats.iterations),
            "initial_error": float(result.stats.initial_error),
            "final_error": float(result.stats.final_error),
            "converged": bool(result.stats.converged),
            "solve_seconds": result.solve_seconds,
        }
        if len(result.odom_compare) == len(traj) and len(traj) > 0:
            metrics["mse_vs_odom"] = mse_reference_compat(
                traj, result.odom_compare, self.config.eval.z_datum_shift
            )
            metrics["ate_rmse_vs_odom"] = ate_rmse(traj, result.odom_compare)
        return metrics

    def save_graph_dot(self, path: str) -> None:
        if self._graph_cache is None:
            self.batch_create()
        graph, initial = self._graph_cache
        _save_dot(path, graph, initial.num_poses, initial.num_landmarks)

    def plot(self, result: SlamResult, save_path: str | None = None, show: bool = False):
        return plot_trajectory_3d(
            result.trajectory, result.odom_compare, save_path=save_path, show=show
        )


def _f64_inputs(result: SlamResult, config: UslamConfig):
    """(graph, values, cam) of a result in float64 on the result's device.
    The camera is made in float32 first, as the solve's was."""
    dev = result.values.pose_trans.device
    cam = StereoCamera.from_config(config.camera, device=dev)
    return tuple(cast_tree(t, torch.float64, dev) for t in (result.graph, result.values, cam))


def compute_marginals(
    result: SlamResult,
    config: UslamConfig = DEFAULT_CONFIG,
    pose_indices=(),
    vel_indices=(),
    landmark_indices=(),
    include_bias: bool = False,
):
    """Marginal covariances of selected states at a result's solution, in
    float64 on the result's device: the selected-column solves run through
    the weak global modes, which float32 cannot represent."""
    graph, values, cam = _f64_inputs(result, config)
    return marginal_covariances(
        graph, values, cam,
        config.noise.dvl_sigma, config.noise.stereo_sigma, config.imu.gravity,
        pose_indices=pose_indices, vel_indices=vel_indices,
        landmark_indices=landmark_indices, include_bias=include_bias,
        jitter=0.0, refine_iters=2, device=values.pose_trans.device,
    )


def compute_joint_marginals(result: SlamResult, config: UslamConfig = DEFAULT_CONFIG, keys=()):
    """Joint covariance over selected states at a result's solution, in
    float64 on the result's device (see :func:`compute_marginals`)."""
    graph, values, cam = _f64_inputs(result, config)
    return joint_marginal_covariance(
        graph, values, cam,
        config.noise.dvl_sigma, config.noise.stereo_sigma, config.imu.gravity, keys,
        jitter=0.0, refine_iters=2, device=values.pose_trans.device,
    )


def _run_frontend(seq: SensorSequence, config: UslamConfig, device, ransac_idx) -> list:
    """ORB front end over the whole image stream, ``offline_chunk`` stereo
    pairs per batched step."""
    fe = StereoFrontend(config.camera, config.frontend, device=device, ransac_idx=ransac_idx)
    n_frames = len(seq.image_t)
    # Integrated gyro rotation per inter-frame interval (host numpy).
    rotvecs = np.zeros((n_frames, 3), np.float32)
    for i in range(1, n_frames):
        if len(seq.imu_t):
            sl = slice_stream(seq.imu_t, float(seq.image_t[i - 1]), float(seq.image_t[i]))
            if sl.stop > sl.start:
                rotvecs[i] = integrate_gyro_rotvec(
                    seq.imu_gyro[sl.start : sl.stop], config.imu.default_dt
                )
    chunk = max(1, int(config.frontend.offline_chunk))
    features = []
    for c0 in range(0, n_frames, chunk):
        c1 = min(c0 + chunk, n_frames)
        features.extend(
            fe.process_chunk(
                seq.images_left[c0:c1], seq.images_right[c0:c1],
                seq.image_t[c0:c1], rotvecs[c0:c1],
                pad_to=chunk if c1 - c0 < chunk else None,
            )
        )
    return features


def _replay_keyframes(slam: AUVSlam, seq: SensorSequence, config: UslamConfig) -> None:
    """Feed the sequence through the per-keyframe API (the reference's
    ``__main__`` loop, batch.py:309-343): time join, latest depth, the IMU
    samples since the previous keyframe, one ``batch_update`` per triple."""
    feat_t = np.array([f.t for f in seq.features]) if seq.features else np.zeros(0)
    streams = [seq.dvl_twist_t] + ([feat_t] if len(feat_t) else [])
    prev_t = None
    for pivot_i, picks in approximate_time_join(seq.dvl_pose_t, streams, config.timesync.slop):
        t = float(seq.dvl_pose_t[pivot_i])
        pi = int(np.searchsorted(seq.pressure_t, t, side="right")) - 1
        if pi < 0:
            continue  # no depth yet: the reference drops the triple (batch.py:54)
        depth = float(pressure_to_depth(seq.pressure_mbar[pi], config.pressure))
        sl = slice_stream(seq.imu_t, prev_t if prev_t is not None else -np.inf, t)
        for k in range(sl.start, sl.stop):
            slam.update_imu(seq.imu_acc[k], seq.imu_gyro[k], config.imu.default_dt)
        prev_t = t
        features = None
        if len(feat_t):
            ff = seq.features[picks[1]]
            features = (ff.ids, ff.u0, ff.v0, ff.u1, ff.v1)
        slam.batch_update(
            seq.dvl_pose_quat[pivot_i], seq.dvl_pose_pos[pivot_i],
            seq.dvl_twist_vel[picks[0]], depth, features,
        )


def run_sequence(
    seq: SensorSequence,
    config: UslamConfig = DEFAULT_CONFIG,
    *,
    device="cuda",
    with_landmarks: bool = True,
    fast_ingest: bool = True,
    ransac_idx=None,
) -> SlamResult:
    """Offline end-to-end driver: front end (if the sequence has images and
    no features), ingest, one LM solve on ``device``. As in the JAX
    package, the front end's output is stored in ``seq.features``.
    ``fast_ingest`` uses the vectorized packer; False replays the sequence
    through the per-keyframe API. ``ransac_idx`` (64,) overrides the front
    end's seeded RANSAC hypothesis indices.

    Beyond the JAX package's metrics, ``result.metrics`` carries
    ``frontend_frames``, ``frontend_seconds`` and ``pack_seconds`` (the
    ingest either way)."""
    device = resolve_device(device)
    timing: dict[str, Any] = {}
    if not seq.features and seq.images_left is not None:
        t0 = time.perf_counter()
        features = _run_frontend(seq, config, device, ransac_idx)
        timing["frontend_frames"] = len(features)
        timing["frontend_seconds"] = time.perf_counter() - t0
        log.info(
            "frontend: %d stereo frames in %.2fs", len(features), timing["frontend_seconds"]
        )
        seq.features = features

    slam = AUVSlam(config, device=device)
    t0 = time.perf_counter()
    if fast_ingest:
        graph_np, initial_np, odom_compare, _rows = pack_sequence(
            seq, config, with_landmarks=with_landmarks
        )
        slam._graph_cache = (to_port(graph_np, device), to_port(initial_np, device))
        slam.odom_compare = list(odom_compare)
    else:
        _replay_keyframes(slam, seq, config)
        slam.batch_create(with_landmarks)
    timing["pack_seconds"] = time.perf_counter() - t0

    result = slam.solve(with_landmark=with_landmarks)
    result.metrics.update(timing)
    if seq.gt_pos is not None and len(seq.gt_pos) >= len(result.trajectory):
        result.metrics["ate_rmse_vs_gt"] = ate_rmse(
            result.trajectory, seq.gt_pos[: len(result.trajectory)]
        )
    return result
