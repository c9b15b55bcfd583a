"""Factor-graph containers, the per-keyframe graph builder and the IMU
whitener computation.

Port of :mod:`uslam_tpu.graph.builder`. The containers match the JAX
package's field for field (``uslam_tpu_torch.interop`` converts by field
name). Leaves are numpy arrays straight out of
:func:`uslam_tpu_torch.graph.packing.pack_sequence` and tensors on the
solve's device after :func:`uslam_tpu_torch.interop.to_port`.
:class:`GraphBuilder` is the reference-shaped per-keyframe path (host
numpy), kept for parity with the vectorized packer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from uslam_tpu_torch.config import UslamConfig
from uslam_tpu_torch.factors.imu import ImuIntervalData
from uslam_tpu_torch.graph.values import Values


class Priors(NamedTuple):
    pose_quat: torch.Tensor        # (4,)
    pose_trans: torch.Tensor       # (3,)
    pose_sigmas: torch.Tensor      # (6,) [rot x3, trans x3]
    vel: torch.Tensor              # (3,)
    vel_sigma: torch.Tensor        # ()
    bias: torch.Tensor             # (6,)
    bias_weight: torch.Tensor      # () = 1/sigma; 0 disables the bias prior
    # Dense marginal prior on [pose_0, vel_0, bias] (fixed-lag smoothing);
    # weight 0 in batch mode.
    marg_sqrt_info: torch.Tensor   # (15, 15)
    marg_pose_quat: torch.Tensor   # (4,)
    marg_pose_trans: torch.Tensor  # (3,)
    marg_vel: torch.Tensor         # (3,)
    marg_bias: torch.Tensor        # (6,)
    marg_weight: torch.Tensor      # ()


class ImuIntervals(NamedTuple):
    data: ImuIntervalData          # (N-1, S, ...) interval i couples (i, i+1)
    whitener: torch.Tensor         # (N-1, 9, 9) inv sqrt preintegration cov
    mask: torch.Tensor             # (N-1,) 1.0 where the interval has samples


class DvlMeasurements(NamedTuple):
    vel_body: torch.Tensor         # (N, 3)
    mask: torch.Tensor             # (N,) 1.0 where a DVL factor exists (i >= 1)


class StereoObservations(NamedTuple):
    cam_idx: torch.Tensor          # (F,) frame index
    lm_idx: torch.Tensor           # (F,) landmark row
    meas: torch.Tensor             # (F, 3) (uL, uR, v) pixels
    mask: torch.Tensor             # (F,) 1.0 valid
    lm_obs_idx: torch.Tensor       # (M, K) per-landmark indices into F
    lm_obs_mask: torch.Tensor      # (M, K)


class GraphArrays(NamedTuple):
    priors: Priors
    imu: ImuIntervals
    dvl: DvlMeasurements
    stereo: StereoObservations


def bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two (the JAX package's static-shape
    buckets, kept so packed graphs match it leaf for leaf)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def rank_within_group(keys: np.ndarray) -> np.ndarray:
    """ranks[i] = number of earlier elements with the same key."""
    o = np.argsort(keys, kind="stable")
    sk = keys[o]
    is_new = np.r_[True, sk[1:] != sk[:-1]]
    grp_first = np.maximum.accumulate(np.where(is_new, np.arange(len(sk)), 0))
    ranks = np.empty(len(keys), int)
    ranks[o] = np.arange(len(sk)) - grp_first
    return ranks


def stratified_obs_mask(keys: np.ndarray, cap: int) -> np.ndarray:
    """Keep min(count, cap) observations evenly spaced through each group's
    time order, so loop-closure re-observations survive the budget."""
    if not len(keys):
        return np.ones(0, bool)
    rank = rank_within_group(keys)
    counts = np.bincount(keys)[keys]
    return ((rank + 1) * cap) // counts > (rank * cap) // counts



@dataclass
class GraphBuilder:
    """Accumulates keyframes, then finalizes to (GraphArrays, Values): what
    the reference's ``batch_update`` accumulates per synchronized triple
    (batch.py:253-267) and its ``batch_create`` turns into factors
    (batch.py:270-305). Priors only at keyframe 0; IMU, DVL and stereo
    factors for every keyframe i >= 1; landmark ids interned to dense rows,
    the first observation giving the initial estimate."""

    config: UslamConfig
    poses: list = field(default_factory=list)        # (quat wxyz, trans)
    vels: list = field(default_factory=list)
    imu_buffers: list = field(default_factory=list)  # per keyframe (S_i, 7) [acc, gyro, dt]
    dvl_vels: list = field(default_factory=list)
    features: list = field(default_factory=list)     # per keyframe [(row, uL, uR, v)]
    landmark_init: dict = field(default_factory=dict)  # id -> (3,)
    _lm_rows: dict = field(default_factory=dict)     # id -> dense row

    def add_keyframe(
        self,
        pose_quat: np.ndarray,
        pose_trans: np.ndarray,
        imu_samples: np.ndarray | None,
        dvl_vel_body: np.ndarray | None,
        features: list | None = None,
        vel_init: np.ndarray | None = None,
    ) -> int:
        """Append one keyframe. ``imu_samples``: (S_i, 7) [ax, ay, az, gx,
        gy, gz, dt] buffered since the previous keyframe; ``features``:
        (landmark_id, uL, uR, v, init_world_xyz) tuples."""
        self.poses.append((np.asarray(pose_quat, np.float64), np.asarray(pose_trans, np.float64)))
        # The reference initializes every velocity to zero (batch.py:279).
        self.vels.append(np.zeros(3) if vel_init is None else np.asarray(vel_init, np.float64))
        self.imu_buffers.append(
            np.zeros((0, 7)) if imu_samples is None else np.asarray(imu_samples, np.float64)
        )
        self.dvl_vels.append(
            np.zeros(3) if dvl_vel_body is None else np.asarray(dvl_vel_body, np.float64)
        )
        frame_feats = []
        for lm_id, uL, uR, v, init_xyz in features or ():
            if lm_id not in self._lm_rows:
                self._lm_rows[lm_id] = len(self._lm_rows)
                self.landmark_init[lm_id] = np.asarray(init_xyz, np.float64)
            frame_feats.append((self._lm_rows[lm_id], uL, uR, v))
        self.features.append(frame_feats)
        return len(self.poses) - 1

    @property
    def num_keyframes(self) -> int:
        return len(self.poses)

    @property
    def num_landmarks(self) -> int:
        return len(self._lm_rows)

    def finalize(self, dtype=torch.float32, with_landmarks: bool = True, *, device="cuda"):
        """(GraphArrays, Values) of tensors on ``device``; float leaves in
        ``dtype``, indices int32. ``with_landmarks`` mirrors the reference's
        ``batch_create(with_landmark=...)`` (batch.py:270)."""
        from uslam_tpu_torch.interop import to_port  # interop imports this module

        cfg = self.config
        n = len(self.poses)
        if n < 1:
            raise ValueError("graph needs at least one keyframe")
        quats = np.stack([q for q, _ in self.poses])
        trans = np.stack([t for _, t in self.poses])
        vels = np.stack(self.vels)

        # IMU interval i uses the samples buffered AT keyframe i+1 (what
        # arrived since keyframe i), padded to a static S.
        S = max(
            cfg.imu.max_samples_per_keyframe,
            bucket(max((b.shape[0] for b in self.imu_buffers[1:]), default=1)),
        )
        n_int = max(n - 1, 1)
        acc, gyro = np.zeros((n_int, S, 3)), np.zeros((n_int, S, 3))
        dts, imu_mask = np.zeros((n_int, S)), np.zeros(n_int)
        for i in range(1, n):
            buf = self.imu_buffers[i][:S]
            s = buf.shape[0]
            if s > 0:
                acc[i - 1, :s], gyro[i - 1, :s], dts[i - 1, :s] = buf[:, 0:3], buf[:, 3:6], buf[:, 6]
                imu_mask[i - 1] = 1.0

        dvl = np.stack(self.dvl_vels)
        dvl_mask = np.ones(n)
        dvl_mask[0] = 0.0

        # Stereo observations at keyframes i >= 1, under the stratified
        # per-landmark budget (the packer's policy).
        obs_all = (
            [(i, *o) for i in range(1, n) for o in self.features[i]] if with_landmarks else []
        )
        if obs_all:
            keep = stratified_obs_mask(np.array([o[1] for o in obs_all]),
                                       cfg.solver.max_obs_per_landmark)
            obs = [o for o, k in zip(obs_all, keep) if k]
        else:
            obs = []
        m = len(self._lm_rows) if with_landmarks else 0
        f_real = len(obs)
        F = bucket(max(f_real, 1))
        cam_idx = np.zeros(F, np.int32)
        lm_idx = np.zeros(F, np.int32)
        meas = np.zeros((F, 3))
        s_mask = np.zeros(F)
        for k, (ci, li, uL, uR, v) in enumerate(obs):
            cam_idx[k], lm_idx[k] = ci, li
            meas[k] = (uL, uR, v)
            s_mask[k] = 1.0

        # Per-landmark observation grouping for the Schur elimination.
        M = bucket(max(m, 1))
        per_lm = [[] for _ in range(M)]
        for k in range(f_real):
            per_lm[lm_idx[k]].append(k)
        K = bucket(max((len(o) for o in per_lm), default=1), minimum=2)
        lm_obs_idx = np.zeros((M, K), np.int32)
        lm_obs_mask = np.zeros((M, K))
        for j, o in enumerate(per_lm):
            lm_obs_idx[j, : len(o)] = o
            lm_obs_mask[j, : len(o)] = 1.0

        landmarks = np.zeros((M, 3))
        if with_landmarks:
            for lm_id, row in self._lm_rows.items():
                landmarks[row] = self.landmark_init[lm_id]

        npt = np.float64 if dtype == torch.float64 else np.float32

        def arr(x):
            return np.asarray(x, npt)

        noise = cfg.noise
        bias_weight = 0.0 if noise.prior_bias_sigma is None else 1.0 / noise.prior_bias_sigma
        priors = Priors(
            pose_quat=arr(quats[0]),
            pose_trans=arr(trans[0]),
            pose_sigmas=arr(noise.prior_pose_sigmas),
            vel=arr(vels[0]),
            vel_sigma=arr(noise.prior_vel_sigma),
            bias=arr(np.zeros(6)),
            bias_weight=arr(bias_weight),
            marg_sqrt_info=arr(np.zeros((15, 15))),
            marg_pose_quat=arr([1.0, 0, 0, 0]),
            marg_pose_trans=arr(np.zeros(3)),
            marg_vel=arr(np.zeros(3)),
            marg_bias=arr(np.zeros(6)),
            marg_weight=arr(0.0),
        )
        imu = ImuIntervals(
            data=ImuIntervalData(acc=arr(acc), gyro=arr(gyro), dt=arr(dts)),
            whitener=arr(compute_imu_whiteners(ImuIntervalData(acc, gyro, dts), cfg)),
            mask=arr(imu_mask),
        )
        graph = GraphArrays(
            priors=priors,
            imu=imu,
            dvl=DvlMeasurements(vel_body=arr(dvl), mask=arr(dvl_mask)),
            stereo=StereoObservations(
                cam_idx=cam_idx, lm_idx=lm_idx, meas=arr(meas), mask=arr(s_mask),
                lm_obs_idx=lm_obs_idx, lm_obs_mask=arr(lm_obs_mask),
            ),
        )
        values = Values(
            pose_quat=arr(quats),
            pose_trans=arr(trans),
            vel=arr(vels),
            bias=arr(np.zeros(6)),
            landmarks=arr(landmarks),
        )
        return to_port(graph, device), to_port(values, device)

    def landmark_rows(self) -> dict:
        """id -> dense row mapping (for result extraction)."""
        return dict(self._lm_rows)


def _np_hat(w: np.ndarray) -> np.ndarray:
    """(F, 3) -> (F, 3, 3) skew-symmetric."""
    H = np.zeros((w.shape[0], 3, 3))
    H[:, 0, 1], H[:, 0, 2] = -w[:, 2], w[:, 1]
    H[:, 1, 0], H[:, 1, 2] = w[:, 2], -w[:, 0]
    H[:, 2, 0], H[:, 2, 1] = -w[:, 1], w[:, 0]
    return H


def _np_exp_and_left_jacobian(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Batched Rodrigues Exp(w) and SO(3) left Jacobian Jl(w), f64."""
    th2 = np.sum(w * w, axis=1)
    th = np.sqrt(th2)
    small = th < 1e-8
    with np.errstate(invalid="ignore", divide="ignore"):
        s = np.where(small, 1.0 - th2 / 6.0, np.sin(th) / np.where(small, 1.0, th))
        c = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(th)) / np.where(small, 1.0, th2))
        j2 = np.where(
            small, 1.0 / 6.0 - th2 / 120.0,
            (th - np.sin(th)) / np.where(small, 1.0, th2 * th),
        )
    H = _np_hat(w)
    H2 = H @ H
    eye = np.broadcast_to(np.eye(3), H.shape)
    R = eye + s[:, None, None] * H + c[:, None, None] * H2
    Jl = eye + c[:, None, None] * H + j2[:, None, None] * H2
    return R, Jl


def compute_imu_whiteners(data: ImuIntervalData, cfg: UslamConfig) -> np.ndarray:
    """Preintegration covariance at zero bias -> inv(chol(P)), (F, 9, 9) f64.

    The covariance recursion of Forster TRO'17 eq. 62-63 with GTSAM's
    continuous-time noise (per-sample covariance sigma^2/dt), vectorized
    over intervals in f64."""
    accel_cov, gyro_cov = cfg.imu.accel_cov, cfg.imu.gyro_cov
    integration_cov = cfg.imu.integration_cov
    acc = np.asarray(data.acc, np.float64)
    gyro = np.asarray(data.gyro, np.float64)
    dts = np.asarray(data.dt, np.float64)
    F, S, _ = acc.shape
    eye3 = np.broadcast_to(np.eye(3), (F, 3, 3))
    R = np.tile(np.eye(3), (F, 1, 1))
    P = np.zeros((F, 9, 9))
    for k in range(S):
        a, w, h = acc[:, k], gyro[:, k], dts[:, k]
        active = h > 0.0
        if not active.any():
            continue
        hs = h[:, None, None]
        dR, Jl_neg = _np_exp_and_left_jacobian(-w * h[:, None])
        Rh = _np_hat(a) * hs
        A = np.zeros((F, 9, 9))
        A[:, 0:3, 0:3] = dR                      # Exp(wdt)^T
        A[:, 3:6, 0:3] = -R @ Rh
        A[:, 3:6, 3:6] = np.eye(3)
        A[:, 6:9, 0:3] = -0.5 * (R @ Rh) * hs
        A[:, 6:9, 3:6] = eye3 * hs
        A[:, 6:9, 6:9] = np.eye(3)

        G_g = Jl_neg * hs
        G_av = R * hs
        G_ap = 0.5 * R * hs * hs
        with np.errstate(divide="ignore"):
            inv_h = np.where(active, 1.0 / np.maximum(h, 1e-9), 0.0)[:, None, None]
        Q = np.zeros((F, 9, 9))
        Q[:, 0:3, 0:3] = gyro_cov * inv_h * (G_g @ G_g.transpose(0, 2, 1))
        Q[:, 3:6, 3:6] = accel_cov * inv_h * (G_av @ G_av.transpose(0, 2, 1))
        Q[:, 3:6, 6:9] = accel_cov * inv_h * (G_av @ G_ap.transpose(0, 2, 1))
        Q[:, 6:9, 3:6] = Q[:, 3:6, 6:9].transpose(0, 2, 1)
        Q[:, 6:9, 6:9] = (
            accel_cov * inv_h * (G_ap @ G_ap.transpose(0, 2, 1))
            + integration_cov * hs * np.eye(3)
        )

        P_new = A @ P @ A.transpose(0, 2, 1) + Q
        m = active[:, None, None]
        P = np.where(m, P_new, P)
        R = np.where(m, R @ dR.transpose(0, 2, 1), R)

    L = np.linalg.cholesky(P + 1e-10 * np.eye(9))
    return np.linalg.solve(L, np.broadcast_to(np.eye(9), L.shape))
