"""Trajectory metrics, numpy (port of :mod:`uslam_tpu.eval.metrics`)."""

from __future__ import annotations

import numpy as np

from uslam_tpu_torch.graph.values import Values


def trajectory_from_values(values: Values) -> np.ndarray:
    """(N, 3) keyframe positions, float64 numpy."""
    return values.pose_trans.detach().cpu().numpy().astype(np.float64)


def mse_reference_compat(
    slam_xyz: np.ndarray, odom_xyz: np.ndarray, z_datum_shift: float = 0.7433
) -> float:
    """The reference's MSE (batch.py:362-367): odometry shifted down by
    ``z_datum_shift`` in z, then the mean of all squared coordinate
    differences."""
    odom = np.asarray(odom_xyz, np.float64) - np.array([0.0, 0.0, z_datum_shift])
    diff = odom - np.asarray(slam_xyz, np.float64)
    return float(np.mean(diff**2))


def ate_rmse(
    estimate_xyz: np.ndarray, reference_xyz: np.ndarray, align: bool = False
) -> float:
    """Absolute trajectory error: RMSE over positions; ``align`` first
    removes the best-fit rigid transform (Umeyama without scale)."""
    est = np.asarray(estimate_xyz, np.float64)
    ref = np.asarray(reference_xyz, np.float64)
    if align:
        est = _umeyama_align(est, ref)
    return float(np.sqrt(np.mean(np.sum((est - ref) ** 2, axis=-1))))


def rpe_rmse(
    estimate_xyz: np.ndarray, reference_xyz: np.ndarray, delta: int = 1
) -> float:
    """Relative pose error: translation RMSE over ``delta``-step increments."""
    est = np.asarray(estimate_xyz, np.float64)
    ref = np.asarray(reference_xyz, np.float64)
    d_est = est[delta:] - est[:-delta]
    d_ref = ref[delta:] - ref[:-delta]
    return float(np.sqrt(np.mean(np.sum((d_est - d_ref) ** 2, axis=-1))))


def _umeyama_align(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """src moved by the rigid (R, t) that best aligns it to dst."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    S, D = src - mu_s, dst - mu_d
    U, _, Vt = np.linalg.svd(D.T @ S / len(src))
    R = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    return (R @ S.T).T + mu_d
