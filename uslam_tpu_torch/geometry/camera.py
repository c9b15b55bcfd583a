"""Rectified stereo camera (GTSAM ``Cal3_S2Stereo`` semantics).

Port of :mod:`uslam_tpu.geometry.camera`: measurements are ``(uL, uR, v)``
and back-projection uses the mean focal length, as the reference does
(batch.py:152-163).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uslam_tpu_torch.config import CameraConfig
from uslam_tpu_torch.geometry.se3 import (
    Pose3,
    pose_transform_point,
    pose_transform_point_inverse,
)


class StereoCamera(NamedTuple):
    """Calibration as 0-d tensors on the solve's device."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    baseline: torch.Tensor

    @classmethod
    def from_config(
        cls, cfg: CameraConfig, *, device, dtype=torch.float32
    ) -> "StereoCamera":
        def t(v):
            return torch.tensor(v, dtype=dtype, device=device)

        return cls(t(cfg.fx), t(cfg.fy), t(cfg.cx), t(cfg.cy), t(cfg.baseline))


def stereo_project(cam: StereoCamera, p_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame point(s) (...,3) -> (uL, uR, v) (...,3)."""
    x, y, z = p_cam.unbind(-1)
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    uL = cam.fx * x / z_safe + cam.cx
    uR = cam.fx * (x - cam.baseline) / z_safe + cam.cx
    v = cam.fy * y / z_safe + cam.cy
    return torch.stack([uL, uR, v], dim=-1)


def project_world_point(
    cam: StereoCamera, pose_world_body: Pose3, p_world: torch.Tensor
) -> torch.Tensor:
    """The stereo factor's forward model: world point through a body pose."""
    return stereo_project(cam, pose_transform_point_inverse(pose_world_body, p_world))


def stereo_backproject(cam: StereoCamera, meas: torch.Tensor) -> torch.Tensor:
    """(uL, uR, v) (..., 3) -> camera-frame point (..., 3), in the tensor's
    dtype: W = |uR - uL| / baseline, x = (uL - cx) / W, y = (v - cy) / W,
    z = f_mean / W (batch.py:156-163 with the disparity's magnitude)."""
    uL, uR, v = meas.unbind(-1)
    W = torch.clamp(torch.abs(uR - uL), min=1e-6) / cam.baseline
    f_mean = 0.5 * (cam.fx + cam.fy)
    return torch.stack([(uL - cam.cx) / W, (v - cam.cy) / W, f_mean / W], dim=-1)


def triangulate_stereo(
    cam: StereoCamera, cam_pose_world: Pose3, meas: torch.Tensor
) -> torch.Tensor:
    """Back-project stereo measurements and move them into the world by the
    camera's pose world_T_cam."""
    return pose_transform_point(cam_pose_world, stereo_backproject(cam, meas))


def quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """(..., 4) wxyz -> (..., 3, 3), float64 numpy."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), np.float64)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def triangulate_stereo_np(cam_cfg, quats, trans, meas) -> np.ndarray:
    """Back-project (F,) stereo measurements at world_T_cam poses, numpy f64.

    ``cam_cfg``: CameraConfig; quats (F, 4) wxyz; trans (F, 3); meas (F, 3)
    as (uL, uR, v)."""
    meas = np.asarray(meas, np.float64)
    uL, uR, v = meas[..., 0], meas[..., 1], meas[..., 2]
    d = np.maximum(np.abs(uR - uL), 1e-6)
    W = d / cam_cfg.baseline
    p_cam = np.stack(
        [
            (uL - cam_cfg.cx) / W,
            (v - cam_cfg.cy) / W,
            (0.5 * (cam_cfg.fx + cam_cfg.fy)) / W,
        ],
        axis=-1,
    )
    R = quat_to_matrix_np(np.asarray(quats, np.float64))
    return np.einsum("...ij,...j->...i", R, p_cam) + np.asarray(trans, np.float64)
