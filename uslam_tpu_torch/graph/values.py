"""Variable container (the port of :mod:`uslam_tpu.graph.values`).

Tangent layout used by all solvers:

    [ pose_0(6) vel_0(3) | pose_1(6) vel_1(3) | ... | bias(6) | lm_0(3) ... ]
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uslam_tpu_torch.geometry.se3 import Pose3, pose_retract

POSE_DIM = 6
VEL_DIM = 3
BIAS_DIM = 6
LM_DIM = 3
FRAME_DIM = POSE_DIM + VEL_DIM  # 9


class Values(NamedTuple):
    """pose_quat (N, 4) [w,x,y,z]; pose_trans (N, 3); vel (N, 3);
    bias (6,) = [accel_bias, gyro_bias]; landmarks (M, 3)."""

    pose_quat: torch.Tensor
    pose_trans: torch.Tensor
    vel: torch.Tensor
    bias: torch.Tensor
    landmarks: torch.Tensor

    @property
    def num_poses(self) -> int:
        return self.pose_quat.shape[0]

    @property
    def num_landmarks(self) -> int:
        return self.landmarks.shape[0]

    def pose(self, i) -> Pose3:
        return Pose3(self.pose_quat[i], self.pose_trans[i])

    def poses(self) -> Pose3:
        return Pose3(self.pose_quat, self.pose_trans)


def tangent_dim(num_poses: int, num_landmarks: int) -> int:
    return FRAME_DIM * num_poses + BIAS_DIM + LM_DIM * num_landmarks


def frame_offset(i):
    """Tangent offset of pose i; vel i is at +POSE_DIM."""
    return FRAME_DIM * i


def bias_offset(num_poses: int) -> int:
    return FRAME_DIM * num_poses


def landmark_offset(num_poses: int, j):
    return FRAME_DIM * num_poses + BIAS_DIM + LM_DIM * j


def values_retract(values: Values, delta: torch.Tensor) -> Values:
    """Poses by the SE(3) expmap (right perturbation), the rest by addition
    (GTSAM retract semantics)."""
    n, m = values.num_poses, values.num_landmarks
    frames = delta[: FRAME_DIM * n].reshape(n, FRAME_DIM)
    d_bias = delta[FRAME_DIM * n : FRAME_DIM * n + BIAS_DIM]
    d_lm = delta[FRAME_DIM * n + BIAS_DIM :].reshape(m, LM_DIM)
    new_pose = pose_retract(
        Pose3(values.pose_quat, values.pose_trans), frames[:, :POSE_DIM]
    )
    return Values(
        pose_quat=new_pose.quat,
        pose_trans=new_pose.trans,
        vel=values.vel + frames[:, POSE_DIM:],
        bias=values.bias + d_bias,
        landmarks=values.landmarks + d_lm,
    )
