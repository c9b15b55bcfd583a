"""Prior factors on the first pose, velocity and IMU bias (port of
:mod:`uslam_tpu.factors.priors`). The linearizer inlines the bias prior
as a weighted difference, as the JAX package's does."""

from __future__ import annotations

import torch

from uslam_tpu_torch.geometry.se3 import Pose3, pose_local


def prior_pose_residual(pose: Pose3, prior: Pose3, sigmas: torch.Tensor) -> torch.Tensor:
    """Log(prior^{-1} pose) / sigmas, sigmas ordered [rot(3), trans(3)]."""
    return pose_local(prior, pose) / sigmas


def prior_vel_residual(vel: torch.Tensor, prior: torch.Tensor, sigma) -> torch.Tensor:
    return (vel - prior) / sigma


def prior_bias_residual(bias: torch.Tensor, prior: torch.Tensor, sigma) -> torch.Tensor:
    return (bias - prior) / sigma
