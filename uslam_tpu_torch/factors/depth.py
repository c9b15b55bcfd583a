"""Depth from pressure (port of :mod:`uslam_tpu.factors.depth`, reference
batch.py:122-126). The reference substitutes this depth for the z of the
keyframe's initial estimate and adds no depth factor; neither does the
slice. :func:`depth_residual` is the JAX package's optional one."""

from __future__ import annotations

import torch

from uslam_tpu_torch.config import PressureConfig
from uslam_tpu_torch.geometry.se3 import Pose3


def pressure_to_depth(press_abs_mbar, cfg: PressureConfig = PressureConfig()):
    """depth = (p_mbar * 100 - atm) / (rho g); numbers, numpy or tensors."""
    pressure_pa = press_abs_mbar * 100.0
    return (pressure_pa - cfg.atm_pressure_pa) / (cfg.water_density * cfg.gravity)


def depth_residual(pose: Pose3, depth_meas, sigma: float) -> torch.Tensor:
    """Whitened residual on the pose's z, at least 1-d: the reference takes
    the converted depth as z directly (batch.py:133), and so does this."""
    return torch.atleast_1d((pose.trans[..., 2] - depth_meas) / sigma)
