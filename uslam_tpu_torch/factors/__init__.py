"""Whitened factor residuals (port of ``uslam_tpu.factors``): priors, IMU
preintegration (the ``preintegrate`` CUDA kernel on the card) and the IMU
factor, DVL velocity, stereo reprojection and pressure depth.

The public names are the JAX package's ``uslam_tpu.factors``. They load on
first use, so importing the subpackage imports no torch module.
"""

import importlib

_EXPORTS = {
    "ImuIntervalData": "imu",
    "preintegrate": "imu",
    "preintegrate_with_cov": "imu",
    "imu_residual": "imu",
    "dvl_residual": "dvl",
    "stereo_residual": "stereo",
    "prior_pose_residual": "priors",
    "prior_vel_residual": "priors",
    "prior_bias_residual": "priors",
    "pressure_to_depth": "depth",
    "depth_residual": "depth",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
