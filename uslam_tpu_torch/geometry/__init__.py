"""SO(3)/SE(3) geometry and the rectified stereo camera (port of
``uslam_tpu.geometry``): quaternions ``[w, x, y, z]``, GTSAM tangent order
``[omega, v]``, right retraction, tensor functions that broadcast over
leading dimensions.

The public names are the JAX package's ``uslam_tpu.geometry``. They load on
first use, so importing the subpackage imports no torch module.
"""

import importlib

_EXPORTS = {
    "quat_identity": "so3",
    "quat_multiply": "so3",
    "quat_conjugate": "so3",
    "quat_normalize": "so3",
    "quat_rotate": "so3",
    "quat_to_matrix": "so3",
    "matrix_to_quat": "so3",
    "so3_exp": "so3",
    "so3_log": "so3",
    "so3_hat": "so3",
    "so3_vee": "so3",
    "so3_left_jacobian": "so3",
    "so3_left_jacobian_inverse": "so3",
    "Pose3": "se3",
    "pose_identity": "se3",
    "pose_compose": "se3",
    "pose_inverse": "se3",
    "pose_between": "se3",
    "pose_transform_point": "se3",
    "pose_transform_point_inverse": "se3",
    "se3_exp": "se3",
    "se3_log": "se3",
    "pose_retract": "se3",
    "pose_local": "se3",
    "StereoCamera": "camera",
    "stereo_project": "camera",
    "stereo_backproject": "camera",
    "triangulate_stereo": "camera",
    "normalized_to_pixels": "camera",
    "project_world_point": "camera",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
