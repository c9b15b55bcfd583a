"""SE(3) poses as (quaternion, translation) pairs.

Port of :mod:`uslam_tpu.geometry.se3`: GTSAM tangent order
``xi = [omega, v]`` and right retraction ``retract(T, xi) = T * Exp(xi)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uslam_tpu_torch.geometry.so3 import (
    quat_conjugate,
    quat_identity,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    so3_exp,
    so3_left_jacobian,
    so3_left_jacobian_inverse,
    so3_log,
)


class Pose3(NamedTuple):
    """Rigid transform x_world = R(quat) @ x_local + trans; quat (...,4)
    [w,x,y,z], trans (...,3)."""

    quat: torch.Tensor
    trans: torch.Tensor


def pose_identity(dtype=torch.float32, device="cuda") -> Pose3:
    """The identity pose on ``device`` (the card unless the caller asks for another)."""
    return Pose3(quat_identity(dtype, device), torch.zeros(3, dtype=dtype, device=device))


def pose_compose(a: Pose3, b: Pose3) -> Pose3:
    """a * b (apply b first, then a)."""
    return Pose3(
        quat_normalize(quat_multiply(a.quat, b.quat)),
        quat_rotate(a.quat, b.trans) + a.trans,
    )


def pose_inverse(p: Pose3) -> Pose3:
    qinv = quat_conjugate(p.quat)
    return Pose3(qinv, -quat_rotate(qinv, p.trans))


def pose_between(a: Pose3, b: Pose3) -> Pose3:
    """a^{-1} * b."""
    return pose_compose(pose_inverse(a), b)


def pose_transform_point(p: Pose3, x: torch.Tensor) -> torch.Tensor:
    """World point from local point: R x + t."""
    return quat_rotate(p.quat, x) + p.trans


def pose_transform_point_inverse(p: Pose3, x: torch.Tensor) -> torch.Tensor:
    """Local point from world point: R^T (x - t)."""
    return quat_rotate(quat_conjugate(p.quat), x - p.trans)


def se3_exp(xi: torch.Tensor) -> Pose3:
    """xi = [omega, v] (...,6) -> Pose3 with t = J_l(omega) v."""
    omega = xi[..., :3]
    v = xi[..., 3:]
    t = (so3_left_jacobian(omega) @ v[..., None])[..., 0]
    return Pose3(so3_exp(omega), t)


def se3_log(p: Pose3) -> torch.Tensor:
    """Pose3 -> xi = [omega, v] (...,6)."""
    omega = so3_log(p.quat)
    v = (so3_left_jacobian_inverse(omega) @ p.trans[..., None])[..., 0]
    return torch.cat([omega, v], dim=-1)


def pose_retract(p: Pose3, xi: torch.Tensor) -> Pose3:
    """Right retraction: p * Exp(xi)."""
    return pose_compose(p, se3_exp(xi))


def pose_local(a: Pose3, b: Pose3) -> torch.Tensor:
    """Log(a^{-1} b)."""
    return se3_log(pose_between(a, b))
