"""SO(3): quaternions, exponential and log maps, left Jacobians.

Port of :mod:`uslam_tpu.geometry.so3`. Quaternions are ``[w, x, y, z]``.
Every function broadcasts over leading dimensions, so the linearizer can
push a batch of tangent basis vectors through them in one call.

Small-angle branches keep the double-``where`` trick: the untaken branch is
evaluated on a safe argument, so the forward-mode derivatives the
linearizer takes at theta = 0 pick up no NaN from it (reverse mode through
the square root at 0 is not supported, as in the JAX package).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def quat_identity(dtype=torch.float32, device="cuda") -> torch.Tensor:
    """[1, 0, 0, 0] on ``device`` (the card unless the caller asks for another)."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2, both [w,x,y,z]."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    # Negation instead of a product with a (1, -1, -1, -1) constant: the
    # same bits, and no host-to-device copy (which a CUDA graph forbids).
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion q: R(q) @ v (two cross products)."""
    qw = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) [w,x,y,z] (...,4) -> rotation matrices (...,3,3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (...,3,3) -> unit quaternions [w,x,y,z] (...,4).

    Branch-free Shepperd method, as the JAX package: all four candidates,
    the one with the largest pivot kept (the first on ties), sign w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS * _EPS))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], dim=-1
    )
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)], dim=-1
    )
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)], dim=-1
    )
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3], dim=-1
    )
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Vector(s) (...,3) -> skew-symmetric matrix (...,3,3)."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w.unbind(-1)
    return torch.stack(
        [zeros, -wz, wy, wz, zeros, -wx, -wy, wx, zeros], dim=-1
    ).reshape(w.shape[:-1] + (3, 3))


def so3_vee(m: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix (...,3,3) -> vector (...,3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _theta(w: torch.Tensor):
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    return theta, theta_sq


def _safe(small: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` where not small, 1 where small (the inner ``where``)."""
    return torch.where(small, torch.ones_like(x), x)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map: rotation vector (...,3) -> unit quaternion (...,4)."""
    theta, theta_sq = _theta(w)
    half = 0.5 * theta
    small = theta_sq < _EPS
    sinc_half = torch.where(
        small, 0.5 - theta_sq / 48.0, torch.sin(half) / _safe(small, theta)
    )
    cw = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([cw[..., None], sinc_half[..., None] * w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Log map: unit quaternion (...,4) -> rotation vector (...,3)."""
    q = torch.where(q[..., :1] < 0, -q, q)  # shortest arc
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vn_sq = torch.sum(q[..., 1:] * q[..., 1:], dim=-1)
    vn = torch.sqrt(torch.clamp(vn_sq, min=0.0))
    small = vn_sq < _EPS * _EPS
    angle = 2.0 * torch.atan2(vn, w)
    scale = torch.where(
        small,
        2.0 / torch.clamp(w, min=_EPS)
        * (1.0 - vn_sq / (3.0 * torch.clamp(w * w, min=_EPS))),
        angle / _safe(small, vn),
    )
    return scale[..., None] * q[..., 1:]


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """J_l = I + (1-cos t)/t^2 W + (t - sin t)/t^3 W^2, W = hat(w)."""
    theta, theta_sq = _theta(w)
    small = theta_sq < _EPS
    a = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / _safe(small, theta_sq)
    )
    b = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / _safe(small, theta_sq * theta),
    )
    W = so3_hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_left_jacobian_inverse(w: torch.Tensor) -> torch.Tensor:
    """J_l^-1 = I - W/2 + (1/t^2 - (1+cos t)/(2 t sin t)) W^2."""
    theta, theta_sq = _theta(w)
    small = theta_sq < _EPS
    half = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 / _safe(small, theta_sq))
        - (torch.cos(half) / _safe(small, 2.0 * theta * torch.sin(half))),
    )
    W = so3_hat(w)
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)
