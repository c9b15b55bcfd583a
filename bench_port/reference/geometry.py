"""Plain PyTorch SO(3) / SE(3) for the reference: quaternions [w, x, y, z],
GTSAM's tangent order xi = [omega, v] and right retraction T * Exp(xi).
Every function broadcasts over leading dimensions. Small-angle branches
evaluate the untaken branch on a safe argument, so forward-mode
derivatives at theta = 0 stay finite."""

from __future__ import annotations

import torch

EPS = 1e-8


def qmul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnormalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def qrotate(q, v):
    qw = q[..., :1]
    qv, v = torch.broadcast_tensors(q[..., 1:], v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def hat(w):
    z = torch.zeros_like(w[..., 0])
    wx, wy, wz = w.unbind(-1)
    return torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], -1).reshape(w.shape[:-1] + (3, 3))


def _theta(w):
    th2 = torch.sum(w * w, dim=-1)
    return torch.sqrt(torch.clamp(th2, min=0.0)), th2


def _safe(small, x):
    return torch.where(small, torch.ones_like(x), x)


def so3_exp(w):
    th, th2 = _theta(w)
    small = th2 < EPS
    s = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / _safe(small, th))
    c = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
    return torch.cat([c[..., None], s[..., None] * w], dim=-1)


def so3_log(q):
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vn2 = torch.sum(q[..., 1:] * q[..., 1:], dim=-1)
    vn = torch.sqrt(torch.clamp(vn2, min=0.0))
    small = vn2 < EPS * EPS
    scale = torch.where(
        small,
        2.0 / torch.clamp(w, min=EPS) * (1.0 - vn2 / (3.0 * torch.clamp(w * w, min=EPS))),
        2.0 * torch.atan2(vn, w) / _safe(small, vn),
    )
    return scale[..., None] * q[..., 1:]


def _eye(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def left_jacobian(w):
    th, th2 = _theta(w)
    small = th2 < EPS
    a = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / _safe(small, th2))
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / _safe(small, th2 * th))
    W = hat(w)
    return _eye(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def left_jacobian_inverse(w):
    th, th2 = _theta(w)
    small = th2 < EPS
    k = torch.where(
        small, 1.0 / 12.0 + th2 / 720.0,
        1.0 / _safe(small, th2) - torch.cos(0.5 * th) / _safe(small, 2.0 * th * torch.sin(0.5 * th)),
    )
    W = hat(w)
    return _eye(W) - 0.5 * W + k[..., None, None] * (W @ W)


def retract(q, t, xi):
    """(q, t) * Exp(xi), xi = [omega, v], Exp's translation J_l(omega) v."""
    dq = so3_exp(xi[..., :3])
    dt = (left_jacobian(xi[..., :3]) @ xi[..., 3:, None])[..., 0]
    return qnormalize(qmul(q, dq)), qrotate(q, dt) + t


def local(qa, ta, qb, tb):
    """Log(a^{-1} b) as [omega, v]."""
    qi = qconj(qa)
    q = qnormalize(qmul(qi, qb))
    t = qrotate(qi, tb - ta)
    omega = so3_log(q)
    return torch.cat([omega, (left_jacobian_inverse(omega) @ t[..., None])[..., 0]], dim=-1)
