"""IMU preintegration and the preintegrated IMU factor.

Port of :mod:`uslam_tpu.factors.imu`. The residual re-integrates the raw
samples at the current bias estimate (exact bias dependence through AD
instead of GTSAM's first-order correction). Samples are padded to a static
``S`` per interval; ``dt == 0`` rows integrate to a no-op.

The JAX package runs the integration as a ``lax.scan`` and differentiates
it with ``jax.jacfwd``. Here :func:`preintegrate` is a
``torch.autograd.Function`` whose forward returns the deltas and keeps
their (10, 6) Jacobian with respect to the bias, and whose ``jvp`` is that
Jacobian times the bias tangent: ``torch.func.jvp`` in the linearizer
reaches it instead of tracing the S steps. The forward dispatches on the
device of the samples and on nothing else:

- a CUDA tensor goes to the hand-written kernel ``csrc/preintegrate.cu``
  (:func:`preintegrate_cuda`), which raises on what it does not take;
- a CPU tensor goes to :func:`preintegrate_plain`, the same recursion in
  plain PyTorch carrying the six bias tangents beside the value;
- anything else raises.

The linearizer evaluates every interval at one bias, so it preintegrates
once per interval (:func:`preintegrate_with_jacobian`) and hands the
deltas to its tangent rows itself (uslam_tpu_torch/solvers/linearize.py).
The error needs no Jacobian: :func:`preintegrate_value` launches the
kernel's value-only variant.

:func:`preintegrate_loop` is the scan written as a Python loop over the
samples, value only; differentiated by ``torch.func.jacfwd`` it is the
oracle both are held to (tests/test_torch_preintegrate.py, chip_smoke.py).

The samples are data: a tangent on them is not propagated (the JAX
package never differentiates them either).

The whitener (GTSAM's sigma^2/dt discrete covariance, fixed at
preintegration) is computed once at packing time in float64 numpy
(:func:`uslam_tpu_torch.graph.builder.compute_imu_whiteners`).
:func:`preintegrate_with_cov` and :func:`whitener_from_cov` are the JAX
package's tensor versions of the same (the deltas beside the covariance,
then inv(chol(P))), plain PyTorch on the device of their inputs: no main
path reads them on the device.
Gravity follows ``MakeSharedU``: g = (0, 0, -gravity).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from uslam_tpu_torch.cuda_build import launch_counts, load, raise_on, stream_of
from uslam_tpu_torch.geometry.se3 import Pose3
from uslam_tpu_torch.geometry.so3 import (
    _EPS,
    quat_conjugate,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
    so3_exp,
    so3_hat,
    so3_left_jacobian,
    so3_log,
)

# Rows of the bias Jacobian: delta_q (4), delta_v (3), delta_p (3).
JAC_ROWS = 10
BIAS_DIM = 6


class ImuIntervalData(NamedTuple):
    """acc (..., S, 3) m/s^2; gyro (..., S, 3) rad/s; dt (..., S) s, 0 = pad."""

    acc: torch.Tensor
    gyro: torch.Tensor
    dt: torch.Tensor


class PreintegratedDelta(NamedTuple):
    delta_q: torch.Tensor   # (..., 4) body-frame rotation delta
    delta_v: torch.Tensor   # (..., 3) velocity delta in frame i
    delta_p: torch.Tensor   # (..., 3) position delta in frame i
    dt_total: torch.Tensor  # (...,)


def _identity_quat(lead: tuple, like: torch.Tensor) -> torch.Tensor:
    # Built on the device: a host constant would be a host-to-device copy,
    # which a CUDA graph capture forbids.
    return torch.cat([like.new_ones(lead + (1,)), like.new_zeros(lead + (3,))], dim=-1)


def preintegrate_loop(data: ImuIntervalData, bias: torch.Tensor) -> PreintegratedDelta:
    """Forward-Euler body-frame preintegration at bias [ba(3), bg(3)]:

        dR_{k+1} = dR_k Exp((w - bg) dt)
        dv_{k+1} = dv_k + dR_k (a - ba) dt
        dp_{k+1} = dp_k + dv_k dt + 0.5 dR_k (a - ba) dt^2

    The JAX package's scan as a Python loop, value only: the oracle.
    ``bias`` may carry extra leading dimensions; they broadcast against the
    interval dimensions of ``data``."""
    ba, bg = bias[..., :3], bias[..., 3:]
    acc, gyro, dts = data.acc, data.gyro, data.dt
    lead = torch.broadcast_shapes(acc.shape[:-2], ba.shape[:-1])
    q = _identity_quat(lead, acc)
    v = acc.new_zeros(lead + (3,))
    p = acc.new_zeros(lead + (3,))
    t = dts.new_zeros(dts.shape[:-1])
    for k in range(acc.shape[-2]):
        a_c = acc[..., k, :] - ba
        w_c = gyro[..., k, :] - bg
        dt = dts[..., k, None]
        acc_world = quat_rotate(q, a_c)
        p = p + v * dt + 0.5 * acc_world * dt * dt
        v = v + acc_world * dt
        q = quat_normalize(quat_multiply(q, so3_exp(w_c * dt)))
        t = t + dts[..., k]
    return PreintegratedDelta(q, v, p, t)


# ---- the plain version: value and six bias tangents ------------------------
# Vectors are columns along dim -2: a value (..., k, 1), its tangents with
# respect to the six bias entries (..., k, 6). Each tangent is what
# torch.func.jvp computes for the same operation of preintegrate_loop, in the
# same order of float operations (PyTorch's forward-mode rules: (a b)' = a' b
# + b' a, (a / b)' = (a' - b' (a / b)) / b, sqrt(x)' = x' / (2 sqrt(x)),
# |q|' = (q . q') / |q|); csrc/preintegrate.cu follows the same order, one
# column per thread.


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-2)


def _mul_dual(a, da, b, db):
    return a * b, da * b + db * a


def _qmul_dual(q1, dq1, q2, dq2):
    """quat_multiply of quaternion columns (..., 4, c) and its tangent."""
    a, da, b, db = (x.unbind(-2) for x in (q1, dq1, q2, dq2))

    def term(i, j):
        return _mul_dual(a[i], da[i], b[j], db[j])

    def combine(signs, pairs):
        (v, dv), rest = term(*pairs[0]), pairs[1:]
        for sign, pair in zip(signs, rest):
            t, dt = term(*pair)
            v, dv = (v + t, dv + dt) if sign > 0 else (v - t, dv - dt)
        return v, dv

    out = [
        combine((-1, -1, -1), ((0, 0), (1, 1), (2, 2), (3, 3))),
        combine((1, 1, -1), ((0, 1), (1, 0), (2, 3), (3, 2))),
        combine((-1, 1, 1), ((0, 2), (1, 3), (2, 0), (3, 1))),
        combine((1, -1, 1), ((0, 3), (1, 2), (2, 1), (3, 0))),
    ]
    return torch.stack([v for v, _ in out], dim=-2), torch.stack([d for _, d in out], dim=-2)


def _rotate_dual(q, dq, a, da):
    """quat_rotate(q, a) and its tangent."""
    qw, qv, dqw, dqv = q[..., :1, :], q[..., 1:, :], dq[..., :1, :], dq[..., 1:, :]
    t = 2.0 * _cross(qv, a)
    dt = 2.0 * (_cross(dqv, a) + _cross(qv, da))
    m, dm = _mul_dual(qw, dqw, t, dt)
    return a + m + _cross(qv, t), (da + dm) + (_cross(dqv, t) + _cross(qv, dt))


def _exp_dual(phi, dphi):
    """so3_exp(phi) and its tangent: the tangent of the branch taken, which
    is what ``torch.where`` gives under ``torch.func.jvp``."""
    th2 = torch.sum(phi * phi, dim=-2, keepdim=True)
    dth2 = torch.sum(dphi * phi + dphi * phi, dim=-2, keepdim=True)
    small = th2 < _EPS
    th = torch.sqrt(torch.clamp(th2, min=0.0))
    dth = dth2 / (2 * th)
    half, dhalf = 0.5 * th, 0.5 * dth
    sh, ch = torch.sin(half), torch.cos(half)
    safe = torch.where(small, torch.ones_like(th), th)
    dsafe = torch.where(small, torch.zeros_like(dth), dth)
    s_big = sh / safe
    ds_big = (dhalf * ch - dsafe * s_big) / safe
    s = torch.where(small, 0.5 - th2 / 48.0, s_big)
    ds = torch.where(small, -(dth2 / 48.0), ds_big)
    c = torch.where(small, 1.0 - th2 / 8.0, ch)
    dc = torch.where(small, -(dth2 / 8.0), dhalf * -sh)
    sw, dsw = _mul_dual(s, ds, phi, dphi)
    return torch.cat([c, sw], dim=-2), torch.cat([dc, dsw], dim=-2)


def _normalize_dual(q, dq):
    n = torch.linalg.vector_norm(q, dim=-2, keepdim=True)
    dn = torch.sum(q * dq, dim=-2, keepdim=True) / n
    qn = q / n
    return qn, (dq - dn * qn) / n


def preintegrate_plain(data: ImuIntervalData, bias: torch.Tensor):
    """Plain version: (:class:`PreintegratedDelta`, J (..., 10, 6)) with J
    the Jacobian of (delta_q, delta_v, delta_p) with respect to ``bias``,
    carried through the recursion as forward-mode tangents."""
    acc, gyro, dts = data.acc, data.gyro, data.dt
    lead = torch.broadcast_shapes(acc.shape[:-2], bias.shape[:-1])
    ba, bg = bias[..., :3, None], bias[..., 3:, None]
    eye = torch.eye(3, dtype=acc.dtype, device=acc.device)
    zero3 = torch.zeros_like(eye)
    da = torch.cat([-eye, zero3], dim=-1)   # d(a - ba)/d[ba, bg]
    dw = torch.cat([zero3, -eye], dim=-1)   # d(w - bg)/d[ba, bg]
    q = _identity_quat(lead, acc)[..., None]
    v = acc.new_zeros(lead + (3, 1))
    p = acc.new_zeros(lead + (3, 1))
    dq = acc.new_zeros(lead + (4, BIAS_DIM))
    dv = acc.new_zeros(lead + (3, BIAS_DIM))
    dp = acc.new_zeros(lead + (3, BIAS_DIM))
    t = dts.new_zeros(dts.shape[:-1])
    for k in range(acc.shape[-2]):
        a = acc[..., k, :, None] - ba
        w = gyro[..., k, :, None] - bg
        h = dts[..., k, None, None]
        r, dr = _rotate_dual(q, dq, a, da)
        p = p + v * h + 0.5 * r * h * h
        dp = dp + dv * h + 0.5 * dr * h * h
        v = v + r * h
        dv = dv + dr * h
        e, de = _exp_dual(w * h, dw * h)
        q, dq = _normalize_dual(*_qmul_dual(q, dq, e, de))
        t = t + dts[..., k]
    delta = PreintegratedDelta(q[..., 0], v[..., 0], p[..., 0], t)
    return delta, torch.cat([dq, dv, dp], dim=-2)


# ---- the CUDA kernel ---------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def preintegrate_cuda(data: ImuIntervalData, bias: torch.Tensor, jacobian: bool = True):
    """The kernel (csrc/preintegrate.cu): the same function as
    :func:`preintegrate_plain`, for CUDA tensors of float32 or float64.
    With ``jacobian=False`` the value-only variant runs and the Jacobian
    returned is None.

    The samples' leading shape must be a suffix of the broadcast leading
    shape (the linearizer's tangent rows over the intervals, or one bias
    for every interval): row r of the broadcast rows reads the samples of
    row ``r % R_data``. Other broadcasts raise."""
    acc, gyro, dts = data.acc, data.gyro, data.dt
    dtypes = tuple(_DTYPE_CODE)
    if acc.dim() < 2 or acc.shape[-1] != 3 or gyro.shape != acc.shape \
            or dts.shape != acc.shape[:-1] or bias.dim() < 1 or bias.shape[-1] != BIAS_DIM:
        raise ValueError(
            f"preintegrate: shapes acc {tuple(acc.shape)}, gyro {tuple(gyro.shape)}, "
            f"dt {tuple(dts.shape)}, bias {tuple(bias.shape)}"
        )
    if len({acc.dtype, gyro.dtype, dts.dtype, bias.dtype}) != 1 or acc.dtype not in dtypes:
        raise ValueError(
            f"preintegrate: need one dtype of {dtypes}, got acc {acc.dtype}, gyro {gyro.dtype}, "
            f"dt {dts.dtype}, bias {bias.dtype}"
        )
    if not all(x.device == acc.device and x.device.type == "cuda" for x in (gyro, dts, bias)):
        raise ValueError(
            f"preintegrate: need CUDA tensors on one device, got {acc.device}, {gyro.device}, "
            f"{dts.device}, {bias.device}"
        )
    S = acc.shape[-2]
    data_lead = tuple(acc.shape[:-2])
    lead = tuple(torch.broadcast_shapes(data_lead, bias.shape[:-1]))
    if lead[len(lead) - len(data_lead):] != data_lead:
        raise ValueError(
            f"preintegrate: the samples' leading shape {data_lead} is not a suffix of the "
            f"broadcast leading shape {lead}"
        )
    n_data = math.prod(data_lead)
    acc, gyro = (x.contiguous().reshape(n_data, S, 3) for x in (acc, gyro))
    dts = dts.contiguous().reshape(n_data, S)
    rows = math.prod(lead)
    # One bias for every row is read in place (row r reads bias row r % 1).
    if bias.numel() == BIAS_DIM:
        b = bias.contiguous().reshape(1, BIAS_DIM)
    else:
        b = bias.expand(lead + (BIAS_DIM,)).contiguous().reshape(rows, BIAS_DIM)
    q = acc.new_empty((rows, 4))
    v = acc.new_empty((rows, 3))
    p = acc.new_empty((rows, 3))
    jac = acc.new_empty((rows, JAC_ROWS, BIAS_DIM)) if jacobian else None
    t = acc.new_empty((n_data,))
    if rows > 0:
        if rows >= 2**31 or n_data * S >= 2**31 // 3:
            raise ValueError(f"preintegrate: too many rows {rows} x {S} samples")
        lib = load()
        code = lib.uslam_preintegrate(
            _DTYPE_CODE[acc.dtype], acc.data_ptr(), gyro.data_ptr(), dts.data_ptr(),
            b.data_ptr(), q.data_ptr(), v.data_ptr(), p.data_ptr(), t.data_ptr(),
            jac.data_ptr() if jacobian else None, rows, n_data, b.shape[0], S, stream_of(acc),
        )
        raise_on(lib, code, "preintegrate")
        launch_counts["preintegrate"] += 1
    delta = PreintegratedDelta(
        q.reshape(lead + (4,)), v.reshape(lead + (3,)), p.reshape(lead + (3,)),
        t.reshape(data_lead),
    )
    return delta, (jac.reshape(lead + (JAC_ROWS, BIAS_DIM)) if jacobian else None)


def preintegrate_with_jacobian(data: ImuIntervalData, bias: torch.Tensor):
    """(:class:`PreintegratedDelta`, bias Jacobian (..., 10, 6)): the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    kind = data.acc.device.type
    if kind == "cuda":
        return preintegrate_cuda(data, bias)
    if kind == "cpu":
        return preintegrate_plain(data, bias)
    raise ValueError(f"preintegrate: unsupported device {data.acc.device}")


def preintegrate_value(data: ImuIntervalData, bias: torch.Tensor) -> PreintegratedDelta:
    """The deltas alone, not differentiable: the kernel's value-only
    variant for CUDA tensors, :func:`preintegrate_loop` for CPU tensors."""
    kind = data.acc.device.type
    if kind == "cuda":
        return preintegrate_cuda(data, bias, jacobian=False)[0]
    if kind == "cpu":
        return preintegrate_loop(data, bias)
    raise ValueError(f"preintegrate: unsupported device {data.acc.device}")


class _Preintegrate(torch.autograd.Function):
    """The deltas, with the bias Jacobian as their forward-mode derivative."""

    @staticmethod
    def forward(acc, gyro, dt, bias):
        delta, jac = preintegrate_with_jacobian(ImuIntervalData(acc, gyro, dt), bias)
        return (*delta, jac)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[3], output[4])
        ctx.save_for_forward(output[4])

    @staticmethod
    def jvp(ctx, acc_t, gyro_t, dt_t, bias_t):
        # The samples' tangents (zeros under torch.func) are not propagated.
        (jac,) = ctx.saved_tensors
        d = (jac @ bias_t[..., :, None])[..., 0]
        return d[..., 0:4], d[..., 4:7], d[..., 7:10], None, None


def preintegrate(data: ImuIntervalData, bias: torch.Tensor) -> PreintegratedDelta:
    """Preintegrated deltas at bias [ba(3), bg(3)] (the recursion of
    :func:`preintegrate_loop`), forward-differentiable in ``bias``.

    ``bias`` may carry extra leading dimensions; they broadcast against the
    interval dimensions of ``data``."""
    return PreintegratedDelta(*_Preintegrate.apply(data.acc, data.gyro, data.dt, bias)[:4])


def preintegrate_with_cov(
    data: ImuIntervalData,
    bias: torch.Tensor,
    accel_cov: float,
    gyro_cov: float,
    integration_cov: float,
) -> tuple[PreintegratedDelta, torch.Tensor]:
    """Preintegrate and propagate the 9x9 covariance, state [dtheta, dv, dp]
    (Forster et al. TRO'17 eq. 62-63, the model GTSAM implements): with R_k
    the preintegrated rotation so far, a = acc - ba, w = gyro - bg,

        A = [ Exp(w dt)^T          0      0 ]
            [ -R_k hat(a) dt       I      0 ]
            [ -0.5 R_k hat(a) dt^2 I dt   I ]

        noise: dtheta <- Jr(w dt) dt n_g; dv <- R_k dt n_a;
               dp <- 0.5 R_k dt^2 n_a (+ integration noise on dp),

    each sample's noise the continuous-time density over dt (GTSAM's
    sigma^2 / dt). A loop over the samples in the order of the JAX
    package's scan; ``bias`` broadcasts against the intervals' leading
    dimensions as in :func:`preintegrate_loop`. Returns (deltas, P (..., 9, 9))."""
    ba, bg = bias[..., :3], bias[..., 3:]
    acc, gyro, dts = data.acc, data.gyro, data.dt
    lead = torch.broadcast_shapes(acc.shape[:-2], ba.shape[:-1])
    eye = torch.eye(3, dtype=acc.dtype, device=acc.device)
    q = _identity_quat(lead, acc)
    v = acc.new_zeros(lead + (3,))
    p = acc.new_zeros(lead + (3,))
    t = dts.new_zeros(dts.shape[:-1])
    P = acc.new_zeros(lead + (9, 9))
    for k in range(acc.shape[-2]):
        a_c = acc[..., k, :] - ba
        w_c = gyro[..., k, :] - bg
        dt = dts[..., k, None]
        h = dt[..., None]
        Rk = quat_to_matrix(q)
        acc_world = (Rk @ a_c[..., None])[..., 0]

        wdt = w_c * dt
        dq = so3_exp(wdt)
        hat_a = so3_hat(a_c)
        A = acc.new_zeros(lead + (9, 9))
        A[..., 0:3, 0:3] = quat_to_matrix(dq).mT
        A[..., 3:6, 0:3] = -Rk @ hat_a * h
        A[..., 3:6, 3:6] = eye
        A[..., 6:9, 0:3] = -0.5 * Rk @ hat_a * h * h
        A[..., 6:9, 3:6] = eye * h
        A[..., 6:9, 6:9] = eye

        # Right Jacobian Jr(wdt) = J_l(-wdt).
        G_g = so3_left_jacobian(-wdt) * h
        G_a_v = Rk * h
        G_a_p = 0.5 * Rk * h * h
        inv_dt = torch.where(h > 0.0, 1.0 / torch.clamp(h, min=1e-9), 0.0)
        Q = acc.new_zeros(lead + (9, 9))
        Q[..., 0:3, 0:3] = gyro_cov * inv_dt * (G_g @ G_g.mT)
        Q[..., 3:6, 3:6] = accel_cov * inv_dt * (G_a_v @ G_a_v.mT)
        Q[..., 3:6, 6:9] = accel_cov * inv_dt * (G_a_v @ G_a_p.mT)
        Q[..., 6:9, 3:6] = accel_cov * inv_dt * (G_a_p @ G_a_v.mT)
        Q[..., 6:9, 6:9] = accel_cov * inv_dt * (G_a_p @ G_a_p.mT) + integration_cov * h * eye

        # dt == 0 padding: identity transition, zero noise.
        P = torch.where(h <= 0.0, P, A @ P @ A.mT + Q)
        p = p + v * dt + 0.5 * acc_world * dt * dt
        v = v + acc_world * dt
        q = quat_normalize(quat_multiply(q, dq))
        t = t + dts[..., k]
    return PreintegratedDelta(q, v, p, t), P


def whitener_from_cov(P: torch.Tensor, jitter: float = 1e-12) -> torch.Tensor:
    """W = inv(chol(P + jitter I)), lower triangular, so W P W^T = I: the
    whitened residual is W @ r."""
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    L = torch.linalg.cholesky(P + jitter * eye)
    return torch.linalg.solve_triangular(L, eye.expand(P.shape), upper=False)


def imu_residual(
    pose_i: Pose3,
    vel_i: torch.Tensor,
    pose_j: Pose3,
    vel_j: torch.Tensor,
    bias: torch.Tensor,
    data: ImuIntervalData,
    gravity: float,
    whitener: torch.Tensor,
) -> torch.Tensor:
    """9-dim whitened ImuFactor residual [r_dR, r_dv, r_dp] (GTSAM):

        r_dR = Log( dR(b)^T R_i^T R_j )
        r_dv = R_i^T (v_j - v_i - g T)               - dv(b)
        r_dp = R_i^T (p_j - p_i - v_i T - 0.5 g T^2) - dp(b)

    with the deltas of :func:`preintegrate` at ``bias`` (any bias per row).
    The linearizer and the error take them once per interval instead
    (:func:`preintegrate_with_jacobian`, :func:`preintegrate_value`) and
    call :func:`imu_residual_of_delta`.
    """
    delta = preintegrate(data, bias)
    return imu_residual_of_delta(pose_i, vel_i, pose_j, vel_j, delta, gravity, whitener)


def imu_residual_of_delta(
    pose_i: Pose3,
    vel_i: torch.Tensor,
    pose_j: Pose3,
    vel_j: torch.Tensor,
    delta: PreintegratedDelta,
    gravity: float,
    whitener: torch.Tensor,
) -> torch.Tensor:
    """:func:`imu_residual` from given deltas."""
    T = delta.dt_total.to(pose_i.trans.dtype)[..., None]
    # Built on the device (no host-to-device copy: see _identity_quat).
    g = torch.cat([pose_i.trans.new_zeros(2), pose_i.trans.new_full((1,), -gravity)])

    qi_inv = quat_conjugate(pose_i.quat)
    r_dR = so3_log(
        quat_multiply(
            quat_conjugate(delta.delta_q), quat_multiply(qi_inv, pose_j.quat)
        )
    )
    r_dv = quat_rotate(qi_inv, vel_j - vel_i - g * T) - delta.delta_v
    r_dp = (
        quat_rotate(
            qi_inv, pose_j.trans - pose_i.trans - vel_i * T - 0.5 * g * T * T
        )
        - delta.delta_p
    )
    r = torch.cat(torch.broadcast_tensors(r_dR, r_dv, r_dp), dim=-1)
    return (whitener @ r[..., None])[..., 0]
