"""Linearization: whitened residuals and tangent-space Jacobians.

Port of :mod:`uslam_tpu.solvers.linearize`. Every factor family linearizes
as one batched call producing stacked residuals and dense Jacobian blocks;
masked (padding) factors give exactly zero rows.

The JAX package takes ``jax.jacfwd`` at the zero tangent. Here the same
forward-mode derivative is one ``torch.func.jvp`` over a batch of tangent
basis vectors: the factor functions broadcast over leading dimensions, so
the ``dim`` basis directions ride as one extra leading axis and every
column of the Jacobian comes out of a single pass. The IMU preintegration
runs once per interval (the CUDA kernel ``csrc/preintegrate.cu`` on the
card) and reaches the tangent rows through a ``torch.autograd.Function``
whose ``jvp`` is its bias Jacobian.

:func:`linearize_graph` and :func:`graph_error` dispatch on the device of
the values: on CUDA they replay a CUDA graph cached by shape
(:mod:`uslam_tpu_torch.solvers.compiled`, the counterpart of the JAX
package's ``jax.jit``); on the CPU they run their eager bodies,
:func:`linearize_graph_eager` and :func:`graph_error_eager`, which stay
callable on CUDA so that the two can be compared.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uslam_tpu_torch.factors.dvl import dvl_residual
from uslam_tpu_torch.factors.imu import (
    BIAS_DIM,
    JAC_ROWS,
    PreintegratedDelta,
    imu_residual_of_delta,
    preintegrate_value,
    preintegrate_with_jacobian,
)
from uslam_tpu_torch.factors.priors import prior_pose_residual, prior_vel_residual
from uslam_tpu_torch.factors.stereo import stereo_residual
from uslam_tpu_torch.geometry.camera import StereoCamera
from uslam_tpu_torch.geometry.se3 import Pose3, pose_local, pose_retract
from uslam_tpu_torch.graph.builder import GraphArrays
from uslam_tpu_torch.graph.values import Values
from uslam_tpu_torch.solvers import compiled


class _DeltaAtLinearizationBias(torch.autograd.Function):
    """The IMU deltas of the linearization point, as the tangent rows see
    them: ``forward`` returns the deltas preintegrated at the values' bias
    b0, broadcast to the leading shape of ``bias``, whatever ``bias`` holds;
    ``jvp`` is the bias Jacobian at b0 times the bias tangent. So it is
    :func:`~uslam_tpu_torch.factors.imu.preintegrate` only at ``bias`` = b0,
    the zero offset at which :func:`_lin` evaluates: it is no function of
    the bias for any other caller."""

    @staticmethod
    def forward(q, v, p, jac, bias):
        # Copies: forward mode writes into its outputs, which an expanded
        # view forbids.
        lead = bias.shape[:-1]
        return tuple(x.expand(lead + x.shape[-1:]).clone() for x in (q, v, p))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[3])

    @staticmethod
    def jvp(ctx, q_t, v_t, p_t, jac_t, bias_t):
        # jac (n, 10, 6), bias_t (..., n, 6): the tangent rows ride in the
        # product's columns, so the Jacobian is not copied once per row.
        (jac,) = ctx.saved_tensors
        n = bias_t.shape[-2]
        cols = bias_t.reshape(-1, n, BIAS_DIM).permute(1, 2, 0)  # (n, 6, B)
        d = (jac @ cols).permute(2, 0, 1).reshape(bias_t.shape[:-1] + (JAC_ROWS,))
        return d[..., 0:4], d[..., 4:7], d[..., 7:10]


def _delta_at_linearization_bias(delta, jac, bias) -> PreintegratedDelta:
    """``delta`` and ``jac`` (leading shape (n,)), preintegrated at b0, for
    the tangent rows ``bias`` = b0 + d (..., n, 6) under ``torch.func.jvp``
    at d = 0: bit for bit ``preintegrate`` at ``bias`` (its rows all
    equal the one at b0, and ``jac`` times a unit tangent is exact), for one
    preintegration per interval instead of one per tangent row."""
    q, v, p = _DeltaAtLinearizationBias.apply(
        delta.delta_q, delta.delta_v, delta.delta_p, jac, bias)
    return PreintegratedDelta(q, v, p, delta.dt_total)


class Linearization(NamedTuple):
    """Whitened residuals and Jacobian blocks per factor family; N poses,
    F stereo observations, IMU interval k couples frames (k, k+1)."""

    prior_pose_r: torch.Tensor   # (6,)
    prior_pose_J: torch.Tensor   # (6, 6)
    prior_vel_r: torch.Tensor    # (3,)
    prior_vel_J: torch.Tensor    # (3, 3)
    prior_bias_r: torch.Tensor   # (6,)
    prior_bias_J: torch.Tensor   # (6, 6)
    marg_r: torch.Tensor         # (15,)
    marg_J: torch.Tensor         # (15, 15) wrt [pose_0, vel_0, bias]
    imu_r: torch.Tensor          # (N-1, 9)
    imu_J_pose_i: torch.Tensor   # (N-1, 9, 6)
    imu_J_vel_i: torch.Tensor    # (N-1, 9, 3)
    imu_J_pose_j: torch.Tensor   # (N-1, 9, 6)
    imu_J_vel_j: torch.Tensor    # (N-1, 9, 3)
    imu_J_bias: torch.Tensor     # (N-1, 9, 6)
    dvl_r: torch.Tensor          # (N, 3)
    dvl_J_pose: torch.Tensor     # (N, 3, 6)
    dvl_J_vel: torch.Tensor      # (N, 3, 3)
    stereo_r: torch.Tensor       # (F, 3)
    stereo_J_pose: torch.Tensor  # (F, 3, 6)
    stereo_J_lm: torch.Tensor    # (F, 3, 3)

    def error(self) -> torch.Tensor:
        """0.5 * sum of squared whitened residuals (GTSAM error), summed in
        the JAX package's order."""
        return 0.5 * (
            torch.sum(self.prior_pose_r**2)
            + torch.sum(self.prior_vel_r**2)
            + torch.sum(self.prior_bias_r**2)
            + torch.sum(self.marg_r**2)
            + torch.sum(self.imu_r**2)
            + torch.sum(self.dvl_r**2)
            + torch.sum(self.stereo_r**2)
        )


def _lin(fn, batch: tuple, dim: int, like: torch.Tensor):
    """Residual ``fn`` of a tangent (..., *batch, dim) -> (r0 (*batch, r),
    J (*batch, r, dim)) at the zero tangent."""
    eye = torch.eye(dim, dtype=like.dtype, device=like.device)
    tangent = eye.reshape((dim,) + (1,) * len(batch) + (dim,)).expand(
        (dim,) + tuple(batch) + (dim,)
    )
    r, jt = torch.func.jvp(fn, (torch.zeros_like(tangent),), (tangent,))
    return r[0], jt.movedim(0, -1)


def _frame_pairs(values: Values, n_int: int):
    """Poses and velocities at both ends of each IMU interval. The packer
    pads a single-pose graph to one (masked) interval, hence the clamp."""
    n = values.num_poses
    ar = torch.arange(n_int, device=values.pose_quat.device)
    ki = torch.clamp(ar, max=n - 1)
    kj = torch.clamp(ar + 1, max=n - 1)
    return (
        Pose3(values.pose_quat[ki], values.pose_trans[ki]), values.vel[ki],
        Pose3(values.pose_quat[kj], values.pose_trans[kj]), values.vel[kj],
    )


def linearize_graph_eager(
    graph: GraphArrays,
    values: Values,
    cam: StereoCamera,
    dvl_sigma: float,
    stereo_sigma: float,
    gravity: float,
    huber_delta: float | None = None,
) -> Linearization:
    like = values.pose_trans
    p = graph.priors
    pose0 = values.pose(0)

    prior_pose_r, prior_pose_J = _lin(
        lambda xi: prior_pose_residual(
            pose_retract(pose0, xi), Pose3(p.pose_quat, p.pose_trans), p.pose_sigmas
        ),
        (), 6, like,
    )
    prior_vel_r, prior_vel_J = _lin(
        lambda dv: prior_vel_residual(values.vel[0] + dv, p.vel, p.vel_sigma),
        (), 3, like,
    )
    # weight = 1/sigma; 0 disables (the reference has no bias prior).
    prior_bias_r, prior_bias_J = _lin(
        lambda db: p.bias_weight * (values.bias + db - p.bias), (), 6, like
    )

    def f_marg(d):
        dev = torch.cat(
            [
                pose_local(
                    Pose3(p.marg_pose_quat, p.marg_pose_trans),
                    pose_retract(pose0, d[..., :6]),
                ),
                values.vel[0] + d[..., 6:9] - p.marg_vel,
                values.bias + d[..., 9:15] - p.marg_bias,
            ],
            dim=-1,
        )
        return p.marg_weight * (p.marg_sqrt_info @ dev[..., None])[..., 0]

    marg_r, marg_J = _lin(f_marg, (), 15, like)

    # ---- IMU: tangent [pose_i, vel_i, pose_j, vel_j, bias] (24) ----------
    # Every tangent row sits at the one bias: preintegrate once per
    # interval, then let the rows reach the deltas through their Jacobian.
    n_int = graph.imu.mask.shape[0]
    pose_i, vel_i, pose_j, vel_j = _frame_pairs(values, n_int)
    delta0, jac0 = preintegrate_with_jacobian(graph.imu.data, values.bias)

    def f_imu(d):
        return imu_residual_of_delta(
            pose_retract(pose_i, d[..., 0:6]),
            vel_i + d[..., 6:9],
            pose_retract(pose_j, d[..., 9:15]),
            vel_j + d[..., 15:18],
            _delta_at_linearization_bias(delta0, jac0, values.bias + d[..., 18:24]),
            gravity,
            graph.imu.whitener,
        )

    imu_r, imu_J = _lin(f_imu, (n_int,), 24, like)
    imu_mask = graph.imu.mask
    imu_r = imu_r * imu_mask[:, None]
    imu_J = imu_J * imu_mask[:, None, None]

    # ---- DVL -------------------------------------------------------------
    poses = Pose3(values.pose_quat, values.pose_trans)
    dvl_r, dvl_J = _lin(
        lambda d: dvl_residual(
            pose_retract(poses, d[..., :6]), values.vel + d[..., 6:9],
            graph.dvl.vel_body, dvl_sigma,
        ),
        (values.num_poses,), 9, like,
    )
    dvl_r = dvl_r * graph.dvl.mask[:, None]
    dvl_J = dvl_J * graph.dvl.mask[:, None, None]

    # ---- stereo ----------------------------------------------------------
    s = graph.stereo
    obs_poses = Pose3(values.pose_quat[s.cam_idx], values.pose_trans[s.cam_idx])
    obs_lms = values.landmarks[s.lm_idx]
    stereo_r, stereo_J = _lin(
        lambda d: stereo_residual(
            cam, pose_retract(obs_poses, d[..., :6]), obs_lms + d[..., 6:9],
            s.meas, stereo_sigma,
        ),
        (s.meas.shape[0],), 9, like,
    )
    if huber_delta is not None:
        # IRLS Huber: scale residual and Jacobian by sqrt(w),
        # w = min(1, delta/||r||), re-evaluated each linearization.
        nrm = torch.linalg.vector_norm(stereo_r, dim=-1)
        w = torch.sqrt(torch.clamp(huber_delta / torch.clamp(nrm, min=1e-9), max=1.0))
        stereo_r = stereo_r * w[:, None]
        stereo_J = stereo_J * w[:, None, None]
    stereo_r = stereo_r * s.mask[:, None]
    stereo_J = stereo_J * s.mask[:, None, None]

    return Linearization(
        prior_pose_r=prior_pose_r,
        prior_pose_J=prior_pose_J,
        prior_vel_r=prior_vel_r,
        prior_vel_J=prior_vel_J,
        prior_bias_r=prior_bias_r,
        prior_bias_J=prior_bias_J,
        marg_r=marg_r,
        marg_J=marg_J,
        imu_r=imu_r,
        imu_J_pose_i=imu_J[..., 0:6],
        imu_J_vel_i=imu_J[..., 6:9],
        imu_J_pose_j=imu_J[..., 9:15],
        imu_J_vel_j=imu_J[..., 15:18],
        imu_J_bias=imu_J[..., 18:24],
        dvl_r=dvl_r,
        dvl_J_pose=dvl_J[..., :6],
        dvl_J_vel=dvl_J[..., 6:],
        stereo_r=stereo_r,
        stereo_J_pose=stereo_J[..., :6],
        stereo_J_lm=stereo_J[..., 6:],
    )


def graph_error_eager(
    graph: GraphArrays,
    values: Values,
    cam: StereoCamera,
    dvl_sigma: float,
    stereo_sigma: float,
    gravity: float,
    huber_delta: float | None = None,
) -> torch.Tensor:
    """Total error 0.5 ||r||^2 without Jacobians (LM step acceptance); with a
    Huber delta the stereo terms use the Huber cost rho(||r||)."""
    p = graph.priors
    e = 0.5 * torch.sum(
        prior_pose_residual(
            values.pose(0), Pose3(p.pose_quat, p.pose_trans), p.pose_sigmas
        ) ** 2
    )
    e = e + 0.5 * torch.sum(prior_vel_residual(values.vel[0], p.vel, p.vel_sigma) ** 2)
    e = e + 0.5 * torch.sum((p.bias_weight * (values.bias - p.bias)) ** 2)

    n_int = graph.imu.mask.shape[0]
    pose_i, vel_i, pose_j, vel_j = _frame_pairs(values, n_int)
    imu_r = imu_residual_of_delta(
        pose_i, vel_i, pose_j, vel_j, preintegrate_value(graph.imu.data, values.bias), gravity,
        graph.imu.whitener,
    )
    e = e + 0.5 * torch.sum((imu_r * graph.imu.mask[:, None]) ** 2)

    dvl_r = dvl_residual(
        Pose3(values.pose_quat, values.pose_trans), values.vel,
        graph.dvl.vel_body, dvl_sigma,
    )
    e = e + 0.5 * torch.sum((dvl_r * graph.dvl.mask[:, None]) ** 2)

    s = graph.stereo
    obs_poses = Pose3(values.pose_quat[s.cam_idx], values.pose_trans[s.cam_idx])
    st_r = stereo_residual(cam, obs_poses, values.landmarks[s.lm_idx], s.meas, stereo_sigma)
    if huber_delta is None:
        return e + 0.5 * torch.sum((st_r * s.mask[:, None]) ** 2)
    nrm = torch.linalg.vector_norm(st_r, dim=-1)
    rho = torch.where(
        nrm <= huber_delta, 0.5 * nrm**2, huber_delta * (nrm - 0.5 * huber_delta)
    )
    return e + torch.sum(rho * s.mask)


def _dispatch(name: str, body, graph, values, cam, dvl_sigma, stereo_sigma, gravity, huber_delta):
    if values.pose_trans.device.type == "cuda":
        return compiled.call(
            name, body, (graph, values, cam), (dvl_sigma, stereo_sigma, gravity, huber_delta)
        )
    return body(graph, values, cam, dvl_sigma, stereo_sigma, gravity, huber_delta)


def linearize_graph(
    graph: GraphArrays,
    values: Values,
    cam: StereoCamera,
    dvl_sigma: float,
    stereo_sigma: float,
    gravity: float,
    huber_delta: float | None = None,
) -> Linearization:
    """Whitened residuals and Jacobian blocks of every factor family at
    ``values`` (:func:`linearize_graph_eager`; a replayed CUDA graph on the
    card)."""
    return _dispatch("linearize_graph", linearize_graph_eager, graph, values, cam,
                     dvl_sigma, stereo_sigma, gravity, huber_delta)


def graph_error(
    graph: GraphArrays,
    values: Values,
    cam: StereoCamera,
    dvl_sigma: float,
    stereo_sigma: float,
    gravity: float,
    huber_delta: float | None = None,
) -> torch.Tensor:
    """Total error 0.5 ||r||^2, Huber on the stereo terms with a delta
    (:func:`graph_error_eager`; a replayed CUDA graph on the card)."""
    return _dispatch("graph_error", graph_error_eager, graph, values, cam,
                     dvl_sigma, stereo_sigma, gravity, huber_delta)
