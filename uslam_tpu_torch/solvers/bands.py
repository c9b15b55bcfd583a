"""Banded camera-system assembly (port of :mod:`uslam_tpu.solvers.bands`).

The camera system is laid out pose-major,

    [poses (6N) | velocities (3N) | bias (6)],

so the landmark Schur correction lands on one contiguous (6N, 6N) block.
IMU, DVL and prior terms couple frame k only to frame k+1: they are
assembled as per-frame diagonal blocks plus (k, k+1) coupling blocks, with
shifted adds over per-interval einsums. The per-frame stereo sums
(:func:`frame_sum`; one-hot matmuls over ``cam_idx`` in the JAX package)
add each frame's observations in a fixed order, where an ``index_add_``
would add with float atomics on the GPU and change the result from run to
run. Padded observations have zero Jacobians and are left out. The dense
matrix the reduced Cholesky needs is made by block writes into a zero
matrix, which is pure data movement and so exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uslam_tpu_torch.graph.builder import StereoObservations
from uslam_tpu_torch.graph.values import BIAS_DIM, POSE_DIM, VEL_DIM
from uslam_tpu_torch.solvers.linearize import Linearization


class CamBands(NamedTuple):
    """Block-banded camera-only normal equations (pose-major layout).

    ``*_d`` are per-frame diagonal blocks; ``*_o``/``*_sup``/``*_sub`` the
    (k, k+1) / (k+1, k) couplings of IMU intervals; ``pb``/``vb`` the dense
    column of the single run-wide bias."""

    pp_d: torch.Tensor    # (N, 6, 6) pose-pose diagonal
    pp_o: torch.Tensor    # (N-1, 6, 6) pose_k - pose_{k+1}
    pv_d: torch.Tensor    # (N, 6, 3) pose_k - vel_k
    pv_sup: torch.Tensor  # (N-1, 6, 3) pose_k - vel_{k+1}
    pv_sub: torch.Tensor  # (N-1, 6, 3) pose_{k+1} - vel_k
    vv_d: torch.Tensor    # (N, 3, 3)
    vv_o: torch.Tensor    # (N-1, 3, 3) vel_k - vel_{k+1}
    pb: torch.Tensor      # (N, 6, 6) pose_k - bias
    vb: torch.Tensor      # (N, 3, 6) vel_k - bias
    bb: torch.Tensor      # (6, 6)
    gp: torch.Tensor      # (N, 6) gradient, pose part
    gv: torch.Tensor      # (N, 3)
    gb: torch.Tensor      # (6,)


def damping_scalars(damping, dtype: torch.dtype):
    """(lambda, lambda + 1e-8), each rounded in the solve's float type as
    the JAX package's device-side scalars are: Python floats (exact) for a
    number, 0-d tensors of ``dtype`` for a tensor (the LM's lambda on the
    device), the same bits either way."""
    if isinstance(damping, torch.Tensor):
        lam = damping.to(dtype)
        return lam, lam + 1e-8
    f = np.float64 if dtype == torch.float64 else np.float32
    lam = f(damping)
    return float(lam), float(lam + f(1e-8))


def _at_i_plus_j(at_i: torch.Tensor, at_j: torch.Tensor, n: int) -> torch.Tensor:
    """Interval quantity -> per-frame sum: at_i[k] lands on frame k, at_j[k]
    on frame k+1."""
    z = at_i.new_zeros((1,) + tuple(at_i.shape[1:]))
    return (torch.cat([at_i, z]) + torch.cat([z, at_j]))[:n]


def _add_head(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x with v added to its frame-0 entry, out of place."""
    return torch.cat([x[:1] + v, x[1:]])


def _damp_diag(blk: torch.Tensor, lam, lam_floor, diag_damping: bool):
    """LM damping on every diagonal entry of (..., d, d) blocks: Marquardt
    H + lam diag(H) + 1e-8 (the floor keeps padded zero rows nonsingular),
    or H + (lam + 1e-8) I."""
    eye = torch.eye(blk.shape[-1], dtype=blk.dtype, device=blk.device)
    if diag_damping:
        return blk + (lam * blk) * eye + 1e-8 * eye
    return blk + lam_floor * eye


def frame_sum(values: torch.Tensor, frames: torch.Tensor, n: int) -> torch.Tensor:
    """sum_b values[b] onto rows frames[b]: values (B, X), frames (B,) ->
    (n, X); rows with a frame outside [0, n) are dropped, and callers send
    their masked (zero) rows there. A stable sort on the frame, then one
    sum over each frame's contiguous run (``segment_reduce``, no atomics):
    linear in B, no host read, and the order of additions is fixed, so two
    calls end bit-identical. A run is summed serially, so it must not hold
    the padding: on an H100, one frame with all of a packed graph's padded
    rows made this 22 ms at the 4000-pose survey, against 0.3 ms without
    them and 10 ms for the one-hot GEMM."""
    fs, perm = torch.sort(frames, stable=True)
    offsets = torch.searchsorted(fs, torch.arange(n + 1, device=fs.device, dtype=fs.dtype))
    return torch.segment_reduce(values[perm], "sum", offsets=offsets, axis=0, unsafe=True)


def observed_frames(cam_idx: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """cam_idx as int64 with masked observations sent to frame n, which
    :func:`frame_sum` drops."""
    return torch.where(mask > 0, cam_idx.long(), n)


def assemble_cam_bands(
    lin: Linearization, stereo: StereoObservations, n: int, damping,
    diag_damping: bool = False,
) -> CamBands:
    """Banded camera system from a linearization, with the stereo
    pose-diagonal terms and the LM damping on every diagonal;
    ``diag_damping`` damps with lambda*diag(H) (Marquardt) instead of
    lambda*I."""
    lam, lam_floor = damping_scalars(damping, lin.stereo_r.dtype)
    Ji = {
        "p": lin.imu_J_pose_i, "v": lin.imu_J_vel_i,
        "P": lin.imu_J_pose_j, "V": lin.imu_J_vel_j, "b": lin.imu_J_bias,
    }
    r_imu = lin.imu_r

    def blk(a, b):
        return torch.einsum("fda,fdb->fab", Ji[a], Ji[b])

    def grad(a):
        return -torch.einsum("fda,fd->fa", Ji[a], r_imu)

    # IMU band blocks (interval k couples frames k and k+1).
    pp_d = _at_i_plus_j(blk("p", "p"), blk("P", "P"), n)
    pv_d = _at_i_plus_j(blk("p", "v"), blk("P", "V"), n)
    vv_d = _at_i_plus_j(blk("v", "v"), blk("V", "V"), n)
    pp_o = blk("p", "P")[: n - 1]
    pv_sup = blk("p", "V")[: n - 1]
    pv_sub = blk("P", "v")[: n - 1]
    vv_o = blk("v", "V")[: n - 1]
    pb = _at_i_plus_j(blk("p", "b"), blk("P", "b"), n)
    vb = _at_i_plus_j(blk("v", "b"), blk("V", "b"), n)
    bb = torch.einsum("fda,fdb->ab", lin.imu_J_bias, lin.imu_J_bias)
    gp = _at_i_plus_j(grad("p"), grad("P"), n)
    gv = _at_i_plus_j(grad("v"), grad("V"), n)
    gb = -torch.einsum("fda,fd->a", lin.imu_J_bias, r_imu)

    # DVL (per frame, diagonal band only).
    Jp, Jv, r_dvl = lin.dvl_J_pose, lin.dvl_J_vel, lin.dvl_r
    pp_d = pp_d + torch.einsum("fda,fdb->fab", Jp, Jp)
    pv_d = pv_d + torch.einsum("fda,fdb->fab", Jp, Jv)
    vv_d = vv_d + torch.einsum("fda,fdb->fab", Jv, Jv)
    gp = gp - torch.einsum("fda,fd->fa", Jp, r_dvl)
    gv = gv - torch.einsum("fda,fd->fa", Jv, r_dvl)

    # Stereo pose-diagonal blocks and gradient, summed per frame.
    Js, rs = lin.stereo_J_pose, lin.stereo_r
    rhs = torch.cat(
        [
            torch.einsum("fda,fdb->fab", Js, Js).reshape(-1, 36),
            -torch.einsum("fda,fd->fa", Js, rs),
        ],
        dim=1,
    )                                                    # (F, 42)
    per_frame = frame_sum(rhs, observed_frames(stereo.cam_idx, stereo.mask, n), n)
    pp_d = pp_d + per_frame[:, :36].reshape(n, 6, 6)
    gp = gp + per_frame[:, 36:]

    # Priors and the dense marginal prior (frame 0 / bias).
    pp0 = lin.prior_pose_J.T @ lin.prior_pose_J
    vv0 = lin.prior_vel_J.T @ lin.prior_vel_J
    bb = bb + lin.prior_bias_J.T @ lin.prior_bias_J
    gp0 = -lin.prior_pose_J.T @ lin.prior_pose_r
    gv0 = -lin.prior_vel_J.T @ lin.prior_vel_r
    gb = gb - lin.prior_bias_J.T @ lin.prior_bias_r

    Jm, rm = lin.marg_J, lin.marg_r                      # (15, 15) over [p0, v0, b]
    Jp0, Jv0, Jb0 = Jm[:, :6], Jm[:, 6:9], Jm[:, 9:15]
    pp0 = pp0 + Jp0.T @ Jp0
    vv0 = vv0 + Jv0.T @ Jv0
    bb = bb + Jb0.T @ Jb0
    gp0 = gp0 - Jp0.T @ rm
    gv0 = gv0 - Jv0.T @ rm
    gb = gb - Jb0.T @ rm

    pp_d = _add_head(pp_d, pp0)
    vv_d = _add_head(vv_d, vv0)
    pv_d = _add_head(pv_d, Jp0.T @ Jv0)
    pb = _add_head(pb, Jp0.T @ Jb0)
    vb = _add_head(vb, Jv0.T @ Jb0)
    gp = _add_head(gp, gp0)
    gv = _add_head(gv, gv0)

    pp_d = _damp_diag(pp_d, lam, lam_floor, diag_damping)
    vv_d = _damp_diag(vv_d, lam, lam_floor, diag_damping)
    bb = _damp_diag(bb, lam, lam_floor, diag_damping)
    return CamBands(pp_d, pp_o, pv_d, pv_sup, pv_sub, vv_d, vv_o, pb, vb, bb, gp, gv, gb)


def band_dense(diag: torch.Tensor, sup: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
    """(N,da,db) diagonal + (N-1,da,db) super/sub block bands -> the dense
    (N*da, N*db) block-tridiagonal matrix, by block writes into zeros."""
    n, da, db = diag.shape
    out = diag.new_zeros((n, da, n, db))
    k = torch.arange(n, device=diag.device)
    out[k, :, k, :] = diag
    out[k[:-1], :, k[1:], :] = sup
    out[k[1:], :, k[:-1], :] = sub
    return out.reshape(n * da, n * db)


def expand_cam_dense(b: CamBands, pp_extra: torch.Tensor | None = None):
    """Banded camera system -> dense (Dc, Dc), (Dc,) for the reduced solve.
    ``pp_extra``: optional dense (6N, 6N) addend of the pose-pose block (the
    Schur landmark correction -U V^T)."""
    n = b.pp_d.shape[0]
    Hpp = band_dense(b.pp_d, b.pp_o, b.pp_o.transpose(1, 2))
    if pp_extra is not None:
        Hpp = Hpp + pp_extra
    Hpv = band_dense(b.pv_d, b.pv_sup, b.pv_sub)
    Hvv = band_dense(b.vv_d, b.vv_o, b.vv_o.transpose(1, 2))
    Hpb = b.pb.reshape(n * POSE_DIM, BIAS_DIM)
    Hvb = b.vb.reshape(n * VEL_DIM, BIAS_DIM)
    H = torch.cat(
        [
            torch.cat([Hpp, Hpv, Hpb], dim=1),
            torch.cat([Hpv.T, Hvv, Hvb], dim=1),
            torch.cat([Hpb.T, Hvb.T, b.bb], dim=1),
        ],
        dim=0,
    )
    g = torch.cat([b.gp.reshape(-1), b.gv.reshape(-1), b.gb])
    return H, g
