"""Plain PyTorch reference of the batch solve: the whole graph's cost in
float64 and an exact Levenberg-Marquardt oracle on it.

The cost is GTSAM's 0.5 * sum of squared whitened residuals over the
factors the reference deployment builds (batch.py:270-305): the priors on
the first pose, velocity and IMU bias, one preintegrated IMU factor per
keyframe interval (the samples re-integrated at the current bias,
forward Euler), one DVL body-velocity factor and the stereo projections
(GenericStereoFactor3D) of every keyframe after the first.

The oracle (the pattern of tests/test_oracle_parity.py:29-68) linearizes
the whole tangent space, assembles the dense normal equations and solves
them exactly with a Cholesky factorization: no velocity elimination, no
iterative refinement. The tangent holds the landmarks first, so the
factorization eliminates them first, as a Schur complement does: in
float64 that changes nothing, and in the control's lower precision the
factorization meets the cancellation that a lower-precision Schur step
meets (a landmark seen from one keyframe cancels that keyframe's stereo
block up to the damping). Its lambda policy follows
GTSAM's; it stops when an accepted step lowers the cost by at most 1e-6 of
it. It imports nothing of the program and reads only the graph that
:mod:`bench_port.reference.packing` built.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from reference.geometry import local, qconj, qmul, qnormalize, qrotate, retract, so3_exp, so3_log

ORACLE_MAX_ITERS = 40


@dataclass
class Problem:
    """The graph's leaves as tensors and the camera and noise numbers."""

    g: dict
    n: int                 # poses
    m: int                 # real landmark rows
    cam: dict
    dvl_sigma: float
    stereo_sigma: float
    gravity: float

    @property
    def dim(self) -> int:
        return 3 * self.m + 9 * self.n + 6

    @property
    def pose_off(self) -> int:
        """Tangent layout: landmarks (3) * m, [pose (6), vel (3)] * n, bias (6)."""
        return 3 * self.m

    @property
    def bias_off(self) -> int:
        return 3 * self.m + 9 * self.n


def problem(leaves: dict, n_landmarks: int, cfg: dict, device, dtype=torch.float64,
            store=np.float32) -> Problem:
    """The graph as the program is given it: every float leaf rounded to
    ``store`` (the port packs float32 leaves), then held in ``dtype``."""
    g = {}
    for k, a in leaves.items():
        a = np.asarray(a)
        if a.dtype.kind == "f":
            g[k] = torch.as_tensor(a.astype(store).astype(np.float64), dtype=dtype, device=device)
        else:
            g[k] = torch.as_tensor(a, dtype=torch.int64, device=device)
    if cfg["noise"]["stereo_huber_delta"] is not None:
        raise NotImplementedError("the reference cost is Gaussian (stereo_huber_delta None)")
    return Problem(g=g, n=int(leaves["dvl.mask"].shape[0]), m=int(n_landmarks),
                   cam={k: float(cfg["camera"][k]) for k in ("fx", "fy", "cx", "cy", "baseline")},
                   dvl_sigma=float(cfg["noise"]["dvl_sigma"]),
                   stereo_sigma=float(cfg["noise"]["stereo_sigma"]),
                   gravity=float(cfg["imu"]["gravity"]))


def values_to(values: dict, device, dtype=torch.float64) -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=device).to(dtype) if not torch.is_tensor(v)
            else v.detach().to(device=device, dtype=dtype) for k, v in values.items()}


# ---- residuals ---------------------------------------------------------------

def _cat(*parts):
    """Concatenate along the last axis, broadcasting the leading ones."""
    lead = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], -1)


def preintegrate(acc, gyro, dts, bias):
    """Deltas (q, v, p, T) of each interval at ``bias`` [ba, bg]; leading
    dimensions of ``bias`` broadcast against the intervals."""
    ba, bg = bias[..., :3], bias[..., 3:]
    lead = torch.broadcast_shapes(acc.shape[:-2], ba.shape[:-1])
    q = torch.cat([acc.new_ones(lead + (1,)), acc.new_zeros(lead + (3,))], -1)
    v = acc.new_zeros(lead + (3,))
    p = acc.new_zeros(lead + (3,))
    for k in range(acc.shape[-2]):
        dt = dts[..., k, None]
        a_w = qrotate(q, acc[..., k, :] - ba)
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        q = qnormalize(qmul(q, so3_exp((gyro[..., k, :] - bg) * dt)))
    return q, v, p, dts.sum(-1)


def imu_residual(P: Problem, qi, ti, vi, qj, tj, vj, bias):
    g = P.g
    dq, dv, dp, T = preintegrate(g["imu.data.acc"], g["imu.data.gyro"], g["imu.data.dt"], bias)
    T = T[..., None]
    grav = torch.zeros(3, dtype=ti.dtype, device=ti.device)
    grav[2] = -P.gravity
    qi_inv = qconj(qi)
    r_R = so3_log(qmul(qconj(dq), qmul(qi_inv, qj)))
    r_v = qrotate(qi_inv, vj - vi - grav * T) - dv
    r_p = qrotate(qi_inv, tj - ti - vi * T - 0.5 * grav * T * T) - dp
    r = _cat(r_R, r_v, r_p)
    return (g["imu.whitener"] @ r[..., None])[..., 0] * g["imu.mask"][:, None]


def stereo_residual(P: Problem, q, t, lm):
    g, c = P.g, P.cam
    x, y, z = qrotate(qconj(q), lm - t).unbind(-1)
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    pred = torch.stack([c["fx"] * x / z + c["cx"], c["fx"] * (x - c["baseline"]) / z + c["cx"],
                        c["fy"] * y / z + c["cy"]], -1)
    return (pred - g["stereo.meas"]) / P.stereo_sigma * g["stereo.mask"][:, None]


def dvl_residual(P: Problem, q, vel):
    g = P.g
    return (qrotate(q, g["dvl.vel_body"]) - vel) / P.dvl_sigma * g["dvl.mask"][:, None]


def prior_residuals(P: Problem, q0, t0, v0, bias):
    g = P.g
    r_pose = local(g["priors.pose_quat"], g["priors.pose_trans"], q0, t0) / g["priors.pose_sigmas"]
    r_vel = (v0 - g["priors.vel"]) / g["priors.vel_sigma"]
    r_bias = g["priors.bias_weight"] * (bias - g["priors.bias"])
    dev = _cat(local(g["priors.marg_pose_quat"], g["priors.marg_pose_trans"], q0, t0),
               v0 - g["priors.marg_vel"], bias - g["priors.marg_bias"])
    r_marg = g["priors.marg_weight"] * (g["priors.marg_sqrt_info"] @ dev[..., None])[..., 0]
    return r_pose, r_vel, r_bias, r_marg


def _pairs(v):
    return (v["pose_quat"][:-1], v["pose_trans"][:-1], v["vel"][:-1],
            v["pose_quat"][1:], v["pose_trans"][1:], v["vel"][1:])


def cost(P: Problem, v: dict) -> torch.Tensor:
    """0.5 * sum of squared whitened residuals at values ``v``, evaluated
    in the graph's type."""
    g = P.g
    v = {k: x.to(work_dtype(P)) for k, x in v.items()}
    terms = list(prior_residuals(P, v["pose_quat"][0], v["pose_trans"][0], v["vel"][0], v["bias"]))
    terms.append(imu_residual(P, *_pairs(v), v["bias"]))
    terms.append(dvl_residual(P, v["pose_quat"], v["vel"]))
    ci, li = g["stereo.cam_idx"], g["stereo.lm_idx"]
    terms.append(stereo_residual(P, v["pose_quat"][ci], v["pose_trans"][ci], v["landmarks"][li]))
    return 0.5 * sum(torch.sum(r * r) for r in terms)


# ---- the oracle --------------------------------------------------------------

def _jvp_rows(fn, batch: tuple, dim: int, like):
    """Residual ``fn`` of a tangent (dim, *batch, dim) -> (r (*batch, k),
    J (*batch, k, dim)) at the zero tangent, one forward-mode pass."""
    eye = torch.eye(dim, dtype=like.dtype, device=like.device)
    tangent = eye.reshape((dim,) + (1,) * len(batch) + (dim,)).expand((dim,) + batch + (dim,))
    r, jt = torch.func.jvp(fn, (torch.zeros_like(tangent),), (tangent,))
    return r[0], jt.movedim(0, -1)


def _pose_cols(P: Problem, i, n_cols: int = 9):
    return P.pose_off + 9 * i[:, None] + torch.arange(n_cols, device=i.device)


def work_dtype(P: Problem):
    """The type the residuals are evaluated in: the graph's."""
    return P.g["imu.data.acc"].dtype


def normal_equations(P: Problem, v: dict, solve_dtype=None):
    """Dense H = J^T J and b = -J^T r over the tangent
    landmark rows (3) * m, [pose_i (6), vel_i (3)] * n, bias (6). The
    residuals and Jacobians are evaluated in the graph's type, H and b are
    assembled in ``solve_dtype`` (default: the same)."""
    n, D, g = P.n, P.dim, P.g
    v = {k: x.to(work_dtype(P)) for k, x in v.items()}
    like = v["pose_trans"]
    dev = like.device
    sd = solve_dtype or like.dtype
    H = torch.zeros(D * D, dtype=sd, device=dev)
    b = torch.zeros(D, dtype=sd, device=dev)
    bias_cols = P.bias_off + torch.arange(6, device=dev)

    def add(r, J, cols):
        # r (B, k), J (B, k, c), cols (B, c) global tangent indices
        r, J = r.to(sd), J.to(sd)
        JtJ = J.mT @ J
        H.index_put_(((cols[:, :, None] * D + cols[:, None, :]).reshape(-1),),
                     JtJ.reshape(-1), accumulate=True)
        b.index_add_(0, cols.reshape(-1), -(J.mT @ r[..., None])[..., 0].reshape(-1))

    q0, t0, v0, bias = v["pose_quat"][0], v["pose_trans"][0], v["vel"][0], v["bias"]

    def f_prior(d):
        q, t = retract(q0, t0, d[..., :6])
        return _cat(*prior_residuals(P, q, t, v0 + d[..., 6:9], bias + d[..., 9:15]))

    r, J = _jvp_rows(f_prior, (), 15, like)
    add(r[None], J[None], torch.cat([P.pose_off + torch.arange(9, device=dev), bias_cols])[None])

    qi, ti, vi, qj, tj, vj = _pairs(v)

    def f_imu(d):
        a = retract(qi, ti, d[..., 0:6])
        c = retract(qj, tj, d[..., 9:15])
        return imu_residual(P, a[0], a[1], vi + d[..., 6:9], c[0], c[1], vj + d[..., 15:18],
                            bias + d[..., 18:24])

    r, J = _jvp_rows(f_imu, (n - 1,), 24, like)
    k = torch.arange(n - 1, device=dev)
    add(r, J, torch.cat([_pose_cols(P, k), _pose_cols(P, k + 1), bias_cols.expand(n - 1, 6)], 1))

    def f_dvl(d):
        q, _ = retract(v["pose_quat"], v["pose_trans"], d[..., :6])
        return dvl_residual(P, q, v["vel"] + d[..., 6:9])

    r, J = _jvp_rows(f_dvl, (n,), 9, like)
    add(r, J, _pose_cols(P, torch.arange(n, device=dev)))

    ci, li = g["stereo.cam_idx"], g["stereo.lm_idx"]
    q_o, t_o, l_o = v["pose_quat"][ci], v["pose_trans"][ci], v["landmarks"][li]

    def f_stereo(d):
        q, t = retract(q_o, t_o, d[..., :6])
        return stereo_residual(P, q, t, l_o + d[..., 6:9])

    r, J = _jvp_rows(f_stereo, (ci.shape[0],), 9, like)
    lm_cols = 3 * torch.clamp(li, max=max(P.m - 1, 0))[:, None] + torch.arange(3, device=dev)
    add(r, J, torch.cat([_pose_cols(P, ci, 6), lm_cols], 1))
    return H.reshape(D, D), b


def retract_values(P: Problem, v: dict, delta) -> dict:
    n = P.n
    delta = delta.to(v["pose_trans"].dtype)
    pv = delta[P.pose_off: P.bias_off].reshape(n, 9)
    q, t = retract(v["pose_quat"], v["pose_trans"], pv[:, :6])
    lm = v["landmarks"].clone()
    lm[: P.m] = lm[: P.m] + delta[: P.pose_off].reshape(P.m, 3)
    return {"pose_quat": q, "pose_trans": t, "vel": v["vel"] + pv[:, 6:9],
            "bias": v["bias"] + delta[P.bias_off: P.bias_off + 6], "landmarks": lm}


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 matrix products on the card while inside (the control's
    precision); nothing on the CPU."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def optimize(P: Problem, initial: dict, max_iters: int = ORACLE_MAX_ITERS):
    """Exact dense LM from ``initial``: (values, cost, iterations). The
    values, the normal equations and their solve are held in the type of
    ``initial``; the residuals are evaluated in the graph's."""
    v = initial
    sd = v["pose_trans"].dtype
    err = float(cost(P, v))
    lam, nu = 1e-5, 10.0
    it = 0
    H = None
    for it in range(1, max_iters + 1):
        if H is None:    # the normal equations at a new point
            H, b = normal_equations(P, v, sd)
            diag = H.diagonal().clone()
        H.diagonal().copy_(diag + (lam + 1e-12))
        L, info = torch.linalg.cholesky_ex(H)
        new_err = float("nan")
        if int(info) == 0:
            delta = torch.cholesky_solve(b[:, None], L)[:, 0]
            cand = retract_values(P, v, delta)
            new_err = float(cost(P, cand))
        del L
        if np.isfinite(new_err) and new_err < err:
            decrease = err - new_err
            v, err = cand, new_err
            H = None
            if decrease <= 1e-8 or decrease <= 1e-6 * err:
                break
            lam, nu = max(lam / 10.0, 0.0), 10.0
        else:
            lam = max(lam, 1e-10) * nu
            nu *= 10.0
            if lam > 1e8:
                break
    return v, err, it
