"""Plain numpy reference of the batch graph: the factor graph that the
reference deployment (hvak/visual-underwater-slam, batch.py:253-305) builds
from one dive, packed into the port's static-shape layout.

It imports nothing of the program. From the benchmark's own copy of the
dive's streams and feature tracks it works out again what the program's
ingest derives: the approximate time join (ROS ApproximateTimeSynchronizer,
slop 0.2 s), the keyframe depth from pressure, the IMU intervals and their
whiteners (Forster et al. TRO'17 eq. 62-63, GTSAM's continuous-time noise),
the DVL factors, the landmark interning in first-appearance order with the
stratified per-landmark observation budget, the power-of-two padding, and
the initial values (DVL poses with the pressure depth, zero velocities,
first-observation triangulation).

:func:`pack` returns (leaves, initial) as dicts of float64 / int numpy
arrays keyed by the port's field paths ("priors.pose_quat", ...).
"""

from __future__ import annotations

import numpy as np


def time_join(pivot_t, other_ts, slop):
    """Greedy in-order join: each accepted (pivot, picks) has every stamp
    within ``slop``; each message joins at most one tuple."""
    cursors = [0] * len(other_ts)
    out = []
    for pi, t in enumerate(np.asarray(pivot_t, np.float64)):
        picks = []
        for ts, c in zip(other_ts, cursors):
            if c >= len(ts):
                picks.append(None)
                continue
            i = max(int(np.searchsorted(ts, t, side="left")), c)
            best, best_d = None, np.inf
            for j in (i - 1, i):
                if c <= j < len(ts) and abs(float(ts[j]) - t) < best_d:
                    best, best_d = j, abs(float(ts[j]) - t)
            picks.append(best)
        if any(j is None for j in picks):
            break
        stamps = [float(t)] + [float(ts[j]) for ts, j in zip(other_ts, picks)]
        if max(stamps) - min(stamps) <= slop:
            out.append((pi, picks))
            cursors = [j + 1 for j in picks]
    return out


def bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def rank_within_group(keys):
    o = np.argsort(keys, kind="stable")
    sk = keys[o]
    is_new = np.r_[True, sk[1:] != sk[:-1]]
    grp_first = np.maximum.accumulate(np.where(is_new, np.arange(len(sk)), 0))
    ranks = np.empty(len(keys), int)
    ranks[o] = np.arange(len(sk)) - grp_first
    return ranks


def stratified_keep(keys, cap: int):
    """min(count, cap) observations of each key, evenly spaced in time."""
    if not len(keys):
        return np.ones(0, bool)
    rank = rank_within_group(keys)
    counts = np.bincount(keys)[keys]
    return ((rank + 1) * cap) // counts > (rank * cap) // counts


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def triangulate(cam, quats, trans, uL, uR, v):
    """Stereo back-projection with the mean focal length (batch.py:152-163)
    moved into the world by world_T_cam."""
    W = np.maximum(np.abs(uR - uL), 1e-6) / cam["baseline"]
    p_cam = np.stack(
        [(uL - cam["cx"]) / W, (v - cam["cy"]) / W, (0.5 * (cam["fx"] + cam["fy"])) / W], -1)
    return np.einsum("...ij,...j->...i", quat_to_matrix(quats), p_cam) + trans


def _hat(w):
    H = np.zeros(w.shape[:-1] + (3, 3))
    H[..., 0, 1], H[..., 0, 2] = -w[..., 2], w[..., 1]
    H[..., 1, 0], H[..., 1, 2] = w[..., 2], -w[..., 0]
    H[..., 2, 0], H[..., 2, 1] = -w[..., 1], w[..., 0]
    return H


def _exp_and_left_jacobian(w):
    th2 = np.sum(w * w, axis=-1)
    th = np.sqrt(th2)
    small = th < 1e-8
    with np.errstate(invalid="ignore", divide="ignore"):
        s = np.where(small, 1.0 - th2 / 6.0, np.sin(th) / np.where(small, 1.0, th))
        c = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(th)) / np.where(small, 1.0, th2))
        j2 = np.where(small, 1.0 / 6.0 - th2 / 120.0,
                      (th - np.sin(th)) / np.where(small, 1.0, th2 * th))
    H = _hat(w)
    H2 = H @ H
    eye = np.broadcast_to(np.eye(3), H.shape)
    return (eye + s[..., None, None] * H + c[..., None, None] * H2,
            eye + c[..., None, None] * H + j2[..., None, None] * H2)


def imu_whiteners(acc, gyro, dts, imu):
    """inv(chol(P)) of each interval's preintegration covariance at zero
    bias: P <- A P A^T + Q per sample (per-sample noise sigma^2 / dt)."""
    F, S, _ = acc.shape
    R = np.tile(np.eye(3), (F, 1, 1))
    P = np.zeros((F, 9, 9))
    eye3 = np.broadcast_to(np.eye(3), (F, 3, 3))
    for k in range(S):
        a, w, h = acc[:, k], gyro[:, k], dts[:, k]
        active = h > 0.0
        if not active.any():
            continue
        hs = h[:, None, None]
        dR_T, Jr = _exp_and_left_jacobian(-w * h[:, None])
        Ah = _hat(a) * hs
        A = np.zeros((F, 9, 9))
        A[:, 0:3, 0:3] = dR_T
        A[:, 3:6, 0:3] = -R @ Ah
        A[:, 3:6, 3:6] = np.eye(3)
        A[:, 6:9, 0:3] = -0.5 * (R @ Ah) * hs
        A[:, 6:9, 3:6] = eye3 * hs
        A[:, 6:9, 6:9] = np.eye(3)
        G_g, G_av, G_ap = Jr * hs, R * hs, 0.5 * R * hs * hs
        with np.errstate(divide="ignore"):
            inv_h = np.where(active, 1.0 / np.maximum(h, 1e-9), 0.0)[:, None, None]
        Q = np.zeros((F, 9, 9))
        Q[:, 0:3, 0:3] = imu["gyro_cov"] * inv_h * (G_g @ G_g.transpose(0, 2, 1))
        Q[:, 3:6, 3:6] = imu["accel_cov"] * inv_h * (G_av @ G_av.transpose(0, 2, 1))
        Q[:, 3:6, 6:9] = imu["accel_cov"] * inv_h * (G_av @ G_ap.transpose(0, 2, 1))
        Q[:, 6:9, 3:6] = Q[:, 3:6, 6:9].transpose(0, 2, 1)
        Q[:, 6:9, 6:9] = (imu["accel_cov"] * inv_h * (G_ap @ G_ap.transpose(0, 2, 1))
                          + imu["integration_cov"] * hs * np.eye(3))
        m = active[:, None, None]
        P = np.where(m, A @ P @ A.transpose(0, 2, 1) + Q, P)
        R = np.where(m, R @ dR_T.transpose(0, 2, 1), R)
    L = np.linalg.cholesky(P + 1e-10 * np.eye(9))
    return np.linalg.solve(L, np.broadcast_to(np.eye(9), L.shape))


def pack(streams: dict, features: list, cfg: dict):
    """(leaves, initial, n_landmarks): the batch graph of one dive.
    ``cfg`` is the configuration's "uslam" section (the port's config
    schema, read here as plain numbers)."""
    s = streams
    cam, imu, noise = cfg["camera"], cfg["imu"], cfg["noise"]
    if imu["dt_mode"] != "fixed" or cfg["timesync"]["pose_source"] != "dvl":
        raise NotImplementedError("the reference packs dt_mode 'fixed', poses from the DVL")
    feat_t = np.array([f["t"] for f in features]) if features else np.zeros(0)
    others = [s["dvl_twist_t"]] + ([feat_t] if len(feat_t) else [])
    kf, dvl_i, ff_i = [], [], []
    for pivot_i, picks in time_join(s["dvl_pose_t"], others, cfg["timesync"]["slop"]):
        pi = int(np.searchsorted(s["pressure_t"], float(s["dvl_pose_t"][pivot_i]), "right")) - 1
        if pi < 0:
            continue
        kf.append((pivot_i, pi))
        dvl_i.append(picks[0])
        ff_i.append(picks[1] if len(picks) > 1 else -1)
    pose_i = np.array([a for a, _ in kf])
    press_i = np.array([b for _, b in kf])
    n = len(pose_i)
    if n < 2:
        raise ValueError("the reference packs dives of two keyframes or more")

    kf_t = s["dvl_pose_t"][pose_i].astype(np.float64)
    quats = s["dvl_pose_quat"][pose_i].astype(np.float64)
    pr = cfg["pressure"]
    depth = ((s["pressure_mbar"][press_i] * 100.0 - pr["atm_pressure_pa"])
             / (pr["water_density"] * pr["gravity"]))
    trans = s["dvl_pose_pos"][pose_i].astype(np.float64).copy()
    trans[:, 2] = depth

    S = imu["max_samples_per_keyframe"]
    edges = np.searchsorted(s["imu_t"], kf_t, side="left")
    lo = edges[:-1]
    counts = np.minimum(edges[1:] - lo, S)
    idx = np.clip(lo[:, None] + np.arange(S)[None, :], 0, max(len(s["imu_t"]) - 1, 0))
    live = np.arange(S)[None, :] < counts[:, None]
    acc = np.where(live[..., None], s["imu_acc"][idx], 0.0)
    gyro = np.where(live[..., None], s["imu_gyro"][idx], 0.0)
    dts = np.where(live, imu["default_dt"], 0.0)

    dvl_mask = np.ones(n)
    dvl_mask[0] = 0.0

    rx, ry = cam["resolution_x"], cam["resolution_y"]
    frame, ids, uL, uR, vv = [], [], [], [], []
    for i in range(n):
        if ff_i[i] < 0 or not len(features[ff_i[i]]["ids"]):
            continue
        f = features[ff_i[i]]
        frame.append(np.full(len(f["ids"]), i))
        ids.append(np.asarray(f["ids"]))
        uL.append((f["u0"] + 1.0) * 0.5 * rx)
        uR.append((f["u1"] + 1.0) * 0.5 * rx)
        vv.append(((f["v0"] + f["v1"]) / 2.0 + 1.0) * 0.5 * ry)
    if not frame:
        raise ValueError("the reference packs dives with feature tracks")
    frame, ids, uL, uR, vv = (np.concatenate(a) for a in (frame, ids, uL, uR, vv))
    uniq, first = np.unique(ids, return_index=True)
    order = np.argsort(first, kind="stable")
    uniq, first = uniq[order], first[order]
    row_of = {int(u): r for r, u in enumerate(uniq)}
    rows = np.array([row_of[int(i)] for i in ids], int)
    m = len(uniq)
    lm_init = triangulate(cam, quats[frame[first]], trans[frame[first]],
                          uL[first], uR[first], vv[first])

    keep = frame >= 1
    frame, rows, uL, uR, vv = frame[keep], rows[keep], uL[keep], uR[keep], vv[keep]
    capped = stratified_keep(rows, cfg["solver"]["max_obs_per_landmark"])
    frame, rows, uL, uR, vv = frame[capped], rows[capped], uL[capped], uR[capped], vv[capped]
    f_real = len(frame)
    F = bucket(max(f_real, 1))
    M = bucket(max(m, 1))
    rank = rank_within_group(rows)
    K = bucket(max(int(rank.max()) + 1, 1), minimum=2)

    def padded(a, size, dtype=np.float64):
        out = np.zeros((size,) + a.shape[1:], dtype)
        out[: len(a)] = a
        return out

    lm_obs_idx = np.zeros((M, K), np.int64)
    lm_obs_mask = np.zeros((M, K))
    lm_obs_idx[rows, rank] = np.arange(f_real)
    lm_obs_mask[rows, rank] = 1.0
    bias_sigma = noise["prior_bias_sigma"]
    leaves = {
        "priors.pose_quat": quats[0],
        "priors.pose_trans": trans[0],
        "priors.pose_sigmas": np.asarray(noise["prior_pose_sigmas"], np.float64),
        "priors.vel": np.zeros(3),
        "priors.vel_sigma": np.asarray(noise["prior_vel_sigma"], np.float64),
        "priors.bias": np.zeros(6),
        "priors.bias_weight": np.asarray(0.0 if bias_sigma is None else 1.0 / bias_sigma),
        "priors.marg_sqrt_info": np.zeros((15, 15)),
        "priors.marg_pose_quat": np.array([1.0, 0, 0, 0]),
        "priors.marg_pose_trans": np.zeros(3),
        "priors.marg_vel": np.zeros(3),
        "priors.marg_bias": np.zeros(6),
        "priors.marg_weight": np.zeros(()),
        "imu.data.acc": acc,
        "imu.data.gyro": gyro,
        "imu.data.dt": dts,
        "imu.whitener": imu_whiteners(acc, gyro, dts, imu),
        "imu.mask": (counts > 0).astype(np.float64),
        "dvl.vel_body": s["dvl_twist_vel"][np.array(dvl_i)].astype(np.float64),
        "dvl.mask": dvl_mask,
        "stereo.cam_idx": padded(frame, F, np.int64),
        "stereo.lm_idx": padded(rows, F, np.int64),
        "stereo.meas": padded(np.stack([uL, uR, vv], -1), F),
        "stereo.mask": padded(np.ones(f_real), F),
        "stereo.lm_obs_idx": lm_obs_idx,
        "stereo.lm_obs_mask": lm_obs_mask,
    }
    initial = {
        "pose_quat": quats, "pose_trans": trans, "vel": np.zeros((n, 3)),
        "bias": np.zeros(6), "landmarks": padded(lm_init, M),
    }
    return leaves, initial, m
