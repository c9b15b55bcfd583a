"""Vectorized sequence -> factor graph packing, host numpy.

Port of :func:`uslam_tpu.graph.packing.pack_sequence`: the same time join,
keyframe depth substitution, IMU interval slicing, landmark interning and
stratified observation budget, producing the same leaves (tested leaf for
leaf against the JAX package). The leaves stay numpy; the caller uploads
the whole tree once with :func:`uslam_tpu_torch.interop.to_port`.
"""

from __future__ import annotations

import numpy as np

from uslam_tpu_torch.config import UslamConfig
from uslam_tpu_torch.factors.depth import pressure_to_depth
from uslam_tpu_torch.factors.imu import ImuIntervalData
from uslam_tpu_torch.geometry.camera import triangulate_stereo_np
from uslam_tpu_torch.graph.builder import (
    DvlMeasurements,
    GraphArrays,
    ImuIntervals,
    Priors,
    StereoObservations,
    bucket,
    compute_imu_whiteners,
    rank_within_group,
    stratified_obs_mask,
)
from uslam_tpu_torch.graph.values import Values
from uslam_tpu_torch.io.sequence import SensorSequence
from uslam_tpu_torch.io.timesync import approximate_time_join


def _nearest_within_slop(
    query_t: np.ndarray, stream_t: np.ndarray, stream_v: np.ndarray, slop: float
) -> np.ndarray:
    """Stream value at the closest stamp to each query time, zeros where no
    sample lies within ``slop``."""
    hi = np.searchsorted(stream_t, query_t)
    lo = np.clip(hi - 1, 0, len(stream_t) - 1)
    hi = np.clip(hi, 0, len(stream_t) - 1)
    pick = np.where(
        np.abs(stream_t[hi] - query_t) < np.abs(stream_t[lo] - query_t), hi, lo
    )
    out = stream_v[pick].astype(np.float64)
    out[np.abs(stream_t[pick] - query_t) > slop] = 0.0
    return out


def pack_sequence(
    seq: SensorSequence,
    config: UslamConfig,
    with_landmarks: bool = True,
):
    """Time-join the streams and pack the factor graph.

    Returns (graph, initial_values, odom_compare, landmark_id_rows) with
    numpy leaves. Keyframes are the synchronized (odom, dvl, features)
    triples (reference batch.py:325), keyframe z is the latest pressure
    depth (batch.py:133), and landmarks start at the triangulation of their
    first observation."""
    cfg = config
    feat_t = np.array([f.t for f in seq.features]) if seq.features else np.zeros(0)
    streams = [seq.dvl_twist_t] + ([feat_t] if len(feat_t) else [])
    triples = approximate_time_join(seq.dvl_pose_t, streams, cfg.timesync.slop)

    # Latest pressure at or before each keyframe; keyframes before the
    # first pressure message are dropped (reference batch.py:54).
    kf, dvl_i, ff_i = [], [], []
    for pivot_i, picks in triples:
        t = float(seq.dvl_pose_t[pivot_i])
        pi = int(np.searchsorted(seq.pressure_t, t, side="right")) - 1
        if pi < 0:
            continue
        kf.append((pivot_i, pi))
        dvl_i.append(picks[0])
        ff_i.append(picks[1] if len(picks) > 1 else -1)
    if not kf:
        raise ValueError("no usable keyframes after time sync")
    kf_pose_i = np.array([a for a, _ in kf])
    kf_press_i = np.array([b for _, b in kf])
    n = len(kf_pose_i)

    kf_t = seq.dvl_pose_t[kf_pose_i].astype(np.float64)
    if cfg.timesync.pose_source == "gt" and seq.gt_quat is not None:
        quats = seq.gt_quat[kf_pose_i].astype(np.float64)
        odom_compare = seq.gt_pos[kf_pose_i].astype(np.float64)
    else:
        quats = seq.dvl_pose_quat[kf_pose_i].astype(np.float64)
        odom_compare = seq.dvl_pose_pos[kf_pose_i].astype(np.float64)
    depth = np.asarray(pressure_to_depth(seq.pressure_mbar[kf_press_i], cfg.pressure))
    trans = odom_compare.copy()
    trans[:, 2] = depth

    # --- IMU intervals: interval i uses samples in [kf_t[i], kf_t[i+1]) ---
    S = cfg.imu.max_samples_per_keyframe
    hi = np.searchsorted(seq.imu_t, kf_t, side="left")
    lo_int, hi_int = hi[:-1], hi[1:]
    counts = np.minimum(hi_int - lo_int, S)
    idx = lo_int[:, None] + np.arange(S)[None, :] if n > 1 else np.zeros((1, S), int)
    idx = np.clip(idx, 0, max(len(seq.imu_t) - 1, 0))
    sample_mask = (
        (np.arange(S)[None, :] < counts[:, None]) if n > 1 else np.zeros((1, S), bool)
    )
    acc = np.where(sample_mask[..., None], seq.imu_acc[idx], 0.0)
    gyro = np.where(sample_mask[..., None], seq.imu_gyro[idx], 0.0)
    if cfg.imu.dt_mode == "stamps" and len(seq.imu_t) > 1:
        step = np.diff(seq.imu_t, append=seq.imu_t[-1] + np.median(np.diff(seq.imu_t)))
        dts = np.where(sample_mask, step[idx], 0.0)
    else:
        dts = np.where(sample_mask, cfg.imu.default_dt, 0.0)
    imu_mask = (counts > 0).astype(np.float64) if n > 1 else np.zeros(1)

    # --- DVL: a factor for every keyframe i >= 1 ---------------------------
    dvl = seq.dvl_twist_vel[np.array(dvl_i)].astype(np.float64)
    dvl_mask = np.ones(n)
    dvl_mask[0] = 0.0

    # --- velocity initial estimates: the mavros stream when present
    # (reference isam.py:306,319-328), zero otherwise (batch.py:279) -----
    vel_init = np.zeros((n, 3))
    if seq.mavros_vel is not None and seq.mavros_vel_t is not None and len(
        seq.mavros_vel_t
    ):
        vel_init = _nearest_within_slop(
            kf_t, np.asarray(seq.mavros_vel_t, np.float64),
            np.asarray(seq.mavros_vel, np.float64), cfg.timesync.slop,
        )

    # --- stereo features -------------------------------------------------
    rx, ry = cfg.camera.resolution_x, cfg.camera.resolution_y
    frames, ids_all, uL_all, uR_all, v_all = [], [], [], [], []
    if with_landmarks and len(feat_t):
        for i in range(n):
            fi = ff_i[i]
            if fi < 0:
                continue
            ff = seq.features[fi]
            k = len(ff.ids)
            if k == 0:
                continue
            frames.append(np.full(k, i))
            ids_all.append(np.asarray(ff.ids))
            uL_all.append((ff.u0 + 1.0) * 0.5 * rx)
            uR_all.append((ff.u1 + 1.0) * 0.5 * rx)
            v_all.append(((ff.v0 + ff.v1) / 2.0 + 1.0) * 0.5 * ry)
    if frames:
        frame_idx = np.concatenate(frames)
        ids = np.concatenate(ids_all)
        uL = np.concatenate(uL_all)
        uR = np.concatenate(uR_all)
        vv = np.concatenate(v_all)
    else:
        frame_idx = np.zeros(0, int)
        ids = np.zeros(0, int)
        uL = uR = vv = np.zeros(0)

    # Intern ids -> dense rows in first-appearance order.
    uniq, first_pos = np.unique(ids, return_index=True)
    order = np.argsort(first_pos, kind="stable")
    uniq = uniq[order]
    first_pos = first_pos[order]
    row_of = {int(u): r for r, u in enumerate(uniq)}
    lm_rows = np.array([row_of[int(i)] for i in ids], int) if len(ids) else np.zeros(0, int)
    m = len(uniq)

    if m:
        f0 = first_pos
        lm_init = triangulate_stereo_np(
            cfg.camera,
            quats[frame_idx[f0]],
            trans[frame_idx[f0]],
            np.stack([uL[f0], uR[f0], vv[f0]], -1),
        )
    else:
        lm_init = np.zeros((0, 3))

    # Stereo factors for keyframes i >= 1 only (reference batch.py:295),
    # under the per-landmark observation budget.
    keep = frame_idx >= 1
    frame_k, lm_k = frame_idx[keep], lm_rows[keep]
    uL_k, uR_k, v_k = uL[keep], uR[keep], vv[keep]
    cap = cfg.solver.max_obs_per_landmark
    if len(lm_k):
        capped = stratified_obs_mask(lm_k, cap)
        frame_k, lm_k = frame_k[capped], lm_k[capped]
        uL_k, uR_k, v_k = uL_k[capped], uR_k[capped], v_k[capped]

    f_real = len(frame_k)
    F = bucket(max(f_real, 1))
    cam_idx = np.zeros(F, np.int32)
    lm_idx = np.zeros(F, np.int32)
    meas = np.zeros((F, 3))
    s_mask = np.zeros(F)
    cam_idx[:f_real] = frame_k
    lm_idx[:f_real] = lm_k
    meas[:f_real] = np.stack([uL_k, uR_k, v_k], -1) if f_real else 0.0
    s_mask[:f_real] = 1.0

    M = bucket(max(m, 1))
    if f_real:
        rank = rank_within_group(lm_k)
        K = bucket(max(int(rank.max()) + 1, 1), minimum=2)
        lm_obs_idx = np.zeros((M, K), np.int32)
        lm_obs_mask = np.zeros((M, K))
        lm_obs_idx[lm_k, rank] = np.arange(f_real)
        lm_obs_mask[lm_k, rank] = 1.0
    else:
        lm_obs_idx = np.zeros((M, 2), np.int32)
        lm_obs_mask = np.zeros((M, 2))

    landmarks = np.zeros((M, 3))
    if m:
        landmarks[:m] = lm_init

    npt = np.float32
    noise = cfg.noise
    bias_weight = 0.0 if noise.prior_bias_sigma is None else 1.0 / noise.prior_bias_sigma
    priors = Priors(
        pose_quat=np.asarray(quats[0], npt),
        pose_trans=np.asarray(trans[0], npt),
        pose_sigmas=np.asarray(noise.prior_pose_sigmas, npt),
        vel=np.asarray(vel_init[0], npt),
        vel_sigma=np.asarray(noise.prior_vel_sigma, npt),
        bias=np.zeros(6, npt),
        bias_weight=np.asarray(bias_weight, npt),
        marg_sqrt_info=np.zeros((15, 15), npt),
        marg_pose_quat=np.array([1.0, 0, 0, 0], npt),
        marg_pose_trans=np.zeros(3, npt),
        marg_vel=np.zeros(3, npt),
        marg_bias=np.zeros(6, npt),
        marg_weight=np.zeros((), npt),
    )
    # Whiteners from the unquantized f64 samples, as the JAX package does.
    imu = ImuIntervals(
        data=ImuIntervalData(
            acc=np.asarray(acc, npt), gyro=np.asarray(gyro, npt), dt=np.asarray(dts, npt)
        ),
        whitener=np.asarray(
            compute_imu_whiteners(ImuIntervalData(acc, gyro, dts), cfg), npt
        ),
        mask=np.asarray(imu_mask, npt),
    )
    graph = GraphArrays(
        priors=priors,
        imu=imu,
        dvl=DvlMeasurements(np.asarray(dvl, npt), np.asarray(dvl_mask, npt)),
        stereo=StereoObservations(
            cam_idx=cam_idx,
            lm_idx=lm_idx,
            meas=np.asarray(meas, npt),
            mask=np.asarray(s_mask, npt),
            lm_obs_idx=lm_obs_idx,
            lm_obs_mask=np.asarray(lm_obs_mask, npt),
        ),
    )
    values = Values(
        pose_quat=np.asarray(quats, npt),
        pose_trans=np.asarray(trans, npt),
        vel=np.asarray(vel_init, npt),
        bias=np.zeros(6, npt),
        landmarks=np.asarray(landmarks, npt),
    )
    return graph, values, odom_compare, row_of
