"""Fixed-lag smoother: a sliding window of keyframes re-solved by LM, with
the departing keyframe's information carried forward as a dense marginal
prior (port of :mod:`uslam_tpu.solvers.fixed_lag`).

- Host path (:meth:`FixedLagSmoother.add_keyframe`): the window graph is
  rebuilt each keyframe by :class:`GraphBuilder` and solved on the
  smoother's device; the marginal's PSD projection runs in numpy float64.
- Device-resident steady state (``device_resident=True``): the window
  lives in device tensors between keyframes (:class:`DeviceWindowState`).
  Per keyframe the host uploads one record (one pinned, asynchronous copy
  of a packed buffer), :func:`window_step` builds the window graph on the
  device (landmark ids interned by sort and cumulative sum, with no host
  read), runs the LM, takes the dropped factors' marginal, PSD-projects it
  (:func:`uslam_tpu_torch.solvers.eig.sym_eigh`, the ``jacobi_eigh``
  kernel), rolls the state and packs the output, LM statistics included,
  which comes back in one device-to-host copy. On the card these are
  three CUDA graphs keyed by the window's shapes, replayed with no host
  read (the JAX package's ``_device_window_step`` is one program): the
  graph build (``"window_graph"``), the LM (``"lm_solve"``: its loop a
  WHILE node that stops when the window converges, its re-linearization
  an IF node) and the rest (``"window_tail"``). The smoother captures
  them at its first marginalization, before the first steady keyframe.
- Fused (:func:`fused_keyframe_step`): the per-frame front end, id
  interning, triangulation and record assembly run on the device too, in
  one more graph with the graph build (``"fused_front"``), so the host
  uploads the uint8 stereo pair and a small record, and waits for
  nothing until it fetches the output.

Approximations (the JAX package's, standard): marginal cross-couplings to
frames other than the new oldest are dropped, and landmarks whose
observations all left the window are dropped rather than marginalized.

Every solve refuses TF32 matmuls on the card
(:func:`uslam_tpu_torch.pipeline.require_full_float32`). The packed step
output is ``(10 n + 15,)``, float32 on the card: window quat, trans, vel,
the departing frame and the LM statistics, packed on the device
(:func:`window_tail`).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from uslam_tpu_torch.config import UslamConfig
from uslam_tpu_torch.device import resolve_device, synchronize
from uslam_tpu_torch.factors.imu import ImuIntervalData
from uslam_tpu_torch.frontend.orb import Keypoints
from uslam_tpu_torch.frontend.tracker import orb_pair_step
from uslam_tpu_torch.geometry.camera import StereoCamera, triangulate_stereo
from uslam_tpu_torch.geometry.se3 import Pose3
from uslam_tpu_torch.graph.builder import (
    DvlMeasurements,
    GraphArrays,
    GraphBuilder,
    ImuIntervals,
    Priors,
    StereoObservations,
    compute_imu_whiteners,
)
from uslam_tpu_torch.graph.values import BIAS_DIM, FRAME_DIM, Values
from uslam_tpu_torch.pipeline import require_full_float32, run_solver
from uslam_tpu_torch.solvers import compiled
from uslam_tpu_torch.solvers.eig import sym_eigh
from uslam_tpu_torch.solvers.linearize import linearize_graph
from uslam_tpu_torch.solvers.lm import LMStats, solve_lm

# Padding id of the device-resident window's feature slots.
ID_SENTINEL = np.int32(np.iinfo(np.int32).max)


def marginal_information(graph, values: Values, cam, dvl_sigma, stereo_sigma, gravity):
    """15x15 marginal information on [new-oldest pose (6), vel (3), bias (6)]
    from the factors that leave with the departing frame 0: the previous
    marginal prior, frame 0's priors and the IMU interval 0 -> 1. The
    window's other factors stay in the next window, so including them
    would count their information again every step. Frame 0's stereo
    observations are dropped (sparsification); the marginal's mean is the
    window solution."""
    # The same CUDA graph as the LM's linearizations on the card; its
    # outputs come back cloned, so nothing the LM returned is overwritten.
    lin = linearize_graph(graph, values, cam, dvl_sigma, stereo_sigma, gravity)
    F = FRAME_DIM
    D = 2 * F + BIAS_DIM                    # [f0 (9) | f1 (9) | bias (6)]
    like = lin.imu_r

    def z(r, c):
        return torch.zeros((r, c), dtype=like.dtype, device=like.device)

    J_imu = torch.cat(
        [lin.imu_J_pose_i[0], lin.imu_J_vel_i[0], lin.imu_J_pose_j[0],
         lin.imu_J_vel_j[0], lin.imu_J_bias[0]],
        dim=1,
    )                                        # (9, 24)
    J_pp = torch.cat([lin.prior_pose_J, z(6, D - 6)], dim=1)
    J_pv = torch.cat([z(3, 6), lin.prior_vel_J, z(3, D - 9)], dim=1)
    J_pb = torch.cat([z(6, 2 * F), lin.prior_bias_J], dim=1)
    Jm = lin.marg_J                          # (15, 15) over [p0, v0, b]
    J_marg = torch.cat([Jm[:, :F], z(15, F), Jm[:, F:]], dim=1)
    H = (
        J_imu.T @ J_imu
        + J_pp.T @ J_pp
        + J_pv.T @ J_pv
        + J_pb.T @ J_pb
        + J_marg.T @ J_marg
    )
    H00 = H[:F, :F] + 1e-9 * torch.eye(F, dtype=like.dtype, device=like.device)
    Hr0 = H[F:, :F]
    # solve_ex: no host read of the factorization's status on the card.
    return H[F:, F:] - Hr0 @ torch.linalg.solve_ex(H00, Hr0.T)[0]


def solve_and_marginalize(graph, initial, cam, dvl_sigma, stereo_sigma, gravity, solver_cfg):
    """Window LM solve, then the departing frame's marginal information."""
    values, stats = run_solver(graph, initial, cam, dvl_sigma, stereo_sigma, gravity, solver_cfg)
    lam = marginal_information(graph, values, cam, dvl_sigma, stereo_sigma, gravity)
    return values, stats, lam


def imu_whitener_record(imu_samples, config: UslamConfig):
    """Buffered IMU samples (n, 7) or None -> (imu (S, 7) float32, whitener
    (9, 9) float32, valid float32). The whitener comes from the unquantized
    float64 samples; the graph data itself is float32."""
    S = config.imu.max_samples_per_keyframe
    imu64 = np.zeros((S, 7), np.float64)
    valid = 0.0
    if imu_samples is not None and len(imu_samples):
        s = min(len(imu_samples), S)
        imu64[:s] = np.asarray(imu_samples, np.float64)[:s]
        valid = 1.0
    whit = compute_imu_whiteners(
        ImuIntervalData(acc=imu64[None, :, 0:3], gyro=imu64[None, :, 3:6], dt=imu64[None, :, 6]),
        config,
    )[0].astype(np.float32)
    return imu64.astype(np.float32), whit, np.float32(valid)


# ---------------------------------------------------------------------------
# Device-resident window
# ---------------------------------------------------------------------------


class DeviceWindowState(NamedTuple):
    """The steady-state window on the device; frame axis W."""

    quat: torch.Tensor          # (W, 4)
    trans: torch.Tensor         # (W, 3)
    vel: torch.Tensor           # (W, 3)
    bias: torch.Tensor          # (6,)
    imu: torch.Tensor           # (W, S, 7) samples that arrived AT frame i
    imu_whitener: torch.Tensor  # (W, 9, 9)
    imu_valid: torch.Tensor     # (W,)
    dvl: torch.Tensor           # (W, 3)
    feat_ids: torch.Tensor      # (W, Kf) int32, ID_SENTINEL padding
    feat_meas: torch.Tensor     # (W, Kf, 3) pixels (uL, uR, v)
    feat_init: torch.Tensor     # (W, Kf, 3) world init
    feat_mask: torch.Tensor     # (W, Kf)
    marg_sqrt_info: torch.Tensor  # (15, 15)
    marg_quat: torch.Tensor     # (4,)
    marg_trans: torch.Tensor    # (3,)
    marg_vel: torch.Tensor      # (3,)
    marg_bias: torch.Tensor     # (6,)


class DeviceWindowRecord(NamedTuple):
    """One new keyframe."""

    quat: torch.Tensor          # (4,)
    trans: torch.Tensor         # (3,)
    vel: torch.Tensor           # (3,)
    imu: torch.Tensor           # (S, 7)
    imu_whitener: torch.Tensor  # (9, 9)
    imu_valid: torch.Tensor     # ()
    dvl: torch.Tensor           # (3,)
    feat_ids: torch.Tensor      # (Kf,) int32
    feat_meas: torch.Tensor     # (Kf, 3)
    feat_init: torch.Tensor     # (Kf, 3)
    feat_mask: torch.Tensor     # (Kf,)


def upload(tree, device):
    """A NamedTuple of float32 / int32 numpy arrays -> the same NamedTuple of
    tensors on ``device``, in ONE host-to-device copy: the leaves' bits are
    packed into one int32 buffer (integer copies keep every float bit) and
    come back as views of it. To the card the buffer goes pinned and
    asynchronous, so the host does not wait for it."""
    leaves = [np.asarray(a) for a in tree]
    for a in leaves:
        if a.dtype not in (np.float32, np.int32):
            raise TypeError(f"upload: {a.dtype} leaf; need float32 or int32")
    flat = torch.from_numpy(np.concatenate([a.reshape(-1).view(np.int32) for a in leaves]))
    device = torch.device(device)
    if device.type == "cuda":
        # The pinned block is not reused before the copy has ended.
        flat = flat.pin_memory().to(device, non_blocking=True)
    else:
        flat = flat.to(device)
    out, o = [], 0
    for a in leaves:
        t = flat[o : o + a.size]
        o += a.size
        out.append((t.view(torch.float32) if a.dtype == np.float32 else t).reshape(a.shape))
    return type(tree)(*out)


def device_window_graph(st: DeviceWindowState, rec: DeviceWindowRecord):
    """(W+1)-frame (GraphArrays, Values) built on the state's device with no
    host read.

    Landmark rows are the sorted unique ids of the valid observations
    (frames >= 1), padded to M = W Kf + 1 rows with ID_SENTINEL: sort,
    adjacent difference and cumulative sum stand in for a sized unique.
    Each row's observations are listed in flat order; the first one's
    initial point initializes the landmark. Every observation is written
    into a slot of its own (invalid ones into spare rows, cut off)."""
    W, Kf = st.feat_ids.shape
    n = W + 1
    dev, dt = st.trans.device, st.trans.dtype

    def cat(a, b):
        return torch.cat([a, b[None]])

    def full(shape, v):
        return torch.full(shape, v, dtype=dt, device=dev)

    quat, trans, vel = cat(st.quat, rec.quat), cat(st.trans, rec.trans), cat(st.vel, rec.vel)
    imu, whit = cat(st.imu, rec.imu), cat(st.imu_whitener, rec.imu_whitener)
    imu_valid, dvl = cat(st.imu_valid, rec.imu_valid), cat(st.dvl, rec.dvl)
    ids, meas = cat(st.feat_ids, rec.feat_ids), cat(st.feat_meas, rec.feat_meas)
    init, fmask = cat(st.feat_init, rec.feat_init), cat(st.feat_mask, rec.feat_mask)

    priors = Priors(
        pose_quat=quat[0],
        pose_trans=trans[0],
        # The explicit first-frame priors are off: the marginal carries them.
        pose_sigmas=full((6,), 1e6),
        vel=vel[0],
        vel_sigma=full((), 1e6),
        bias=st.bias,
        bias_weight=full((), 0.0),
        marg_sqrt_info=st.marg_sqrt_info,
        marg_pose_quat=st.marg_quat,
        marg_pose_trans=st.marg_trans,
        marg_vel=st.marg_vel,
        marg_bias=st.marg_bias,
        marg_weight=full((), 1.0),
    )
    imu_iv = ImuIntervals(
        data=ImuIntervalData(acc=imu[1:, :, 0:3], gyro=imu[1:, :, 3:6], dt=imu[1:, :, 6]),
        whitener=whit[1:],
        mask=imu_valid[1:],
    )
    dvl_arr = DvlMeasurements(
        vel_body=dvl, mask=torch.cat([full((1,), 0.0), full((n - 1,), 1.0)])
    )

    # ---- stereo: flatten, intern ids, group by landmark -------------------
    F = n * Kf
    M = W * Kf + 1                          # >= 1 sentinel row
    ar = torch.arange(F, device=dev)
    frame_of = torch.div(ar, Kf, rounding_mode="floor").to(torch.int32)
    obs_ok = (fmask.reshape(-1) > 0) & (frame_of >= 1)      # i >= 1 cadence
    ids_flat = torch.where(obs_ok, ids.reshape(-1), int(ID_SENTINEL))
    srt = torch.sort(ids_flat).values
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), srt[1:] != srt[:-1]])
    uniq = torch.full((M,), int(ID_SENTINEL), dtype=torch.int32, device=dev)
    uniq.scatter_(0, torch.cumsum(is_new, 0) - 1, srt)   # repeats write equal values
    rows = torch.clamp(torch.searchsorted(uniq, ids_flat), 0, M - 1)

    # Occurrence rank within each landmark's observations (O(F^2)).
    same = (rows[None, :] == rows[:, None]) & obs_ok[None, :]
    rank = torch.sum(same & (ar[None, :] < ar[:, None]), dim=1)
    K = n  # a landmark appears at most once per frame
    # Invalid observations go to spare rows M.. (one each), cut off below.
    slot = (torch.where(obs_ok, rows, M + ar), torch.clamp(rank, 0, K - 1))
    lm_obs_idx = torch.zeros((M + F, K), dtype=torch.int32, device=dev)
    lm_obs_idx.index_put_(slot, ar.to(torch.int32))
    lm_obs_mask = torch.zeros((M + F, K), dtype=dt, device=dev)
    lm_obs_mask.index_put_(slot, obs_ok.to(dt))
    lm_obs_mask = lm_obs_mask[:M] * (uniq != int(ID_SENTINEL))[:, None]

    # Landmark init = its first (lowest flat index) observation's point.
    first_obs = torch.full((M,), F, dtype=torch.int64, device=dev).scatter_reduce_(
        0, rows, torch.where(obs_ok, ar, F), "amin", include_self=True
    )
    lm_init = init.reshape(F, 3)[torch.clamp(first_obs, 0, F - 1)]
    lm_init = lm_init * (first_obs < F)[:, None]

    stereo = StereoObservations(
        cam_idx=frame_of,
        lm_idx=rows.to(torch.int32),
        meas=meas.reshape(F, 3) * obs_ok[:, None],
        mask=obs_ok.to(dt),
        lm_obs_idx=lm_obs_idx[:M],
        lm_obs_mask=lm_obs_mask,
    )
    graph = GraphArrays(priors=priors, imu=imu_iv, dvl=dvl_arr, stereo=stereo)
    values = Values(pose_quat=quat, pose_trans=trans, vel=vel, bias=st.bias, landmarks=lm_init)
    return graph, values


def window_tail(st: DeviceWindowState, rec: DeviceWindowRecord, graph, values: Values, stats,
                cam, dvl_sigma, stereo_sigma, gravity):
    """The window step after its LM: the dropped factors' marginal, its PSD
    square root (:func:`uslam_tpu_torch.solvers.eig.sym_eigh`: the
    ``jacobi_eigh`` kernel on the card), the state roll and the packing.
    Returns (new state, packed (10 n + 15,) output: window quat, trans, vel,
    the departing frame, then the LM statistics rounded to float32, in the
    window's type as in the JAX package)."""
    lam = marginal_information(graph, values, cam, dvl_sigma, stereo_sigma, gravity)
    w, V, _ = sym_eigh(0.5 * (lam + lam.T))
    # Contiguous, as the host's first marginal is: the next window graph
    # then has the layout its cached graphs were captured with.
    sqrt_info = (V * torch.sqrt(torch.clamp(w, min=0.0))).T.contiguous()

    def roll(a, b):
        return torch.cat([a[1:], b[None]])

    new_state = DeviceWindowState(
        quat=values.pose_quat[1:],
        trans=values.pose_trans[1:],
        vel=values.vel[1:],
        bias=values.bias,
        imu=roll(st.imu, rec.imu),
        imu_whitener=roll(st.imu_whitener, rec.imu_whitener),
        imu_valid=roll(st.imu_valid, rec.imu_valid),
        dvl=roll(st.dvl, rec.dvl),
        feat_ids=roll(st.feat_ids, rec.feat_ids),
        feat_meas=roll(st.feat_meas, rec.feat_meas),
        feat_init=roll(st.feat_init, rec.feat_init),
        feat_mask=roll(st.feat_mask, rec.feat_mask),
        marg_sqrt_info=sqrt_info,
        marg_quat=values.pose_quat[1],
        marg_trans=values.pose_trans[1],
        marg_vel=values.vel[1],
        marg_bias=values.bias,
    )
    dt = values.pose_trans.dtype
    packed = torch.cat([
        values.pose_quat.reshape(-1), values.pose_trans.reshape(-1), values.vel.reshape(-1),
        values.pose_quat[0], values.pose_trans[0], values.vel[0],
        torch.stack([s.to(torch.float32) for s in stats]).to(dt),
    ])
    return new_state, packed


def _graphed(device: torch.device, solver_cfg, graphed: bool | None) -> bool:
    require_full_float32(device)
    if graphed is None:
        return device.type == "cuda" and not solver_cfg.debug_nans
    return graphed


def _solve_window(st, rec, graph, initial, cam, dvl_sigma, stereo_sigma, gravity, solver_cfg,
                  graphed: bool):
    """LM on the window graph, then :func:`window_tail` (its graph,
    ``"window_tail"``, when ``graphed``). Returns (new state, packed)."""
    values, stats = solve_lm(graph, initial, cam, dvl_sigma, stereo_sigma, gravity, solver_cfg,
                             graphed=graphed)
    trees, statics = (st, rec, graph, values, stats, cam), (dvl_sigma, stereo_sigma, gravity)
    if graphed:
        return compiled.call("window_tail", window_tail, trees, statics)
    return window_tail(*trees, *statics)


def window_step(st: DeviceWindowState, rec: DeviceWindowRecord, cam, dvl_sigma, stereo_sigma,
                gravity, solver_cfg, *, graphed: bool | None = None):
    """One steady-state keyframe on the device, the JAX package's
    ``_window_step_core`` / ``_device_window_step``: window graph, LM solve,
    dropped-factor marginal, PSD projection, state roll. Returns (new
    state, the packed (10 n + 15,) output on the device:
    :func:`unpack_step_outputs`).

    ``graphed`` (default: on CUDA without ``debug_nans``): the graph build
    replays as one CUDA graph (``"window_graph"``) keyed by the window's
    shapes, the LM as its solve's graph
    (:func:`uslam_tpu_torch.solvers.lm.solve_lm`: a WHILE node, no host
    read), and the rest as ``"window_tail"``
    (:func:`window_tail`, the marginal's linearization inside it): no host
    read and no launch outside a graph but their copies in and out.
    ``graphed=False`` runs the same bodies eagerly (the linearizations
    replay their own graphs on the card)."""
    graphed = _graphed(st.trans.device, solver_cfg, graphed)
    if graphed:
        graph, initial = compiled.call("window_graph", device_window_graph, (st, rec), ())
    else:
        graph, initial = device_window_graph(st, rec)
    return _solve_window(st, rec, graph, initial, cam, dvl_sigma, stereo_sigma, gravity,
                         solver_cfg, graphed)


def unpack_step_outputs(flat):
    """Packed (10 n + 15,) -> (pose_quat (n, 4), pose_trans (n, 3), vel
    (n, 3), departing (10,), LMStats of scalars rounded to float32)."""
    flat = np.asarray(flat)
    n = (flat.size - 15) // 10
    pq = flat[: 4 * n].reshape(n, 4)
    pt = flat[4 * n : 7 * n].reshape(n, 3)
    vv = flat[7 * n : 10 * n].reshape(n, 3)
    return pq, pt, vv, flat[10 * n : 10 * n + 10], LMStats(*flat[10 * n + 10 :])


# ---------------------------------------------------------------------------
# Fused steady state: the front end on the device too
# ---------------------------------------------------------------------------


class FusedFrontendState(NamedTuple):
    """The tracker's previous frame and id counter, on the device."""

    desc: torch.Tensor     # (K, 8) int32 previous left descriptors
    xy: torch.Tensor       # (K, 2) float32
    mask: torch.Tensor     # (K,) bool
    ids: torch.Tensor      # (K,) int32, -1 = no persistent id
    next_id: torch.Tensor  # () int32


class FusedRecord(NamedTuple):
    """Per-keyframe small inputs, all float32 (one upload)."""

    imu: torch.Tensor         # (S, 7)
    whitener: torch.Tensor    # (9, 9)
    imu_valid: torch.Tensor   # ()
    dvl: torch.Tensor         # (3,)
    quat: torch.Tensor        # (4,) odometry orientation (wxyz)
    pos_xy: torch.Tensor      # (2,) odometry x, y
    depth: torch.Tensor       # () pressure depth (keyframe z)
    vel0: torch.Tensor        # (3,) velocity init (mavros or zeros)
    rotvec: torch.Tensor      # (3,) integrated gyro rotation prev -> cur


def intern_ids(prev_ids, next_id, stereo_ok, tm_idx):
    """Persistent ids on the device, the host loop of
    ``StereoFrontend._intern_ids`` vectorized: a stereo-matched keypoint
    tracked to a previous keypoint with an id inherits it, other
    stereo-matched keypoints take fresh ids in slot order, the rest -1.
    Returns (ids int32, next id)."""
    prev_j = prev_ids[torch.clamp(tm_idx, min=0)]
    tracked = (tm_idx >= 0) & (prev_j >= 0)
    needs_new = stereo_ok & ~tracked
    nn = needs_new.to(torch.int32)
    fresh = next_id + torch.cumsum(nn, 0, dtype=torch.int32) - nn
    ids = torch.where(stereo_ok & tracked, prev_j, torch.where(needs_new, fresh, -1))
    return ids.to(torch.int32), next_id + nn.sum(dtype=torch.int32)


def fused_front(st: DeviceWindowState, fe: FusedFrontendState, pair, rec: FusedRecord, cam,
                kvec, hyp_idx, frontend_cfg):
    """The fused keyframe up to its LM: ORB pair step on the stereo pair
    (2, H, W) (any real dtype, cast here; 3 ``fast_harris`` launches at 3
    levels, 1 ``hamming``), id interning, triangulation at the
    depth-adjusted odometry pose, the window record and the window graph.
    Returns (graph, initial values, window record, new front-end state)."""
    prev = Keypoints(xy=fe.xy, score=None, angle=None, level=None, desc=fe.desc, mask=fe.mask)
    kp_l, kp_r, sm_idx, sm_mask, tm_idx = orb_pair_step(
        pair.to(torch.float32), prev, frontend_cfg, rec.rotvec, kvec, hyp_idx
    )
    ids, next_id = intern_ids(fe.ids, fe.next_id, sm_mask, tm_idx)

    trans = torch.cat([rec.pos_xy, rec.depth[None]])
    xy_r = kp_r.xy[torch.clamp(sm_idx, min=0)]
    meas3 = torch.stack(
        [kp_l.xy[:, 0], xy_r[:, 0], 0.5 * (kp_l.xy[:, 1] + xy_r[:, 1])], dim=-1
    )
    world = triangulate_stereo(cam, Pose3(rec.quat, trans), meas3)
    fmask = sm_mask.to(trans.dtype)
    win_rec = DeviceWindowRecord(
        quat=rec.quat, trans=trans, vel=rec.vel0,
        imu=rec.imu, imu_whitener=rec.whitener, imu_valid=rec.imu_valid, dvl=rec.dvl,
        feat_ids=torch.where(sm_mask, ids, int(ID_SENTINEL)),
        feat_meas=meas3 * fmask[:, None],
        feat_init=world * fmask[:, None],
        feat_mask=fmask,
    )
    graph, initial = device_window_graph(st, win_rec)
    new_fe = FusedFrontendState(desc=kp_l.desc, xy=kp_l.xy, mask=kp_l.mask, ids=ids,
                                next_id=next_id)
    return graph, initial, win_rec, new_fe


def fused_keyframe_step(st: DeviceWindowState, fe: FusedFrontendState, pair, rec: FusedRecord,
                        cam, kvec, hyp_idx, dvl_sigma, stereo_sigma, gravity, solver_cfg,
                        frontend_cfg, *, graphed: bool | None = None):
    """One steady-state keyframe from the stereo pair (2, H, W) on the
    device: :func:`fused_front`, the window's LM and :func:`window_tail`,
    the JAX package's ``_fused_keyframe_step``. Returns (new window state,
    new front-end state, packed (10 n + 15,) float32 output).

    ``graphed`` (as :func:`window_step`'s): :func:`fused_front`
    replays as one CUDA graph (``"fused_front"``: the pair and the record
    are its leaves, ``frontend_cfg`` a static), then the LM step's graph
    and ``"window_tail"``: no host read and no launch outside a graph but
    their copies in and out. ``graphed=False`` runs the same bodies
    eagerly."""
    graphed = _graphed(st.trans.device, solver_cfg, graphed)
    trees = (st, fe, pair, rec, cam, kvec, hyp_idx)
    if graphed:
        graph, initial, win_rec, new_fe = compiled.call("fused_front", fused_front, trees,
                                                        (frontend_cfg,))
    else:
        graph, initial, win_rec, new_fe = fused_front(*trees, frontend_cfg)
    new_state, packed = _solve_window(
        st, win_rec, graph, initial, cam, dvl_sigma, stereo_sigma, gravity, solver_cfg, graphed)
    return new_state, new_fe, packed


# ---------------------------------------------------------------------------
# The smoother
# ---------------------------------------------------------------------------


@dataclass
class Keyframe:
    quat: np.ndarray
    trans: np.ndarray
    vel: np.ndarray
    imu: np.ndarray | None          # (S, 7)
    dvl: np.ndarray
    features: list | None           # [(id, uL, uR, v, init_xyz)]


@dataclass
class FixedLagSmoother:
    """Sliding-window smoother with the reference ``isam.py`` usage shape:
    feed measurements per keyframe, get the window's estimate back.

    ``solve_during_fill=False`` returns the initial values unsolved until
    the window is full. ``device_resident`` keeps the steady-state window
    in device tensors (the fill and the first marginalization use the host
    path). ``steady_solver`` is the solver of steady-state steps (None:
    ``config.solver``); fill-phase solves run ``config.solver``. Solves run
    on ``device``, the card unless the caller asks for the CPU."""

    config: UslamConfig
    window: int = 10
    solve_during_fill: bool = True
    device_resident: bool = False
    feat_slots: int = 64          # per-frame feature slots of the device window
    steady_solver: object = None
    device: object = "cuda"
    _frames: deque = field(default_factory=deque)
    _marg: dict | None = None
    _trajectory: list = field(default_factory=list)
    _dev_state: object = None
    # One entry per solved keyframe. Host path: graph_ms (GraphBuilder and
    # upload), solve_ms (LM, marginal and fetch), lm_iters. Device-resident
    # steps: record_ms, solve_ms (upload + the device's work up to a
    # synchronize), fetch_ms (the device-to-host copy), lm_iters.
    timings: list = field(default_factory=list)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.cam = StereoCamera.from_config(self.config.camera, device=self.device)

    def _noise(self):
        cfg = self.config
        return (self.cam, cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)

    def add_keyframe(self, pose_quat, pose_trans, vel, imu_samples, dvl_vel, features=None):
        """Append one keyframe, solve the window, marginalize if full.
        Returns the window estimate (last entry = newest pose)."""
        self._frames.append(
            Keyframe(
                np.asarray(pose_quat, np.float64),
                np.asarray(pose_trans, np.float64),
                np.asarray(vel, np.float64),
                None if imu_samples is None else np.asarray(imu_samples, np.float64),
                np.zeros(3) if dvl_vel is None else np.asarray(dvl_vel, np.float64),
                features,
            )
        )
        full = len(self._frames) > self.window
        if self.device_resident and self._marg is not None and full:
            return self._device_step()

        if not full and not self.solve_during_fill:
            b = GraphBuilder(self.config)
            for fr in self._frames:
                b.add_keyframe(fr.quat, fr.trans, None, fr.dvl, None, vel_init=fr.vel)
            return b.finalize(with_landmarks=False, device=self.device)[1]

        t0 = time.perf_counter()
        graph, initial = self._window_graph()
        t1 = time.perf_counter()
        if full:
            values, stats, lam = solve_and_marginalize(
                graph, initial, *self._noise(), self.steady_solver or self.config.solver
            )
        else:
            values, stats = run_solver(graph, initial, *self._noise(), self.config.solver)
        pq, pt, vv = (a.cpu().numpy() for a in (values.pose_quat, values.pose_trans, values.vel))
        self.timings.append({
            "graph_ms": (t1 - t0) * 1e3,
            "solve_ms": (time.perf_counter() - t1) * 1e3,
            "lm_iters": stats.iterations,
        })
        # The next window linearizes at the smoothed state.
        for i, fr in enumerate(self._frames):
            fr.quat, fr.trans, fr.vel = pq[i], pt[i], vv[i]
        if full:
            self._store_marginal(lam.cpu().numpy().astype(np.float64), values)
            oldest = self._frames.popleft()
            self._trajectory.append(np.concatenate([oldest.quat, oldest.trans, oldest.vel]))
            if self.device_resident and self._dev_state is None and self.device.type == "cuda":
                self._prime_device_step()
        return values

    def _window_graph(self):
        """The window's (GraphArrays, Values) on the smoother's device, with
        the marginal prior once one exists."""
        b = GraphBuilder(self.config)
        for i, fr in enumerate(self._frames):
            b.add_keyframe(
                fr.quat, fr.trans,
                fr.imu if i > 0 else None,   # the interval belongs to its arrival
                fr.dvl, fr.features, vel_init=fr.vel,
            )
        graph, initial = b.finalize(device=self.device)
        if self._marg is not None:
            m = self._marg

            def t(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

            graph = graph._replace(
                priors=graph.priors._replace(
                    marg_sqrt_info=t(m["sqrt_info"]),
                    marg_pose_quat=t(m["pose_quat"]),
                    marg_pose_trans=t(m["pose_trans"]),
                    marg_vel=t(m["vel"]),
                    marg_bias=t(m["bias"]),
                    marg_weight=t(1.0),
                    # The explicit first-pose/vel/bias priors apply to the
                    # first window only (isam.py:316-319); afterwards the
                    # marginal carries them.
                    pose_sigmas=t(np.full(6, 1e6)),
                    vel_sigma=t(1e6),
                    bias_weight=t(0.0),
                )
            )
        return graph, initial

    def _store_marginal(self, lam: np.ndarray, values: Values) -> None:
        """PSD-project the 15x15 marginal information (numpy float64) and
        keep it as the next window's dense prior on frame 1."""
        w, V = np.linalg.eigh((lam + lam.T) / 2.0)   # sparsification: tiny negative eigs
        self._marg = {
            # sqrt_info^T sqrt_info = lam; C order, the layout of the first
            # window's (zero) prior, whose graphs the next windows replay.
            "sqrt_info": np.ascontiguousarray((V * np.sqrt(np.clip(w, 0.0, None))).T),
            "pose_quat": values.pose_quat[1].cpu().numpy(),
            "pose_trans": values.pose_trans[1].cpu().numpy(),
            "vel": values.vel[1].cpu().numpy(),
            "bias": values.bias.cpu().numpy(),
        }

    # ---- device-resident steady state --------------------------------

    def _frame_record_arrays(self, fr: Keyframe) -> DeviceWindowRecord:
        """One keyframe -> the record's fixed-shape float32 / int32 arrays."""
        Kf = self.feat_slots
        imu, whit, valid = imu_whitener_record(fr.imu, self.config)
        ids = np.full(Kf, ID_SENTINEL, np.int32)
        meas = np.zeros((Kf, 3), np.float32)
        init = np.zeros((Kf, 3), np.float32)
        fmask = np.zeros(Kf, np.float32)
        for k, (lm_id, uL, uR, v, xyz) in enumerate((fr.features or [])[:Kf]):
            ids[k] = lm_id
            meas[k] = (uL, uR, v)
            init[k] = np.asarray(xyz, np.float32)
            fmask[k] = 1.0
        return DeviceWindowRecord(
            quat=np.asarray(fr.quat, np.float32),
            trans=np.asarray(fr.trans, np.float32),
            vel=np.asarray(fr.vel, np.float32),
            imu=imu,
            imu_whitener=whit,
            imu_valid=valid,
            dvl=np.asarray(fr.dvl, np.float32),
            feat_ids=ids,
            feat_meas=meas,
            feat_init=init,
            feat_mask=fmask,
        )

    def _init_device_state(self, frames=None) -> None:
        """Upload the window (all frames but the just-appended one, by
        default) and the marginal, in one copy."""
        if frames is None:
            frames = list(self._frames)[:-1]
        recs = [self._frame_record_arrays(fr) for fr in frames]
        m = self._marg

        def stack(name):
            return np.stack([getattr(r, name) for r in recs])

        def f32(a):
            return np.asarray(a, np.float32)

        self._dev_state = upload(
            DeviceWindowState(
                quat=stack("quat"), trans=stack("trans"), vel=stack("vel"), bias=f32(m["bias"]),
                imu=stack("imu"), imu_whitener=stack("imu_whitener"),
                imu_valid=stack("imu_valid"), dvl=stack("dvl"),
                feat_ids=stack("feat_ids"), feat_meas=stack("feat_meas"),
                feat_init=stack("feat_init"), feat_mask=stack("feat_mask"),
                marg_sqrt_info=f32(m["sqrt_info"]), marg_quat=f32(m["pose_quat"]),
                marg_trans=f32(m["pose_trans"]), marg_vel=f32(m["vel"]),
                marg_bias=f32(m["bias"]),
            ),
            self.device,
        )

    def _prime_device_step(self) -> None:
        """Capture the steady keyframe's CUDA graphs (``"window_graph"``, the
        window's ``"lm_solve"``, ``"window_tail"``) at the first
        marginalization, so that no steady keyframe pays for them: the device
        window is made from the frames just kept (as the first steady step
        would make it), and one step runs on the newest frame's record, its
        results dropped."""
        self._init_device_state(frames=list(self._frames))
        rec = upload(self._frame_record_arrays(self._frames[-1]), self.device)
        window_step(self._dev_state, rec, *self._noise(), self.steady_solver or self.config.solver)

    def _dispatch(self, rec: DeviceWindowRecord) -> torch.Tensor:
        """A steady keyframe on the device, from the upload of its record
        (numpy) to the packed output: on the card, graph replays with no
        host read."""
        self._dev_state, packed = window_step(
            self._dev_state, upload(rec, self.device), *self._noise(),
            self.steady_solver or self.config.solver,
        )
        return packed

    def _device_step(self) -> Values:
        if self._dev_state is None:
            self._init_device_state()
        t0 = time.perf_counter()
        rec = self._frame_record_arrays(self._frames[-1])
        t1 = time.perf_counter()
        packed = self._dispatch(rec)
        synchronize(self.device)
        t2 = time.perf_counter()
        pq, pt, vv, departing, stats = unpack_step_outputs(packed.cpu().numpy())
        t3 = time.perf_counter()
        self.timings.append({
            "record_ms": (t1 - t0) * 1e3,
            "solve_ms": (t2 - t1) * 1e3,
            "fetch_ms": (t3 - t2) * 1e3,
            "lm_iters": int(stats.iterations),
        })
        # Roll the host mirror (full_trajectory, checkpoints).
        self._frames.popleft()
        for i, fr in enumerate(self._frames):
            fr.quat, fr.trans, fr.vel = pq[i + 1], pt[i + 1], vv[i + 1]
        self._trajectory.append(np.asarray(departing, np.float64))
        return Values(
            pose_quat=pq, pose_trans=pt, vel=vv,
            bias=np.zeros(6, np.float32), landmarks=np.zeros((1, 3), np.float32),
        )

    # ------------------------------------------------------------------

    @property
    def trajectory(self) -> np.ndarray:
        """Marginalized (final) keyframes so far: (T, 10) [quat, trans, vel]."""
        if not self._trajectory:
            return np.zeros((0, 10))
        return np.stack(self._trajectory)

    def full_trajectory(self) -> np.ndarray:
        """Final + current-window translations (T_total, 3)."""
        done = self.trajectory[:, 4:7] if self._trajectory else np.zeros((0, 3))
        cur = np.stack([f.trans for f in self._frames]) if self._frames else np.zeros((0, 3))
        return np.concatenate([done, cur], axis=0)


# ---------------------------------------------------------------------------
# Checkpoint / resume: the JAX package's npz layout, so a state crosses
# between the two packages either way.
# ---------------------------------------------------------------------------


def save_smoother_state(path: str, sm: FixedLagSmoother) -> None:
    """The smoother's resumable state (window keyframes, marginal prior,
    final trajectory) as one npz. A device-resident window is rebuilt at
    the first steady-state step after loading."""
    arrays: dict[str, np.ndarray] = {
        "window": np.asarray(sm.window),
        "n_frames": np.asarray(len(sm._frames)),
        "trajectory": np.stack(sm._trajectory) if sm._trajectory else np.zeros((0, 10)),
        "has_marg": np.asarray(1 if sm._marg is not None else 0),
    }
    if sm._marg is not None:
        for k, v in sm._marg.items():
            arrays[f"marg_{k}"] = np.asarray(v)
    for i, fr in enumerate(sm._frames):
        arrays[f"f{i}_quat"] = fr.quat
        arrays[f"f{i}_trans"] = fr.trans
        arrays[f"f{i}_vel"] = fr.vel
        arrays[f"f{i}_imu"] = fr.imu if fr.imu is not None else np.zeros((0, 7))
        arrays[f"f{i}_dvl"] = fr.dvl
        feats = fr.features or []
        arrays[f"f{i}_feat"] = np.array(
            [[f[0], f[1], f[2], f[3], *np.asarray(f[4], np.float64)] for f in feats],
            np.float64,
        ).reshape(len(feats), 7)
    np.savez_compressed(path, **arrays)


def load_smoother_state(path: str, config: UslamConfig, **kwargs) -> FixedLagSmoother:
    """A FixedLagSmoother from :func:`save_smoother_state`'s npz (or the
    JAX package's). ``kwargs`` (device, solve_during_fill, ...) pass to the
    smoother."""
    z = np.load(path, allow_pickle=False)
    sm = FixedLagSmoother(config, window=int(z["window"]), **kwargs)
    sm._trajectory.extend(z["trajectory"])
    if int(z["has_marg"]):
        sm._marg = {k[len("marg_"):]: z[k] for k in z.files if k.startswith("marg_")}
    for i in range(int(z["n_frames"])):
        feats = [
            (int(r[0]), float(r[1]), float(r[2]), float(r[3]), r[4:7]) for r in z[f"f{i}_feat"]
        ] or None
        imu = z[f"f{i}_imu"]
        sm._frames.append(
            Keyframe(
                quat=z[f"f{i}_quat"],
                trans=z[f"f{i}_trans"],
                vel=z[f"f{i}_vel"],
                imu=imu if len(imu) else None,
                dvl=z[f"f{i}_dvl"],
                features=feats,
            )
        )
    return sm
