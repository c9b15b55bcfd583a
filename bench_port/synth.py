"""The benchmark's frozen dive generator: physically consistent synthetic
AUV sequences with known ground truth, host numpy.

A copy, draw for draw, of the generator the port ships
(``uslam_tpu_torch/io/synthetic.py`` as of the benchmark's first version),
kept here so that a change to the program cannot change the benchmark's
inputs. It returns plain numpy arrays; ``bench_port/drivers`` hand them to
the program through its public input types.

Trajectory: a horizontal circle ('orbit') or a sinusoidal transect
('survey') with a slow climb; the body frame looks along the direction of
travel (z forward, x right, y down). World frame: z up, gravity (0, 0, -g).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class DiveSpec:
    duration: float = 20.0
    keyframe_rate: float = 5.0
    imu_rate: float = 200.0
    trajectory: str = "orbit"
    radius: float = 5.0
    omega: float = 0.25
    survey_amplitude: float = 3.0
    survey_wavelength: float = 40.0
    climb_rate: float = -0.02
    z0: float = -2.0
    ramp_tau: float = 2.0
    num_landmarks: int = 200
    landmark_ring_width: float = 3.0
    landmark_z_spread: float = 2.0
    max_feature_depth: float = 15.0
    min_feature_depth: float = 0.5
    gravity: float = 9.81
    imu_acc_noise: float = 0.0
    imu_gyro_noise: float = 0.0
    dvl_noise: float = 0.0
    feature_noise_px: float = 0.0
    odom_drift_rate: float = 0.0
    seed: int = 0


@dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    resolution_x: int
    resolution_y: int

    @classmethod
    def from_dict(cls, d: dict) -> "Camera":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__})


@dataclass
class Dive:
    """One generated dive: the sensor streams, the feature tracks (one dict
    per keyframe: t, ids, u0, v0, u1, v1 in [-1, 1]), the ground truth and
    the landmarks the images are rendered from."""

    streams: dict
    features: list
    truth: dict
    landmarks: np.ndarray
    keyframes: dict = field(default_factory=dict)


def _body_frame(t, zb, rate):
    zeros = np.zeros_like(t)
    yb = np.stack([zeros, zeros, -np.ones_like(t)], axis=-1)
    xb = np.cross(yb, zb)
    R = np.stack([xb, yb, zb], axis=-1)
    om_w = np.stack([zeros, zeros, rate], axis=-1)
    return R, np.einsum("tij,tj->ti", np.swapaxes(R, -1, -2), om_w)


def pose_at(spec: DiveSpec, t: np.ndarray) -> dict:
    """Analytic pos, world_R_body R, vel, acc and body rates at times t."""
    tau = spec.ramp_tau
    e = np.exp(-t / tau)
    if spec.trajectory == "survey":
        v = spec.omega * spec.radius
        u, du, ddu = v * (t - tau * (1.0 - e)), v * (1.0 - e), (v / tau) * e
        A, k = spec.survey_amplitude, 2.0 * np.pi / spec.survey_wavelength
        sin_ku, cos_ku = np.sin(k * u), np.cos(k * u)
        pos = np.stack([u, A * sin_ku, spec.z0 + spec.climb_rate * t], axis=-1)
        vel = np.stack([du, A * k * cos_ku * du, np.full_like(t, spec.climb_rate)], axis=-1)
        acc = np.stack(
            [ddu, A * k * cos_ku * ddu - A * k * k * sin_ku * du * du, np.zeros_like(t)],
            axis=-1,
        )
        slope = A * k * cos_ku
        psi = np.arctan(slope)
        dpsi = (-A * k * k * sin_ku / (1.0 + slope * slope)) * du
        zb = np.stack([np.cos(psi), np.sin(psi), np.zeros_like(t)], axis=-1)
        R, om_b = _body_frame(t, zb, dpsi)
        return {"pos": pos, "R": R, "vel": vel, "acc": acc, "omega_body": om_b}
    th = spec.omega * (t - tau * (1.0 - e))
    dth = spec.omega * (1.0 - e)
    ddth = (spec.omega / tau) * e
    c, s = np.cos(th), np.sin(th)
    R_c = spec.radius
    pos = np.stack([R_c * c, R_c * s, spec.z0 + spec.climb_rate * t], axis=-1)
    vel = np.stack([-R_c * dth * s, R_c * dth * c, np.full_like(t, spec.climb_rate)], axis=-1)
    acc = np.stack(
        [
            -R_c * ddth * s - R_c * dth**2 * c,
            R_c * ddth * c - R_c * dth**2 * s,
            np.zeros_like(t),
        ],
        axis=-1,
    )
    R, om_b = _body_frame(t, np.stack([-s, c, np.zeros_like(t)], axis=-1), dth)
    return {"pos": pos, "R": R, "vel": vel, "acc": acc, "omega_body": om_b}


def project(cam: Camera, R, p, landmarks):
    """Camera-frame depth z and stereo pixels (uL, uR, v) of every landmark."""
    p_cam = (landmarks - p) @ R
    z = p_cam[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uL = cam.fx * p_cam[:, 0] / z + cam.cx
        uR = cam.fx * (p_cam[:, 0] - cam.baseline) / z + cam.cx
        v = cam.fy * p_cam[:, 1] / z + cam.cy
    return z, uL, uR, v


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(T, 3, 3) -> (T, 4) wxyz with w >= 0."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(R).as_quat()
    q = np.concatenate([q[:, 3:4], q[:, :3]], axis=-1)
    return np.where(q[:, :1] < 0, -q, q)


def generate(spec: DiveSpec, cam: Camera, pressure: dict) -> Dive:
    """IMU at ``imu_rate``; DVL pose (random-walk drift), DVL twist,
    pressure and stereo feature tracks at ``keyframe_rate``; ground truth
    at keyframe rate. ``pressure``: atm_pressure_pa, water_density,
    gravity."""
    rng = np.random.default_rng(spec.seed)
    g_world = np.array([0.0, 0.0, -spec.gravity])

    imu_t = np.arange(0.0, spec.duration, 1.0 / spec.imu_rate)
    st = pose_at(spec, imu_t)
    f_body = np.einsum("tij,tj->ti", np.swapaxes(st["R"], -1, -2), st["acc"] - g_world)
    acc_meas = f_body + rng.normal(0, spec.imu_acc_noise, f_body.shape)
    gyro_meas = st["omega_body"] + rng.normal(0, spec.imu_gyro_noise, f_body.shape)

    kf_t = np.arange(0.0, spec.duration, 1.0 / spec.keyframe_rate)
    kf = pose_at(spec, kf_t)
    kf_quat = _rot_to_quat(kf["R"])
    vel_body = np.einsum("tij,tj->ti", np.swapaxes(kf["R"], -1, -2), kf["vel"])
    dvl_twist = vel_body + rng.normal(0, spec.dvl_noise, vel_body.shape)
    drift = np.cumsum(
        rng.normal(0, spec.odom_drift_rate / np.sqrt(spec.keyframe_rate), (len(kf_t), 3)),
        axis=0,
    )
    dvl_pos = kf["pos"] + drift
    press_pa = (
        kf["pos"][:, 2] * (pressure["water_density"] * pressure["gravity"])
        + pressure["atm_pressure_pa"]
    )

    n = spec.num_landmarks
    if spec.trajectory == "survey":
        v_fwd = spec.omega * spec.radius
        x_lm = rng.uniform(0.0, v_fwd * spec.duration + spec.max_feature_depth, n)
        y_lm = spec.survey_amplitude * np.sin(
            2.0 * np.pi * x_lm / spec.survey_wavelength
        ) + rng.uniform(-spec.landmark_ring_width, spec.landmark_ring_width, n)
        z_lm = (
            spec.z0
            + spec.climb_rate * (x_lm / max(v_fwd, 1e-9))
            + rng.uniform(-spec.landmark_z_spread, spec.landmark_z_spread, n)
        )
        landmarks = np.stack([x_lm, y_lm, z_lm], axis=-1)
    else:
        r_lm = spec.radius + rng.uniform(-spec.landmark_ring_width, spec.landmark_ring_width, n)
        th_lm = rng.uniform(0, 2 * np.pi, n)
        z_lm = spec.z0 + rng.uniform(-spec.landmark_z_spread, spec.landmark_z_spread, n)
        landmarks = np.stack([r_lm * np.cos(th_lm), r_lm * np.sin(th_lm), z_lm], axis=-1)

    rx, ry = cam.resolution_x, cam.resolution_y
    features = []
    for k, t in enumerate(kf_t):
        z, uL, uR, v = project(cam, kf["R"][k], kf["pos"][k], landmarks)
        vis = (
            (z > spec.min_feature_depth) & (z < spec.max_feature_depth)
            & (uL >= 0) & (uL < rx) & (uR >= 0) & (uR < rx) & (v >= 0) & (v < ry)
        )
        ids = np.nonzero(vis)[0]
        n_px = spec.feature_noise_px
        uLn = uL[vis] + rng.normal(0, n_px, ids.shape)
        uRn = uR[vis] + rng.normal(0, n_px, ids.shape)
        vn = v[vis] + rng.normal(0, n_px, ids.shape)
        features.append({
            "t": float(t), "ids": ids.astype(np.int64),
            "u0": uLn / (0.5 * rx) - 1.0, "v0": vn / (0.5 * ry) - 1.0,
            "u1": uRn / (0.5 * rx) - 1.0, "v1": vn / (0.5 * ry) - 1.0,
        })

    streams = dict(
        imu_t=imu_t, imu_acc=acc_meas, imu_gyro=gyro_meas,
        pressure_t=kf_t.copy(), pressure_mbar=press_pa / 100.0,
        dvl_pose_t=kf_t.copy(), dvl_pose_quat=kf_quat, dvl_pose_pos=dvl_pos,
        dvl_twist_t=kf_t.copy(), dvl_twist_vel=dvl_twist,
    )
    truth = dict(gt_t=kf_t.copy(), gt_quat=kf_quat, gt_pos=kf["pos"], gt_vel=kf["vel"])
    return Dive(streams=streams, features=features, truth=truth, landmarks=landmarks,
                keyframes={"R": kf["R"], "pos": kf["pos"], "t": kf_t})


def track_budget(features: list, cam: Camera, rows: int, cols: int, per_cell: int,
                 seed: int) -> list:
    """The front end's feature budget applied to every landmark's
    projection: not a copy of the port's generator, the benchmark's model of
    the tracks that a grid front end (the reference's image processor,
    launch/stereo.launch:37-40) publishes.

    In each cell of a ``rows`` x ``cols`` grid over the left image at most
    ``per_cell`` features are kept: tracks that continue from the keyframe
    before first, the longest-lived first, then new ones in an order drawn
    from ``seed``. A track that is not kept ends; a landmark seen again after
    a gap starts a new track with a new id, as a tracker that follows
    features from frame to frame gives (no loop closures)."""
    rng = np.random.default_rng([int(seed), 0x627564])
    rx, ry = cam.resolution_x, cam.resolution_y
    prev: dict = {}          # landmark -> (track id, age in keyframes)
    next_id = 0
    out = []
    for f in features:
        ids = np.asarray(f["ids"])
        u = (f["u0"] + 1.0) * 0.5 * rx
        v = (f["v0"] + 1.0) * 0.5 * ry
        cell = (np.clip((v * rows // ry).astype(np.int64), 0, rows - 1) * cols
                + np.clip((u * cols // rx).astype(np.int64), 0, cols - 1))
        age = np.array([prev[int(i)][1] if int(i) in prev else -1 for i in ids], np.int64)
        order = np.lexsort((rng.random(len(ids)), -age, cell))
        c = cell[order]
        keep = np.sort(order[np.arange(len(c)) - np.searchsorted(c, c, side="left") < per_cell])
        cur = {}
        for i in ids[keep]:
            i = int(i)
            if i in prev:
                cur[i] = (prev[i][0], prev[i][1] + 1)
            else:
                cur[i] = (next_id, 0)
                next_id += 1
        prev = cur
        out.append({"t": f["t"], "ids": np.array([cur[int(i)][0] for i in ids[keep]], np.int64),
                    **{k: f[k][keep] for k in ("u0", "v0", "u1", "v1")}})
    return out


def digest(dive: Dive) -> str:
    """sha256 of every array of a dive, in a fixed order (the frozen copy's
    check against the port's generator)."""
    import hashlib

    h = hashlib.sha256()
    for group in (dive.streams, dive.truth):
        for k in sorted(group):
            h.update(k.encode())
            h.update(np.ascontiguousarray(group[k], np.float64).tobytes())
    for f in dive.features:
        h.update(np.asarray(f["ids"], np.int64).tobytes())
        for k in ("t", "u0", "v0", "u1", "v1"):
            h.update(np.ascontiguousarray(f[k], np.float64).tobytes())
    return h.hexdigest()
