"""Time-stamped sensor streams, one array per topic, and the front end's
per-frame output (the JAX package's containers, field for field).

- imu:       t (T,), acc (T, 3), gyro (T, 3)
- pressure:  t (P,), absolute pressure in mbar (P,)
- dvl_pose:  t (D,), quat wxyz (D, 4), pos (D, 3)
- dvl_twist: t (V,), body-frame velocity (V, 3)
- features:  one FeatureFrame per stereo frame, normalized [-1, 1] coords
- optional raw stereo images for the ORB front end, and ground truth.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FeatureFrame:
    """One frame of stereo feature tracks (normalized coordinates)."""

    t: float
    ids: np.ndarray   # (k,) int64 persistent track ids
    u0: np.ndarray    # (k,) left x in [-1, 1]
    v0: np.ndarray    # (k,) left y in [-1, 1]
    u1: np.ndarray    # (k,) right x in [-1, 1]
    v1: np.ndarray    # (k,) right y in [-1, 1]


@dataclass
class SensorSequence:
    imu_t: np.ndarray
    imu_acc: np.ndarray
    imu_gyro: np.ndarray
    pressure_t: np.ndarray
    pressure_mbar: np.ndarray
    dvl_pose_t: np.ndarray
    dvl_pose_quat: np.ndarray   # wxyz
    dvl_pose_pos: np.ndarray
    dvl_twist_t: np.ndarray
    dvl_twist_vel: np.ndarray
    features: list = field(default_factory=list)   # list[FeatureFrame]
    # Optional ENU velocity stream, used as the initial velocity estimate.
    mavros_vel_t: np.ndarray | None = None
    mavros_vel: np.ndarray | None = None
    # Optional raw rectified stereo imagery (T, H, W) for the front end.
    image_t: np.ndarray | None = None
    images_left: np.ndarray | None = None
    images_right: np.ndarray | None = None
    # Optional ground truth at keyframe rate (synthetic sequences).
    gt_t: np.ndarray | None = None
    gt_quat: np.ndarray | None = None
    gt_pos: np.ndarray | None = None
    gt_vel: np.ndarray | None = None


def save_sequence(path: str, seq: SensorSequence) -> None:
    """Write ``seq`` to one compressed npz, in the JAX package's layout key
    for key (every array field, ``n_feature_frames``, and per feature frame
    ``ff{i}_t``, ``ff{i}_ids`` and ``ff{i}_uv`` = [u0 v0 u1 v1]), so files
    pass between the two packages both ways."""
    arrays = {k: v for k, v in vars(seq).items() if isinstance(v, np.ndarray)}
    arrays["n_feature_frames"] = np.asarray(len(seq.features))
    for i, f in enumerate(seq.features):
        arrays[f"ff{i}_t"] = np.asarray(f.t)
        arrays[f"ff{i}_ids"] = f.ids
        arrays[f"ff{i}_uv"] = np.stack([f.u0, f.v0, f.u1, f.v1], axis=-1)
    np.savez_compressed(path, **arrays)


def load_sequence(path: str) -> SensorSequence:
    """Read a sequence written by :func:`save_sequence` (either package's)."""
    z = np.load(path, allow_pickle=False)
    features = []
    for i in range(int(z["n_feature_frames"])):
        uv = z[f"ff{i}_uv"]
        features.append(FeatureFrame(
            t=float(z[f"ff{i}_t"]), ids=z[f"ff{i}_ids"],
            u0=uv[:, 0], v0=uv[:, 1], u1=uv[:, 2], v1=uv[:, 3],
        ))
    kwargs = {}
    for name in (
        "imu_t imu_acc imu_gyro pressure_t pressure_mbar dvl_pose_t "
        "dvl_pose_quat dvl_pose_pos dvl_twist_t dvl_twist_vel"
    ).split():
        kwargs[name] = z[name]
    for name in (
        "mavros_vel_t mavros_vel "
        "image_t images_left images_right gt_t gt_quat gt_pos gt_vel"
    ).split():
        kwargs[name] = z[name] if name in z.files else None
    return SensorSequence(features=features, **kwargs)
