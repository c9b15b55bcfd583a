"""Stereo image directory loading (the JAX package's ``uslam_tpu.io.images``).

The reference replays compressed ROS image topics through two
``image_transport republish`` nodes to feed the nodelet raw frames
(launch/stereo.launch:24-26). Offline, the equivalent is decoding image
files from disk into the ``SensorSequence`` image arrays: ``.npy`` frames
with numpy, any other format with OpenCV, which a machine may lack.
"""

from __future__ import annotations

import os
import re

import numpy as np


def _decode(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        img = np.load(path)
    else:
        try:
            import cv2

            img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            if img is None:
                raise ValueError(f"cv2 failed to decode {path}")
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                f"cannot decode {ext} without OpenCV; provide .npy frames"
            ) from e
    if img.ndim == 3:
        img = img.mean(axis=-1)
    return img.astype(np.float32)


def _stamp_from_name(name: str) -> float | None:
    """Parse a timestamp from a filename like 1678901234.567.png or
    000123.png (frame index)."""
    stem = os.path.splitext(os.path.basename(name))[0]
    m = re.search(r"(\d+(?:\.\d+)?)", stem)
    return float(m.group(1)) if m else None


def load_stereo_image_dirs(
    left_dir: str,
    right_dir: str,
    rate_hz: float | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load matching sorted frames from two directories.

    Returns (t (T,), left (T, H, W), right (T, H, W)). Timestamps come from
    filenames when parseable, else from ``rate_hz`` (frame index / rate).
    """
    lf = sorted(
        f for f in os.listdir(left_dir) if not f.startswith(".")
    )
    rf = sorted(
        f for f in os.listdir(right_dir) if not f.startswith(".")
    )
    n = min(len(lf), len(rf))
    if n == 0:
        raise ValueError("no frames found")
    lf, rf = lf[:n], rf[:n]
    left = np.stack([_decode(os.path.join(left_dir, f)) for f in lf])
    right = np.stack([_decode(os.path.join(right_dir, f)) for f in rf])
    stamps = [_stamp_from_name(f) for f in lf]
    usable = all(s is not None for s in stamps) and len(set(stamps)) == n
    if usable:
        arr = np.asarray(stamps, np.float64)
        # Consecutive-integer names are frame INDICES, not timestamps.
        if np.array_equal(arr, np.arange(arr[0], arr[0] + n)):
            usable = False
    if usable:
        t = np.asarray(stamps, np.float64)
    else:
        rate = rate_hz or 5.0
        t = np.arange(n, dtype=np.float64) / rate
    return t, left, right
