"""Time the port's two bag readers on a sensor bag of a whole dive.

``uslam_tpu_torch.io.rosbag.bag_to_sequence`` reads a bag through the C++
record scanner (``use_native=True``, the default) or through the Python
reader (``use_native=False``). This script writes one seeded sensor bag
of ``--minutes`` of recording at the reference's rates (IMU 200 Hz, the
DVL pose 10 Hz, the DVL twist and the pressure 10 Hz; SURVEY.md L0/L2),
with the reference's message types, once per compression, and reads it
back with each reader ``--reps`` times. It checks that both readers give
array-equal streams and prints each read's wall time, host only: no
device is involved. Where ``nvidia-smi`` is found, the card's name and
power limit head the output, to name the machine.

    PYTHONPATH=. python tools/bag_reader_scale.py [--minutes 60] [--reps 2]

The serializers are ``chip_smoke.py``'s. ``lz4`` is left out: the port's
LZ4 compressor is a per-byte Python loop, minutes for a dive's bag.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import SEQ_ARRAYS, sensor_messages  # noqa: E402
from uslam_tpu_torch.io import rosbag  # noqa: E402

RATES_HZ = {"imu": 200.0, "dvl_pose": 10.0, "dvl_twist": 10.0, "pressure": 10.0}
T0 = 1_700_000_000.0


def dive_streams(minutes: float, seed: int) -> SimpleNamespace:
    """Seeded sensor streams of ``minutes`` of recording."""
    rng = np.random.default_rng(seed)
    dur = 60.0 * minutes

    def stamps(rate):
        n = int(dur * rate)
        return T0 + np.arange(n) / rate + rng.uniform(0.0, 1e-3, n)

    s = SimpleNamespace()
    s.imu_t = stamps(RATES_HZ["imu"])
    s.imu_acc = rng.normal(0.0, 1.0, (len(s.imu_t), 3)) + [0.0, 0.0, 9.81]
    s.imu_gyro = rng.normal(0.0, 0.05, (len(s.imu_t), 3))
    s.pressure_t = stamps(RATES_HZ["pressure"])
    s.pressure_mbar = 1013.25 + rng.uniform(0.0, 500.0, len(s.pressure_t))
    s.dvl_pose_t = stamps(RATES_HZ["dvl_pose"])
    q = rng.normal(size=(len(s.dvl_pose_t), 4))
    s.dvl_pose_quat = q / np.linalg.norm(q, axis=1, keepdims=True)
    s.dvl_pose_pos = rng.normal(0.0, 20.0, (len(s.dvl_pose_t), 3))
    s.dvl_twist_t = stamps(RATES_HZ["dvl_twist"])
    s.dvl_twist_vel = rng.normal(0.0, 0.3, (len(s.dvl_twist_t), 3))
    return s


def streams_equal(a, b) -> bool:
    for name in SEQ_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
            return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=60.0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compression", nargs="+", default=["none", "bz2"])
    args = ap.parse_args()

    if shutil.which("nvidia-smi"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    streams = dive_streams(args.minutes, args.seed)
    msgs = sorted(sensor_messages(streams, rosbag.BagTopics()), key=lambda m: m[3])
    print(f"{len(msgs)} messages ({len(streams.imu_t)} IMU) over {args.minutes} min, "
          f"serialized in {time.perf_counter() - t0!r} s", flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for comp in args.compression:
            path = os.path.join(tmp, f"dive_{comp}.bag")
            t0 = time.perf_counter()
            rosbag.write_bag(path, msgs, compression=comp)
            size = os.path.getsize(path)
            print(f"{comp}: {size} bytes written in {time.perf_counter() - t0!r} s", flush=True)
            seqs = {}
            for rep in range(args.reps):
                for label, native in (("C++ scanner", True), ("Python reader", False)):
                    t0 = time.perf_counter()
                    seqs[label] = rosbag.bag_to_sequence(path, use_native=native)
                    dt = time.perf_counter() - t0
                    print(f"  {comp}, {label}, read {rep + 1}: {dt!r} s, {len(msgs) / dt!r} "
                          f"messages/s, {size / dt / 1e6!r} MB/s", flush=True)
            same = streams_equal(*seqs.values()) and len(seqs["C++ scanner"].imu_t) == len(
                streams.imu_t)
            print(f"  {comp}: readers array-equal: {same}", flush=True)
            ok &= same
            os.remove(path)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
