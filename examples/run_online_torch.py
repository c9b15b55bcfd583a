"""Online (streaming) SLAM demo of the PyTorch port
(``examples/run_online.py`` on ``uslam_tpu_torch``) — the working version
of the reference's isam.py (reference README.md:41 admits it "does not
currently work").

Generates a synthetic dive with rendered stereo imagery, then replays it
through OnlineSlam exactly as live sensors would arrive: IMU at 200 Hz,
pressure, DVL pose/twist, and stereo frames at 5 Hz. Each synchronized
frame triggers ORB extraction + fixed-lag smoothing and yields the current
pose estimate. Runs on the GPU; ``--cpu`` runs on the CPU instead, and is
the only way there (without it and without a usable GPU the script raises).

Usage: python examples/run_online_torch.py [--duration 12] [--window 10] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--duration", type=float, default=12.0)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument(
        "--device-resident", action="store_true",
        help="keep the steady-state window on the device (one record upload "
        "and one fetch per keyframe, no host read in between)",
    )
    ap.add_argument(
        "--fused", action="store_true",
        help="fuse the front-end INTO the steady-state device step "
        "(ORB + matching + id interning + triangulation + window solve "
        "as replayed CUDA graphs per keyframe)",
    )
    args = ap.parse_args()

    import numpy as np

    from uslam_tpu_torch import OnlineSlam
    from uslam_tpu_torch.config import UslamConfig
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence

    seq = generate_synthetic_sequence(
        SyntheticSpec(duration=args.duration, odom_drift_rate=0.03, seed=3),
        render_images=True,
        omit_features=True,
    )
    online = OnlineSlam(
        UslamConfig(), window=args.window,
        device_resident=args.device_resident, fused=args.fused,
        device="cpu" if args.cpu else "cuda",
    )

    # Interleave every stream by timestamp — a live driver loop.
    events = (
        [("imu", t, i) for i, t in enumerate(seq.imu_t)]
        + [("press", t, i) for i, t in enumerate(seq.pressure_t)]
        + [("pose", t, i) for i, t in enumerate(seq.dvl_pose_t)]
        + [("twist", t, i) for i, t in enumerate(seq.dvl_twist_t)]
        + [("frame", t, i) for i, t in enumerate(seq.image_t)]
    )
    events.sort(key=lambda e: e[1])

    lat_ms: list[float] = []
    t_start = time.perf_counter()
    for kind, t, i in events:
        if kind == "imu":
            online.add_imu(t, seq.imu_acc[i], seq.imu_gyro[i])
        elif kind == "press":
            online.add_pressure(t, seq.pressure_mbar[i])
        elif kind == "pose":
            online.add_dvl_pose(t, seq.dvl_pose_quat[i], seq.dvl_pose_pos[i])
        elif kind == "twist":
            online.add_dvl_twist(t, seq.dvl_twist_vel[i])
        else:
            t0 = time.perf_counter()
            values = online.add_stereo_frame(t, seq.images_left[i], seq.images_right[i])
            if values is not None:
                # The host path returns the window on the solve's device,
                # the device-resident one as fetched numpy arrays.
                last = values.pose_trans[-1]
                pos = last.cpu().numpy() if hasattr(last, "cpu") else np.asarray(last)
                ms = (time.perf_counter() - t0) * 1e3
                lat_ms.append(ms)
                print(
                    f"t={t:6.2f}s keyframe {online.keyframes:3d} "
                    f"pos=({pos[0]:+.2f}, {pos[1]:+.2f}, {pos[2]:+.2f}) "
                    f"[{ms:.0f} ms]"
                )
    wall = time.perf_counter() - t_start

    traj = online.trajectory()
    if seq.gt_pos is not None and len(traj):
        from uslam_tpu_torch.eval.metrics import ate_rmse

        n = min(len(traj), len(seq.gt_pos))
        print(f"ATE vs ground truth: {ate_rmse(traj[:n], seq.gt_pos[:n]):.3f} m")
    if len(lat_ms) > 4:
        tail = np.sort(np.array(lat_ms[len(lat_ms) // 2 :]))
        print(
            f"steady-state keyframe latency: median "
            f"{tail[len(tail) // 2]:.0f} ms, p90 {tail[int(len(tail) * 0.9)]:.0f} ms"
        )
    print(f"{online.keyframes} keyframes in {wall:.1f}s wall "
          f"({args.duration / max(wall, 1e-9):.2f}x realtime incl. graph captures)")


if __name__ == "__main__":
    main()
