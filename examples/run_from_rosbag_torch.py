"""Batch-solve a recorded ROS bag end-to-end with the PyTorch port
(``examples/run_from_rosbag.py`` on ``uslam_tpu_torch``) — the reference's
workflow (`rosbag play` + batch.py, reference README.md:46-52) without any
ROS installation.

Usage:
    python examples/run_from_rosbag_torch.py dive.bag [--plot traj.png] [--cpu]

The solve runs on the GPU. ``--cpu`` runs it on the CPU instead, and is the
only way there (without it and without a usable GPU the script raises); the
JAX example has no such flag, the port adds it for its CPU test.

Expects the reference's topics (override with --topic-* flags):
    /zedm/zed_node/imu/data           sensor_msgs/Imu
    /BlueROV/pressure2                std_msgs/String (JSON, press_abs mbar)
    /dvl/local_position               PoseWithCovarianceStamped
    /dvl/twist                        TwistStamped
    /auv/image_processor/features     stereo feature tracks (normalized)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bag")
    ap.add_argument("--plot", default=None, help="save a 3-D trajectory plot")
    ap.add_argument("--dot", default=None, help="export factor graph .dot")
    ap.add_argument("--topic-imu", default=None)
    ap.add_argument("--topic-pressure", default=None)
    ap.add_argument("--topic-dvl-pose", default=None)
    ap.add_argument("--topic-dvl-twist", default=None)
    ap.add_argument("--topic-features", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args()

    from uslam_tpu_torch.config import UslamConfig
    from uslam_tpu_torch.io.rosbag import BagTopics, bag_to_sequence
    from uslam_tpu_torch.pipeline import run_sequence

    topics = BagTopics()
    for name in ("imu", "pressure", "dvl_pose", "dvl_twist", "features"):
        v = getattr(args, f"topic_{name}")
        if v:
            topics = dataclasses.replace(topics, **{name: v})

    seq = bag_to_sequence(args.bag, topics=topics)
    print(
        f"bag: {len(seq.imu_t)} imu, {len(seq.pressure_t)} pressure, "
        f"{len(seq.dvl_pose_t)} dvl poses, {len(seq.dvl_twist_t)} twists, "
        f"{len(seq.features)} feature frames"
    )
    result = run_sequence(seq, UslamConfig(), device="cpu" if args.cpu else "cuda")
    print({k: v for k, v in result.metrics.items() if not k.startswith("_")})

    if args.plot:
        from uslam_tpu_torch.eval.plot import plot_trajectory_3d

        if plot_trajectory_3d(result.trajectory, result.odom_compare, save_path=args.plot) is None:
            print(f"matplotlib is not installed: {args.plot} not written")
        else:
            print(f"wrote {args.plot}")
    if args.dot:
        from uslam_tpu_torch.eval.graphviz import save_graph_dot

        save_graph_dot(
            args.dot, result.graph, result.values.num_poses, result.values.num_landmarks
        )
        print(f"wrote {args.dot}")


if __name__ == "__main__":
    main()
