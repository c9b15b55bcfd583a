"""End-to-end demo of the PyTorch port: synthetic AUV sequence -> SLAM ->
plots + exports (``examples/run_synthetic.py`` on ``uslam_tpu_torch``).

Run:  python examples/run_synthetic_torch.py [--images] [--duration 60] [--cpu]

The solve runs on the GPU; ``--cpu`` runs it on the CPU instead, and is the
only way there (without it and without a usable GPU the script raises).
With --images the demo renders stereo imagery and runs the in-framework
ORB front-end instead of using the generator's perfect feature tracks —
the complete replacement for the reference's
roslaunch-stereo.launch + python3 batch.py workflow (reference
README.md "Usage").
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--images", action="store_true", help="run the ORB front-end")
    ap.add_argument("--out", default="/tmp/uslam_demo")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    from uslam_tpu_torch.config import CameraConfig, FrontendConfig, UslamConfig
    from uslam_tpu_torch.eval.graphviz import save_graph_dot
    from uslam_tpu_torch.eval.plot import plot_trajectory_3d
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.pipeline import run_sequence

    os.makedirs(args.out, exist_ok=True)

    if args.images:
        cam = CameraConfig(
            fx=300.0, fy=300.0, cx=192.0, cy=120.0, baseline=0.12,
            resolution_x=384, resolution_y=240,
        )
        cfg = UslamConfig(camera=cam, frontend=FrontendConfig(pyramid_levels=1))
        seq = generate_synthetic_sequence(
            SyntheticSpec(duration=args.duration, num_landmarks=150,
                          odom_drift_rate=0.03, max_feature_depth=12.0),
            cam_cfg=cam, render_images=True, omit_features=True,
        )
    else:
        cfg = UslamConfig()
        seq = generate_synthetic_sequence(
            SyntheticSpec(duration=args.duration, odom_drift_rate=0.05,
                          feature_noise_px=0.3)
        )

    result = run_sequence(seq, cfg, device=device)
    print("metrics:")
    for k, v in result.metrics.items():
        print(f"  {k}: {v}")

    # Pose uncertainty at the start/middle/end of the dive (gtsam.Marginals
    # parity — float64 recovery on the solve's device, solvers/marginals.py).
    from uslam_tpu_torch.pipeline import compute_marginals
    from uslam_tpu_torch.solvers.marginals import marginal_sigmas

    n = result.values.num_poses
    picks = (0, n // 2, n - 1)
    marg = compute_marginals(result, cfg, pose_indices=picks)
    sig = marginal_sigmas(marg.pose)
    print("pose 1-sigma [rot(rad) | trans(m)]:")
    for i, s in zip(picks, sig):
        print(
            f"  pose {i:4d}: rot ({s[0]:.4f}, {s[1]:.4f}, {s[2]:.4f})  "
            f"trans ({s[3]:.4f}, {s[4]:.4f}, {s[5]:.4f})"
        )

    fig = plot_trajectory_3d(
        result.trajectory, result.odom_compare,
        save_path=os.path.join(args.out, "trajectory.png"),
    )
    save_graph_dot(
        os.path.join(args.out, "graph.dot"),
        result.graph, result.values.num_poses, result.values.num_landmarks,
    )
    if fig is None:
        print(f"matplotlib is not installed: wrote {args.out}/graph.dot, no trajectory.png")
    else:
        print(f"wrote {args.out}/trajectory.png and graph.dot")


if __name__ == "__main__":
    main()
