"""Command line of the port: ``python -m uslam_tpu_torch <cmd>`` (the JAX
package's ``python -m uslam_tpu``, flag for flag).

    python -m uslam_tpu_torch run dive.bag --plot traj.png
    python -m uslam_tpu_torch run seq.npz --config cfg.json --polish
    python -m uslam_tpu_torch synth --duration 60 --out seq.npz
    python -m uslam_tpu_torch info dive.bag

``run`` solves on the GPU; ``--cpu`` runs it on the CPU instead, and is the
only way there. Without ``--cpu`` and without a usable GPU it fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _load_sequence(path: str):
    if path.endswith(".bag"):
        from uslam_tpu_torch.io.rosbag import bag_to_sequence

        return bag_to_sequence(path)
    from uslam_tpu_torch.io.sequence import load_sequence

    return load_sequence(path)


def cmd_run(args) -> int:
    from uslam_tpu_torch.config import UslamConfig
    from uslam_tpu_torch.pipeline import run_sequence

    if args.config:
        if args.config.endswith((".yaml", ".yml")):
            cfg = UslamConfig.from_yaml(args.config)
        else:
            cfg = UslamConfig.from_json(args.config)
    else:
        cfg = UslamConfig()
    updates = {}
    if args.banded:
        # band_width 0: measured off the packed graph.
        updates.update(reduced_solver="banded", band_width=0)
    if args.polish:
        updates.update(f64_polish=True)
    if updates:
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, **updates))
    seq = _load_sequence(args.sequence)
    result = run_sequence(
        seq, cfg, device="cpu" if args.cpu else "cuda", with_landmarks=not args.no_landmarks
    )
    print(json.dumps(dict(result.metrics), default=float, indent=2))

    if args.plot:
        from uslam_tpu_torch.eval.plot import plot_trajectory_3d

        if plot_trajectory_3d(result.trajectory, result.odom_compare, save_path=args.plot) is None:
            print(f"--plot: matplotlib is not installed; {args.plot} not written", file=sys.stderr)
    if args.dot:
        from uslam_tpu_torch.eval.graphviz import save_graph_dot

        save_graph_dot(
            args.dot, result.graph, result.values.num_poses, result.values.num_landmarks
        )
    if args.save_values:
        from uslam_tpu_torch.utils.checkpoint import save_state

        save_state(args.save_values, result.values)
    return 0


def cmd_synth(args) -> int:
    from uslam_tpu_torch.io.sequence import save_sequence
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence

    spec = SyntheticSpec(
        duration=args.duration,
        trajectory=args.trajectory,
        num_landmarks=args.landmarks,
        odom_drift_rate=args.drift,
        feature_noise_px=args.noise,
        seed=args.seed,
    )
    seq = generate_synthetic_sequence(
        spec, render_images=args.images, omit_features=args.images
    )
    save_sequence(args.out, seq)
    print(f"wrote {args.out}: {len(seq.dvl_pose_t)} keyframes, {len(seq.imu_t)} imu samples")
    return 0


def cmd_info(args) -> int:
    if args.sequence.endswith(".bag"):
        from collections import Counter

        from uslam_tpu_torch.io.rosbag import read_bag

        counts: Counter = Counter()
        types: dict[str, str] = {}
        t0, t1 = None, None
        for m in read_bag(args.sequence):
            counts[m.topic] += 1
            types[m.topic] = m.type
            t0 = m.t if t0 is None else min(t0, m.t)
            t1 = m.t if t1 is None else max(t1, m.t)
        dur = (t1 - t0) if counts else 0.0
        print(f"{args.sequence}: {sum(counts.values())} messages, {dur:.1f}s")
        for topic in sorted(counts):
            print(f"  {topic:45s} {types[topic]:45s} {counts[topic]:7d}")
    else:
        seq = _load_sequence(args.sequence)
        for name in ("imu_t", "pressure_t", "dvl_pose_t", "dvl_twist_t"):
            print(f"  {name:12s} {len(getattr(seq, name))} msgs")
        print(f"  features     {len(seq.features)} frames")
        if seq.images_left is not None:
            print(f"  images       {seq.images_left.shape}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="uslam_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="batch-solve a sequence (.npz or .bag)")
    p.add_argument("sequence")
    p.add_argument(
        "--config", default=None, help="UslamConfig JSON or YAML (.yaml/.yml)"
    )
    p.add_argument("--plot", default=None)
    p.add_argument("--dot", default=None)
    p.add_argument("--save-values", default=None, help="npz checkpoint of the solution")
    p.add_argument("--no-landmarks", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    p.add_argument(
        "--banded", action="store_true",
        help="banded large-N reduced solver (bounded-track-span missions; "
        "band width measured from the packed graph)",
    )
    p.add_argument(
        "--polish", action="store_true",
        help="float64 polish after the solve, on the solve's device (offline quality runs)",
    )
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("synth", help="generate a synthetic sequence npz")
    p.add_argument("--out", default="synthetic.npz")
    p.add_argument("--duration", type=float, default=60.0)
    p.add_argument(
        "--trajectory", choices=["orbit", "survey"], default="orbit",
        help="orbit: looping circle (loop closures); survey: sinusoidal "
        "transect (bounded track span, the banded-solver regime)",
    )
    p.add_argument("--landmarks", type=int, default=256)
    p.add_argument("--drift", type=float, default=0.02)
    p.add_argument("--noise", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--images", action="store_true", help="render stereo imagery")
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("info", help="summarize a sequence or bag")
    p.add_argument("sequence")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
