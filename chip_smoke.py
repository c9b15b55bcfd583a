#!/usr/bin/env python3
"""Build and drive the PyTorch port (``uslam_tpu_torch``) once on one
NVIDIA GPU, and check what comes out.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. device: CUDA must be available; prints the card's name and power limit.
2. build: nvcc builds the hand-written kernels from ``uslam_tpu_torch/csrc``,
   g++ the C++ bag scanner from ``uslam_tpu_torch/native``.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (FAST+Harris on 16 images at each of
   the three pyramid levels of 1920x1080, bit-identical on the interior,
   plus ragged and batch shapes; Hamming on the 16 frame matrices of 48x48
   one chunk launches at once, exact), then each one's time: N launches
   back to back between one pair of CUDA events, divided by N, after a
   warm-up, with the device kept busy while the host enqueues them
   (FAST+Harris: the 50 MB L2 flushed before every launch, as the time of
   N flush+kernel pairs less that of N flushes), beside its bound (the
   larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s). The
   same at the online path's per-keyframe shapes: FAST+Harris on one
   stereo pair at each level, Hamming on its 2 matrices of 48x48. Then a
   torch.profiler breakdown of one front-end chunk's device time.
4. slice: ``run_sequence`` with the default ``UslamConfig()`` (Schur +
   velocity elimination) on a rendered 20 s synthetic dive (100 stereo
   keyframes at 1920x1080, 200 landmarks, 200 Hz IMU); checks the launch
   counts of both kernels (fast_harris once per level per chunk, hamming
   once per chunk), the LM's error decrease, and the trajectory error
   against ground truth and the DVL odometry; then where one LM iteration
   goes (host clock per stage, torch.profiler device time of the solve).
5. Schur vs dense, on the features phase 4 left in the sequence (no front
   end): at the slice's solution, the Schur step against the dense step
   in float64 and from the float32 linearization, and both steps repeated
   bit for bit; the default solve run again, ending bit-identical; the
   dense linear solver to convergence, whose final error the Schur LM's
   must come within ``SCHUR_VS_DENSE_ERROR`` of.
6. offline tail: the float64 polish and float64 marginals (three poses,
   three landmarks, the bias, one joint covariance) from the slice's
   result, on the card.
7. 1k: bench.py's 1000-pose precomputed-feature solve with the default
   solver and the polish (at most 2 iterations, as bench.py runs it, then
   the default 12); its ATEs against ground truth and the DVL odometry,
   and its LM-iteration profile.
8. online: the first ``ONLINE_SECONDS`` of phase 3's dive (uint8 frames)
   streamed message by message through ``OnlineSlam(UslamConfig(),
   window=10, solve_during_fill=False)`` three times: (a) the host
   smoother with the per-frame front end, (b) ``pipelined=True`` (fused
   front end and window step on the device), (c) ``device_resident=True``.
   Checks 3 fast_harris and 1 hamming launches per keyframe on each pass,
   equal keyframe counts, no pending keyframe after ``flush()``, each
   ATE within ``ONLINE_ATE_VS_ODOM`` of the DVL odometry's and (b) within
   ``ONLINE_DIVERGENCE_M`` of (a); prints per-keyframe host ms (median,
   p90) of the steady keyframes, the timing split, LM iterations, one
   steady keyframe under torch.profiler, and the window's landmarks by
   observation count.
9. survey: bench.py's scaling sweep (bench.py:517-628) on the banded
   solver: a survey trajectory of 2000, then 4000 poses (precomputed
   features, packed by the port), ``reduced_solver="banded"`` with band
   width and correction window measured off the graph, bench.py's 1k
   ``SolverConfig``; prints the band, the LM, ATEs (observability-limited,
   as bench.py marks them), per-iteration host ms, peak device memory, the
   2-iteration banded float64 polish and ``cost_vs_f64_opt`` (final error /
   polished error), which must be <= ``COST_VS_F64_OPT`` (bench.py's alert,
   bench.py:700). At 2000 poses one banded step is held to the Schur step
   (float64 both) with each one's peak memory, and on a short long-track
   survey (band_w ~ N, chunk window F < 2 band_w) too. At each size the
   per-frame sum of the band assembly (``bands.frame_sum``) must make no
   host sync and repeat bit-identically.
10. KLT: ``run_sequence`` with ``FrontendConfig(temporal_tracker="klt")`` on
   the first ``ONLINE_SECONDS`` of phase 3's dive (21 keyframes), beside the
   ORB front end on the same frames: launch counts (3 fast_harris and 1
   hamming per frame under KLT), landmarks observed in >= 2 keyframes, and
   ATE within ``ONLINE_ATE_VS_ODOM`` of the DVL odometry's. ``klt_track``
   on the card is held to the CPU on the clip's first two frames and on a
   copy shifted by a known sub-pixel offset, which it must recover.
11. ingest and the command line: (a) the first ``ONLINE_SECONDS`` of the
   dive (uint8 frames, stamps on the nanosecond grid) written as a
   reference-style ROS bag (``sensor_msgs/Imu``, pressure JSON in
   ``std_msgs/String``, ``PoseWithCovarianceStamped``, ``TwistStamped``
   and two ``mono8`` ``sensor_msgs/Image`` topics, bz2; the sensor topics
   alone again as lz4), read back (frames, arrays and stamps equal to the
   source), and run on the card beside the same clip in memory (features,
   launches and errors equal after ``INGEST_LM_ITERS`` LM iterations each,
   not converged); the C++ bag scanner against the Python reader on both
   bags, with their times; (b) ``python -m uslam_tpu_torch info`` on the
   bag and ``synth`` + ``info`` on an npz, as child processes; (c) a 20 Hz
   1080p KLT clip (``CLI_CLIP``, 40 keyframes) saved as npz and solved by
   ``run --config klt.json --polish --save-values --dot --plot`` through
   the command line's entry point in this process, its launch counts set
   to 0 just before: that run's launches (3 fast_harris and 1 hamming per
   frame), its solve on the card, error falling, ATE within
   ``ONLINE_ATE_VS_ODOM`` of the DVL odometry's, files written, values
   loaded onto the card, its KLT track lengths (ROADMAP C1, C4) and its
   track ids equal frame for frame to the port's front end on the CPU
   over the same npz; ORB's track lengths beside; (d)
   ``SolverConfig.debug_nans`` bit-identical on a clean 2 s solve
   (``INGEST_LM_ITERS`` LM iterations) and raising ``FloatingPointError``
   at ``linearize`` on a NaN IMU sample, and ``smooth_imu`` on the card
   equal to the CPU.

The last two lines of standard output are one JSON object with the kernel
records, then ``{"ok": true, "device": {...}}``. Imports nothing of JAX and
nothing of the JAX package ``uslam_tpu``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PLAIN_REPS = 5
KERNEL_REPS = 50
# The Schur step against the dense step of the same linearization: in
# float64, the Schur-vs-dense tolerance of tests/test_torch_schur.py; from a
# float32 linearization, that of tests/test_torch_single_obs.py (the step
# is returned in float32).
SCHUR_STEP_RTOL = 1e-7
SCHUR_F32_STEP_RTOL = 1e-6
# The Schur LM's final error may exceed the dense LM's by this factor at
# most: both stop on the float32 error floor, where the last accepted steps
# follow rounding (port/JAX final-error ratios of 0.82-1.17 over five seeds,
# tests/test_torch_slice.py).
SCHUR_VS_DENSE_ERROR = 1.5
HOST_AHEAD_CYCLES = 50_000_000  # ~28 ms of device spin while the host enqueues
FLUSH_BYTES = 96 << 20          # > the H100's 50 MB L2
# Card peaks the bounds use (NVIDIA's H100 SXM data sheet): HBM bytes/s and
# fp32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float operations per pixel of FAST+Harris: Sobel 15, vertical and
# horizontal 7-sums 36, det/trace/response 7, FAST thresholds 2 and
# compares 32.
FAST_HARRIS_OPS_PER_PX = 92
# The CUDA kernel keeps the plain version's order of float operations, so
# it must agree with it exactly (tolerance 0) on pixels at least BORDER px
# inside the border, where the versions differ (wrap vs clamp).
BORDER = 5
# Phase 8: the online stream's first seconds (5 keyframes per second), the
# window, and which steady keyframe goes under the profiler.
ONLINE_SECONDS = 4.0
ONLINE_WINDOW = 10
ONLINE_PROFILED_STEADY = 3
# Each pass's ATE may reach this multiple of the DVL odometry's on the same
# keyframes (tests/test_fixed_lag.py:133-134); the pipelined pass may
# diverge from the host pass by this much, the JAX package's bound between
# its fused and split paths (tests/test_online_fused.py:87).
ONLINE_ATE_VS_ODOM = 1.2
ONLINE_DIVERGENCE_M = 0.4
# Phase 9: bench.py's scaling sizes, its certificate's polish iterations
# and alert (bench.py:522,661,700), and the banded step's tolerance against
# the Schur step in float64 (tests/test_torch_banded.py).
SURVEY_POSES = (2000, 4000)
SURVEY_POLISH_ITERS = 2
COST_VS_F64_OPT = 1.05
BANDED_STEP_RTOL = 1e-7
# bands.frame_sum against an index_add_ of the same float64 values: both
# are sums of the same terms in another order.
FRAME_SUM_RTOL = 1e-12
# Phase 10: klt_track on the card against the CPU, the CPU-vs-JAX tolerance
# of tests/test_torch_klt.py (window sums reduced in another float32
# order); and the known sub-pixel offset (x, y) of the shifted copy, with
# the median error allowed against it.
KLT_CARD_VS_CPU_PX = 1e-3
KLT_SHIFT = (-2.3, 3.6)
KLT_SHIFT_PX = 0.05
# Phase 11: stamps survive a bag's secs/nsecs round trip to this many
# seconds; the run on the decoded bag ends within this relative error of
# the run on the same frames in memory. Both solves, and the debug_nans
# ones, stop after INGEST_LM_ITERS LM iterations, far from convergence
# (the 21-keyframe solve takes ~52 iterations and ~60 s on the card's
# host): they hold two runs of one input to each other, not to an
# optimum, and phase 5 shows a solve of one graph repeats bit for bit.
# Then the 20 Hz KLT clip for the command line, and the share of its KLT
# landmarks expected in >= 2 keyframes (ROADMAP C1; an ALERT below it,
# see C4; the check is that the card's tracks equal the CPU's);
# smooth_imu on the card against the CPU, relative to the largest value.
BAG_STAMP_S = 1e-9
INGEST_ERROR_RTOL = 1e-6
INGEST_LM_ITERS = 3
CLI_CLIP = dict(duration=2.0, keyframe_rate=20.0, odom_drift_rate=0.05)
KLT_MULTI_SHARE = 0.25
SMOOTH_IMU_RTOL = 1e-5
IMAGE_TOPICS = ("/zedm/zed_node/left/image_rect_color", "/zedm/zed_node/right/image_rect_color")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Device ms of one call of ``fn``: ``reps`` calls back to back between
    one pair of CUDA events, divided by ``reps``, after a warm-up call. A
    spin kernel first keeps the device busy while the host enqueues them,
    so host overhead between launches is not timed. With ``flush``: the
    time of ``reps`` (flush, fn) pairs less that of ``reps`` flushes."""
    import torch

    def run(body) -> float:
        body()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        start.record()
        for _ in range(reps):
            body()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    if flush is None:
        return run(fn)

    def both():
        flush()
        fn()

    return run(both) - run(flush)


def bound_ms(n_bytes: float, n_ops: float):
    """(bound in ms, what bounds it): the larger of the bytes over the HBM
    rate and the operations over the fp32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def textured_images(shape, seed: int):
    """Smoothed noise with bright and dark squares: corner-rich texture,
    made on the card from a seed."""
    import torch

    from uslam_tpu_torch.frontend.pyramid import box_blur

    b, h, w = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = box_blur(torch.rand(shape, generator=gen, device="cuda") * 255.0, 2)
    n_sq = max(1, h * w // 4000)
    ys = torch.randint(0, h - 12, (b, n_sq), generator=gen, device="cuda")
    xs = torch.randint(0, w - 12, (b, n_sq), generator=gen, device="cuda")
    val = torch.rand((b, n_sq), generator=gen, device="cuda") * 255.0
    ar = torch.arange(10, device="cuda")
    bi = torch.arange(b, device="cuda")[:, None, None, None]
    img[bi, (ys[..., None] + ar)[..., :, None], (xs[..., None] + ar)[..., None, :]] = val[
        ..., None, None
    ]
    return img.contiguous()


def check_fast_harris(batches) -> dict:
    """Kernel vs plain version on every batch: bool corners, and corners
    and Harris bit-identical on the interior."""
    import torch

    from uslam_tpu_torch.frontend import kernels

    worst_err = 0.0
    for label, imgs in batches:
        ck, hk = kernels.fast_harris(imgs, 10.0)
        cp, hp = kernels.fast_harris_plain(imgs, 10.0)
        torch.cuda.synchronize()
        inner = (slice(None), slice(BORDER, -BORDER), slice(BORDER, -BORDER))
        n_diff = int((ck[inner] != cp[inner]).sum())
        err = float((hk[inner] - hp[inner]).abs().max())
        n_corners = int(cp[inner].sum())
        log(f"  fast_harris {label} {tuple(imgs.shape)}: corners={n_corners} "
            f"dtype={ck.dtype} corner_mismatch={n_diff} harris_max_abs_err={err!r}")
        if ck.dtype != torch.bool or cp.dtype != torch.bool:
            raise AssertionError(f"fast_harris corners are {ck.dtype} / {cp.dtype}, not bool")
        if n_diff or err != 0.0:
            raise AssertionError(f"fast_harris disagrees with its plain version on {label}")
        worst_err = max(worst_err, err)
    return {"max_abs_err": worst_err}


def check_hamming(pairs) -> dict:
    """Kernel vs plain version; distances must agree exactly."""
    import torch

    from uslam_tpu_torch.frontend import kernels

    worst_err = 0
    for label, (da, db) in pairs:
        k = kernels.hamming(da, db)
        p = kernels.hamming_plain(da, db)
        torch.cuda.synchronize()
        err = int((k - p).abs().max())
        log(f"  hamming {label} {tuple(da.shape)} x {tuple(db.shape)}: "
            f"max_abs_err={err} mean_dist={float(p.float().mean())!r}")
        if err:
            raise AssertionError(f"hamming disagrees with its plain version on {label}")
        worst_err = max(worst_err, err)
    return {"max_abs_err": float(worst_err)}


def sass_loop_summary(lib_path: str, kernel: str = "fast_harris_kernel") -> str:
    """Static instruction count of ``kernel``'s longest loop in the built
    library (cuobjdump -sass), by opcode class: what the kernel issues per
    iteration, to hold against the card's issue rate."""
    import re
    from collections import Counter

    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    if not cuobjdump.exists():
        return "not measured (no cuobjdump)"
    sass = subprocess.run([str(cuobjdump), "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass) if kernel in f.split("\n", 1)[0])
    code = [(int(m.group(1), 16), m.group(2).strip())
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    loops = [(int(m.group(1), 16), off) for off, ins in code
             if (m := re.search(r"BRA\s.*?0x([0-9a-f]+)", ins)) and int(m.group(1), 16) < off]
    lo, hi = max(loops, key=lambda t: t[1] - t[0])
    ops = [re.sub(r"^@!?U?P[T0-9]\s+", "", ins).split()[0] for off, ins in code if lo <= off <= hi]
    classes = Counter(
        "fp32" if op.startswith(("FADD", "FMUL", "FFMA")) else
        "compare" if op.startswith("FSETP") else
        "move" if op.startswith(("MOV", "IMAD.MOV")) else
        "shared" if op.startswith(("LDS", "STS")) else
        "global" if op.startswith(("LDG", "STG")) else "integer/control"
        for op in ops
    )
    return f"{len(ops)} instructions in the loop body: {dict(classes)}"


def profile_chunk(seq, cfg, top: int = 8) -> None:
    """Where one front-end chunk's device time goes: torch.profiler over
    ``StereoFrontend.process_chunk`` on the second chunk of ``seq`` (the
    first one warms up), device time summed by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from uslam_tpu_torch.frontend.tracker import StereoFrontend

    c = cfg.frontend.offline_chunk
    fe = StereoFrontend(cfg.camera, cfg.frontend, device="cuda")
    chunks = [slice(0, c), slice(c, 2 * c)]
    args = [(seq.images_left[sl], seq.images_right[sl], seq.image_t[sl]) for sl in chunks]
    fe.process_chunk(*args[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fe.process_chunk(*args[1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels and copies), less the profiler's own
    # buffer requests; operator-level rows would count each kernel twice.
    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("Activity Buffer"):
            acc = per_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    device_ms = sum(ms for ms, _ in per_name.values())
    log(f"front-end chunk profile: wall {wall_ms!r} ms, device {device_ms!r} ms "
        f"(busy {device_ms / wall_ms!r})")
    for name, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {name[:70]}: {ms!r} ms device, {n} calls")


def _median_ms(fn, reps: int = 3):
    """(median host ms of ``reps`` synchronized calls of ``fn``, last output)."""
    import torch

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2], out


def profile_solve(result, cfg, label: str, top: int = 6) -> None:
    """Where one LM iteration of the default solver goes at ``result``'s
    solution: host clock around synchronized calls (median of 3) of each
    stage, then torch.profiler's device time of one whole ``solve_schur``
    summed by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from uslam_tpu_torch.device import cast_tree
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.solvers import bands, schur
    from uslam_tpu_torch.solvers.linearize import graph_error, linearize_graph

    g, v, sc = result.graph, result.values, cfg.solver
    n, n_lm = v.num_poses, v.num_landmarks
    cam = StereoCamera.from_config(cfg.camera, device="cuda")
    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    lam, jitter = sc.lambda_initial, sc.cholesky_jitter  # Marquardt with the lambda floor
    t_lin, lin = _median_ms(lambda: linearize_graph(g, v, cam, *sig))
    t_err, _ = _median_ms(lambda: graph_error(g, v, cam, *sig))
    # The stages as solve_schur runs them: in float64.
    t_cast, (lin64, st64) = _median_ms(lambda: (
        cast_tree(lin, torch.float64, "cuda"), cast_tree(g.stereo, torch.float64, "cuda")))
    t_elim, (_hi, g_l, U, V) = _median_ms(
        lambda: schur.landmark_elimination(lin64, st64, n, lam, True))
    t_bands, b = _median_ms(lambda: bands.assemble_cam_bands(lin64, st64, n, lam, True))
    t_corr, H_corr = _median_ms(lambda: U @ V.T)
    t_vel, _ = _median_ms(lambda: schur._solve_vel_eliminated(
        b, H_corr, U @ g_l.reshape(-1), n, sc.refine_iters, jitter))
    # The (6N+6) pose+bias principal block of the reduced camera matrix: SPD
    # and the size of the factorization velocity elimination leaves.
    S, _ = bands.expand_cam_dense(b, pp_extra=-H_corr)
    keep = torch.cat([torch.arange(6 * n), torch.arange(9 * n, 9 * n + 6)]).cuda()
    t_chol, (_L, info) = _median_ms(lambda: torch.linalg.cholesky_ex(S[keep][:, keep]))

    def solve():
        return schur.solve_schur(lin, g.stereo, n, n_lm, lam, refine_iters=sc.refine_iters,
                                 jitter=jitter, diag_damping=True, eliminate_velocities=True)

    t_solve, _ = _median_ms(solve)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("Activity Buffer"):
            acc = per_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    device_ms = sum(ms for ms, _ in per_name.values())
    log(f"{label} LM-iteration profile (N={n}, M={n_lm}, host ms, median of 3): "
        f"linearize {t_lin!r}, graph_error {t_err!r}, solve_schur {t_solve!r} = float64 cast "
        f"{t_cast!r} + landmark elimination {t_elim!r} + bands {t_bands!r} + U V^T "
        f"{t_corr!r} + velocity elimination and reduced solve {t_vel!r}; float64 Cholesky of "
        f"the {6 * n + 6} reduced block alone {t_chol!r} (info {int(info)})")
    log(f"  solve_schur device time {device_ms!r} ms in {sum(c for _, c in per_name.values())} "
        f"kernels (busy {device_ms / t_solve!r} of its host time); top:")
    for name, (ms, k) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"    {name[:70]}: {ms!r} ms, {k} calls")


def schur_witness(result, cfg) -> dict:
    """At the slice's solution, on the card: (a) the Schur step against the
    dense step over the whole tangent space, both in float64, at two
    lambdas; (b) the default path's step (``solve_schur`` given the float32
    linearization) against the float64 dense step of that linearization;
    (c) the float32 linearization and both solvers' steps, computed twice,
    are bit-identical."""
    import torch

    from uslam_tpu_torch.device import cast_tree
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.solvers import dense, schur
    from uslam_tpu_torch.solvers.linearize import linearize_graph

    g, v, sc = result.graph, result.values, cfg.solver
    n, n_lm = v.num_poses, v.num_landmarks
    args = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity,
            cfg.noise.stereo_huber_delta)
    kw = dict(refine_iters=sc.refine_iters, jitter=sc.cholesky_jitter, diag_damping=True)

    def steps(lin, stereo, lam):
        H, grad = dense.assemble_dense_with_landmarks(lin, stereo.cam_idx, stereo.lm_idx, n, n_lm)
        return (schur.solve_schur(lin, stereo, n, n_lm, lam, eliminate_velocities=True, **kw),
                dense.solve_dense_gn(H, grad, lam, **kw))

    def rel(a, b):
        return float(torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b))

    cam32 = StereoCamera.from_config(cfg.camera, device="cuda")
    g64, cam64 = cast_tree(g, torch.float64, "cuda"), cast_tree(cam32, torch.float64, "cuda")
    lin64 = linearize_graph(g64, cast_tree(v, torch.float64, "cuda"), cam64, *args)
    lin32 = linearize_graph(g, v, cam32, *args)
    lin32_as64 = cast_tree(lin32, torch.float64, "cuda")
    lams = (sc.lambda_initial, 1e-2)
    f64_rel, f32_rel = [], []
    for lam in lams:
        f64_rel.append(rel(*steps(lin64, g64.stereo, lam)))
        d_ref = steps(lin32_as64, g64.stereo, lam)[1]
        f32_rel.append(rel(steps(lin32, g.stereo, lam)[0], d_ref))
    again = linearize_graph(g, v, cam32, *args)
    first, second = steps(lin32, g.stereo, lams[0]), steps(again, g.stereo, lams[0])
    same = {
        "linearization": all(torch.equal(a, b) for a, b in zip(lin32, again)),
        "schur step": torch.equal(first[0], second[0]),
        "dense step": torch.equal(first[1], second[1]),
    }
    log(f"Schur vs dense step at the slice's solution (lambda {lams}, D = {9 * n + 6 + 3 * n_lm}): "
        f"float64 both, relative difference {f64_rel!r}; float32 linearization through "
        f"solve_schur vs the float64 dense step of it {f32_rel!r}; bit-identical when "
        f"repeated: {same}")
    return {
        f"Schur step = dense step in float64 (relative < {SCHUR_STEP_RTOL})":
        max(f64_rel) < SCHUR_STEP_RTOL,
        f"float32-input Schur step = float64 dense step (relative < {SCHUR_F32_STEP_RTOL})":
        max(f32_rel) < SCHUR_F32_STEP_RTOL,
        "linearization, Schur step and dense step bit-identical when repeated": all(same.values()),
    }


def _f64_block_ok(A) -> bool:
    """Finite, symmetric to 1e-9 relative, positive definite, float64 on the card."""
    import torch

    scale = float(A.abs().max())
    return bool(
        A.dtype == torch.float64 and A.device.type == "cuda"
        and bool(torch.isfinite(A).all())
        and float((A - A.transpose(-1, -2)).abs().max()) <= 1e-9 * scale
        and bool((torch.linalg.cholesky_ex(A)[1] == 0).all())
    )


def offline_tail(result, seq, cfg) -> dict:
    """The f64 polish and the marginals from the slice's result, on the card."""
    import numpy as np
    import torch

    from uslam_tpu_torch.eval.metrics import ate_rmse
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.pipeline import AUVSlam
    from uslam_tpu_torch.solvers.marginals import marginal_sigmas
    from uslam_tpu_torch.solvers.polish import polish_f64

    m = result.metrics
    n = m["num_poses"]
    gt = seq.gt_pos[:n]
    cam = StereoCamera.from_config(cfg.camera, device="cuda")
    t0 = time.perf_counter()
    vals, info = polish_f64(
        result.graph, result.values, cam, cfg.noise.dvl_sigma, cfg.noise.stereo_sigma,
        cfg.imu.gravity, cfg.solver, huber_delta=cfg.noise.stereo_huber_delta, device="cuda",
    )
    torch.cuda.synchronize()
    polish_s = time.perf_counter() - t0
    ate_pol = ate_rmse(vals.pose_trans.cpu().numpy(), gt)
    log(f"f64 polish on the card: {info['polish_iterations']} iterations in {polish_s!r} s, "
        f"error {info['polish_initial_error']!r} -> {info['polish_final_error']!r} "
        f"(f32 final {m['final_error']!r}); ATE {m['ate_rmse_vs_gt']!r} -> {ate_pol!r} m")

    slam = AUVSlam(cfg, device="cuda")
    s = result.graph.stereo
    lms = torch.unique(s.lm_idx[s.mask > 0]).tolist()[:3]
    poses = (0, n // 2, n - 1)
    t_marg, marg = _median_ms(lambda: slam.marginals(
        result, pose_indices=poses, landmark_indices=lms, include_bias=True), reps=1)
    keys = (("pose", 0), ("pose", n - 1), ("vel", n // 2), ("bias",), ("landmark", lms[0]))
    t_joint, joint = _median_ms(lambda: slam.joint_marginals(result, keys), reps=1)
    log(f"marginals on the card (float64): poses {poses}, landmarks {lms} and the bias in "
        f"{t_marg!r} ms; joint over {len(keys)} keys {tuple(joint.shape)} in {t_joint!r} ms")
    for i, sg in zip(poses, marginal_sigmas(marg.pose)):
        log(f"  pose {i} sigmas [rot, trans]: {np.array2string(sg, precision=5)}")
    log(f"  landmark sigmas: {np.array2string(marginal_sigmas(marg.landmark), precision=5)}")
    blocks = list(marg.pose) + list(marg.landmark) + [marg.bias, joint]
    return {
        "polish: polished error <= f32 final error": info["polish_final_error"] <= m["final_error"],
        "marginals: finite, symmetric, PD, float64 on cuda": all(_f64_block_ok(A) for A in blocks),
    }


def solve_1k() -> dict:
    """bench.py's 1k-pose batch solve (bench.py:279-306) with the default
    Schur + velocity-elimination solver, then the f64 polish."""
    import torch

    from uslam_tpu_torch.config import SolverConfig, UslamConfig
    from uslam_tpu_torch.eval.metrics import ate_rmse
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.pipeline import run_sequence
    from uslam_tpu_torch.solvers.polish import polish_f64

    t0 = time.perf_counter()
    seq = generate_synthetic_sequence(SyntheticSpec(
        duration=200.0, keyframe_rate=5.0, num_landmarks=512, omega=0.15,
        odom_drift_rate=0.02, feature_noise_px=0.3, seed=0,
    ))
    gen_s = time.perf_counter() - t0
    cfg = UslamConfig(solver=SolverConfig(
        max_iterations=50, plateau_patience=3, relative_error_tol=1e-5))
    initial = pack_sequence(seq, cfg)[1]
    t0 = time.perf_counter()
    r = run_sequence(seq, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = r.metrics
    n = m["num_poses"]
    gt = seq.gt_pos[:n]
    cam = StereoCamera.from_config(cfg.camera, device="cuda")

    def polish(max_iters):
        t0 = time.perf_counter()
        vals, info = polish_f64(r.graph, r.values, cam, cfg.noise.dvl_sigma,
                                cfg.noise.stereo_sigma, cfg.imu.gravity, cfg.solver,
                                max_iters=max_iters, device="cuda")
        torch.cuda.synchronize()
        return vals, info, time.perf_counter() - t0

    # bench.py's polish (BENCH_POLISH_ITERS=2, bench.py:720), for the
    # comparison with the JAX package's record, then the default 12.
    vals2, info2, polish2_s = polish(2)
    vals, info, polish_s = polish(12)
    ate_init = ate_rmse(initial.pose_trans, gt)
    ate_pol2 = ate_rmse(vals2.pose_trans.cpu().numpy(), gt)
    ate_pol = ate_rmse(vals.pose_trans.cpu().numpy(), gt)
    ate_odom = ate_rmse(r.odom_compare, gt)
    st = r.graph.stereo
    log(f"1k-pose solve (bench.py:279-306 spec; sequence made in {gen_s!r} s): N={n}, "
        f"landmark rows {m['num_landmarks']}, {int(st.mask.sum())} stereo observations, "
        f"reduced system {6 * n + 6}")
    log(f"  pack {m['pack_seconds']!r} s; solve {m['solve_seconds']!r} s, "
        f"{m['lm_iterations']} LM iterations; run_sequence wall {wall!r} s")
    log(f"  error {m['initial_error']!r} -> {m['final_error']!r}")
    log(f"  ATE vs ground truth: initial {ate_init!r} -> final {m['ate_rmse_vs_gt']!r}; "
        f"DVL odometry {ate_odom!r} m")
    for label, inf, sec, ate_p in (("bench.py's 2", info2, polish2_s, ate_pol2),
                                   ("the default 12", info, polish_s, ate_pol)):
        log(f"  polish, at most {label} iterations: {inf['polish_iterations']} in {sec!r} s, "
            f"error {inf['polish_initial_error']!r} -> {inf['polish_final_error']!r}, "
            f"ATE {ate_p!r} m")
    profile_solve(r, cfg, "1k")
    return {
        "1k: final_error < initial_error": m["final_error"] < m["initial_error"],
        "1k: final ATE below the initial ATE and the DVL odometry's":
        m["ate_rmse_vs_gt"] < ate_init and m["ate_rmse_vs_gt"] < ate_odom,
        "1k: polished error <= f32 final error": info["polish_final_error"]
        <= info2["polish_final_error"] <= m["final_error"],
    }


def online_events(seq, t_end: float) -> list:
    """Every sensor message of ``seq`` up to ``t_end``, in time order
    (tests/test_online_fused.py's stream): (kind, t, index)."""
    events = (
        [("imu", t, i) for i, t in enumerate(seq.imu_t)]
        + [("press", t, i) for i, t in enumerate(seq.pressure_t)]
        + [("pose", t, i) for i, t in enumerate(seq.dvl_pose_t)]
        + [("twist", t, i) for i, t in enumerate(seq.dvl_twist_t)]
        + [("frame", t, i) for i, t in enumerate(seq.image_t)]
    )
    events.sort(key=lambda e: e[1])
    return [e for e in events if e[1] <= t_end]


def profile_call(fn) -> dict:
    """One call of ``fn`` under torch.profiler, device activity only (a
    keyframe runs ~10^5 host ops, whose records alone take the profiler a
    minute to process): host wall ms with a synchronize, device ms, the
    count of device kernels and copies, and the profiler's whole cost in s."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and not e.name.startswith("Activity Buffer")]
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    device_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy": device_ms / wall_ms,
            "kernels": len(dev) - len(copies), "copies": len(copies),
            "profiler_s": time.perf_counter() - t_all}


def online_pass(label: str, cfg, seq, events, left, right, **mode) -> dict:
    """Stream ``events`` through ``OnlineSlam(cfg, window=ONLINE_WINDOW,
    solve_during_fill=False, device="cuda", **mode)`` with the kernels'
    launch counts set to 0 just before; host ms of every keyframe's
    ``add_stereo_frame``, one steady keyframe under the profiler."""
    import numpy as np
    import torch

    from uslam_tpu_torch.frontend import kernels
    from uslam_tpu_torch.online import OnlineSlam

    online = OnlineSlam(cfg, window=ONLINE_WINDOW, solve_during_fill=False, device="cuda", **mode)
    call_ms, profiled = {}, None
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for kind, t, i in events:
        if kind == "imu":
            online.add_imu(t, seq.imu_acc[i], seq.imu_gyro[i])
        elif kind == "press":
            online.add_pressure(t, seq.pressure_mbar[i])
        elif kind == "pose":
            online.add_dvl_pose(t, seq.dvl_pose_quat[i], seq.dvl_pose_pos[i])
        elif kind == "twist":
            online.add_dvl_twist(t, seq.dvl_twist_vel[i])
        elif online.keyframes == ONLINE_WINDOW + 1 + ONLINE_PROFILED_STEADY and profiled is None:
            profiled = profile_call(lambda: online.add_stereo_frame(t, left[i], right[i]))
        else:
            k, ts = online.keyframes, time.perf_counter()
            online.add_stereo_frame(t, left[i], right[i])
            if online.keyframes > k:
                call_ms[k] = (time.perf_counter() - ts) * 1e3
    online.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    traj = online.trajectory()
    n = len(traj)
    # Steady state: from the second marginalization on (keyframe
    # ONLINE_WINDOW + 1), where every mode runs its own steady step.
    steady = [ms for k, ms in call_ms.items() if k > ONLINE_WINDOW]
    timings = online.timings[ONLINE_WINDOW + 1:]
    keys = ("frontend_ms", "triangulate_ms", "graph_ms", "record_ms", "solve_ms", "fetch_ms",
            "pair_wait_ms", "dispatch_ms", "harvest_wait_ms", "harvest_ms")
    split = {k: float(np.median([e[k] for e in timings])) for k in keys
             if timings and all(k in e for e in timings)}
    iters = [e["lm_iters"] for e in timings if "lm_iters" in e]
    gt, odom = seq.gt_pos[:n], seq.dvl_pose_pos[:n]
    from uslam_tpu_torch.eval.metrics import ate_rmse

    out = {
        "label": label, "online": online, "traj": traj, "keyframes": online.keyframes,
        "launches": launches, "wall_s": wall, "steady": len(steady),
        "median_ms": float(np.median(steady)), "p90_ms": float(np.percentile(steady, 90)),
        "lm_iters": float(np.median(iters)) if iters else float("nan"),
        "ate": ate_rmse(traj, gt), "ate_odom": ate_rmse(odom, gt), "profiled": profiled,
    }
    log(f"online pass {label}: {out['keyframes']} keyframes ({out['steady']} steady, one more "
        f"profiled) in {wall!r} s = {out['keyframes'] / wall!r} keyframes/s; steady ms per "
        f"keyframe median {out['median_ms']!r}, p90 {out['p90_ms']!r}; launches {launches}")
    log(f"  steady split, medians (ms): {split}; LM iterations, median {out['lm_iters']!r} "
        f"(max {max(iters) if iters else None})")
    log(f"  ATE vs ground truth {out['ate']!r} m; DVL odometry {out['ate_odom']!r} m "
        f"(same {n} keyframes); host ms of every timed keyframe: "
        f"{[round(ms, 1) for ms in call_ms.values()]}")
    if profiled:
        log(f"  one steady keyframe under torch.profiler: host wall {profiled['wall_ms']!r} ms, "
            f"device {profiled['device_ms']!r} ms (busy {profiled['busy']!r}), "
            f"{profiled['kernels']} kernels, {profiled['copies']} copies (the profiled call took "
            f"{profiled['profiler_s']!r} s in all)")
    return out


def online_phase(seq, cfg) -> dict:
    """Phase 8: the first ONLINE_SECONDS of the phase-3 dive streamed
    through OnlineSlam on the card: (a) the host smoother with the
    per-frame front end, (b) pipelined (fused, device-resident), (c) the
    split device-resident path."""
    import numpy as np

    t_phase = time.perf_counter()
    events = online_events(seq, ONLINE_SECONDS)
    frames = sorted({i for kind, _, i in events if kind == "frame"})
    # uint8 frames, as a camera gives them.
    left = {i: np.clip(seq.images_left[i], 0, 255).astype(np.uint8) for i in frames}
    right = {i: np.clip(seq.images_right[i], 0, 255).astype(np.uint8) for i in frames}
    log(f"online stream: {ONLINE_SECONDS} s, {len(frames)} stereo frames "
        f"{left[frames[0]].shape} uint8, {len(events)} messages; window {ONLINE_WINDOW}, "
        f"solve_during_fill=False, max_update_iters=4")
    a = online_pass("(a) host smoother", cfg, seq, events, left, right)
    g, _ = a["online"].smoother._window_graph()
    per_lm = np.bincount(g.stereo.lm_obs_mask.sum(1).long().cpu().numpy())
    log(f"  (a)'s last window: landmarks by observation count "
        f"{dict((k, int(c)) for k, c in enumerate(per_lm) if k and c)}")
    b = online_pass("(b) pipelined", cfg, seq, events, left, right, pipelined=True)
    c = online_pass("(c) device-resident", cfg, seq, events, left, right, device_resident=True)
    passes = (a, b, c)
    div = {p["label"]: float(np.linalg.norm(p["traj"] - a["traj"], axis=1).max()) for p in (b, c)}
    log(f"  divergence from (a), max over keyframes (m): {div}")
    log(f"online phase: {time.perf_counter() - t_phase!r} s")
    checks = {}
    for p in passes:
        name = p["label"]
        checks[f"online {name}: fast_harris 3 and hamming 1 launches per keyframe"] = (
            p["launches"] == {"fast_harris": 3 * p["keyframes"], "hamming": p["keyframes"]})
        checks[f"online {name}: trajectory finite, one row per keyframe"] = (
            p["traj"].shape == (p["keyframes"], 3) and bool(np.isfinite(p["traj"]).all()))
        checks[f"online {name}: ATE <= {ONLINE_ATE_VS_ODOM} x the DVL odometry's"] = (
            p["ate"] <= ONLINE_ATE_VS_ODOM * p["ate_odom"])
        checks[f"online {name}: at least 8 steady keyframes"] = p["steady"] >= 8
    checks["online: keyframes equal across passes"] = len({p["keyframes"] for p in passes}) == 1
    checks["online (b): no pending keyframe after flush()"] = b["online"]._pending is None
    checks["online (b): fused steps ran"] = any(e.get("pipelined") for e in b["online"].timings)
    checks[f"online (b) within {ONLINE_DIVERGENCE_M} m of (a)"] = div[b["label"]] < ONLINE_DIVERGENCE_M
    return {"checks": checks, "launches": a["launches"], "passes": passes}


def _rel(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm(a.double() - b.double()) / torch.linalg.vector_norm(b.double()))


def _peak_mib(fn):
    """(fn's output, peak device MiB allocated while it ran)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**20


def banded_vs_schur(graph, values, cfg, label: str, corr_lm_chunk: int = 128) -> float:
    """One banded step against the Schur step of the same float64
    linearization and damping (lambda_initial, Marquardt), at the polish's
    rounding-level jitter 1e-12 and 2 refinements (tests/test_banded.py's
    identity); the difference at the LM's own jitter is printed beside it.
    Returns the relative difference at jitter 1e-12."""
    import torch

    from uslam_tpu_torch.device import cast_tree
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.solvers import banded, schur
    from uslam_tpu_torch.solvers.linearize import linearize_graph

    sc = cfg.solver
    n, n_lm = values.num_poses, values.num_landmarks
    g64 = cast_tree(graph, torch.float64, "cuda")
    cam64 = cast_tree(StereoCamera.from_config(cfg.camera, device="cuda"), torch.float64, "cuda")
    lin = linearize_graph(g64, cast_tree(values, torch.float64, "cuda"), cam64,
                          cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    bw = banded.measure_band_width(graph.stereo)
    cw = banded.measure_corr_window(graph.stereo, lm_chunk=corr_lm_chunk)
    lam = sc.lambda_initial
    out = {}
    for jitter, b_ref, s_ref in ((1e-12, 2, 2), (sc.cholesky_jitter, sc.banded_refine_iters,
                                                  sc.refine_iters)):
        d_b, peak_b = _peak_mib(lambda: banded.solve_schur_banded(
            lin, g64.stereo, n, n_lm, lam, band_w=bw, corr_window=cw, corr_lm_chunk=corr_lm_chunk,
            jitter=jitter, refine_iters=b_ref, diag_damping=True))
        d_s, peak_s = _peak_mib(lambda: schur.solve_schur(
            lin, g64.stereo, n, n_lm, lam, jitter=jitter, refine_iters=s_ref, diag_damping=True,
            eliminate_velocities=sc.eliminate_velocities))
        out[jitter] = _rel(d_b, d_s)
        log(f"{label}: banded vs Schur step (float64, lambda {lam}, jitter {jitter}, refinements "
            f"{b_ref} / {s_ref}; N={n}, band_w {bw}, window {cw} of {corr_lm_chunk}-landmark "
            f"chunks): relative difference {out[jitter]!r}; peak device MiB banded {peak_b!r}, "
            f"Schur {peak_s!r}")
        del d_b, d_s
    return out[1e-12]


def frame_sum_check(stereo, n: int, label: str) -> dict:
    """``bands.frame_sum`` as the band assembly calls it, at a graph's
    observations with (F, 42) float64 values, the stereo band's width: no
    host synchronization (the device-resident window step must make none),
    two calls bit-identical, and within FRAME_SUM_RTOL of an
    ``index_add_`` of the unmasked rows; its device time beside the chunked
    (N, 8192) one-hot GEMM over every row that it replaced."""
    import warnings

    import torch

    from uslam_tpu_torch.solvers.bands import frame_sum, observed_frames

    frames = stereo.cam_idx.long()
    kept = observed_frames(stereo.cam_idx, stereo.mask, n)
    gen = torch.Generator(device="cuda").manual_seed(3)
    vals = torch.randn((frames.numel(), 42), dtype=torch.float64, device="cuda", generator=gen)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            a = frame_sum(vals, kept, n)
            b = frame_sum(vals, kept, n)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # What the mode reports per synchronizing call (the mode also warns once
    # that it is a prototype, in words of its own).
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    ref = vals.new_zeros((n, 42)).index_add_(0, frames, vals * stereo.mask[:, None])
    rel = float((a - ref).abs().max() / ref.abs().max())
    rows = torch.arange(n, device="cuda")

    def onehot():
        out = vals.new_zeros((n, 42))
        for s in range(0, frames.numel(), 8192):
            hot = (frames[None, s : s + 8192] == rows[:, None]).to(vals.dtype)
            out = out + hot @ vals[s : s + 8192]
        return out

    ms, onehot_ms = cuda_ms(lambda: frame_sum(vals, kept, n), 10), cuda_ms(onehot, 10)
    log(f"  {label} frame_sum, {int(stereo.mask.sum())} of F={frames.numel()} observations onto "
        f"N={n} frames: {ms!r} ms (chunked one-hot GEMM over all F {onehot_ms!r} ms); host syncs "
        f"{len(syncs)} {syncs}; relative to index_add_ {rel!r}")
    return {
        f"{label}: frame_sum makes no host sync, repeats bit-identically, = index_add_": (
            not syncs and torch.equal(a, b) and rel < FRAME_SUM_RTOL),
    }


def survey_solve(n_poses: int) -> dict:
    """bench.py's scaling entry (bench.py:541-628) at ``n_poses`` on the card,
    then its float64 certificate (bench.py:630-700) by the banded polish."""
    import numpy as np
    import torch

    from uslam_tpu_torch.config import SolverConfig, UslamConfig
    from uslam_tpu_torch.eval.metrics import ate_rmse
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.interop import to_port
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.pipeline import AUVSlam, banded_solver_config
    from uslam_tpu_torch.solvers.banded import auto_panel, solve_schur_banded
    from uslam_tpu_torch.solvers.linearize import linearize_graph
    from uslam_tpu_torch.solvers.polish import polish_f64

    t0 = time.perf_counter()
    seq = generate_synthetic_sequence(SyntheticSpec(
        trajectory="survey", duration=n_poses / 5.0, keyframe_rate=5.0,
        num_landmarks=max(512, n_poses), omega=0.15, max_feature_depth=10.0,
        odom_drift_rate=0.02, feature_noise_px=0.3, seed=0,
    ))
    gen_s = time.perf_counter() - t0
    cfg = UslamConfig(solver=SolverConfig(
        max_iterations=50, plateau_patience=3, relative_error_tol=1e-5, reduced_solver="banded"))
    t0 = time.perf_counter()
    graph_np, initial_np, odom, _ = pack_sequence(seq, cfg)
    pack_s = time.perf_counter() - t0
    graph, initial = to_port(graph_np, "cuda"), to_port(initial_np, "cuda")
    slam = AUVSlam(cfg, device="cuda")
    slam._graph_cache = (graph, initial)
    slam.odom_compare = list(odom)
    base_mib = torch.cuda.memory_allocated() / 2**20
    r, peak_mib = _peak_mib(slam.solve)
    m = r.metrics
    n, bw, cw = m["num_poses"], m["band_width"], m["banded_corr_window"]
    gt = seq.gt_pos[:n]
    ate_init = ate_rmse(initial_np.pose_trans, gt)
    ate_final = ate_rmse(r.trajectory, gt)
    ate_odom = ate_rmse(r.odom_compare, gt)
    # One LM iteration's two stages at the solution, host ms (median of 3).
    cam = StereoCamera.from_config(cfg.camera, device="cuda")
    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    scfg = banded_solver_config(cfg.solver, graph)
    t_lin, lin = _median_ms(lambda: linearize_graph(graph, r.values, cam, *sig))
    t_solve, _ = _median_ms(lambda: solve_schur_banded(
        lin, graph.stereo, n, m["num_landmarks"], scfg.lambda_initial, band_w=bw,
        corr_window=cw, jitter=scfg.cholesky_jitter, refine_iters=scfg.banded_refine_iters,
        diag_damping=True))
    del lin
    t0 = time.perf_counter()
    vals_pol, info = polish_f64(graph, r.values, cam, *sig, scfg,
                                max_iters=SURVEY_POLISH_ITERS, device="cuda")
    torch.cuda.synchronize()
    polish_s = time.perf_counter() - t0
    ate_pol = ate_rmse(vals_pol.pose_trans.cpu().numpy(), gt)
    cost = m["final_error"] / max(info["polish_final_error"], 1e-30)
    errors = (m["initial_error"], m["final_error"], info["polish_initial_error"],
              info["polish_final_error"])
    log(f"survey {n_poses} (bench.py:541-552 spec; made in {gen_s!r} s, packed in {pack_s!r} s): "
        f"N={n} poses, M={m['num_landmarks']} landmark rows, {int(graph.stereo.mask.sum())} "
        f"stereo observations, band_w {bw}, correction window {cw}, panel {auto_panel(bw)}")
    log(f"  LM: {m['lm_iterations']} iterations, converged={m['converged']}, error "
        f"{m['initial_error']!r} -> {m['final_error']!r}; solve {m['solve_seconds']!r} s; "
        f"per iteration at the solution (host ms, median of 3): linearize {t_lin!r}, banded "
        f"solve {t_solve!r}")
    log(f"  peak device memory during the solve {peak_mib!r} MiB (graph and values before it: "
        f"{base_mib!r} MiB)")
    log(f"  ATE vs ground truth (observability-limited): initial {ate_init!r} -> final "
        f"{ate_final!r} m; DVL odometry {ate_odom!r} m")
    log(f"  banded float64 polish on the card, at most {SURVEY_POLISH_ITERS} iterations: "
        f"{info['polish_iterations']} in {polish_s!r} s, error {info['polish_initial_error']!r} "
        f"-> {info['polish_final_error']!r}, ATE {ate_pol!r} m; cost_vs_f64_opt {cost!r}")
    if ate_pol > ate_final:
        # VERDICT r5's open item: the JAX package's sweep let this pass
        # silently. The cost is flat along the survey's weak modes, so the
        # float64 optimum need not have the smaller ATE; reported, not failed.
        log(f"  ALERT survey {n_poses}: polished ATE {ate_pol!r} m > final ATE {ate_final!r} m "
            "(observability-limited)")
    out = {
        "n": n, "graph": graph, "values": r.values, "cfg": cfg, "cost": cost,
        "checks": {
            **frame_sum_check(graph.stereo, n, f"survey {n_poses}"),
            f"survey {n_poses}: cost_vs_f64_opt <= {COST_VS_F64_OPT}": cost <= COST_VS_F64_OPT,
            f"survey {n_poses}: LM and polish errors finite, final < initial":
            all(math.isfinite(e) for e in errors) and m["final_error"] < m["initial_error"],
            f"survey {n_poses}: trajectory finite": bool(np.isfinite(r.trajectory).all()),
        },
    }
    del vals_pol
    return out


def survey_phase() -> dict:
    """Phase 9: the survey sizes on the banded solver, the banded step held
    to the Schur step at the first size, and the long-track a0 graph."""
    import torch

    from uslam_tpu_torch.config import UslamConfig
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.interop import to_port
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.solvers.banded import measure_band_width, measure_corr_window

    t_phase = time.perf_counter()
    checks = {}
    for i, n_poses in enumerate(SURVEY_POSES):
        res = survey_solve(n_poses)
        checks.update(res["checks"])
        if i == 0:
            rel = banded_vs_schur(res["graph"], res["values"], res["cfg"], f"survey {n_poses}")
            checks[f"survey {n_poses}: banded step = Schur step (relative < {BANDED_STEP_RTOL})"] = (
                rel < BANDED_STEP_RTOL)
        del res
        torch.cuda.empty_cache()
    # A short survey seen to 15 m: every track spans nearly the whole run
    # (band_w ~ N), and 4-landmark chunks observe windows F < 2 band_w, where
    # the reference's diagonal shear once wrapped rows ("a0").
    cfg = UslamConfig()
    seq = generate_synthetic_sequence(SyntheticSpec(
        trajectory="survey", duration=6.0, num_landmarks=48, max_feature_depth=15.0, seed=1))
    g_np, v_np, _, _ = pack_sequence(seq, cfg)
    graph, values = to_port(g_np, "cuda"), to_port(v_np, "cuda")
    bw, cw = measure_band_width(graph.stereo), measure_corr_window(graph.stereo, lm_chunk=4)
    rel = banded_vs_schur(graph, values, cfg, "long-track survey", corr_lm_chunk=4)
    checks[f"long-track survey: band_w {bw} >= N-3 and window {cw} < 2 band_w (the a0 shape)"] = (
        bw >= values.num_poses - 3 and cw < 2 * bw)
    checks[f"long-track survey: banded step = Schur step (relative < {BANDED_STEP_RTOL})"] = (
        rel < BANDED_STEP_RTOL)
    log(f"survey phase: {time.perf_counter() - t_phase!r} s")
    return checks


def truncate_sequence(seq, t_end: float):
    """A copy of ``seq`` with every stream cut after ``t_end`` and no
    features (the front end makes them)."""
    import numpy as np

    def cut(t, *arrays):
        k = int(np.searchsorted(t, t_end, side="right"))
        return [a[:k] for a in (t, *arrays)]

    out = dataclasses.replace(seq, features=[])
    out.imu_t, out.imu_acc, out.imu_gyro = cut(seq.imu_t, seq.imu_acc, seq.imu_gyro)
    out.pressure_t, out.pressure_mbar = cut(seq.pressure_t, seq.pressure_mbar)
    out.dvl_pose_t, out.dvl_pose_quat, out.dvl_pose_pos = cut(
        seq.dvl_pose_t, seq.dvl_pose_quat, seq.dvl_pose_pos)
    out.dvl_twist_t, out.dvl_twist_vel = cut(seq.dvl_twist_t, seq.dvl_twist_vel)
    out.image_t, out.images_left, out.images_right = cut(
        seq.image_t, seq.images_left, seq.images_right)
    out.gt_t, out.gt_quat, out.gt_pos, out.gt_vel = cut(seq.gt_t, seq.gt_quat, seq.gt_pos, seq.gt_vel)
    return out


def track_lengths(frames) -> dict:
    """{track length in frames: number of track ids} over FeatureFrames."""
    import numpy as np

    ids = np.concatenate([f.ids for f in frames]) if frames else np.zeros(0, np.int64)
    per_id = np.bincount(ids)
    lengths = np.bincount(per_id[per_id > 0])
    return {k: int(c) for k, c in enumerate(lengths) if k and c}


def klt_card_check(clip, cfg) -> dict:
    """klt_track on the card against the port's CPU run on the same inputs,
    from the ORB keypoints of the clip's first left frame: to its second
    left frame, and to a copy of the first shifted by a known sub-pixel
    offset. Valid masks must be equal and points that converged on the CPU
    (30 iterations = 60) within KLT_CARD_VS_CPU_PX; on the shifted copy at
    least half the keypoints must track, with the median error against the
    known offset within KLT_SHIFT_PX."""
    import numpy as np
    import torch
    from scipy.ndimage import shift as nd_shift

    from uslam_tpu_torch.frontend.klt import klt_track
    from uslam_tpu_torch.frontend.orb import extract_orb_batch

    fcfg = cfg.frontend
    a = np.asarray(clip.images_left[0], np.float32)
    kp = extract_orb_batch(torch.from_numpy(a)[None].cuda(), fcfg)
    pts, mask = kp.xy[0], kp.mask[0]
    sx, sy = KLT_SHIFT
    targets = {
        "next frame": np.asarray(clip.images_left[1], np.float32),
        f"shifted ({sx}, {sy}) px": nd_shift(a, (sy, sx), order=1, mode="nearest"),
    }
    kw = dict(levels=fcfg.pyramid_levels, radius=fcfg.patch_size // 2)
    checks = {}
    for name, b in targets.items():
        args = [torch.from_numpy(a), torch.from_numpy(b), pts.cpu(), mask.cpu()]
        card, card_ok = klt_track(*(x.cuda() for x in args), **kw)
        cpu, cpu_ok = klt_track(*args, **kw)
        longer = klt_track(*args, iters=60, **kw)[0]
        card, card_ok = card.cpu(), card_ok.cpu()
        sel = cpu_ok & torch.all(longer == cpu, dim=1)
        err = float((card - cpu)[sel].abs().max()) if bool(sel.any()) else 0.0
        n_kp, n_ok = int(mask.sum()), int(cpu_ok.sum())
        line = (f"  klt_track card vs CPU, {name}: {n_ok} of {n_kp} keypoints tracked "
                f"(card {int(card_ok.sum())}), {int(sel.sum())} converged, max |card - CPU| "
                f"{err!r} px")
        checks[f"klt: card tracks = CPU's, {name}"] = bool(torch.equal(card_ok, cpu_ok)) and (
            err <= KLT_CARD_VS_CPU_PX)
        if name.startswith("shifted"):
            off = (card - pts.cpu() - torch.tensor([sx, sy]))[card_ok].norm(dim=1)
            med = float(off.median()) if n_ok else math.inf
            line += f"; median error vs the known offset {med!r} px"
            checks[f"klt: half the keypoints track a known shift within {KLT_SHIFT_PX} px"] = (
                2 * n_ok >= n_kp > 0 and med <= KLT_SHIFT_PX)
        log(line)
    return checks


def klt_phase(seq, cfg) -> dict:
    """Phase 10: run_sequence with the KLT temporal tracker on the first
    ONLINE_SECONDS of the dive, beside the ORB front end on the same frames."""
    import numpy as np

    from uslam_tpu_torch.eval.metrics import ate_rmse
    from uslam_tpu_torch.frontend import kernels
    from uslam_tpu_torch.frontend.tracker import StereoFrontend
    from uslam_tpu_torch.pipeline import run_sequence

    t_phase = time.perf_counter()
    cfg_klt = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, temporal_tracker="klt"))
    runs = {}
    for name, c in (("orb", cfg), ("klt", cfg_klt)):
        clip = truncate_sequence(seq, ONLINE_SECONDS)
        kernels.reset_launch_counts()
        r = run_sequence(clip, c, device="cuda")
        launches = dict(kernels.launch_counts)
        m = r.metrics
        n = m["num_poses"]
        per_lm = r.graph.stereo.lm_obs_mask.sum(1).long().cpu().numpy()
        ate_odom = ate_rmse(r.odom_compare, clip.gt_pos[:n])
        runs[name] = dict(r=r, clip=clip, launches=launches, ate_odom=ate_odom,
                          multi=int((per_lm >= 2).sum()), observed=int((per_lm >= 1).sum()))
        log(f"{name} front end on the first {ONLINE_SECONDS} s ({len(clip.image_t)} frames): "
            f"{m['frontend_frames'] / m['frontend_seconds']!r} frames/s; launches {launches}; "
            f"solve {m['solve_seconds']!r} s, {m['lm_iterations']} LM iterations, error "
            f"{m['initial_error']!r} -> {m['final_error']!r}; landmarks observed in >= 2 keyframes "
            f"{runs[name]['multi']} of {runs[name]['observed']} observed; ATE vs ground truth "
            f"{m['ate_rmse_vs_gt']!r} m, DVL odometry {ate_odom!r} m")
        # The same frames again with the RANSAC gate opened (front end only):
        # whether the temporal association or the shared gate ends the tracks.
        open_gate = dataclasses.replace(c.frontend, ransac_threshold_px=1e9)
        fe = StereoFrontend(c.camera, open_gate, device="cuda")
        frames = fe.process_chunk(clip.images_left, clip.images_right, clip.image_t)
        log(f"  {name} track lengths in frames {{length: tracks}}: {track_lengths(clip.features)}; "
            f"RANSAC gate opened: {track_lengths(frames)}")
    k = runs["klt"]
    m, n_frames = k["r"].metrics, len(k["clip"].image_t)
    card_checks = klt_card_check(k["clip"], cfg)
    levels = cfg.frontend.pyramid_levels
    errors = (m["initial_error"], m["final_error"], m["ate_rmse_vs_gt"], k["ate_odom"])
    log(f"KLT phase: {time.perf_counter() - t_phase!r} s")
    return {
        "launches": k["launches"],
        "checks": {
            f"klt: fast_harris {levels} and hamming 1 launches per frame": k["launches"] == {
                "fast_harris": levels * n_frames, "hamming": n_frames},
            "klt: every frame went through the front end": m["frontend_frames"] == n_frames,
            "klt: errors and ATEs finite, final error < initial":
            all(math.isfinite(e) for e in errors) and m["final_error"] < m["initial_error"],
            f"klt: ATE <= {ONLINE_ATE_VS_ODOM} x the DVL odometry's":
            m["ate_rmse_vs_gt"] <= ONLINE_ATE_VS_ODOM * k["ate_odom"],
            "klt: trajectory finite": bool(np.isfinite(k["r"].trajectory).all()),
            **card_checks,
        },
    }


# ---- phase 11: ROS bags, npz files and the command line ---------------------
# ROS1 message definitions and serializers of the reference's topics (the
# public ROS1 wire format: little-endian, length-prefixed strings and arrays).

IMU_DEF = """\
Header header
geometry_msgs/Quaternion orientation
float64[9] orientation_covariance
geometry_msgs/Vector3 angular_velocity
float64[9] angular_velocity_covariance
geometry_msgs/Vector3 linear_acceleration
float64[9] linear_acceleration_covariance
================================================================================
MSG: geometry_msgs/Quaternion
float64 x
float64 y
float64 z
float64 w
================================================================================
MSG: geometry_msgs/Vector3
float64 x
float64 y
float64 z
"""

POSE_COV_DEF = """\
Header header
geometry_msgs/PoseWithCovariance pose
================================================================================
MSG: geometry_msgs/PoseWithCovariance
geometry_msgs/Pose pose
float64[36] covariance
================================================================================
MSG: geometry_msgs/Pose
geometry_msgs/Point position
geometry_msgs/Quaternion orientation
================================================================================
MSG: geometry_msgs/Point
float64 x
float64 y
float64 z
================================================================================
MSG: geometry_msgs/Quaternion
float64 x
float64 y
float64 z
float64 w
"""

TWIST_DEF = """\
Header header
geometry_msgs/Twist twist
================================================================================
MSG: geometry_msgs/Twist
geometry_msgs/Vector3 linear
geometry_msgs/Vector3 angular
================================================================================
MSG: geometry_msgs/Vector3
float64 x
float64 y
float64 z
"""

STRING_DEF = "string data\n"

IMAGE_DEF = """\
Header header
uint32 height
uint32 width
string encoding
uint8 is_bigendian
uint32 step
uint8[] data
"""


def s_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def s_header(t: float) -> bytes:
    secs = int(t)
    return struct.pack("<III", 7, secs, int(round((t - secs) * 1e9))) + s_string("")


def ser_imu(t, acc, gyro) -> bytes:
    cov = struct.pack("<9d", *([0.0] * 9))
    return (s_header(t) + struct.pack("<4d", 0.0, 0.0, 0.0, 1.0) + cov
            + struct.pack("<3d", *gyro) + cov + struct.pack("<3d", *acc) + cov)


def ser_pose_cov(t, quat_wxyz, pos) -> bytes:
    w, x, y, z = quat_wxyz
    return (s_header(t) + struct.pack("<3d", *pos) + struct.pack("<4d", x, y, z, w)
            + struct.pack("<36d", *([0.0] * 36)))


def ser_twist(t, vel) -> bytes:
    return s_header(t) + struct.pack("<3d", *vel) + struct.pack("<3d", 0.0, 0.0, 0.0)


def ser_pressure(mbar) -> bytes:
    return s_string(json.dumps({"press_abs": mbar, "temperature": 21.0}))


def ser_image_mono8(t, img) -> bytes:
    h, w = img.shape
    return (s_header(t) + struct.pack("<II", h, w) + s_string("mono8")
            + struct.pack("<BII", 0, w, h * w) + img.tobytes())


def sensor_messages(seq, tp) -> list:
    """The four sensor topics of ``seq`` as (topic, type, definition, t,
    bytes), with the reference's message types."""
    msgs = [(tp.imu, "sensor_msgs/Imu", IMU_DEF, float(t), ser_imu(float(t), a, g))
            for t, a, g in zip(seq.imu_t, seq.imu_acc, seq.imu_gyro)]
    msgs += [(tp.pressure, "std_msgs/String", STRING_DEF, float(t), ser_pressure(float(p)))
             for t, p in zip(seq.pressure_t, seq.pressure_mbar)]
    msgs += [(tp.dvl_pose, "geometry_msgs/PoseWithCovarianceStamped", POSE_COV_DEF, float(t),
              ser_pose_cov(float(t), q, p))
             for t, q, p in zip(seq.dvl_pose_t, seq.dvl_pose_quat, seq.dvl_pose_pos)]
    msgs += [(tp.dvl_twist, "geometry_msgs/TwistStamped", TWIST_DEF, float(t), ser_twist(float(t), v))
             for t, v in zip(seq.dvl_twist_t, seq.dvl_twist_vel)]
    return msgs


SENSOR_FIELDS = (
    ("imu_t", "imu_acc", "imu_gyro"), ("pressure_t", "pressure_mbar"),
    ("dvl_pose_t", "dvl_pose_quat", "dvl_pose_pos"), ("dvl_twist_t", "dvl_twist_vel"),
)
SEQ_ARRAYS = [f for group in SENSOR_FIELDS for f in group] + [
    "mavros_vel_t", "mavros_vel", "image_t", "images_left", "images_right"]


def sequences_equal(a, b) -> bool:
    """Every stream of two sequences array-equal, features included."""
    import numpy as np

    for name in SEQ_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
            return False
    return len(a.features) == len(b.features) and all(
        fa.t == fb.t and all(np.array_equal(getattr(fa, f), getattr(fb, f))
                             for f in ("ids", "u0", "v0", "u1", "v1"))
        for fa, fb in zip(a.features, b.features))


def cli(*args: str, timeout: float = 900):
    """``python -m uslam_tpu_torch *args`` as a child process from the
    checkout; logs its exit code, wall time and, on failure, its stderr."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "uslam_tpu_torch", *args], cwd=ROOT, capture_output=True,
        text=True, timeout=timeout, env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    log(f"  $ python -m uslam_tpu_torch {' '.join(Path(a).name if '/' in a else a for a in args)}"
        f": exit {proc.returncode} in {time.perf_counter() - t0!r} s")
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
    return proc


def bag_round_trip(seq, cfg, tmp: Path) -> dict:
    """Phase 11 (a): the first ONLINE_SECONDS of the dive, uint8 frames, as a
    reference-style bag (bz2; its sensor topics alone again as lz4), read
    back, and run on the card beside the same frames in memory; the C++
    scanner against the Python reader on both bags."""
    import numpy as np

    from uslam_tpu_torch.frontend import kernels
    from uslam_tpu_torch.io import rosbag
    from uslam_tpu_torch.pipeline import run_sequence

    clip = truncate_sequence(seq, ONLINE_SECONDS)
    clip.images_left = np.clip(clip.images_left, 0, 255).astype(np.uint8)
    clip.images_right = np.clip(clip.images_right, 0, 255).astype(np.uint8)
    # Stamps as a bag records them, whole nanoseconds, so that the clip in
    # memory and the bag read back hold the same ones: otherwise an IMU
    # sample stamped at a keyframe's time may move by an ulp across it. The
    # reader keys an image pair by its stamp rounded to 0.1 ms.
    for name in ("imu_t", "pressure_t", "dvl_pose_t", "dvl_twist_t", "image_t"):
        q = [int(t) + int(round((t - int(t)) * 1e9)) * 1e-9 for t in getattr(clip, name).tolist()]
        setattr(clip, name, np.array([round(t, 4) for t in q] if name == "image_t" else q))
    tp = rosbag.BagTopics(image_left=IMAGE_TOPICS[0], image_right=IMAGE_TOPICS[1])
    sensors = sorted(sensor_messages(clip, tp), key=lambda m: m[3])
    images = [(topic, "sensor_msgs/Image", IMAGE_DEF, float(t), ser_image_mono8(float(t), img))
              for t, lo, ro in zip(clip.image_t, clip.images_left, clip.images_right)
              for topic, img in ((tp.image_left, lo), (tp.image_right, ro))]
    bag, lz4_bag = tmp / "dive.bag", tmp / "sensors_lz4.bag"
    t0 = time.perf_counter()
    rosbag.write_bag(str(bag), sorted(sensors + images, key=lambda m: m[3]), compression="bz2")
    t_bz2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    rosbag.write_bag(str(lz4_bag), sensors, compression="lz4")
    t_lz4 = time.perf_counter() - t0
    written = {}
    for topic, *_ in sensors + images:
        written[topic] = written.get(topic, 0) + 1
    log(f"  wrote {bag.name}: {len(sensors) + len(images)} messages ({len(images)} mono8 images "
        f"{clip.images_left.shape[1:]}), {os.path.getsize(bag)} bytes, bz2, in {t_bz2!r} s; "
        f"{lz4_bag.name}: {len(sensors)} messages, {os.path.getsize(lz4_bag)} bytes, lz4, in "
        f"{t_lz4!r} s (host)")

    t0 = time.perf_counter()
    dec = rosbag.bag_to_sequence(str(bag), topics=tp, decode_images=True)
    log(f"  decoded with images (Python reader): {time.perf_counter() - t0!r} s (host)")
    frames_equal = all(
        d is not None and d.dtype == np.float32 and np.array_equal(d, src)
        for d, src in ((dec.images_left, clip.images_left), (dec.images_right, clip.images_right)))
    stamp_err, data_equal = 0.0, True
    for t_name, *data in SENSOR_FIELDS + (("image_t",),):
        a, b = getattr(dec, t_name), getattr(clip, t_name)
        if a.shape != b.shape:
            stamp_err = math.inf
            continue
        stamp_err = max(stamp_err, float(np.abs(a - b).max()))
        data_equal &= all(np.array_equal(getattr(dec, f), getattr(clip, f)) for f in data)
    log(f"  decoded frames equal the uint8 source: {frames_equal}; sensor arrays equal: "
        f"{data_equal}; stamps within {stamp_err!r} s")

    acfg = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, max_iterations=INGEST_LM_ITERS))
    runs = {}
    for name, s in (("in memory", clip), ("decoded bag", dec)):
        kernels.reset_launch_counts()
        r = run_sequence(s, acfg, device="cuda")
        runs[name] = (r, dict(kernels.launch_counts), s.features)
        m = r.metrics
        log(f"  run_sequence on the {name} ({INGEST_LM_ITERS} LM iterations at most): launches "
            f"{runs[name][1]}, {m['lm_iterations']} LM iterations, error {m['initial_error']!r} -> "
            f"{m['final_error']!r}")
    (ref, ref_launches, ref_feats), (got, launches, got_feats) = runs.values()
    features_equal = len(ref_feats) == len(got_feats) == len(clip.image_t) and all(
        abs(a.t - b.t) <= BAG_STAMP_S and all(
            np.array_equal(getattr(a, f), getattr(b, f)) for f in ("ids", "u0", "v0", "u1", "v1"))
        for a, b in zip(ref_feats, got_feats))
    err_rel = max(abs(got.metrics[k] - ref.metrics[k]) / ref.metrics[k]
                  for k in ("initial_error", "final_error"))

    readers_equal = {}
    for path in (bag, lz4_bag):
        size, seqs = os.path.getsize(path), {}
        for label, native in (("C++ scanner", True), ("Python reader", False)):
            t0 = time.perf_counter()
            seqs[label] = rosbag.bag_to_sequence(str(path), use_native=native)
            dt = time.perf_counter() - t0
            # No rate from a read of milliseconds: tools/bag_reader_scale.py
            # times both readers on a whole dive's sensor bag.
            rate = f", {size / dt / 1e6!r} MB/s" if dt >= 1.0 else ""
            log(f"  {path.name} ({size} bytes), {label}: {dt!r} s{rate} (host of the card's "
                f"machine; bag bytes over wall time, decompression included)")
        readers_equal[path.name] = sequences_equal(*seqs.values()) and len(
            seqs["C++ scanner"].imu_t) == len(clip.imu_t)
    return {
        "bag": bag, "written": written, "launches": launches,
        "checks": {
            "ingest (a): bag frames equal the uint8 source": frames_equal,
            "ingest (a): bag sensor arrays equal the source": data_equal,
            f"ingest (a): bag stamps within {BAG_STAMP_S} s": stamp_err <= BAG_STAMP_S,
            "ingest (a): features from the decoded bag equal those in memory": features_equal,
            "ingest (a): launches on the decoded bag equal those in memory": (
                launches == ref_launches and launches["fast_harris"] > 0),
            f"ingest (a): errors within {INGEST_ERROR_RTOL} of the run in memory":
            err_rel <= INGEST_ERROR_RTOL,
            **{f"ingest (a): C++ scanner = Python reader on {k}": v
               for k, v in readers_equal.items()},
        },
    }


def info_counts(text: str) -> dict:
    """{name: count} from the lines ``info`` prints for a bag or an npz."""
    out = {}
    for line in text.splitlines():
        parts = line.split()
        if line.startswith("  ") and len(parts) >= 2:
            if parts[-1] == "msgs" or parts[-1] == "frames":
                out[parts[0]] = int(parts[-2])
            elif parts[-1].isdigit():
                out[parts[0]] = int(parts[-1])
    return out


def cli_checks(bag: Path, written: dict, tmp: Path) -> dict:
    """Phase 11 (b): ``info`` on the bag, ``synth`` then ``info`` on its npz."""
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence

    info_bag = cli("info", str(bag))
    npz = str(tmp / "s.npz")
    synth = cli("synth", "--duration", "4", "--out", npz)
    info_npz = cli("info", npz)
    spec = generate_synthetic_sequence(SyntheticSpec(duration=4.0, num_landmarks=256))
    log(f"  info on the bag: {info_counts(info_bag.stdout)}; synth: {synth.stdout.strip()}; "
        f"info on its npz: {info_counts(info_npz.stdout)}")
    return {
        "cli (b): info on the bag exits 0 with each topic's count":
        info_bag.returncode == 0 and info_counts(info_bag.stdout) == written,
        "cli (b): synth and info exit 0 with the spec's keyframe and IMU counts":
        synth.returncode == 0 and info_npz.returncode == 0 and {
            k: v for k, v in info_counts(info_npz.stdout).items() if k in ("dvl_pose_t", "imu_t")}
        == {"dvl_pose_t": len(spec.dvl_pose_t), "imu_t": len(spec.imu_t)},
    }


def cli_run_in_process(argv: list) -> tuple:
    """``python -m uslam_tpu_torch *argv`` through its entry point
    (``__main__.main``) in this process, with the launch counts set to 0
    just before it: the counts read after it are the run's own. Returns
    (exit code, stdout, stderr, launches, [(sequence, SlamResult)] of each
    ``run_sequence`` call the command made)."""
    import contextlib
    import io

    import torch

    from uslam_tpu_torch import __main__ as entry
    from uslam_tpu_torch import pipeline
    from uslam_tpu_torch.frontend import kernels

    calls, real = [], pipeline.run_sequence

    def recorded(seq, *args, **kwargs):
        result = real(seq, *args, **kwargs)
        calls.append((seq, result))
        return result

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    pipeline.run_sequence = recorded  # cmd_run imports it at call time
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = entry.main(argv)
        torch.cuda.synchronize()
    finally:
        pipeline.run_sequence = real
    launches = dict(kernels.launch_counts)
    log(f"  $ python -m uslam_tpu_torch {' '.join(Path(a).name if '/' in a else a for a in argv)}"
        f" (in this process): exit {rc} in {time.perf_counter() - t0!r} s")
    return rc, out.getvalue(), err.getvalue(), launches, calls


def frames_agree(card, cpu, cam) -> tuple:
    """(frames whose track ids equal, max |card - CPU| over the feature
    coordinates in px) of two front ends' FeatureFrames."""
    import numpy as np

    scale = {"u0": cam.resolution_x, "u1": cam.resolution_x,
             "v0": cam.resolution_y, "v1": cam.resolution_y}
    same, err = 0, 0.0
    for a, b in zip(card, cpu):
        if a.t != b.t or not np.array_equal(a.ids, b.ids):
            continue
        same += 1
        for f, size in scale.items():
            d = np.abs(getattr(a, f) - getattr(b, f))
            err = max(err, float(d.max()) * 0.5 * size if len(d) else 0.0)
    return same, err


def cli_klt_run(cfg, tmp: Path) -> dict:
    """Phase 11 (c): ``run`` on a 20 Hz 1080p clip with the KLT tracker and
    the polish, through the command line's entry point in this process:
    its launches, device, track lengths (ROADMAP C1) and features come from
    that run. The port's front end on the CPU over the same npz must give
    the card's track ids frame for frame. ORB's track lengths are printed
    beside."""
    import numpy as np
    import torch

    from uslam_tpu_torch.config import FrontendConfig, UslamConfig
    from uslam_tpu_torch.eval.metrics import ate_rmse
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.graph.values import Values
    from uslam_tpu_torch.io.sequence import load_sequence, save_sequence
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.pipeline import _run_frontend
    from uslam_tpu_torch.utils.checkpoint import load_state

    t0 = time.perf_counter()
    clip = generate_synthetic_sequence(
        SyntheticSpec(**CLI_CLIP), cfg.camera, render_images=True, omit_features=True)
    clip.images_left = np.clip(clip.images_left, 0, 255).astype(np.uint8)
    clip.images_right = np.clip(clip.images_right, 0, 255).astype(np.uint8)
    npz, cfg_path = str(tmp / "clip.npz"), str(tmp / "klt.json")
    save_sequence(npz, clip)
    klt_cfg = UslamConfig(frontend=FrontendConfig(temporal_tracker="klt"))
    klt_cfg.save_json(cfg_path)
    n_kf = len(clip.image_t)
    log(f"  clip {CLI_CLIP}: {n_kf} keyframes {clip.images_left.shape[1:]} uint8, rendered and "
        f"saved ({os.path.getsize(npz)} bytes) in {time.perf_counter() - t0!r} s")
    out = {k: str(tmp / n) for k, n in (("values", "v.npz"), ("dot", "g.dot"), ("plot", "p.png"))}
    rc, stdout, stderr, launches, calls = cli_run_in_process(
        ["run", npz, "--config", cfg_path, "--polish", "--save-values", out["values"],
         "--dot", out["dot"], "--plot", out["plot"]])
    if rc != 0:
        log(stderr[-4000:])
    m = json.loads(stdout) if rc == 0 else {}
    log(f"  metrics: {m}")
    (run_seq, result), = calls
    solve_device = result.values.pose_trans.device
    card_frames = run_seq.features

    tracks = {"klt": track_lengths(card_frames)}
    t0 = time.perf_counter()
    cpu_frames = _run_frontend(load_sequence(npz), klt_cfg, torch.device("cpu"), None)
    t_cpu = time.perf_counter() - t0
    same, coord_err = frames_agree(card_frames, cpu_frames, cfg.camera)
    t0 = time.perf_counter()
    tracks["orb"] = track_lengths(_run_frontend(load_sequence(npz), UslamConfig(),
                                                torch.device("cuda"), None))
    t_orb = time.perf_counter() - t0
    share = {}
    for name, tl in tracks.items():
        n_ids = sum(tl.values())
        multi = sum(c for k, c in tl.items() if k >= 2)
        share[name] = multi / max(n_ids, 1)
        log(f"  {name} track lengths {{length: tracks}} {tl}; landmarks in >= 2 keyframes "
            f"{multi} of {n_ids}")
    log(f"  the run's KLT features against the port's KLT front end on the CPU ({t_cpu!r} s): "
        f"ids equal in {same} of {len(card_frames)} frames ({len(cpu_frames)} on the CPU), "
        f"max |card - CPU| {coord_err!r} px; ORB front end alone on the card {t_orb!r} s")
    if share["klt"] < KLT_MULTI_SHARE:
        # Not a check: the JAX package's front end gives these tracks id for
        # id on this clip (ROADMAP C4), so the shortfall is the reference's.
        log(f"  ALERT: {share['klt']!r} of the KLT landmarks seen in >= 2 keyframes, below "
            f"{KLT_MULTI_SHARE} (ROADMAP C4: the 3 px 1-point translation RANSAC gate rejects "
            f"parallax at this focal length)")
    n = m.get("num_poses", 0)
    _, _, odom, _ = pack_sequence(run_seq, klt_cfg)
    ate_odom = ate_rmse(odom[:n], clip.gt_pos[:n]) if n else math.inf
    values = (load_state(out["values"], Values(*[torch.empty(0)] * 5), device="cuda")
              if os.path.exists(out["values"]) else None)
    written = {k: os.path.exists(p) and os.path.getsize(p) > 0 for k, p in out.items()}
    has_matplotlib = importlib.util.find_spec("matplotlib") is not None
    log(f"  launches {launches}; solved on {solve_device}; ATE vs ground truth "
        f"{m.get('ate_rmse_vs_gt')!r} m, DVL odometry {ate_odom!r} m; saved values: "
        f"{None if values is None else tuple(values.pose_trans.shape)}; files written {written} "
        f"(matplotlib installed: {has_matplotlib}; CLI stderr: {stderr.strip()[-300:]!r})")
    return {
        "launches": launches, "imu": np.concatenate([clip.imu_acc, clip.imu_gyro], 1),
        "checks": {
            "cli (c): run exits 0 and prints JSON metrics": rc == 0 and bool(m),
            "cli (c): run solved on the card": solve_device.type == "cuda",
            f"cli (c): run launches fast_harris {cfg.frontend.pyramid_levels} and hamming 1 "
            f"per frame": launches == {
                "fast_harris": cfg.frontend.pyramid_levels * n_kf, "hamming": n_kf},
            "cli (c): the LM's error falls": m.get("final_error", math.inf) < m.get(
                "initial_error", -math.inf),
            f"cli (c): ATE <= {ONLINE_ATE_VS_ODOM} x the DVL odometry's":
            m.get("ate_rmse_vs_gt", math.inf) <= ONLINE_ATE_VS_ODOM * ate_odom,
            "cli (c): --save-values and --dot written; --plot written, or matplotlib absent "
            "and the CLI says so": all(written[k] for k in ("values", "dot")) and (
                written["plot"] if has_matplotlib
                else "matplotlib is not installed" in stderr),
            "cli (c): the values load onto the card with the solve's pose count":
            values is not None and values.pose_trans.is_cuda
            and values.pose_quat.shape[0] == n <= n_kf,
            f"cli (c): KLT track ids equal the CPU front end's frame for frame, coordinates "
            f"within {KLT_CARD_VS_CPU_PX} px":
            len(card_frames) == len(cpu_frames) == same == n_kf
            and coord_err <= KLT_CARD_VS_CPU_PX,
        },
    }


def debug_nans_and_filters(cfg, imu) -> dict:
    """Phase 11 (d): ``debug_nans`` on a 2 s precomputed-feature solve, and
    ``smooth_imu`` of the (c) clip's IMU stream on the card against the CPU."""
    import numpy as np
    import torch

    from uslam_tpu_torch.io.filters import smooth_imu
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.pipeline import run_sequence

    seq = generate_synthetic_sequence(SyntheticSpec(duration=2.0))
    cfg = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, max_iterations=INGEST_LM_ITERS))
    on_cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, debug_nans=True))
    t0 = time.perf_counter()
    off = run_sequence(seq, cfg, device="cuda")
    t_off = time.perf_counter() - t0
    t0 = time.perf_counter()
    on = run_sequence(seq, on_cfg, device="cuda")
    t_on = time.perf_counter() - t0
    same = on.stats == off.stats and all(torch.equal(a, b) for a, b in zip(on.values, off.values))
    bad = dataclasses.replace(seq, imu_acc=seq.imu_acc.copy())
    bad.imu_acc[len(bad.imu_acc) // 2, 1] = np.nan
    try:
        run_sequence(bad, on_cfg, device="cuda")
        raised = None
    except FloatingPointError as e:  # the outcome this check expects
        raised = str(e)
    log(f"  debug_nans: {off.stats.iterations} LM iterations, solve {t_off!r} s off, {t_on!r} s "
        f"on; bit-identical: {same}; one NaN IMU sample: {raised!r}")

    x = np.asarray(imu, np.float32)
    smooth_imu(x, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = smooth_imu(x, device="cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    cpu = smooth_imu(x, device="cpu")
    err = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
    log(f"  smooth_imu {x.shape} on the card: {ms!r} ms host wall (synchronized; "
        f"{2 * (len(x) + 24)} sequential steps), max |card - CPU| / max |CPU| {err!r}")
    return {
        "debug_nans (d): a clean solve with the flag on is bit-identical": same,
        "debug_nans (d): a NaN IMU sample raises FloatingPointError naming linearize":
        raised is not None and "linearize" in raised,
        f"smooth_imu (d): card within {SMOOTH_IMU_RTOL} of the CPU": err <= SMOOTH_IMU_RTOL,
    }


def ingest_phase(seq, cfg) -> dict:
    """Phase 11: a reference-style bag through the port's readers to the
    card, the command line, ROADMAP C1 at 20 Hz, debug_nans and smooth_imu."""
    t_phase = time.perf_counter()
    checks = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        log("ingest (a): a reference-style bag of the dive's first seconds")
        a = bag_round_trip(seq, cfg, tmp)
        checks.update(a["checks"])
        log("ingest (b): the command line")
        checks.update(cli_checks(a["bag"], a["written"], tmp))
        log("ingest (c): run from the command line on a 20 Hz 1080p clip, KLT")
        c = cli_klt_run(cfg, tmp)
        checks.update(c["checks"])
    log("ingest (d): debug_nans and smooth_imu")
    checks.update(debug_nans_and_filters(cfg, c["imu"]))
    log(f"ingest phase: {time.perf_counter() - t_phase!r} s")
    return {"checks": checks, "bag_launches": a["launches"], "cli_klt_launches": c["launches"]}


def main() -> int:
    if not (ROOT / "uslam_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"device: {device_name}")
    log(smi)
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 must be False")

    from uslam_tpu_torch.config import UslamConfig
    from uslam_tpu_torch.eval.metrics import ate_rmse
    from uslam_tpu_torch.frontend import kernels
    from uslam_tpu_torch.frontend.orb import extract_orb_batch
    from uslam_tpu_torch.frontend.pyramid import build_pyramid
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.pipeline import run_sequence

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"  fast_harris SASS: {sass_loop_summary(kernels.load()._name)}")
    from uslam_tpu_torch import native

    t0 = time.perf_counter()
    log(f"build: C++ bag scanner {Path(native.load()._name).name} in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 3. kernels against their plain versions ---------------------------
    cfg = UslamConfig()
    t0 = time.perf_counter()
    seq = generate_synthetic_sequence(
        SyntheticSpec(duration=20.0, odom_drift_rate=0.05),
        cfg.camera, render_images=True, omit_features=True,
    )
    log(f"synthetic sequence: {len(seq.image_t)} stereo frames "
        f"{seq.images_left.shape[1:]} in {time.perf_counter() - t0:.2f} s")
    chunk = cfg.frontend.offline_chunk
    levels = cfg.frontend.pyramid_levels
    pairs = np.stack([seq.images_left[:chunk], seq.images_right[:chunk]], axis=1)
    rendered = torch.from_numpy(pairs).cuda().reshape((2 * chunk,) + pairs.shape[2:])
    rendered_levels = [im.contiguous() for im in build_pyramid(rendered, levels)]
    textured_levels = [
        im.contiguous() for im in build_pyramid(textured_images(tuple(rendered.shape), 1), levels)
    ]

    log("kernels:")
    ragged = [(3, 57, 90), (1, 71, 250), (48, 270, 480)]
    fh = check_fast_harris(
        [(f"rendered L{i}", im) for i, im in enumerate(rendered_levels)]
        + [(f"textured L{i}", im) for i, im in enumerate(textured_levels)]
        + [("textured", textured_images(shape, 3 + n)) for n, shape in enumerate(ragged)]
    )
    flush_buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fh_ms, fh_bound, fh_plain_ms = [], [], []
    for im in rendered_levels:
        fh_ms.append(cuda_ms(lambda im=im: kernels.fast_harris(im, 10.0), KERNEL_REPS,
                             flush=flush_buf.zero_))
        fh_plain_ms.append(cuda_ms(lambda im=im: kernels.fast_harris_plain(im, 10.0), PLAIN_REPS))
        fh_bound.append(bound_ms(im.numel() * 9, im.numel() * FAST_HARRIS_OPS_PER_PX))
        b_ms, b_by = fh_bound[-1]
        log(f"  fast_harris {tuple(im.shape)} (L2 flushed, strip rows "
            f"{kernels.load().uslam_fast_harris_strip_rows(*im.shape)}): kernel {fh_ms[-1]!r} ms, "
            f"bound {b_ms!r} ms ({b_by}: 9 B/px), share {b_ms / fh_ms[-1]!r}, "
            f"plain {fh_plain_ms[-1]!r} ms")
    fh_bound_ms = sum(b for b, _ in fh_bound)
    log(f"  fast_harris per chunk: kernel {sum(fh_ms)!r} ms, bound {fh_bound_ms!r} ms, "
        f"share {fh_bound_ms / sum(fh_ms)!r}, plain {sum(fh_plain_ms)!r} ms")

    # The chunk's one Hamming launch: rows 0..C-1 left vs right, rows
    # C..2C-1 left vs previous left (the tracker's layout).
    kp = extract_orb_batch(rendered, cfg.frontend)
    left, right = kp.desc[0::2], kp.desc[1::2]
    prev = torch.cat([torch.zeros_like(left[:1]), left[:-1]])
    real = (torch.cat([left, left]), torch.cat([right, prev]))
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand_desc(b, n):
        return torch.randint(-2**31, 2**31 - 1, (b, n, 8), generator=gen, device="cuda",
                             dtype=torch.int32)

    hm = check_hamming([
        ("random", (rand_desc(2 * chunk, cfg.frontend.max_features),
                    rand_desc(2 * chunk, cfg.frontend.max_features))),
        ("ragged", (rand_desc(3, 70), rand_desc(3, 130))),
        ("rendered descriptors", real),
    ])
    hm_ms = cuda_ms(lambda: kernels.hamming(*real), KERNEL_REPS)
    hm_plain_ms = cuda_ms(lambda: kernels.hamming_plain(*real), KERNEL_REPS)
    n_dist = real[0].shape[0] * real[0].shape[1] * real[1].shape[1]
    hm_bound, hm_bound_by = bound_ms(
        (real[0].numel() + real[1].numel()) * 4 + n_dist * 4, n_dist * 8 * 3
    )
    log(f"  hamming {tuple(real[0].shape)} x {tuple(real[1].shape)}: kernel {hm_ms!r} ms, "
        f"bound {hm_bound!r} ms ({hm_bound_by}), share {hm_bound / hm_ms!r}, "
        f"plain {hm_plain_ms!r} ms")

    # The online path's per-keyframe shapes: one stereo pair (2 images at
    # each level) and one (2, 48, 8) x (2, 48, 8) Hamming launch (stereo and
    # temporal matrices).
    pair_levels = [im[:2].contiguous() for im in rendered_levels]
    real_pair = (torch.cat([left[1:2], left[1:2]]), torch.cat([right[1:2], left[:1]]))
    fh.update(max_abs_err=max(fh["max_abs_err"], check_fast_harris(
        [(f"rendered pair L{i}", im) for i, im in enumerate(pair_levels)])["max_abs_err"]))
    hm.update(max_abs_err=max(hm["max_abs_err"], check_hamming(
        [("rendered pair", real_pair)])["max_abs_err"]))
    kf_ms = [cuda_ms(lambda im=im: kernels.fast_harris(im, 10.0), KERNEL_REPS,
                     flush=flush_buf.zero_) for im in pair_levels]
    kf_bound = [bound_ms(im.numel() * 9, im.numel() * FAST_HARRIS_OPS_PER_PX)[0]
                for im in pair_levels]
    for im, ms, b_ms in zip(pair_levels, kf_ms, kf_bound):
        log(f"  fast_harris per keyframe {tuple(im.shape)} (L2 flushed): kernel {ms!r} ms, "
            f"bound {b_ms!r} ms, share {b_ms / ms!r}")
    log(f"  fast_harris per keyframe (3 launches): kernel {sum(kf_ms)!r} ms, bound "
        f"{sum(kf_bound)!r} ms, share {sum(kf_bound) / sum(kf_ms)!r}")
    hm_kf_ms = cuda_ms(lambda: kernels.hamming(*real_pair), KERNEL_REPS)
    n_kf = real_pair[0].shape[0] * real_pair[0].shape[1] * real_pair[1].shape[1]
    hm_kf_bound, _ = bound_ms((real_pair[0].numel() + real_pair[1].numel()) * 4 + n_kf * 4,
                              n_kf * 8 * 3)
    log(f"  hamming per keyframe {tuple(real_pair[0].shape)} x {tuple(real_pair[1].shape)}: "
        f"kernel {hm_kf_ms!r} ms, bound {hm_kf_bound!r} ms, share {hm_kf_bound / hm_kf_ms!r}")
    del rendered, rendered_levels, textured_levels, pair_levels, kp, real, real_pair, flush_buf
    torch.cuda.empty_cache()
    profile_chunk(seq, cfg)

    # ---- 4. the slice, default config: run_sequence on the card ------------
    n_frames = len(seq.image_t)
    n_chunks = math.ceil(n_frames / chunk)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_sequence(seq, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    m = result.metrics
    n_poses, n_rows = m["num_poses"], m["num_landmarks"]
    ate_odom = ate_rmse(result.odom_compare, seq.gt_pos[:n_poses])
    s = result.graph.stereo
    n_lm_obs = int(torch.unique(s.lm_idx[s.mask > 0]).numel())
    log("slice (default SolverConfig: Schur + velocity elimination):")
    log(f"  launches: {launches} expected fast_harris={n_chunks * levels} "
        f"hamming={n_chunks} ({n_chunks} chunks of {chunk}, {levels} levels)")
    log(f"  frontend: {m['frontend_frames']} frames in {m['frontend_seconds']!r} s "
        f"= {m['frontend_frames'] / m['frontend_seconds']!r} frames/s")
    obs_per_lm = np.bincount(s.lm_obs_mask.sum(1).long().cpu().numpy())
    log(f"  reduced system 6N+6 = {6 * n_poses + 6} (N={n_poses}); landmark rows M={n_rows}, "
        f"observed {n_lm_obs}; full tangent {9 * n_poses + 6 + 3 * n_rows}; landmarks by "
        f"observation count {dict((k, int(c)) for k, c in enumerate(obs_per_lm) if k and c)}")
    log(f"  pack: {m['pack_seconds']!r} s; solve: {m['solve_seconds']!r} s, "
        f"{m['lm_iterations']} LM iterations, converged={m['converged']}")
    log(f"  error {m['initial_error']!r} -> {m['final_error']!r}")
    log(f"  ATE vs ground truth {m['ate_rmse_vs_gt']!r} m; DVL odometry {ate_odom!r} m")
    log(f"  run_sequence wall {wall!r} s")
    traj = result.trajectory
    checks = {
        "fast_harris launched once per level per chunk": launches["fast_harris"] == n_chunks * levels,
        "hamming launched once per chunk": launches["hamming"] == n_chunks,
        "every frame went through the front end": m["frontend_frames"] == n_frames,
        "trajectory shape and finite": traj.shape == (n_poses, 3) and bool(np.isfinite(traj).all()),
        "final_error < initial_error": m["final_error"] < m["initial_error"],
        "at least 20 landmarks observed": n_lm_obs >= 20,
        "ATE finite and below the DVL odometry's": math.isfinite(m["ate_rmse_vs_gt"])
        and m["ate_rmse_vs_gt"] < ate_odom,
    }
    profile_solve(result, cfg, "slice")

    # ---- 5. the Schur solve held to the dense one on the slice's graph -----
    checks.update(schur_witness(result, cfg))
    kernels.reset_launch_counts()
    again = run_sequence(seq, cfg, device="cuda")  # the features phase 4 left
    ma = again.metrics
    log(f"default solver again on the same features (kernel launches "
        f"{dict(kernels.launch_counts)}): {ma['lm_iterations']} LM iterations, error "
        f"{ma['final_error']!r}, solve {ma['solve_seconds']!r} s")
    checks["a second solve of the same graph ends bit-identical"] = (
        ma["lm_iterations"] == m["lm_iterations"] and ma["final_error"] == m["final_error"]
        and torch.equal(again.values.pose_trans, result.values.pose_trans)
    )
    cfg_dense = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, linear_solver="dense"))
    dense = run_sequence(seq, cfg_dense, device="cuda")
    torch.cuda.synchronize()
    md = dense.metrics
    log("dense solver on the same features:")
    log(f"  full tangent D = {9 * n_poses + 6 + 3 * n_rows}; error {md['initial_error']!r} -> "
        f"{md['final_error']!r}; ATE {md['ate_rmse_vs_gt']!r} m")
    log(f"  solve_seconds / LM iterations: schur {m['solve_seconds']!r} s / "
        f"{m['lm_iterations']}, dense {md['solve_seconds']!r} s / {md['lm_iterations']}; "
        f"final error schur / dense {m['final_error'] / md['final_error']!r}")
    checks["dense: final_error < initial_error"] = md["final_error"] < md["initial_error"]
    checks[f"Schur final error <= {SCHUR_VS_DENSE_ERROR} x the dense solver's"] = (
        m["final_error"] <= SCHUR_VS_DENSE_ERROR * md["final_error"])

    # ---- 6. the offline tail: f64 polish and marginals on the card ---------
    checks.update(offline_tail(result, seq, cfg))

    # ---- 7. the solver at its published scale: the 1k-pose batch solve -----
    checks.update(solve_1k())

    # ---- 8. the online stream: OnlineSlam on the card ----------------------
    online = online_phase(seq, cfg)
    checks.update(online["checks"])
    online_launches = online["launches"]

    # ---- 9. the survey sweep on the banded solver and its certificate ------
    checks.update(survey_phase())

    # ---- 10. the KLT temporal tracker on the dive's first seconds ----------
    klt = klt_phase(seq, cfg)
    checks.update(klt["checks"])
    klt_launches = klt["launches"]

    # ---- 11. ROS bags, npz files and the command line ------------------------
    ingest = ingest_phase(seq, cfg)
    checks.update(ingest["checks"])

    checks["neither JAX nor the JAX package imported"] = not any(
        name.split(".")[0] in ("jax", "jaxlib", "uslam_tpu") for name in sys.modules
    )
    for name, ok in checks.items():
        log(f"  check {'PASS' if ok else 'FAIL'}: {name}")
    if not all(checks.values()):
        raise AssertionError("checks failed")

    record = {
        "kernels": [
            {
                "name": "fast_harris", "route": "cuda",
                "source": "uslam_tpu_torch/csrc/fast_harris.cu",
                "replaces": "uslam_tpu/frontend/pallas_kernels.py:67",
                "launches": launches["fast_harris"],
                "max_abs_err": fh["max_abs_err"],
                # One chunk's worth: the three pyramid levels of 16 images.
                "ms": sum(fh_ms), "plain_ms": sum(fh_plain_ms),
                "bound_ms": fh_bound_ms, "bound_by": fh_bound[0][1],
                "share": fh_bound_ms / sum(fh_ms),
                "library_ms": None,  # no PyTorch call computes FAST-9 + Harris
                # The online path (phase 8, pass (a)): one stereo pair per keyframe.
                "online_launches": online_launches["fast_harris"],
                "klt_launches": klt_launches["fast_harris"],
                # Phase 11: the run on the decoded bag, and the command
                # line's run on the 20 Hz KLT clip.
                "bag_launches": ingest["bag_launches"]["fast_harris"],
                "cli_klt_launches": ingest["cli_klt_launches"]["fast_harris"],
                "keyframe_ms": sum(kf_ms), "keyframe_bound_ms": sum(kf_bound),
            },
            {
                "name": "hamming", "route": "cuda",
                "source": "uslam_tpu_torch/csrc/hamming.cu",
                "replaces": "uslam_tpu/frontend/pallas_kernels.py:229",
                "launches": launches["hamming"],
                "max_abs_err": hm["max_abs_err"],
                "ms": hm_ms, "plain_ms": hm_plain_ms,
                "bound_ms": hm_bound, "bound_by": hm_bound_by, "share": hm_bound / hm_ms,
                "library_ms": None,  # no PyTorch call computes packed-word Hamming
                "online_launches": online_launches["hamming"],
                "klt_launches": klt_launches["hamming"],
                "bag_launches": ingest["bag_launches"]["hamming"],
                "cli_klt_launches": ingest["cli_klt_launches"]["hamming"],
                "keyframe_ms": hm_kf_ms, "keyframe_bound_ms": hm_kf_bound,
            },
        ]
    }
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
