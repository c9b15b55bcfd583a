#!/usr/bin/env python3
"""Build and drive the PyTorch port (``uslam_tpu_torch``) once on one
NVIDIA GPU, and check what comes out.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. device: CUDA must be available; prints the card's name and power limit.
2. build: nvcc builds the hand-written kernels from ``uslam_tpu_torch/csrc``.
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

The last two lines of standard output are one JSON object with the kernel
records, then ``{"ok": true, "device": {...}}``. Imports nothing of JAX and
nothing of the JAX package ``uslam_tpu``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
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
