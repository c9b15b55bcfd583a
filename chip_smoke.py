#!/usr/bin/env python3
"""Build and drive the PyTorch port (``uslam_tpu_torch``) once on one
NVIDIA GPU, and check what comes out.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. device: CUDA must be available; prints the card's name and power limit.
2. build: nvcc builds the hand-written kernels from ``uslam_tpu_torch/csrc``
   (fast_harris, hamming, preintegrate, jacobi_eigh, graph_cond; one nvcc
   per source, all started together), g++ the C++ bag scanner from
   ``uslam_tpu_torch/native``. Then the probe of the CUDA graph's
   conditional nodes (``graph_cond_probe``): the torch, CUDA and driver
   versions; a toy WHILE node holding a nested WHILE and an IF with an else
   body (cuBLAS, cuSOLVER and ``jacobi_eigh`` inside) graphed against its
   eager run bit for bit at 5 steps and at 0, with its body runs and
   launches; the condition kernel against its plain version (a host read
   of the flag; ``Test.flag()`` read on the host, over a grid of counters,
   values and thresholds with infinities and NaN, and stop flags), its
   time per launch in a graph from a Test and from a flag beside its
   bound, an empty kernel node's (the floor of a one-thread node), a WHILE
   iteration whose body only counts (its test a Test, and the former
   flag) and the host read's. Then the collective probe
   (``nccl_probe``) on an NCCL group of one rank on cuda:0: the port's three
   collectives (an in-place sum, a gather of float and bool rows, the first
   rank's value) in a plain graph, a WHILE body, both bodies of an IF, before
   a loop and in its body, and in an IF nested in a WHILE body, each graphed
   against its eager run bit for bit at 5 steps and 0, with the node types
   of each graph and body (one rank: torch's side and NCCL's one-rank
   copies; NCCL's kernels for more ranks only in phase 12 (b)).
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
   stereo pair at each level, Hamming on its 2 matrices of 48x48. The IMU
   preintegration kernel on the intervals the packer gives the 1k solve,
   the slice, the online window and the 20 Hz clip (also with S cut to 16),
   each with an all-padding interval, in float32 and float64: against its
   plain version and the forward-mode Jacobian (torch.func.jacfwd) of the
   value-only loop to ``PREINT_RTOL`` with a random bias per row (the
   former layout: 24 rows per interval); bit for bit against the eager path it
   replaces (the loop under torch.func.jvp) in that layout and in the main
   path's (one row per interval); its value-only variant bit for bit
   against the loop. Then its time in the main path's layouts (the
   linearizer's with the Jacobian, the error's value only) beside their
   bounds (what the intervals' data needs, once), the plain version's
   time, the chain's floor (one interval alone, measured; phase 2 prints
   the chain's SASS instructions per step), and in the former 24-row
   layout. The Jacobi eigensolver kernel (``jacobi_eigh``) against its
   plain version on tests/test_torch_eigh.py's cases (the same seeds) and a
   batch of 64 random symmetric 15 x 15, float32 and float64, to
   ``JACOBI_RTOL`` of the input's norm (eigenvalues and PSD projections;
   bit-identity printed, and checked on the SPD 15 x 15), then its time on
   the SPD 15 x 15 in float32 beside its bound (the bytes of A, w and V, or
   the 9 n^3 operations of a symmetric eigendecomposition with vectors),
   its chain of dependent rounds (a latency figure, apart from the bound),
   the plain version's time and torch.linalg.eigh's.
   Then a torch.profiler breakdown of one front-end chunk's device time.
4. slice: ``run_sequence`` with the default ``UslamConfig()`` (Schur +
   velocity elimination) on a rendered 20 s synthetic dive (100 stereo
   keyframes at 1920x1080, 200 landmarks, 200 Hz IMU); checks the launch
   counts of both kernels (fast_harris once per level per chunk, hamming
   once per chunk; preintegrate and graph_cond as the LM's code gives them
   from its iterations and accepted steps), the LM's error decrease, and
   the trajectory error against ground truth and the DVL odometry; prints the LM iterations and
   final error beside the former layout's (``SLICE_BEFORE``); then where one LM iteration
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
   and its LM-iteration profile. Between the solve and the polish, at the
   solution: the CUDA-graphed ``linearize_graph`` and ``graph_error`` held
   to their eager bodies bit for bit (float32, and float64 as the polish
   runs them), and each one's host ms per LM iteration, eager and graphed,
   with one preintegration launch per call, of one kernel row per IMU
   interval; the linearization's IMU block (one preintegration per
   interval) equal to the former 24-row path bit for bit, in both types.
8. online: the first ``ONLINE_SECONDS`` of phase 3's dive (uint8 frames)
   streamed message by message through ``OnlineSlam(UslamConfig(),
   window=10, solve_during_fill=False)`` three times: (a) the host
   smoother with the per-frame front end, (b) ``pipelined=True`` (fused
   front end and window step on the device), (c) ``device_resident=True``.
   Checks each keyframe's launches (3 fast_harris and 1 hamming; 1
   jacobi_eigh per steady keyframe on (b) and (c); the priming step's at
   keyframe 10), equal keyframe counts, no pending keyframe after
   ``flush()``, each ATE within ``ONLINE_ATE_VS_ODOM`` of the DVL
   odometry's and (b) within ``ONLINE_DIVERGENCE_M`` of (a); on (b) and
   (c) every steady keyframe's step, from its record's upload to its
   packed output, under ``torch.cuda.set_sync_debug_mode("error")`` (no
   host read; the mode shown to raise on one), no capture on or after the
   first steady keyframe, and the graphed step equal to the eager one
   (``graphed=False``) bit for bit on the pass's last window, whose
   marginal the Jacobi kernel is held to its plain version on (bit for bit)
   and timed on beside ``torch.linalg.eigh``; prints per-keyframe host ms
   (median, p90) of the steady keyframes beside keyframe 10's, the timing
   split, LM iterations and linearizations per steady keyframe (the window
   LM a WHILE node that stops when it converges, its re-linearization an IF
   node), one steady
   keyframe under torch.profiler, and the window's landmarks by
   observation count; (a)'s last window graphed against eager bit for
   bit, and its IMU block against the 24-row path; the CUDA-graph captures
   of each pass.
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
   host sync and repeat bit-identically. At each size the preintegration
   kernel's time in the linearizer's, the error's and the former layouts.
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

12. multi-device (``uslam_tpu_torch.parallel`` over ``torch.distributed``):
   (a) an NCCL group of one rank on cuda:0 in this process, where every
   collective runs and is an identity: ``sharded_optimize_lm`` on phase 7's
   1k problem and on phase 9's 2000-pose survey (banded) graphed (two plain
   graphs, ``"lm_start"`` and blocks of ``SHARDED_BLOCK`` steps,
   ``"lm_block"``, the collectives inside; host reads ceil(iterations / 4)
   + 1, each a block's read of "active", the only host syncs of a replay)
   against eager blocks of one step, bit for bit, as ``lm_graph_pair`` does
   for phase 14, and bit-identical to phase 7's solve and to the
   single-device graphed survey solve; host ms per iteration graphed, eager
   (before the capture and after) and the single-device graphed solve's;
   ``sharded_lm_step`` (one graph per call; Cholesky on the 1k, banded on
   the survey) graphed against eager and the single-device step, bit for
   bit; ``collectives.wait``, the host's wait after each block, reads the
   group's timeout, returns at once on an idle stream and, on a stream kept
   busy past a short-timeout group's limit, raises then;
   after ``close_mesh`` no cached graph holds the group; ``process_stereo_pairs_sharded`` /
   ``extract_orb_frames_sharded`` on phase 3's first chunk (uint8) equal to
   ``orb_chunk_step``'s stereo output, with 3 fast_harris + 1 hamming and 3
   fast_harris launches per call; prints the collectives' bytes per LM
   iteration and their device time in one sharded solve. (b) With two or
   more GPUs, one NCCL rank per GPU (``parallel.launch.run_ranks``): the
   collective probe on every rank (a plain graph must equal eager; the
   conditional bodies' outcome and node types are printed: NCCL's event
   nodes keep them from instantiating), then the float64 1k LM graphed on
   every rank, held to one rank's over ``PARALLEL_LM_ITERS`` iterations,
   every rank the same bits and equal to its eager blocks of 1, with its
   reads, graph launches, capture ms and ms per iteration graphed and
   eager; the same over ``PARALLEL_BLOCKS_ITERS`` iterations, two blocks or
   more with a host read between them, every rank the same bits, the same
   reads (ceil(iterations / 4) + 1) and equal to its eager blocks of 1; a
   stuck peer: rank 0 replays a graph holding an all-reduce its peers
   never join, and its ``collectives.wait`` raises after
   ``STUCK_TIMEOUT_S``, the replay still running; the
   front end to (a) exactly; on one GPU it prints that it
   did not run.
   ``python3 chip_smoke.py --only-parallel`` runs phases 1, 2 and 12 alone
   (the 1k solve, the 2000-pose survey at its initial values and a 2 s
   dive's first chunk made for it).

13. public surface: the JAX package's entry points beside the pipeline,
   each with its launch counts set to 0 just before it and read just
   after: ``extract_orb`` on one 1920x1080 image (3 fast_harris launches
   and nothing else; bit-identical to ``extract_orb_batch`` of that image;
   on ``SURFACE_CPU_IMAGES`` images equal to the CPU's, descriptors to
   ROADMAP C5's standard; its ms per image beside ``extract_orb_batch``'s
   on a 16-image chunk), ``hamming_distance_matrix`` at (1000, 8) x (1200,
   8) (1 hamming launch, equal to ``hamming_plain``),
   ``preintegrate_with_cov`` in float64 on the slice's IMU intervals (its
   deltas against the preintegrate kernel's value-only variant, its
   ``whitener_from_cov`` against the packer's numpy whitener), and the
   native C++ whiteners and time join against numpy on the slice's
   sequence. ``python3 chip_smoke.py --only-surface`` runs phases 1, 2 and
   13 alone.

14. the LM as one CUDA graph per solve (``solvers/lm.py``,
   ``solvers/compiled.py``): the slice's solve (which must repeat
   ``SLICE_BEFORE``) and the same slice with the CG reduced solve, the 1k
   solve, the 2000-pose banded survey, from their initial values, each
   graphed (the first linearization and error, then a WHILE node over the
   step, its re-linearization an IF node, the CG a WHILE node inside)
   against eager blocks of one step, bit for bit (values and statistics),
   with per solve its host reads (1), graph launches (1), steps run (no
   masked step), linearizations (1 + the accepted steps, as eager), CG
   iterations (as eager) and the launches of preintegrate and graph_cond
   against the counts the code gives; no host sync in a replay of
   ``solve_lm`` (``set_sync_debug_mode``); captures, the capture's host ms, host
   ms per iteration and the device's busy share of one graphed solve; the
   kernel nodes of the LM's and the CG's WHILE bodies on the CG slice,
   captured with each loop test a ``compiled.Test`` (one condition kernel)
   and with the former flag (three torch kernels more), one kernel node per
   test, both graphs replayed in turns for their host ms per iteration and
   equal bit for bit; and the online window step of phase 8's pass (c),
   graphed against eager, bit for bit, with no capture, no host read and no
   masked step (its three graphs replayed three times). Phase 8 checks that
   the device-resident passes capture nothing on or after the first steady
   keyframe and that their window LM reads nothing on the host.

15. the JAX repo's examples and its two quality checks, on the card:
   (a) the port's examples (``EXAMPLE_RUNS``: run_synthetic_torch.py with
   ``--images`` and on precomputed features, run_online_torch.py on the
   host path, ``--device-resident`` and ``--fused``; then
   run_from_rosbag_torch.py on phase 11 (a)'s clip, with its front end's
   features, written as a reference-style features bag), each through its
   ``main()`` in this process with the launch counts set to 0 just before
   and read just after: each launches its kernels, runs on the card, and
   ends below the DVL odometry's ATE (online within
   ``ONLINE_ATE_VS_ODOM`` of it); (b) tests/test_oracle_parity.py:71's
   100-keyframe ATE parity: the float32 ``run_solver`` and the float64
   polish on the card against the exact float64 oracle
   (``exact_f64_optimize``), the polished ATE within ``ORACLE_PARITY`` of
   the oracle's (raises), the float32 canary printed on an ALERT line when
   it misses (ROADMAP C9); (c) tests/test_fixed_lag_stress.py's 30 s drift
   stream (``run_stress``) on the host path and device-resident, each held
   to the JAX test's four bounds (raise), with ``seg_err``, the ATEs, wall
   seconds, host ms per steady keyframe and the LM's host reads per steady
   keyframe. ``python3 chip_smoke.py --only-quality`` runs phases 1, 2 and
   15 alone, the bag made from a features sequence.

After each of phases 4-12, 14 and 15 the CUDA graphs it captured and replayed
are printed. ``python3 chip_smoke.py --only-compiled`` runs phases 1 and 2 (with the
probe), the preintegration checks of phase 3, phase 7's solve and graph checks and
phase 14 on inputs made for it (the slice's front end and solve, the
2000-pose survey at its initial values, phase 8's pass (c)).

The last two lines of standard output are one JSON object with the kernel
records, then ``{"ok": true, "device": {...}}``. Imports nothing of JAX and
nothing of the JAX package ``uslam_tpu``.
"""

from __future__ import annotations

import contextlib
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
# The IMU preintegration kernel against its plain version and against the
# forward-mode Jacobian (torch.func.jacfwd) of the value-only loop, relative
# to each output's largest entry: float64 to 1e-12; float32 to 1e-5 (the
# plain version's sums run in other CUDA reduction orders than the loop's,
# over a 64-step recursion). Against the eager path it replaces (the loop
# under torch.func.jvp) the kernel must be bit-identical: it repeats that
# path's operations in their order.
PREINT_RTOL = {"torch.float32": 1e-5, "torch.float64": 1e-12}
# Float operations the preintegration needs (an FMA two; a sqrt, sin, cos,
# division or comparison one each), counted from the eager path it repeats
# with its tangent seeds' zeros and unit entries folded: an operation on a
# tangent that is exactly 0, or a product by +-1, is not counted. So an
# accelerometer column carries no quaternion tangent (dq = 0 at every
# step: its rotation tangent is R(q) da alone, 12 operations), a
# gyroscope column no da, and Exp's tangent is taken for the 3 gyroscope
# columns alone. (value, the six columns' tangents) per sample:
# - Exp of a real sample (dt != 0; a - ba and w - bg included), by its
#   branch: theta^2 >= 1e-8 (23, 46: 15 per gyroscope column and the
#   2 theta they share) or below (22, 30);
# - the chain, by the step's place in its interval: the first (from the
#   identity and zero tangents: 24, 66), the second (v, p and the gyroscope
#   columns' dv, dp still zero: 95, 495), any later real one (95, 555 =
#   3 x 149 + 3 x 36: rotate, p/v, the Hamilton product, normalize), and a
#   padded one after them (dt = 0: v, p and t stay, q e = q exactly; the
#   normalization alone, 12, 60).
# A real sample in its steady state needs 719 (PR 8's bound counted 1,294
# for every sample: 118 + 6 x 196, zeros included); padding trails each
# interval (the packer's mask).
PREINT_EXP_OPS = {"large": (23, 46), "small": (22, 30)}
PREINT_CHAIN_OPS = {"first": (24, 66), "second": (95, 495), "steady": (95, 555),
                    "padded": (12, 60)}
# The linearizer's tangent rows per IMU interval (pose_i, vel_i, pose_j,
# vel_j, bias): the former main path launched one kernel row for each,
# the layout timed here as "before".
IMU_TANGENT_ROWS = 24
# The slice's LM iterations and final error on the card with the former
# layout: the arithmetic is unchanged, so the solve must repeat them.
SLICE_BEFORE = (83, 0.07104358822107315)
FP64_OPS_PER_S = 34e12  # H100 SXM fp64 outside the tensor cores (data sheet)
# The Jacobi eigensolver kernel against its plain version, relative to the
# input's Frobenius norm: eigenvalues and the PSD projection V diag(max(w,
# 0)) V^T, to the bounds tests/test_torch_eigh.py holds the plain version to
# against jnp.linalg.eigh (1e-5 in float32, 1e-12 in float64). Both run the
# same rotations in the same order, so they agree bit for bit wherever they
# stop after the same sweep; a differing stop stays within these bounds.
JACOBI_RTOL = {"torch.float32": 1e-5, "torch.float64": 1e-12}
# Its cases: tests/test_torch_eigh.py's, from the same numpy seeds, and a
# batch of random symmetric 15 x 15 (the window marginal's size).
JACOBI_SEEDS = {"spd15": 0, "indefinite15": 1, "repeated15": 2, "diagonal15": 3, "zero15": 4,
                "symmetric2": 5, "symmetric9": 6, "symmetric32": 7}
JACOBI_BATCH = (64, 15, 8)    # matrices, size, seed
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
# Phase 12 (b): the ranks' float64 1k LM against one rank's, over this many
# iterations, at tests/test_torch_parallel.py's tolerances.
PARALLEL_LM_ITERS = 3
PARALLEL_ERROR_RTOL = 1e-7
PARALLEL_VALUES_ATOL = 1e-7
# Phase 12 (b): the ranks' float64 1k LM over more than one block of steps
# (solvers/lm.py's SHARDED_BLOCK = 4), held rank against rank bit for bit.
PARALLEL_BLOCKS_ITERS = 9
# Phase 12 (b)'s ranks are stopped after this long, should a rank hang
# where no timeout of the group reaches.
PARALLEL_TIMEOUT_S = 240
# Phase 12 (a): collectives.wait on a stream kept busy (torch.cuda._sleep,
# ~1.5-2 s at the H100's clocks) past the timeout of a group of one rank.
WAIT_PROBE_TIMEOUT_S = 0.25
WAIT_PROBE_CYCLES = 3_000_000_000
# Phase 12 (b): the timeout of the group whose all-reduce one rank replays
# in a graph and its peers never join.
STUCK_TIMEOUT_S = 3.0
STUCK_RANKS_S = 60      # the ranks are killed after this long
# Phase 13: the public surface's entry points on the card. extract_orb on
# the card against the CPU: masks, positions and levels exact, Harris
# scores and angles to tests/test_torch_frontend.py's 1e-5 relative and
# 1e-3 rad, descriptors equal where the angle is bit-equal and elsewhere
# to ROADMAP C5's standard (at most 2 flipped bits, in under 1% of the
# keypoints: another float32 order of the moment sums moves a steered
# sample by a pixel). preintegrate_with_cov's float64 deltas against the
# preintegrate kernel's value-only variant, relative to each output's
# largest entry (PREINT_RTOL); its whitener against the packer's numpy
# whitener, and the native C++ whitener against the same (the JAX
# package's own bound, tests/test_native.py), relative to the largest entry.
SURFACE_IMAGES = 16
SURFACE_CPU_IMAGES = 8   # of the chunk, held to the CPU (48 keypoints each at most)
SURFACE_HAMMING = (1000, 1200)
SURFACE_SCORE_RTOL = 1e-5
SURFACE_ANGLE_ATOL = 1e-3
SURFACE_MAX_FLIPPED_BITS = 2
SURFACE_FLIPPED_SHARE = 0.01
SURFACE_WHITENER_RTOL = 1e-9
NATIVE_WHITENER_RTOL = 1e-12
# Phase 15 (a): the port's examples (examples/*_torch.py), each run through
# its main() in this process, with their arguments. Their ATE bounds are
# PERF.md §2's: offline below the DVL odometry's, online at most
# ONLINE_ATE_VS_ODOM times it.
EXAMPLE_RUNS = (
    ("run_synthetic_torch.py", ("--images", "--duration", "8")),
    ("run_synthetic_torch.py", ("--duration", "20")),
    ("run_online_torch.py", ("--duration", "6")),
    ("run_online_torch.py", ("--duration", "6", "--device-resident")),
    ("run_online_torch.py", ("--duration", "6", "--fused")),
)
# Phase 15 (b): tests/test_oracle_parity.py:71's spec and bounds: the exact
# float64 oracle below half the initial ATE (:127); the float32 solve's ATE
# within ORACLE_CANARY of the oracle's (a regression canary, :133; ROADMAP
# C9: the port's float32 solve misses it on the CPU, so here a miss prints
# an ALERT line and tests/test_torch_oracle_parity.py is its gate); the
# polished ATE within ORACLE_PARITY = (factor, metres) of the oracle's
# (BASELINE's "ATE within 1%", :137).
ORACLE_SPEC = dict(duration=20.0, keyframe_rate=5.0, num_landmarks=128,
                   odom_drift_rate=0.05, feature_noise_px=0.3, seed=3)
ORACLE_CANARY = 3.5
ORACLE_PARITY = (1.01, 1e-4)
# Phase 15 (c): tests/test_fixed_lag_stress.py's stream (a survey whose
# landmarks all enter and leave the window) and its four bounds: enough
# keyframes, churn (unique landmark ids per second), each of STRESS_SEGMENTS
# segments within STRESS_SEG_MAX_M of the batch optimum with no runaway
# trend (the last two segments' mean within STRESS_TREND times the first
# two's, floored at STRESS_TREND_FLOOR_M), and the window beating the DVL
# odometry against ground truth.
STRESS_SECONDS = 30.0
STRESS_WINDOW = 8
STRESS_SEGMENTS = 6
STRESS_SEG_MAX_M = 0.30
STRESS_TREND = 4.0
STRESS_TREND_FLOOR_M = 0.02
STRESS_IDS_PER_SECOND = 2.5


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


def device_span_ms(fn) -> float:
    """Device ms from before to after one call of ``fn``, which must not
    wait on the device: CUDA events on the current stream, after a spin
    kernel that keeps the device busy while the host enqueues."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(bound in ms, what bounds it): the larger of the bytes over the HBM
    rate and the operations over the fp32 rate (or ``ops_per_s``)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / ops_per_s * 1e3
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


def preintegrate_cases(cfg) -> list:
    """IMU intervals as the main path packs them (``pack_sequence``), each
    with one all-padding interval appended (what the packer gives a graph of
    one pose): the 1k solve's, the slice's, the online window's (the slice's
    first ONLINE_WINDOW - 1 intervals) and the 20 Hz clip's, which has 10
    samples per interval, also with S cut to 16. (label, ImuIntervalData
    of float32 numpy arrays)."""
    import numpy as np

    from uslam_tpu_torch.factors.imu import ImuIntervalData
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence

    specs = {
        "1k": SyntheticSpec(duration=200.0, keyframe_rate=5.0, num_landmarks=512, omega=0.15,
                            odom_drift_rate=0.02, feature_noise_px=0.3, seed=0),
        "slice": SyntheticSpec(duration=20.0, odom_drift_rate=0.05),
        "20 Hz": SyntheticSpec(**CLI_CLIP),
    }

    def padded(d):
        return ImuIntervalData(*(np.concatenate([x, np.zeros_like(x[:1])]) for x in d))

    cases = []
    for label, spec in specs.items():
        seq = generate_synthetic_sequence(spec, cfg.camera, render_images=False,
                                          omit_features=True)
        data = pack_sequence(seq, cfg)[0].imu.data
        cases.append((label, padded(data)))
        if label == "slice":
            cases.append(("online window", padded(
                ImuIntervalData(*(x[:ONLINE_WINDOW - 1] for x in data)))))
        if label == "20 Hz":
            cases.append(("20 Hz, S cut to 16", padded(ImuIntervalData(
                data.acc[:, :16], data.gyro[:, :16], data.dt[:, :16]))))
    return cases


def preintegrate_oracle(data, bias):
    """``preintegrate_loop``'s value and its bias Jacobian by
    ``torch.func.jacfwd``: ((R, 10), (R, 10, 6), T). The Jacobian is taken
    with respect to one offset added to every row's bias; each row depends
    on its own bias alone, so that Jacobian is each row's."""
    import torch

    from uslam_tpu_torch.factors import imu

    def f(offset):
        d = imu.preintegrate_loop(data, bias + offset)
        return torch.cat([d.delta_q, d.delta_v, d.delta_p], -1)

    zero = bias.new_zeros(6)
    jac = torch.func.jacfwd(f)(zero)
    value = f(zero)
    return (value.reshape(-1, 10), jac.reshape(-1, 10, 6),
            imu.preintegrate_loop(data, bias[0]).dt_total)


def preintegrate_eager(data, bias6):
    """The eager path the kernel replaces, in the linearizer's layout:
    ``preintegrate_loop`` at ``bias6 + d[..., 18:24]`` under
    ``torch.func.jvp``, d the (24, n, 24) tangent rows. ((n, 10) values,
    (n, 10, 6) bias Jacobian, T)."""
    import torch

    from uslam_tpu_torch.factors import imu

    n = data.acc.shape[0]
    eye = torch.eye(IMU_TANGENT_ROWS, dtype=bias6.dtype, device=bias6.device)
    tangent = eye.reshape(IMU_TANGENT_ROWS, 1, IMU_TANGENT_ROWS).expand(
        IMU_TANGENT_ROWS, n, IMU_TANGENT_ROWS)

    def f(d):
        o = imu.preintegrate_loop(data, bias6 + d[..., 18:24])
        return torch.cat([o.delta_q, o.delta_v, o.delta_p], -1)

    value, jt = torch.func.jvp(f, (torch.zeros_like(tangent),), (tangent,))
    return value[0], jt[18:24].permute(1, 2, 0), imu.preintegrate_loop(data, bias6).dt_total


def preint_bytes_ops(data, bias, jacobian: bool = True):
    """(bytes, float operations) of one launch at ``bias`` ((6,): one row
    per interval; (..., n, 6): a row per bias row): the samples read once
    per interval, the biases, and the outputs (q, v, p, with ``jacobian``
    the (10, 6) Jacobian per row, T per interval); the operations this
    data needs (PREINT_EXP_OPS, PREINT_CHAIN_OPS)."""
    n, S = data.acc.shape[0], data.acc.shape[1]
    item = data.acc.element_size()
    phi = (data.gyro - bias[..., None, 3:]) * data.dt[..., None]
    small = (phi * phi).sum(-1) < 1e-8                    # (rows..., n, S)
    real = (data.dt != 0).expand(small.shape)
    rows = small[..., 0].numel()

    def ops(kind, table):
        value, tangent = table[kind]
        return value + (tangent if jacobian else 0)

    m = real.sum(-1)  # real samples per row
    n_ops = (ops("large", PREINT_EXP_OPS) * int((real & ~small).sum())
             + ops("small", PREINT_EXP_OPS) * int((real & small).sum())
             + int(((m >= 1) * (ops("first", PREINT_CHAIN_OPS)
                                + (S - m) * ops("padded", PREINT_CHAIN_OPS))
                    + (m >= 2) * ops("second", PREINT_CHAIN_OPS)
                    + (m - 2).clamp(min=0) * ops("steady", PREINT_CHAIN_OPS)).sum()))
    per_row = 10 + (60 if jacobian else 0)
    n_bytes = (n * S * 7 + bias.numel() + rows * per_row + n) * item
    return n_bytes, n_ops


def _flat(d):
    import torch

    return torch.cat([d.delta_q, d.delta_v, d.delta_p], -1)


def check_preintegrate(cases) -> dict:
    """The preintegration kernel on the card, in float32 and float64:
    (a) against its plain version and the oracle (:func:`preintegrate_oracle`)
    in the former layout (24 rows per interval) with a random bias per row, to
    PREINT_RTOL, padded intervals' Jacobians exactly 0; (b) bit for bit
    against the eager path it replaces (:func:`preintegrate_eager`), one
    bias for every row, in that layout and in the main path's (one row per
    interval); (c) the value-only variant bit for bit against
    ``preintegrate_loop`` and the full kernel's value. Then its time in the
    main path's layouts (the linearizer's: one row per interval with the
    Jacobian; the error's: value only) beside their bounds and the plain
    version's time, and in the former 24-row layout, on the packer's intervals
    (without the appended all-padding one); and the chain's floor, measured:
    one interval alone (one block, its S steps with nothing beside them)
    beside an empty launch (S = 0)."""
    import numpy as np
    import torch

    from uslam_tpu_torch.factors import imu

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {"max_abs_err": 0.0, "max_rel_err": {}, "times": {}}
    for label, d_np in cases:
        for dtype in (torch.float32, torch.float64):
            data = imu.ImuIntervalData(*(torch.from_numpy(np.asarray(x)).to("cuda", dtype)
                                         for x in d_np))
            n, S = data.acc.shape[0], data.acc.shape[1]
            scale = torch.full((6,), 0.05, dtype=dtype, device="cuda")
            scale[3:] = 0.005
            bias = torch.randn((IMU_TANGENT_ROWS, n, 6), generator=gen, device="cuda",
                               dtype=dtype) * scale
            dk, jk = imu.preintegrate_cuda(data, bias)
            dp, jp = imu.preintegrate_plain(data, bias)
            vo, jo, to = preintegrate_oracle(data, bias)
            torch.cuda.synchronize()
            vk, vp = _flat(dk).reshape(-1, 10), _flat(dp).reshape(-1, 10)
            jk, jp = jk.reshape(-1, 10, 6), jp.reshape(-1, 10, 6)
            rel, abs_plain = {}, 0.0
            for name, sl in (("q", slice(0, 4)), ("v", slice(4, 7)), ("p", slice(7, 10))):
                rel[name] = float((vk[:, sl] - vo[:, sl]).abs().max() / vo[:, sl].abs().max())
                rel[f"J_{name}"] = float((jk[:, sl] - jo[:, sl]).abs().max()
                                         / jo[:, sl].abs().max())
                abs_plain = max(abs_plain, float((vk[:, sl] - vp[:, sl]).abs().max()),
                                float((jk[:, sl] - jp[:, sl]).abs().max()))
            rel["t"] = float((dk.dt_total - to).abs().max() / to.abs().max())
            abs_plain = max(abs_plain, float((dk.dt_total - dp.dt_total).abs().max()))
            pad_ok = bool(torch.isfinite(jk).all()) and bool(
                (jk.reshape(IMU_TANGENT_ROWS, n, 10, 6)[:, -1] == 0).all())
            worst = max(rel.values())
            tol = PREINT_RTOL[str(dtype)]
            # (b): one bias for every row, as the LM linearizes; the former
            # 24-row layout and the main path's n rows.
            bias6 = bias[0, 0]
            ve, je, te = preintegrate_eager(data, bias6)
            d24, j24 = imu.preintegrate_cuda(data, bias6.expand(IMU_TANGENT_ROWS, n, 6))
            dn, jn = imu.preintegrate_cuda(data, bias6)
            bitwise = {
                "24 rows": (torch.equal(_flat(d24)[0], ve) and torch.equal(j24[0], je)
                            and torch.equal(d24.dt_total, te)),
                "n rows": (torch.equal(_flat(dn), ve) and torch.equal(jn, je)
                           and torch.equal(dn.dt_total, te)),
            }
            # (c): the error's value-only variant.
            dv, none = imu.preintegrate_cuda(data, bias6, jacobian=False)
            loop = imu.preintegrate_loop(data, bias6)
            value_only = none is None and all(
                torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(dv, loop, dn))
            log(f"  preintegrate {label} {str(dtype)[6:]} ({n} intervals, S={S}): relative error "
                f"vs jacfwd of the loop ({IMU_TANGENT_ROWS} x {n} rows, random bias) {worst!r} "
                f"(tol {tol}; by output { {k: float(f'{v:.3g}') for k, v in rel.items()} }), max "
                f"abs vs plain {abs_plain!r}; padded interval: Jacobian finite and 0: {pad_ok}; "
                f"bit-identical to the eager jvp of the loop: {bitwise}; value-only variant "
                f"bit-identical to the loop and the full kernel: {value_only}")
            if worst > tol or not pad_ok or not all(bitwise.values()) or not value_only:
                raise AssertionError(f"preintegrate disagrees with its oracle on {label} {dtype}")
            out["max_abs_err"] = max(out["max_abs_err"], abs_plain)
            out["max_rel_err"][str(dtype)] = max(out["max_rel_err"].get(str(dtype), 0.0), worst)

            # Times on the packer's intervals alone (no appended padding).
            n -= 1
            data = imu.ImuIntervalData(*(x[:n] for x in data))
            bias24 = bias[:, :n].contiguous()
            rate = FP32_OPS_PER_S if dtype == torch.float32 else FP64_OPS_PER_S
            lin_ms = cuda_ms(lambda: imu.preintegrate_cuda(data, bias6), KERNEL_REPS)
            err_ms = cuda_ms(lambda: imu.preintegrate_cuda(data, bias6, jacobian=False),
                             KERNEL_REPS)
            rows24_ms = cuda_ms(lambda: imu.preintegrate_cuda(data, bias24), KERNEL_REPS)
            plain_ms = cuda_ms(lambda: imu.preintegrate_plain(data, bias6), PLAIN_REPS)
            lin_b, lin_by = bound_ms(*preint_bytes_ops(data, bias6), rate)
            err_b, err_by = bound_ms(*preint_bytes_ops(data, bias6, jacobian=False), rate)
            r24_b, _ = bound_ms(*preint_bytes_ops(data, bias24), rate)
            t = dict(ms=lin_ms, bound_ms=lin_b, bound_by=lin_by, plain_ms=plain_ms,
                     err_ms=err_ms, err_bound_ms=err_b, err_bound_by=err_by,
                     rows24_ms=rows24_ms, rows24_bound_ms=r24_b)
            # The chain's floor: the first interval alone, and the launch
            # with no samples.
            one = imu.ImuIntervalData(*(x[:1] for x in data))
            empty = imu.ImuIntervalData(*(x[:1, :0] for x in data))
            t["one_ms"] = cuda_ms(lambda: imu.preintegrate_cuda(one, bias6), KERNEL_REPS)
            t["err_one_ms"] = cuda_ms(lambda: imu.preintegrate_cuda(one, bias6, jacobian=False),
                                      KERNEL_REPS)
            t["empty_ms"] = cuda_ms(lambda: imu.preintegrate_cuda(empty, bias6), KERNEL_REPS)
            floor = (f"; one interval alone (S={S}) {t['one_ms']!r} ms with the Jacobian, "
                     f"{t['err_one_ms']!r} ms value only, an empty launch {t['empty_ms']!r} ms: "
                     f"binds {'the chain' if t['one_ms'] > lin_b else lin_by}")
            out["times"][(label, str(dtype))] = t
            log(f"    time: linearizer ({n} rows + Jacobian) {lin_ms!r} ms, bound {lin_b!r} ms "
                f"({lin_by}), share {lin_b / lin_ms!r}, plain {plain_ms!r} ms; error ({n} rows, "
                f"value only) {err_ms!r} ms, bound {err_b!r} ms ({err_by}), share "
                f"{err_b / err_ms!r}; the former layout ({IMU_TANGENT_ROWS} x {n} rows + Jacobian, "
                f"before) {rows24_ms!r} ms, bound {r24_b!r} ms{floor}")
    return out


def jacobi_case(name: str):
    """tests/test_torch_eigh.py's case ``name`` (float64 numpy)."""
    import numpy as np

    rng = np.random.default_rng(JACOBI_SEEDS[name])
    if name == "spd15":
        J = rng.normal(size=(15, 15))
        return J @ J.T
    if name == "indefinite15":
        Q, _ = np.linalg.qr(rng.normal(size=(15, 15)))
        w = np.concatenate([rng.uniform(1.0, 10.0, 10), rng.uniform(-2e-9, -5e-10, 5)])
        return (Q * w) @ Q.T
    if name == "repeated15":
        return np.kron(np.eye(5), np.ones((3, 3))) + 2.0 * np.eye(15)
    if name == "diagonal15":
        return np.diag(rng.normal(size=15))
    if name == "zero15":
        return np.zeros((15, 15))
    n = int(name[len("symmetric"):])
    J = rng.normal(size=(n, n))
    return J + J.T


def jacobi_compare(label: str, A) -> dict:
    """The kernel against its plain version on ``A`` (..., n, n) on the card:
    eigenvalues and PSD projections within JACOBI_RTOL of the input's norm,
    bit-identity, sweeps. Returns {max_abs_err, rel_err, same, sweeps}."""
    import torch

    from uslam_tpu_torch.solvers import eig

    w, V, sw = eig.sym_eigh(A)
    wp, Vp, swp = eig.sym_eigh_plain(A)
    torch.cuda.synchronize()
    same = torch.equal(w, wp) and torch.equal(V, Vp) and torch.equal(sw, swp)
    err = max(float((w - wp).abs().max()), float((V - Vp).abs().max())) if w.numel() else 0.0

    def psd(w, V):
        return (V * torch.clamp(w, min=0.0)[..., None, :]) @ V.mT

    norm = float(torch.linalg.norm(A.double(), dim=(-2, -1)).max())
    rel = max(float((w - wp).abs().max()), float((psd(w, V) - psd(wp, Vp)).abs().max())) / max(
        norm, 1e-300) if w.numel() else 0.0
    tol = JACOBI_RTOL[str(A.dtype)]
    log(f"  jacobi_eigh {label} {tuple(A.shape)} {A.dtype}: max_abs_err {err!r}, eigenvalues and "
        f"PSD projection within {rel!r} of ||A|| (tolerance {tol}, met {rel <= tol}); "
        f"bit-identical {same}; sweeps {sorted(set(sw.flatten().tolist()))} (plain "
        f"{sorted(set(swp.flatten().tolist()))})")
    if not rel <= tol:
        raise AssertionError(f"jacobi_eigh disagrees with its plain version on {label}")
    return {"max_abs_err": err, "rel_err": rel, "same": same,
            "sweeps": int(sw.max()) if sw.numel() else 0}


def jacobi_bound(n: int, itemsize: int):
    """(bound ms, by) of one n x n symmetric eigendecomposition with its
    eigenvectors, whatever the algorithm: A read once, w and V written once;
    9 n^3 operations, the symmetric QR algorithm's count with vectors
    (tridiagonal reduction, its Q, and the implicit QR steps; Golub and
    Van Loan, "Matrix Computations", section 8.3)."""
    n_bytes = itemsize * (n * n + n + n * n)
    return bound_ms(n_bytes, 9 * n ** 3, FP32_OPS_PER_S if itemsize == 4 else FP64_OPS_PER_S)


def jacobi_times(A, label: str) -> dict:
    """The kernel's time on one matrix (KERNEL_REPS launches between CUDA
    events), its bound, the plain version's time and torch.linalg.eigh's
    (the library call, used nowhere in the port). Beside them, as a latency
    figure and not part of the bound: the kernel's chain of dependent
    rounds, (m - 1) per sweep at the padded size m = n + n % 2, for the
    sweeps this matrix took."""
    from uslam_tpu_torch.solvers import eig

    import torch

    n = A.shape[-1]
    sweeps = int(eig.sym_eigh(A)[2].max())
    rounds = (n + n % 2 - 1) * sweeps
    ms = cuda_ms(lambda: eig.sym_eigh(A), KERNEL_REPS)
    plain_ms = cuda_ms(lambda: eig.sym_eigh_plain(A), PLAIN_REPS)
    library_ms = cuda_ms(lambda: torch.linalg.eigh(A), KERNEL_REPS)
    b_ms, b_by = jacobi_bound(n, A.element_size())
    log(f"  jacobi_eigh {label} {tuple(A.shape)} {A.dtype}: kernel {ms!r} ms, bound {b_ms!r} ms "
        f"({b_by}: {9 * n ** 3} operations, 9 n^3), share {b_ms / ms!r}; chain: {sweeps} sweeps, "
        f"{rounds} dependent rounds, {ms / max(rounds, 1) * 1e3!r} us per round; plain "
        f"{plain_ms!r} ms; torch.linalg.eigh {library_ms!r} ms")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
            "bound_by": b_by, "sweeps": sweeps, "rounds": rounds}


def check_jacobi() -> dict:
    """Phase 3's Jacobi checks: tests/test_torch_eigh.py's cases and a batch
    of random symmetric 15 x 15, float32 and float64, then the times on the
    15 x 15 SPD case in float32 (the main path's size and type)."""
    import numpy as np
    import torch

    worst = {"max_abs_err": 0.0, "rel_err": 0.0, "same": True, "same_spd15": True}
    b, n, seed = JACOBI_BATCH
    B = np.random.default_rng(seed).normal(size=(b, n, n))
    for dt in (torch.float32, torch.float64):
        cases = [(name, jacobi_case(name)) for name in JACOBI_SEEDS]
        cases.append((f"batch of {b}", B + np.swapaxes(B, 1, 2)))
        for name, A in cases:
            r = jacobi_compare(name, torch.tensor(A, dtype=dt, device="cuda"))
            worst = {"max_abs_err": max(worst["max_abs_err"], r["max_abs_err"]),
                     "rel_err": max(worst["rel_err"], r["rel_err"]),
                     "same": worst["same"] and r["same"],
                     "same_spd15": worst["same_spd15"] and (r["same"] or name != "spd15")}
    worst.update(jacobi_times(torch.tensor(jacobi_case("spd15"), dtype=torch.float32,
                                           device="cuda"), "spd15"))
    return worst


def _toy_program(x, n, m):
    """The probe's program: a loop of ``n`` (a 0-d int64 tensor) steps,
    each an inner loop of 3 matrix products, then a branch on the step's
    parity whose taken side runs a Cholesky, a triangular solve and the
    jacobi_eigh kernel, the other a subtraction; the carry also sums."""
    import torch

    from uslam_tpu_torch.solvers import compiled
    from uslam_tpu_torch.solvers.eig import sym_eigh

    def inner(t):
        y, j = t
        return (y @ m) * 0.5 + 1.0, j + 1

    def heavy(a):
        spd = a @ a.T + a.shape[0] * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
        chol = torch.linalg.cholesky_ex(spd)[0]
        w, v, _ = sym_eigh(spd[:15, :15].contiguous())
        z = torch.linalg.solve_triangular(chol, a, upper=False)
        return z + w.sum() * 1e-3 + v[0, 0] * 0

    def body(s):
        y, i, acc = s
        y, _ = compiled.while_loop(lambda t: t[1] < 3, inner, (y, torch.zeros_like(i)),
                                   name="probe_inner")
        y = compiled.cond(i % 2 == 0, heavy, lambda a: a - 1.0, y, name="probe_if")
        return y / (1.0 + y.abs().max()), i + 1, acc + y.sum()

    zero = torch.zeros((), dtype=torch.int64, device=x.device)
    return compiled.while_loop(lambda s: s[1] < n, body, (x, zero, x.sum() * 0),
                               name="probe_outer")


def graph_cond_probe() -> dict:
    """Phase 2's probe of the conditional nodes (``csrc/graph_cond.cu``,
    ``solvers/compiled.py``) on the card: the versions they need, then a
    WHILE node holding a nested WHILE and an IF with an else body (cuBLAS,
    cuSOLVER and a hand kernel inside), graphed against its eager run bit
    for bit, at 5 steps and at 0 (a loop that never runs), the body runs
    and the launch counts equal; the condition kernel against its plain
    version (a host read of the flag), and its time in a graph, a WHILE
    iteration's, and the host read's."""
    import torch

    from uslam_tpu_torch import cuda_build
    from uslam_tpu_torch.solvers import compiled

    smi = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    nvcc = subprocess.run([cuda_build._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"conditional nodes: torch {torch.__version__}, its CUDA {torch.version.cuda}, driver "
        f"{smi}, nvcc {nvcc!r}; torch._C._cuda_beginAllocateCurrentStreamToPool "
        f"{hasattr(torch._C, '_cuda_beginAllocateCurrentStreamToPool')}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(32, 32, generator=gen, device="cuda", dtype=torch.float64)
    m = torch.randn(32, 32, generator=gen, device="cuda", dtype=torch.float64) / 8
    checks, out = {}, {}
    for steps in (5, 0):
        n = torch.tensor(steps, device="cuda")
        compiled.reset_counts()
        cuda_build.reset_launch_counts()
        eager = _toy_program(x, n, m)
        eager_runs = {k: list(v) for k, v in compiled.runs.items()}
        eager_launches = dict(cuda_build.launch_counts)
        graphed = [compiled.call("probe", _toy_program, (x, n, m), ()) for _ in range(2)]
        compiled.reset_counts()
        cuda_build.reset_launch_counts()
        again = compiled.call("probe", _toy_program, (x, n, m), ())
        compiled.settle_launches()
        runs = {k: list(v) for k, v in compiled.runs.items()}
        launches = dict(cuda_build.launch_counts)
        same = all(torch.equal(a, b) for g in (*graphed, again) for a, b in zip(g, eager))
        expected = {k: v for k, v in eager_launches.items() if v}
        got = {k: v for k, v in launches.items() if k != "graph_cond" and v}
        log(f"  probe, {steps} steps: graphed = eager bit for bit {same}; body runs graphed "
            f"{runs}, eager {eager_runs}; launches graphed {launches}, eager {eager_launches}")
        checks[f"conditional nodes: the probe at {steps} steps, graphed = eager bit for bit"] = same
        checks[f"conditional nodes: the probe at {steps} steps, body runs and launches as "
               "eager"] = runs == eager_runs and got == expected
        out[steps] = launches
    # The kernel against its plain version: an IF node whose bodies write
    # 1 and 0, at both flags, against the host's read of the flag.
    err = 0
    for value in (False, True):
        flag = torch.tensor(value, device="cuda")
        got = compiled.call("probe_flag", lambda f: compiled.cond(
            f, lambda: torch.ones((), device="cuda"), lambda: torch.zeros((), device="cuda")),
            (flag,), ())
        err = max(err, abs(float(got) - float(bool(flag))))
    test_err, test_cases = test_kernel_check()
    checks["conditional nodes: the condition kernel's loop test = Test.flag() read on the host, "
           f"{test_cases} operand sets"] = test_err == 0
    # Its time: a graph of K more condition kernels after an IF node,
    # against the graph with none, from the flag and from a Test of the
    # CG's form (an int64 counter below its limit, a float64 value above
    # its threshold); K empty kernels in a graph against none (the floor
    # of a one-thread node); a WHILE node of K iterations whose body only
    # counts, its test a Test (the counter's + 1, then the condition
    # kernel) or the former flag (+ 1, <, then the condition kernel).
    flag = torch.ones((), dtype=torch.bool, device="cuda")
    ops = (torch.tensor(0, device="cuda"), torch.tensor(2.0, dtype=torch.float64, device="cuda"),
           torch.tensor(1.0, dtype=torch.float64, device="cuda"))

    def sets(k, form):
        def fn(f, c, v, th):
            if compiled._warming_up():
                return f
            node, bodies = compiled._node(compiled._IF, f, "timing")
            for b in bodies:
                with compiled._body(node, b, f.device):
                    f.logical_not()
            cond = f if form == "flag" else compiled.Test(c, 3, v, th)
            for _ in range(k):
                compiled._set(node, cond)
            return f
        return fn

    def empties(k):
        def fn(f):
            out = f.clone()
            lib, stream = cuda_build.load(), torch.cuda.current_stream().cuda_stream
            for _ in range(k):
                cuda_build.raise_on(lib, lib.uslam_empty_kernel(stream), "empty")
            return out
        return fn

    k = 1000
    t_sets = {}
    for form in ("flag", "test"):
        t_k = cuda_ms(lambda: compiled.call(f"probe_sets_{form}_{k}", sets(k, form),
                                            (flag, *ops), ()), 20)
        t_0 = cuda_ms(lambda: compiled.call(f"probe_sets_{form}_0", sets(0, form),
                                            (flag, *ops), ()), 20)
        t_sets[form] = (t_k - t_0) / k
    empty_ms = (cuda_ms(lambda: compiled.call(f"probe_empty_{k}", empties(k), (flag,), ()), 20)
                - cuda_ms(lambda: compiled.call("probe_empty_0", empties(0), (flag,), ()), 20)) / k
    n_it = torch.tensor(k, device="cuda")
    t_loop = cuda_ms(lambda: compiled.call("probe_loop_test", lambda n: compiled.while_loop(
        lambda i: compiled.Test(i, k), lambda i: i + 1, torch.zeros_like(n)), (n_it,), ()), 20)
    t_loop_former = cuda_ms(lambda: compiled.call("probe_loop", lambda n: compiled.while_loop(
        lambda i: i < n, lambda i: i + 1, torch.zeros_like(n)), (n_it,), ()), 20)
    t0 = time.perf_counter()
    for _ in range(200):
        bool(flag)
    read_ms = (time.perf_counter() - t0) * 1e3 / 200
    test = compiled.Test(*ops[:1], 3, *ops[1:])
    t0 = time.perf_counter()
    for _ in range(200):
        bool(test.flag())
    plain_ms = (time.perf_counter() - t0) * 1e3 / 200
    # The CG's test: an 8-byte counter, two 8-byte values read, one 8-byte
    # count read and written; two comparisons and their and.
    bound, bound_by = bound_ms(8 + 8 + 8 + 16, 3)
    log(f"  condition kernel: per launch in a graph ({k} in one graph, less the graph without "
        f"them) {t_sets['test']!r} ms from a Test (the CG's form), {t_sets['flag']!r} ms from a "
        f"flag; an empty kernel node {empty_ms!r} ms; a WHILE iteration whose body only counts "
        f"{t_loop / k!r} ms (a Test: 2 kernel nodes), {t_loop_former / k!r} ms (the former "
        f"flag: 3 kernel nodes); the plain version (Test.flag() and a host read) {plain_ms!r} "
        f"ms, a host read of a flag alone {read_ms!r} ms; bound {bound!r} ms ({bound_by}: the "
        f"test's operands, one count read and written); max abs err {max(err, test_err)}")
    checks["conditional nodes: the condition kernel = the host's read of the flag"] = err == 0
    from uslam_tpu_torch.parallel import make_mesh
    from uslam_tpu_torch.parallel.mesh import close_mesh

    mesh = make_mesh(0, 1, "cuda:0")
    try:
        found = nccl_probe(mesh)["ok"]
    finally:
        close_mesh(mesh)
    checks.update({f"collectives in a graph, {shape!r} (NCCL, one rank): graphed = eager bit for "
                   "bit at 5 steps and 0": ok for shape, ok in found.items()})
    return {"checks": checks, "ms": t_sets["test"], "flag_ms": t_sets["flag"],
            "empty_ms": empty_ms, "plain_ms": plain_ms, "read_ms": read_ms, "bound_ms": bound,
            "bound_by": bound_by, "max_abs_err": max(err, test_err),
            "while_iteration_ms": t_loop / k, "while_iteration_former_ms": t_loop_former / k}


def test_kernel_check() -> tuple:
    """The condition kernel's loop test against its plain version
    (``Test.flag()`` read on the host): an IF node set from a Test, whose
    bodies write 1 and 0, replayed over a grid of operands: counters below,
    at and above the limit; values and thresholds with an infinity and NaN,
    in float32 and float64; stop true and false; and the LM's form (no
    value). Returns (max abs err, operand sets)."""
    import torch

    from uslam_tpu_torch.solvers import compiled

    limit = 3

    def decide(c, v, th, s):
        out = torch.full((), -1.0, device="cuda")
        if compiled._warming_up():
            return out
        test = compiled.Test(c, limit, stop=s) if v is None else compiled.Test(c, limit, v, th, s)
        node, (then_graph, else_graph) = compiled._node(compiled._IF, test, "probe_test")
        with compiled._body(node, then_graph, c.device):
            out.fill_(1.0)
        with compiled._body(node, else_graph, c.device):
            out.fill_(0.0)
        return out

    err, cases = 0.0, 0
    floats = (float("-inf"), 1.0, 2.0, float("nan"))
    for count in (2, 3, 4):
        c = torch.tensor(count, device="cuda")
        for stop in (False, True):
            s = torch.tensor(stop, device="cuda")
            operands = [(None, None)] + [
                (torch.tensor(v, dtype=dt, device="cuda"),
                 torch.tensor(th, dtype=dt, device="cuda"))
                for dt in (torch.float32, torch.float64) for v in floats for th in floats]
            for v, th in operands:
                got = compiled.call("probe_test", decide, (c, v, th, s), ())
                test = (compiled.Test(c, limit, stop=s) if v is None
                        else compiled.Test(c, limit, v, th, s))
                err = max(err, abs(float(got) - float(bool(test.flag()))))
                cases += 1
    return err, cases


# Where the probe's collectives sit: in a plain graph (no conditional node);
# in a WHILE body; in both bodies of an IF; once before a loop and in its
# body (the first error's broadcast, then the step's collectives); in a
# WHILE body and in an IF nested in it.
NCCL_PROBE_SHAPES = ("plain", "while", "if", "outer+while", "while>if")


def _nccl_program(x, flags, n, group, shape):
    """The collective probe's program on a (rows, c) float64 ``x`` and a
    (rows,) bool ``flags``: ``mix`` runs the port's three collectives (an
    in-place sum, a gather of rows, float and bool, the first rank's
    value), placed as ``shape`` says (``NCCL_PROBE_SHAPES``) in a loop of
    ``n`` (a 0-d int64 tensor) steps or a branch on ``n > 0``."""
    import torch

    from uslam_tpu_torch.collectives import all_gather_rows, all_reduce_sum, from_first_rank
    from uslam_tpu_torch.solvers import compiled

    rows = x.shape[0]

    def mix(y, f):
        s = all_reduce_sum(y * 0.5 + 1.0, group)
        g = all_gather_rows(s, group)[-rows:]
        gf = all_gather_rows(f, group)[-rows:]
        y = s + g * 1e-3 + gf.to(s.dtype)[:, None]
        return from_first_rank(y / (1.0 + y.abs().max()), group), gf ^ (y[:, 0] > 0)

    def other(y, f):
        return from_first_rank(y - 1.0, group), all_gather_rows(f, group)[:rows]

    def body(s):
        y, f, i = s
        y, f = mix(y, f)
        if shape == "while>if":
            y, f = compiled.cond(i % 2 == 0, mix, other, y, f, name="probe_nccl_if")
        return y, f, i + 1

    if shape == "plain":
        return mix(x, flags)
    if shape == "if":
        return compiled.cond(n > 0, mix, other, x, flags, name="probe_nccl_if")
    if shape == "outer+while":
        x, flags = mix(x, flags)
    zero = torch.zeros((), dtype=torch.int64, device=x.device)
    return compiled.while_loop(lambda s: s[2] < n, body, (x, flags, zero),
                               name="probe_nccl_while")


def nccl_probe(mesh) -> dict:
    """The port's collectives inside conditional bodies on ``mesh`` (NCCL):
    for each of ``NCCL_PROBE_SHAPES``, the program graphed (one
    ``compiled.call``, keyed by the group) against its eager run, bit for
    bit, at 5 steps and at 0, with the body runs; the node types the graph
    and each of its conditional bodies hold (``compiled.body_nodes``). A
    capture or instantiation that fails is recorded with its error, the
    line that raised and the node types read before, and fails the check.
    Then the mesh's graphs are evicted. One rank shows torch's side (the
    process group under a body's capture) and NCCL's one-rank copies, not
    NCCL's kernels for two or more ranks."""
    import traceback

    import torch

    from uslam_tpu_torch.solvers import compiled

    gen = torch.Generator(device=mesh.device).manual_seed(5 + mesh.rank)
    x = torch.randn(16, 8, generator=gen, device=mesh.device, dtype=torch.float64)
    flags = torch.rand(16, generator=gen, device=mesh.device) > 0.5
    out = {"ok": {}, "nodes": {}, "errors": {}}
    where = f"rank {mesh.rank} of {mesh.size}"
    for shape in NCCL_PROBE_SHAPES:
        ok, errors = True, []
        for steps in (5, 0):
            n = torch.tensor(steps, device=mesh.device)
            compiled.reset_counts()
            eager = _nccl_program(x, flags, n, mesh.group, shape)
            eager_runs = {k: list(v) for k, v in compiled.runs.items()}
            compiled.reset_counts()
            try:
                with compiled.recording_nodes():
                    graphed = compiled.call(f"probe_nccl_{shape}", _nccl_program,
                                            (x, flags, n), (mesh.group, shape), group=mesh.group)
                torch.cuda.synchronize(mesh.device)
            except Exception as e:  # the probe's finding: printed, and the check fails
                frames = traceback.extract_tb(e.__traceback__)[-3:]
                where_raised = "; ".join(f"{Path(f.filename).name}:{f.lineno} {f.line}"
                                         for f in frames)
                errors.append(f"{type(e).__name__}: {str(e).splitlines()[0]} (raised at "
                              f"{where_raised}; nodes read {dict(compiled.body_nodes)})")
                ok = False
                break
            if compiled.body_nodes:
                out["nodes"][shape] = {k: v for k, v in compiled.body_nodes.items()}
            compiled.settle_launches()
            runs = {k: list(v) for k, v in compiled.runs.items()}
            same = all(torch.equal(a, b) for a, b in zip(graphed, eager)) and runs == eager_runs
            log(f"  NCCL in conditional bodies ({where}), {shape!r} at {steps} steps: graphed = "
                f"eager bit for bit, body runs as eager: {same} (runs {runs})")
            ok = ok and same
        if errors:
            out["errors"][shape] = errors[0]
            log(f"  NCCL in conditional bodies ({where}), {shape!r}: FAILED: {errors[0]}")
        else:
            log(f"  NCCL in conditional bodies ({where}), {shape!r}: body graphs' nodes "
                f"{out['nodes'].get(shape)}")
        out["ok"][shape] = ok
    evicted = compiled.evict_group(mesh.group)
    log(f"  NCCL probe ({where}): {evicted} cached graphs of the group evicted")
    return out


def compiled_vs_eager(graph, values, cam, sig, huber, label: str) -> dict:
    """The graphed linearize_graph and graph_error against their eager
    bodies on the same inputs: bit for bit."""
    import torch

    from uslam_tpu_torch.solvers import linearize as L

    lin_g = L.linearize_graph(graph, values, cam, *sig, huber)
    lin_e = L.linearize_graph_eager(graph, values, cam, *sig, huber)
    err_g = L.graph_error(graph, values, cam, *sig, huber)
    err_e = L.graph_error_eager(graph, values, cam, *sig, huber)
    torch.cuda.synchronize()
    diffs = {f: float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
             for f, a, b in zip(lin_g._fields, lin_g, lin_e)}
    diffs["graph_error"] = float((err_g.double() - err_e.double()).abs())
    same = all(torch.equal(a, b) for a, b in zip(lin_g, lin_e)) and torch.equal(err_g, err_e)
    dtype = str(values.pose_trans.dtype)[6:]
    log(f"  graphed vs eager, {label} ({dtype}): bit-identical {same}; largest difference "
        f"{max(diffs.values())!r}" + ("" if same else f" by field {diffs}"))
    return {f"graphed linearize_graph and graph_error = eager, {label} ({dtype}), bit for bit":
            same}


def imu_block_24_rows(graph, values, gravity):
    """The linearization's IMU block as the former layout took it: ``imu_residual``
    under ``torch.func.jvp`` with the public ``preintegrate``, one kernel
    row for each of the 24 tangent rows of every interval; (r, J)."""
    from uslam_tpu_torch.factors.imu import imu_residual
    from uslam_tpu_torch.geometry.se3 import pose_retract
    from uslam_tpu_torch.solvers import linearize as L

    n_int = graph.imu.mask.shape[0]
    pose_i, vel_i, pose_j, vel_j = L._frame_pairs(values, n_int)

    def f(d):
        return imu_residual(
            pose_retract(pose_i, d[..., 0:6]), vel_i + d[..., 6:9],
            pose_retract(pose_j, d[..., 9:15]), vel_j + d[..., 15:18],
            values.bias + d[..., 18:24], graph.imu.data, gravity, graph.imu.whitener)

    r, J = L._lin(f, (n_int,), IMU_TANGENT_ROWS, values.pose_trans)
    return r * graph.imu.mask[:, None], J * graph.imu.mask[:, None, None]


def imu_block_check(graph, values, cam, sig, huber, label: str) -> dict:
    """The eager linearization's IMU block (one preintegration per
    interval) against :func:`imu_block_24_rows`, bit for bit."""
    import torch

    from uslam_tpu_torch.solvers import linearize as L

    lin = L.linearize_graph_eager(graph, values, cam, *sig, huber)
    r, J = imu_block_24_rows(graph, values, sig[2])
    ours = torch.cat([lin.imu_J_pose_i, lin.imu_J_vel_i, lin.imu_J_pose_j, lin.imu_J_vel_j,
                      lin.imu_J_bias], -1)
    same = torch.equal(lin.imu_r, r) and torch.equal(ours, J)
    dtype = str(values.pose_trans.dtype)[6:]
    log(f"  IMU block, {label} ({dtype}, {r.shape[0]} intervals): one preintegration per "
        f"interval = the 24-row path bit for bit: {same}")
    return {f"IMU block = the 24-row path bit for bit, {label} ({dtype})": same}


def kernel_rows(fn) -> list:
    """(rows, with the Jacobian) of every preintegrate launch while ``fn``
    runs (eagerly: a replayed graph calls no wrapper)."""
    from uslam_tpu_torch.factors import imu

    rows, wrapped = [], imu.preintegrate_cuda

    def recording(data, bias, jacobian=True):
        delta, jac = wrapped(data, bias, jacobian)
        rows.append((delta.delta_q.numel() // 4, jacobian))
        return delta, jac

    imu.preintegrate_cuda = recording
    try:
        fn()
    finally:
        imu.preintegrate_cuda = wrapped
    return rows


def compiled_1k(one_k: dict) -> dict:
    """On the 1k problem at its solution: the graphed linearization and
    error held to their eager bodies (float32, and float64 as the polish
    runs them), then per LM iteration the host ms of each (median of 3),
    eager (with the preintegration kernel) and graphed, the captures they
    made and the preintegration launches of one graphed call."""
    import torch

    from uslam_tpu_torch.device import cast_tree
    from uslam_tpu_torch.frontend import kernels
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.solvers import compiled
    from uslam_tpu_torch.solvers import linearize as L

    cfg, r = one_k["cfg"], one_k["result"]
    g, v = r.graph, r.values
    cam = StereoCamera.from_config(cfg.camera, device="cuda")
    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    huber = cfg.noise.stereo_huber_delta
    g64, v64, cam64 = (cast_tree(x, torch.float64, "cuda") for x in (g, v, cam))
    checks = compiled_vs_eager(g, v, cam, sig, huber, "1k")
    checks.update(compiled_vs_eager(g64, v64, cam64, sig, None, "1k"))
    checks.update(imu_block_check(g, v, cam, sig, huber, "1k"))
    checks.update(imu_block_check(g64, v64, cam64, sig, None, "1k"))
    n_int = g.imu.mask.shape[0]
    rows = {"linearize": kernel_rows(lambda: L.linearize_graph_eager(g, v, cam, *sig, huber)),
            "graph_error": kernel_rows(lambda: L.graph_error_eager(g, v, cam, *sig, huber))}
    log(f"  preintegrate launches of one eager call, (kernel rows, with the Jacobian): {rows} "
        f"for {n_int} IMU intervals (formerly {IMU_TANGENT_ROWS * n_int} rows with the Jacobian)")
    checks["1k: preintegrate launches one kernel row per IMU interval"] = rows == {
        "linearize": [(n_int, True)], "graph_error": [(n_int, False)]}
    t = {}
    for name, fn in (("linearize eager", L.linearize_graph_eager),
                     ("linearize graphed", L.linearize_graph),
                     ("graph_error eager", L.graph_error_eager),
                     ("graph_error graphed", L.graph_error)):
        t[name], _ = _median_ms(lambda fn=fn: fn(g, v, cam, *sig, huber))
    kernels.reset_launch_counts()
    before = sum(compiled.captures.values())
    L.linearize_graph(g, v, cam, *sig, huber)
    per_lin = kernels.launch_counts["preintegrate"]
    kernels.reset_launch_counts()
    L.graph_error(g, v, cam, *sig, huber)
    per_err = kernels.launch_counts["preintegrate"]
    log(f"  1k LM iteration (N={v.num_poses}, host ms, median of 3, synchronized): linearize "
        f"eager {t['linearize eager']!r}, graphed {t['linearize graphed']!r} (PERF.md section 5"
        f" before: 885.5); graph_error eager {t['graph_error eager']!r}, graphed "
        f"{t['graph_error graphed']!r} (before: 62-80); captures so far "
        f"{dict(compiled.captures)}, {sum(compiled.captures.values()) - before} by these calls; "
        f"preintegrate launches per linearization {per_lin}, per error {per_err}")
    checks["1k: one preintegrate launch per graphed linearization and per error"] = (
        per_lin == 1 and per_err == 1)
    return {"checks": checks, "ms": t, "rows": rows}


def log_graphs(label: str) -> dict:
    """Print and reset the CUDA-graph captures, replays, host reads of the
    LM's blocks and host ms of the captures (warm-up included) since the
    last call (per function)."""
    from uslam_tpu_torch.solvers import compiled

    out = {"captures": dict(compiled.captures), "replays": dict(compiled.replays),
           "reads": dict(compiled.reads), "capture_ms": dict(compiled.capture_ms)}
    log(f"  CUDA graphs, {label}: captures {out['captures']}, replays {out['replays']}, "
        f"host reads {out['reads']}, capture ms {out['capture_ms']}")
    compiled.reset_counts()
    return out


_SASS = {}


def _sass_code(lib_path: str, kernel: str):
    """[(offset, instruction)] of the function whose (mangled) name holds
    ``kernel`` in the built library's SASS (cuobjdump -sass), or None
    without cuobjdump."""
    import re

    if lib_path not in _SASS:
        cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
        if not cuobjdump.exists():
            return None
        _SASS[lib_path] = subprocess.run([str(cuobjdump), "-sass", lib_path],
                                         capture_output=True, text=True, check=True,
                                         timeout=120).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", _SASS[lib_path])
                if kernel in f.split("\n", 1)[0])
    return [(int(m.group(1), 16), m.group(2).strip())
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]


def _backward_branches(code):
    """(target, offset) of every backward branch: the loops."""
    import re

    return [(int(m.group(1), 16), off) for off, ins in code
            if (m := re.search(r"BRA\s.*?0x([0-9a-f]+)", ins)) and int(m.group(1), 16) < off]


def sass_loop_summary(lib_path: str, kernel: str = "fast_harris_kernel",
                      step_marker: str = "") -> str:
    """Static instruction count of a loop of ``kernel`` in the built
    library (cuobjdump -sass), by opcode class: what the kernel issues per
    iteration, to hold against the card's issue rate. The longest loop; or,
    with ``step_marker``, the innermost loop holding it most often and with
    the fewest calls, per occurrence (the preintegration's chain: one
    MUFU.RSQ, the norm's square root, per step; the out-of-line rerun's
    loop calls the intrinsics' slow paths)."""
    import re
    from collections import Counter

    code = _sass_code(lib_path, kernel)
    if code is None:
        return "not measured (no cuobjdump)"
    loops = _backward_branches(code)

    def count(lo_hi, what):
        return sum(what in ins for off, ins in code if lo_hi[0] <= off <= lo_hi[1])

    steps = 1
    if step_marker:
        inner = [(lo, hi) for lo, hi in loops
                 if not any(lo < a <= b < hi for a, b in loops if (a, b) != (lo, hi))]
        lo, hi = max(inner, key=lambda t: (count(t, step_marker), -count(t, "CALL")))
        steps = max(count((lo, hi), step_marker), 1)
    else:
        lo, hi = max(loops, key=lambda t: t[1] - t[0])
    ops = [re.sub(r"^@!?U?P[T0-9]\s+", "", ins).split()[0] for off, ins in code if lo <= off <= hi]
    classes = Counter(
        "fp32" if op.startswith(("FADD", "FMUL", "FFMA")) else
        "fp64" if op.startswith(("DADD", "DMUL", "DFMA")) else
        "mufu" if op.startswith("MUFU") else
        "compare" if op.startswith(("FSETP", "DSETP")) else
        "move" if op.startswith(("MOV", "IMAD.MOV")) else
        "shared" if op.startswith(("LDS", "STS")) else
        "global" if op.startswith(("LDG", "STG")) else "integer/control"
        for op in ops
    )
    if step_marker:
        return (f"{len(ops)} instructions in the loop body, {steps} step(s): "
                f"{len(ops) / steps!r} per step; {dict(classes)}")
    return f"{len(ops)} instructions in the loop body: {dict(classes)}"


def preintegrate_sass(lib_path: str) -> None:
    """Prints the preintegration chain's instructions per step for the
    kernel's four instantiations (float32 / float64, with the Jacobian /
    value only)."""
    for key, mangled in (("float32", "If"), ("float64", "Id")):
        for variant, flag in (("with the Jacobian", "Lb1E"), ("value only", "Lb0E")):
            summary = sass_loop_summary(lib_path, f"preintegrate_kernel{mangled}{flag}",
                                        step_marker="MUFU.RSQ")
            log(f"  preintegrate SASS, {key} {variant}, the chain: {summary}")


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


def load_1k() -> dict:
    """bench.py's 1k-pose problem (bench.py:279-306) on precomputed features
    and its solve by ``run_sequence`` with the default Schur +
    velocity-elimination solver: the sequence, config, packed initial
    values (numpy), the result and the run's wall s."""
    import torch

    from uslam_tpu_torch.config import SolverConfig, UslamConfig
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.pipeline import run_sequence

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
    return {"seq": seq, "cfg": cfg, "initial": initial, "result": r, "gen_s": gen_s,
            "wall": time.perf_counter() - t0}


def solve_1k(one_k: dict) -> dict:
    """bench.py's 1k-pose batch solve (bench.py:279-306, :func:`load_1k`)
    with the default Schur + velocity-elimination solver, then the f64
    polish."""
    import torch

    from uslam_tpu_torch.eval.metrics import ate_rmse
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.solvers.polish import polish_f64

    seq, cfg, initial, r = one_k["seq"], one_k["cfg"], one_k["initial"], one_k["result"]
    gen_s, wall = one_k["gen_s"], one_k["wall"]
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


def sync_debug_control() -> bool:
    """torch.cuda.set_sync_debug_mode("error") raises on a host read (a
    ``.item()``): the mode the steady keyframes run under is on."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.ones(1, device="cuda").item()
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return False


def online_pass(label: str, cfg, seq, events, left, right, **mode) -> dict:
    """Stream ``events`` through ``OnlineSlam(cfg, window=ONLINE_WINDOW,
    solve_during_fill=False, device="cuda", **mode)`` with the kernels'
    launch counts set to 0 just before; host ms and kernel launches of
    every keyframe's ``add_stereo_frame``, one steady keyframe under the
    profiler. On the device paths each steady keyframe's step, from its
    record's upload to its packed output (``_dispatch``), runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host read raises."""
    import numpy as np
    import torch

    from uslam_tpu_torch.frontend import kernels
    from uslam_tpu_torch.online import OnlineSlam
    from uslam_tpu_torch.solvers import compiled

    online = OnlineSlam(cfg, window=ONLINE_WINDOW, solve_during_fill=False, device="cuda", **mode)
    guard = {"on": False, "calls": 0}
    target = online if online.fused else online.smoother if online.device_resident else None
    if target is not None:
        dispatch = target._dispatch

        def guarded(*args, **kwargs):
            if not guard["on"]:
                return dispatch(*args, **kwargs)
            guard["calls"] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return dispatch(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        target._dispatch = guarded
    call_ms, kf_launches, profiled, last = {}, {}, None, None
    # CUDA-graph captures and LM host reads up to the first marginalization
    # (keyframe ONLINE_WINDOW): the device-resident paths capture the steady
    # step's graphs there, so no steady keyframe captures, and their window
    # LM reads nothing on the host.
    captures_at = reads_at = None
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
        else:
            k = online.keyframes
            guard["on"] = k > ONLINE_WINDOW
            before = dict(kernels.launch_counts)
            if k == ONLINE_WINDOW + 1 + ONLINE_PROFILED_STEADY and profiled is None:
                profiled = profile_call(lambda: online.add_stereo_frame(t, left[i], right[i]))
            else:
                ts = time.perf_counter()
                online.add_stereo_frame(t, left[i], right[i])
                if online.keyframes > k:
                    call_ms[k] = (time.perf_counter() - ts) * 1e3
            guard["on"] = False
            if online.keyframes > k:
                kf_launches[k] = {n: kernels.launch_counts[n] - before[n] for n in before}
                last = (t, i)
        if captures_at is None and online.keyframes == ONLINE_WINDOW + 1:
            # One host read here, before the steady keyframes: the LM's
            # body runs so far.
            compiled.settle_launches()
            captures_at = sum(compiled.captures.values())
            reads_at = sum(compiled.reads.values())
            runs_at = {k: list(v) for k, v in compiled.runs.items()}
    online.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    compiled.settle_launches()
    launches = dict(kernels.launch_counts)
    steady_captures = sum(compiled.captures.values()) - captures_at
    steady_reads = sum(compiled.reads.values()) - reads_at
    n_steady = online.keyframes - ONLINE_WINDOW - 1

    def steady_runs(name):
        return [a - b for a, b in zip(compiled.runs.get(name, [0, 0]),
                                      runs_at.get(name, [0, 0]))]
    traj = online.trajectory()
    n = len(traj)
    # Steady state: from the second marginalization on (keyframe
    # ONLINE_WINDOW + 1), where every mode runs its own steady step.
    steady = [ms for k, ms in call_ms.items() if k > ONLINE_WINDOW]
    timings = online.timings[ONLINE_WINDOW + 1:]
    keys = ("frontend_ms", "triangulate_ms", "graph_ms", "record_ms", "solve_ms", "fetch_ms",
            "dispatch_ms", "harvest_wait_ms", "harvest_ms")
    split = {k: float(np.median([e[k] for e in timings])) for k in keys
             if timings and all(k in e for e in timings)}
    iters = [e["lm_iters"] for e in timings if "lm_iters" in e]
    # The steady keyframes' window LMs: the loop's body runs (its
    # iterations: no masked step) and the re-linearization's branches; each
    # solve also linearizes once before its loop.
    lm_steps, (taken, rejected) = steady_runs("lm_step")[0], steady_runs("lm_linearize")
    gt, odom = seq.gt_pos[:n], seq.dvl_pose_pos[:n]
    from uslam_tpu_torch.eval.metrics import ate_rmse

    out = {
        "label": label, "online": online, "traj": traj, "keyframes": online.keyframes,
        "launches": launches, "wall_s": wall, "steady": len(steady),
        "median_ms": float(np.median(steady)), "p90_ms": float(np.percentile(steady, 90)),
        "lm_iters": float(np.median(iters)) if iters else float("nan"),
        "ate": ate_rmse(traj, gt), "ate_odom": ate_rmse(odom, gt), "profiled": profiled,
        "captures": dict(compiled.captures), "steady_captures": steady_captures,
        "steady_reads": steady_reads, "first_marginal_ms": call_ms.get(ONLINE_WINDOW),
        "max_ms": max(call_ms.values()), "max_at": max(call_ms, key=call_ms.get),
        "kf_launches": kf_launches, "guarded": guard["calls"], "last": last,
        "steady_lm_iters": lm_steps / n_steady, "steady_linearizations": 1 + taken / n_steady,
        "steady_lm_iters_sum": sum(iters), "steady_lm_runs": lm_steps,
    }
    front = ("fast_harris", "hamming", "jacobi_eigh")
    log(f"online pass {label}: {out['keyframes']} keyframes ({out['steady']} steady, one more "
        f"profiled) in {wall!r} s = {out['keyframes'] / wall!r} keyframes/s; steady ms per "
        f"keyframe median {out['median_ms']!r}, p90 {out['p90_ms']!r}; launches {launches}")
    log(f"  keyframe {ONLINE_WINDOW} (the first marginalization, where the device paths "
        f"capture the steady step's graphs): {out['first_marginal_ms']!r} ms beside the steady "
        f"median {out['median_ms']!r} and p90 {out['p90_ms']!r}; the slowest timed keyframe "
        f"{out['max_ms']!r} ms (keyframe {out['max_at']})")
    log(f"  launches per keyframe (fast_harris, hamming, jacobi_eigh): "
        f"{[tuple(kf_launches[k][f] for f in front) for k in sorted(kf_launches)]}; steady "
        f"steps run under the sync check: {guard['calls']}")
    log(f"  steady split, medians (ms): {split}; LM iterations, median {out['lm_iters']!r} "
        f"(max {max(iters) if iters else None}); per steady keyframe ({n_steady}): LM iterations "
        f"{out['steady_lm_iters']!r} (steps run {lm_steps}, the outputs' iterations "
        f"{sum(iters)}), linearizations {out['steady_linearizations']!r} (1 + {taken} accepted "
        f"steps over the {n_steady}; {rejected} rejected)")
    log(f"  CUDA graphs: captures so far in the phase {out['captures']}, {steady_captures} of "
        f"them on or after the first steady keyframe; LM host reads in the steady keyframes "
        f"{steady_reads}; preintegrate launches "
        f"{launches['preintegrate']} ({launches['preintegrate'] / online.keyframes!r} per "
        f"keyframe)")
    log(f"  ATE vs ground truth {out['ate']!r} m; DVL odometry {out['ate_odom']!r} m "
        f"(same {n} keyframes); host ms of every timed keyframe: "
        f"{[round(ms, 1) for ms in call_ms.values()]}")
    if profiled:
        log(f"  one steady keyframe under torch.profiler: host wall {profiled['wall_ms']!r} ms, "
            f"device {profiled['device_ms']!r} ms (busy {profiled['busy']!r}), "
            f"{profiled['kernels']} kernels, {profiled['copies']} copies (the profiled call took "
            f"{profiled['profiler_s']!r} s in all); the window LM's kernels, inside conditional "
            f"nodes' bodies, are not in the trace")
    return out


def steady_step_check(p: dict, cfg, left, right) -> dict:
    """After a device pass: its steady step, graphed (the cached graphs: no
    capture) against eager (``graphed=False``) on the same inputs (the
    pass's final window and front-end state, its last pair and a record),
    bit for bit; then the Jacobi kernel against its plain version on that
    window's marginal (the matrix the step hands ``sym_eigh``), and the
    kernel's time on it beside its bound, the plain version's and
    torch.linalg.eigh's."""
    import numpy as np
    import torch

    from uslam_tpu_torch.solvers import compiled
    from uslam_tpu_torch.solvers import fixed_lag as fl
    from uslam_tpu_torch.solvers.lm import solve_lm

    o = p["online"]
    sm = o.smoother
    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    t, i = p["last"]
    if o.fused:
        pair = torch.from_numpy(np.stack([left[i], right[i]])).cuda()
        rec = fl.upload(o._fused_record(t, None, None), "cuda")
        args = (sm._dev_state, o._fe_state, pair, rec, sm.cam, o.frontend.kvec,
                o.frontend.ransac_idx, *sig, o._steady_solver, cfg.frontend)
        captures = sum(compiled.captures.values())
        g = fl.fused_keyframe_step(*args)
        recaptured = sum(compiled.captures.values()) - captures
        e = fl.fused_keyframe_step(*args, graphed=False)
        leaves_g, leaves_e = [*g[0], *g[1], g[2]], [*e[0], *e[1], e[2]]
        graph, initial = fl.fused_front(*args[:7], cfg.frontend)[:2]
    else:
        rec = fl.upload(sm._frame_record_arrays(sm._frames[-1]), "cuda")
        args = (sm._dev_state, rec, sm.cam, *sig, sm.steady_solver)
        captures = sum(compiled.captures.values())
        g = fl.window_step(*args)
        recaptured = sum(compiled.captures.values()) - captures
        e = fl.window_step(*args, graphed=False)
        leaves_g, leaves_e = [*g[0], g[1]], [*e[0], e[1]]
        graph, initial = fl.device_window_graph(sm._dev_state, rec)
    same = all(torch.equal(a, b) for a, b in zip(leaves_g, leaves_e))
    log(f"  {p['label']}: the steady step on its last window, graphed = eager bit for bit: "
        f"{same} ({len(leaves_g)} leaves); captures {recaptured}")
    values, _ = solve_lm(graph, initial, sm.cam, *sig, o._steady_solver)
    lam = fl.marginal_information(graph, values, sm.cam, *sig)
    A = 0.5 * (lam + lam.T)
    r = jacobi_compare(f"{p['label']}'s last window marginal", A)
    r.update(jacobi_times(A, f"{p['label']}'s last window marginal"))
    return {"same": same, "recaptured": recaptured, "jacobi": r}


def online_inputs(seq) -> tuple:
    """The stream's messages up to ONLINE_SECONDS and its frames as uint8,
    as a camera gives them: (events, left, right)."""
    import numpy as np

    events = online_events(seq, ONLINE_SECONDS)
    frames = sorted({i for kind, _, i in events if kind == "frame"})
    left = {i: np.clip(seq.images_left[i], 0, 255).astype(np.uint8) for i in frames}
    right = {i: np.clip(seq.images_right[i], 0, 255).astype(np.uint8) for i in frames}
    log(f"online stream: {ONLINE_SECONDS} s, {len(frames)} stereo frames "
        f"{left[frames[0]].shape} uint8, {len(events)} messages; window {ONLINE_WINDOW}, "
        f"solve_during_fill=False, max_update_iters=4")
    return events, left, right


def online_phase(seq, cfg) -> dict:
    """Phase 8: the first ONLINE_SECONDS of the phase-3 dive streamed
    through OnlineSlam on the card: (a) the host smoother with the
    per-frame front end, (b) pipelined (fused, device-resident), (c) the
    split device-resident path."""
    import numpy as np

    t_phase = time.perf_counter()
    events, left, right = online_inputs(seq)
    a = online_pass("(a) host smoother", cfg, seq, events, left, right)
    g, vals = a["online"].smoother._window_graph()
    from uslam_tpu_torch.geometry.camera import StereoCamera

    window_checks = compiled_vs_eager(
        g, vals, StereoCamera.from_config(cfg.camera, device="cuda"),
        (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity),
        cfg.noise.stereo_huber_delta, "(a)'s last online window")
    window_checks.update(imu_block_check(
        g, vals, StereoCamera.from_config(cfg.camera, device="cuda"),
        (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity),
        cfg.noise.stereo_huber_delta, "(a)'s last online window"))
    per_lm = np.bincount(g.stereo.lm_obs_mask.sum(1).long().cpu().numpy())
    log(f"  (a)'s last window: landmarks by observation count "
        f"{dict((k, int(c)) for k, c in enumerate(per_lm) if k and c)}")
    b = online_pass("(b) pipelined", cfg, seq, events, left, right, pipelined=True)
    b_step = steady_step_check(b, cfg, left, right)
    c = online_pass("(c) device-resident", cfg, seq, events, left, right, device_resident=True)
    c_step = steady_step_check(c, cfg, left, right)
    passes = (a, b, c)
    div = {p["label"]: float(np.linalg.norm(p["traj"] - a["traj"], axis=1).max()) for p in (b, c)}
    log(f"  divergence from (a), max over keyframes (m): {div}")
    log(f"online phase: {time.perf_counter() - t_phase!r} s")
    checks = dict(window_checks)
    checks["online: the sync check's mode raises on a host read"] = sync_debug_control()
    front = ("fast_harris", "hamming", "jacobi_eigh")
    for p in passes:
        name = p["label"]
        launches = p["launches"]
        kf = p["kf_launches"]
        device = p is not a
        # The priming at the first marginal (keyframe ONLINE_WINDOW): the
        # smoother's window step (the tail's warm-up and replay: 2
        # jacobi_eigh) and, on the fused path, one fused step (the front
        # graph's warm-up and replay: 6 fast_harris, 2 hamming; the tail's
        # replay: 1 jacobi_eigh).
        primed = (3 * (1 + 2 * (p is b)), 1 + 2 * (p is b), (2 + (p is b)) * device)
        expected = {k: (3, 1, int(device and k > ONLINE_WINDOW)) if k != ONLINE_WINDOW else primed
                    for k in kf}
        checks[f"online {name}: launches per keyframe: fast_harris 3, hamming 1, jacobi_eigh "
               f"{int(device)} per steady keyframe; {primed} at keyframe {ONLINE_WINDOW}"] = (
            sorted(kf) == list(range(p["keyframes"]))
            and all(tuple(kf[k][f] for f in front) == expected[k] for k in kf)
            and all(launches[f] == sum(d[f] for d in kf.values()) for f in front))
        checks[f"online {name}: preintegrate launched"] = launches["preintegrate"] > 0
        checks[f"online {name}: trajectory finite, one row per keyframe"] = (
            p["traj"].shape == (p["keyframes"], 3) and bool(np.isfinite(p["traj"]).all()))
        checks[f"online {name}: ATE <= {ONLINE_ATE_VS_ODOM} x the DVL odometry's"] = (
            p["ate"] <= ONLINE_ATE_VS_ODOM * p["ate_odom"])
        checks[f"online {name}: at least 8 steady keyframes"] = p["steady"] >= 8
    checks["online: keyframes equal across passes"] = len({p["keyframes"] for p in passes}) == 1
    for p, step in ((b, b_step), (c, c_step)):
        checks[f"online {p['label']}: no CUDA-graph capture on or after the first steady "
               "keyframe"] = p["steady_captures"] == 0 and step["recaptured"] == 0
        checks[f"online {p['label']}: the window LM reads nothing on the host"] = (
            p["steady_reads"] == 0)
        checks[f"online {p['label']}: every steady step ran under set_sync_debug_mode('error') "
               "with no host read"] = p["guarded"] == p["steady"] + 1
        checks[f"online {p['label']}: the graphed steady step = the eager one, bit for bit"] = (
            step["same"])
        checks[f"online {p['label']}: jacobi_eigh bit-identical to its plain version on the "
               "last window marginal"] = step["jacobi"]["same"]
    checks["online (b): no pending keyframe after flush()"] = b["online"]._pending is None
    checks["online (b): fused steps ran"] = any(e.get("pipelined") for e in b["online"].timings)
    checks[f"online (b) within {ONLINE_DIVERGENCE_M} m of (a)"] = div[b["label"]] < ONLINE_DIVERGENCE_M
    return {"checks": checks, "launches": a["launches"], "passes": passes,
            "jacobi": {p["label"]: step["jacobi"] for p, step in ((b, b_step), (c, c_step))}}


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


def survey_problem(n_poses: int) -> tuple:
    """bench.py's scaling entry (bench.py:541-552) at ``n_poses``: the
    sequence (precomputed features) and the banded solver's config."""
    from uslam_tpu_torch.config import SolverConfig, UslamConfig
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence

    seq = generate_synthetic_sequence(SyntheticSpec(
        trajectory="survey", duration=n_poses / 5.0, keyframe_rate=5.0,
        num_landmarks=max(512, n_poses), omega=0.15, max_feature_depth=10.0,
        odom_drift_rate=0.02, feature_noise_px=0.3, seed=0,
    ))
    cfg = UslamConfig(solver=SolverConfig(
        max_iterations=50, plateau_patience=3, relative_error_tol=1e-5, reduced_solver="banded"))
    return seq, cfg


def survey_solve(n_poses: int) -> dict:
    """bench.py's scaling entry (bench.py:541-628) at ``n_poses`` on the card,
    then its float64 certificate (bench.py:630-700) by the banded polish."""
    import numpy as np
    import torch

    from uslam_tpu_torch.eval.metrics import ate_rmse
    from uslam_tpu_torch.factors.imu import preintegrate_cuda
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.interop import to_port
    from uslam_tpu_torch.pipeline import AUVSlam, banded_solver_config
    from uslam_tpu_torch.solvers.banded import auto_panel, solve_schur_banded
    from uslam_tpu_torch.solvers.linearize import linearize_graph
    from uslam_tpu_torch.solvers.polish import polish_f64

    t0 = time.perf_counter()
    seq, cfg = survey_problem(n_poses)
    gen_s = time.perf_counter() - t0
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
    # The preintegration kernel at the survey's layouts: the linearizer's
    # (one row per interval, with the Jacobian), the error's (value only),
    # and the former one (24 rows per interval).
    data, b6 = graph.imu.data, r.values.bias
    n_int = data.acc.shape[0]
    preint_ms = cuda_ms(lambda: preintegrate_cuda(data, b6), KERNEL_REPS)
    preint_err_ms = cuda_ms(lambda: preintegrate_cuda(data, b6, jacobian=False), KERNEL_REPS)
    b24 = b6 + torch.zeros((IMU_TANGENT_ROWS, n_int, 6), dtype=b6.dtype, device="cuda")
    preint24_ms = cuda_ms(lambda: preintegrate_cuda(data, b24), KERNEL_REPS)
    preint_bound, preint_by = bound_ms(*preint_bytes_ops(data, b6))
    err_bound, _ = bound_ms(*preint_bytes_ops(data, b6, jacobian=False))
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
        f"solve {t_solve!r}; preintegrate kernel (float32, {data.acc.shape[1]} samples per "
        f"interval): {n_int} rows + Jacobian {preint_ms!r} ms, bound {preint_bound!r} ms "
        f"({preint_by}), share {preint_bound / preint_ms!r}; value only {preint_err_ms!r} ms, "
        f"bound {err_bound!r} ms; formerly {IMU_TANGENT_ROWS * n_int} rows {preint24_ms!r} ms")
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
        "n": n, "graph": graph, "initial": initial, "values": r.values, "cfg": cfg, "cost": cost,
        "preint_ms": preint_ms, "preint_err_ms": preint_err_ms, "preint24_ms": preint24_ms,
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


def survey_phase() -> tuple:
    """Phase 9: the survey sizes on the banded solver, the banded step held
    to the Schur step at the first size, and the long-track a0 graph.
    Returns (checks, the first size's graph, solution and config, with the
    preintegration kernel's ms at each size)."""
    import torch

    from uslam_tpu_torch.config import UslamConfig
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.interop import to_port
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.solvers.banded import measure_band_width, measure_corr_window

    t_phase = time.perf_counter()
    checks, preint_ms = {}, {}
    for i, n_poses in enumerate(SURVEY_POSES):
        res = survey_solve(n_poses)
        checks.update(res["checks"])
        preint_ms[n_poses] = {k: res[k] for k in ("preint_ms", "preint_err_ms", "preint24_ms")}
        if i == 0:
            rel = banded_vs_schur(res["graph"], res["values"], res["cfg"], f"survey {n_poses}")
            checks[f"survey {n_poses}: banded step = Schur step (relative < {BANDED_STEP_RTOL})"] = (
                rel < BANDED_STEP_RTOL)
            first = {k: res[k] for k in ("graph", "initial", "values", "cfg")}
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
    first["preint_ms"] = preint_ms
    return checks, first


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
            f"klt: fast_harris {levels} and hamming 1 launches per frame": {
                f: k["launches"][f] for f in ("fast_harris", "hamming")} == {
                "fast_harris": levels * n_frames, "hamming": n_frames},
            "klt: preintegrate launched": k["launches"]["preintegrate"] > 0,
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
        "bag": bag, "written": written, "launches": launches, "clip": clip,
        "checks": {
            "ingest (a): bag frames equal the uint8 source": frames_equal,
            "ingest (a): bag sensor arrays equal the source": data_equal,
            f"ingest (a): bag stamps within {BAG_STAMP_S} s": stamp_err <= BAG_STAMP_S,
            "ingest (a): features from the decoded bag equal those in memory": features_equal,
            # The first run captures the solve's CUDA graphs (one eager
            # warm-up call each, whose launches count); the second replays
            # them. So the front end's launches are held equal, and the
            # preintegration's only to have run.
            "ingest (a): front-end launches on the decoded bag equal those in memory": (
                all(launches[f] == ref_launches[f] for f in ("fast_harris", "hamming"))
                and launches["fast_harris"] > 0),
            "ingest (a): preintegrate launched by both runs": (
                launches["preintegrate"] > 0 and ref_launches["preintegrate"] > 0),
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
            f"per frame": {k: launches[k] for k in ("fast_harris", "hamming")} == {
                "fast_harris": cfg.frontend.pyramid_levels * n_kf, "hamming": n_kf},
            "cli (c): run launches preintegrate": launches["preintegrate"] > 0,
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
    return {"checks": checks, "bag_launches": a["launches"], "cli_klt_launches": c["launches"],
            "clip": a["clip"]}


# ---- phase 12: multi-device execution ----------------------------------------


def _tree_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def _device_ms_by(fn, keep) -> tuple:
    """(device ms of the kernels whose name ``keep`` accepts, their count,
    device ms of all kernels) of one synchronized call of ``fn`` under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kept_ms, kept_n, all_ms = 0.0, 0, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("Activity Buffer"):
            ms = e.time_range.elapsed_us() / 1e3
            all_ms += ms
            if keep(e.name):
                kept_ms += ms
                kept_n += 1
    return kept_ms, kept_n, all_ms


def _is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def chunk_reference(pairs_np, cfg):
    """``orb_chunk_step`` on uint8 pairs (C, 2, H, W) as the offline
    tracker's first chunk runs it (``StereoFrontend.process_chunk``, no
    gyro): (kp_left, kp_right, stereo idx, stereo mask)."""
    import torch

    from uslam_tpu_torch.frontend.tracker import StereoFrontend, orb_chunk_step

    fe = StereoFrontend(cfg.camera, cfg.frontend, device="cuda")
    pairs = torch.from_numpy(pairs_np).cuda().to(torch.float32)
    rot = torch.zeros((pairs_np.shape[0], 3), device="cuda")
    return orb_chunk_step(pairs, fe._prev, cfg.frontend, rot, fe.kvec, fe.ransac_idx)[:4]


def parallel_one_rank(one_k: dict, survey: dict, pairs_np, cfg_fe) -> dict:
    """Phase 12 (a): an NCCL group of one rank on cuda:0 in this process;
    every collective runs and is an identity. The 1k and the 2000-pose
    banded survey's sharded solves graphed (one graph per solve, the
    collectives in the WHILE body) against eager blocks of one step and the
    single-device solves, bit for bit; ``sharded_lm_step`` graphed against
    eager, Cholesky and banded; ``collectives.wait`` bounded by the group's
    timeout; after ``close_mesh`` no cached graph holds the group.
    ``pairs_np`` (C, 2, H, W) uint8 go through the front end with
    ``cfg_fe`` (a UslamConfig)."""
    import datetime

    import torch
    import torch.distributed as dist

    from uslam_tpu_torch import collectives
    from uslam_tpu_torch.frontend import kernels
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.graph.values import values_retract
    from uslam_tpu_torch.interop import to_port
    from uslam_tpu_torch.parallel import (
        extract_orb_frames_sharded,
        make_mesh,
        process_stereo_pairs_sharded,
        shard_landmarks,
        sharded_lm_step,
    )
    from uslam_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, close_mesh
    from uslam_tpu_torch.pipeline import banded_solver_config
    from uslam_tpu_torch.solvers import compiled
    from uslam_tpu_torch.solvers.banded import solve_schur_banded
    from uslam_tpu_torch.solvers.linearize import linearize_graph
    from uslam_tpu_torch.solvers.lm import optimize_lm
    from uslam_tpu_torch.solvers.schur import solve_schur

    mesh = make_mesh(0, 1, "cuda:0")
    group = mesh.group
    checks, out = {}, {}

    def held(key) -> bool:
        return key[3] is not None and key[3][0] is group

    def step_modes(*args, **kw) -> tuple:
        """``sharded_lm_step`` graphed (its capture), eagerly, graphed again
        (a replay); (graphed, eager, host ms of the replay, of eager)."""
        res, ms = {}, {}
        for mode in (True, False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[mode] = sharded_lm_step(*args, graphed=mode, **kw)
            torch.cuda.synchronize()
            ms[mode] = (time.perf_counter() - t0) * 1e3
        return res[True], res[False], ms[True], ms[False]

    try:
        # -- the 1k solve, landmark-sharded, against phase 7's solve --------------
        cfg, r = one_k["cfg"], one_k["result"]
        sc = cfg.solver
        huber = cfg.noise.stereo_huber_delta
        cam = StereoCamera.from_config(cfg.camera, device="cuda")
        sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
        graph, values = shard_landmarks(r.graph, to_port(one_k["initial"], "cuda"), mesh)
        # Phase 7's solve was the process's first; time a warm one beside it.
        optimize_lm(r.graph, values, cam, *sig, sc, huber)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, single = optimize_lm(r.graph, values, cam, *sig, sc, huber)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3
        log("multi-device (a): NCCL, one rank on cuda:0, in this process")
        pair = lm_graph_pair("1k sharded_optimize_lm (world size 1)", graph, values, cam, sig,
                             huber, sc, mesh=mesh)
        checks.update({f"multi-device (a): {k}": v for k, v in pair["checks"].items()})
        vals, stats = pair["values"], pair["stats"]
        out["1k"] = dict(pair, single_ms=single_ms, single_it=single.iterations)
        launches = {"sharded_lm": pair["launches"]}
        n, m = values.num_poses, values.num_landmarks
        corr_bytes = (6 * n) ** 2 * 8 + 6 * n * 8
        gather_bytes = 3 * m * 8
        lin = linearize_graph(graph, vals, cam, *sig, huber)

        def solve():
            return solve_schur(lin, graph.stereo, n, m, sc.lambda_initial,
                               refine_iters=sc.refine_iters, jitter=sc.cholesky_jitter,
                               diag_damping=True, eliminate_velocities=True, group=mesh.group)

        solve()
        nccl_ms, nccl_n, solve_ms = _device_ms_by(solve, _is_nccl)
        it = max(stats.iterations, 1)
        log(f"  1k sharded, host ms per iteration: graphed {pair['graphed_ms'] / it!r}, eager "
            f"blocks of 1 {pair['eager1_ms'] / it!r}, the single-device graphed solve just "
            f"before {single_ms / max(single.iterations, 1)!r} ({single.iterations} iterations); "
            f"host reads per solve graphed {pair['reads']}, eager {pair['eager1_reads']}; "
            f"capture ms {pair['capture_ms']!r}; error {stats.final_error!r} (phase 7 "
            f"{r.stats.final_error!r}); launches {launches['sharded_lm']}")
        log(f"  collectives per LM iteration: all-reduce of H_corr + g_corr {corr_bytes} B "
            f"(6N = {6 * n}, float64), all-gather of the landmark delta {gather_bytes} B, "
            f"broadcast of the error 4 B; one sharded solve_schur at the solution: NCCL "
            f"kernels {nccl_n}, {nccl_ms!r} ms of its {solve_ms!r} ms device time")
        checks["multi-device (a): 1k sharded LM, graphed, = phase 7's LM (iterations, final "
               "error, values bit-identical)"] = (
            stats.iterations == r.stats.iterations and stats.final_error == r.stats.final_error
            and _tree_equal(vals, r.values))
        del lin, vals, pair
        # One Cholesky step (the 1k's reduced solver) at the initial values.
        kw1 = dict(refine_iters=sc.refine_iters, jitter=sc.cholesky_jitter, diag_damping=True,
                   eliminate_velocities=True)
        lin = linearize_graph(r.graph, values, cam, *sig)
        ref = values_retract(values, solve_schur(lin, r.graph.stereo, n, m, sc.lambda_initial,
                                                 **kw1))
        del lin
        step_g, step_e, g_ms, e_ms = step_modes(graph, values, cam, *sig, sc.lambda_initial,
                                                mesh, **kw1)
        log(f"  1k Cholesky sharded_lm_step: graphed {g_ms!r} ms (replay), eager {e_ms!r} ms")
        checks["multi-device (a): 1k Cholesky sharded step, graphed, = single-device step "
               "(bit-identical)"] = _tree_equal(step_g, ref)
        checks["multi-device (a): 1k Cholesky sharded step graphed = eager "
               "(bit-identical)"] = _tree_equal(step_g, step_e)
        del step_g, step_e, ref, graph, values

        # -- the 2000-pose survey, banded: the sharded solve and one step ----------
        sgraph, svalues, sinit = survey["graph"], survey["values"], survey["initial"]
        scfg = banded_solver_config(survey["cfg"].solver, sgraph)
        shuber = survey["cfg"].noise.stereo_huber_delta
        n, m = svalues.num_poses, svalues.num_landmarks
        kw = dict(refine_iters=scfg.banded_refine_iters, jitter=scfg.cholesky_jitter,
                  diag_damping=True)
        lam, bw, cw = scfg.lambda_initial, scfg.band_width, scfg.banded_corr_window
        scam = StereoCamera.from_config(survey["cfg"].camera, device="cuda")
        ssig = (survey["cfg"].noise.dvl_sigma, survey["cfg"].noise.stereo_sigma,
                survey["cfg"].imu.gravity)
        ref_vals, ref_stats = optimize_lm(sgraph, sinit, scam, *ssig, scfg, shuber)
        g_loc, v_loc = shard_landmarks(sgraph, sinit, mesh)
        spair = lm_graph_pair(f"survey {n} banded sharded_optimize_lm (world size 1)", g_loc,
                              v_loc, scam, ssig, shuber, scfg, mesh=mesh)
        checks.update({f"multi-device (a): {k}": v for k, v in spair["checks"].items()})
        checks[f"multi-device (a): survey {n} banded sharded LM, graphed, = the single-device "
               "graphed solve (statistics, values bit-identical)"] = (
            spair["stats"] == ref_stats and _tree_equal(spair["values"], ref_vals))
        out["survey"] = spair
        del spair, ref_vals
        lin = linearize_graph(sgraph, svalues, scam, *ssig)
        ref = values_retract(svalues, solve_schur_banded(
            lin, sgraph.stereo, n, m, lam, bw, corr_window=cw, **kw))
        del lin
        g_loc, v_loc = shard_landmarks(sgraph, svalues, mesh)
        step_g, step_e, g_ms, e_ms = step_modes(g_loc, v_loc, scam, *ssig, lam, mesh,
                                                reduced_solver="banded", band_w=bw,
                                                corr_window=cw, **kw)
        band_bytes = n * (bw + 1) * 36 * 8 + n * 6 * 8
        log(f"  survey {n} banded sharded_lm_step: graphed {g_ms!r} ms (replay), eager "
            f"{e_ms!r} ms; all-reduce of the correction band {band_bytes} B (N={n}, "
            f"band_w {bw}, float64), all-gather of the landmark delta {3 * m * 8} B")
        checks[f"multi-device (a): survey {n} banded sharded step, graphed, = single-device "
               "step (bit-identical)"] = _tree_equal(step_g, ref)
        checks[f"multi-device (a): survey {n} banded sharded step graphed = eager "
               "(bit-identical)"] = _tree_equal(step_g, step_e)
        del step_g, step_e, ref, g_loc, v_loc

        # -- the front end, frame-parallel ------------------------------------------
        ref = chunk_reference(pairs_np, cfg_fe)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        kp_l, kp_r, idx, mask = process_stereo_pairs_sharded(
            pairs_np[:, 0], pairs_np[:, 1], mesh, cfg_fe.frontend)
        torch.cuda.synchronize()
        pairs_ms = (time.perf_counter() - t0) * 1e3
        launches["pairs"] = dict(kernels.launch_counts)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        frames = extract_orb_frames_sharded(pairs_np[:, 0], mesh, cfg_fe.frontend)
        torch.cuda.synchronize()
        frames_ms = (time.perf_counter() - t0) * 1e3
        launches["frames"] = dict(kernels.launch_counts)
        c, levels = pairs_np.shape[0], cfg_fe.frontend.pyramid_levels
        log(f"  front end on {c} uint8 pairs {pairs_np.shape[2:]}: process_stereo_pairs_sharded "
            f"{pairs_ms!r} ms, launches {launches['pairs']}; extract_orb_frames_sharded "
            f"{frames_ms!r} ms, launches {launches['frames']}; stereo matches "
            f"{int(mask.sum())} of {int(kp_l.mask.sum())} left keypoints")
        checks["multi-device (a): sharded stereo pairs = orb_chunk_step (keypoints, "
               "descriptors, stereo idx and mask exact)"] = (
            _tree_equal(kp_l, ref[0]) and _tree_equal(kp_r, ref[1])
            and torch.equal(idx, ref[2]) and torch.equal(mask, ref[3]))
        checks["multi-device (a): sharded frames = orb_chunk_step's left keypoints"] = (
            _tree_equal(frames, ref[0]))
        checks[f"multi-device (a): launches per call: pairs fast_harris {levels} hamming 1, "
               f"frames fast_harris {levels} hamming 0"] = (
            launches["pairs"] == {"fast_harris": levels, "hamming": 1, "preintegrate": 0,
                                  "jacobi_eigh": 0, "graph_cond": 0}
            and launches["frames"] == {"fast_harris": levels, "hamming": 0, "preintegrate": 0,
                                       "jacobi_eigh": 0, "graph_cond": 0})
        checks["multi-device (a): the sharded LM launches preintegrate"] = (
            launches["sharded_lm"]["preintegrate"] > 0)
        out["frontend"] = [a.cpu() for a in (*kp_l, *kp_r, idx, mask)]
        out["launches"] = launches

        # -- the host's wait after a replay, bounded by the group's timeout ---------
        limit = collectives.timeout_s(group, mesh.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        collectives.wait(group, mesh.device, "idle stream")
        idle_ms = (time.perf_counter() - t0) * 1e3
        short = dist.new_group([0], timeout=datetime.timedelta(seconds=WAIT_PROBE_TIMEOUT_S))
        x = collectives.all_reduce_sum(torch.ones(1, device=mesh.device), short)
        torch.cuda.synchronize()
        torch.cuda._sleep(WAIT_PROBE_CYCLES)
        t0 = time.perf_counter()
        try:
            collectives.wait(short, mesh.device, "busy stream")
            err = None
        except Exception as e:  # noqa: BLE001 - printed and checked
            err = e
        waited_s = time.perf_counter() - t0
        busy_after = not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
        busy_s = time.perf_counter() - t0
        dist.destroy_process_group(short)
        del x, short
        log(f"  collectives.wait: group timeout read {limit!r} s (make_mesh's "
            f"{DEFAULT_TIMEOUT_S!r}); idle stream {idle_ms!r} ms; busy stream, group timeout "
            f"{WAIT_PROBE_TIMEOUT_S} s: {err!r} after {waited_s!r} s, stream still busy then "
            f"{busy_after}, its work ended {busy_s!r} s after the wait began")
        checks[f"multi-device (a): collectives.wait reads the group's timeout "
               f"({DEFAULT_TIMEOUT_S} s) and returns at once on an idle stream"] = (
            limit == DEFAULT_TIMEOUT_S and idle_ms < 100)
        checks[f"multi-device (a): collectives.wait on a stream busy past a "
               f"{WAIT_PROBE_TIMEOUT_S} s group timeout raises RuntimeError then, the stream "
               "still busy"] = (
            type(err) is RuntimeError and "timeout" in str(err)
            and WAIT_PROBE_TIMEOUT_S <= waited_s < 4 * WAIT_PROBE_TIMEOUT_S and busy_after)
        held_before = sum(map(held, compiled._CACHE))
    finally:
        close_mesh(mesh)
    left = sum(map(held, compiled._CACHE))
    log(f"  close_mesh: {held_before} cached graphs held the group before, {left} after")
    checks["multi-device (a): after close_mesh no cached graph holds the group"] = (
        held_before > 0 and left == 0)
    out["checks"] = checks
    return out


def _probe_rank(mesh) -> dict:
    """Phase 12 (b), one NCCL rank: the collective probe."""
    return nccl_probe(mesh)


def _parallel_rank(mesh, graph, initial, cam_cfg, sig, huber, solver_cfg, pairs_np, fcfg):
    """Phase 12 (b), one NCCL rank: the float64 1k LM graphed (the
    process's first solve, with its capture, then a warm one) and in eager
    blocks of one step, with each one's wall s and host reads, the
    capture's host ms; the same over ``PARALLEL_BLOCKS_ITERS`` iterations
    (more than one block); the NCCL device ms of one sharded solve at its
    end, and the ms of one H_corr all-reduce alone; the front end."""
    import torch
    import torch.distributed as dist

    from uslam_tpu_torch.device import cast_tree
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.parallel import (
        process_stereo_pairs_sharded,
        shard_landmarks,
        sharded_optimize_lm,
    )
    from uslam_tpu_torch.solvers import compiled
    from uslam_tpu_torch.solvers.linearize import linearize_graph
    from uslam_tpu_torch.solvers.schur import solve_schur

    cam = StereoCamera.from_config(cam_cfg, device=mesh.device, dtype=torch.float64)
    g, v = shard_landmarks(graph, initial, mesh)

    def run(cfg, graphed: bool) -> dict:
        compiled.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals, stats = sharded_optimize_lm(g, v, cam, *sig, mesh, cfg, huber, graphed=graphed)
        torch.cuda.synchronize()
        return {"s": time.perf_counter() - t0, "reads": sum(compiled.reads.values()),
                "replays": dict(compiled.replays), "capture_ms": dict(compiled.capture_ms),
                "values": type(vals)(*(a.cpu() for a in vals)), "stats": stats}

    # Each: the first with its capture, a warm one, eager blocks of 1.
    runs = [run(solver_cfg, mode) for mode in (True, True, False)]
    blocks_cfg = dataclasses.replace(solver_cfg, max_iterations=PARALLEL_BLOCKS_ITERS)
    blocks = [run(blocks_cfg, mode) for mode in (True, True, False)]
    vals = cast_tree(runs[1]["values"], torch.float64, mesh.device)
    lin = linearize_graph(g, vals, cam, *sig, huber)

    def solve():
        return solve_schur(lin, g.stereo, v.num_poses, v.num_landmarks,
                           solver_cfg.lambda_initial, refine_iters=solver_cfg.refine_iters,
                           jitter=solver_cfg.cholesky_jitter, diag_damping=True,
                           eliminate_velocities=True, group=mesh.group)

    solve()
    prof = _device_ms_by(solve, _is_nccl)
    # The H_corr all-reduce alone: REPS back to back between CUDA events,
    # after a barrier, so a rank's time holds little waiting for the others.
    buf = torch.ones((6 * v.num_poses) ** 2, dtype=torch.float64, device=mesh.device)
    dist.all_reduce(buf, group=mesh.group)
    dist.barrier(group=mesh.group)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(PLAIN_REPS):
        dist.all_reduce(buf, group=mesh.group)
    end.record()
    end.synchronize()
    allreduce_ms = start.elapsed_time(end) / PLAIN_REPS
    del buf
    kp_l, kp_r, idx, mask = process_stereo_pairs_sharded(
        pairs_np[:, 0], pairs_np[:, 1], mesh, fcfg.frontend)
    return {"runs": runs, "blocks": blocks,
            "frontend": [a.cpu() for a in (*kp_l, *kp_r, idx, mask)], "prof": prof,
            "allreduce_ms": allreduce_ms}


def _stuck_peer_main(rank: int, world: int, tmp: str, results) -> None:
    """Phase 12 (b), a stuck peer, one NCCL rank in a process of its own:
    every rank runs a graph holding one all-reduce on a group whose
    timeout is ``STUCK_TIMEOUT_S`` (capture and replay); then rank 0
    replays it again and its peers, alive, never join. Rank 0's
    ``collectives.wait`` must raise after the timeout; rank 0 then puts
    its record on ``results`` before any CUDA call, and whether its replay
    ended in another. Each process ends at once (``os._exit``): rank 0's
    replay still runs, and nothing may wait on the device."""
    import datetime

    import torch
    import torch.distributed as dist

    from uslam_tpu_torch import collectives
    from uslam_tpu_torch.parallel import make_mesh
    from uslam_tpu_torch.solvers import compiled

    out = {"rank": rank, "err": None, "err_type": None}
    store = None
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        mesh = make_mesh(rank, world, f"cuda:{rank}", store)
        short = dist.new_group(list(range(world)),
                               timeout=datetime.timedelta(seconds=STUCK_TIMEOUT_S))
        x = torch.full((1024,), float(rank + 1), device=mesh.device)

        def total():
            return compiled.call("stuck_peer", collectives.all_reduce_sum, (x.clone(),),
                                 (short,), group=short)

        out["first"] = float(total()[0])
        if rank == 0:
            total()
            t0 = time.perf_counter()
            try:
                collectives.wait(short, mesh.device, "stuck replay")
            except Exception as e:  # noqa: BLE001 - returned and checked
                out["err"], out["err_type"] = repr(e), type(e).__name__
            out["waited_s"] = time.perf_counter() - t0
            results.put(out)
            out = {"rank": 0, "replay_ended": torch.cuda.current_stream().query()}
        else:
            store.wait(["stuck_done"])   # out of step until rank 0 is done
    except Exception as e:  # noqa: BLE001 - returned, and the check fails
        out["failed"] = repr(e)
    finally:
        if rank == 0 and store is not None:
            store.set("stuck_done", "1")
    results.put(out)
    results.close()
    results.join_thread()
    os._exit(0)


def stuck_peer(world: int) -> list:
    """Run :func:`_stuck_peer_main` on ``world`` ranks; their records in
    rank order, each rank's parts merged (a rank that put none is
    missing). Ranks still alive after ``STUCK_RANKS_S`` are killed."""
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    outs: dict = {}
    with tempfile.TemporaryDirectory(prefix="uslam_stuck_") as tmp:
        procs = [ctx.Process(target=_stuck_peer_main, args=(r, world, tmp, results))
                 for r in range(world)]
        deadline = time.monotonic() + STUCK_RANKS_S
        try:
            for p in procs:
                p.start()
            while time.monotonic() < deadline and not (
                    len(outs) == world and all("first" in o or "failed" in o for o in outs.values())
                    and "replay_ended" in outs[0]):
                try:
                    o = results.get(timeout=1.0)
                except queue.Empty:
                    continue
                outs.setdefault(o["rank"], {}).update(o)
        finally:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
                if p.is_alive():
                    p.kill()
                    p.join()
    return [outs[r] for r in sorted(outs)]


def parallel_many_gpus(one_k: dict, pairs_np, cfg_fe, frontend_a) -> dict:
    """Phase 12 (b): one NCCL rank per GPU when the host has two or more:
    the collective probe on every rank (ranks of their own, so a capture
    that fails there leaves nothing behind; NCCL_DEBUG=WARN names the call
    NCCL saw fail); the float64 1k LM graphed on every
    rank, held to one device at tests/test_torch_parallel.py's tolerances,
    every rank's values and statistics the same bits, and each rank's
    graphed solve = its eager blocks of one step bit for bit; the front
    end held to (a) exactly."""
    import numpy as np
    import torch

    from uslam_tpu_torch.device import cast_tree
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.interop import to_port
    from uslam_tpu_torch.parallel.launch import run_ranks
    from uslam_tpu_torch.solvers.lm import SHARDED_BLOCK, optimize_lm

    cfg, r = one_k["cfg"], one_k["result"]
    n_gpu = torch.cuda.device_count()
    m = r.values.num_landmarks
    world = max((w for w in (1, 2, 4, 8) if w <= n_gpu and pairs_np.shape[0] % w == 0
                 and m % w == 0), default=1)
    if world < 2:
        log(f"multi-device (b): not run ({n_gpu} GPU; one NCCL rank per GPU needs two or more)")
        return {}
    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    huber = cfg.noise.stereo_huber_delta
    solver = dataclasses.replace(cfg.solver, max_iterations=PARALLEL_LM_ITERS)
    graph = cast_tree(r.graph, torch.float64, "cpu")
    initial = cast_tree(to_port(one_k["initial"], "cpu"), torch.float64, "cpu")
    cam = StereoCamera.from_config(cfg.camera, device="cuda", dtype=torch.float64)
    ref_s = []
    for _ in range(2):  # the first float64 solve of the process, then a warm one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_vals, ref_stats = optimize_lm(cast_tree(graph, torch.float64, "cuda"),
                                          cast_tree(initial, torch.float64, "cuda"), cam, *sig,
                                          solver, huber)
        torch.cuda.synchronize()
        ref_s.append(time.perf_counter() - t0)
    os.environ.setdefault("NCCL_DEBUG", "WARN")   # read by the spawned ranks
    probes = run_ranks(_probe_rank, world, device="cuda", timeout_s=PARALLEL_TIMEOUT_S)
    t0 = time.perf_counter()
    outs = run_ranks(_parallel_rank, world, graph, initial, cfg.camera, sig, huber, solver,
                     pairs_np, cfg_fe, device="cuda", timeout_s=PARALLEL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    stuck = stuck_peer(world)
    log(f"multi-device (b): stuck peer, {world} ranks, group timeout {STUCK_TIMEOUT_S} s: "
        f"{stuck}")
    total = world * (world + 1) / 2
    stuck_ok = (len(stuck) == world and not any("failed" in o for o in stuck)
                and all(o["first"] == total for o in stuck)
                and stuck[0]["err_type"] == "RuntimeError" and "timeout" in stuck[0]["err"]
                and STUCK_TIMEOUT_S <= stuck[0]["waited_s"] < STUCK_TIMEOUT_S + 1
                and stuck[0].get("replay_ended") is False
                and all(o["err"] is None for o in stuck[1:]))
    graphed = [o["runs"][1] for o in outs]
    lm_ok = all(
        run["stats"].iterations == ref_stats.iterations
        and math.isclose(run["stats"].final_error, ref_stats.final_error,
                         rel_tol=PARALLEL_ERROR_RTOL)
        and all(np.allclose(a.numpy(), b.cpu().numpy(), rtol=0, atol=PARALLEL_VALUES_ATOL)
                for a, b in zip(run["values"], ref_vals))
        for run in graphed)
    ranks_same = all(run["stats"] == graphed[0]["stats"]
                     and _tree_equal(run["values"], graphed[0]["values"]) for run in graphed)
    graphed_eager = all(o["runs"][1]["stats"] == o["runs"][2]["stats"]
                        and _tree_equal(o["runs"][1]["values"], o["runs"][2]["values"])
                        for o in outs)
    blocks = max(1, math.ceil(ref_stats.iterations / SHARDED_BLOCK))
    replays_ok = all(o["runs"][1]["replays"] == {"lm_start": 1, "lm_block": blocks}
                     and o["runs"][1]["reads"] == blocks + 1 for o in outs)
    # Over more than one block: the ranks read "active" between blocks and
    # replay as many blocks each.
    multi = [o["blocks"][1] for o in outs]
    multi_it = multi[0]["stats"].iterations
    multi_blocks = math.ceil(multi_it / SHARDED_BLOCK)
    multi_same = all(run["stats"] == multi[0]["stats"]
                     and _tree_equal(run["values"], multi[0]["values"]) for run in multi)
    multi_eager = all(o["blocks"][1]["stats"] == o["blocks"][2]["stats"]
                      and _tree_equal(o["blocks"][1]["values"], o["blocks"][2]["values"])
                      for o in outs)
    multi_reads = multi_blocks >= 2 and all(
        run["replays"] == {"lm_start": 1, "lm_block": multi_blocks}
        and run["reads"] == multi_blocks + 1 for run in multi)
    fe_ok = all(all(torch.equal(a, b) for a, b in zip(o["frontend"], frontend_a)) for o in outs)
    log(f"multi-device (b): {world} NCCL ranks, one per GPU, in {wall!r} s (spawn included): "
        f"float64 1k LM graphed {[run['stats'].iterations for run in graphed]} iterations, "
        f"final errors {[run['stats'].final_error for run in graphed]} (one device "
        f"{ref_stats.final_error!r} in {ref_s[0]!r} s cold, {ref_s[1]!r} s warm)")
    for r_, o in enumerate(outs):
        (nccl_ms, nccl_n, solve_ms) = o["prof"]
        first, warm, eager = o["runs"]
        it = max(warm["stats"].iterations, 1)
        log(f"  rank {r_}: LM graphed {first['s']!r} s with its capture (capture host ms "
            f"{first['capture_ms']}), {warm['s']!r} s warm ({warm['s'] * 1e3 / it!r} ms per "
            f"iteration, host reads {warm['reads']}, graph launches {warm['replays']}); eager "
            f"blocks of 1 {eager['s']!r} s ({eager['s'] * 1e3 / it!r} ms per iteration, host "
            f"reads {eager['reads']}); one sharded solve_schur at its end: NCCL kernels "
            f"{nccl_n}, {nccl_ms!r} ms of {solve_ms!r} ms device time; the "
            f"{(6 * r.values.num_poses) ** 2 * 8} B all-reduce alone {o['allreduce_ms']!r} ms")
    for r_, o in enumerate(outs):
        first, warm, eager = o["blocks"]
        it = max(warm["stats"].iterations, 1)
        log(f"  rank {r_}, max_iterations {PARALLEL_BLOCKS_ITERS}: {warm['stats'].iterations} "
            f"iterations, final error {warm['stats'].final_error!r}; LM graphed "
            f"{first['s']!r} s with its capture (capture host ms {first['capture_ms']}), "
            f"{warm['s']!r} s warm ({warm['s'] * 1e3 / it!r} ms per iteration, host reads "
            f"{warm['reads']}, graph launches {warm['replays']}); eager blocks of 1 "
            f"{eager['s']!r} s ({eager['s'] * 1e3 / it!r} ms per iteration, host reads "
            f"{eager['reads']})")
    # What lm.SHARDED_BLOCK rests on: NCCL's kernels capture in a plain
    # graph and not in a conditional body (printed above, rank by rank).
    checks = {f"multi-device (b): {world} ranks, collectives in a plain graph = eager bit for "
              "bit, every rank": all(probe["ok"]["plain"] for probe in probes)}
    log(f"multi-device (b): collectives in conditional bodies, {world} ranks, graphed = eager: "
        f"{[{k: v for k, v in probe['ok'].items() if k != 'plain'} for probe in probes]}")
    checks.update({
        f"multi-device (b): {world} ranks, float64 1k LM graphed = one rank ({PARALLEL_LM_ITERS} "
        f"iterations, error rtol {PARALLEL_ERROR_RTOL}, values atol {PARALLEL_VALUES_ATOL})": lm_ok,
        f"multi-device (b): {world} ranks, every rank's graphed LM the same bits": ranks_same,
        f"multi-device (b): {world} ranks, each rank's graphed LM = its eager blocks of 1, bit "
        "for bit": graphed_eager,
        f"multi-device (b): {world} ranks, graph launches lm_start 1, lm_block ceil(iterations "
        f"/ {SHARDED_BLOCK}), host reads one more, every rank": replays_ok,
        f"multi-device (b): {world} ranks, float64 1k LM graphed over {PARALLEL_BLOCKS_ITERS} "
        "iterations, every rank the same bits": multi_same,
        f"multi-device (b): {world} ranks, over {PARALLEL_BLOCKS_ITERS} iterations each rank's "
        "graphed LM = its eager blocks of 1, bit for bit": multi_eager,
        f"multi-device (b): {world} ranks, over {PARALLEL_BLOCKS_ITERS} iterations lm_block "
        "ceil(iterations / 4) >= 2 and host reads one more, the same on every rank": multi_reads,
        f"multi-device (b): {world} ranks, front end = (a) exactly": fe_ok,
        f"multi-device (b): {world} ranks, a stuck peer: rank 0's wait on its replay raises "
        f"RuntimeError after its {STUCK_TIMEOUT_S} s timeout, the replay still running": stuck_ok,
    })
    return checks


def parallel_phase(one_k: dict, survey: dict, pairs_np, cfg_fe) -> dict:
    """Phase 12: (a) then (b); returns the checks and (a)'s launches."""
    t_phase = time.perf_counter()
    a = parallel_one_rank(one_k, survey, pairs_np, cfg_fe)
    checks = dict(a["checks"])
    checks.update(parallel_many_gpus(one_k, pairs_np, cfg_fe, a["frontend"]))
    log(f"multi-device phase: {time.perf_counter() - t_phase!r} s")
    return {"checks": checks, "launches": a["launches"]}



# ---- phase 13: the public surface on the card ----------------------------------


def _rel_max(a, b) -> float:
    """max |a - b| over max |b| (numpy or tensors)."""
    import numpy as np

    a, b = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64) for x in (a, b))
    return float(np.abs(a - b).max() / np.abs(b).max())


def surface_phase(cfg) -> dict:
    """Phase 13: the entry points the JAX package exports beside the
    pipeline, on the card: ``extract_orb`` on one 1080p image (one
    ``fast_harris`` launch per level; bit-identical to ``extract_orb_batch``
    of one image; on SURFACE_CPU_IMAGES images the CPU's to the SURFACE_*
    standard; ms per image beside the chunked path's),
    ``hamming_distance_matrix`` at SURFACE_HAMMING (one ``hamming`` launch,
    exact), ``preintegrate_with_cov`` and
    ``whitener_from_cov`` in float64 on the slice's IMU intervals, and the
    native time join and whiteners on the slice's sequence."""
    import numpy as np
    import torch

    from uslam_tpu_torch import native
    from uslam_tpu_torch.factors import imu
    from uslam_tpu_torch.frontend import extract_orb, hamming_distance_matrix, kernels
    from uslam_tpu_torch.frontend.orb import extract_orb_batch
    from uslam_tpu_torch.graph.builder import compute_imu_whiteners
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.io.timesync import approximate_time_join

    t_phase = time.perf_counter()
    log("public surface (phase 13):")
    checks, launches = {}, {}
    levels = cfg.frontend.pyramid_levels
    shape = (SURFACE_IMAGES, cfg.camera.resolution_y, cfg.camera.resolution_x)
    chunk = textured_images(shape, 13)
    img = chunk[0].contiguous()

    kernels.reset_launch_counts()
    kp = extract_orb(img, cfg.frontend)
    torch.cuda.synchronize()
    launches["extract_orb"] = dict(kernels.launch_counts)
    one = extract_orb_batch(img[None], cfg.frontend)
    checks[f"extract_orb: {levels} fast_harris launches, nothing else"] = (
        launches["extract_orb"] == {"fast_harris": levels, "hamming": 0, "preintegrate": 0,
                                    "jacobi_eigh": 0, "graph_cond": 0})
    checks["extract_orb bit-identical to extract_orb_batch of one image"] = all(
        torch.equal(a, b[0]) for a, b in zip(kp, one))

    t0 = time.perf_counter()
    pairs = [(extract_orb(im, cfg.frontend), extract_orb(im.cpu(), cfg.frontend))
             for im in chunk[:SURFACE_CPU_IMAGES]]
    t_cpu = time.perf_counter() - t0
    card = [np.concatenate([a.cpu().numpy() for a in f]) for f in zip(*(c for c, _ in pairs))]
    ref = [np.concatenate([a.numpy() for a in f]) for f in zip(*(r for _, r in pairs))]
    m = ref[5]
    same_angle = m & (card[2] == ref[2])
    flipped = np.unpackbits((card[4] ^ ref[4]).view(np.uint8), axis=-1).sum(-1)[m]
    score_err = _rel_max(card[1][m], ref[1][m]) if m.any() else 0.0
    angle_err = float(np.abs(card[2] - ref[2])[m].max()) if m.any() else 0.0
    log(f"  extract_orb on the card against the CPU, {SURFACE_CPU_IMAGES} images "
        f"{tuple(img.shape)} ({t_cpu!r} s): "
        f"{int(m.sum())} keypoints, masks equal {np.array_equal(card[5], m)}, xy equal "
        f"{np.array_equal(card[0][m], ref[0][m])}, levels equal "
        f"{np.array_equal(card[3][m], ref[3][m])}; score rel err {score_err!r}, angle err "
        f"{angle_err!r} rad, angles bit-equal {int(same_angle.sum())} of {int(m.sum())}; "
        f"keypoints with flipped descriptor bits {int((flipped > 0).sum())} "
        f"(max {int(flipped.max()) if m.any() else 0} bits)")
    checks["extract_orb on the card equals the CPU's (masks, xy, levels; C5 descriptors)"] = (
        m.sum() >= 100 and np.array_equal(card[5], m)
        and np.array_equal(card[0][m], ref[0][m]) and np.array_equal(card[3][m], ref[3][m])
        and score_err <= SURFACE_SCORE_RTOL and angle_err <= SURFACE_ANGLE_ATOL
        and np.array_equal(card[4][same_angle], ref[4][same_angle])
        and flipped.max() <= SURFACE_MAX_FLIPPED_BITS
        and (flipped > 0).mean() < SURFACE_FLIPPED_SHARE)

    one_ms = cuda_ms(lambda: extract_orb(img, cfg.frontend), 20)
    batch_ms = cuda_ms(lambda: extract_orb_batch(chunk, cfg.frontend), 5)
    one_wall, _ = _median_ms(lambda: extract_orb(img, cfg.frontend), 5)
    batch_wall, _ = _median_ms(lambda: extract_orb_batch(chunk, cfg.frontend), 5)
    # CUDA events around back-to-back calls: where the host enqueues more
    # slowly than the device runs (a single image), this is host-bound.
    log(f"  extract_orb ms per {shape[2]}x{shape[1]} image: CUDA events over back-to-back "
        f"calls {one_ms!r}, host wall (synchronized) {one_wall!r}; extract_orb_batch of "
        f"{SURFACE_IMAGES}, per image: events {batch_ms / SURFACE_IMAGES!r}, host wall "
        f"{batch_wall / SURFACE_IMAGES!r}")

    gen = torch.Generator(device="cuda").manual_seed(13)
    da, db = (torch.randint(-2**31, 2**31 - 1, (n, 8), generator=gen, device="cuda",
                            dtype=torch.int32) for n in SURFACE_HAMMING)
    kernels.reset_launch_counts()
    dist = hamming_distance_matrix(da, db)
    torch.cuda.synchronize()
    launches["hamming_distance_matrix"] = dict(kernels.launch_counts)
    plain = kernels.hamming_plain(da[None], db[None])[0]
    hd_ms = cuda_ms(lambda: hamming_distance_matrix(da, db), KERNEL_REPS)
    log(f"  hamming_distance_matrix {tuple(da.shape)} x {tuple(db.shape)}: launches "
        f"{launches['hamming_distance_matrix']}, max_abs_err vs hamming_plain "
        f"{int((dist - plain).abs().max())}, {hd_ms!r} ms")
    checks["hamming_distance_matrix: 1 hamming launch, nothing else"] = (
        launches["hamming_distance_matrix"] == {"fast_harris": 0, "hamming": 1, "preintegrate": 0,
                                                "jacobi_eigh": 0, "graph_cond": 0})
    checks["hamming_distance_matrix equals hamming_plain"] = (
        dist.shape == SURFACE_HAMMING and torch.equal(dist, plain))

    # The slice's sequence with its synthetic features (not rendered): the
    # streams its time join takes and the IMU intervals the packer gives it.
    seq = generate_synthetic_sequence(SyntheticSpec(duration=20.0, odom_drift_rate=0.05),
                                      cfg.camera, render_images=False)
    data_np = pack_sequence(seq, cfg)[0].imu.data
    data = imu.ImuIntervalData(*(torch.from_numpy(np.asarray(x, np.float64)).cuda()
                                 for x in data_np))
    zero = torch.zeros(6, dtype=torch.float64, device="cuda")
    covs = (cfg.imu.accel_cov, cfg.imu.gyro_cov, cfg.imu.integration_cov)
    kernels.reset_launch_counts()
    delta, P = imu.preintegrate_with_cov(data, zero, *covs)
    cov_launches = dict(kernels.launch_counts)
    value = imu.preintegrate_value(data, zero)
    delta_err = max(_rel_max(a, b) for a, b in zip(delta, value))
    W = imu.whitener_from_cov(P, jitter=1e-10)
    W_np = compute_imu_whiteners(data_np, cfg)
    w_err = _rel_max(W, W_np)
    cov_ms, _ = _median_ms(lambda: imu.preintegrate_with_cov(data, zero, *covs))
    log(f"  preintegrate_with_cov float64 on {tuple(data.acc.shape)} (the slice's intervals): "
        f"deltas vs the preintegrate kernel's value-only variant rel err {delta_err!r}; "
        f"whitener_from_cov vs the packer's numpy whitener rel err {w_err!r}; host "
        f"{cov_ms!r} ms, plain PyTorch (launches {cov_launches})")
    checks["preintegrate_with_cov deltas = the kernel's (float64, PREINT_RTOL)"] = (
        delta_err <= PREINT_RTOL["torch.float64"])
    checks[f"whitener_from_cov = the numpy whitener to {SURFACE_WHITENER_RTOL}"] = (
        w_err <= SURFACE_WHITENER_RTOL)

    # Medians of 3: the first native call also builds the library (g++).
    t_native, W_native = _median_ms(
        lambda: native.imu_whiteners(data_np.acc, data_np.gyro, data_np.dt, *covs))
    t_numpy, _ = _median_ms(lambda: compute_imu_whiteners(data_np, cfg))
    native_err = _rel_max(W_native, W_np)
    feat_t = np.array([f.t for f in seq.features])
    streams = [seq.dvl_twist_t, feat_t]
    join = native.approx_time_join(seq.dvl_pose_t, streams, cfg.timesync.slop)
    join_ref = approximate_time_join(seq.dvl_pose_t, streams, cfg.timesync.slop)
    log(f"  native imu_whiteners vs numpy on the slice's intervals: rel err {native_err!r} "
        f"(max |diff| {float(np.abs(W_native - W_np).max())!r}); {t_native!r} ms vs "
        f"{t_numpy!r} ms (host, median of 3); native approx_time_join: {len(join)} keyframes, equal "
        f"to io.timesync's {join == join_ref}")
    checks[f"native imu_whiteners = numpy to {NATIVE_WHITENER_RTOL}"] = (
        native_err <= NATIVE_WHITENER_RTOL)
    checks["native approx_time_join = io.timesync.approximate_time_join"] = (
        len(join) == len(seq.dvl_pose_t) and join == join_ref)
    log(f"public surface phase: {time.perf_counter() - t_phase!r} s")
    return {"checks": checks, "launches": launches}


# ---- phase 14: the LM as replayed CUDA graphs --------------------------------


def _values_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def lm_graph_pair(label: str, graph, initial, cam, sig, huber, solver_cfg, mesh=None) -> dict:
    """One LM solve graphed against the same solve in eager blocks of one
    step: values and statistics bit for bit. ``optimize_lm`` on the card
    is one graph, the loop a WHILE node, its re-linearization an IF node,
    the CG another WHILE node; with ``mesh``, ``sharded_optimize_lm`` on
    its rank's slice replays two plain graphs, the first linearization and
    error (``"lm_start"``) and blocks of ``SHARDED_BLOCK`` gated steps
    (``"lm_block"``, the collectives inside, the IF node too), reading
    "active" after each block. Per solve its host reads, graph launches,
    steps run (masked = steps - iterations), linearizations (1 + the
    accepted steps), CG iterations and the kernel launches its graphs and
    bodies ran against the counts the code gives; host ms per iteration
    (synchronized; the graphed solve after its capture) and the capture's
    host ms; the host syncs of a replay of ``solve_lm`` under
    ``torch.cuda.set_sync_debug_mode`` (none; with ``mesh`` the block
    reads alone); the graphs' span on the device (CUDA events around
    ``solve_lm``) over the solve's host wall. The device's busy share is
    not measured: torch.profiler records no kernel inside a conditional
    node's body."""
    import warnings

    import torch

    from uslam_tpu_torch.frontend import kernels
    from uslam_tpu_torch.parallel import sharded_optimize_lm
    from uslam_tpu_torch.solvers import compiled
    from uslam_tpu_torch.solvers.lm import SHARDED_BLOCK, optimize_lm, solve_lm

    group = None if mesh is None else mesh.group

    def run(**kw):
        compiled.reset_counts()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mesh is None:
            out = optimize_lm(graph, initial, cam, *sig, solver_cfg, huber, **kw)
        else:
            out = sharded_optimize_lm(graph, initial, cam, *sig, mesh, solver_cfg, huber, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {"reads": sum(compiled.reads.values()), "launches": dict(kernels.launch_counts),
                  "replays": dict(compiled.replays), "captures": dict(compiled.captures),
                  "capture_ms": dict(compiled.capture_ms),
                  "runs": {k: list(v) for k, v in compiled.runs.items()}}
        return out, ms, counts

    # With a mesh, eager blocks of 1 before the capture too: does the
    # group's graph slow its eager collectives?
    before = run(graphed=False) if mesh is not None else None
    (v_first, s_first), first_ms, first = run()
    (v_g, s_g), graphed_ms, g = run()
    (v_1, s_1), eager1_ms, e = run(graphed=False)   # blocks of 1, the default
    it = s_g.iterations
    blocks = max(1, math.ceil(it / SHARDED_BLOCK))
    # The host syncs of one replay: none, or with a mesh one per block.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            solve_lm(graph, initial, cam, *sig, solver_cfg, huber, group)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = len(caught)
    span_ms = device_span_ms(lambda: solve_lm(graph, initial, cam, *sig, solver_cfg, huber,
                                              group))
    same = s_g == s_first == s_1 and all(_values_equal(v_g, v) for v in (v_first, v_1))
    if before is not None:
        same = same and before[0][1] == s_g and _values_equal(before[0][0], v_g)
        log(f"    eager blocks of 1 before the capture: {before[1] / it!r} host ms per "
            "iteration")
    accepts, rejects = g["runs"].get("lm_linearize", [0, 0])
    cg = g["runs"].get("cg", [0])[0]
    if mesh is None:
        steps = g["runs"].get("lm_step", [0])[0]
        # From the code: the first linearization and error outside the
        # loop, one error per step, one linearization per taken step; the
        # condition kernel once before the loop, then per step the IF's
        # and the loop's, and per CG solve its loop's first test and one
        # per CG iteration.
        expected = {"preintegrate": 2 + it + accepts,
                    "graph_cond": 1 + 2 * it + (it + cg if cg else 0)}
        replays, reads, syncs_expected = {"lm_solve": 1}, 1, 0
        launch_ok = steps == it
    else:
        # Blocks of SHARDED_BLOCK steps: a step after the stop (masked)
        # computes its error too and takes the IF's else body.
        steps = SHARDED_BLOCK * g["replays"].get("lm_block", 0)
        expected = {"preintegrate": 2 + steps + accepts,
                    "graph_cond": steps + (steps + cg if cg else 0)}
        replays, reads, syncs_expected = {"lm_start": 1, "lm_block": blocks}, blocks + 1, blocks
        launch_ok = 0 <= steps - it < SHARDED_BLOCK
    got = {k: g["launches"][k] for k in expected}
    capture_ms = sum(first["capture_ms"].values())
    log(f"  {label}: {it} LM iterations, final error {s_g.final_error!r}, converged "
        f"{s_g.converged}; graphed = eager blocks of 1, values and statistics bit for bit: "
        f"{same}")
    log(f"    per graphed solve: host reads {g['reads']} (eager blocks of 1: {e['reads']}), graph "
        f"launches {g['replays']}, steps run {steps} ({steps - it} masked), linearizations "
        f"{1 + accepts} = 1 + {accepts} accepted ({rejects} rejected or masked), CG iterations "
        f"{cg} (eager {e['runs'].get('cg', [0])[0]}); launches {got}, from the code "
        f"{expected}; captures {first['captures']} on the first solve (host ms "
        f"{first['capture_ms']}), {g['captures']} on the second; host syncs in a replay of "
        f"solve_lm {syncs}")
    log(f"    host ms per iteration: graphed {graphed_ms / it!r} (first solve, with its capture, "
        f"{first_ms / it!r}), eager blocks of 1 {eager1_ms / it!r}; solve ms graphed "
        f"{graphed_ms!r}, eager {eager1_ms!r}")
    log(f"    the graphs on the device (CUDA events, copies in and out included): {span_ms!r} "
        f"ms, {span_ms / graphed_ms!r} of the graphed solve's host wall")
    design = ("one graph launch and one host read per solve, no masked step" if mesh is None
              else f"graph launches lm_start 1, lm_block ceil(iterations / {SHARDED_BLOCK}), "
              "host reads one more, fewer masked steps than a block")
    checks = {
        f"LM {label}: graphed = eager blocks of 1, bit for bit": same,
        f"LM {label}: {design}": g["replays"] == replays and g["reads"] == reads and launch_ok,
        f"LM {label}: linearizations 1 + accepted steps, as eager": (
            accepts == e["runs"].get("lm_linearize", [0])[0] and accepts + rejects == steps),
        f"LM {label}: CG iterations graphed = eager": cg == e["runs"].get("cg", [0])[0],
        f"LM {label}: launches in the graphs and bodies as the code gives them": got == expected,
        f"LM {label}: no capture on a second solve of the same shapes": not g["captures"],
        f"LM {label}: host syncs in a replay of solve_lm (set_sync_debug_mode): "
        f"{syncs_expected}": syncs == syncs_expected,
    }
    return {"checks": checks, "iterations": it, "final_error": s_g.final_error,
            "reads": g["reads"], "graphed_ms": graphed_ms, "eager1_ms": eager1_ms,
            "eager1_reads": e["reads"], "span_ms": span_ms, "syncs": syncs,
            "linearizations": 1 + accepts, "capture_ms": capture_ms,
            "cg": cg, "values": v_g, "stats": s_g, "launches": g["launches"]}


def while_test_nodes(label: str, graph, initial, cam, sig, huber, solver_cfg) -> dict:
    """The kernel nodes of the LM's and the CG's WHILE bodies (``"lm_step"``
    and ``"cg"``), from one solve's graph captured twice under
    ``compiled.recording_nodes``: as the port runs it (each loop test a
    ``compiled.Test``, which the condition kernel computes) and with each
    Test's flag computed first in torch, the former test (its two
    comparisons and their and, then the condition kernel: 4 kernel nodes).
    The LM's body holds two WHILE tests (the CG's first, before its node,
    and the LM's next), the CG's body one (its next): a body's tests take
    4 x tests - (former - now) kernel nodes. Then both graphs replayed in
    turns (now, former, former, now): host ms per LM iteration of each, and
    both solves equal bit for bit."""
    import torch

    from uslam_tpu_torch.solvers import compiled
    from uslam_tpu_torch.solvers.lm import optimize_lm

    plain_while = compiled.while_loop

    def former_while(cond_fun, body_fun, init, *, name="while_loop"):
        def flag_fun(carry):
            test = cond_fun(carry)
            return test.flag() if isinstance(test, compiled.Test) else test
        return plain_while(flag_fun, body_fun, init, name=name)

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = optimize_lm(graph, initial, cam, *sig, solver_cfg, huber)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    saved = dict(compiled._CACHE)
    entries, nodes, outs = {}, {}, {}
    try:
        for form in ("now", "former"):
            compiled._CACHE.clear()
            compiled.while_loop = plain_while if form == "now" else former_while
            compiled.reset_counts()
            with compiled.recording_nodes():
                outs[form] = solve()[0]
            nodes[form] = {body: compiled.body_nodes.get(body, {}).get(0, {})
                           for body in ("lm_step", "cg")}
            (key, entry), = ((k, e) for k, e in compiled._CACHE.items() if k[0] == "lm_solve")
            entries[form] = entry
        ms = {"now": [], "former": []}
        for form in ("now", "former", "former", "now"):
            compiled._CACHE[key] = entries[form]
            (values, stats), t = solve()
            ms[form].append(t / stats.iterations)
            outs[form + " again"] = (values, stats)
    finally:
        compiled.while_loop = plain_while
        compiled._CACHE.clear()
        compiled._CACHE.update(saved)
    same = all(outs[f][1] == outs["now"][1] and _values_equal(outs[f][0], outs["now"][0])
               for f in ("former", "now again", "former again"))
    kernels_in = {f: {b: n.get("kernel", 0) for b, n in nodes[f].items()} for f in nodes}
    tests = {"lm_step": 2, "cg": 1}
    test_nodes = {b: 4 * n - (kernels_in["former"][b] - kernels_in["now"][b])
                  for b, n in tests.items()}
    log(f"  {label}: kernel nodes of the WHILE bodies, the test a Test / the former flag: "
        f"{kernels_in['now']} / {kernels_in['former']} (all nodes {nodes}); the kernel nodes "
        f"of the bodies' WHILE tests {test_nodes} for {tests} tests (former: 4 each); host ms "
        f"per LM iteration, replayed in turns, Test {ms['now']!r}, former {ms['former']!r}; "
        f"the two graphs' solves equal bit for bit: {same}")
    return {"checks": {
        f"LM {label}: one kernel node per WHILE test in the LM's and the CG's bodies "
        "(counted from the captured bodies)": test_nodes == tests,
        f"LM {label}: the Test's graph = the former flag's graph, bit for bit": same},
        "nodes": kernels_in, "ms": ms}


def window_graph_check(online_c, cfg) -> dict:
    """The device-resident window step of phase 8's pass (c) on its last
    window: graphed (the "window_graph", "lm_solve" and "window_tail" graphs
    the smoother captured) against eager, bit for bit; the replays, host
    reads, LM iterations and linearizations, host ms."""
    import torch

    from uslam_tpu_torch.solvers import compiled
    from uslam_tpu_torch.solvers.fixed_lag import unpack_step_outputs, upload, window_step

    sm = online_c.smoother
    rec = upload(sm._frame_record_arrays(sm._frames[-1]), "cuda")
    args = (sm._dev_state, rec, sm.cam, cfg.noise.dvl_sigma, cfg.noise.stereo_sigma,
            cfg.imu.gravity, sm.steady_solver)
    compiled.settle_launches()
    compiled.reset_counts()
    t_g, graphed = _median_ms(lambda: window_step(*args))
    counts = (dict(compiled.captures), dict(compiled.replays), dict(compiled.reads))
    compiled.settle_launches()
    runs = {k: list(v) for k, v in compiled.runs.items()}
    span_ms = device_span_ms(lambda: window_step(*args))
    t_e, eager = _median_ms(lambda: window_step(*args, graphed=False))
    leaves_g, leaves_e = [*graphed[0], graphed[1]], [*eager[0], eager[1]]
    same = all(torch.equal(a, b) for a, b in zip(leaves_g, leaves_e))
    iterations = int(unpack_step_outputs(graphed[1].cpu().numpy())[4].iterations)
    log(f"  online window step (pass (c)'s last window, max_iterations "
        f"{sm.steady_solver.max_iterations}, {iterations} LM iterations): "
        f"graphed = eager bit for bit: {same}; host ms graphed {t_g!r}, eager {t_e!r} (median "
        f"of 3); the graphed step's three graphs on the device (CUDA events) {span_ms!r} ms; "
        f"captures {counts[0]}, replays {counts[1]}, host reads {counts[2]}; body runs over the "
        f"3 graphed steps {runs}")
    return {"checks": {"online window step: graphed = eager, bit for bit": same,
                       "online window step: replays (window_graph 3, lm_solve 3, window_tail 3), "
                       "no capture, no host read, no masked step":
                       counts[0] == {} and counts[2] == {}
                       and counts[1] == {"window_graph": 3, "lm_solve": 3, "window_tail": 3}
                       and runs.get("lm_step", [0])[0] == 3 * iterations},
            "graphed_ms": t_g, "eager_ms": t_e, "span_ms": span_ms}


def graph_cache_summary() -> dict:
    """Per graph name: the cached entries and the MiB of their static input
    buffers (the memory each entry keeps outside the shared pool)."""
    from uslam_tpu_torch.solvers import compiled

    out: dict = {}
    for key, entry in compiled._CACHE.items():
        n, mib = out.get(key[0], (0, 0.0))
        out[key[0]] = (n + 1, mib + sum(b.numel() * b.element_size() for b in entry.inputs) / 2**20)
    return out


def lm_graph_phase(seq, cfg, one_k: dict, survey: dict, online_c) -> dict:
    """Phase 14: the LM as one CUDA graph per solve (WHILE and IF nodes),
    against eager blocks of one step, on the slice (which must repeat
    ``SLICE_BEFORE``) and the slice with the CG reduced solve, the 1k
    solve, the 2000-pose banded survey and the online window step."""
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.interop import to_port
    from uslam_tpu_torch.pipeline import banded_solver_config

    import torch

    t_phase = time.perf_counter()
    log("the LM as one CUDA graph per solve, its loops WHILE nodes (graphed against eager):")
    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    cam = StereoCamera.from_config(cfg.camera, device="cuda")
    g_np, v_np = pack_sequence(seq, cfg)[:2]
    slice_ = lm_graph_pair("slice", to_port(g_np, "cuda"), to_port(v_np, "cuda"), cam, sig,
                           cfg.noise.stereo_huber_delta, cfg.solver)
    checks = dict(slice_["checks"])
    checks[f"LM slice: {SLICE_BEFORE} iterations and final error, as before"] = (
        (slice_["iterations"], slice_["final_error"]) == SLICE_BEFORE)
    # CG inside the graph is a WHILE node nested in the LM's body, stopping
    # at its test; eagerly it reads the test once per block of CG_BLOCK.
    cg = lm_graph_pair("slice, CG reduced solve", to_port(g_np, "cuda"), to_port(v_np, "cuda"),
                       cam, sig, cfg.noise.stereo_huber_delta,
                       dataclasses.replace(cfg.solver, reduced_solver="cg"))
    checks.update(cg["checks"])
    checks.update(while_test_nodes("slice, CG reduced solve", to_port(g_np, "cuda"),
                                   to_port(v_np, "cuda"), cam, sig, cfg.noise.stereo_huber_delta,
                                   dataclasses.replace(cfg.solver, reduced_solver="cg"))["checks"])
    c1k = one_k["cfg"]
    r1k = lm_graph_pair("1k", one_k["result"].graph, to_port(one_k["initial"], "cuda"),
                        StereoCamera.from_config(c1k.camera, device="cuda"), sig,
                        c1k.noise.stereo_huber_delta, c1k.solver)
    checks.update(r1k["checks"])
    cs = survey["cfg"]
    rs = lm_graph_pair("survey 2000 (banded)", survey["graph"], survey["initial"],
                       StereoCamera.from_config(cs.camera, device="cuda"), sig,
                       cs.noise.stereo_huber_delta, banded_solver_config(cs.solver, survey["graph"]))
    checks.update(rs["checks"])
    if online_c is not None:
        checks.update(window_graph_check(online_c, cfg)["checks"])
    log(f"  graph cache (close_mesh evicts a group's graphs, nothing else is): "
        f"{graph_cache_summary()}; device memory reserved "
        f"{torch.cuda.memory_reserved() / 2**20!r} MiB")
    log(f"LM graph phase: {time.perf_counter() - t_phase!r} s")
    return {"checks": checks, "slice": slice_, "cg": cg, "1k": r1k, "survey": rs}


# ---- phase 15: the JAX repo's examples and its two quality checks -----------

CAMERA_MEAS_DEF = """\
Header header
gtsam_vio/FeatureMeasurement[] features
================================================================================
MSG: gtsam_vio/FeatureMeasurement
uint64 id
float64 u0
float64 v0
float64 u1
float64 v1
"""


def ser_features(t, ids, u0, v0, u1, v1) -> bytes:
    out = s_header(t) + struct.pack("<I", len(ids))
    for row in zip(ids, u0, v0, u1, v1):
        out += struct.pack("<Qdddd", int(row[0]), *(float(x) for x in row[1:]))
    return out


def write_features_bag(seq, path: str) -> None:
    """``seq``'s four sensor topics and its feature tracks (normalized
    coordinates, the reference's ``gtsam_vio/CameraMeasurement``) as a
    reference-style bag at ``path``, on the reference's topics: the input
    of examples/run_from_rosbag*.py."""
    from uslam_tpu_torch.io import rosbag

    tp = rosbag.BagTopics()
    msgs = sensor_messages(seq, tp) + [
        (tp.features, "gtsam_vio/CameraMeasurement", CAMERA_MEAS_DEF, float(f.t),
         ser_features(float(f.t), f.ids, f.u0, f.v0, f.u1, f.v1))
        for f in seq.features]
    rosbag.write_bag(path, sorted(msgs, key=lambda m: m[3]))


def exact_f64_optimize(graph, initial, cam, cfg, max_iters: int = 40):
    """tests/test_oracle_parity.py:29-68 on the port: an LM whose every step
    is the exact dense solve of the whole tangent space (numpy float64
    ``np.linalg.solve``: no Schur complement, no Cholesky jitter, no
    refinement, no damping floor) with GTSAM's lambda policy and stopping
    tests. ``graph``, ``initial`` and ``cam`` are float64 on one device,
    where the linearization, the error and the dense assembly run. Returns
    (values, error)."""
    import numpy as np
    import torch

    from uslam_tpu_torch.graph.values import values_retract
    from uslam_tpu_torch.solvers.dense import assemble_dense_with_landmarks
    from uslam_tpu_torch.solvers.linearize import graph_error, linearize_graph

    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    n, m = initial.num_poses, initial.num_landmarks
    values = initial
    error = float(graph_error(graph, values, cam, *sig))
    lam, nu = 1e-5, 10.0
    for _ in range(max_iters):
        H, g = assemble_dense_with_landmarks(
            linearize_graph(graph, values, cam, *sig), graph.stereo.cam_idx,
            graph.stereo.lm_idx, n, m)
        H = H.cpu().numpy().astype(np.float64)
        g = g.cpu().numpy().astype(np.float64)
        delta = np.linalg.solve(H + (lam + 1e-12) * np.eye(H.shape[0]), g)
        candidate = values_retract(values, torch.from_numpy(delta).to(values.pose_trans))
        new_error = float(graph_error(graph, candidate, cam, *sig))
        if np.isfinite(new_error) and new_error < error:
            decrease = error - new_error
            values, error = candidate, new_error
            if decrease <= 1e-8 or decrease <= 1e-6 * error:
                break
            lam, nu = max(lam / 10.0, 0.0), 10.0
        else:
            lam = max(lam, 1e-10) * nu
            nu *= 10.0
            if lam > 1e8:
                break
    return values, error


def oracle_solves(device: str) -> dict:
    """tests/test_oracle_parity.py:71 on the port, on ``device``: the
    float32 production solve (``run_solver``, ``SolverConfig()``), the
    float64 polish from it, and the exact float64 oracle on the same graph
    cast to float64. Returns the four ATEs against ground truth (initial,
    float32, polished, oracle), the errors, iterations and host seconds of
    each solve; checks nothing."""
    import numpy as np
    import torch

    from uslam_tpu_torch.config import UslamConfig
    from uslam_tpu_torch.device import cast_tree, synchronize
    from uslam_tpu_torch.eval.metrics import ate_rmse
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.interop import to_port
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.pipeline import run_solver
    from uslam_tpu_torch.solvers.polish import polish_f64

    dev = torch.device(device)
    seq = generate_synthetic_sequence(SyntheticSpec(**ORACLE_SPEC))
    cfg = UslamConfig()
    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    g_np, v_np, _odom, _ = pack_sequence(seq, cfg)
    graph, initial = to_port(g_np, dev), to_port(v_np, dev)
    cam = StereoCamera.from_config(cfg.camera, device=dev)
    out = {}

    t0 = time.perf_counter()
    values, stats = run_solver(graph, initial, cam, *sig, cfg.solver)
    synchronize(dev)
    out["f32_s"], out["f32_iterations"] = time.perf_counter() - t0, stats.iterations
    out["f32_converged"], out["f32_error"] = stats.converged, stats.final_error
    t0 = time.perf_counter()
    polished, info = polish_f64(graph, values, cam, *sig, cfg.solver, device=dev)
    synchronize(dev)
    out["polish_s"], out["polish_iterations"] = time.perf_counter() - t0, info["polish_iterations"]
    out["polish_error"] = info["polish_final_error"]
    t0 = time.perf_counter()
    oracle, out["oracle_error"] = exact_f64_optimize(
        cast_tree(graph, torch.float64, dev), cast_tree(initial, torch.float64, dev),
        cast_tree(cam, torch.float64, dev), cfg)
    synchronize(dev)
    out["oracle_s"] = time.perf_counter() - t0

    n = min(initial.num_poses, len(seq.gt_pos))
    gt = np.asarray(seq.gt_pos[:n], np.float64)
    for name, v in (("init", initial), ("f32", values), ("polished", polished),
                    ("oracle", oracle)):
        out[f"ate_{name}"] = ate_rmse(v.pose_trans.detach().cpu().numpy()[:n], gt)
    return out


def stress_keyframes(seq, cfg):
    """tests/test_fixed_lag.py:13-35 (``feed``) on the port: per keyframe
    (quat, pos, imu rows since the previous keyframe with dt 0.005 or None,
    DVL velocity, features triangulated from the keyframe's pose or None)."""
    import numpy as np

    from uslam_tpu_torch.io.timesync import slice_stream
    from uslam_tpu_torch.pipeline import AUVSlam

    slam = AUVSlam(cfg, device="cpu")  # its host triangulation alone
    prev_t = None
    for i, t in enumerate(seq.dvl_pose_t):
        sl = slice_stream(seq.imu_t, prev_t if prev_t is not None else -np.inf, float(t))
        imu = None
        if sl.stop > sl.start:
            imu = np.stack([np.concatenate([seq.imu_acc[k], seq.imu_gyro[k], [0.005]])
                            for k in range(sl.start, sl.stop)])
        prev_t = float(t)
        ff = seq.features[i]
        feats = None
        if len(ff.ids):
            feats = slam.get_landmarks(ff.ids, ff.u0, ff.v0, ff.u1, ff.v1,
                                       seq.dvl_pose_quat[i], seq.dvl_pose_pos[i])
        yield seq.dvl_pose_quat[i], seq.dvl_pose_pos[i], imu, seq.dvl_twist_vel[i], feats


def stress_spec(duration: float) -> dict:
    """tests/test_fixed_lag_stress.py:27-37: landmark density per second
    kept at the original 60 s / 320 configuration, short tracks."""
    return dict(trajectory="survey", duration=duration, num_landmarks=int(320 * duration / 60.0),
                odom_drift_rate=0.03, feature_noise_px=0.3, max_feature_depth=10.0, seed=6)


def run_stress(duration: float, device: str = "cuda", device_resident: bool = False) -> dict:
    """tests/test_fixed_lag_stress.py:25-81 on the port: the batch solve
    (``run_sequence``) and ``FixedLagSmoother(window=8,
    solve_during_fill=False)`` on ``device`` over the same survey stream;
    raises AssertionError when one of the JAX test's four bounds fails.
    Returns the figures: segment errors, ATEs, keyframes, unique ids, wall
    seconds of each side, host ms per steady keyframe and the LM's host
    reads (``compiled.read``) per steady keyframe."""
    import numpy as np

    from uslam_tpu_torch.config import UslamConfig
    from uslam_tpu_torch.device import resolve_device, synchronize
    from uslam_tpu_torch.eval.metrics import ate_rmse
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.pipeline import run_sequence
    from uslam_tpu_torch.solvers import compiled
    from uslam_tpu_torch.solvers.fixed_lag import FixedLagSmoother

    dev = resolve_device(device)
    cfg = UslamConfig()
    seq = generate_synthetic_sequence(SyntheticSpec(**stress_spec(duration)))

    t0 = time.perf_counter()
    traj_batch = run_sequence(seq, cfg, device=dev).trajectory
    batch_s = time.perf_counter() - t0

    fl = FixedLagSmoother(cfg, window=STRESS_WINDOW, solve_during_fill=False,
                          device_resident=device_resident, device=dev)
    seen_ids: set[int] = set()
    steady_ms, steady_reads = [], 0
    t0 = time.perf_counter()
    for k, (quat, pos, imu, dvl, feats) in enumerate(stress_keyframes(seq, cfg)):
        if feats:
            seen_ids.update(int(f[0]) for f in feats)
        reads = sum(compiled.reads.values())
        tk = time.perf_counter()
        fl.add_keyframe(quat, pos, np.zeros(3), imu, dvl, feats)
        synchronize(dev)
        if k > STRESS_WINDOW:   # after the first marginalization
            steady_ms.append((time.perf_counter() - tk) * 1e3)
            steady_reads += sum(compiled.reads.values()) - reads
    traj_fl = fl.full_trajectory()
    window_s = time.perf_counter() - t0

    n = min(len(traj_fl), len(traj_batch))
    seg = n // STRESS_SEGMENTS
    seg_err = np.array([
        ate_rmse(traj_fl[i * seg:(i + 1) * seg], traj_batch[i * seg:(i + 1) * seg])
        for i in range(STRESS_SEGMENTS)])
    gt = seq.gt_pos[:n]
    out = {
        "keyframes": n, "unique_ids": len(seen_ids), "seg_err": seg_err.tolist(),
        "ate_fl": ate_rmse(traj_fl[:n], gt), "ate_odom": ate_rmse(np.asarray(seq.dvl_pose_pos[:n]), gt),
        "batch_s": batch_s, "window_s": window_s, "steady": len(steady_ms),
        "steady_median_ms": float(np.median(steady_ms)),
        "steady_p90_ms": float(np.percentile(steady_ms, 90)),
        "reads_per_steady": steady_reads / max(len(steady_ms), 1),
    }
    if not n >= int(duration * 5) - 10:
        raise AssertionError(f"drift stream: {n} keyframes")
    if not len(seen_ids) > STRESS_IDS_PER_SECOND * duration:
        raise AssertionError(f"drift stream: {len(seen_ids)} unique landmark ids (no churn)")
    if not seg_err.max() < STRESS_SEG_MAX_M:
        raise AssertionError(f"drift stream: segment divergence from batch {seg_err}")
    if not seg_err[-2:].mean() < STRESS_TREND * max(seg_err[:2].mean(), STRESS_TREND_FLOOR_M):
        raise AssertionError(f"drift stream: divergence trend {seg_err}")
    if not out["ate_fl"] < out["ate_odom"]:
        raise AssertionError(f"drift stream: window ATE {out['ate_fl']} >= odometry "
                             f"{out['ate_odom']}")
    return out


@contextlib.contextmanager
def recording(module, name: str, sink: list):
    """``module.name`` replaced while the block runs by a wrapper that
    appends each call's result to ``sink``."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        sink.append(out)
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def example_in_process(script: str, argv) -> dict:
    """``python examples/<script> *argv`` through the script's ``main()`` in
    this process (as ``cli_run_in_process`` runs the command line), with
    the launch counts set to 0 just before it and read just after. Returns
    its standard output, wall seconds, launches, and the sequences it
    generated, the results of its ``run_sequence`` calls and the
    ``OnlineSlam`` it made."""
    import io
    import runpy

    import torch

    import uslam_tpu_torch
    from uslam_tpu_torch import pipeline
    from uslam_tpu_torch.frontend import kernels
    from uslam_tpu_torch.io import synthetic
    from uslam_tpu_torch.solvers import compiled

    main_fn = runpy.run_path(str(ROOT / "examples" / script), run_name="example")["main"]
    seqs, results, onlines = [], [], []
    out = io.StringIO()
    argv0 = sys.argv
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        sys.argv = [script, *argv]
        with recording(synthetic, "generate_synthetic_sequence", seqs), \
                recording(pipeline, "run_sequence", results), \
                recording(uslam_tpu_torch, "OnlineSlam", onlines), \
                contextlib.redirect_stdout(out):
            main_fn()
        torch.cuda.synchronize()
    finally:
        sys.argv = argv0
    wall = time.perf_counter() - t0
    compiled.settle_launches()
    launches = dict(kernels.launch_counts)
    log(f"  $ python examples/{script} {' '.join(Path(a).name if '/' in a else a for a in argv)}"
        f" (in this process): {wall!r} s; launches {launches}")
    return {"stdout": out.getvalue(), "wall_s": wall, "launches": launches, "seqs": seqs,
            "results": results, "onlines": onlines}


def examples_on_card(bag_clip) -> dict:
    """Phase 15 (a): the port's three examples on the card, each with its
    launch counts (``EXAMPLE_RUNS``, then run_from_rosbag_torch.py on
    ``bag_clip`` written as a features bag)."""
    from uslam_tpu_torch.eval.metrics import ate_rmse

    checks, launches = {}, {}
    front = ("fast_harris", "hamming")
    back = ("preintegrate", "graph_cond")
    with tempfile.TemporaryDirectory() as tmp:
        for i, (script, argv) in enumerate(EXAMPLE_RUNS):
            label = " ".join((script,) + argv)
            if script == "run_synthetic_torch.py":
                out_dir = Path(tmp) / f"run_{i}"
                r = example_in_process(script, argv + ("--out", str(out_dir)))
                (res,), (seq,) = r["results"], r["seqs"]
                n = res.values.num_poses
                ate, ate_odom = res.metrics["ate_rmse_vs_gt"], ate_rmse(res.odom_compare,
                                                                        seq.gt_pos[:n])
                want = front + back if "--images" in argv else back
                checks[f"examples: {label} on the card, graph.dot written"] = (
                    res.values.pose_trans.device.type == "cuda"
                    and (out_dir / "graph.dot").is_file())
                checks[f"examples: {label} ATE below the DVL odometry's"] = ate < ate_odom
                if "--images" not in argv:
                    checks[f"examples: {label} runs no front end"] = r["launches"][
                        "fast_harris"] == 0
            else:
                r = example_in_process(script, argv)
                (online,), (seq,) = r["onlines"], r["seqs"]
                traj = online.trajectory()
                n = min(len(traj), len(seq.gt_pos))
                ate = ate_rmse(traj[:n], seq.gt_pos[:n])
                ate_odom = ate_rmse(seq.dvl_pose_pos[:n], seq.gt_pos[:n])
                resident = "--device-resident" in argv or "--fused" in argv
                want = front + back + (("jacobi_eigh",) if resident else ())
                checks[f"examples: {label} ATE within {ONLINE_ATE_VS_ODOM} x the DVL "
                       f"odometry's"] = ate <= ONLINE_ATE_VS_ODOM * ate_odom
                checks[f"examples: {label} every frame a keyframe"] = online.keyframes == len(
                    seq.image_t)
            checks[f"examples: {label} launched {want}"] = all(r["launches"][k] > 0 for k in want)
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
            for line in r["stdout"].splitlines()[-4:]:
                log(f"    {line}")
            log(f"    ATE {ate!r} m, DVL odometry {ate_odom!r} m, wall {r['wall_s']!r} s")

        bag = Path(tmp) / "dive_features.bag"
        write_features_bag(bag_clip, str(bag))
        label = "run_from_rosbag_torch.py"
        r = example_in_process(label, (str(bag), "--dot", str(Path(tmp) / "bag.dot")))
        (res,) = r["results"]
        n = res.values.num_poses
        gt = bag_clip.gt_pos[:n]
        ate, ate_odom = ate_rmse(res.trajectory, gt), ate_rmse(res.odom_compare, gt)
        checks[f"examples: {label} on a features bag of {len(bag_clip.features)} frames, on the "
               f"card"] = (res.values.pose_trans.device.type == "cuda"
                           and n == len(bag_clip.features))
        checks[f"examples: {label} ATE below the DVL odometry's"] = ate < ate_odom
        checks[f"examples: {label} launched {back}"] = all(r["launches"][k] > 0 for k in back)
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for line in r["stdout"].splitlines():
            log(f"    {line}")
        log(f"    ATE {ate!r} m, DVL odometry {ate_odom!r} m, wall {r['wall_s']!r} s")
    return {"checks": checks, "launches": launches}


def oracle_on_card() -> dict:
    """Phase 15 (b): tests/test_oracle_parity.py:71 on the card: the
    float32 solve and the polish on the card, the exact float64 oracle
    there too (its dense solve numpy's). The sanity and parity bounds
    raise; the canary prints an ALERT line when it misses (ROADMAP C9)."""
    o = oracle_solves("cuda")
    log(f"  float32 run_solver: {o['f32_iterations']} LM iterations, converged "
        f"{o['f32_converged']}, error {o['f32_error']!r}, {o['f32_s']!r} s; polish: "
        f"{o['polish_iterations']} iterations, error {o['polish_error']!r}, {o['polish_s']!r} s; "
        f"oracle: error {o['oracle_error']!r}, {o['oracle_s']!r} s")
    log(f"  ATE vs ground truth: initial {o['ate_init']!r} m, float32 {o['ate_f32']!r} m, "
        f"polished {o['ate_polished']!r} m, oracle {o['ate_oracle']!r} m; float32 / oracle "
        f"{o['ate_f32'] / o['ate_oracle']!r}, polished / oracle "
        f"{o['ate_polished'] / o['ate_oracle']!r}")
    if not o["ate_oracle"] < 0.5 * o["ate_init"]:
        raise AssertionError(f"oracle parity: oracle ATE {o['ate_oracle']} not below half the "
                             f"initial {o['ate_init']}")
    factor, metres = ORACLE_PARITY
    if not o["ate_polished"] <= factor * o["ate_oracle"] + metres:
        raise AssertionError(f"oracle parity: polished ATE {o['ate_polished']} > {factor} x "
                             f"oracle {o['ate_oracle']} + {metres}")
    if not o["ate_f32"] <= ORACLE_CANARY * o["ate_oracle"]:
        log(f"ALERT: the float32 canary misses on the card: float32 ATE {o['ate_f32']!r} > "
            f"{ORACLE_CANARY} x oracle {o['ate_oracle']!r} (ROADMAP C9)")
    return {"checks": {
        "oracle parity: the float32 solve converged on the card": o["f32_converged"],
        f"oracle parity: polished ATE within {factor} x the oracle's + {metres} m "
        "(raises otherwise)": True,
    }, "oracle": o}


def stress_on_card() -> dict:
    """Phase 15 (c): the 30 s drift stream on the card, on the host path and
    device-resident, each held to tests/test_fixed_lag_stress.py's four
    bounds (``run_stress`` raises)."""
    out = {}
    for label, resident in (("host path", False), ("device-resident", True)):
        s = run_stress(STRESS_SECONDS, "cuda", device_resident=resident)
        out[label] = s
        log(f"  {label}: {s['keyframes']} keyframes, {s['unique_ids']} unique landmark ids; "
            f"seg_err {s['seg_err']!r} (< {STRESS_SEG_MAX_M} m); ATE window {s['ate_fl']!r} m vs "
            f"DVL odometry {s['ate_odom']!r} m; batch solve {s['batch_s']!r} s, stream "
            f"{s['window_s']!r} s wall; steady keyframe host ms median {s['steady_median_ms']!r}, "
            f"p90 {s['steady_p90_ms']!r} ({s['steady']} steady); LM host reads per steady "
            f"keyframe {s['reads_per_steady']!r}")
    return {"checks": {
        f"drift stream ({STRESS_SECONDS} s, window {STRESS_WINDOW}), {k}: the JAX test's four "
        "bounds (raise otherwise)": True for k in out}, "stress": out}


def quality_phase(bag_clip) -> dict:
    """Phase 15: (a) the examples, (b) the oracle parity, (c) the drift
    stream, all on the card."""
    t_phase = time.perf_counter()
    log("quality (a): the port's examples on the card")
    ex = examples_on_card(bag_clip)
    log("quality (b): ATE parity against the exact float64 oracle (100 keyframes)")
    orc = oracle_on_card()
    log("quality (c): the fixed-lag drift stream")
    st = stress_on_card()
    log(f"quality phase: {time.perf_counter() - t_phase!r} s")
    return {"checks": {**ex["checks"], **orc["checks"], **st["checks"]},
            "launches": ex["launches"]}


def finish_alone(checks: dict, device_name: str) -> int:
    """The end of a run of one phase: its checks, then the last line."""
    import torch

    for name, ok in checks.items():
        log(f"  check {'PASS' if ok else 'FAIL'}: {name}")
    if not all(checks.values()):
        raise AssertionError("checks failed")
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


def only_surface(device_name: str) -> int:
    """``--only-surface``: phase 13 alone."""
    from uslam_tpu_torch.config import UslamConfig

    checks = surface_phase(UslamConfig())["checks"]
    return finish_alone(checks, device_name)


def only_quality(device_name: str) -> int:
    """``--only-quality``: phase 15 alone, its bag made from a features
    sequence of ``ONLINE_SECONDS`` in place of phase 11 (a)'s clip."""
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence

    clip = generate_synthetic_sequence(SyntheticSpec(duration=ONLINE_SECONDS,
                                                     odom_drift_rate=0.05))
    return finish_alone(quality_phase(clip)["checks"], device_name)


def only_parallel(device_name: str, probe_checks: dict) -> int:
    """``--only-parallel``: phase 12 alone (after phase 2's probe), on
    inputs made for it (the 1k solve, the 2000-pose survey at its initial
    values, the first chunk of a 2 s dive)."""
    import numpy as np

    from uslam_tpu_torch.config import UslamConfig
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.interop import to_port
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence

    cfg = UslamConfig()
    seq = generate_synthetic_sequence(SyntheticSpec(duration=2.0, odom_drift_rate=0.05),
                                      cfg.camera, render_images=True, omit_features=True)
    c = cfg.frontend.offline_chunk
    pairs = np.clip(np.stack([seq.images_left[:c], seq.images_right[:c]], 1), 0, 255)
    s_seq, s_cfg = survey_problem(SURVEY_POSES[0])
    g_np, v_np, _, _ = pack_sequence(s_seq, s_cfg)
    survey = {"graph": to_port(g_np, "cuda"), "values": to_port(v_np, "cuda"),
              "initial": to_port(v_np, "cuda"), "cfg": s_cfg}
    checks = dict(probe_checks)
    checks.update(parallel_phase(load_1k(), survey, pairs.astype(np.uint8), cfg)["checks"])
    return finish_alone(checks, device_name)


def only_compiled(device_name: str, probe_checks: dict) -> int:
    """``--only-compiled``: the preintegration kernel against its plain
    version and oracle (phase 3's part), the 1k solve and its graph checks
    and per-iteration times (phase 7's part), then phase 14 on inputs made
    for it: the slice's solve (the rendered dive through ``run_sequence``),
    the 2000-pose survey at its initial values and phase 8's pass (c)."""
    from uslam_tpu_torch.config import UslamConfig
    from uslam_tpu_torch.frontend import kernels
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.interop import to_port
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.pipeline import run_sequence

    cfg = UslamConfig()
    check_preintegrate(preintegrate_cases(cfg))
    kernels.reset_launch_counts()
    one_k = load_1k()
    log(f"1k solve: {one_k['result'].metrics['lm_iterations']} LM iterations in "
        f"{one_k['result'].metrics['solve_seconds']!r} s; launches {dict(kernels.launch_counts)}")
    log_graphs("the 1k solve")
    checks = dict(probe_checks)
    checks.update(compiled_1k(one_k)["checks"])
    seq = generate_synthetic_sequence(SyntheticSpec(duration=20.0, odom_drift_rate=0.05),
                                      cfg.camera, render_images=True, omit_features=True)
    m = run_sequence(seq, cfg, device="cuda").metrics
    log(f"slice: {m['lm_iterations']} LM iterations, error {m['final_error']!r}, solve "
        f"{m['solve_seconds']!r} s")
    s_seq, s_cfg = survey_problem(SURVEY_POSES[0])
    g_np, v_np = pack_sequence(s_seq, s_cfg)[:2]
    survey = {"graph": to_port(g_np, "cuda"), "initial": to_port(v_np, "cuda"), "cfg": s_cfg}
    c = online_pass("(c) device-resident", cfg, seq, *online_inputs(seq), device_resident=True)
    checks["online (c): no CUDA-graph capture on or after the first steady keyframe"] = (
        c["steady_captures"] == 0)
    checks["online (c): the window LM reads nothing on the host"] = c["steady_reads"] == 0
    checks.update(lm_graph_phase(seq, cfg, one_k, survey, c["online"])["checks"])
    return finish_alone(checks, device_name)


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
    ).stdout.strip().splitlines()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"device: {device_name}")
    for line in smi:
        log(line)
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 must be False")

    from uslam_tpu_torch import cuda_build
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
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"  fast_harris SASS: {sass_loop_summary(kernels.load()._name)}")
    preintegrate_sass(kernels.load()._name)
    from uslam_tpu_torch import native

    t0 = time.perf_counter()
    log(f"build: C++ bag scanner {Path(native.load()._name).name} in "
        f"{time.perf_counter() - t0:.2f} s")
    probe = graph_cond_probe()
    if sys.argv[1:] == ["--only-parallel"]:
        return only_parallel(device_name, probe["checks"])
    if sys.argv[1:] == ["--only-compiled"]:
        return only_compiled(device_name, probe["checks"])
    if sys.argv[1:] == ["--only-surface"]:
        return only_surface(device_name)
    if sys.argv[1:] == ["--only-quality"]:
        return only_quality(device_name)
    if sys.argv[1:]:
        print(f"unknown arguments {sys.argv[1:]}: none, --only-parallel, --only-compiled, "
              "--only-surface or --only-quality", file=sys.stderr)
        return 2

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
    # Phase 12's front-end input: the chunk as uint8 frames, as a camera gives them.
    first_chunk = np.clip(pairs, 0, 255).astype(np.uint8)
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
    pi = check_preintegrate(preintegrate_cases(cfg))
    jac = check_jacobi()
    profile_chunk(seq, cfg)

    # ---- 4. the slice, default config: run_sequence on the card ------------
    n_frames = len(seq.image_t)
    n_chunks = math.ceil(n_frames / chunk)
    from uslam_tpu_torch.solvers import compiled

    log_graphs("before phase 4")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_sequence(seq, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    m = result.metrics
    accepts = compiled.runs.get("lm_linearize", [0])[0]
    # From the LM's code, on the first solve of these shapes: the capture's
    # warm-up runs the first linearization and error, one step's error and
    # both branches of its re-linearization (4 preintegrate launches); the
    # replay the first linearization and error, one error per iteration and
    # one linearization per accepted step, and the condition kernel once
    # before the loop and twice per iteration (the IF's, the loop's).
    solve_launches = {"preintegrate": 4 + 2 + m["lm_iterations"] + accepts,
                      "graph_cond": 1 + 2 * m["lm_iterations"]}
    n_poses, n_rows = m["num_poses"], m["num_landmarks"]
    ate_odom = ate_rmse(result.odom_compare, seq.gt_pos[:n_poses])
    s = result.graph.stereo
    n_lm_obs = int(torch.unique(s.lm_idx[s.mask > 0]).numel())
    log("slice (default SolverConfig: Schur + velocity elimination):")
    log(f"  launches: {launches} expected fast_harris={n_chunks * levels} "
        f"hamming={n_chunks} ({n_chunks} chunks of {chunk}, {levels} levels), {solve_launches} "
        f"({accepts} accepted LM steps)")
    log(f"  frontend: {m['frontend_frames']} frames in {m['frontend_seconds']!r} s "
        f"= {m['frontend_frames'] / m['frontend_seconds']!r} frames/s")
    obs_per_lm = np.bincount(s.lm_obs_mask.sum(1).long().cpu().numpy())
    log(f"  reduced system 6N+6 = {6 * n_poses + 6} (N={n_poses}); landmark rows M={n_rows}, "
        f"observed {n_lm_obs}; full tangent {9 * n_poses + 6 + 3 * n_rows}; landmarks by "
        f"observation count {dict((k, int(c)) for k, c in enumerate(obs_per_lm) if k and c)}")
    log(f"  pack: {m['pack_seconds']!r} s; solve: {m['solve_seconds']!r} s, "
        f"{m['lm_iterations']} LM iterations, converged={m['converged']}")
    log(f"  LM iterations and final error {(m['lm_iterations'], m['final_error'])!r} beside the "
        f"former layout's {SLICE_BEFORE!r}: equal "
        f"{(m['lm_iterations'], m['final_error']) == SLICE_BEFORE}")
    log(f"  error {m['initial_error']!r} -> {m['final_error']!r}")
    log(f"  ATE vs ground truth {m['ate_rmse_vs_gt']!r} m; DVL odometry {ate_odom!r} m")
    log(f"  run_sequence wall {wall!r} s")
    traj = result.trajectory
    checks = {
        f"slice: {SLICE_BEFORE} LM iterations and final error, as before": (
            (m["lm_iterations"], m["final_error"]) == SLICE_BEFORE),
        "fast_harris launched once per level per chunk": launches["fast_harris"] == n_chunks * levels,
        "hamming launched once per chunk": launches["hamming"] == n_chunks,
        f"the LM's launches as its code gives them ({accepts} accepted steps): {solve_launches}": (
            {k: launches[k] for k in solve_launches} == solve_launches),
        "every frame went through the front end": m["frontend_frames"] == n_frames,
        "trajectory shape and finite": traj.shape == (n_poses, 3) and bool(np.isfinite(traj).all()),
        "final_error < initial_error": m["final_error"] < m["initial_error"],
        "at least 20 landmarks observed": n_lm_obs >= 20,
        "ATE finite and below the DVL odometry's": math.isfinite(m["ate_rmse_vs_gt"])
        and m["ate_rmse_vs_gt"] < ate_odom,
    }
    checks.update(probe["checks"])
    checks["jacobi_eigh: bit-identical to its plain version on phase 3's SPD 15 x 15, float32 "
           "and float64"] = jac["same_spd15"]
    profile_solve(result, cfg, "slice")
    log_graphs("phase 4 (slice)")

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

    log_graphs("phase 5 (Schur vs dense)")

    # ---- 6. the offline tail: f64 polish and marginals on the card ---------
    checks.update(offline_tail(result, seq, cfg))
    log_graphs("phase 6 (polish, marginals)")

    # ---- 7. the solver at its published scale: the 1k-pose batch solve -----
    one_k = load_1k()
    log_graphs("phase 7 (the 1k solve)")
    c1k = compiled_1k(one_k)
    checks.update(c1k["checks"])
    checks.update(solve_1k(one_k))
    log_graphs("phase 7 (graph checks, polish, profile)")

    # ---- 8. the online stream: OnlineSlam on the card ----------------------
    online = online_phase(seq, cfg)
    checks.update(online["checks"])
    online_launches = online["launches"]
    log_graphs("phase 8 (online)")

    # ---- 9. the survey sweep on the banded solver and its certificate ------
    survey_checks, survey_2k = survey_phase()
    checks.update(survey_checks)
    log_graphs("phase 9 (survey)")

    # ---- 10. the KLT temporal tracker on the dive's first seconds ----------
    klt = klt_phase(seq, cfg)
    checks.update(klt["checks"])
    klt_launches = klt["launches"]
    log_graphs("phase 10 (KLT)")

    # ---- 11. ROS bags, npz files and the command line ------------------------
    ingest = ingest_phase(seq, cfg)
    checks.update(ingest["checks"])
    log_graphs("phase 11 (ingest, command line)")

    # ---- 12. multi-device: NCCL, landmark-sharded LM, frame-parallel ORB --------
    parallel = parallel_phase(one_k, survey_2k, first_chunk, cfg)
    checks.update(parallel["checks"])
    par = parallel["launches"]
    log_graphs("phase 12 (multi-device)")

    # ---- 13. the public surface: extract_orb, hamming_distance_matrix, ... ---
    surface = surface_phase(cfg)
    checks.update(surface["checks"])

    # ---- 14. the LM as replayed CUDA graphs, against eager blocks ----------
    checks.update(lm_graph_phase(seq, cfg, one_k, survey_2k, online["passes"][2]["online"])[
        "checks"])
    log_graphs("phase 14 (the graphed LM)")

    # ---- 15. the examples, the oracle parity and the drift stream ----------
    quality = quality_phase(ingest["clip"])
    checks.update(quality["checks"])
    log_graphs("phase 15 (examples, oracle parity, drift stream)")

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
                # Phase 12 (a): one process_stereo_pairs_sharded and one
                # extract_orb_frames_sharded call over phase 3's first chunk.
                "parallel_launches": {k: v["fast_harris"] for k, v in par.items()},
                # Phase 13: extract_orb on one 1080p image.
                "surface_launches": {k: v["fast_harris"] for k, v in surface["launches"].items()},
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
                "parallel_launches": {k: v["hamming"] for k, v in par.items()},
                # Phase 13: hamming_distance_matrix at SURFACE_HAMMING.
                "surface_launches": {k: v["hamming"] for k, v in surface["launches"].items()},
            },
            {
                "name": "preintegrate", "route": "cuda",
                "source": "uslam_tpu_torch/csrc/preintegrate.cu",
                # No Pallas kernel: the lax.scan of the JAX package's
                # preintegration, jitted with the linearization.
                "replaces": "uslam_tpu/factors/imu.py:67",
                "launches": launches["preintegrate"],
                # Largest difference from the plain version, any case and type.
                "max_abs_err": pi["max_abs_err"],
                "max_rel_err_vs_jacfwd": pi["max_rel_err"],
                # The 1k solve's linearization: one row per interval (999)
                # with the Jacobian, float32; its bound counts what the
                # intervals need once.
                **{k: pi["times"][("1k", "torch.float32")][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "share": pi["times"][("1k", "torch.float32")]["bound_ms"]
                / pi["times"][("1k", "torch.float32")]["ms"],
                "library_ms": None,  # no PyTorch call computes the preintegration
                # The chain's floor, measured at 1k: the first interval
                # alone (S = 64) with the Jacobian, and an empty launch.
                "one_interval_ms": pi["times"][("1k", "torch.float32")]["one_ms"],
                "empty_launch_ms": pi["times"][("1k", "torch.float32")]["empty_ms"],
                # The error's layout (value only), float64, and the former layout
                # (24 rows per interval, the "before"), at 1k.
                "error_ms": pi["times"][("1k", "torch.float32")]["err_ms"],
                "error_bound_ms": pi["times"][("1k", "torch.float32")]["err_bound_ms"],
                "f64_ms": pi["times"][("1k", "torch.float64")]["ms"],
                "rows24_ms": pi["times"][("1k", "torch.float32")]["rows24_ms"],
                # Kernel rows per launch of one eager 1k linearization / error.
                "rows_per_launch": c1k["rows"],
                "online_launches": online_launches["preintegrate"],
                "online_pass_launches": {p["label"]: p["launches"]["preintegrate"]
                                         for p in online["passes"]},
                "klt_launches": klt_launches["preintegrate"],
                "bag_launches": ingest["bag_launches"]["preintegrate"],
                "cli_klt_launches": ingest["cli_klt_launches"]["preintegrate"],
                "parallel_launches": {k: v["preintegrate"] for k, v in par.items()},
                "keyframe_ms": pi["times"][("online window", "torch.float32")]["ms"],
                "keyframe_bound_ms": pi["times"][("online window", "torch.float32")]["bound_ms"],
                # Phase 9: the survey's layouts at each size.
                "survey_ms": survey_2k["preint_ms"],
            },
            {
                "name": "jacobi_eigh", "route": "cuda",
                "source": "uslam_tpu_torch/csrc/jacobi_eigh.cu",
                # No Pallas kernel: jnp.linalg.eigh of the window step's
                # marginal, compiled into the JAX package's keyframe program.
                "replaces": "uslam_tpu/solvers/fixed_lag.py:677",
                # Phase 8, the device-resident passes (b) and (c): one per
                # steady keyframe, and the priming at the first marginal.
                "launches": sum(p["launches"]["jacobi_eigh"] for p in online["passes"]),
                "online_pass_launches": {p["label"]: p["launches"]["jacobi_eigh"]
                                         for p in online["passes"]},
                # Against its plain version: phase 3's cases and phase 8's
                # last window marginals.
                "max_abs_err": max([jac["max_abs_err"]]
                                   + [r["max_abs_err"] for r in online["jacobi"].values()]),
                # Times on pass (b)'s last window marginal (15 x 15 float32);
                # the bound from n alone, the sweeps and the chain of
                # dependent rounds they make beside it.
                **{k: online["jacobi"]["(b) pipelined"][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                             "sweeps", "rounds")},
                "share": online["jacobi"]["(b) pipelined"]["bound_ms"]
                / online["jacobi"]["(b) pipelined"]["ms"],
                # Phase 3: the SPD 15 x 15 case in float32.
                "spd15_ms": jac["ms"], "spd15_library_ms": jac["library_ms"],
                "bit_identical_to_plain": jac["same"] and all(
                    r["same"] for r in online["jacobi"].values()),
            },
            {
                "name": "graph_cond", "route": "cuda",
                "source": "uslam_tpu_torch/csrc/graph_cond.cu",
                # No Pallas kernel: the LM's lax.while_loop (and, nested
                # in it, its lax.cond, :178, and the CG's while_loop,
                # uslam_tpu/solvers/schur.py:349), which XLA keeps on the
                # device; here the handles of a CUDA graph's WHILE and IF
                # nodes, set from a device flag or a loop's test the kernel
                # computes.
                "replaces": "uslam_tpu/solvers/lm.py:229",
                # Phase 4's solve: once before the loop, twice per LM
                # iteration (the IF's, the loop's).
                "launches": launches["graph_cond"],
                # Against its plain version (a host read of the flag, both
                # values; Test.flag() read on the host, over a grid of
                # operands); the probe's graphs against their eager runs, bit
                # for bit (phase 2's checks).
                "max_abs_err": probe["max_abs_err"],
                # Per launch inside a graph; the plain version a host read.
                # Per launch inside a graph, from a Test of the CG's form;
                # the plain version Test.flag() and a host read.
                **{k: probe[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "share": probe["bound_ms"] / probe["ms"],
                "library_ms": None,  # no PyTorch call sets a graph's conditional handle
                # From a flag; an empty kernel node (a one-thread node's
                # floor); a WHILE iteration whose body only counts, its test
                # a Test and the former flag; a host read of a flag.
                **{k: probe[k] for k in ("flag_ms", "empty_ms", "read_ms", "while_iteration_ms",
                                         "while_iteration_former_ms")},
                "online_pass_launches": {p["label"]: p["launches"]["graph_cond"]
                                         for p in online["passes"]},
            },
        ]
    }
    for k in record["kernels"]:
        # Phase 15 (a): the examples' runs, each from counts set to 0.
        k["examples_launches"] = quality["launches"][k["name"]]
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
