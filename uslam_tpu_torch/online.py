"""Online (streaming) SLAM: sensors in, pose estimates out, per keyframe
(port of :mod:`uslam_tpu.online`).

Feed IMU, pressure, DVL and stereo frames as they arrive; each stereo
frame that can be time-matched with fresh DVL messages (the
ApproximateTimeSynchronizer contract, batch.py:325) becomes a keyframe:
the per-frame ORB front end tracks features and the fixed-lag smoother
updates the estimate. Runs on ``device``, the card unless the caller asks
for the CPU.

Steady-state modes (once the window is full and has a marginal):
``device_resident`` keeps the window in device tensors; ``fused`` also
runs the front end, id interning and triangulation on the device (implies
``device_resident``); ``pipelined`` starts the device-to-host copy of
keyframe k's estimate and returns keyframe k-1's (implies ``fused``; call
:meth:`OnlineSlam.flush` to drain the last one). ``threaded_upload`` sends
the fused path's stereo pair from a pinned buffer on a side stream, which
the compute stream waits on. On the card a steady fused keyframe is CUDA
graph replays (:func:`uslam_tpu_torch.solvers.fixed_lag.fused_keyframe_step`)
with no host wait between the record's upload and the packed output; the
keyframe that makes the first marginal captures them.

``FrontendConfig(temporal_tracker="klt")`` makes the per-frame front end
associate by KLT; the fused steady-state step matches by ORB descriptors
whatever the tracker, as the JAX package's fused step does. Such an
``OnlineSlam`` logs a warning when it is built, and each keyframe's entry
in ``timings`` names the tracker that associated it.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from uslam_tpu_torch.config import DEFAULT_CONFIG, UslamConfig
from uslam_tpu_torch.device import resolve_device, synchronize
from uslam_tpu_torch.factors.depth import pressure_to_depth
from uslam_tpu_torch.frontend.tracker import StereoFrontend, integrate_gyro_rotvec
from uslam_tpu_torch.graph.values import Values
from uslam_tpu_torch.pipeline import AUVSlam
from uslam_tpu_torch.solvers.fixed_lag import (
    FixedLagSmoother,
    FusedFrontendState,
    FusedRecord,
    Keyframe,
    fused_keyframe_step,
    imu_whitener_record,
    unpack_step_outputs,
    upload,
)

log = logging.getLogger("uslam_tpu_torch.online")


@dataclass
class OnlineSlam:
    config: UslamConfig = field(default_factory=lambda: DEFAULT_CONFIG)
    window: int = 10
    solve_during_fill: bool = True
    device_resident: bool = False
    fused: bool = False
    pipelined: bool = False
    threaded_upload: bool = True
    # Steady-state window LM iterations per keyframe (the reference's
    # isam.update is one bounded refinement per keyframe, isam.py:341);
    # each state is refined `window` times before it leaves. Fill-phase
    # solves run config.solver. None: no cap.
    max_update_iters: int | None = 4
    device: object = "cuda"
    # RANSAC hypothesis indices (64,) for the front end; None draws them
    # from a seeded generator.
    ransac_idx: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.frontend = StereoFrontend(
            self.config.camera, self.config.frontend, device=self.device,
            ransac_idx=self.ransac_idx,
        )
        if self.pipelined:
            self.fused = True
        if self.fused:
            self.device_resident = True
            if self.config.frontend.temporal_tracker == "klt":
                log.warning("OnlineSlam(fused=True): steady keyframes match by ORB "
                            "descriptors, not by the configured KLT tracker")
        self._steady_solver = self.config.solver
        if self.max_update_iters is not None:
            self._steady_solver = dataclasses.replace(
                self.config.solver,
                max_iterations=min(self.max_update_iters, self.config.solver.max_iterations),
            )
        self.smoother = FixedLagSmoother(
            self.config, window=self.window,
            solve_during_fill=self.solve_during_fill,
            device_resident=self.device_resident,
            feat_slots=(
                self.config.frontend.max_features if self.fused else FixedLagSmoother.feat_slots
            ),
            steady_solver=self._steady_solver,
            device=self.device,
        )
        self._fe_state = None          # FusedFrontendState on the device
        self._staging = None           # threaded_upload: (pinned pair, stream, event)
        self._pending = None           # pipelined: the keyframe still to harvest
        self._last_values = None       # pipelined: the previous keyframe's estimate
        self._helper = AUVSlam(self.config, device=self.device)  # triangulation
        self._imu_buf: list = []
        self._depth: float | None = None
        self._odom: tuple | None = None       # (t, quat, pos)
        self._twist: tuple | None = None      # (t, vel)
        self._mavros: tuple | None = None     # (t, world-frame vel)
        self.keyframes = 0
        # Per-keyframe latency split (ms): front end, host triangulation,
        # and the smoother's record/solve/fetch in the device-resident
        # steady state.
        self.timings: list = []

    # ---- sensor inputs (the reference's subscriber surface) --------------

    def add_imu(self, t: float, acc, gyro, dt: float | None = None) -> None:
        dt = self.config.imu.default_dt if dt is None else dt
        self._imu_buf.append(np.concatenate([np.asarray(acc, float), np.asarray(gyro, float), [dt]]))

    def add_pressure(self, t: float, press_abs_mbar: float) -> None:
        self._depth = float(pressure_to_depth(press_abs_mbar, self.config.pressure))

    def add_dvl_pose(self, t: float, quat_wxyz, pos_xyz) -> None:
        self._odom = (t, np.asarray(quat_wxyz, float), np.asarray(pos_xyz, float))

    def add_dvl_twist(self, t: float, vel_body) -> None:
        self._twist = (t, np.asarray(vel_body, float))

    def add_mavros_vel(self, t: float, vel_world) -> None:
        """World-frame velocity (/mavros/local_position/velocity_local):
        the new keyframe's velocity initial estimate (isam.py:306,365);
        zero when absent or stale (batch.py:279)."""
        self._mavros = (t, np.asarray(vel_world, float))

    def _vel0(self, t: float) -> np.ndarray:
        if self._mavros is not None and abs(self._mavros[0] - t) <= self.config.timesync.slop:
            return self._mavros[1]
        return np.zeros(3)

    def _take_imu(self):
        """(gyro rotation since the previous keyframe or None, the buffered
        samples or None); empties the buffer."""
        buf = np.stack(self._imu_buf) if self._imu_buf else None
        self._imu_buf = []
        rv = None
        if buf is not None and self.keyframes > 0:
            rv = integrate_gyro_rotvec(buf[:, 3:6], buf[:, 6])
        return rv, buf

    def add_stereo_frame(self, t: float, left, right):
        """Process one stereo pair; returns the window estimate, or None if
        the frame cannot be synchronized (the reference drops it,
        batch.py:54)."""
        slop = self.config.timesync.slop
        if (
            self._odom is None
            or self._twist is None
            or self._depth is None
            or abs(self._odom[0] - t) > slop
            or abs(self._twist[0] - t) > slop
        ):
            log.debug("dropping frame at t=%.3f (unsynchronized)", t)
            return None
        sm = self.smoother
        if self.fused and sm._marg is not None and len(sm._frames) >= self.window:
            return self._fused_step(t, left, right)

        t0 = time.perf_counter()
        rv, imu = self._take_imu()
        ff = self.frontend.process(np.asarray(left), np.asarray(right), t, gyro_rotvec=rv)
        t1 = time.perf_counter()
        _, quat, pos = self._odom
        pos_adj = np.array([pos[0], pos[1], self._depth])
        feats = None
        if len(ff.ids):
            feats = self._helper.get_landmarks(ff.ids, ff.u0, ff.v0, ff.u1, ff.v1, quat, pos_adj)
        t2 = time.perf_counter()
        n_timing = len(sm.timings)
        values = sm.add_keyframe(quat, pos_adj, self._vel0(t), imu, self._twist[1], feats)
        t3 = time.perf_counter()
        entry = {
            "frontend_ms": (t1 - t0) * 1e3,
            "triangulate_ms": (t2 - t1) * 1e3,
            "smoother_ms": (t3 - t2) * 1e3,
            "total_ms": (t3 - t0) * 1e3,
            "tracker": self.config.frontend.temporal_tracker,
        }
        if len(sm.timings) > n_timing:
            entry.update(sm.timings[-1])
        self.timings.append(entry)
        self.keyframes += 1
        self._last_values = values   # pipelined: seeds the one-keyframe lag
        if (self.fused and self.device.type == "cuda" and self._fe_state is None
                and sm._marg is not None and len(sm._frames) >= self.window):
            self._prime_fused(t, left, right)   # the next keyframe is fused
        return values

    def _upload_pair(self, left, right):
        """The stereo pair as one (2, H, W) tensor on the device, in the
        frames' dtype, and the event the compute stream must wait for (None
        when the copy is already ordered). With ``threaded_upload`` on the
        card the pair is written into a pinned buffer and copied on a side
        stream, so the host goes on with the record meanwhile."""
        if not (self.threaded_upload and self.device.type == "cuda"):
            pair = np.stack([np.asarray(left), np.asarray(right)])
            return torch.from_numpy(pair).to(self.device), None
        if self._staging is None:
            pinned = torch.from_numpy(np.stack([np.asarray(left), np.asarray(right)])).pin_memory()
            self._staging = (pinned, torch.cuda.Stream(self.device), torch.cuda.Event())
        else:
            pinned, _, done = self._staging
            done.synchronize()          # the previous copy out of the buffer has ended
            host = pinned.numpy()
            host[0], host[1] = left, right
        pinned, stream, done = self._staging
        with torch.cuda.stream(stream):
            pair = pinned.to(self.device, non_blocking=True)
            done.record(stream)
        pair.record_stream(torch.cuda.current_stream(self.device))
        return pair, done

    def _fused_frontend_state(self) -> FusedFrontendState:
        """The device front end's state, made once from the host tracker's
        (its state moves to the device)."""
        if self._fe_state is None:
            fe = self.frontend
            self._fe_state = FusedFrontendState(
                desc=fe._prev.desc, xy=fe._prev.xy, mask=fe._prev.mask,
                ids=torch.as_tensor(fe._prev_ids.astype(np.int32), device=self.device),
                next_id=torch.tensor(fe._next_id, dtype=torch.int32, device=self.device),
            )
        return self._fe_state

    def _fused_record(self, t: float, rv, imu_samples) -> FusedRecord:
        """The fused step's small inputs, float32 numpy (one upload)."""
        imu32, whit, valid = imu_whitener_record(imu_samples, self.config)
        _, quat, pos = self._odom
        return FusedRecord(
            imu=imu32, whitener=whit, imu_valid=valid,
            dvl=np.asarray(self._twist[1], np.float32),
            quat=np.asarray(quat, np.float32),
            pos_xy=np.asarray(pos[:2], np.float32),
            depth=np.float32(self._depth),
            vel0=np.asarray(self._vel0(t), np.float32),
            rotvec=np.asarray(np.zeros(3) if rv is None else rv, np.float32),
        )

    def _dispatch(self, pair, pair_copied, rec: FusedRecord, *, keep: bool = True):
        """A fused keyframe on the device, from the upload of its record
        (numpy) to the packed output: on the card, graph replays with no host
        read. ``keep=False`` drops the new states (the priming step)."""
        sm, cfg = self.smoother, self.config
        rec = upload(rec, self.device)
        if pair_copied is not None:
            torch.cuda.current_stream(self.device).wait_event(pair_copied)
        st, fe, packed = fused_keyframe_step(
            sm._dev_state, self._fused_frontend_state(), pair, rec, sm.cam, self.frontend.kvec,
            self.frontend.ransac_idx, cfg.noise.dvl_sigma, cfg.noise.stereo_sigma,
            cfg.imu.gravity, self._steady_solver, cfg.frontend,
        )
        if keep:
            sm._dev_state, self._fe_state = st, fe
        return packed

    def _prime_fused(self, t: float, left, right) -> None:
        """Capture the fused step's front graph (``"fused_front"``) at the
        keyframe that made the first marginal, on its pair, after the
        smoother captured the window's graphs, so that no steady keyframe
        captures: one fused step whose results are dropped."""
        pair, pair_copied = self._upload_pair(left, right)
        self._dispatch(pair, pair_copied, self._fused_record(t, None, None), keep=False)

    def _fused_step(self, t: float, left, right):
        """Steady-state keyframe through :func:`fused_keyframe_step`: the
        pair and one small record go up, one packed estimate comes back."""
        sm = self.smoother
        t0 = time.perf_counter()
        if sm._dev_state is None:
            sm._init_device_state(frames=list(sm._frames))
        pair, pair_copied = self._upload_pair(left, right)
        t_pair = time.perf_counter()
        rv, imu_samples = self._take_imu()
        rec = self._fused_record(t, rv, imu_samples)
        t1 = time.perf_counter()
        packed = self._dispatch(pair, pair_copied, rec)
        twist = np.asarray(self._twist[1], np.float64)
        # record_ms: the host's inputs (pair copy started, IMU, the record
        # as numpy); the record's upload and the wait on the pair's copy are
        # in the step's span (dispatch_ms, or solve_ms without pipelining).
        base = {
            "record_ms": (t1 - t0) * 1e3,
            "pair_stack_ms": (t_pair - t0) * 1e3,
            "prep_ms": (t1 - t_pair) * 1e3,
            "frontend_ms": 0.0,      # inside the device step
            "triangulate_ms": 0.0,
            "fused": True,
            "tracker": "orb",        # the fused step matches by descriptors
        }
        if self.pipelined:
            # Start the copy of keyframe k's outputs, THEN harvest k-1, so
            # that k's work is queued before the host waits on k-1's copy.
            if self.device.type == "cuda":
                host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
                host.copy_(packed, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record()
            else:
                host, copied = packed, None
            t2 = time.perf_counter()
            self._harvest_pending()
            t3 = time.perf_counter()
            entry = dict(base, dispatch_ms=(t2 - t1) * 1e3, harvest_wait_ms=(t3 - t2) * 1e3,
                         smoother_ms=(t3 - t0) * 1e3, total_ms=(t3 - t0) * 1e3, pipelined=True)
            self._pending = (host, copied, imu_samples, twist, entry)
            self.timings.append(entry)
            self.keyframes += 1
            return self._last_values
        self._harvest_pending()  # a pipelined stream that changed modes
        synchronize(self.device)
        t2 = time.perf_counter()
        fetched = unpack_step_outputs(packed.cpu().numpy())
        t3 = time.perf_counter()
        values = self._finish_keyframe(fetched, imu_samples, twist)
        entry = dict(base, solve_ms=(t2 - t1) * 1e3, fetch_ms=(t3 - t2) * 1e3,
                     smoother_ms=(t3 - t0) * 1e3, total_ms=(t3 - t0) * 1e3,
                     lm_iters=int(fetched[4].iterations))
        sm.timings.append({k: entry[k] for k in ("record_ms", "solve_ms", "fetch_ms", "lm_iters")})
        self.timings.append(entry)
        self.keyframes += 1
        return values

    def _finish_keyframe(self, fetched, imu_samples, twist):
        """Roll the host mirror of the window from a fetched estimate (the
        fused mirror's keyframes carry no features: they live on the
        device)."""
        sm = self.smoother
        pq, pt, vv, departing, _stats = fetched
        sm._frames.append(
            Keyframe(pq[-1].astype(np.float64), pt[-1].astype(np.float64),
                     vv[-1].astype(np.float64), imu_samples, twist, None)
        )
        sm._frames.popleft()
        for i, fr in enumerate(sm._frames):
            fr.quat, fr.trans, fr.vel = pq[i + 1], pt[i + 1], vv[i + 1]
        sm._trajectory.append(np.asarray(departing, np.float64))
        self._last_values = Values(
            pose_quat=pq, pose_trans=pt, vel=vv,
            bias=np.zeros(6, np.float32), landmarks=np.zeros((1, 3), np.float32),
        )
        return self._last_values

    def _harvest_pending(self) -> None:
        """Pipelined mode: wait for the previous keyframe's copy and roll
        the host mirror."""
        if self._pending is None:
            return
        host, copied, imu_samples, twist, entry = self._pending
        self._pending = None
        th = time.perf_counter()
        if copied is not None:
            copied.synchronize()
        fetched = unpack_step_outputs(host.numpy())
        entry["harvest_ms"] = (time.perf_counter() - th) * 1e3
        entry["lm_iters"] = int(fetched[4].iterations)
        self._finish_keyframe(fetched, imu_samples, twist)

    def flush(self) -> None:
        """Drain the pipelined tail, so that ``trajectory()`` and checkpoints
        see every processed frame."""
        self._harvest_pending()

    # ---- outputs ----------------------------------------------------------

    def trajectory(self) -> np.ndarray:
        """(T, 3) final + in-window positions so far."""
        self._harvest_pending()
        return self.smoother.full_trajectory()
