"""The port's fixed-lag smoother (uslam_tpu_torch/solvers/fixed_lag.py)
against the JAX package, on the CPU.

Inputs: a synthetic dive with precomputed features (persistent landmark
ids, so landmarks are seen from several keyframes), at 100 Hz IMU with 32
samples per interval to keep the CPU linearizations cheap; both packages
get the same keyframes.

Tolerances, with their reasons:
- the IMU whitener record: bit-exact against the JAX package's numpy
  whitener path (its native C++ path sums in another order: 1e-6
  relative);
- the host window graph and the device window graph: exact (the same
  float32 values moved and cast, the same interning); the device graph's
  ``lm_obs_idx`` only where ``lm_obs_mask`` is set, since the JAX package
  writes its padded slots in colliding scatter order;
- the dropped-factor marginal and one device window step in float64:
  1e-9 relative (another Cholesky, triangular solve and eigensolver); the
  marginal's square root is compared through sqrt_info^T sqrt_info
  (eigenvector signs are free);
- ``_store_marginal``: 1e-12 (both are numpy float64);
- a short stream (2.0 s, window 4): the host path against the port's
  batch solve within 0.08 m (tests/test_fixed_lag.py's gate); against the
  JAX package's host smoother within STREAM_JAX_BOUND (both float32:
  rounding differences are carried by the marginal from step to step);
  device-resident against host within 0.35 m (tests/test_fixed_lag.py's
  bound between the JAX package's two paths), each ATE within 1.2x the
  odometry's; a checkpoint resumed to the end equal to the run that was
  not interrupted (1e-5, as tests/test_fixed_lag.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uslam_tpu import config as jconfig
from uslam_tpu.geometry import camera as jcam
from uslam_tpu.io.synthetic import SyntheticSpec, generate_synthetic_sequence
from uslam_tpu.io.timesync import slice_stream
from uslam_tpu.solvers import fixed_lag as jfl
from uslam_tpu_torch.device import cast_tree
from uslam_tpu_torch.eval.metrics import ate_rmse
from uslam_tpu_torch.geometry.camera import StereoCamera
from uslam_tpu_torch.interop import config_to_port, to_port
from uslam_tpu_torch.pipeline import AUVSlam
from uslam_tpu_torch.solvers import fixed_lag as tfl

JCFG = jconfig.UslamConfig(
    imu=jconfig.ImuConfig(default_dt=0.01, max_samples_per_keyframe=32),
    solver=jconfig.SolverConfig(max_iterations=10),
)
CFG = config_to_port(JCFG)
# Steady-state steps capped as OnlineSlam caps them (bounded updates).
STEADY = dataclasses.replace(JCFG.solver, max_iterations=3)
SPEC = dict(duration=2.0, imu_rate=100.0, odom_drift_rate=0.06, seed=2)
WINDOW = 4
# Measured 0.046 m on this stream (0.017 m against the JAX package run
# with its dense solver, which has no float32 Schur noise).
STREAM_JAX_BOUND = 0.1
SIGMAS = (JCFG.noise.dvl_sigma, JCFG.noise.stereo_sigma, JCFG.imu.gravity)



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def dive():
    """(sequence, keyframes): per keyframe (quat, pos, imu since the
    previous keyframe or None, DVL velocity, features with their
    triangulated initial points)."""
    seq = generate_synthetic_sequence(SyntheticSpec(**SPEC))
    helper = AUVSlam(CFG, device="cpu")
    frames, prev_t = [], -np.inf
    for i, t in enumerate(seq.dvl_pose_t):
        sl = slice_stream(seq.imu_t, prev_t, float(t))
        prev_t = float(t)
        imu = None
        if sl.stop > sl.start:
            k = np.arange(sl.start, sl.stop)
            imu = np.concatenate(
                [seq.imu_acc[k], seq.imu_gyro[k], np.full((len(k), 1), JCFG.imu.default_dt)], 1
            )
        ff = seq.features[i]
        feats = helper.get_landmarks(ff.ids, ff.u0, ff.v0, ff.u1, ff.v1,
                                     seq.dvl_pose_quat[i], seq.dvl_pose_pos[i])
        frames.append((seq.dvl_pose_quat[i], seq.dvl_pose_pos[i], imu, seq.dvl_twist_vel[i],
                       feats or None))
    return seq, frames


@pytest.fixture
def numpy_whiteners(monkeypatch):
    """The JAX package's whiteners from its numpy path, not its C++ one."""
    from uslam_tpu import native

    monkeypatch.setattr(native, "imu_whiteners", lambda *a, **k: None)


def _marg(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    return {
        "sqrt_info": rng.normal(size=(15, 15)),
        "pose_quat": (q / np.linalg.norm(q)).astype(np.float32),
        "pose_trans": rng.normal(size=3).astype(np.float32),
        "vel": rng.normal(size=3).astype(np.float32),
        "bias": rng.normal(0, 0.01, 6).astype(np.float32),
    }


def _smoothers(frames, marg):
    """A JAX and a port smoother holding the same window (no solve)."""
    jsm = jfl.FixedLagSmoother(JCFG, window=WINDOW, solve_during_fill=False)
    tsm = tfl.FixedLagSmoother(CFG, window=WINDOW, solve_during_fill=False, device="cpu")
    for q, p, imu, dvl, feats in frames:
        jsm._frames.append(jfl._Keyframe(np.asarray(q, np.float64), np.asarray(p, np.float64),
                                         np.zeros(3), imu, np.asarray(dvl, np.float64), feats))
        tsm._frames.append(tfl.Keyframe(np.asarray(q, np.float64), np.asarray(p, np.float64),
                                        np.zeros(3), imu, np.asarray(dvl, np.float64), feats))
    jsm._marg = tsm._marg = marg
    return jsm, tsm


def test_imu_whitener_record_bit_exact(numpy_whiteners, dive):
    _, frames = dive
    rng = np.random.default_rng(1)
    long = np.concatenate([rng.normal(0, 1, (50, 3)), rng.normal(0, 0.1, (50, 3)),
                           np.full((50, 1), 0.01)], 1)
    for imu in (frames[3][2], None, long):
        ref = jfl._imu_whitener_record(imu, JCFG)
        ours = tfl.imu_whitener_record(imu, CFG)
        for a, b in zip(ref, ours):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("with_marg", [False, True], ids=["first-window", "marginal-prior"])
def test_window_graph_matches_jax(numpy_whiteners, dive, with_marg):
    _, frames = dive
    jsm, tsm = _smoothers(frames[2 : 3 + WINDOW], _marg() if with_marg else None)
    ref = jax.tree.leaves(jsm._window_graph())
    ours = jax.tree.leaves(tsm._window_graph())
    assert len(ref) == len(ours) == 31
    for a, b in zip(ref, ours):
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)


@pytest.fixture(scope="module")
def device_window(dive):
    """A device window (W = WINDOW frames and a marginal) and a new
    keyframe's record, as the JAX package builds them (numpy float32)."""
    _, frames = dive
    jsm, _ = _smoothers(frames[4 : 5 + WINDOW], _marg(3))
    jsm._marg["sqrt_info"] = np.linalg.cholesky(np.eye(15) * 50.0 + 0.1).T
    jsm._init_device_state()
    state = jax.device_get(jsm._dev_state)
    rec = jsm._frame_record_arrays(jsm._frames[-1])
    return state, rec


def test_device_window_graph_matches_jax(device_window):
    state, rec = device_window
    jg, jv, _ = jax.device_get(jfl._device_window_graph(
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, rec), JCFG))
    tg, tv = tfl.device_window_graph(to_port(state, "cpu"), to_port(rec, "cpu"))
    mask = jg.stereo.lm_obs_mask > 0
    assert mask.sum() >= 40 and (mask.sum(1) >= 2).sum() >= 10  # multi-view landmarks
    np.testing.assert_array_equal(tg.stereo.lm_obs_idx.numpy()[mask], jg.stereo.lm_obs_idx[mask])
    jg = jg._replace(stereo=jg.stereo._replace(lm_obs_idx=None))
    tg = tg._replace(stereo=tg.stereo._replace(lm_obs_idx=None))
    ref, ours = jax.tree.leaves((jg, jv)), jax.tree.leaves((tg, tv))
    assert len(ref) == len(ours) == 30
    for a, b in zip(ref, ours):
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-300)


def test_marginal_and_window_step_match_jax_f64(device_window):
    state, rec = device_window
    f64 = lambda t: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a, np.float64) if a.dtype == np.float32 else a, t)
    state64, rec64 = f64(state), f64(rec)
    with jax.enable_x64(True):
        cj = jcam.StereoCamera.from_config(JCFG.camera, jnp.float64)

        def jax_fn(st, rc, cam):
            graph, values, _ = jfl._device_window_graph(st, rc, JCFG)
            lam = jfl._marginal_information(graph, values, cam, *SIGMAS)
            return lam, jfl._window_step_core(st, rc, cam, *SIGMAS, STEADY, JCFG)

        lam_ref, (st_ref, out_ref) = jax.device_get(jax.jit(jax_fn)(
            jax.tree.map(jnp.asarray, state64), jax.tree.map(jnp.asarray, rec64), cj))
    ct = StereoCamera.from_config(CFG.camera, device="cpu", dtype=torch.float64)
    st, rc = (cast_tree(to_port(t, "cpu"), torch.float64, "cpu") for t in (state64, rec64))
    graph, values = tfl.device_window_graph(st, rc)
    lam = tfl.marginal_information(graph, values, ct, *SIGMAS)
    assert _rel(lam.numpy(), lam_ref) < 1e-9
    new_st, out = tfl.window_step(st, rc, ct, *SIGMAS, config_to_port(STEADY))
    n = WINDOW + 1
    *_, stats = tfl.unpack_step_outputs(out.numpy())
    out = out[: 10 * n + 10]
    assert stats.iterations == int(out_ref[10 * n + 12]) >= 2
    # The JAX package packs the LM statistics in float32.
    assert abs(stats.final_error - out_ref[10 * n + 11]) < 1e-6 * out_ref[10 * n + 11]
    assert _rel(out.numpy(), out_ref[: 10 * n + 10]) < 1e-9
    for f in tfl.DeviceWindowState._fields:
        a, b = getattr(st_ref, f), getattr(new_st, f).numpy()
        if f == "marg_sqrt_info":
            a, b = a.T @ a, b.T @ b
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert _rel(b, a) < 1e-9, f


def test_store_marginal_matches_jax():
    rng = np.random.default_rng(5)
    J = rng.normal(size=(15, 15))
    lam = J.T @ J - 0.5 * np.outer(J[0], J[0])      # a few negative eigenvalues
    v = dict(pose_quat=rng.normal(size=(5, 4)), pose_trans=rng.normal(size=(5, 3)),
             vel=rng.normal(size=(5, 3)), bias=rng.normal(size=6))
    jsm = jfl.FixedLagSmoother(JCFG)
    jsm._store_marginal(lam, jfl.Values(**{k: a.astype(np.float32) for k, a in v.items()},
                                        landmarks=np.zeros((1, 3), np.float32)))
    tsm = tfl.FixedLagSmoother(CFG, device="cpu")
    tsm._store_marginal(lam, tfl.Values(**{k: torch.tensor(a, dtype=torch.float32)
                                           for k, a in v.items()},
                                        landmarks=torch.zeros(1, 3)))
    assert jsm._marg.keys() == tsm._marg.keys()
    for k in jsm._marg:
        np.testing.assert_allclose(tsm._marg[k], jsm._marg[k], rtol=0, atol=1e-12, err_msg=k)


def _assert_same_state(a, b):
    """Two smoothers (either package) hold the same frames, marginal and
    trajectory."""
    assert len(a._frames) == len(b._frames) >= 1
    for fa, fb in zip(a._frames, b._frames):
        for f in ("quat", "trans", "vel", "dvl"):
            np.testing.assert_array_equal(getattr(fb, f), getattr(fa, f))
        assert (fa.imu is None) == (fb.imu is None)
        if fa.imu is not None:
            np.testing.assert_array_equal(fb.imu, fa.imu)
        assert len(fa.features or []) == len(fb.features or [])
        for x, y in zip(fa.features or [], fb.features or []):
            assert x[:4] == y[:4]
            np.testing.assert_array_equal(y[4], x[4])
    assert a._marg.keys() == b._marg.keys()
    for k in a._marg:
        np.testing.assert_array_equal(b._marg[k], a._marg[k])
    np.testing.assert_array_equal(b.trajectory, a.trajectory)


def test_smoother_state_crosses_between_packages(dive, tmp_path):
    """A state the JAX package saved (a window with features and IMU, a
    marginal, final rows) loads in the port, and the reverse; the JAX
    smoother's state saved mid-stream is in the checkpoint test below."""
    _, frames = dive
    jsm, _ = _smoothers(frames[1 : 1 + WINDOW], _marg(7))
    jsm._trajectory = [np.random.default_rng(8).normal(size=10) for _ in range(3)]
    jfl.save_smoother_state(str(tmp_path / "jax.npz"), jsm)
    ported = tfl.load_smoother_state(str(tmp_path / "jax.npz"), CFG, device="cpu")
    assert ported.window == WINDOW and ported.device.type == "cpu"
    _assert_same_state(jsm, ported)
    tfl.save_smoother_state(str(tmp_path / "port.npz"), ported)
    back = jfl.load_smoother_state(str(tmp_path / "port.npz"), JCFG)
    _assert_same_state(ported, back)


# ---- a short stream ------------------------------------------------------


@pytest.fixture(scope="module")
def stream(dive, tmp_path_factory):
    """The dive through the port's host path (its state saved), the
    same resumed from the file three keyframes before the end, the
    device-resident path, the JAX
    package's host path, and the port's batch solve."""
    _, frames = dive
    cut = len(frames) - 3                       # three steady steps after the resume
    tmp = tmp_path_factory.mktemp("fixed_lag")
    path, jax_path = str(tmp / "state.npz"), str(tmp / "jax_state.npz")

    def port_smoother(**kw):
        return tfl.FixedLagSmoother(CFG, window=WINDOW, solve_during_fill=False,
                                    steady_solver=config_to_port(STEADY), device="cpu", **kw)

    host, dev = port_smoother(), port_smoother(device_resident=True)
    jax_host = jfl.FixedLagSmoother(JCFG, window=WINDOW, solve_during_fill=False,
                                    steady_solver=STEADY)
    for k, (q, p, imu, dvl, feats) in enumerate(frames):
        if k == cut:
            tfl.save_smoother_state(path, host)
            jfl.save_smoother_state(jax_path, jax_host)
        for sm in (host, dev, jax_host):
            sm.add_keyframe(q, p, np.zeros(3), imu, dvl, feats)
    resumed = tfl.load_smoother_state(path, CFG, solve_during_fill=False,
                                      steady_solver=config_to_port(STEADY), device="cpu")
    for q, p, imu, dvl, feats in frames[cut:]:
        resumed.add_keyframe(q, p, np.zeros(3), imu, dvl, feats)

    batch = AUVSlam(CFG, device="cpu")
    for q, p, imu, dvl, feats in frames:
        batch.builder.add_keyframe(q, p, imu, dvl, feats)
    return dict(host=host, dev=dev, jax_host=jax_host, resumed=resumed, jax_path=jax_path,
                batch=batch.solve().trajectory)


def test_host_path_tracks_batch_and_jax(dive, stream):
    seq, frames = dive
    traj = stream["host"].full_trajectory()
    assert traj.shape == (len(frames), 3) and len(stream["host"].trajectory) == len(frames) - WINDOW
    assert ate_rmse(traj, stream["batch"]) < 0.08
    div = float(np.linalg.norm(traj - stream["jax_host"].full_trajectory(), axis=1).max())
    assert div < STREAM_JAX_BOUND, div
    gt = seq.gt_pos[: len(traj)]
    assert ate_rmse(traj, gt) < 1.2 * ate_rmse(np.asarray(seq.dvl_pose_pos[: len(gt)]), gt)


def test_device_resident_matches_host_path(dive, stream):
    seq, _ = dive
    th, td = stream["host"].full_trajectory(), stream["dev"].full_trajectory()
    assert td.shape == th.shape
    assert stream["dev"]._dev_state is not None
    # One solve per keyframe from the first full window on: the first one
    # on the host path (it makes the first marginal), the rest on the device.
    timings = stream["dev"].timings
    assert len(timings) == len(th) - WINDOW and "record_ms" in timings[-1]
    assert all(1 <= t["lm_iters"] <= STEADY.max_iterations for t in timings)
    assert float(np.linalg.norm(th - td, axis=1).max()) < 0.35
    gt = seq.gt_pos[: len(th)]
    ate_odom = ate_rmse(np.asarray(seq.dvl_pose_pos[: len(gt)]), gt)
    assert ate_rmse(th, gt) < 1.2 * ate_odom and ate_rmse(td, gt) < 1.2 * ate_odom


def test_checkpoint_resume_matches_uninterrupted(stream):
    np.testing.assert_allclose(stream["resumed"].full_trajectory(),
                               stream["host"].full_trajectory(), atol=1e-5)
    # The JAX package's own mid-stream state (a real marginal) loads in the
    # port as it loads in the JAX package.
    _assert_same_state(jfl.load_smoother_state(stream["jax_path"], JCFG),
                       tfl.load_smoother_state(stream["jax_path"], CFG, device="cpu"))
