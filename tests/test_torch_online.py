"""The port's online path (uslam_tpu_torch/online.py and the per-frame front
end) against the JAX package, on the CPU.

Tolerances, with their reasons:
- the per-frame front end (``orb_pair_step``, ``StereoFrontend.process``):
  keypoints, descriptors, matches, ids and normalized coordinates exact,
  given the JAX package's own RANSAC hypothesis indices;
- on-device id interning: equal to the host loop, id for id;
- ``triangulate_stereo``: 1e-12 absolute in float64 (same formula, same
  order);
- a short stream (SMALL_CAM of tests/test_online_fused.py, 2 s, window
  4) through the host, split (device-resident) and fused paths: fused
  against split within 0.4 m, the JAX package's bound between its own two
  paths (tests/test_online_fused.py); fused ATE below the DVL odometry's;
- pipelined against fused: the same computations on the same inputs, so
  equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import shift as nd_shift

from tests.test_frontend import textured_image
from tests.test_torch_frontend import jax_ransac_indices
from uslam_tpu.config import CameraConfig, FrontendConfig
from uslam_tpu.frontend import tracker as jtracker
from uslam_tpu.geometry import camera as jcam
from uslam_tpu.geometry import se3 as jse3
from uslam_tpu_torch import config as tconfig
from uslam_tpu_torch.eval.metrics import ate_rmse
from uslam_tpu_torch.frontend import tracker as ttracker
from uslam_tpu_torch.geometry import camera as tcam
from uslam_tpu_torch.geometry.se3 import Pose3
from uslam_tpu_torch.interop import config_to_port, from_port
from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
from uslam_tpu_torch.online import OnlineSlam
from uslam_tpu_torch.solvers.fixed_lag import intern_ids

CAM = CameraConfig(fx=200.0, fy=200.0, cx=128.0, cy=96.0, baseline=0.1,
                   resolution_x=256, resolution_y=192)
FCFG = FrontendConfig(pyramid_levels=1, max_features_per_cell=6)
SMALL_CAM = tconfig.CameraConfig(
    fx=300.0, fy=300.0, cx=160.0, cy=120.0, baseline=0.35, resolution_x=320, resolution_y=240,
)


def _frames(n=5):
    """A textured scene moving (1, 3) px per frame, with its right image 8 px
    over; uint8, as a camera gives them."""
    img = textured_image()
    lefts, rights = [], []
    for step in range(n):
        left = nd_shift(img, (step, 3 * step), order=1, mode="nearest")
        lefts.append(left)
        rights.append(nd_shift(left, (0, -8.0), order=1, mode="nearest"))
    u8 = lambda a: np.clip(np.stack(a), 0, 255).astype(np.uint8)  # noqa: E731
    return u8(lefts), u8(rights)


def _rotvecs(n):
    rv = np.zeros((n, 3), np.float32)
    rv[3:] = [1e-3, -2e-3, 5e-4]
    return rv


def test_orb_pair_step_matches_jax():
    lefts, rights = _frames(2)
    cfg_t = config_to_port(FCFG)
    K = FCFG.max_features
    idx = jax_ransac_indices(K)
    kvec = np.array([CAM.fx, CAM.fy, CAM.cx, CAM.cy], np.float32)
    rv = np.array([1e-3, -2e-3, 5e-4], np.float32)
    prev_j = (jnp.zeros((K, 8), jnp.uint32), jnp.zeros((K, 2)), jnp.zeros(K, bool))
    prev_t = ttracker.StereoFrontend(config_to_port(CAM), cfg_t, device="cpu")._prev
    n_tracked = 0
    for f in range(2):
        pair = np.stack([lefts[f], rights[f]])
        ref = jax.device_get(jtracker._orb_pair_step(
            pair, *prev_j, FCFG, jnp.asarray(rv), jnp.asarray(kvec)))
        ours = ttracker.orb_pair_step(
            torch.from_numpy(pair).float(), prev_t, cfg_t, torch.from_numpy(rv),
            torch.from_numpy(kvec), torch.from_numpy(idx),
        )
        for kp_t, kp_j in zip(ours[:2], ref[:2]):
            kt = from_port(kp_t, kp_j)
            np.testing.assert_array_equal(kt.mask, kp_j.mask)
            for name in ("xy", "level", "desc"):
                np.testing.assert_array_equal(getattr(kt, name)[kp_j.mask],
                                              getattr(kp_j, name)[kp_j.mask], err_msg=name)
        for a, b in zip(ours[2:], ref[2:]):
            np.testing.assert_array_equal(a.numpy(), b)
        n_tracked += int((ref[4] >= 0).sum())
        prev_j = (ref[0].desc, ref[0].xy, ref[0].mask)
        prev_t = ours[0]
    assert int(ref[3].sum()) >= 8 and n_tracked >= 8


def test_process_matches_jax():
    """Five frames through the per-frame front end, with gyro rotation on
    the last two: ids, coordinates and the tracks across frames."""
    lefts, rights = _frames(5)
    rvs = _rotvecs(5)
    fe_j = jtracker.StereoFrontend(CAM, FCFG)
    fe_t = ttracker.StereoFrontend(config_to_port(CAM), config_to_port(FCFG), device="cpu",
                                   ransac_idx=jax_ransac_indices(FCFG.max_features))
    got = []
    for f in range(5):
        a = fe_j.process(lefts[f], rights[f], 0.2 * f, gyro_rotvec=rvs[f])
        b = fe_t.process(lefts[f], rights[f], 0.2 * f, gyro_rotvec=rvs[f])
        assert a.t == b.t
        np.testing.assert_array_equal(b.ids, a.ids)
        for fa, fb in zip((a.u0, a.v0, a.u1, a.v1), (b.u0, b.v0, b.u1, b.v1)):
            np.testing.assert_array_equal(fb, fa)
        got.append(b)
    assert len(got[0].ids) >= 8
    assert len(np.intersect1d(got[3].ids, got[4].ids)) >= 3
    fe_t.reset()
    assert fe_t._next_id == 0 and not bool(fe_t._prev.mask.any())


def test_intern_ids_on_device_matches_host_loop():
    rng = np.random.default_rng(4)
    K = 48
    fe = ttracker.StereoFrontend(tconfig.CameraConfig(), tconfig.FrontendConfig(), device="cpu")
    fe._prev_ids = np.where(rng.uniform(size=K) < 0.7, rng.integers(0, 90, K), -1)
    fe._next_id = 90
    for _ in range(4):
        stereo_ok = rng.uniform(size=K) < 0.6
        tm_idx = np.where(rng.uniform(size=K) < 0.5, rng.integers(0, K, K), -1)
        prev_ids = torch.tensor(fe._prev_ids, dtype=torch.int32)
        ids, next_id = intern_ids(prev_ids, torch.tensor(fe._next_id, dtype=torch.int32),
                                  torch.from_numpy(stereo_ok), torch.from_numpy(tm_idx))
        ref = fe._intern_ids(stereo_ok, tm_idx)
        np.testing.assert_array_equal(ids.numpy(), ref)
        assert int(next_id) == fe._next_id and ids.dtype == torch.int32
    assert (ref >= 0).sum() >= 10


def test_triangulate_stereo_matches_jax_f64():
    rng = np.random.default_rng(6)
    cfg = tconfig.CameraConfig()
    meas = np.stack([rng.uniform(800, 1100, 32), rng.uniform(700, 790, 32),
                     rng.uniform(400, 700, 32)], -1)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    t = rng.normal(size=3)
    with jax.enable_x64(True):
        cj = jcam.StereoCamera.from_config(CameraConfig(), jnp.float64)
        ref = np.asarray(jcam.triangulate_stereo(cj, jse3.Pose3(jnp.asarray(q), jnp.asarray(t)),
                                                 jnp.asarray(meas)))
    ct = tcam.StereoCamera.from_config(cfg, device="cpu", dtype=torch.float64)
    ours = tcam.triangulate_stereo(ct, Pose3(torch.tensor(q), torch.tensor(t)), torch.tensor(meas))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.numpy(), tcam.triangulate_stereo_np(cfg, q, t, meas),
                               rtol=0, atol=1e-12)


# ---- the online stream ----------------------------------------------------


def _stream(online, seq) -> None:
    """Every sensor message of ``seq`` in time order (tests/test_online_fused.py)."""
    events = (
        [("imu", t, i) for i, t in enumerate(seq.imu_t)]
        + [("press", t, i) for i, t in enumerate(seq.pressure_t)]
        + [("pose", t, i) for i, t in enumerate(seq.dvl_pose_t)]
        + [("twist", t, i) for i, t in enumerate(seq.dvl_twist_t)]
        + [("frame", t, i) for i, t in enumerate(seq.image_t)]
    )
    events.sort(key=lambda e: e[1])
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
            online.add_stereo_frame(t, seq.images_left[i], seq.images_right[i])



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def streams():
    """A 2 s SMALL_CAM stream (10 keyframes; 100 Hz IMU, 32 samples per
    interval, and 2 LM iterations per steady keyframe, to keep the CPU
    linearizations cheap) through the host, split, fused and pipelined
    paths with a window of 4."""
    cfg = tconfig.UslamConfig(
        camera=SMALL_CAM,
        imu=tconfig.ImuConfig(default_dt=0.01, max_samples_per_keyframe=32),
        frontend=tconfig.FrontendConfig(pyramid_levels=2),
        solver=tconfig.SolverConfig(max_iterations=10),
    )
    seq = generate_synthetic_sequence(
        SyntheticSpec(duration=2.0, imu_rate=100.0, odom_drift_rate=0.03, seed=3),
        SMALL_CAM, render_images=True, omit_features=True,
    )
    seq.images_left = np.clip(seq.images_left, 0, 255).astype(np.uint8)
    seq.images_right = np.clip(seq.images_right, 0, 255).astype(np.uint8)
    runs = {}
    for name, mode in (("host", {}), ("split", dict(device_resident=True)),
                       ("fused", dict(fused=True)), ("pipelined", dict(pipelined=True))):
        online = OnlineSlam(cfg, window=4, solve_during_fill=False, max_update_iters=2,
                            device="cpu", **mode)
        _stream(online, seq)
        runs[name] = online
    return seq, runs


def test_stream_paths_agree(streams):
    seq, runs = streams
    n_kf = {name: o.keyframes for name, o in runs.items()}
    assert set(n_kf.values()) == {len(seq.image_t)}, n_kf
    assert any(e.get("fused") for e in runs["fused"].timings)
    assert all(e["tracker"] == "orb" for e in runs["fused"].timings)
    assert runs["split"].smoother._dev_state is not None
    trajs = {name: runs[name].trajectory() for name in ("host", "split", "fused")}
    assert all(t.shape == (len(seq.image_t), 3) and np.isfinite(t).all() for t in trajs.values())
    div = float(np.linalg.norm(trajs["fused"] - trajs["split"], axis=1).max())
    assert div < 0.4, div
    gt = seq.gt_pos[: len(seq.image_t)]
    ate = {name: ate_rmse(t, gt) for name, t in trajs.items()}
    ate_odom = ate_rmse(np.asarray(seq.dvl_pose_pos[: len(gt)]), gt)
    assert ate["fused"] < ate_odom, (ate, ate_odom)
    assert ate["host"] < 1.2 * ate_odom, (ate, ate_odom)
    steady = [e for e in runs["split"].timings if "lm_iters" in e]
    assert steady and all(1 <= e["lm_iters"] <= 2 for e in steady)


def test_pipelined_equals_fused_bit_for_bit(streams):
    _, runs = streams
    piped, fused = runs["pipelined"], runs["fused"]
    assert any(e.get("pipelined") for e in piped.timings)
    assert piped._pending is not None      # the last keyframe waits for a harvest
    piped.flush()
    assert piped._pending is None
    assert all("lm_iters" in e for e in piped.timings if e.get("pipelined"))
    np.testing.assert_array_equal(piped.trajectory(), fused.trajectory())
    np.testing.assert_array_equal(piped.smoother.trajectory, fused.smoother.trajectory)


def test_online_drops_unsynchronized_frames():
    online = OnlineSlam(tconfig.UslamConfig(), window=4, device="cpu")
    img = np.zeros((48, 64), np.float32)
    assert online.add_stereo_frame(0.0, img, img) is None  # no odometry, twist or depth yet
    online.add_pressure(0.0, 1000.0)
    online.add_dvl_pose(0.0, [1, 0, 0, 0], [0, 0, 0])
    online.add_dvl_twist(0.0, [0, 0, 0])
    assert online.add_stereo_frame(5.0, img, img) is None  # far outside the slop
    assert online.keyframes == 0


def test_steady_state_iteration_cap_default():
    online = OnlineSlam(tconfig.UslamConfig(), device="cpu")
    assert online.max_update_iters == 4 and online.window == 10
    assert online._steady_solver.max_iterations == 4
    assert online.smoother.steady_solver.max_iterations == 4
    assert online.config.solver.max_iterations > 4
    assert online.solve_during_fill and online.threaded_upload


def test_online_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from uslam_tpu_torch import FixedLagSmoother
    from uslam_tpu_torch import OnlineSlam as RootOnlineSlam

    assert RootOnlineSlam is OnlineSlam
    for make in (lambda: OnlineSlam(), lambda: FixedLagSmoother(tconfig.UslamConfig())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_online_kernel_launches_per_keyframe(cuda):
    """On the card: 3 fast_harris launches (2 images at each of 3 levels)
    and 1 hamming launch per keyframe, on the host and the fused path."""
    from uslam_tpu_torch.frontend import kernels

    cam = tconfig.CameraConfig(fx=600.0, fy=600.0, cx=320.0, cy=240.0, baseline=0.2,
                               resolution_x=640, resolution_y=480)
    cfg = tconfig.UslamConfig(camera=cam)
    seq = generate_synthetic_sequence(SyntheticSpec(duration=3.0, odom_drift_rate=0.03, seed=3),
                                      cam, render_images=True, omit_features=True)
    for mode in ({}, dict(pipelined=True)):
        kernels.reset_launch_counts()
        online = OnlineSlam(cfg, window=4, solve_during_fill=False, device=cuda, **mode)
        _stream(online, seq)
        online.flush()
        assert kernels.launch_counts == {"fast_harris": 3 * online.keyframes,
                                         "hamming": online.keyframes}
        assert np.isfinite(online.trajectory()).all()
