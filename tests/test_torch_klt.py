"""The port's KLT tracker (uslam_tpu_torch/frontend/klt.py) and the
front end's ``temporal_tracker="klt"`` against the JAX package, on the CPU.

Tolerances, with their reasons:
- ``klt_track`` on tests/test_klt.py's three setups: valid masks equal;
  positions of the points whose iteration converged (a step below
  ``precision`` at every level, so more iterations move them no further)
  within 1e-3 px: the 15x15 window sums reduce in another order in float32,
  which moves a converged point by ~1e-5 px. A point still moving after the
  30 iterations follows that rounding along its path (measured: one of the
  24 points of the large-motion setup, 0.12 px apart), so only its mask is
  held;
- the tracker in KLT mode (tests/test_klt.py:62's frames): ids exact,
  normalized coordinates within 1e-6, given the JAX package's RANSAC
  indices; ``process_chunk`` equal to ``process`` frame by frame;
- ``run_sequence`` on the 384x240 image setup (tests/test_torch_slice.py)
  with KLT: FeatureFrames as above; final error within 25% of the JAX
  package's dense run and |ATE_port - ATE_jax| <= max(0.01 m, 10%), the
  slice test's float32 tolerances and reasons;
- ``klt_track`` on the card (``cuda`` marker; skips without one) against
  the CPU on the three setups: masks equal, converged points within 1e-3 px
  for the same reason as against JAX.
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import shift as nd_shift

from tests.test_frontend import textured_image
from tests.test_torch_frontend import jax_ransac_indices
from tests.test_torch_slice import CAM as SLICE_CAM
from tests.test_torch_slice import SPEC as SLICE_SPEC
from uslam_tpu.config import CameraConfig, FrontendConfig, SolverConfig, UslamConfig
from uslam_tpu.frontend.klt import klt_track as jax_klt_track
from uslam_tpu.frontend.tracker import StereoFrontend as JaxStereoFrontend
from uslam_tpu.io.synthetic import SyntheticSpec, generate_synthetic_sequence
from uslam_tpu.pipeline import run_sequence as jax_run_sequence
from uslam_tpu_torch import config as tconfig
from uslam_tpu_torch.frontend.klt import klt_track
from uslam_tpu_torch.frontend.tracker import StereoFrontend
from uslam_tpu_torch.interop import config_to_port
from uslam_tpu_torch.io import synthetic as tsynth
from uslam_tpu_torch.online import OnlineSlam
from uslam_tpu_torch.pipeline import run_sequence

torch.set_num_threads(1)


def _translation():
    img = textured_image(192, 256, seed=9)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(30, 226, 32), rng.uniform(30, 162, 32)], axis=-1)
    return img, nd_shift(img, (-2.3, 3.6), order=1, mode="nearest"), pts, 3


def _large_motion():
    img = textured_image(192, 256, seed=10)
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(40, 210, 24), rng.uniform(40, 150, 24)], axis=-1)
    return img, nd_shift(img, (0, 14.0), order=1, mode="nearest"), pts, 3


def _flat():
    img = np.full((96, 128), 100.0, np.float32)
    return img, img, np.array([[64.0, 48.0], [30.0, 30.0]]), 3


SETUPS = {"translation": _translation, "large-motion": _large_motion, "flat": _flat}


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_klt_track_matches_jax(name):
    img, img2, pts, levels = SETUPS[name]()
    img, img2, pts = (np.asarray(a, np.float32) for a in (img, img2, pts))
    mask = np.ones(len(pts), bool)
    ref, ref_ok = (np.asarray(a) for a in jax_klt_track(
        jnp.asarray(img), jnp.asarray(img2), jnp.asarray(pts), jnp.asarray(mask), levels=levels))
    args = (torch.from_numpy(img), torch.from_numpy(img2), torch.from_numpy(pts),
            torch.from_numpy(mask))
    ours, ok = (a.numpy() for a in klt_track(*args, levels=levels))
    longer = klt_track(*args, levels=levels, iters=60)[0].numpy()
    np.testing.assert_array_equal(ok, ref_ok)
    converged = np.all(longer == ours, axis=1)
    assert converged[ok].sum() >= {"flat": 0, "translation": 28, "large-motion": 20}[name]
    sel = ok & converged
    np.testing.assert_allclose(ours[sel], ref[sel], rtol=0, atol=1e-3)
    if name == "flat":
        assert not ok.any()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SETUPS))
def test_klt_track_on_the_card_matches_cpu(cuda, name):
    img, img2, pts, levels = SETUPS[name]()
    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in (img, img2, pts)]
    args.append(torch.ones(len(pts), dtype=torch.bool))
    cpu, cpu_ok = klt_track(*args, levels=levels)
    longer = klt_track(*args, levels=levels, iters=60)[0]
    card, card_ok = (a.cpu() for a in klt_track(*(a.to(cuda) for a in args), levels=levels))
    assert torch.equal(card_ok, cpu_ok)
    sel = cpu_ok & torch.all(longer == cpu, dim=1)
    torch.testing.assert_close(card[sel], cpu[sel], rtol=0, atol=1e-3)


def _klt_frames(rotate: bool):
    """tests/test_klt.py:62's frames: a scene moving 3 px per frame, right
    image 8 px over; with ``rotate`` a small gyro rotation from frame 1."""
    img = textured_image()
    frames = []
    for step in range(3):
        left = nd_shift(img, (0, 3 * step), order=1, mode="nearest")
        right = nd_shift(left, (0, -8.0), order=1, mode="nearest")
        rv = np.array([1e-3, -2e-3, 5e-4], np.float32) if rotate and step else None
        frames.append((left, right, 0.2 * step, rv))
    return frames


@pytest.mark.parametrize("rotate", [False, True], ids=["no-gyro", "gyro"])
def test_tracker_klt_mode_matches_jax(rotate):
    cam = CameraConfig(resolution_x=256, resolution_y=192)
    cfg = FrontendConfig(temporal_tracker="klt", klt_gate_px=2.5)
    fe_j = JaxStereoFrontend(cam, cfg)
    fe_t = StereoFrontend(config_to_port(cam), config_to_port(cfg), device="cpu",
                          ransac_idx=jax_ransac_indices(cfg.max_features))
    frames = _klt_frames(rotate)
    got_j = [fe_j.process(l, r, t, gyro_rotvec=rv) for l, r, t, rv in frames]
    got_t = [fe_t.process(l, r, t, gyro_rotvec=rv) for l, r, t, rv in frames]
    for a, b in zip(got_j, got_t):
        np.testing.assert_array_equal(b.ids, a.ids)
        for fa, fb in zip((a.u0, a.v0, a.u1, a.v1), (b.u0, b.v0, b.u1, b.v1)):
            np.testing.assert_allclose(fb, fa, rtol=0, atol=1e-6)
    assert len(got_t[0].ids) >= 8
    assert len(np.intersect1d(got_t[0].ids, got_t[1].ids)) >= 3
    # The chunked entry point runs KLT frame by frame: the same frames.
    fe_c = StereoFrontend(config_to_port(cam), config_to_port(cfg), device="cpu",
                          ransac_idx=jax_ransac_indices(cfg.max_features))
    lefts, rights, ts, rvs = zip(*frames)
    rvs = np.stack([np.zeros(3, np.float32) if rv is None else rv for rv in rvs])
    chunk = fe_c.process_chunk(np.stack(lefts), np.stack(rights), np.array(ts), rvs)
    for a, b in zip(got_t, chunk):
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_array_equal(b.u0, a.u0)


def test_run_sequence_klt_matches_jax():
    cfg = UslamConfig(
        camera=SLICE_CAM,
        frontend=FrontendConfig(pyramid_levels=1, max_features_per_cell=6,
                                temporal_tracker="klt"),
    )
    seq_jax = generate_synthetic_sequence(
        SyntheticSpec(**SLICE_SPEC), cam_cfg=SLICE_CAM, render_images=True, omit_features=True)
    seq_port = tsynth.generate_synthetic_sequence(
        tsynth.SyntheticSpec(**SLICE_SPEC), config_to_port(SLICE_CAM), render_images=True,
        omit_features=True)
    ref = jax_run_sequence(
        seq_jax, dataclasses.replace(cfg, solver=SolverConfig(linear_solver="dense")))
    ours = run_sequence(seq_port, config_to_port(cfg), device="cpu",
                        ransac_idx=jax_ransac_indices(cfg.frontend.max_features))
    assert len(seq_port.features) == len(seq_jax.features) == len(seq_jax.image_t)
    for a, b in zip(seq_jax.features, seq_port.features):
        np.testing.assert_array_equal(b.ids, a.ids)
        for fa, fb in zip((a.u0, a.v0, a.u1, a.v1), (b.u0, b.v0, b.u1, b.v1)):
            np.testing.assert_allclose(fb, fa, rtol=0, atol=1e-6)
    ids = np.concatenate([f.ids for f in seq_port.features])
    assert (np.bincount(ids) >= 2).sum() >= 10       # KLT carries tracks across frames
    m, mj = ours.metrics, ref.metrics
    assert m["num_poses"] == mj["num_poses"] >= 15
    assert m["final_error"] < 1e-6 * m["initial_error"]
    assert abs(m["final_error"] - mj["final_error"]) <= 0.25 * mj["final_error"]
    ate, ate_jax = m["ate_rmse_vs_gt"], mj["ate_rmse_vs_gt"]
    assert abs(ate - ate_jax) <= max(0.01, 0.1 * ate_jax), (ate, ate_jax)


def test_online_slam_accepts_klt(caplog):
    """OnlineSlam takes the KLT tracker as the JAX package's does (its
    per-frame front end); a fused one, whose steady step matches by ORB,
    says so; an unknown tracker raises."""
    cam = tconfig.CameraConfig(resolution_x=256, resolution_y=192)
    cfg = tconfig.UslamConfig(camera=cam, frontend=tconfig.FrontendConfig(
        temporal_tracker="klt", klt_gate_px=2.5))
    online = OnlineSlam(cfg, window=4, solve_during_fill=False, device="cpu")
    assert online.frontend.cfg.temporal_tracker == "klt"
    frames = [online.frontend.process(l, r, t, rv) for l, r, t, rv in _klt_frames(False)]
    assert len(np.intersect1d(frames[0].ids, frames[2].ids)) >= 3
    assert "match by ORB" not in caplog.text
    with caplog.at_level(logging.WARNING, logger="uslam_tpu_torch.online"):
        OnlineSlam(cfg, window=4, fused=True, device="cpu")
    assert "match by ORB" in caplog.text
    bad = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                temporal_tracker="sift"))
    with pytest.raises(ValueError, match="temporal_tracker"):
        OnlineSlam(bad, device="cpu")
