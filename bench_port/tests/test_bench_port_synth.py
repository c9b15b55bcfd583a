"""The frozen dive generator is a faithful copy, and the front end's
track budget keeps what the grid keeps.

The digest was recorded from the port's own generator
(uslam_tpu_torch/io/synthetic.py, ``generate_synthetic_sequence``) on the
spec below with the default ZED-mini camera and pressure; this test
imports nothing of the port, so a later change there cannot break it."""

import numpy as np
import synth

CAMERA = dict(fx=1827.0, fy=1827.5999755859375, cx=968.9000244140625, cy=561.4000244140625,
              baseline=0.063, resolution_x=1920, resolution_y=1080)
PRESSURE = dict(atm_pressure_pa=98250.0, water_density=997.0, gravity=9.81)
SPEC = dict(duration=4.0, num_landmarks=64, omega=0.15, odom_drift_rate=0.02,
            feature_noise_px=0.3, seed=12345)
PORT_DIGEST = "9674f99b34ad326042d10f0fb2dd8a6159dc2198375759ea15c69d372dcc03f9"


def test_generator_reproduces_the_ports_draws():
    dive = synth.generate(synth.DiveSpec(**SPEC), synth.Camera(**CAMERA), PRESSURE)
    assert synth.digest(dive) == PORT_DIGEST
    assert sum(len(f["ids"]) for f in dive.features) == 71


def test_track_budget_keeps_the_grids_tracks():
    cam = synth.Camera(**CAMERA)
    spec = synth.DiveSpec(duration=20.0, num_landmarks=4000, landmark_z_spread=4.0, z0=-6.0,
                          omega=0.15, seed=21)
    dive = synth.generate(spec, cam, PRESSURE)
    rows, cols, per_cell = 3, 4, 4
    kept = synth.track_budget(dive.features, cam, rows, cols, per_cell, seed=21)
    assert synth.track_budget(dive.features, cam, rows, cols, per_cell, seed=21)[7]["ids"].tolist() \
        == kept[7]["ids"].tolist()
    landmark_of, last_seen = {}, {}
    for k, (raw, f) in enumerate(zip(dive.features, kept)):
        u = (f["u0"] + 1.0) * 0.5 * cam.resolution_x
        v = (f["v0"] + 1.0) * 0.5 * cam.resolution_y
        cell = (v * rows // cam.resolution_y).astype(int) * cols \
            + (u * cols // cam.resolution_x).astype(int)
        assert np.bincount(cell, minlength=rows * cols).max() <= per_cell
        # Every kept observation is a generated one, unchanged.
        pos = {float(x): j for j, x in enumerate(raw["u0"])}
        src = np.array([pos[float(x)] for x in f["u0"]])
        for key in ("v0", "u1", "v1"):
            assert np.array_equal(f[key], raw[key][src])
        for tid, lm in zip(f["ids"].tolist(), raw["ids"][src].tolist()):
            # A track follows one landmark over consecutive keyframes only.
            assert landmark_of.setdefault(tid, lm) == lm
            assert last_seen.get(tid, k - 1) == k - 1
            last_seen[tid] = k
        # A cell drops a continuing track only when it is full.
        if k:
            prev = {landmark_of[t] for t in kept[k - 1]["ids"].tolist()}
            kept_lms = set(raw["ids"][src].tolist())
            raw_u = (raw["u0"] + 1.0) * 0.5 * cam.resolution_x
            raw_v = (raw["v0"] + 1.0) * 0.5 * cam.resolution_y
            raw_cell = (raw_v * rows // cam.resolution_y).astype(int) * cols \
                + (raw_u * cols // cam.resolution_x).astype(int)
            counts = np.bincount(cell, minlength=rows * cols)
            for lm, c in zip(raw["ids"].tolist(), raw_cell.tolist()):
                if lm in prev and lm not in kept_lms:
                    assert counts[c] == per_cell
    per = np.array([len(f["ids"]) for f in kept])
    assert per.max() <= rows * cols * per_cell and per[10:].mean() > 30
    lengths = np.bincount(np.concatenate([f["ids"] for f in kept]))
    assert (lengths == 1).any() and lengths.max() > 5
