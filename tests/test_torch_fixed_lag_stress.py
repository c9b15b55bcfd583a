"""Fixed-lag marginalization stress test on the port
(tests/test_fixed_lag_stress.py on ``uslam_tpu_torch``): a long survey
stream with continuous landmark churn, every landmark entering and leaving
the window, and the window-vs-batch divergence bounded per time segment
and in its trend.

The body, ``chip_smoke.run_stress``, lives in chip_smoke.py, whose phase
15 (c) runs the 30 s stream on the card on every chip run (host path and
device-resident); it raises on the JAX test's four bounds, unchanged:
enough keyframes, more unique landmark ids than 2.5 per second, each of 6
segments within 0.30 m of the batch optimum with the last two segments'
mean within 4x the first two's, and the window's ATE below the DVL
odometry's. The windowed trajectory is not compared with the JAX
package's point by point: stream divergence between float32 runs is
chaotic (ROADMAP §C, "Known reference behaviours").

Both streams are slow-marked on the CPU. The 30 s one takes ~300 s here
(measured 297 s: 2 s per steady keyframe, eager, each LM iteration
relinearizing the window; the batch solve 9.1 s of it), against the JAX
test's 39.7 s; the 60 s one is slow in the JAX package too. The feed,
``chip_smoke.stress_keyframes``, is held to the JAX test's ``feed``
(tests/test_fixed_lag.py:13-35) exactly, on the stream's first seconds.
"""

import numpy as np
import pytest

from chip_smoke import run_stress, stress_keyframes, stress_spec
from tests.test_fixed_lag import feed
from uslam_tpu.config import UslamConfig as JaxUslamConfig
from uslam_tpu.io.synthetic import SyntheticSpec as JaxSpec
from uslam_tpu.io.synthetic import generate_synthetic_sequence as jax_generate
from uslam_tpu_torch.config import UslamConfig
from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence

FEED_SECONDS = 3.0


def test_stress_feed_equals_jax_feed():
    """The port's feed gives the JAX test's keyframes: poses, IMU rows,
    DVL velocities, and the same features triangulated to the same
    float32 points."""
    ref = []
    feed(jax_generate(JaxSpec(**stress_spec(FEED_SECONDS))), JaxUslamConfig(),
         lambda *kf: ref.append(kf))
    got = list(stress_keyframes(
        generate_synthetic_sequence(SyntheticSpec(**stress_spec(FEED_SECONDS))), UslamConfig()))
    assert len(got) == len(ref) == int(FEED_SECONDS * 5)
    assert sum(1 for kf in got if kf[4]) >= len(got) - 1
    for (q, p, imu, dvl, feats), (rq, rp, rimu, rdvl, rfeats) in zip(got, ref):
        np.testing.assert_array_equal(q, rq)
        np.testing.assert_array_equal(p, rp)
        np.testing.assert_array_equal(dvl, rdvl)
        assert (imu is None) == (rimu is None)
        if imu is not None:
            np.testing.assert_array_equal(imu, rimu)
        assert len(feats or []) == len(rfeats or [])
        for f, rf in zip(feats or [], rfeats or []):
            assert f[:4] == rf[:4]
            np.testing.assert_array_equal(f[4], rf[4])


@pytest.mark.slow
def test_fixed_lag_long_stream_drift_bounded():
    """30 s, ~150 marginalizations (the JAX test's always-on stream; slow on
    the port's CPU path, ~300 s, and held on the card by chip_smoke.py)."""
    run_stress(30.0, "cpu")


@pytest.mark.slow
def test_fixed_lag_60s_stream_drift_bounded():
    run_stress(60.0, "cpu")
