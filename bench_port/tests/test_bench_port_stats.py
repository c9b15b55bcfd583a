"""The rate the end-to-end metric is made of, on synthetic timestamps,
and the comparison against the limits."""

import pytest

import harness


def test_completed_rate_is_all_work_over_all_time():
    # Dives of 200 s completed at 0.5, 1.0, 1.7 s after a window opened at
    # 10.0 s: 600 dive seconds over 1.7 s, not a median of chunks.
    units = [(10.5, 200.0), (11.0, 200.0), (11.7, 200.0)]
    assert harness.completed_rate(units, 10.0) == pytest.approx(600.0 / 1.7)
    assert harness.completed_rate([], 10.0) is None


def test_compare_against_limits():
    ok, out = harness.compare({"a": 1.0, "b": 0.5}, {"a": 1.0, "b": 0.4})
    assert not ok and out["a"] == {"value": 1.0, "limit": 1.0}
    ok, out = harness.compare({"a": float("nan"), "b": float("inf")}, {"a": 1.0, "b": 1.0})
    assert not ok and out["a"]["value"] == "nan" and out["b"]["value"] == "inf"
    ok, out = harness.compare({}, {"a": 1.0})
    assert not ok and out["a"]["value"] is None
    assert harness.compare({"a": 0.0}, {"a": 0.0})[0]
