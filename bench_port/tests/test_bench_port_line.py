"""The result line's shape and the import guard."""

import json

import harness


def test_result_line_keys_and_order():
    line = harness.result_line(
        True, 12, 0, {"setup_s": {"value": 9.5, "unit": "s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 123}, {"graph_gap": {"value": 0.0, "limit": 1e-5}},
        breakdown={"device_ops": [["k", 0.1]], "idle_gaps": [["host", 0.2]]})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert d["metrics"]["setup_s"] == {"value": 9.5, "unit": "s"}
    assert "\n" not in line


def test_import_guard_compares_whole_top_level_names():
    mods = ["uslam_tpu_torch", "uslam_tpu_torch.pipeline", "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_loaded(mods) == []
    bad = ["uslam_tpu", "uslam_tpu.x", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]
    assert harness.forbidden_loaded(mods + bad) == sorted(bad)
