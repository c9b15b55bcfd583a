"""Sensor streams and their ingest, host numpy: the containers and their
npz files (:mod:`.sequence`), ROS bags (:mod:`.rosbag`), image folders
(:mod:`.images`), the time join (:mod:`.timesync`) and synthetic sequences
(:mod:`.synthetic`); the IMU prefilters (:mod:`.filters`) run on a device.

The public names are the JAX package's ``uslam_tpu.io``. They load on
first use, so ``import uslam_tpu_torch.io`` imports no torch module.
"""

import importlib

_EXPORTS = {
    "FeatureFrame": "sequence",
    "SensorSequence": "sequence",
    "load_sequence": "sequence",
    "save_sequence": "sequence",
    "BagTopics": "rosbag",
    "bag_to_sequence": "rosbag",
    "read_bag": "rosbag",
    "approximate_time_join": "timesync",
    "SyntheticSpec": "synthetic",
    "generate_synthetic_sequence": "synthetic",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
