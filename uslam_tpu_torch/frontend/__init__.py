"""The ORB visual front end (port of ``uslam_tpu.frontend``): FAST-9 +
Harris detection on the hand-written ``fast_harris`` CUDA kernel, grid
top-K, rBRIEF, Hamming matching on the ``hamming`` kernel (wrappers and
plain versions in :mod:`.kernels`), and the per-frame and chunked tracker.

The public names are the JAX package's ``uslam_tpu.frontend``. They load on
first use, so importing the subpackage imports no torch module.
"""

import importlib

_EXPORTS = {
    "build_pyramid": "pyramid",
    "box_blur": "pyramid",
    "fast_corners": "fast",
    "harris_response": "fast",
    "Keypoints": "orb",
    "extract_orb": "orb",
    "hamming_distance_matrix": "match",
    "match_descriptors": "match",
    "stereo_match": "match",
    "StereoFrontend": "tracker",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
