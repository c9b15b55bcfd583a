"""The factor graph as a struct of arrays (port of ``uslam_tpu.graph``):
stacked variables and their tangent layout, the graph builder and its
containers.

The public names are the JAX package's ``uslam_tpu.graph``. They load on
first use, so importing the subpackage imports no torch module.
"""

import importlib

_EXPORTS = {
    "Values": "values",
    "values_retract": "values",
    "tangent_dim": "values",
    "GraphArrays": "builder",
    "GraphBuilder": "builder",
    "StereoObservations": "builder",
    "ImuIntervals": "builder",
    "DvlMeasurements": "builder",
    "Priors": "builder",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
