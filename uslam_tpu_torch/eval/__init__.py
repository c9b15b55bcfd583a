"""Evaluation, plotting and graph export (port of ``uslam_tpu.eval``):
trajectory metrics, the 3-D plot and the Graphviz export.

The public names are the JAX package's ``uslam_tpu.eval``. They load on
first use, so importing the subpackage imports no torch module.
"""

import importlib

_EXPORTS = {
    "ate_rmse": "metrics",
    "mse_reference_compat": "metrics",
    "rpe_rmse": "metrics",
    "trajectory_from_values": "metrics",
    "plot_trajectory_3d": "plot",
    "graph_to_dot": "graphviz",
    "save_graph_dot": "graphviz",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
