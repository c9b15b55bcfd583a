"""Nonlinear least-squares solvers (port of ``uslam_tpu.solvers``): the
linearization, the dense and Schur reduced solves, the Levenberg-Marquardt
host loop, marginal covariances; the banded, fixed-lag and polish solvers
in their modules.

The public names are the JAX package's ``uslam_tpu.solvers``. They load on
first use, so importing the subpackage imports no torch module.
"""

import importlib

_EXPORTS = {
    "Linearization": "linearize",
    "linearize_graph": "linearize",
    "graph_error": "linearize",
    "assemble_dense": "dense",
    "solve_dense_gn": "dense",
    "solve_schur": "schur",
    "LMState": "lm",
    "optimize_lm": "lm",
    "MarginalCovariances": "marginals",
    "marginal_covariances": "marginals",
    "marginal_sigmas": "marginals",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
