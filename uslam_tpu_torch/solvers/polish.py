"""Float64 LM polish from a float32 solution (port of
:mod:`uslam_tpu.solvers.polish`).

A float32 solve reaches its error floor while weakly observable modes
(long-wavelength bends, global yaw; curvature ~1e-8 of the strong modes)
are still off: float32 normal equations cannot represent them. Continuing
the same optimization in float64 from the float32 solution closes that gap
in a few iterations. The JAX package ran this tail on the host CPU because
its TPU has no float64; the H100 has, so the port runs it on ``device``
(the card by default, where the float32 solve ran), with the same policy:
lambda 1e-7, nu, at most 12 iterations, the Schur solve with 2 refinement
passes and a 1e-12 jitter, or with ``reduced_solver="banded"`` and a band
width set, the banded solve (O(N P^2) where the Schur solve factors the
dense reduced system).
"""

from __future__ import annotations

import numpy as np
import torch

from uslam_tpu_torch.config import SolverConfig
from uslam_tpu_torch.device import cast_tree, resolve_device
from uslam_tpu_torch.graph.values import Values, values_retract
from uslam_tpu_torch.solvers.banded import solve_schur_banded
from uslam_tpu_torch.solvers.linearize import graph_error, linearize_graph
from uslam_tpu_torch.solvers.schur import solve_schur


def polish_f64(
    graph,
    values: Values,
    cam,
    dvl_sigma: float,
    stereo_sigma: float,
    gravity: float,
    cfg: SolverConfig = SolverConfig(),
    max_iters: int = 12,
    huber_delta: float | None = None,
    *,
    device="cuda",
) -> tuple[Values, dict]:
    """Continue LM in float64 on ``device`` from a (float32) solution.
    Returns (float64 Values, info dict with ``polish_iterations``,
    ``polish_initial_error``, ``polish_final_error``)."""
    dev = resolve_device(device)
    graph64 = cast_tree(graph, torch.float64, dev)
    cam64 = cast_tree(cam, torch.float64, dev)
    vals = cast_tree(values, torch.float64, dev)
    n, m = vals.num_poses, vals.num_landmarks
    kw = dict(
        cam=cam64, dvl_sigma=dvl_sigma, stereo_sigma=stereo_sigma,
        gravity=gravity, huber_delta=huber_delta,
    )

    def err_fn(v):
        return float(graph_error(graph64, v, **kw))

    banded = cfg.reduced_solver == "banded" and cfg.band_width > 0

    def solve_fn(lin, lam):
        if banded:
            return solve_schur_banded(
                lin, graph64.stereo, n, m, lam,
                band_w=cfg.band_width, panel=cfg.banded_panel or None,
                refine_iters=2, jitter=1e-12,
                diag_damping=cfg.damping_mode == "diag",
                corr_window=cfg.banded_corr_window,
            )
        return solve_schur(
            lin, graph64.stereo, n, m, lam,
            refine_iters=2, jitter=1e-12,
            diag_damping=cfg.damping_mode == "diag",
            eliminate_velocities=cfg.eliminate_velocities,
        )

    error0 = error = err_fn(vals)
    lam, nu = 1e-7, 10.0
    iters = 0
    lin = linearize_graph(graph64, vals, **kw)
    for _ in range(max_iters):
        candidate = values_retract(vals, solve_fn(lin, lam))
        new_error = err_fn(candidate)
        iters += 1
        if np.isfinite(new_error) and new_error < error:
            decrease = error - new_error
            vals, error = candidate, new_error
            lin = linearize_graph(graph64, vals, **kw)
            lam, nu = max(lam / 10.0, 1e-12), 10.0
            if decrease <= 1e-9 or decrease <= 1e-7 * error:
                break
        else:
            lam, nu = max(lam, 1e-10) * nu, nu * 10.0
            if lam > 1e6:
                break
    info = {
        "polish_iterations": iters,
        "polish_initial_error": error0,
        "polish_final_error": error,
    }
    return vals, info
