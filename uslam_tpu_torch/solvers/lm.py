"""Levenberg-Marquardt outer loop (port of :mod:`uslam_tpu.solvers.lm`).

GTSAM's LevenbergMarquardtOptimizer policy as the JAX package runs it:
lambda starts at ``lambda_initial`` and is divided/multiplied by
``lambda_factor`` on accept/reject (Marquardt diagonal damping with a
floor by default), GTSAM's ``checkConvergence`` on accepted steps, and the
plateau stop. A rejected step re-solves with the SAME linearization; only
an accepted step re-linearizes.

The JAX package's ``lax.while_loop`` becomes a host loop. Each iteration
reads back one number, the candidate's error; the accept/reject decision
and the lambda, stall and convergence bookkeeping then run on the host in
the solve's floating type, so every comparison rounds as the JAX loop's did.

The default linear solver is the landmark Schur complement with velocity
elimination (:mod:`uslam_tpu_torch.solvers.schur`), with the Cholesky or CG
reduced solve; ``reduced_solver="banded"`` runs the banded large-N solve
(:mod:`uslam_tpu_torch.solvers.banded`) whatever ``linear_solver`` says, as
the JAX package does; ``linear_solver="dense"`` factors the whole tangent
space.

``SolverConfig.debug_nans`` (the JAX package turns on ``jax.debug_nans``
around the solve) checks the results of every stage of every iteration for
NaN and Inf: the linearization, the landmark Schur or banded reduction (or
the dense assembly), the reduced solve, the step and the new error. The
first non-finite value raises ``FloatingPointError`` naming its stage.
With the flag off no check runs and no host read is added.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from uslam_tpu_torch.config import SolverConfig
from uslam_tpu_torch.geometry.camera import StereoCamera
from uslam_tpu_torch.graph.builder import GraphArrays
from uslam_tpu_torch.graph.values import Values, values_retract
from uslam_tpu_torch.solvers.banded import solve_schur_banded
from uslam_tpu_torch.solvers.dense import assemble_dense_with_landmarks, solve_dense_gn
from uslam_tpu_torch.solvers.linearize import graph_error, linearize_graph
from uslam_tpu_torch.solvers.schur import solve_schur


def check_finite(stage: str, *tensors: torch.Tensor) -> None:
    """``debug_nans``: raise FloatingPointError naming ``stage`` when one of
    ``tensors`` holds a NaN or an Inf (one host read per tensor)."""
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"debug_nans: non-finite value after the {stage} stage")


class LMStats(NamedTuple):
    initial_error: float
    final_error: float
    iterations: int
    final_lambda: float
    converged: bool


def optimize_lm(
    graph: GraphArrays,
    initial: Values,
    cam: StereoCamera,
    dvl_sigma: float,
    stereo_sigma: float,
    gravity: float,
    cfg: SolverConfig = SolverConfig(),
    huber_delta: float | None = None,
) -> tuple[Values, LMStats]:
    """Run LM to convergence."""
    if cfg.reduced_solver == "banded" and cfg.band_width <= 0:
        raise ValueError(
            "reduced_solver='banded' needs band_width >= the max track "
            "span (solvers.banded.measure_band_width)"
        )
    n, m = initial.num_poses, initial.num_landmarks
    # Host-side scalars in the solve's float type, so comparisons round as
    # the JAX loop's device-side ones did.
    f = {torch.float32: np.float32, torch.float64: np.float64}[initial.pose_trans.dtype]

    def err_fn(values: Values):
        return graph_error(
            graph, values, cam, dvl_sigma, stereo_sigma, gravity, huber_delta
        )

    def lin_fn(values: Values):
        return linearize_graph(
            graph, values, cam, dvl_sigma, stereo_sigma, gravity, huber_delta
        )

    diag_damping = cfg.damping_mode == "diag"
    # Marquardt damping with the lambda floor keeps the scaled diagonal at
    # >= 1 + lambda, itself the PD margin; otherwise restore the 1e-7 jitter
    # (same rule as the JAX package).
    floored_diag = diag_damping and min(cfg.lambda_initial, cfg.lambda_lower_bound) >= 1e-7
    jitter = cfg.cholesky_jitter if floored_diag else max(cfg.cholesky_jitter, 1e-7)
    check = check_finite if cfg.debug_nans else None

    def solve(lin, lam):
        if cfg.reduced_solver == "banded":
            return solve_schur_banded(
                lin, graph.stereo, n, m, float(lam),
                band_w=cfg.band_width,
                panel=cfg.banded_panel or None,
                refine_iters=(
                    cfg.banded_refine_iters if cfg.banded_refine_iters >= 0 else cfg.refine_iters
                ),
                jitter=jitter,
                diag_damping=diag_damping,
                corr_window=cfg.banded_corr_window,
                check=check,
            )
        if cfg.linear_solver == "schur":
            return solve_schur(
                lin, graph.stereo, n, m, float(lam),
                cg=cfg.reduced_solver == "cg",
                cg_iters=cfg.cg_max_iterations,
                cg_tol=cfg.cg_tol,
                refine_iters=cfg.refine_iters,
                jitter=jitter,
                diag_damping=diag_damping,
                eliminate_velocities=cfg.eliminate_velocities,
                check=check,
            )
        H, g = assemble_dense_with_landmarks(
            lin, graph.stereo.cam_idx, graph.stereo.lm_idx, n, m
        )
        if check:
            check("dense assembly", H, g)
        delta = solve_dense_gn(
            H, g, float(lam), refine_iters=cfg.refine_iters, jitter=jitter,
            diag_damping=diag_damping,
        )
        if check:
            check("reduced solve", delta)
        return delta

    def linearize(values: Values):
        lin = lin_fn(values)
        if check:
            check("linearize", *lin)
        return lin

    values = initial
    lin = linearize(values)
    error = f(err_fn(values).item())
    init_error = error
    lam = f(cfg.lambda_initial)
    iterations, stall, converged = 0, 0, False
    while iterations < cfg.max_iterations and not converged:
        candidate = values_retract(values, solve(lin, lam))
        if check:
            check("step", *candidate)
        new_error = f(err_fn(candidate).item())
        if check and not math.isfinite(new_error):
            raise FloatingPointError("debug_nans: non-finite value after the new error stage")
        if not math.isfinite(new_error):
            new_error = f(np.inf)
        accept = bool(new_error < error)
        if accept:
            values = candidate
            lin = linearize(values)

        decrease = np.abs(error - new_error)
        converged = accept and bool(
            (new_error <= cfg.error_tol)
            | (decrease <= cfg.absolute_error_tol)
            | (decrease <= cfg.relative_error_tol * error)
        )
        new_lam = (
            np.maximum(lam / f(cfg.lambda_factor), f(cfg.lambda_lower_bound))
            if accept
            else lam * f(cfg.lambda_factor)
        )
        converged = converged or bool(new_lam > cfg.lambda_upper_bound)
        # Plateau stop: consecutive iterations whose error change stays in
        # the progress band; a reject that degraded the error a lot neither
        # counts nor resets.
        band = np.maximum(f(cfg.plateau_rtol) * error, f(10.0 * cfg.absolute_error_tol))
        if accept and (error - new_error) > band:
            stall = 0
        elif decrease <= band:
            stall += 1
        if cfg.plateau_patience > 0:
            converged = converged or stall >= cfg.plateau_patience
        if accept:
            error = new_error
        lam = f(new_lam)
        iterations += 1

    return values, LMStats(
        initial_error=float(init_error),
        final_error=float(error),
        iterations=iterations,
        final_lambda=float(lam),
        converged=converged,
    )
