"""Levenberg-Marquardt outer loop (port of :mod:`uslam_tpu.solvers.lm`).

GTSAM's LevenbergMarquardtOptimizer policy as the JAX package runs it:
lambda starts at ``lambda_initial`` and is divided/multiplied by
``lambda_factor`` on accept/reject (Marquardt diagonal damping with a
floor by default), GTSAM's ``checkConvergence`` on accepted steps, and the
plateau stop. A rejected step re-solves with the SAME linearization; only
an accepted step changes it.

The JAX package's ``lax.while_loop`` state lives on the device here too:
:class:`LMState` holds 0-d tensors, and a step is the JAX step written in
``torch.where``: the accept test with the NaN -> inf guard, lambda
divided with its floor or multiplied, the convergence tests, the lambda
blow-up and the plateau band. Every comparison runs in the solve's float
type, as the JAX loop's device-side ones do. An ``active`` flag
(``iterations < max_iterations`` and not converged) gates every update,
so a step after the stop leaves the state exactly as it was, and eager
blocks of any size give the same bits.

The loop and the branch are the JAX package's own, through
:func:`uslam_tpu_torch.solvers.compiled.while_loop` and
:func:`uslam_tpu_torch.solvers.compiled.cond`: :func:`lm_step`
re-linearizes under ``cond`` when the step was taken, so a solve
linearizes 1 + (accepted steps) times. On the card (no ``debug_nans``, no
``group``) the whole solve is one CUDA graph (``"lm_solve"``), keyed by the
graph's shapes and the solver settings the step reads: the first
linearization and error, then a WHILE node whose body is one step (its
re-linearization an IF node, its CG another WHILE node) and whose test,
:func:`_active` as a :class:`~uslam_tpu_torch.solvers.compiled.Test`, the
condition kernel computes. A solve launches one graph and runs no step
after the stop; :func:`optimize_lm` reads the host once, for the
statistics. On the CPU and with ``debug_nans`` the same steps run eagerly
in blocks of ``block`` (default 1): one host read of "active" per block
and one of the accept flag per step.

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

``group`` runs the same policy landmark-sharded over a ``torch.distributed``
process group (:func:`uslam_tpu_torch.parallel.mesh.sharded_optimize_lm`):
every rank runs the loop, the solves carry the collectives, and the errors
the step decides on are the first rank's, so every rank takes the same
branch. On the card each rank replays its own graphs of the solve, the
collectives captured inside them (the JAX package compiles ``shard_map``
around ``optimize_lm`` into one program): NCCL's kernels for two or more
ranks do not instantiate in a conditional node's body, so the loop is the
host's, over plain graphs of ``SHARDED_BLOCK`` gated steps (one read of
"active" per block, after a wait bounded by the group's timeout, which
raises when a peer never comes). ``debug_nans`` stays eager there, since
its check of every rank reads the host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from uslam_tpu_torch.collectives import any_rank, from_first_rank, wait
from uslam_tpu_torch.config import SolverConfig
from uslam_tpu_torch.geometry.camera import StereoCamera
from uslam_tpu_torch.graph.builder import GraphArrays
from uslam_tpu_torch.graph.values import Values, values_retract
from uslam_tpu_torch.solvers import compiled
from uslam_tpu_torch.solvers.banded import solve_schur_banded
from uslam_tpu_torch.solvers.dense import assemble_dense_with_landmarks, solve_dense_gn
from uslam_tpu_torch.solvers.linearize import graph_error, linearize_graph
from uslam_tpu_torch.solvers.schur import solve_schur


def check_finite(stage: str, *tensors: torch.Tensor, group=None) -> None:
    """``debug_nans``: raise FloatingPointError naming ``stage`` when one of
    ``tensors`` holds a NaN or an Inf (one host read). With ``group``, when
    one does on any rank: the tensors may be shard-local, and every rank
    raises together."""
    bad = torch.stack([~torch.isfinite(t).all() for t in tensors]).any()
    if any_rank(bad, group):
        raise FloatingPointError(f"debug_nans: non-finite value after the {stage} stage")


class LMState(NamedTuple):
    """The loop's state between iterations (the JAX package's fields), on
    the solve's device: ``error`` and ``lam`` are 0-d tensors of the solve's
    float type, ``iterations`` and ``stall`` 0-d int64, ``converged`` 0-d
    bool."""

    values: Values
    lin: object                 # Linearization at `values` (kept on reject)
    error: torch.Tensor
    lam: torch.Tensor
    iterations: torch.Tensor
    stall: torch.Tensor         # consecutive iterations without meaningful decrease
    converged: torch.Tensor


class LMStats(NamedTuple):
    """Python numbers from :func:`optimize_lm`; 0-d tensors on the solve's
    device from :func:`solve_lm`."""

    initial_error: float
    final_error: float
    iterations: int
    final_lambda: float
    converged: bool


def graph_config(cfg: SolverConfig) -> SolverConfig:
    """``cfg`` with the fields the LM step does not read set to their
    defaults: the part of a graph's cache key that is the solver's."""
    d = SolverConfig()
    return dataclasses.replace(cfg, max_obs_per_landmark=d.max_obs_per_landmark,
                               banded_unroll=d.banded_unroll, debug_nans=d.debug_nans,
                               f64_polish=d.f64_polish)


class _Problem(NamedTuple):
    error: object       # values -> 0-d error (the first rank's with a group)
    linearize: object   # values -> Linearization
    solve: object       # (lin, lam) -> step


def _problem(graph, cam, dvl_sigma, stereo_sigma, gravity, cfg, huber_delta, group,
             n: int, m: int, check) -> _Problem:
    diag_damping = cfg.damping_mode == "diag"
    # Marquardt damping with the lambda floor keeps the scaled diagonal at
    # >= 1 + lambda, itself the PD margin; otherwise restore the 1e-7 jitter
    # (same rule as the JAX package).
    floored_diag = diag_damping and min(cfg.lambda_initial, cfg.lambda_lower_bound) >= 1e-7
    jitter = cfg.cholesky_jitter if floored_diag else max(cfg.cholesky_jitter, 1e-7)

    # With a group, every decision of the step reads values that are the
    # same bits on every rank: this error (the first rank's), and lambda,
    # the counts and flags derived from it. So every rank's loop takes the
    # same number of turns and makes the same collectives. In graphs this
    # is what keeps the ranks together: a rank that replayed one block more
    # would wait inside the replay for peers that never come, where the
    # group's watchdog and timeout do not reach (the host's wait after each
    # block, collectives.wait, raises at the group's timeout then).
    def error(values: Values) -> torch.Tensor:
        err = graph_error(graph, values, cam, dvl_sigma, stereo_sigma, gravity, huber_delta)
        return from_first_rank(err, group)

    def linearize(values: Values):
        lin = linearize_graph(graph, values, cam, dvl_sigma, stereo_sigma, gravity, huber_delta)
        if check:
            check("linearize", *lin)
        return lin

    def solve(lin, lam):
        if cfg.reduced_solver == "banded":
            return solve_schur_banded(
                lin, graph.stereo, n, m, lam,
                band_w=cfg.band_width,
                panel=cfg.banded_panel or None,
                refine_iters=(
                    cfg.banded_refine_iters if cfg.banded_refine_iters >= 0 else cfg.refine_iters
                ),
                jitter=jitter,
                diag_damping=diag_damping,
                corr_window=cfg.banded_corr_window,
                check=check,
                group=group,
            )
        if cfg.linear_solver == "schur":
            return solve_schur(
                lin, graph.stereo, n, m, lam,
                cg=cfg.reduced_solver == "cg",
                cg_iters=cfg.cg_max_iterations,
                cg_tol=cfg.cg_tol,
                refine_iters=cfg.refine_iters,
                jitter=jitter,
                diag_damping=diag_damping,
                eliminate_velocities=cfg.eliminate_velocities,
                check=check,
                group=group,
            )
        H, g = assemble_dense_with_landmarks(
            lin, graph.stereo.cam_idx, graph.stereo.lm_idx, n, m
        )
        if check:
            check("dense assembly", H, g)
        delta = solve_dense_gn(
            H, g, lam, refine_iters=cfg.refine_iters, jitter=jitter,
            diag_damping=diag_damping,
        )
        if check:
            check("reduced solve", delta)
        return delta

    return _Problem(error, linearize, solve)


def _select(take: torch.Tensor, new, old):
    """Leafwise ``torch.where(take, new, old)`` over a NamedTuple."""
    return type(old)(*(torch.where(take, a, b) for a, b in zip(new, old)))


def _decide(state: LMState, p: _Problem, cfg: SolverConfig, check=None):
    """One iteration of the JAX package's ``step`` on tensors, gated by
    ``active``, but for its linearization: (the next state, still holding
    the old linearization; ``take``, whether the step was taken)."""
    active = (state.iterations < cfg.max_iterations) & ~state.converged
    error = state.error
    candidate = values_retract(state.values, p.solve(state.lin, state.lam))
    if check:
        check("step", *candidate)
    new_error = p.error(candidate)
    if check:
        check("new error", new_error)
    # Guard NaN/Inf (divergence detection): a non-finite candidate is rejected.
    new_error = torch.where(torch.isfinite(new_error), new_error, float("inf"))
    accept = new_error < error
    take = active & accept

    # GTSAM checkConvergence on accepted steps; lambda blow-up => stuck.
    decrease = torch.abs(error - new_error)
    converged = accept & (
        (new_error <= cfg.error_tol)
        | (decrease <= cfg.absolute_error_tol)
        | (decrease <= cfg.relative_error_tol * error)
    )
    lam = torch.where(
        accept,
        torch.clamp(state.lam / cfg.lambda_factor, min=cfg.lambda_lower_bound),
        state.lam * cfg.lambda_factor,
    )
    converged = converged | (lam > cfg.lambda_upper_bound)
    # Plateau stop: consecutive iterations whose error change stays in the
    # progress band; a reject that degraded the error a lot neither counts
    # nor resets.
    band = torch.clamp(cfg.plateau_rtol * error, min=10.0 * cfg.absolute_error_tol)
    fast = accept & ((error - new_error) > band)
    slow = decrease <= band
    stall = torch.where(fast, 0, torch.where(slow, state.stall + 1, state.stall))
    if cfg.plateau_patience > 0:
        converged = converged | (stall >= cfg.plateau_patience)
    return LMState(
        _select(take, candidate, state.values), state.lin,
        torch.where(take, new_error, error),
        torch.where(active, lam, state.lam),
        state.iterations + active.long(),
        torch.where(active, stall, state.stall),
        state.converged | (active & converged),
    ), take


def lm_step(state: LMState, p: _Problem, cfg: SolverConfig, check=None) -> LMState:
    """One iteration of the JAX package's ``step``, gated by ``active``:
    the step, its accept test and, under ``lax.cond``
    (:func:`uslam_tpu_torch.solvers.compiled.cond`), the re-linearization
    of a taken step alone. Eagerly the branch is taken on the host (one
    read); in a CUDA graph it is an IF node, which holds no collective (the
    linearization is each rank's own, of the whole graph). After the stop
    it returns the state unchanged."""
    new, take = _decide(state, p, cfg, check)
    lin = compiled.cond(take, p.linearize, lambda values: state.lin, new.values,
                        name="lm_linearize")
    return new._replace(lin=lin)


def _active(state: LMState, cfg: SolverConfig) -> compiled.Test:
    """The loop's test, ``iterations < max_iterations`` and not converged:
    one condition kernel in a graph, ``.flag()`` eagerly."""
    return compiled.Test(state.iterations, cfg.max_iterations, stop=state.converged)


def _start(p: _Problem, initial: Values, cfg: SolverConfig) -> LMState:
    """The loop's first state: the first linearization and error."""
    # On the card lin holds clones of a replayed graph's outputs, so it
    # outlives the error's replays (another graph) and later linearizations.
    lin = p.linearize(initial)
    init_error = p.error(initial)
    dev = init_error.device
    count = torch.zeros((), dtype=torch.int64, device=dev)
    return LMState(
        initial, lin, init_error,
        torch.full((), cfg.lambda_initial, dtype=init_error.dtype, device=dev),
        count, count, torch.zeros((), dtype=torch.bool, device=dev),
    )


def _steps(s: LMState, p: _Problem, cfg: SolverConfig, block: int, check=None) -> LMState:
    for _ in range(block):
        s = lm_step(s, p, cfg, check)
    return s


def _stats(init_error: torch.Tensor, state: LMState) -> LMStats:
    return LMStats(init_error, state.error, state.iterations, state.lam, state.converged)


def _run(p: _Problem, initial: Values, cfg: SolverConfig, block: int, check) -> tuple:
    """The JAX package's ``optimize_lm`` body: the first linearization and
    error, then ``lax.while_loop`` over blocks of ``block`` steps
    (:func:`uslam_tpu_torch.solvers.compiled.while_loop`); (values, the
    statistics as 0-d tensors)."""
    state = _start(p, initial, cfg)
    init_error = state.error
    state = compiled.while_loop(functools.partial(_active, cfg=cfg),
                                functools.partial(_steps, p=p, cfg=cfg, block=block,
                                                  check=check),
                                state, name="lm_step")
    return state.values, _stats(init_error, state)


def _graph_solve(graph, cam, initial, dvl_sigma, stereo_sigma, gravity, huber_delta, cfg):
    """The whole solve, the body of its CUDA graph: a WHILE node over
    :func:`lm_step`."""
    p = _problem(graph, cam, dvl_sigma, stereo_sigma, gravity, cfg, huber_delta, None,
                 initial.num_poses, initial.num_landmarks, None)
    return _run(p, initial, cfg, 1, None)


# A collective of two or more NCCL ranks cannot sit in a conditional node's
# body: NCCL leaves event record and event wait nodes in the graph it is
# captured into, and a body holding them fails to instantiate ("invalid
# argument"), while a plain graph holding them replays (chip_smoke.py's
# collective probe, phase 12 (b); four H100s, torch 2.11 with CUDA 12.8). So a
# graphed solve with a group, of any size, replays plain graphs: the first
# linearization and error, then blocks of SHARDED_BLOCK steps gated by
# ``active`` (a step after the stop changes no bit), with one host read of
# ``active`` after each block. The step's re-linearization stays an IF node
# and the CG a WHILE node: neither holds a collective.
SHARDED_BLOCK = 4


def _graph_start(graph, cam, initial, dvl_sigma, stereo_sigma, gravity, huber_delta, cfg,
                 group) -> LMState:
    p = _problem(graph, cam, dvl_sigma, stereo_sigma, gravity, cfg, huber_delta, group,
                 initial.num_poses, initial.num_landmarks, None)
    return _start(p, initial, cfg)


def _graph_block(graph, cam, state, dvl_sigma, stereo_sigma, gravity, huber_delta, cfg,
                 group) -> LMState:
    p = _problem(graph, cam, dvl_sigma, stereo_sigma, gravity, cfg, huber_delta, group,
                 state.values.num_poses, state.values.num_landmarks, None)
    return _steps(state, p, cfg, SHARDED_BLOCK)


def _sharded_graph_solve(graph, cam, initial, statics: tuple, cfg: SolverConfig, group):
    """The sharded solve as replays of two plain graphs (``"lm_start"``,
    ``"lm_block"``): ceil(iterations / SHARDED_BLOCK) host reads, each
    after a wait bounded by the group's timeout (``collectives.wait``)."""
    state = compiled.call("lm_start", _graph_start, (graph, cam, initial), statics,
                          group=group)
    init_error = state.error
    while True:
        state = compiled.call("lm_block", _graph_block, (graph, cam, state), statics,
                              group=group)
        wait(group, init_error.device, "sharded LM block")
        if not compiled.read([_active(state, cfg).flag()], name="lm_block")[0]:
            return state.values, _stats(init_error, state)


def solve_lm(
    graph: GraphArrays,
    initial: Values,
    cam: StereoCamera,
    dvl_sigma: float,
    stereo_sigma: float,
    gravity: float,
    cfg: SolverConfig = SolverConfig(),
    huber_delta: float | None = None,
    group=None,
    *,
    block: int | None = None,
    graphed: bool | None = None,
) -> tuple[Values, LMStats]:
    """Run LM to convergence; the statistics stay 0-d tensors on the
    solve's device (nothing is read for them). ``group``: landmark-sharded
    (module docstring); ``graph.stereo.lm_obs_idx``/``lm_obs_mask`` hold
    this rank's slice, everything else is the same on every rank.

    ``graphed`` (default: on CUDA without ``debug_nans``) replays the
    solve's CUDA graph (the loop a WHILE node: no host read; with
    ``group``, this rank's graphs of the first linearization and of blocks
    of ``SHARDED_BLOCK`` steps, the collectives inside, one host read per
    block); ``graphed=False`` runs the same steps eagerly in blocks of
    ``block`` (default 1). A capture that fails raises."""
    if group is not None and cfg.linear_solver != "schur":
        raise ValueError("sharded LM requires the schur linear solver")
    if cfg.reduced_solver == "banded" and cfg.band_width <= 0:
        raise ValueError(
            "reduced_solver='banded' needs band_width >= the max track "
            "span (solvers.banded.measure_band_width)"
        )
    eligible = initial.pose_trans.device.type == "cuda" and not cfg.debug_nans
    if graphed is None:
        graphed = eligible
    if graphed and not eligible:
        raise ValueError("graphed LM needs CUDA tensors and debug_nans off")
    if graphed and block is not None:
        raise ValueError("block applies to the eager LM (graphed=False) alone")
    k = block or 1
    if k < 1:
        raise ValueError(f"block {k} < 1")
    sig = (dvl_sigma, stereo_sigma, gravity)
    if graphed and group is not None:
        return _sharded_graph_solve(graph, cam, initial,
                                    (*sig, huber_delta, graph_config(cfg), group), cfg, group)
    if graphed:
        return compiled.call("lm_solve", _graph_solve, (graph, cam, initial),
                             (*sig, huber_delta, graph_config(cfg)))
    check = None
    if cfg.debug_nans:
        check = check_finite if group is None else functools.partial(check_finite, group=group)
    p = _problem(graph, cam, *sig, cfg, huber_delta, group, initial.num_poses,
                 initial.num_landmarks, check)
    return _run(p, initial, cfg, k, check)


def optimize_lm(
    graph: GraphArrays,
    initial: Values,
    cam: StereoCamera,
    dvl_sigma: float,
    stereo_sigma: float,
    gravity: float,
    cfg: SolverConfig = SolverConfig(),
    huber_delta: float | None = None,
    group=None,
    *,
    block: int | None = None,
    graphed: bool | None = None,
) -> tuple[Values, LMStats]:
    """Run LM to convergence (:func:`solve_lm`); the statistics come back
    as Python numbers, in one host read."""
    values, stats = solve_lm(
        graph, initial, cam, dvl_sigma, stereo_sigma, gravity, cfg, huber_delta, group,
        block=block, graphed=graphed,
    )
    e0, e, it, lam, conv = compiled.read(stats)
    return values, LMStats(
        initial_error=e0, final_error=e, iterations=int(it), final_lambda=lam,
        converged=bool(conv),
    )
