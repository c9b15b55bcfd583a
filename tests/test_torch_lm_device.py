"""The port's device-resident LM (uslam_tpu_torch/solvers/lm.py: the state
as 0-d tensors, the step in ``torch.where`` with its re-linearization under
``compiled.cond``, the loop ``compiled.while_loop`` over eager blocks of
steps) against the JAX package's ``optimize_lm`` (its ``lax.while_loop``) in
float64, on one small graph: a 2 s synthetic dive, 10 poses, packed by the
JAX package.

The JAX side is compiled once: the cases differ only in solver settings
that the JAX step reads as device values (lambda's start and bound, the
tolerances, the iteration cap), so they are passed in traced, with
identity damping (whose jitter rule reads none of them). Its per-iteration
states, ``stall`` included, come out of its ``while_loop`` through a
debug callback.

Tolerances, with their reasons:
- iterations, accept/reject, lambda, stall and the stop: exact (the same
  decisions on the same float64 errors);
- the final error: 1e-9 relative, as tests/test_torch_schur.py holds the
  default LM (the Cholesky and the sums run in another library and order);
  the errors on the way 1e-6: an early identity-damped step at a small
  lambda is ill-conditioned, and its error a small difference of large
  ones (3.3e6 -> 39.55 in one step, 1.4e-8 apart measured);
- blocks of 1 and of 8 steps: bit for bit (a step after the stop leaves
  every bit of the state as it was), on the case that stops mid-block; the
  other cases run once, in blocks of 8, and their masked steps must leave
  the state as the stop left it;
- linearizations: exactly 1 + the accepted steps, JAX's ``lax.cond`` count
  (a rejected or masked step linearizes nothing);
- the float32 decisions: exact, against numpy's float32 (NumPy 2 rounds a
  Python float to float32 before it meets a float32 scalar) and JAX's
  weakly typed float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from tests.test_torch_backend import SIGMAS, _cams, _jax64
from uslam_tpu.config import SolverConfig, UslamConfig
from uslam_tpu.graph.packing import pack_sequence as jax_pack
from uslam_tpu.io.synthetic import SyntheticSpec, generate_synthetic_sequence
from uslam_tpu.solvers import lm as jlm
from uslam_tpu_torch.graph.values import Values
from uslam_tpu_torch.interop import config_to_port, to_port
from uslam_tpu_torch.solvers import compiled, lm

torch.set_num_threads(1)

# Every case: identity damping, lambda floor 1e-12, the default patience 5.
BASE = SolverConfig(damping_mode="identity", lambda_lower_bound=1e-12)
# Traced on the JAX side. lambda_factor too: a constant divisor becomes a
# product by its reciprocal in XLA (0.1 / 10 -> 0.010000000000000002), where
# the port, like the former host loop, divides.
TRACED = ("lambda_initial", "lambda_factor", "lambda_upper_bound", "plateau_rtol",
          "absolute_error_tol", "relative_error_tol", "max_iterations")
# name: (values: "plain" or "rotated", settings). "rotated": every pose
# turned by ~0.3 rad and every velocity off by ~1 m/s, so small-lambda
# steps overshoot and are rejected.
CASES = {
    "rejects": ("rotated", dict(lambda_initial=0.1, max_iterations=12)),
    "lambda blow-up": ("rotated", dict(lambda_initial=1e-3, lambda_upper_bound=5.0,
                                       max_iterations=9)),
    "plateau": ("plain", dict(plateau_rtol=0.5, absolute_error_tol=1e-12,
                              relative_error_tol=1e-12, max_iterations=12)),
    "NaN candidate": ("plain", dict(lambda_initial=-1e6, max_iterations=3)),
    "max_iterations mid-block": ("plain", dict(max_iterations=5)),
}
# The stop each case must reach, and its iterations.
EXPECTED = {
    "rejects": ("max_iterations", 12),
    "lambda blow-up": ("lambda blow-up", 4),
    "plateau": ("plateau", 7),
    "NaN candidate": ("max_iterations", 3),
    "max_iterations mid-block": ("max_iterations", 5),
}


@pytest.fixture(scope="module")
def small():
    """The graph and both starts, float64 numpy."""
    cfg = UslamConfig()
    spec = SyntheticSpec(duration=2.0, odom_drift_rate=0.05, feature_noise_px=0.3, seed=1)
    graph, values = jax.device_get(jax_pack(generate_synthetic_sequence(spec), cfg)[:2])
    g64 = jax.tree.map(
        lambda a: np.asarray(a, np.float64) if np.issubdtype(a.dtype, np.floating) else a, graph)
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), values)
    rng = np.random.default_rng(0)
    q = v64.pose_quat                                          # wxyz
    turned = (Rotation.from_quat(np.roll(q, -1, axis=1))
              * Rotation.from_rotvec(rng.normal(0, 0.3, (q.shape[0], 3))))
    qn = np.roll(turned.as_quat(), 1, axis=1)
    rotated = v64._replace(pose_quat=np.where(qn[:, :1] < 0, -qn, qn),
                           vel=v64.vel + rng.normal(0, 1.0, v64.vel.shape))
    return cfg, g64, {"plain": v64, "rotated": rotated}


def _states(x) -> list:
    """(error, lam, iterations, stall, converged) per state."""
    return [(float(s.error), float(s.lam), int(s.iterations), int(s.stall), bool(s.converged))
            for s in x]


@pytest.fixture(scope="module")
def jax_runs(small, monkeypatch_module):
    """Each case through the JAX package's optimize_lm (one compile): the
    initial state, then the state after every iteration."""
    cfg, g64, starts = small
    cj, _ = _cams(cfg)
    record: list = []
    plain_while = jax.lax.while_loop

    def recording_while(cond, body, init):
        if not isinstance(init, jlm.LMState):
            return plain_while(cond, body, init)

        def step(s):
            s = body(s)
            jax.debug.callback(lambda *a: record.append(a), s.error, s.lam, s.iterations,
                               s.stall, s.converged)
            return s

        return plain_while(cond, step, init)

    monkeypatch_module.setattr(jax.lax, "while_loop", recording_while)

    def run(graph, values, *settings):
        solver = dataclasses.replace(BASE, **dict(zip(TRACED, settings)))
        return jlm.optimize_lm(graph, values, cj, *SIGMAS, solver)

    out = {}
    # Process-wide, not the thread-local enable_x64: the callback runs on
    # another thread and would see float32 otherwise.
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jitted = jax.jit(run)
        for name, (start, settings) in CASES.items():
            record.clear()
            args = [settings.get(k, getattr(BASE, k)) for k in TRACED]
            _, stats = jax.device_get(jitted(_jax64(g64), _jax64(starts[start]), *args))
            jax.effects_barrier()
            first = (float(stats.initial_error), args[0], 0, 0, False)
            out[name] = [first] + sorted(
                ((float(e), float(lam), int(it), int(st), bool(c))
                 for e, lam, it, st, c in record), key=lambda s: s[2])
    finally:
        jax.config.update("jax_enable_x64", x64)
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _port_run(small, name, block, linearizations=None):
    """The case through the port's solve_lm on the CPU in blocks of
    ``block``; (final values, stats, every state after a step). With
    ``linearizations`` (a list), the solve's calls of linearize_graph are
    appended to it."""
    cfg, g64, starts = small
    _, ct = _cams(cfg)
    start, settings = CASES[name]
    solver = config_to_port(dataclasses.replace(BASE, **settings))
    states: list = []
    plain_step, plain_linearize = lm.lm_step, lm.linearize_graph

    def recording_step(*args, **kwargs):
        state = plain_step(*args, **kwargs)
        states.append(state)
        return state

    def counting_linearize(*args, **kwargs):
        if linearizations is not None:
            linearizations.append(1)
        return plain_linearize(*args, **kwargs)

    lm.lm_step, lm.linearize_graph = recording_step, counting_linearize
    try:
        values, stats = lm.solve_lm(to_port(g64, "cpu"), to_port(starts[start], "cpu"), ct,
                                    *SIGMAS, solver, block=block)
    finally:
        lm.lm_step, lm.linearize_graph = plain_step, plain_linearize
    return values, stats, states


@pytest.fixture(scope="module")
def port_runs(small):
    """Each case through the port in blocks of 8, run once for the file:
    (values, stats, states, linearizations, the runs of the loop's body
    and of the re-linearization's branches)."""
    out = {}
    for name in CASES:
        compiled.reset_counts()
        lins: list = []
        out[name] = (*_port_run(small, name, 8, lins), len(lins),
                     {k: list(v) for k, v in compiled.runs.items()})
    return out


def _stop(state, settings) -> str:
    error, lam, it, stall, converged = state
    if not converged:
        return "max_iterations"
    if lam > settings.get("lambda_upper_bound", BASE.lambda_upper_bound):
        return "lambda blow-up"
    if stall >= BASE.plateau_patience:
        return "plateau"
    return "tolerance"


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(tuple(a)),
                                                  jax.tree.leaves(tuple(b))))


@pytest.mark.parametrize("name", sorted(CASES))
def test_lm_state_matches_jax(small, jax_runs, port_runs, name):
    ref = jax_runs[name]
    _, stats, states8, linearizations, runs = port_runs[name]
    it = int(stats.iterations)
    # Blocks of 8 run masked steps after the stop; they change no bit.
    assert len(states8) % 8 == 0 and 1 <= it <= len(states8)
    assert all(_leaves_equal(s, states8[it - 1]) for s in states8[it:])
    ours = [(float(stats.initial_error), ref[0][1], 0, 0, False)] + _states(states8[:it])
    assert len(ours) == len(ref), (ours, ref)
    for (e, lam, i, st, c), (re, rlam, ri, rst, rc) in zip(ours, ref):
        assert (i, st, c) == (ri, rst, rc)
        assert lam == rlam
        assert abs(e - re) <= 1e-6 * abs(re)
    assert abs(ours[-1][0] - ref[-1][0]) <= 1e-9 * abs(ref[-1][0])
    assert float(stats.final_error) == ours[-1][0]
    settings = CASES[name][1]
    assert (_stop(ref[-1], settings), ref[-1][2]) == EXPECTED[name]
    assert (_stop(ours[-1], settings), ours[-1][2]) == EXPECTED[name]
    assert it == ref[-1][2] and float(stats.final_lambda) == ref[-1][1]
    accepts = sum(b[0] < a[0] for a, b in zip(ref, ref[1:]))
    # lax.cond: the first linearization, then one per accepted step; the
    # loop's body ran once per block of 8, its branch once per step.
    assert linearizations == 1 + accepts
    assert runs["lm_linearize"] == [accepts, len(states8) - accepts]
    assert runs["lm_step"] == [len(states8) // 8, 0]
    if name in ("rejects", "lambda blow-up", "NaN candidate"):
        assert accepts < len(ref) - 1          # at least one reject
    if name == "NaN candidate":
        assert accepts == 0 and ours[-1][0] == ours[0][0]


def test_blocks_of_one_and_eight_agree(small, port_runs):
    """The case that stops in the middle of a block of 8 (three masked
    steps after it): blocks of 1 give every bit of blocks of 8."""
    v1, s1, states1 = _port_run(small, "max_iterations mid-block", 1)
    v8, s8, states8 = port_runs["max_iterations mid-block"][:3]
    assert len(states1) == int(s1.iterations) == 5 and len(states8) == 8
    for a, b in zip((*v1, *s1), (*v8, *s8)):
        assert torch.equal(a, b)
    assert all(_leaves_equal(a, b) for a, b in zip(states1, states8))


def _tie_inputs():
    """A float32 error e and candidate error c with e - c equal, in
    float32, to relative_error_tol * e rounded as NumPy 2 and JAX round it
    (the tolerance to float32 first), where rounding the float64 product
    once gives a smaller number: the convergence test is a tie that holds
    in float32 and fails in float64 arithmetic."""
    r = 0.3
    e = np.float32(1.0) + np.arange(1, 200_000, dtype=np.float32) * np.float32(2.0 ** -23)
    prod32 = np.float32(r) * e
    prod64 = (r * e.astype(np.float64)).astype(np.float32)
    exact = prod32 == np.round(prod32 * 2.0 ** 23) / 2.0 ** 23      # a multiple of e's ulp
    i = int(np.flatnonzero(exact & (prod64 < prod32))[0])
    c = e[i] - prod32[i]
    assert np.float32(e[i] - c) == prod32[i]
    return r, e[i], c


def test_float32_decisions_round_as_numpy_and_jax():
    """One step in float32 on a stand-in problem whose candidate error is
    given: at a tie of the relative convergence test the port converges,
    as the former host loop (numpy float32) and the JAX step (weakly typed
    float32) do, where float64 rounding would not."""
    r, e, c = _tie_inputs()
    assert not (np.float64(e) - np.float64(c) <= r * np.float64(e))   # not a tie in float64
    assert (e - c) <= r * e                                           # numpy, NEP 50
    with jax.enable_x64(False):
        je, jc = jnp.float32(e), jnp.float32(c)
        assert bool(jnp.abs(je - jc) <= r * je)                       # the JAX step's test
    f32 = torch.float32
    values = Values(torch.tensor([[1.0, 0, 0, 0]]), torch.zeros(1, 3), torch.zeros(1, 3),
                    torch.zeros(6), torch.zeros(1, 3))
    p = lm._Problem(error=lambda v: torch.tensor(c, dtype=f32),
                    linearize=lambda v: v,
                    solve=lambda lin, lam: torch.zeros(18))
    cfg = config_to_port(dataclasses.replace(
        BASE, relative_error_tol=r, absolute_error_tol=1e-9, max_iterations=4))
    zero = torch.zeros((), dtype=torch.int64)
    state = lm.LMState(values, values, torch.tensor(e, dtype=f32),
                       torch.tensor(cfg.lambda_initial, dtype=f32), zero, zero,
                       torch.zeros((), dtype=torch.bool))
    out = lm.lm_step(state, p, cfg)
    assert bool(out.converged) and float(out.error) == float(c)
    assert out.lam.dtype == f32 and float(out.lam) == float(
        np.maximum(np.float32(cfg.lambda_initial) / np.float32(cfg.lambda_factor),
                   np.float32(cfg.lambda_lower_bound)))
    # After the stop the step changes nothing.
    assert _leaves_equal(out, lm.lm_step(out, p, cfg))
