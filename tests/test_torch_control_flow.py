"""The port's ``lax.while_loop`` and ``lax.cond``
(uslam_tpu_torch/solvers/compiled.py ``while_loop`` / ``cond``) run eagerly
against JAX's, and the CG solve built on them
(uslam_tpu_torch/solvers/schur.py ``_cg_solve``) against the JAX package's.

On the CPU the primitives run eagerly (one host read per test); on the card
the same calls become a CUDA graph's WHILE and IF nodes, which
chip_smoke.py holds to these eager runs bit for bit.

Tolerances, with their reasons:
- the primitives: exact. The functions use elementwise IEEE operations
  alone (no reduction whose order could differ, no product beside a sum
  that XLA could contract into an FMA but by a power of two), in float64
  on both sides; the runs and host reads counted as the loops and branches
  ran;
- the CG: its iterations exact (JAX's stopping rule on systems whose
  residual is far from the tolerance when it stops), its solution to 1e-12
  of its norm (the matrix-vector products sum in another order than XLA's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uslam_tpu.solvers import schur as jschur
from uslam_tpu_torch.config import SolverConfig
from uslam_tpu_torch.solvers import compiled
from uslam_tpu_torch.solvers.lm import graph_config
from uslam_tpu_torch.solvers.schur import _cg_solve

torch.set_num_threads(1)


def _grow(lib, x, n):
    """One step of the loops below, in ``lib`` (jnp or torch). Products by
    powers of two alone: XLA contracts a product and a sum into one FMA,
    which rounds once, where the port rounds twice."""
    return x * 2.0 + 0.25 * (x < 2.0) - 0.125, n + 1


def _jax_loop(x, limit, bound=50.0, stop=False):
    def body(c):
        return _grow(jnp, *c)

    return jax.lax.while_loop(lambda c: (c[1] < limit) & (bound > c[0][0]) & (not stop), body,
                              (x, 0))


def _port_loop(x, limit, form="bool", bound=50.0, stop=False):
    """The loop with its test as a bool tensor, or as a ``compiled.Test``
    (``n < limit``, ``bound > x[0]``, not ``stop``), which the condition
    kernel computes in a graph."""
    def body(c):
        return _grow(torch, *c)

    zero = torch.zeros((), dtype=torch.int64)
    if form == "bool":
        assert bound == 50.0 and not stop
        cond = lambda c: (c[1] < limit) & (c[0][0] < 50.0)   # noqa: E731
    else:
        value, halt = torch.tensor(bound, dtype=x.dtype), torch.tensor(stop)
        cond = lambda c: compiled.Test(c[1], limit, value, c[0][0], halt)   # noqa: E731
    return compiled.while_loop(cond, body, (x, zero), name="grow")


def _x(seed, n=6):
    return np.random.default_rng(seed).uniform(0.1, 3.0, n)


# (limit, x[0] at entry, the test's form, its bound, stop at entry)
WHILE_CASES = {
    "stops on x": (40, 0.5, "bool", 50.0, False),
    "stops on the count": (3, 0.5, "bool", 50.0, False),
    "zero trips": (40, 60.0, "bool", 50.0, False),
    "zero limit": (0, 0.5, "bool", 50.0, False),
    "Test, stops on x": (40, 0.5, "Test", 50.0, False),
    "Test, stops on the count": (3, 0.5, "Test", 50.0, False),
    "Test, zero limit": (0, 0.5, "Test", 50.0, False),
    "Test, stop at entry": (40, 0.5, "Test", 50.0, True),
    "Test, NaN value": (40, 0.5, "Test", float("nan"), False),
    "Test, NaN threshold": (40, float("nan"), "Test", 50.0, False),
}


@pytest.mark.parametrize("limit, start, form, bound, stop", list(WHILE_CASES.values()),
                         ids=list(WHILE_CASES))
def test_while_loop_matches_jax(limit, start, form, bound, stop):
    x = _x(1)
    x[0] = start
    with jax.enable_x64(True):
        jx, jn = jax.device_get(jax.jit(_jax_loop, static_argnums=(1, 2, 3))(
            jnp.asarray(x), limit, bound, stop))
    compiled.reset_counts()
    px, pn = _port_loop(torch.from_numpy(x), limit, form, bound, stop)
    assert np.array_equal(px.numpy(), jx, equal_nan=True) and int(pn) == int(jn)
    assert compiled.runs.get("grow", [0, 0]) == [int(jn), 0]
    assert compiled.reads == {"grow": int(jn) + 1}       # one read per test
    if not start < 50.0 or not bound > 0.5 or limit == 0 or stop:
        assert int(pn) == 0 and np.array_equal(px.numpy(), x, equal_nan=True)
    else:
        assert int(pn) == min(limit, 7)   # 0.5 passes 50 after 7 steps


LIMITS = (0, 1, 3)
FLOATS = (float("-inf"), -1.0, 0.0, 1.0, 2.0, float("inf"), float("nan"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_test_flag_equals_the_former_expressions(dtype):
    """``Test.flag()`` equals the expressions the LM's and the CG's loops
    tested before (``solvers/lm.py::_active``, ``solvers/schur.py``'s
    ``going``) on every combination of a small grid: counters below, at
    and above the limit, values and thresholds with infinities and NaN,
    converged or not."""
    for count in range(5):
        it = torch.tensor(count)
        for limit in LIMITS:
            for converged in (False, True):
                conv = torch.tensor(converged)
                test = compiled.Test(it, limit, stop=conv)
                assert torch.equal(test.flag(), (it < limit) & ~conv)
            for rr, thresh in ((a, b) for a in FLOATS for b in FLOATS):
                rr_t, th_t = torch.tensor(rr, dtype=dtype), torch.tensor(thresh, dtype=dtype)
                test = compiled.Test(it, limit, rr_t, th_t)
                assert torch.equal(test.flag(), (it < limit) & (rr_t > th_t))


def test_graph_key_holds_the_loop_limits():
    """A WHILE test's limit is fixed in its graph, so the solver part of a
    graph's cache key keeps ``max_iterations`` and ``cg_max_iterations``."""
    cfg = SolverConfig()
    key = graph_config(cfg)
    assert graph_config(dataclasses.replace(cfg, max_iterations=cfg.max_iterations + 1)) != key
    assert graph_config(dataclasses.replace(
        cfg, cg_max_iterations=cfg.cg_max_iterations + 1)) != key
    assert graph_config(dataclasses.replace(cfg, debug_nans=True)) == key


def test_nested_while_loop_and_cond_match_jax():
    """A loop whose body runs an inner loop, then a branch on the outer
    count's parity (the LM's shape: a loop, a branch in its body)."""
    x = _x(2)

    def jax_prog(x):
        def outer(c):
            y, i = c
            y, _ = jax.lax.while_loop(lambda t: t[1] < 3, lambda t: (t[0] * 0.5 + 0.5, t[1] + 1),
                                      (y, 0))
            y = jax.lax.cond(i % 2 == 0, lambda a: a * a / 4.0, lambda a: a - 1.0, y)
            return y, i + 1

        return jax.lax.while_loop(lambda c: c[1] < 5, outer, (x, 0))

    def port_prog(x):
        def outer(c):
            y, i = c
            y, _ = compiled.while_loop(lambda t: t[1] < 3,
                                       lambda t: (t[0] * 0.5 + 0.5, t[1] + 1),
                                       (y, torch.zeros_like(i)), name="inner")
            y = compiled.cond(i % 2 == 0, lambda a: a * a / 4.0, lambda a: a - 1.0, y,
                              name="parity")
            return y, i + 1

        return compiled.while_loop(lambda c: c[1] < 5, outer,
                                   (x, torch.zeros((), dtype=torch.int64)), name="outer")

    with jax.enable_x64(True):
        jy, ji = jax.device_get(jax.jit(jax_prog)(jnp.asarray(x)))
    compiled.reset_counts()
    py, pi = port_prog(torch.from_numpy(x))
    assert np.array_equal(py.numpy(), jy) and int(pi) == int(ji) == 5
    assert compiled.runs == {"outer": [5, 0], "inner": [15, 0], "parity": [3, 2]}
    assert compiled.reads == {"outer": 6, "inner": 20, "parity": 5}


@pytest.mark.parametrize("pred", [True, False])
def test_cond_matches_jax(pred):
    x = _x(3)
    y = _x(4)

    branches = (lambda a, b: (a * b, a - b), lambda a, b: (a / b, b * 2.0))
    with jax.enable_x64(True):
        ref = jax.device_get(jax.jit(lambda p, a, b: jax.lax.cond(p, *branches, a, b))(
            pred, jnp.asarray(x), jnp.asarray(y)))
    compiled.reset_counts()
    out = compiled.cond(torch.tensor(pred), *branches, torch.from_numpy(x), torch.from_numpy(y))
    assert all(np.array_equal(o.numpy(), r) for o, r in zip(out, ref))
    assert compiled.runs == {"cond": [1, 0] if pred else [0, 1]}
    assert compiled.reads == {"cond": 1}


def _spd(seed, n=12):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, n))
    # Rows of widely different scale, as the reduced system's are: the
    # Jacobi scaling is what CG sees.
    d = np.diag(10.0 ** rng.uniform(-2, 2, n))
    return d @ (m @ m.T + n * np.eye(n)) @ d, rng.normal(size=n)


@pytest.mark.parametrize("iters, tol, stop", [(50, 1e-8, "tolerance"), (4, 1e-12, "cg_iters"),
                                               (0, 1e-8, "zero iters"),
                                               (50, 1e-8, "NaN residual")])
def test_cg_matches_jax(monkeypatch, iters, tol, stop):
    """The CG's test (``compiled.Test``: it < iters and rr > thresh, its
    ``flag()`` in the eager blocks) against the JAX loop's: stopping on the
    tolerance, on the count, at a zero count, and at once on a NaN
    residual (NaN > thresh is false on both sides)."""
    A, b = _spd(5)
    if stop == "NaN residual":
        b[3] = np.nan
    seen = []
    plain_while = jax.lax.while_loop

    def recording_while(cond, body, init):
        out = plain_while(cond, body, init)
        seen.append(out)
        return out

    monkeypatch.setattr(jax.lax, "while_loop", recording_while)
    with jax.enable_x64(True):
        ref = np.asarray(jschur._cg_solve(jnp.asarray(A), jnp.asarray(b), iters, tol))
        ref_it = int(seen[-1][4])
        ref_rr = float(seen[-1][3])
    compiled.reset_counts()
    x = _cg_solve(torch.from_numpy(A), torch.from_numpy(b), iters, tol).numpy()
    it = compiled.runs.get("cg", [0])[0]
    assert it == ref_it
    if stop == "tolerance":
        assert it < iters
    elif stop == "cg_iters":
        assert it == iters and ref_rr > 1e3 * tol * tol
    else:
        assert it == 0 and (np.isnan(ref_rr) if stop == "NaN residual" else iters == 0)
    assert np.linalg.norm(x - ref) <= 1e-12 * np.linalg.norm(ref)
