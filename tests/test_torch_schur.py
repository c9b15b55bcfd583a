"""The port's default solver (banded camera assembly, landmark Schur
complement, velocity elimination, CG, the default-config LM) against the
JAX package in float64 (JAX under ``jax.enable_x64``) on the same inputs.

Tolerances, with their reasons:
- the banded assembly and its dense expansion: 1e-12 absolute on O(1..100)
  entries; only the order of float64 sums differs (per-frame stereo sums
  by ``index_add_`` where JAX uses a one-hot matmul). The dense expansion
  of a band is pure data movement and must be bit-identical;
- ``inv3x3``: 1e-9 relative, the JAX package's own tolerance against LU;
- Schur steps: 1e-9 relative to the step's largest entry against JAX
  (Cholesky and triangular solves in another library), 1e-7 against the
  port's own dense solve (the JAX package's Schur-vs-dense tolerance);
- CG: 1e-6 relative (iterates of a Krylov method amplify rounding of the
  matrix-vector products);
- the default-config LM: equal iteration counts, final error 1e-9
  relative, as tests/test_torch_backend.py holds the dense LM.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_solver import _random_linearization
from tests.test_torch_backend import SIGMAS, _cams, _jax64, _rel, problem  # noqa: F401
from uslam_tpu.config import SolverConfig
from uslam_tpu.solvers import bands as jbands
from uslam_tpu.solvers import dense as jdense
from uslam_tpu.solvers import schur as jschur
from uslam_tpu.solvers.lm import optimize_lm as jax_optimize_lm
from uslam_tpu_torch.interop import config_to_port, to_port
from uslam_tpu_torch.solvers import bands, dense, schur
from uslam_tpu_torch.solvers.lm import optimize_lm

N, M, K = 7, 5, 4


@pytest.fixture(scope="module")
def lin64():
    """One random float64 linearization with padded observations, as the
    JAX containers (numpy leaves) and as the port's (CPU tensors)."""
    with jax.enable_x64(True):
        lin, stereo = jax.device_get(_random_linearization(np.random.default_rng(2), N, M, K))
    return (lin, stereo), (to_port(lin, "cpu"), to_port(stereo, "cpu"))


def _jax_run(fn, *args):
    with jax.enable_x64(True):
        return jax.device_get(fn(*(_jax64(a) for a in args)))


@pytest.mark.parametrize("diag_damping", [False, True], ids=["identity", "diag"])
def test_bands_match_jax_f64(lin64, diag_damping):
    (jlin, jst), (lin, st) = lin64
    lam = 1e-3 if diag_damping else 0.37
    ref_b = _jax_run(lambda l, s: jbands.assemble_cam_bands(l, s, N, lam, diag_damping), jlin, jst)
    ours_b = bands.assemble_cam_bands(lin, st, N, lam, diag_damping)
    for f in ref_b._fields:
        np.testing.assert_allclose(getattr(ours_b, f).numpy(), getattr(ref_b, f), rtol=0,
                                   atol=1e-12, err_msg=f)
    ref_H, ref_g = _jax_run(jbands.expand_cam_dense, ref_b)
    H, g = bands.expand_cam_dense(ours_b)
    np.testing.assert_allclose(H.numpy(), ref_H, rtol=0, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=0, atol=1e-12)
    # Block-band expansion is data movement: bit-identical on equal inputs.
    blocks = (ref_b.pv_d, ref_b.pv_sup, ref_b.pv_sub)
    np.testing.assert_array_equal(
        bands.band_dense(*(torch.tensor(a) for a in blocks)).numpy(),
        _jax_run(jbands._band_dense, *blocks),
    )


def test_inv3x3_matches_jax():
    rng = np.random.default_rng(7)
    J = rng.standard_normal((64, 5, 3))
    A = np.einsum("mkd,mke->mde", J, J) + 1e-8 * np.eye(3)
    A[0] = 1e-8 * np.eye(3)  # padded landmark: the damping floor only
    ref = _jax_run(jdense.inv3x3, A)
    ours = dense.inv3x3(torch.tensor(A)).numpy()
    rel = np.abs(ours - ref) / np.abs(ref).max(axis=(-2, -1), keepdims=True)
    assert rel.max() < 1e-9, rel.max()
    np.testing.assert_allclose(ours, np.linalg.inv(A), rtol=1e-9, atol=1e-9)


SCHUR_CASES = {
    "full-identity": dict(lam=0.37, diag_damping=False, eliminate_velocities=False),
    "full-diag": dict(lam=1e-3, diag_damping=True, eliminate_velocities=False),
    "vel-identity": dict(lam=0.37, diag_damping=False, eliminate_velocities=True),
    "vel-diag": dict(lam=1e-3, diag_damping=True, eliminate_velocities=True),
}


@pytest.mark.parametrize("case", sorted(SCHUR_CASES))
def test_solve_schur_matches_jax_f64(lin64, case):
    (jlin, jst), (lin, st) = lin64
    c = SCHUR_CASES[case]
    kw = dict(return_aux=True, diag_damping=c["diag_damping"],
              eliminate_velocities=c["eliminate_velocities"])
    d_ref, aux_ref = _jax_run(
        lambda l, s: jschur.solve_schur(l, s, N, M, c["lam"], **kw), jlin, jst
    )
    delta, aux = schur.solve_schur(lin, st, N, M, c["lam"], **kw)
    assert _rel(delta.numpy(), d_ref) < 1e-9
    assert abs(float(aux) - float(aux_ref)) < 1e-9 * abs(float(aux_ref))
    # Against the port's own dense factorization of the full system.
    H, g = dense.assemble_dense_with_landmarks(lin, st.cam_idx, st.lm_idx, N, M)
    d_dense = dense.solve_dense_gn(H, g, c["lam"], diag_damping=c["diag_damping"]).numpy()
    rel = np.linalg.norm(delta.numpy() - d_dense) / np.linalg.norm(d_dense)
    assert rel < 1e-7, rel


def test_cg_matches_jax_f64(lin64):
    (jlin, jst), (lin, st) = lin64
    kw = dict(cg=True, cg_iters=500, cg_tol=1e-12)
    d_ref = _jax_run(lambda l, s: jschur.solve_schur(l, s, N, M, 10.0, **kw), jlin, jst)
    delta = schur.solve_schur(lin, st, N, M, 10.0, **kw)
    assert _rel(delta.numpy(), d_ref) < 1e-6
    # A cap inside the first block of iterations stops where JAX stops.
    kw = dict(cg=True, cg_iters=5, cg_tol=1e-12)
    d_ref = _jax_run(lambda l, s: jschur.solve_schur(l, s, N, M, 10.0, **kw), jlin, jst)
    assert _rel(schur.solve_schur(lin, st, N, M, 10.0, **kw).numpy(), d_ref) < 1e-6


def test_default_lm_matches_jax_f64(problem):  # noqa: F811
    """The default SolverConfig (Schur, velocity elimination, Marquardt
    damping) in float64: same iterations, same final error."""
    cj, ct = _cams(problem["cfg"])
    g, v = problem["graph64"], problem["values64"]
    solver = SolverConfig(max_iterations=8)
    with jax.enable_x64(True):
        run = jax.jit(jax_optimize_lm, static_argnums=(3, 4, 5, 6))
        vals_ref, stats_ref = jax.device_get(run(_jax64(g), _jax64(v), cj, *SIGMAS, solver))
    vals, stats = optimize_lm(
        to_port(g, "cpu"), to_port(v, "cpu"), ct, *SIGMAS, config_to_port(solver)
    )
    assert stats.iterations == int(stats_ref.iterations)
    assert stats.final_error < 1e-3 * stats.initial_error
    assert abs(stats.final_error - float(stats_ref.final_error)) < 1e-9 * float(stats_ref.final_error)
    assert _rel(vals.pose_trans.numpy(), vals_ref.pose_trans) < 1e-9
    # The CG reduced solve runs the same loop (result checked for sanity only:
    # CG's stopping point sets its accuracy).
    cg = dataclasses.replace(config_to_port(solver), reduced_solver="cg", max_iterations=3)
    _, stats_cg = optimize_lm(to_port(g, "cpu"), to_port(v, "cpu"), ct, *SIGMAS, cg)
    assert stats_cg.final_error < stats_cg.initial_error
