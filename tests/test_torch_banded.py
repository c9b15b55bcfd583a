"""The port's banded large-N solver (uslam_tpu_torch/solvers/banded.py)
against the JAX package in float64 (JAX under ``jax.enable_x64``) and
against the port's own Schur solve, on the shapes of tests/test_banded.py.

Tolerances, with their reasons:
- banded steps: 1e-9 relative to the step's largest entry against the JAX
  package (the Schur tolerance of tests/test_torch_schur.py: Cholesky and
  triangular solves in another library, sums in another order), 1e-7
  against the port's own Schur step (the JAX package's banded-vs-Schur
  tolerance is 1e-8 on the norm); g.delta 1e-9 relative;
- the Thomas factor, factor-apply and apply: 1e-9 relative to the largest
  entry; on a panel that is not positive definite, the same finite panels
  as the JAX package (a failed panel is NaN, and so are the later ones);
- band and window measurements: exact (same host numpy);
- a float32 linearization of the single-observation graph: the banded step
  against the float64 dense step of it, 1e-6 relative (its one float32
  rounding is the returned step, as tests/test_torch_single_obs.py holds
  the Schur step);
- the banded LM on the small survey in float64, without jitter: equal
  iterations, final error 1e-9 relative; the banded polish against the
  Schur polish: equal iterations, final error 1e-9 relative.

The port's refinement removes the PD jitter's bias where the JAX
package's keeps it (uslam_tpu_torch/solvers/banded.py):
test_banded_step_removes_the_jitter_bias holds the port's step to the dense
step (1e-7) at the LM's and the polish's lambda and jitter, beside the JAX
package's (off by more than 1e-5 and 1e-7: measured 1.4e-4 and 9.3e-7);
the other comparisons with JAX use a jitter too small to matter.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_banded import _windowed_linearization
from tests.test_solver import _random_linearization
from tests.test_torch_backend import _rel
from tests.test_torch_single_obs import CFG as SINGLE_CFG
from tests.test_torch_single_obs import SIGMAS as SINGLE_SIGMAS
from tests.test_torch_single_obs import single_obs  # noqa: F401
from uslam_tpu.config import UslamConfig
from uslam_tpu.geometry import camera as jcam
from uslam_tpu.graph.packing import pack_sequence as jax_pack
from uslam_tpu.io.synthetic import SyntheticSpec, generate_synthetic_sequence
from uslam_tpu.pipeline import AUVSlam as JaxAUVSlam
from uslam_tpu.solvers import banded as jbanded
from uslam_tpu.solvers.lm import optimize_lm as jax_optimize_lm
from uslam_tpu_torch.device import cast_tree
from uslam_tpu_torch.geometry import camera as tcam
from uslam_tpu_torch.interop import config_to_port, to_port
from uslam_tpu_torch.pipeline import AUVSlam
from uslam_tpu_torch.solvers import banded, dense, schur
from uslam_tpu_torch.solvers.linearize import linearize_graph
from uslam_tpu_torch.solvers.lm import check_finite, optimize_lm
from uslam_tpu_torch.solvers.polish import polish_f64

torch.set_num_threads(1)

# name: (n, m, K, track span or None for full span, rng seed)
GRAPHS = {
    "full": (7, 5, 4, None, 7),          # band_w = N-1
    "windowed": (25, 12, 4, 5, 11),      # several panels, short tracks
    "a0": (15, 8, 6, 13, 23),            # chunk window F < 2 band_w
    "long": (30, 10, 8, 28, 31),         # long tracks: band_w ~ n
}


@pytest.fixture(scope="module")
def graphs():
    """Random float64 linearizations, as numpy (for JAX) and CPU tensors."""
    out = {}
    with jax.enable_x64(True):
        for name, (n, m, K, span, seed) in GRAPHS.items():
            rng = np.random.default_rng(seed)
            lin, st = (_random_linearization(rng, n, m, K) if span is None
                       else _windowed_linearization(rng, n, m, K, span))
            lin, st = jax.device_get((lin, st))
            out[name] = (n, m, lin, st, to_port(lin, "cpu"), to_port(st, "cpu"))
    return out


# name: (graph, damping, diag_damping, solve kwargs; band_w None = measured)
STEPS = {
    "full-identity": ("full", 0.37, False, dict(band_w=6)),
    "full-diag": ("full", 1e-3, True, dict(band_w=6)),
    "windowed-panel8": ("windowed", 1e-2, True, dict(panel=8)),
    "windowed-panel12": ("windowed", 1e-2, True, dict(panel=12)),
    "windowed-corr": ("windowed", 1e-2, True, dict(panel=8, corr_lm_chunk=4, corr_window=-1)),
    "a0-corr": ("a0", 1e-2, True, dict(corr_lm_chunk=4, corr_window=-1)),
    "long-corr": ("long", 0.37, False, dict(corr_lm_chunk=4, corr_window=-1)),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_banded_step_matches_jax_and_schur_f64(graphs, case):
    name, lam, dd, kw = STEPS[case]
    n, m, jlin, jst, lin, st = graphs[name]
    kw = dict(kw)
    kw.setdefault("band_w", jbanded.measure_band_width(jst))
    if kw.get("corr_window") == -1:
        kw["corr_window"] = cw = jbanded.measure_corr_window(jst, lm_chunk=4)
        assert 0 < cw < n
        if name == "a0":
            assert cw < 2 * kw["band_w"], (cw, kw["band_w"])   # the regression regime
    if name == "long":
        assert kw["band_w"] >= n - 3
    common = dict(return_aux=True, diag_damping=dd, jitter=1e-12, refine_iters=3, **kw)
    with jax.enable_x64(True):
        step = jax.jit(functools.partial(jbanded.solve_schur_banded, num_poses=n,
                                         num_landmarks=m, damping=lam, **common))
        d_ref, a_ref = jax.device_get(step(jlin, jst))
    delta, aux = banded.solve_schur_banded(lin, st, n, m, lam, **common)
    assert delta.dtype == torch.float64 and bool(torch.isfinite(delta).all())
    assert _rel(delta.numpy(), d_ref) < 1e-9
    assert abs(float(aux) - float(a_ref)) < 1e-9 * abs(float(a_ref))
    d_schur = schur.solve_schur(lin, st, n, m, lam, diag_damping=dd, jitter=1e-12)
    assert _rel(delta.numpy(), d_schur.numpy()) < 1e-7


def test_thomas_sweeps_match_jax_and_raise_on_failed_panel():
    """A panel that is not positive definite: the factor holds NaN where
    the JAX package's does (the failed panel and the later ones) and
    nothing raises; the raise comes only from ``debug_nans``' check of the
    factor (test_failed_panel_raises_only_under_debug_nans)."""
    rng = np.random.default_rng(4)
    npan, d, k = 4, 12, 3
    A = rng.standard_normal((npan, d, d))
    D = A @ A.transpose(0, 2, 1) + 4 * d * np.eye(d)
    O = rng.standard_normal((npan - 1, d, d))
    rhs = rng.standard_normal((npan, d, k))
    bad = D.copy()
    bad[2] = -bad[2]    # panel 2 not positive definite
    with jax.enable_x64(True):
        L_ref, x_ref = jax.device_get(jbanded.block_tridiag_factor_apply(D, O, rhs))
        L2_ref = jax.device_get(jbanded.block_tridiag_factor(D, O))
        y_ref = jax.device_get(jbanded.block_tridiag_apply(L2_ref, O, 2 * rhs))
        Lb_ref = jax.device_get(jbanded.block_tridiag_factor(bad, O))
        Lbb_ref, xb_ref = jax.device_get(jbanded.block_tridiag_factor_apply(bad, O, rhs))
    Dt, Ot, rt = (torch.tensor(a) for a in (D, O, rhs))
    L, x = banded.block_tridiag_factor_apply(Dt, Ot, rt)
    L2 = banded.block_tridiag_factor(Dt, Ot)
    y = banded.block_tridiag_apply(L2, Ot, 2 * rt)
    for ours, ref in ((L, L_ref), (x, x_ref), (L2, L2_ref), (y, y_ref)):
        assert _rel(ours.numpy(), ref) < 1e-9
    # A panel that is not positive definite gives NaN, as in the JAX
    # package, and the NaN spreads to the later panels; nothing raises.
    Lb = banded.block_tridiag_factor(torch.tensor(bad), Ot)
    Lbb, xb = banded.block_tridiag_factor_apply(torch.tensor(bad), Ot, rt)

    def finite(a):
        return np.isfinite(np.asarray(a)).all(axis=(-2, -1)).tolist()

    assert finite(Lb_ref) == finite(Lbb_ref) == [True, True, False, False]
    assert finite(Lb) == finite(Lbb) == finite(Lb_ref)
    assert finite(xb) == finite(xb_ref)
    assert _rel(Lb[:2].numpy(), Lb_ref[:2]) < 1e-9
    with pytest.raises(FloatingPointError, match="banded factorization"):
        check_finite("banded factorization", Lb)


def _failing_banded_case(survey, solver="banded"):
    """The survey in float64 with identity damping at a negative lambda:
    every damped system is indefinite, so the banded solve's first panel
    (the Schur solve's reduced Cholesky) fails."""
    cfg, graph, _, g64, v64 = survey
    tcfg = config_to_port(cfg)
    kw = dict(band_width=banded.measure_band_width(to_port(graph.stereo, "cpu")))
    if solver == "banded":
        kw["reduced_solver"] = "banded"
    lm_cfg = dataclasses.replace(tcfg.solver, damping_mode="identity", lambda_initial=-1e3,
                                 max_iterations=2, **kw)
    ct = tcam.StereoCamera.from_config(tcfg.camera, device="cpu", dtype=torch.float64)
    return to_port(g64, "cpu"), to_port(v64, "cpu"), ct, lm_cfg


def test_failed_panel_raises_only_under_debug_nans(survey):
    g, v, ct, lm_cfg = _failing_banded_case(survey)
    lin = linearize_graph(g, v, ct, *SURVEY_SIGMAS)
    n, m = v.num_poses, v.num_landmarks
    kw = dict(band_w=lm_cfg.band_width, jitter=1e-7)
    delta = banded.solve_schur_banded(lin, g.stereo, n, m, -1e3, **kw)
    assert not bool(torch.isfinite(delta).any())
    with pytest.raises(FloatingPointError, match="banded factorization"):
        banded.solve_schur_banded(lin, g.stereo, n, m, -1e3, check=check_finite, **kw)
    with pytest.raises(FloatingPointError, match="banded factorization"):
        optimize_lm(g, v, ct, *SURVEY_SIGMAS, dataclasses.replace(lm_cfg, debug_nans=True))


def test_lm_rejects_a_failed_banded_step(survey):
    """A banded step whose panel fails is rejected and lambda multiplied,
    as on the port's Schur path (and in the JAX package, whose factor gives
    the same NaN panels: test_thomas_sweeps_match_jax_and_raise_on_failed_panel;
    its LM's NaN guard: tests/test_torch_lm_device.py)."""
    g, v, ct, lm_cfg = _failing_banded_case(survey)
    _, stats = optimize_lm(g, v, ct, *SURVEY_SIGMAS, lm_cfg)
    _, ref = optimize_lm(g, v, ct, *SURVEY_SIGMAS,
                         _failing_banded_case(survey, solver="schur")[3])
    assert stats == ref
    assert stats.iterations == 2 and not stats.converged
    assert stats.final_error == stats.initial_error
    assert stats.final_lambda == -1e3 * lm_cfg.lambda_factor ** 2


def test_bias_solve_of_a_singular_system_matches_jax():
    """The banded solve's bias system goes through ``torch.linalg.solve_ex``
    (no host read, no raise). Exactly singular, it gives JAX's
    ``jnp.linalg.solve`` values (NaN and Inf in the same places); rank
    deficient only in exact arithmetic, LAPACK's LU in the port finds a
    tiny pivot and returns huge finite values where JAX's gives NaN and
    -Inf. Not a fault of the port (ROADMAP C8): both LUs take the same
    pivots, and JAX's, like scipy's ``lu_factor``, ends on a pivot of
    exactly 0.0 where torch's (MKL) ends on 1.84e-16, the LAPACK builds'
    rounding on a matrix singular to working precision. The LM rejects
    the step either way."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 5))
    near = A @ A.T
    b = rng.standard_normal(6)
    exact = np.diag([1.0, 1.0, 1.0, 1.0, 1.0, 0.0])
    with jax.enable_x64(True):
        ref_exact, ref_near = (np.asarray(jnp.linalg.solve(S, b)) for S in (exact, near))
    ours_exact, ours_near = (torch.linalg.solve_ex(torch.tensor(S), torch.tensor(b))[0].numpy()
                             for S in (exact, near))
    np.testing.assert_array_equal(ours_exact, ref_exact)
    assert not np.isfinite(ref_exact).all()
    assert not np.isfinite(ref_near).all()
    assert np.isfinite(ours_near).all() and np.abs(ours_near).max() > 1e12


def test_measurements_match_jax_with_masked_slots():
    """tests/test_banded.py:145's graph: one slot masked per landmark and
    landmarks in first-appearance order (int64 before the where)."""
    rng = np.random.default_rng(5)
    n, m, K, span = 200, 40, 4, 5
    _, stereo = jax.device_get(_windowed_linearization(rng, n, m, K, span))
    mask = np.asarray(stereo.lm_obs_mask).copy()
    mask[:, -1] = 0.0
    cam_g = np.asarray(stereo.cam_idx)[np.asarray(stereo.lm_obs_idx)]
    order = np.argsort(np.where(mask > 0, cam_g, n).min(axis=1), kind="stable")
    stereo = stereo._replace(lm_obs_idx=np.asarray(stereo.lm_obs_idx)[order],
                             lm_obs_mask=mask[order])
    st = to_port(stereo, "cpu")
    bw = banded.measure_band_width(st)
    assert bw == jbanded.measure_band_width(stereo) and 1 <= bw <= span
    for chunk in (4, 8, 128):
        cw = banded.measure_corr_window(st, lm_chunk=chunk)
        assert cw == jbanded.measure_corr_window(stereo, lm_chunk=chunk)
    assert banded.measure_corr_window(st, lm_chunk=8) < n // 2


def test_f32_banded_step_matches_f64_dense_on_single_obs(single_obs):  # noqa: F811
    graph, values = single_obs
    n, m = values.pose_trans.shape[0], values.landmarks.shape[0]
    g32, v32 = to_port(graph, "cpu"), to_port(values, "cpu")
    cam = tcam.StereoCamera.from_config(config_to_port(SINGLE_CFG.camera), device="cpu")
    lin = linearize_graph(g32, v32, cam, *SINGLE_SIGMAS, SINGLE_CFG.noise.stereo_huber_delta)
    H, g = dense.assemble_dense_with_landmarks(
        cast_tree(lin, torch.float64, "cpu"), g32.stereo.cam_idx, g32.stereo.lm_idx, n, m)
    bw = banded.measure_band_width(g32.stereo)
    for lam in (SINGLE_CFG.solver.lambda_initial, 1e-2):
        ref = dense.solve_dense_gn(H, g, lam, diag_damping=True).numpy()
        ours = banded.solve_schur_banded(
            lin, g32.stereo, n, m, lam, band_w=bw, diag_damping=True,
            jitter=SINGLE_CFG.solver.cholesky_jitter, refine_iters=1,
        )
        assert ours.dtype == torch.float32
        rel = np.linalg.norm(ours.double().numpy() - ref) / np.linalg.norm(ref)
        assert rel < 1e-6, (lam, rel)


SURVEY = dict(trajectory="survey", duration=30.0, num_landmarks=96, odom_drift_rate=0.03,
              feature_noise_px=0.3, seed=4)
SURVEY_SIGMAS = (UslamConfig().noise.dvl_sigma, UslamConfig().noise.stereo_sigma,
                 UslamConfig().imu.gravity)


@pytest.fixture(scope="module")
def survey():
    """tests/test_banded.py:221's survey, packed by the JAX package, in
    float32 and float64 numpy."""
    cfg = UslamConfig()
    graph, values = jax.device_get(
        jax_pack(generate_synthetic_sequence(SyntheticSpec(**SURVEY)), cfg)[:2])

    def as64(t):
        return jax.tree.map(
            lambda a: np.asarray(a, np.float64) if np.issubdtype(a.dtype, np.floating) else a, t)

    return cfg, graph, values, as64(graph), as64(values)


def test_banded_lm_matches_jax_f64(survey):
    cfg, graph, _, g64, v64 = survey
    bw = jbanded.measure_band_width(graph.stereo)
    cw = jbanded.measure_corr_window(graph.stereo)
    assert bw < v64.pose_trans.shape[0] and cw < v64.pose_trans.shape[0]
    # No jitter: the JAX package's banded refinement keeps the jitter's bias,
    # the port's removes it (test_banded_step_removes_the_jitter_bias).
    solver = dataclasses.replace(cfg.solver, reduced_solver="banded", band_width=bw,
                                 banded_corr_window=cw, max_iterations=8, cholesky_jitter=0.0)
    with jax.enable_x64(True):
        cj = jcam.StereoCamera.from_config(cfg.camera, jnp.float64)
        run = jax.jit(jax_optimize_lm, static_argnums=(3, 4, 5, 6))
        _, ref = jax.device_get(run(jax.tree.map(jnp.asarray, g64),
                                    jax.tree.map(jnp.asarray, v64), cj, *SURVEY_SIGMAS, solver))
    ct = tcam.StereoCamera.from_config(config_to_port(cfg.camera), device="cpu",
                                       dtype=torch.float64)
    _, stats = optimize_lm(to_port(g64, "cpu"), to_port(v64, "cpu"), ct, *SURVEY_SIGMAS,
                           config_to_port(solver))
    assert stats.final_error < 1e-2 * stats.initial_error
    assert stats.iterations == int(ref.iterations)
    assert abs(stats.final_error - float(ref.final_error)) < 1e-9 * float(ref.final_error)


def test_banded_step_removes_the_jitter_bias(survey):
    """At the LM's settings (lambda 1e-5, jitter 1e-8) and the polish's
    (lambda 1e-7, jitter 1e-12) on the survey in float64: the port's banded
    step equals the dense step, where the JAX package's, which refines
    against the jittered band, is far off."""
    cfg, graph, _, g64, v64 = survey
    n, m = v64.pose_trans.shape[0], v64.landmarks.shape[0]
    bw = jbanded.measure_band_width(graph.stereo)
    cw = jbanded.measure_corr_window(graph.stereo)
    g, v = to_port(g64, "cpu"), to_port(v64, "cpu")
    cam = tcam.StereoCamera.from_config(config_to_port(cfg.camera), device="cpu",
                                        dtype=torch.float64)
    lin = linearize_graph(g, v, cam, *SURVEY_SIGMAS)
    H, grad = dense.assemble_dense_with_landmarks(lin, g.stereo.cam_idx, g.stereo.lm_idx, n, m)
    kw = dict(band_w=bw, corr_window=cw, diag_damping=True, refine_iters=2)
    with jax.enable_x64(True):
        jl = jax.tree.map(lambda t: jnp.asarray(t.numpy()), (lin, g.stereo))
        # Damping and jitter traced: one compile for both settings.
        step = jax.jit(lambda lin, st, lam, jitter: jbanded.solve_schur_banded(
            lin, st, n, m, lam, jitter=jitter, **kw))
        for name, lam, jitter, jax_off in (("LM", cfg.solver.lambda_initial,
                                            cfg.solver.cholesky_jitter, 1e-5),
                                           ("polish", 1e-7, 1e-12, 1e-7)):
            ref = dense.solve_dense_gn(H, grad, lam, diag_damping=True, jitter=0.0).numpy()
            ours = banded.solve_schur_banded(lin, g.stereo, n, m, lam, jitter=jitter, **kw)
            theirs = np.asarray(step(*jl, lam, jitter))
            rel = np.linalg.norm(ours.numpy() - ref) / np.linalg.norm(ref)
            rel_jax = np.linalg.norm(theirs - ref) / np.linalg.norm(ref)
            print(f"{name} settings (lambda {lam}, jitter {jitter}): banded step vs the dense "
                  f"step, port {rel:.3e}, JAX {rel_jax:.3e}")
            assert rel < 1e-7, (name, rel)
            assert rel_jax > jax_off, (name, rel_jax)


def test_auvslam_band_measurement_and_validation_match_jax(survey):
    """AUVSlam.solve measures band width and correction window off the
    graph as the JAX package does, and both raise on an undersized band
    width or window; the LM's ValueError on band_width 0 is kept."""
    cfg, graph, values, *_ = survey
    bw = jbanded.measure_band_width(graph.stereo)
    cw = jbanded.measure_corr_window(graph.stereo)
    tcfg = config_to_port(cfg)
    auto = dataclasses.replace(tcfg.solver, reduced_solver="banded", max_iterations=3)
    slam = AUVSlam(dataclasses.replace(tcfg, solver=auto), device="cpu")
    slam._graph_cache = (to_port(graph, "cpu"), to_port(values, "cpu"))
    m = slam.solve().metrics
    assert (m["band_width"], m["banded_corr_window"]) == (bw, cw)
    assert m["final_error"] < m["initial_error"]
    for bad in (dict(band_width=bw - 1), dict(band_width=bw, banded_corr_window=cw - 1)):
        jslam = JaxAUVSlam(dataclasses.replace(
            cfg, solver=dataclasses.replace(cfg.solver, reduced_solver="banded", **bad)))
        jslam._graph_cache = (graph, values)
        with pytest.raises(ValueError):
            jslam.solve()
        slam = AUVSlam(dataclasses.replace(tcfg, solver=dataclasses.replace(auto, **bad)),
                       device="cpu")
        slam._graph_cache = (to_port(graph, "cpu"), to_port(values, "cpu"))
        with pytest.raises(ValueError, match="band_width|banded_corr_window"):
            slam.solve()
    ct = tcam.StereoCamera.from_config(tcfg.camera, device="cpu")
    with pytest.raises(ValueError, match="band_width"):
        optimize_lm(to_port(graph, "cpu"), to_port(values, "cpu"), ct, *SURVEY_SIGMAS, auto)


def test_banded_polish_matches_schur_polish(survey):
    cfg, graph, values, *_ = survey
    tcfg = config_to_port(cfg)
    bw = jbanded.measure_band_width(graph.stereo)
    cw = jbanded.measure_corr_window(graph.stereo)
    cam = tcam.StereoCamera.from_config(tcfg.camera, device="cpu")
    g, v = to_port(graph, "cpu"), to_port(values, "cpu")
    out = {}
    for name, solver in (
        ("banded", dataclasses.replace(tcfg.solver, reduced_solver="banded", band_width=bw,
                                       banded_corr_window=cw)),
        ("schur", tcfg.solver),
    ):
        out[name] = polish_f64(g, v, cam, *SURVEY_SIGMAS, solver, max_iters=3, device="cpu")
    (vb, ib), (vs, is_) = out["banded"], out["schur"]
    assert vb.pose_trans.dtype == torch.float64
    assert ib["polish_final_error"] < ib["polish_initial_error"]
    assert ib["polish_iterations"] == is_["polish_iterations"]
    assert abs(ib["polish_final_error"] - is_["polish_final_error"]) < 1e-9 * is_["polish_final_error"]
    assert _rel(vb.pose_trans.numpy(), vs.pose_trans.numpy()) < 1e-7
