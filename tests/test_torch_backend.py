"""The port's back end (geometry, graph packing, linearization, dense solve,
LM) against the JAX package on the same numpy inputs.

Tolerances, with their reasons:
- geometry in float64: 1e-12 absolute on O(1) quantities (same formulas,
  float64 rounding only); the scipy oracles of tests/test_geometry.py at
  1e-10;
- config, synthetic sequences and the time join: exact (same host numpy
  code, same random draws);
- packed graph leaves: integers exact, floats 1e-6 relative, plus 1e-12 of
  the leaf's largest entry for entries that are 0 analytically: the JAX
  package computes the IMU whiteners with its native C++ recursion, the
  port with numpy, and f64 rounding leaves ~1e-14 where the exact value is
  0 (every other leaf is bit-identical);
- every Linearization field, one dense Gauss-Newton step and the LM run, in
  float64 (JAX under ``jax.enable_x64``): 1e-9 relative to the field's
  largest entry. Only the order of float64 sums differs (scatter-add,
  Cholesky), which moves results by ~1e-15 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from uslam_tpu import config as jconfig
from uslam_tpu.config import SolverConfig, UslamConfig
from uslam_tpu.geometry import camera as jcam
from uslam_tpu.geometry import se3 as jse3
from uslam_tpu.geometry import so3 as jso3
from uslam_tpu.graph.packing import pack_sequence as jax_pack
from uslam_tpu.io import synthetic as jsynth
from uslam_tpu.io import timesync as jtimesync
from uslam_tpu.io.synthetic import SyntheticSpec, generate_synthetic_sequence
from uslam_tpu.solvers import dense as jdense
from uslam_tpu.solvers.linearize import graph_error as jax_graph_error
from uslam_tpu.solvers.linearize import linearize_graph as jax_linearize
from uslam_tpu.solvers.lm import optimize_lm as jax_optimize_lm
from uslam_tpu_torch import config as tconfig
from uslam_tpu_torch.geometry import camera as tcam
from uslam_tpu_torch.geometry import se3 as tse3
from uslam_tpu_torch.geometry import so3 as tso3
from uslam_tpu_torch.graph.packing import pack_sequence
from uslam_tpu_torch.interop import config_to_port, from_port, to_port
from uslam_tpu_torch.io import synthetic as tsynth
from uslam_tpu_torch.io import timesync as ttimesync
from uslam_tpu_torch.pipeline import AUVSlam, run_solver
from uslam_tpu_torch.solvers import dense as tdense
from uslam_tpu_torch.solvers.linearize import graph_error, linearize_graph
from uslam_tpu_torch.solvers.lm import optimize_lm

RNG = np.random.default_rng(0)
SIGMAS = (0.1, 10.0, 9.81)  # dvl_sigma, stereo_sigma, gravity


def _rotvecs(n):
    """Rotation vectors with |w| < pi (log(exp(w)) wraps beyond)."""
    axis = RNG.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return axis * RNG.uniform(0.0, 3.0, (n, 1))


def _quats(n):
    q = RNG.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.where(q[:, :1] < 0, -q, q)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _both(jfn, tfn, *args):
    """Run a JAX function (float64) and its port on the same numpy args."""
    with jax.enable_x64(True):
        ref = jax.device_get(jfn(*(jax.tree.map(jnp.asarray, a) for a in args)))
    ours = tfn(*(jax.tree.map(_t, a) for a in args))
    return ref, ours


def _flat(x):
    if isinstance(x, tuple):
        return np.concatenate([_flat(a) for a in x])
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x).ravel()


N = 16
W, Q, Q2 = _rotvecs(N), _quats(N), _quats(N)
XI = np.concatenate([_rotvecs(N), RNG.normal(size=(N, 3))], -1)
PT = RNG.normal(size=(N, 3)) + np.array([0.0, 0.0, 4.0])
POSE_A = (Q, RNG.normal(size=(N, 3)))
POSE_B = (Q2, RNG.normal(size=(N, 3)))
CAM = (1827.0, 1827.6, 968.9, 561.4, 0.063)

GEOMETRY_CASES = {
    "so3_exp": (lambda m: m.so3_exp, (W,)),
    "so3_log": (lambda m: m.so3_log, (Q,)),
    "quat_multiply": (lambda m: m.quat_multiply, (Q, Q2)),
    "quat_rotate": (lambda m: m.quat_rotate, (Q, PT)),
    "so3_left_jacobian": (lambda m: m.so3_left_jacobian, (W,)),
    "so3_left_jacobian_inverse": (lambda m: m.so3_left_jacobian_inverse, (W,)),
    "se3_exp": (lambda m: m.se3_exp, (XI,)),
    "se3_log": (lambda m: lambda q, t: m.se3_log(m.Pose3(q, t)), POSE_A),
    "pose_compose": (
        lambda m: lambda qa, ta, qb, tb: m.pose_compose(m.Pose3(qa, ta), m.Pose3(qb, tb)),
        POSE_A + POSE_B,
    ),
    "pose_local": (
        lambda m: lambda qa, ta, qb, tb: m.pose_local(m.Pose3(qa, ta), m.Pose3(qb, tb)),
        POSE_A + POSE_B,
    ),
    "pose_retract": (
        lambda m: lambda q, t, xi: m.pose_retract(m.Pose3(q, t), xi), POSE_A + (XI,),
    ),
    "pose_transform_point_inverse": (
        lambda m: lambda q, t, x: m.pose_transform_point_inverse(m.Pose3(q, t), x),
        POSE_A + (PT,),
    ),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY_CASES))
def test_geometry_matches_jax(name):
    pick, args = GEOMETRY_CASES[name]
    mod_j = jse3 if hasattr(jse3, name) or name.startswith("se3") else jso3
    mod_t = tse3 if mod_j is jse3 else tso3
    ref, ours = _both(pick(mod_j), pick(mod_t), *args)
    np.testing.assert_allclose(_flat(ours), _flat(ref), rtol=0, atol=1e-12)


def test_stereo_projection_matches_jax():
    def jfn(q, t, p):
        c = jcam.StereoCamera(*(jnp.asarray(v, jnp.float64) for v in CAM))
        return jcam.project_world_point(c, jse3.Pose3(q, t), p)

    def tfn(q, t, p):
        c = tcam.StereoCamera(*(torch.tensor(v, dtype=torch.float64) for v in CAM))
        return tcam.project_world_point(c, tse3.Pose3(q, t), p)

    ref, ours = _both(jfn, tfn, *POSE_A, PT)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-12)


def test_so3_against_scipy():
    q = tso3.so3_exp(_t(W)).numpy()
    np.testing.assert_allclose(
        np.abs(q[:, [1, 2, 3, 0]]), np.abs(Rotation.from_rotvec(W).as_quat()), atol=1e-10
    )
    np.testing.assert_allclose(tso3.so3_log(_t(q)).numpy(), W, atol=1e-10)
    R = Rotation.from_quat(Q[:, [1, 2, 3, 0]])
    np.testing.assert_allclose(tso3.quat_rotate(_t(Q), _t(PT)).numpy(), R.apply(PT), atol=1e-10)
    prod = (R * Rotation.from_quat(Q2[:, [1, 2, 3, 0]])).as_quat()[:, [3, 0, 1, 2]]
    ours = tso3.quat_multiply(_t(Q), _t(Q2)).numpy()
    np.testing.assert_allclose(ours * np.sign(ours[:, :1] * prod[:, :1]), prod, atol=1e-10)


@pytest.mark.parametrize("name", ["so3_exp", "log_exp", "se3_exp"])
def test_jacobians_finite_at_zero(name):
    """Forward-mode derivatives at the zero tangent (where the linearizer
    takes them and the Taylor branches apply): finite and equal to JAX's
    jacfwd."""
    fns = {
        "so3_exp": (jso3.so3_exp, tso3.so3_exp, 3),
        "log_exp": (lambda w: jso3.so3_log(jso3.so3_exp(w)),
                    lambda w: tso3.so3_log(tso3.so3_exp(w)), 3),
        "se3_exp": (lambda x: jnp.concatenate(jse3.se3_exp(x)),
                    lambda x: torch.cat(tse3.se3_exp(x)), 6),
    }
    jfn, tfn, dim = fns[name]
    zero = torch.zeros(dim, dtype=torch.float64)
    fwd = torch.func.jacfwd(tfn)(zero)
    with jax.enable_x64(True):
        ref = np.asarray(jax.jacfwd(jfn)(jnp.zeros(dim, jnp.float64)))
    assert torch.isfinite(fwd).all()
    np.testing.assert_allclose(fwd.numpy(), ref, atol=1e-14)


def test_triangulate_stereo_np_matches_jax():
    cfg = UslamConfig().camera
    meas = np.stack([RNG.uniform(800, 1100, N), RNG.uniform(700, 790, N), RNG.uniform(400, 700, N)], -1)
    np.testing.assert_array_equal(
        tcam.triangulate_stereo_np(cfg, Q, POSE_A[1], meas),
        jcam.triangulate_stereo_np(cfg, Q, POSE_A[1], meas),
    )


# ---- host inputs: config, synthetic sequences, time join ----------------


def test_config_matches_jax():
    """Same sections, fields and defaults, so a config crosses either way."""
    asdict = dataclasses.asdict
    assert asdict(tconfig.UslamConfig()) == asdict(jconfig.UslamConfig())
    assert tconfig.DEFAULT_CONFIG == tconfig.UslamConfig()
    custom = UslamConfig(
        solver=SolverConfig(linear_solver="dense"),
        frontend=jconfig.FrontendConfig(pyramid_levels=1, max_features_per_cell=6),
    )
    ported = config_to_port(custom)
    assert type(ported) is tconfig.UslamConfig
    assert type(ported.solver) is tconfig.SolverConfig
    assert asdict(ported) == asdict(custom)
    assert ported.frontend.max_features == custom.frontend.max_features == 72
    assert ported.camera.f_mean == custom.camera.f_mean


@pytest.mark.parametrize("trajectory", ["orbit", "survey"])
def test_synthetic_sequence_matches_jax(trajectory):
    """Draw for draw: every stream, feature frame and rendered image equal."""
    cam = dict(fx=150.0, fy=150.0, cx=64.0, cy=48.0, baseline=0.1,
               resolution_x=128, resolution_y=96)
    spec = dict(duration=2.0, trajectory=trajectory, num_landmarks=60, imu_acc_noise=0.01,
                imu_gyro_noise=0.001, dvl_noise=0.02, feature_noise_px=0.5,
                odom_drift_rate=0.05, seed=4)
    ref = jsynth.generate_synthetic_sequence(
        jsynth.SyntheticSpec(**spec), jconfig.CameraConfig(**cam), render_images=True
    )
    ours = tsynth.generate_synthetic_sequence(
        tsynth.SyntheticSpec(**spec), tconfig.CameraConfig(**cam), render_images=True
    )
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(ours, f.name)
        if f.name == "features":
            assert len(a) == len(b) == 10
            for fa, fb in zip(a, b):
                for k in vars(fa):
                    np.testing.assert_array_equal(getattr(fb, k), getattr(fa, k), err_msg=k)
        elif a is None:
            assert b is None, f.name
        else:
            np.testing.assert_array_equal(b, a, err_msg=f.name)
    assert sum(len(fr.ids) for fr in ours.features) >= 10


def test_time_join_matches_jax():
    rng = np.random.default_rng(5)
    pivot = np.sort(rng.uniform(0.0, 20.0, 60))
    others = [np.sort(rng.uniform(0.0, 20.0, n)) for n in (80, 50)]
    ref = jtimesync.approximate_time_join(pivot, others, 0.2)
    assert ttimesync.approximate_time_join(pivot, others, 0.2) == ref
    assert len(ref) >= 10
    assert ttimesync.slice_stream(pivot, 3.0, 9.0) == jtimesync.slice_stream(pivot, 3.0, 9.0)


# ---- packed graph, linearization, solve ---------------------------------


@pytest.fixture(scope="module")
def problem():
    """A 3 s synthetic dive with precomputed features (15 keyframes), made
    and packed by each package on its own; values perturbed so every
    residual is nonzero."""
    spec = dict(duration=3.0, odom_drift_rate=0.05, feature_noise_px=0.3, seed=1)
    seq = generate_synthetic_sequence(SyntheticSpec(**spec))
    cfg = UslamConfig(solver=SolverConfig(linear_solver="dense"))
    jax_out = jax_pack(seq, cfg)
    ours = pack_sequence(
        tsynth.generate_synthetic_sequence(tsynth.SyntheticSpec(**spec)), config_to_port(cfg)
    )
    graph, values = jax.device_get(jax_out[:2])
    rng = np.random.default_rng(3)
    values64 = jax.tree.map(lambda a: np.asarray(a, np.float64), values)
    values64 = values64._replace(
        pose_trans=values64.pose_trans + rng.normal(0, 0.05, values64.pose_trans.shape),
        vel=values64.vel + rng.normal(0, 0.1, values64.vel.shape),
        bias=values64.bias + rng.normal(0, 0.01, 6),
    )
    graph64 = jax.tree.map(
        lambda a: np.asarray(a, np.float64) if np.issubdtype(a.dtype, np.floating) else a, graph
    )
    return dict(seq=seq, cfg=cfg, jax_out=jax_out, ours=ours, graph64=graph64, values64=values64)


def _cams(cfg):
    with jax.enable_x64(True):
        cj = jcam.StereoCamera.from_config(cfg.camera, jnp.float64)
    ct = tcam.StereoCamera.from_config(
        config_to_port(cfg.camera), device="cpu", dtype=torch.float64
    )
    return cj, ct


def test_pack_sequence_matches_jax(problem):
    jg, jv, jodom, jrows = problem["jax_out"]
    tg, tv, todom, trows = problem["ours"]
    ref = jax.tree.leaves(jax.device_get((jg, jv)))
    got = jax.tree.leaves((tg, tv))   # the port's NamedTuples flatten alike
    assert len(ref) == len(got) == 31
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-12 * np.abs(a).max())
    np.testing.assert_array_equal(todom, jodom)
    assert trows == jrows


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-300)


def _jax64(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def step64(problem):
    """One linearization, error and damped Gauss-Newton step in float64 on
    both sides; the JAX side is one jitted program (one compile)."""
    cj, ct = _cams(problem["cfg"])
    g, v = problem["graph64"], problem["values64"]
    n, m = v.pose_quat.shape[0], v.landmarks.shape[0]
    damping = dict(refine_iters=4, jitter=1e-8, diag_damping=True)

    def jax_step(graph, values, cam):
        lin = jax_linearize(graph, values, cam, *SIGMAS)
        H, grad = jdense.assemble_dense_with_landmarks(
            lin, graph.stereo.cam_idx, graph.stereo.lm_idx, n, m
        )
        delta = jdense.solve_dense_gn(H, grad, 1e-3, **damping)
        return lin, jax_graph_error(graph, values, cam, *SIGMAS), H, grad, delta

    with jax.enable_x64(True):
        ref = jax.device_get(jax.jit(jax_step)(_jax64(g), _jax64(v), cj))
    gt, vt = to_port(g, "cpu"), to_port(v, "cpu")
    lin = linearize_graph(gt, vt, ct, *SIGMAS)
    H, grad = tdense.assemble_dense_with_landmarks(lin, gt.stereo.cam_idx, gt.stereo.lm_idx, n, m)
    delta = tdense.solve_dense_gn(H, grad, 1e-3, **damping)
    return ref, (lin, graph_error(gt, vt, ct, *SIGMAS), H, grad, delta)


def test_linearization_matches_jax_f64(step64):
    (ref, err_ref, *_), (ours, err, *_) = step64
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(ours, f)
        assert a.shape == tuple(b.shape), f
        assert _rel(b.numpy(), a) < 1e-9, f
    assert np.abs(ref.imu_J_bias).max() > 0 and np.abs(ref.stereo_r).max() > 0
    assert abs(float(err) - float(err_ref)) < 1e-9 * float(err_ref)


def test_dense_gn_step_matches_jax_f64(step64):
    (_, _, H_ref, g_ref, d_ref), (_, _, H, grad, delta) = step64
    assert _rel(H.numpy(), H_ref) < 1e-9
    assert _rel(grad.numpy(), g_ref) < 1e-9
    assert _rel(delta.numpy(), d_ref) < 1e-9


def test_lm_matches_jax_f64(problem):
    """The whole LM policy (accept/reject, lambda, plateau stop) in float64:
    same iterations, same final error."""
    cj, ct = _cams(problem["cfg"])
    g, v = problem["graph64"], problem["values64"]
    solver = dataclasses.replace(problem["cfg"].solver, max_iterations=8)
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


def test_unported_solver_paths_raise(problem):
    """The default solver config, the f64 polish and the debug_nans solve
    (tests/test_torch_cli.py holds it to the unchecked solve); the banded
    reduced solver without a band width raises ValueError, as the JAX
    package's LM does (tests/test_torch_banded.py drives it)."""
    tg, tv = problem["ours"][:2]
    short = dict(max_iterations=3)
    for solver in (tconfig.SolverConfig(**short), tconfig.SolverConfig(f64_polish=True, **short),
                   tconfig.SolverConfig(debug_nans=True, **short)):
        slam = AUVSlam(tconfig.UslamConfig(solver=solver), device="cpu")
        slam._graph_cache = (to_port(tg, "cpu"), to_port(tv, "cpu"))
        result = slam.solve()
        m = result.metrics
        assert m["final_error"] < m["initial_error"]
        if solver.f64_polish:
            assert m["polish_final_error"] <= m["polish_initial_error"]
            assert result.values.pose_trans.dtype == torch.float64
    ct = tcam.StereoCamera.from_config(tconfig.CameraConfig(), device="cpu")
    for solver, error in (
        (tconfig.SolverConfig(reduced_solver="banded"), ValueError),
        (tconfig.SolverConfig(linear_solver="dense", reduced_solver="banded"), ValueError),
    ):
        with pytest.raises(error):
            run_solver(to_port(tg, "cpu"), to_port(tv, "cpu"), ct, *SIGMAS, solver)


def test_interop_round_trip(problem):
    jg, jv = jax.device_get(problem["jax_out"][:2])
    back = from_port(to_port((jg, jv)[0], "cpu"), jg)
    assert type(back) is type(jg)
    for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ported = to_port(jv, "cpu")
    assert ported.pose_quat.dtype == torch.float32
    assert type(ported).__module__ == "uslam_tpu_torch.graph.values"
