"""The default Schur solver on a graph whose landmarks are each observed
once (the 1080p slice's front end gives such tracks), against the JAX
package and the dense solve.

A landmark seen by one stereo camera is fixed by that observation alone,
so its Schur correction W Hll^-1 W^T cancels the camera's stereo block
Jp^T Jp up to the damping. In float32 the difference keeps rounding noise
of the size of that block; the port therefore eliminates and solves in
float64 whatever the linearization's type (uslam_tpu_torch/solvers/schur.py).

Tolerances, with their reasons:
- one float32 linearization: the port's Schur step against the float64
  dense step of the same linearization, 1e-6 relative (its one float32
  rounding is the returned step); the JAX package's float32 Schur step on
  the same inputs is off by more than 1e-2 at the LM's initial lambda,
  held as the reason for the float64 solve;
- float64 LM: the port's Schur LM against the JAX package's, equal
  iterations and final error to 1e-9 relative, as
  tests/test_torch_schur.py holds the default config; against the port's
  own dense LM, equal iterations and final error to 1e-6 relative (each
  step agrees to ~1e-7, and eight iterations compound it: measured
  1.3e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uslam_tpu.config import UslamConfig
from uslam_tpu.geometry import camera as jcam
from uslam_tpu.graph.packing import pack_sequence as jax_pack
from uslam_tpu.io.synthetic import SyntheticSpec, generate_synthetic_sequence
from uslam_tpu.solvers import schur as jschur
from uslam_tpu.solvers.lm import optimize_lm as jax_optimize_lm
from uslam_tpu_torch.device import cast_tree
from uslam_tpu_torch.geometry import camera as tcam
from uslam_tpu_torch.interop import config_to_port, to_port
from uslam_tpu_torch.solvers import dense, schur
from uslam_tpu_torch.solvers.linearize import linearize_graph
from uslam_tpu_torch.solvers.lm import optimize_lm

CFG = UslamConfig()
SIGMAS = (CFG.noise.dvl_sigma, CFG.noise.stereo_sigma, CFG.imu.gravity)


@pytest.fixture(scope="module")
def single_obs():
    """A 3 s synthetic dive (15 keyframes) whose track ids are made unique
    per frame, packed by the JAX package: every landmark with a stereo
    factor has exactly one."""
    seq = generate_synthetic_sequence(
        SyntheticSpec(duration=3.0, odom_drift_rate=0.05, feature_noise_px=0.3, seed=1)
    )
    for i, f in enumerate(seq.features):
        f.ids = f.ids + (i + 1) * 1_000_000
    graph, values = jax.device_get(jax_pack(seq, CFG)[:2])
    per_lm = graph.stereo.lm_obs_mask.sum(1)
    assert per_lm.max() == 1 and per_lm.sum() == graph.stereo.mask.sum() > 50
    return graph, values


def _as(tree, dtype):
    return jax.tree.map(
        lambda a: np.asarray(a, dtype) if np.issubdtype(a.dtype, np.floating) else a, tree
    )


def test_f32_schur_step_matches_f64_dense(single_obs):
    graph, values = single_obs
    n, m = values.pose_trans.shape[0], values.landmarks.shape[0]
    g32, v32 = to_port(graph, "cpu"), to_port(values, "cpu")
    cam = tcam.StereoCamera.from_config(config_to_port(CFG.camera), device="cpu")
    lin = linearize_graph(g32, v32, cam, *SIGMAS, CFG.noise.stereo_huber_delta)
    lin64 = cast_tree(lin, torch.float64, "cpu")
    H, g = dense.assemble_dense_with_landmarks(lin64, g32.stereo.cam_idx, g32.stereo.lm_idx, n, m)
    kw = dict(diag_damping=True, eliminate_velocities=True, jitter=CFG.solver.cholesky_jitter)
    jl = jax.tree.map(lambda t: jnp.asarray(t.numpy()), (lin, g32.stereo))
    for lam in (CFG.solver.lambda_initial, 1e-2):
        ref = dense.solve_dense_gn(H, g, lam, diag_damping=True).numpy()
        ours = schur.solve_schur(lin, g32.stereo, n, m, lam, **kw)
        assert ours.dtype == torch.float32
        rel = np.linalg.norm(ours.double().numpy() - ref) / np.linalg.norm(ref)
        # The JAX package's float32 Schur step on the same linearization.
        theirs = np.asarray(jschur.solve_schur(*jl, n, m, lam, **kw), np.float64)
        rel_jax = np.linalg.norm(theirs - ref) / np.linalg.norm(ref)
        print(f"lambda {lam}: step vs the float64 dense step, port {rel:.3e}, JAX {rel_jax:.3e}")
        assert rel < 1e-6, (lam, rel)
        if lam == CFG.solver.lambda_initial:
            assert rel_jax > 1e-2, rel_jax


def test_schur_lm_matches_jax_and_dense_f64(single_obs):
    graph, values = _as(single_obs[0], np.float64), _as(single_obs[1], np.float64)
    solver = dataclasses.replace(CFG.solver, max_iterations=8)
    with jax.enable_x64(True):
        cj = jcam.StereoCamera.from_config(CFG.camera, jnp.float64)
        run = jax.jit(jax_optimize_lm, static_argnums=(3, 4, 5, 6, 7))
        _, ref = jax.device_get(run(
            jax.tree.map(jnp.asarray, graph), jax.tree.map(jnp.asarray, values), cj, *SIGMAS,
            solver, CFG.noise.stereo_huber_delta,
        ))
    ct = tcam.StereoCamera.from_config(
        config_to_port(CFG.camera), device="cpu", dtype=torch.float64
    )
    stats = {}
    for name in ("schur", "dense"):
        sc = dataclasses.replace(config_to_port(solver), linear_solver=name)
        stats[name] = optimize_lm(
            to_port(graph, "cpu"), to_port(values, "cpu"), ct, *SIGMAS, sc,
            CFG.noise.stereo_huber_delta,
        )[1]
    ours, dense_stats = stats["schur"], stats["dense"]
    assert ours.final_error < 1e-3 * ours.initial_error
    assert ours.iterations == int(ref.iterations)
    assert abs(ours.final_error - float(ref.final_error)) < 1e-9 * float(ref.final_error)
    assert dense_stats.iterations == ours.iterations
    assert abs(ours.final_error - dense_stats.final_error) < 1e-6 * dense_stats.final_error
