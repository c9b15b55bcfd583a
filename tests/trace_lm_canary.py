"""Where the port's float32 LM and the JAX package's part on
tests/test_oracle_parity.py:71's spec (ROADMAP C9), iteration by
iteration, on the CPU:

    JAX_PLATFORMS=cpu python tests/trace_lm_canary.py

Four runs of the same LM policy on the same graph, each printing per
iteration the error, the candidate's error, lambda, accept or reject, the
plateau counter, the step's norm and its pose, velocity, bias and landmark
parts, and the ATE against ground truth:

- ``jax``: the JAX package's ``optimize_lm`` step (uslam_tpu/solvers/lm.py
  :164-218) replayed eagerly over its own jitted pieces (float32 Schur);
- ``jax+f64 schur``: the same with the Schur solve in float64 (the
  linearization cast up, the step cast back), as the port solves it;
- ``port``: the port's ``lm_step`` (float64 Schur, its design);
- ``port+f32 schur``: the port's step with its float64 cast taken out.

Then the float32 error's rounding at the port's end point, against the
float64 error of the same values, in each package.
"""

import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from uslam_tpu.config import UslamConfig as JaxUslamConfig  # noqa: E402
from uslam_tpu.geometry.camera import StereoCamera as JaxStereoCamera  # noqa: E402
from uslam_tpu.graph.packing import pack_sequence as jax_pack  # noqa: E402
from uslam_tpu.graph.values import values_retract as jax_retract  # noqa: E402
from uslam_tpu.io.synthetic import SyntheticSpec as JaxSpec  # noqa: E402
from uslam_tpu.io.synthetic import generate_synthetic_sequence as jax_generate  # noqa: E402
from uslam_tpu.solvers.linearize import graph_error as jax_error  # noqa: E402
from uslam_tpu.solvers.linearize import linearize_graph as jax_linearize  # noqa: E402
from uslam_tpu.solvers.schur import solve_schur as jax_schur  # noqa: E402
from uslam_tpu_torch.config import UslamConfig  # noqa: E402
from uslam_tpu_torch.device import cast_tree  # noqa: E402
from uslam_tpu_torch.eval.metrics import ate_rmse  # noqa: E402
from uslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from uslam_tpu_torch.graph.packing import pack_sequence  # noqa: E402
from uslam_tpu_torch.graph.values import values_retract  # noqa: E402
from uslam_tpu_torch.interop import from_port, to_port  # noqa: E402
from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence  # noqa: E402
from uslam_tpu_torch.solvers import lm as port_lm  # noqa: E402
from uslam_tpu_torch.solvers import schur as port_schur  # noqa: E402
from uslam_tpu_torch.solvers.linearize import graph_error  # noqa: E402

SPEC = dict(duration=20.0, keyframe_rate=5.0, num_landmarks=128, odom_drift_rate=0.05,
            feature_noise_px=0.3, seed=3)


def step_parts(delta, n: int) -> dict:
    d = np.asarray(delta, np.float64)
    frames = d[:9 * n].reshape(n, 9)
    return {"|step|": np.linalg.norm(d), "pose": np.linalg.norm(frames[:, :6]),
            "vel": np.linalg.norm(frames[:, 6:]), "bias": np.linalg.norm(d[9 * n:9 * n + 6]),
            "landmarks": np.linalg.norm(d[9 * n + 6:])}


def policy(sc, error, new_error, lam, stall):
    """The JAX step's decisions (lm.py:171-217) in float32 numpy."""
    f = np.float32
    new_error = new_error if np.isfinite(new_error) else f(np.inf)
    accept = bool(new_error < error)
    decrease = abs(error - new_error)
    converged = accept and (new_error <= sc.error_tol or decrease <= f(sc.absolute_error_tol)
                            or decrease <= f(sc.relative_error_tol) * error)
    lam = (max(lam / f(sc.lambda_factor), f(sc.lambda_lower_bound)) if accept
           else lam * f(sc.lambda_factor))
    converged = converged or lam > sc.lambda_upper_bound
    band = max(f(sc.plateau_rtol) * error, f(10.0 * sc.absolute_error_tol))
    fast = accept and (error - new_error) > band
    stall = 0 if fast else (stall + 1 if decrease <= band else stall)
    converged = converged or (sc.plateau_patience > 0 and stall >= sc.plateau_patience)
    return accept, lam, stall, converged


def run_jax(f64_schur: bool, gt):
    seq = jax_generate(JaxSpec(**SPEC))
    cfg = JaxUslamConfig()
    sc = cfg.solver
    kw = dict(cam=JaxStereoCamera.from_config(cfg.camera), dvl_sigma=cfg.noise.dvl_sigma,
              stereo_sigma=cfg.noise.stereo_sigma, gravity=cfg.imu.gravity)
    graph, values, _, _ = jax_pack(seq, cfg, dtype=jnp.float32)
    n, m = values.num_poses, values.num_landmarks
    err = jax.jit(lambda v: jax_error(graph, values=v, **kw))
    lin_fn = jax.jit(lambda v: jax_linearize(graph, values=v, **kw))
    schur_kw = dict(cg=False, cg_iters=sc.cg_max_iterations, cg_tol=sc.cg_tol,
                    refine_iters=sc.refine_iters, jitter=sc.cholesky_jitter, diag_damping=True,
                    eliminate_velocities=sc.eliminate_velocities)
    solve = jax.jit(lambda lin, lam: jax_schur(lin, graph.stereo, n, m, lam, **schur_kw))
    retract = jax.jit(jax_retract)

    def up(tree):
        return jax.tree.map(lambda a: jnp.asarray(
            np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else np.asarray(a)),
            tree)

    rows = []
    with jax.default_matmul_precision("highest"):
        lin = lin_fn(values)
        error, lam, stall = np.float32(err(values)), np.float32(sc.lambda_initial), 0
        for _ in range(sc.max_iterations):
            if f64_schur:
                with jax.enable_x64():
                    delta = np.asarray(jax_schur(up(lin), up(graph.stereo), n, m,
                                                 jnp.float64(lam), **schur_kw), np.float32)
            else:
                delta = solve(lin, jnp.float32(lam))
            candidate = retract(values, jnp.asarray(delta))
            new_error = np.float32(err(candidate))
            accept, lam_next, stall, converged = policy(sc, error, new_error, lam, stall)
            rows.append(dict(error=error, candidate=new_error, lam=lam, accept=accept, stall=stall,
                             **step_parts(delta, n)))
            if accept:
                values, error = candidate, new_error
                lin = lin_fn(values)
            rows[-1]["ate"] = ate_rmse(np.asarray(values.pose_trans, np.float64), gt)
            lam = lam_next
            if converged:
                break
    return rows


def run_port(f32_schur: bool, graph, initial, cam, cfg, gt):
    if f32_schur:
        src = inspect.getsource(port_schur.solve_schur).replace(
            "if out_dtype != torch.float64:", "if False:")
        namespace = dict(vars(port_schur))
        exec(compile(src, port_schur.__file__, "exec"), namespace)
        solve_schur = namespace["solve_schur"]
    else:
        solve_schur = port_schur.solve_schur
    real, port_lm.solve_schur = port_lm.solve_schur, solve_schur
    try:
        sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
        p = port_lm._problem(graph, cam, *sig, cfg.solver, None, None, initial.num_poses,
                             initial.num_landmarks, None)
        steps = []
        solve = p.solve
        p = p._replace(solve=lambda lin, lam: steps.append(solve(lin, lam)) or steps[-1])
        state = port_lm._start(p, initial, cfg.solver)
        rows = []
        while bool(port_lm._active(state, cfg.solver).flag()):
            prev = state
            state = port_lm.lm_step(state, p, cfg.solver)
            candidate = values_retract(prev.values, steps[-1])
            rows.append(dict(error=float(prev.error), candidate=float(p.error(candidate)),
                             lam=float(prev.lam), accept=bool(state.error < prev.error),
                             stall=int(state.stall), **step_parts(steps[-1].numpy(),
                                                                  initial.num_poses),
                             ate=ate_rmse(state.values.pose_trans.double().numpy(), gt)))
        return rows, state.values
    finally:
        port_lm.solve_schur = real


def main() -> None:
    seq = generate_synthetic_sequence(SyntheticSpec(**SPEC))
    cfg = UslamConfig()
    g_np, v_np, _, _ = pack_sequence(seq, cfg)
    graph, initial = to_port(g_np, "cpu"), to_port(v_np, "cpu")
    cam = StereoCamera.from_config(cfg.camera, device="cpu")
    gt = np.asarray(seq.gt_pos[:initial.num_poses], np.float64)
    runs = {"jax": run_jax(False, gt), "jax+f64 schur": run_jax(True, gt)}
    runs["port"], port_values = run_port(False, graph, initial, cam, cfg, gt)
    runs["port+f32 schur"], _ = run_port(True, graph, initial, cam, cfg, gt)
    for name, rows in runs.items():
        print(f"== {name}: {len(rows)} iterations, final ATE {rows[-1]['ate']!r} m")
        for k, r in enumerate(rows, 1):
            print(f"  {k:3d} " + " ".join(
                f"{key}={v}" if isinstance(v, bool) or isinstance(v, int)
                else f"{key}={float(v):.7g}" for key, v in r.items()))

    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    f64 = torch.float64
    e64 = float(graph_error(cast_tree(graph, f64, "cpu"), cast_tree(port_values, f64, "cpu"),
                            cast_tree(cam, f64, "cpu"), *sig))
    e_port = float(graph_error(graph, port_values, cam, *sig))
    jcfg = JaxUslamConfig()
    jgraph, jinit, _, _ = jax_pack(jax_generate(JaxSpec(**SPEC)), jcfg, dtype=jnp.float32)
    e_jax = float(jax_error(jgraph, values=from_port(port_values, jinit),
                            cam=JaxStereoCamera.from_config(jcfg.camera),
                            dvl_sigma=sig[0], stereo_sigma=sig[1], gravity=sig[2]))
    print(f"float32 error at the port's end point: float64 {e64!r}, port {e_port!r} "
          f"({(e_port - e64) / e64:+.3e}), JAX {e_jax!r} ({(e_jax - e64) / e64:+.3e}); "
          f"plateau band {cfg.solver.plateau_rtol * e_port!r}")


if __name__ == "__main__":
    main()
