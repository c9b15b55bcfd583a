"""Multi-device execution of the port (``uslam_tpu_torch.parallel``) on CPU
ranks over gloo, at world sizes 2 and 4, against the JAX package's
single-device functions and the port's own.

The ranks are spawned once per world size (``ranks``), each does all the
rank work of this file, and the tests compare what came back. This
module's top-level imports hold no JAX, so a spawned rank imports only
torch and the port; the JAX references are computed in the test process,
on the CPU in float64.

Tolerances, with their reasons:
- the sharded step against JAX's ``solve_schur`` + ``values_retract``:
  1e-9 relative to the step's largest entry, as tests/test_torch_schur.py
  holds the single-device step (the all-reduce adds the ranks' partial
  sums in another order);
- the sharded banded solve (``corr_lm_chunk=2``, so correction chunks
  cross shard edges): rtol 1e-9 / atol 1e-12 against JAX's and the port's
  single-device banded solve, as tests/test_parallel.py holds JAX's;
- three iterations of the full LM policy in float64, Schur and banded:
  equal iteration counts, final error rtol 1e-7, values atol 1e-7 against
  the port's single-device ``optimize_lm`` (tests/test_parallel.py's
  tolerances), and every rank's values identical bit for bit;
- the front end: masks, descriptors and stereo matches exact, keypoint
  coordinates atol 1e-3 (tests/test_parallel.py's).
"""

import dataclasses
import math
import time

import numpy as np
import pytest
import torch

from uslam_tpu_torch.collectives import all_reduce_sum
from uslam_tpu_torch.config import FrontendConfig
from uslam_tpu_torch.frontend.orb import extract_orb_batch
from uslam_tpu_torch.parallel import (
    extract_orb_frames_sharded,
    make_mesh,
    process_stereo_pairs_sharded,
    shard_landmarks,
    sharded_lm_step,
    sharded_optimize_lm,
)
from uslam_tpu_torch.parallel.launch import run_ranks
from uslam_tpu_torch.parallel.mesh import Mesh
from uslam_tpu_torch.solvers.banded import (
    measure_band_width,
    measure_corr_window,
    solve_schur_banded,
)
from uslam_tpu_torch.solvers.lm import check_finite, optimize_lm

STEP_DAMPING = 1.0
BANDED_DAMPING = 1e-2
BANDED_N, BANDED_M = 30, 16
BANDED_KW = dict(panel=8, diag_damping=True, jitter=1e-12, refine_iters=3,
                 corr_lm_chunk=2, return_aux=True)
FRONTEND = FrontendConfig(pyramid_levels=2)
LM_ITERS = 3


# ---- the rank side (no JAX) ------------------------------------------------


def _rows(mesh: Mesh, m: int) -> slice:
    return slice(mesh.rank * m // mesh.size, (mesh.rank + 1) * m // mesh.size)


def _rank_work(mesh: Mesh, inp: dict) -> dict:
    """Every sharded entry point on this rank's slice."""
    out = {}
    sig = inp["sigmas"]
    g, v = shard_landmarks(inp["step_graph"], inp["step_values"], mesh)
    out["step"] = sharded_lm_step(g, v, inp["cam"], *sig, STEP_DAMPING, mesh)

    lin, st = inp["banded"]
    rows = _rows(mesh, BANDED_M)
    st = st._replace(lm_obs_idx=st.lm_obs_idx[rows], lm_obs_mask=st.lm_obs_mask[rows])
    out["banded"] = solve_schur_banded(
        lin, st, BANDED_N, BANDED_M, BANDED_DAMPING, inp["banded_bw"],
        corr_window=inp["banded_cw"], group=mesh.group, **BANDED_KW,
    )

    g, v = shard_landmarks(inp["lm_graph"], inp["lm_values"], mesh)
    for name, cfg in inp["lm_cfgs"].items():
        out[f"lm_{name}"] = sharded_optimize_lm(g, v, inp["cam"], *sig, mesh, cfg)

    out["frames"] = extract_orb_frames_sharded(inp["imgs"], mesh, FRONTEND)
    out["pairs"] = process_stereo_pairs_sharded(inp["imgs"], inp["rights"], mesh, FRONTEND)

    # A NaN on the last rank only: every rank must raise, or the others
    # would wait in the next collective.
    last = mesh.rank == mesh.size - 1
    try:
        check_finite("probe", torch.tensor([math.nan if last else 1.0]), group=mesh.group)
    except FloatingPointError as e:
        out["probe"] = str(e)
    mask = g.stereo.lm_obs_mask.clone()
    if last:
        mask[0, 0] = math.nan
    g_nan = g._replace(stereo=g.stereo._replace(lm_obs_mask=mask))
    cfg = dataclasses.replace(inp["lm_cfgs"]["schur"], debug_nans=True)
    try:
        sharded_optimize_lm(g_nan, v, inp["cam"], *sig, mesh, cfg)
    except FloatingPointError as e:
        out["debug_nans"] = str(e)
    return out


def _mismatched(mesh: Mesh) -> int:
    if mesh.rank == 0:
        all_reduce_sum(torch.ones(1), mesh.group)  # no other rank joins
    return mesh.rank


def _one_rank_lm(mesh: Mesh, graph, values, cam, sig, cfg):
    g, v = shard_landmarks(graph, values, mesh)
    return sharded_optimize_lm(g, v, cam, *sig, mesh, cfg)


# ---- the test process: inputs and JAX references --------------------------


def _to_f64(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(
        lambda x: np.asarray(x, np.float64)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else np.asarray(x),
        tree,
    )


@pytest.fixture(scope="module")
def inputs():
    """The ranks' inputs (port containers of float64 CPU tensors) and the
    JAX package's single-device results on them."""
    import jax
    import jax.numpy as jnp

    from tests.test_banded import _windowed_linearization
    from tests.test_frontend import textured_image
    from tests.test_solver import build_graph
    from uslam_tpu.frontend.match import stereo_match as jax_stereo_match
    from uslam_tpu.frontend.orb import extract_orb_batch as jax_extract_orb_batch
    from uslam_tpu.geometry.camera import StereoCamera as JaxCamera
    from uslam_tpu.graph.values import values_retract as jax_retract
    from uslam_tpu.solvers import banded as jbanded
    from uslam_tpu.solvers.linearize import linearize_graph as jax_linearize
    from uslam_tpu.solvers.schur import solve_schur as jax_solve_schur
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.interop import config_to_port, to_port

    slam, graph, initial, _ = build_graph(duration=3.0)
    cfg = slam.config
    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    g64, v64 = _to_f64(graph), _to_f64(initial)
    n, m = v64.pose_trans.shape[0], v64.landmarks.shape[0]
    rng = np.random.default_rng(7)
    blin, bst = jax.device_get(_windowed_linearization(rng, BANDED_N, BANDED_M, 4, 5))
    blin, bst = _to_f64(blin), _to_f64(bst)
    bw = int(jbanded.measure_band_width(bst))
    cw = int(jbanded.measure_corr_window(bst, lm_chunk=2))
    with jax.enable_x64(True):
        jcam = JaxCamera.from_config(cfg.camera, jnp.float64)

        @jax.jit
        def step(g, v):
            lin = jax_linearize(g, v, jcam, *sig)
            return jax_retract(v, jax_solve_schur(
                lin, g.stereo, n, m, STEP_DAMPING, diag_damping=True,
                eliminate_velocities=True))

        step_ref = jax.device_get(step(g64, v64))
        banded_ref = jax.device_get(jax.jit(lambda lin, st: jbanded.solve_schur_banded(
            lin, st, BANDED_N, BANDED_M, BANDED_DAMPING, band_w=bw, corr_window=cw,
            **BANDED_KW))(blin, bst))

    _, lgraph, linit, _ = build_graph(duration=3.0, drift=0.05, feature_noise=0.3, seed=2)
    lm_graph, lm_values = to_port(_to_f64(lgraph), "cpu"), to_port(_to_f64(linit), "cpu")
    schur_cfg = dataclasses.replace(config_to_port(cfg.solver), max_iterations=LM_ITERS)
    banded_cfg = dataclasses.replace(
        schur_cfg, reduced_solver="banded", band_width=measure_band_width(lm_graph.stereo),
        banded_corr_window=measure_corr_window(lm_graph.stereo),
    )

    imgs = np.stack([textured_image(96, 128, seed=s) for s in range(8)])
    rights = np.roll(imgs, -4, axis=2)
    jfront = dataclasses.replace(cfg.frontend, pyramid_levels=FRONTEND.pyramid_levels)
    # ORB is per image, so one batch of the 8 lefts and 8 rights serves
    # both the frames and the pairs.
    kp = jax.device_get(jax_extract_orb_batch(jnp.asarray(np.concatenate([imgs, rights])), jfront))
    frames_ref = type(kp)(*(a[:8] for a in kp))
    rkp = type(kp)(*(a[8:] for a in kp))
    match = jax.jit(jax.vmap(lambda dl, xl, ml, dr, xr, mr: jax_stereo_match(
        dl, xl, ml, dr, xr, mr,
        max_distance=jfront.match_max_distance, ratio=jfront.match_ratio,
        max_v_diff=jfront.stereo_max_v_diff, min_disparity=jfront.stereo_min_disparity,
        use_pallas=False,
    )))
    sm = jax.device_get(match(frames_ref.desc, frames_ref.xy, frames_ref.mask,
                              rkp.desc, rkp.xy, rkp.mask))
    pairs_ref = list(zip(sm.idx, sm.mask))

    rank_inputs = dict(
        sigmas=sig,
        cam=StereoCamera.from_config(config_to_port(cfg.camera), device="cpu",
                                     dtype=torch.float64),
        step_graph=to_port(g64, "cpu"), step_values=to_port(v64, "cpu"),
        banded=(to_port(blin, "cpu"), to_port(bst, "cpu")), banded_bw=bw, banded_cw=cw,
        lm_graph=lm_graph, lm_values=lm_values,
        lm_cfgs={"schur": schur_cfg, "banded": banded_cfg},
        imgs=torch.from_numpy(imgs), rights=torch.from_numpy(rights),
    )
    refs = dict(step=step_ref, step_initial=v64, banded=banded_ref,
                frames=frames_ref, pairs=pairs_ref)
    return rank_inputs, refs


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-device results on the same inputs."""
    inp, _ = inputs
    lin, st = inp["banded"]
    banded = solve_schur_banded(
        lin, st, BANDED_N, BANDED_M, BANDED_DAMPING, inp["banded_bw"],
        corr_window=inp["banded_cw"], **BANDED_KW,
    )
    lm = {
        name: optimize_lm(inp["lm_graph"], inp["lm_values"], inp["cam"], *inp["sigmas"], cfg)
        for name, cfg in inp["lm_cfgs"].items()
    }
    return dict(banded=banded, lm=lm, frames=extract_orb_batch(inp["imgs"], FRONTEND))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, inputs):
    """Each rank's results, spawned once per world size."""
    return run_ranks(_rank_work, request.param, inputs[0], device="cpu", timeout_s=240)


# ---- the tests --------------------------------------------------------------


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _step_rel(out, ref, initial) -> float:
    """Largest difference of two retracted steps over the step's largest entry."""
    worst, scale = 0.0, 0.0
    for f in ("pose_quat", "pose_trans", "vel", "bias", "landmarks"):
        d_ref = np.asarray(getattr(ref, f)) - np.asarray(getattr(initial, f))
        worst = max(worst, np.abs(_np(getattr(out, f)) - np.asarray(getattr(ref, f))).max())
        scale = max(scale, np.abs(d_ref).max())
    return worst / scale


def test_sharded_step_matches_jax(inputs, ranks):
    _, refs = inputs
    for out in ranks:
        assert _step_rel(out["step"], refs["step"], refs["step_initial"]) < 1e-9


def test_sharded_banded_solve_matches_jax_and_port(inputs, single, ranks):
    _, refs = inputs
    for out in ranks:
        delta, g_dot = out["banded"]
        for ref_delta, ref_g_dot in (refs["banded"], single["banded"]):
            np.testing.assert_allclose(_np(delta), _np(ref_delta), rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(float(g_dot), float(ref_g_dot), rtol=1e-9)


@pytest.mark.parametrize("solver", ["schur", "banded"])
def test_sharded_lm_matches_single_device(single, ranks, solver):
    ref_vals, ref_stats = single["lm"][solver]
    first_vals, _ = ranks[0][f"lm_{solver}"]
    for out in ranks:
        vals, stats = out[f"lm_{solver}"]
        assert stats.iterations == ref_stats.iterations == LM_ITERS
        np.testing.assert_allclose(stats.final_error, ref_stats.final_error, rtol=1e-7)
        for a, b, c in zip(vals, ref_vals, first_vals):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-7)
            assert torch.equal(a, c)  # every rank holds the same bits
    assert ref_stats.final_error < ref_stats.initial_error


def test_frames_sharded_match_batch_and_jax(inputs, single, ranks):
    _, refs = inputs
    ref, jref = single["frames"], refs["frames"]
    m = ref.mask.numpy()
    assert m.any()
    np.testing.assert_array_equal(m, jref.mask)
    for out in ranks:
        kp = out["frames"]
        np.testing.assert_array_equal(kp.mask.numpy(), m)
        np.testing.assert_allclose(kp.xy.numpy()[m], ref.xy.numpy()[m], atol=1e-3)
        np.testing.assert_allclose(kp.xy.numpy()[m], jref.xy[m], atol=1e-3)
        np.testing.assert_array_equal(kp.desc.numpy()[m], ref.desc.numpy()[m])
    # Against JAX: descriptors equal wherever the orientation is; where the
    # float32 moment sums round the angle differently (by ~1e-6 rad) a
    # steered sample can land on the next pixel and flip a bit.
    same_angle = ref.angle.numpy() == jref.angle
    np.testing.assert_allclose(ref.angle.numpy()[m], jref.angle[m], atol=1e-3)
    desc = ref.desc.numpy().view(np.uint32)
    np.testing.assert_array_equal(desc[m & same_angle], jref.desc[m & same_angle])
    flipped = np.unpackbits((desc ^ jref.desc).view(np.uint8), axis=-1).sum(-1)[m]
    assert flipped.max() <= 2 and (flipped > 0).mean() < 0.01, flipped[flipped > 0]


def test_stereo_pairs_sharded_match_jax(inputs, ranks):
    _, refs = inputs
    for out in ranks:
        kp_l, kp_r, idx, mask = (x for x in out["pairs"])
        assert kp_l.xy.shape[0] == kp_r.xy.shape[0] == len(refs["pairs"])
        assert mask.any()
        for b, (ref_idx, ref_mask) in enumerate(refs["pairs"]):
            np.testing.assert_array_equal(mask[b].numpy(), ref_mask)
            np.testing.assert_array_equal(idx[b].numpy()[ref_mask], ref_idx[ref_mask])


def test_non_finite_on_one_rank_raises_on_every_rank(ranks):
    for out in ranks:
        assert out.get("probe") == "debug_nans: non-finite value after the probe stage"
        assert "landmark Schur" in out.get("debug_nans", "")


def test_one_rank_in_process_is_bit_identical(inputs, single):
    """World size 1 runs in this process (gloo, no spawn); every collective
    is then an identity, so the solve must repeat the single-device one
    bit for bit (chip_smoke.py checks the same over NCCL on the card)."""
    inp, _ = inputs
    (vals, stats), = run_ranks(
        _one_rank_lm, 1, inp["lm_graph"], inp["lm_values"], inp["cam"], inp["sigmas"],
        inp["lm_cfgs"]["schur"], device="cpu",
    )
    ref_vals, ref_stats = single["lm"]["schur"]
    assert stats == ref_stats
    assert all(torch.equal(a, b) for a, b in zip(vals, ref_vals))


def test_mismatched_ranks_raise_instead_of_hanging():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2"):
        run_ranks(_mismatched, 2, device="cpu", timeout_s=60)
    assert time.monotonic() - t0 < 60


def test_shape_and_solver_errors(inputs):
    inp, _ = inputs
    three = Mesh(None, 0, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide the mesh size 3"):
        shard_landmarks(inp["lm_graph"], inp["lm_values"], three)
    with pytest.raises(ValueError, match="frame batch 8 must divide the mesh size 3"):
        extract_orb_frames_sharded(inp["imgs"], three, FRONTEND)
    with pytest.raises(ValueError, match="frame batch 8 must divide the mesh size 3"):
        process_stereo_pairs_sharded(inp["imgs"], inp["rights"], three, FRONTEND)
    dense = dataclasses.replace(inp["lm_cfgs"]["schur"], linear_solver="dense")
    with pytest.raises(ValueError, match="requires the schur linear solver"):
        optimize_lm(inp["lm_graph"], inp["lm_values"], inp["cam"], *inp["sigmas"], dense,
                    group=object())
    with pytest.raises(ValueError, match="'cholesky' or 'banded'"):
        sharded_lm_step(inp["lm_graph"], inp["lm_values"], inp["cam"], *inp["sigmas"], 1.0,
                        three, reduced_solver="cg")
    # A whole graph on a rank of two is refused, not solved as a slice.
    two = Mesh(None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="pass shard_landmarks' output"):
        sharded_optimize_lm(inp["lm_graph"], inp["lm_values"], inp["cam"], *inp["sigmas"],
                            two, inp["lm_cfgs"]["schur"])


def test_cuda_mesh_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the NCCL mesh")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(0, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks(_mismatched, 1, device="cuda")

