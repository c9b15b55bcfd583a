"""The port's public surface held to the JAX package's, and the names that
completes it held to the JAX functions of the same name.

Surface (read from the sources with ``ast``; no module is imported): every
``uslam_tpu/**/*.py`` has a counterpart of the same path in
``uslam_tpu_torch/``, each public top-level function or class of it is
defined in or imported by that counterpart, each public method of a
public class is defined on the port's class, and each parameter of a
function or method is one of the port's. The nine subpackages give every
name the JAX package's ``__init__`` exports. The exceptions are the ones
named, with their reasons, in ``NOT_PORTED`` and ``DROPPED_PARAMETERS``
below, and nothing else: an entry that the port has come to cover fails
the test too. So this file is the list of what the JAX package has and the
port does not (ROADMAP "Compared by file").

Numerics, on the CPU, inputs made with numpy from a seed and run through
the JAX function (JAX on the CPU) and the port's:
- geometry, values and residual helpers: exact where the formula is
  elementwise (JAX run op by op); ``matrix_to_quat`` 1e-6 (float32);
- ``preintegrate_with_cov`` in float32 on 3 intervals with padded samples:
  the deltas to tests/test_torch_preintegrate.py's float32 tolerance (1e-5
  of the largest entry), the covariance to 1e-5 of its largest entry; in
  float64 ``whitener_from_cov(P, jitter=1e-10)`` equals the main path's
  numpy whiteners (``graph.builder.compute_imu_whiteners``) to 1e-10;
- ``Linearization.error()`` against the JAX package's on the same
  linearization (a JAX-packed graph carried over by ``interop``) to 1e-6,
  and against the port's ``graph_error``;
- ``extract_orb`` equal bit for bit to ``extract_orb_batch`` of one image,
  and to JAX's ``extract_orb`` as tests/test_torch_frontend.py holds the
  batch (masks, positions, levels exact; Harris scores 1e-5 relative,
  angles 1e-3 rad), descriptors as ROADMAP C5 holds them;
- ``hamming_distance_matrix`` exact;
- ``native``: the time join and id interning equal to the JAX package's
  native functions and to the port's numpy paths, the packed IMU intervals
  equal to the JAX package's, the whiteners to 1e-12 of both (as
  tests/test_native.py holds the JAX package's native whiteners).
Marked ``cuda`` (skipped without a GPU): ``extract_orb`` and
``hamming_distance_matrix`` on the card, one launch per pyramid level and
one launch.
"""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "uslam_tpu", ROOT / "uslam_tpu_torch"
SUBPACKAGES = ("geometry", "frontend", "factors", "graph", "solvers", "eval", "io", "utils",
               "parallel")

# What the JAX package has and the port does not, each with its reason.
NOT_PORTED = {
    "frontend/pallas_kernels.py": "the two Pallas kernels are ported as csrc/fast_harris.cu and "
    "csrc/hamming.cu, wrapped by frontend/kernels.py; resolve_pallas, interpret mode and the "
    "custom_vmap rule are TPU machinery with nothing to do on the card",
    "solvers/tridiag.py": "measured and rejected in the JAX package, imported by none of its "
    "modules (ROADMAP A, 'Not to port')",
    "graph/packing.py::PackedPytree": "a TPU upload layout (one buffer per dtype); the port "
    "moves its containers leaf by leaf (interop.to_port)",
}
_PALLAS = "the Pallas switch: the port dispatches on the tensor's device (frontend/kernels.py)"
_UNROLL = "a lax.scan unroll factor; the port's sweeps are host loops over torch ops"
_AXIS_NAME = "a shard_map axis: the port takes a torch.distributed process group (group=)"
_AXIS = "a jax.sharding mesh axis: the port's mesh is one torch.distributed rank per device"
# (JAX module::function or Class.method) -> (parameters the port drops, why).
DROPPED_PARAMETERS = {
    "frontend/tracker.py::ransac_translation": (
        {"num_hypotheses", "seed"},
        "the port takes the hypothesis indices (hyp_idx): jax.random's draws cannot be made "
        "in torch"),
    "graph/packing.py::pack_sequence": (
        {"dtype"}, "the port packs numpy and casts on the upload to a device"),
    "graph/builder.py::GraphBuilder.finalize": (
        {"as_numpy"}, "the port finalizes onto a device (device=)"),
    "solvers/dense.py::assemble_dense": (
        {"pose_major"}, "the port's Schur path does not assemble the dense system"),
    "frontend/match.py::hamming_distance_matrix": ({"use_pallas"}, _PALLAS),
    "frontend/match.py::match_descriptors": ({"use_pallas"}, _PALLAS),
    "frontend/match.py::stereo_match": ({"use_pallas"}, _PALLAS),
    "solvers/banded.py::block_tridiag_factor": ({"unroll"}, _UNROLL),
    "solvers/banded.py::block_tridiag_factor_apply": ({"unroll"}, _UNROLL),
    "solvers/banded.py::block_tridiag_apply": ({"unroll"}, _UNROLL),
    "solvers/banded.py::solve_schur_banded": ({"axis_name", "unroll"}, _AXIS_NAME + "; " + _UNROLL),
    "solvers/schur.py::solve_schur": ({"axis_name"}, _AXIS_NAME),
    "solvers/lm.py::optimize_lm": ({"axis_name"}, _AXIS_NAME),
    "parallel/mesh.py::make_mesh": (
        {"n_devices", "axis"}, _AXIS + " (world_size=, rank=)"),
    "parallel/mesh.py::shard_landmarks": ({"axis"}, _AXIS),
    "parallel/mesh.py::sharded_optimize_lm": ({"axis"}, _AXIS),
    "parallel/mesh.py::sharded_lm_step": ({"axis"}, _AXIS),
    "parallel/frames.py::extract_orb_frames_sharded": ({"axis"}, _AXIS),
    "parallel/frames.py::process_stereo_pairs_sharded": ({"axis"}, _AXIS),
}


# ---- the surface, from the sources ------------------------------------------


def _params(fn: ast.FunctionDef) -> set:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return set(names + [x.arg for x in (a.vararg, a.kwarg) if x is not None])


def _module(path: Path) -> dict:
    """Top-level defs (name -> node), imported names (name -> source module)
    and the methods of each class (name -> {method -> node})."""
    tree = ast.parse(path.read_text())
    defs, imports, methods = {}, {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            defs[node.name] = node
        if isinstance(node, ast.ClassDef):
            methods[node.name] = {b.name: b for b in node.body if isinstance(b, ast.FunctionDef)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(t, ast.Name):
                    defs[t.id] = node
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                imports[alias.asname or alias.name] = (node.module, alias.name)
    return {"defs": defs, "imports": imports, "methods": methods}


def _port_class_methods(rel: str, name: str):
    """The methods of the port's class ``name`` as seen from module ``rel``,
    following a ``from uslam_tpu_torch... import`` to where it is defined."""
    mod = _module(PORT_PKG / rel)
    if name in mod["methods"]:
        return mod["methods"][name]
    source, real = mod["imports"].get(name, (None, None))
    if source and source.startswith("uslam_tpu_torch."):
        target = Path(*source.split(".")[1:])
        path = target / "__init__.py" if (PORT_PKG / target).is_dir() else target.with_suffix(".py")
        return _port_class_methods(str(path), real)
    return None


def surface_gaps() -> list:
    """What the JAX package has and the port lacks, allow-listed or not."""
    gaps = []
    for jpath in sorted(JAX_PKG.rglob("*.py")):
        rel = str(jpath.relative_to(JAX_PKG))
        if not (PORT_PKG / rel).exists():
            gaps.append(rel)
            continue
        jmod, pmod = _module(jpath), _module(PORT_PKG / rel)
        for name, node in jmod["defs"].items():
            if name.startswith("_") or not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                continue
            if name not in pmod["defs"] and name not in pmod["imports"]:
                gaps.append(f"{rel}::{name}")
                continue
            pnode = pmod["defs"].get(name)
            if isinstance(node, ast.FunctionDef) and isinstance(pnode, ast.FunctionDef):
                for p in sorted(_params(node) - _params(pnode)):
                    gaps.append(f"{rel}::{name}({p})")
            pmethods = _port_class_methods(rel, name) if name in jmod["methods"] else {}
            for m, mnode in jmod["methods"].get(name, {}).items():
                if m.startswith("_"):
                    continue
                if pmethods is None or m not in pmethods:
                    gaps.append(f"{rel}::{name}.{m}")
                    continue
                for p in sorted(_params(mnode) - _params(pmethods[m])):
                    gaps.append(f"{rel}::{name}.{m}({p})")
    return gaps


def _allowed() -> set:
    out = set(NOT_PORTED)
    for key, (params, _) in DROPPED_PARAMETERS.items():
        out |= {f"{key}({p})" for p in params}
    return out


def test_port_covers_the_jax_package_surface():
    """Each public function, class, method and parameter of the JAX package
    has its counterpart in the port, but for the allow-list; and each
    allow-list entry is still a gap (the list holds nothing stale)."""
    gaps = set(surface_gaps())
    assert sorted(gaps - _allowed()) == []
    assert sorted(_allowed() - gaps) == []
    assert all(reason for reason in NOT_PORTED.values())
    assert all(reason for _, reason in DROPPED_PARAMETERS.values())


def _jax_exports(pkg: str) -> list:
    """Names the JAX subpackage's __init__ imports (and so exports)."""
    tree = ast.parse((JAX_PKG / pkg / "__init__.py").read_text())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("pkg", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(pkg):
    port = importlib.import_module(f"uslam_tpu_torch.{pkg}")
    names = _jax_exports(pkg)
    assert names
    for name in names:
        assert getattr(port, name).__name__ == name


def test_lazy_subpackages_import_no_torch():
    """The six subpackages that export lazily import no torch module until
    a name is taken."""
    lazy = ("geometry", "frontend", "factors", "graph", "solvers", "eval")
    code = ("import sys\n"
            + "".join(f"import uslam_tpu_torch.{p}\n" for p in lazy)
            + "assert 'torch' not in sys.modules, 'torch'\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=60)
    assert out.stdout.strip() == "ok", out.stderr


# ---- numerics against the JAX package ---------------------------------------

from uslam_tpu import native as jnative  # noqa: E402
from uslam_tpu.config import FrontendConfig, UslamConfig  # noqa: E402
from uslam_tpu.factors import depth as jdepth  # noqa: E402
from uslam_tpu.factors import imu as jimu  # noqa: E402
from uslam_tpu.factors import priors as jpriors  # noqa: E402
from uslam_tpu.frontend import match as jmatch  # noqa: E402
from uslam_tpu.frontend import orb as jorb  # noqa: E402
from uslam_tpu.geometry import camera as jcam  # noqa: E402
from uslam_tpu.geometry import se3 as jse3  # noqa: E402
from uslam_tpu.geometry import so3 as jso3  # noqa: E402
from uslam_tpu.graph import values as jvalues  # noqa: E402
from uslam_tpu.graph.packing import pack_sequence as jax_pack  # noqa: E402
from uslam_tpu.io.synthetic import SyntheticSpec, generate_synthetic_sequence  # noqa: E402
from uslam_tpu.solvers.linearize import Linearization as JaxLinearization  # noqa: E402
from tests.test_frontend import textured_image  # noqa: E402
from uslam_tpu_torch import factors, frontend, geometry, graph, native  # noqa: E402
from uslam_tpu_torch.factors import imu as timu  # noqa: E402
from uslam_tpu_torch.factors.imu import ImuIntervalData  # noqa: E402
from uslam_tpu_torch.frontend import kernels  # noqa: E402
from uslam_tpu_torch.frontend.orb import extract_orb_batch  # noqa: E402
from uslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from uslam_tpu_torch.geometry.se3 import Pose3  # noqa: E402
from uslam_tpu_torch.geometry.so3 import so3_hat  # noqa: E402
from uslam_tpu_torch.graph import values as tvalues  # noqa: E402
from uslam_tpu_torch.graph.builder import compute_imu_whiteners  # noqa: E402
from uslam_tpu_torch.interop import config_to_port, from_port, to_port  # noqa: E402
from uslam_tpu_torch.io.timesync import approximate_time_join  # noqa: E402
from uslam_tpu_torch.solvers.linearize import graph_error, linearize_graph  # noqa: E402

RNG = np.random.default_rng(10)
PREINT_RTOL = 1e-5   # tests/test_torch_preintegrate.py, float32
CONVERSION_TOL = 1e-6


def _quats(n):
    q = RNG.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q


def _np(x):
    return np.asarray(jax.device_get(x))


def test_geometry_helpers_match_jax():
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        assert torch.equal(geometry.quat_identity(dtype, device="cpu"),
                           torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype))
        pose = geometry.pose_identity(dtype, device="cpu")
        assert pose.quat.dtype == pose.trans.dtype == dtype
        np.testing.assert_array_equal(pose.trans.numpy(), np.zeros(3))
    np.testing.assert_array_equal(geometry.quat_identity(device="cpu").numpy(),
                                  _np(jso3.quat_identity()))
    np.testing.assert_array_equal(geometry.pose_identity(device="cpu").quat.numpy(),
                                  _np(jse3.pose_identity().quat))

    q = _quats(64)
    q[0], q[1] = [1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]   # each pivot's branch
    R = geometry.quat_to_matrix(torch.from_numpy(q))
    np.testing.assert_array_equal(R.numpy(), _np(jso3.quat_to_matrix(jnp.asarray(q))))
    back = geometry.matrix_to_quat(R)
    np.testing.assert_allclose(back.numpy(), _np(jso3.matrix_to_quat(jnp.asarray(R.numpy()))),
                               rtol=CONVERSION_TOL, atol=CONVERSION_TOL)
    np.testing.assert_allclose(back.numpy(), np.where(q[:, :1] < 0, -q, q), atol=CONVERSION_TOL)

    w = RNG.normal(size=(7, 3)).astype(np.float32)
    H = so3_hat(torch.from_numpy(w))
    np.testing.assert_array_equal(geometry.so3_vee(H).numpy(),
                                  _np(jso3.so3_vee(jnp.asarray(H.numpy()))))
    np.testing.assert_array_equal(geometry.so3_vee(H).numpy(), w)

    u0, v0, u1, v1 = RNG.uniform(-1, 1, (4, 9)).astype(np.float32)
    ours = geometry.normalized_to_pixels(*map(torch.from_numpy, (u0, v0, u1, v1)), 1920.0, 1080.0)
    ref = jcam.normalized_to_pixels(*map(jnp.asarray, (u0, v0, u1, v1)), 1920.0, 1080.0)
    np.testing.assert_array_equal(ours.numpy(), _np(ref))


def test_values_helpers_and_residuals_match_jax():
    for n, m in ((1, 0), (5, 3), (100, 250)):
        assert graph.tangent_dim(n, m) == jvalues.tangent_dim(n, m)
        assert tvalues.bias_offset(n) == jvalues.bias_offset(n)
        assert tvalues.landmark_offset(n, m) == jvalues.landmark_offset(n, m)
        assert tvalues.frame_offset(n) == jvalues.frame_offset(n)
    q, t = torch.from_numpy(_quats(4)), torch.from_numpy(RNG.normal(size=(4, 3)))
    values = graph.Values(q, t, torch.zeros(4, 3), torch.zeros(6), torch.zeros(2, 3))
    assert values.poses().quat is q and values.poses().trans is t

    bias, prior = RNG.normal(size=(2, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        factors.prior_bias_residual(torch.from_numpy(bias), torch.from_numpy(prior), 0.1).numpy(),
        _np(jpriors.prior_bias_residual(jnp.asarray(bias), jnp.asarray(prior), 0.1)))
    trans = RNG.normal(size=(3, 3)).astype(np.float32)
    for t_np, d in ((trans[0], 1.5), (trans, np.float32([1.0, -2.0, 0.5]))):
        ours = factors.depth_residual(Pose3(None, torch.from_numpy(t_np)), torch.as_tensor(d), 0.3)
        ref = jdepth.depth_residual(jse3.Pose3(None, jnp.asarray(t_np)), jnp.asarray(d), 0.3)
        assert ours.shape == ref.shape
        np.testing.assert_array_equal(ours.numpy(), _np(ref))


def _imu_samples(n, S, seed):
    """(acc, gyro, dt) float64: every interval ends in padding, interval 1
    without rotation."""
    rng = np.random.default_rng(seed)
    acc = rng.normal(size=(n, S, 3)) + np.array([0.0, 0.0, 9.81])
    gyro = rng.normal(scale=0.4, size=(n, S, 3))
    gyro[1] = 0.0
    counts = rng.integers(S // 2, S, size=n)
    dt = np.where(np.arange(S)[None, :] < counts[:, None], 0.005, 0.0)
    acc[dt == 0], gyro[dt == 0] = 0.0, 0.0
    return acc, gyro, dt


def _rel(ours, ref):
    return float(np.abs(np.asarray(ours) - ref).max() / np.abs(ref).max())


def test_preintegrate_with_cov_matches_jax():
    cfg = UslamConfig().imu
    covs = (cfg.accel_cov, cfg.gyro_cov, cfg.integration_cov)
    acc, gyro, dt = (x.astype(np.float32) for x in _imu_samples(3, 24, seed=5))
    bias = np.float32([0.02, -0.01, 0.03, 0.002, -0.001, 0.003])
    ref_delta, ref_P = jax.device_get(jax.jit(jax.vmap(
        lambda d: jimu.preintegrate_with_cov(d, jnp.asarray(bias), *covs)))(
        jimu.ImuIntervalData(*map(jnp.asarray, (acc, gyro, dt)))))
    delta, P = factors.preintegrate_with_cov(
        ImuIntervalData(*map(torch.from_numpy, (acc, gyro, dt))), torch.from_numpy(bias), *covs)
    assert P.shape == (3, 9, 9) and P.dtype == torch.float32
    for f in ("delta_q", "delta_v", "delta_p", "dt_total"):
        assert _rel(getattr(delta, f).numpy(), getattr(ref_delta, f)) <= PREINT_RTOL, f
    assert _rel(P.numpy(), ref_P) <= PREINT_RTOL


def test_whitener_from_cov_is_the_packing_whitener():
    """float64: whitener_from_cov of the propagated covariance at zero bias
    is the main path's numpy whitener."""
    acc, gyro, dt = _imu_samples(4, 24, seed=6)
    cfg = config_to_port(UslamConfig())
    data = ImuIntervalData(*map(torch.from_numpy, (acc, gyro, dt)))
    _, P = factors.preintegrate_with_cov(data, torch.zeros(6, dtype=torch.float64),
                                         cfg.imu.accel_cov, cfg.imu.gyro_cov,
                                         cfg.imu.integration_cov)
    W = timu.whitener_from_cov(P, jitter=1e-10).numpy()
    ref = compute_imu_whiteners(ImuIntervalData(acc, gyro, dt), cfg)
    np.testing.assert_allclose(W, ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())
    np.testing.assert_allclose(W @ (P.numpy() + 1e-10 * np.eye(9)) @ W.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(9), W.shape), atol=1e-9)


def test_linearization_error_matches_jax():
    cfg = UslamConfig()
    seq = generate_synthetic_sequence(SyntheticSpec(duration=3.0, num_landmarks=24, seed=2))
    graph, values = (to_port(jax.device_get(x), "cpu") for x in jax_pack(seq, cfg)[:2])
    cam = StereoCamera.from_config(config_to_port(cfg).camera, device="cpu")
    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    lin = linearize_graph(graph, values, cam, *sig)
    ours = float(lin.error())
    ref = float(JaxLinearization(*(jnp.asarray(x.numpy()) for x in lin)).error())
    assert abs(ours - ref) <= 1e-6 * abs(ref)
    assert abs(ours - float(graph_error(graph, values, cam, *sig))) <= 1e-6 * abs(ref)


def test_extract_orb_is_the_batch_of_one_and_matches_jax():
    """On textured_image(96, 128) and seven more seeds. Against JAX:
    descriptors equal wherever the angle is bit-equal, and elsewhere the
    standard of ROADMAP C5 (tests/test_torch_parallel.py): the float32
    moment sums round the angle in another order (~1e-5 rad), so a steered
    sample can land on the next pixel: at most 2 flipped bits, in under 1%
    of the keypoints (measured: 1 bit of 1 of 362)."""
    cfg = FrontendConfig(pyramid_levels=2)
    tcfg = config_to_port(cfg)
    flipped = []
    for seed in (3, 0, 1, 2, 4, 5, 6, 7):
        img = textured_image(96, 128, seed=seed)
        ours = frontend.extract_orb(torch.from_numpy(img), tcfg)
        batch = extract_orb_batch(torch.from_numpy(img)[None], tcfg)
        for f, a, b in zip(ours._fields, ours, batch):
            assert torch.equal(a, b[0]), f
        kj = jax.device_get(jorb.extract_orb(jnp.asarray(img), cfg))
        kt = from_port(ours, kj)
        np.testing.assert_array_equal(kt.mask, kj.mask)
        m = kj.mask
        assert m.sum() >= 16
        for f in ("xy", "level"):
            np.testing.assert_array_equal(getattr(kt, f)[m], getattr(kj, f)[m], err_msg=f)
        np.testing.assert_allclose(kt.score[m], kj.score[m], rtol=1e-5)
        np.testing.assert_allclose(kt.angle[m], kj.angle[m], atol=1e-3)
        same_angle = m & (kt.angle == kj.angle)
        np.testing.assert_array_equal(kt.desc[same_angle], kj.desc[same_angle])
        flipped.append(np.unpackbits((kt.desc ^ kj.desc).view(np.uint8), axis=-1).sum(-1)[m])
    flipped = np.concatenate(flipped)
    assert flipped.max() <= 2 and (flipped > 0).mean() < 0.01, flipped[flipped > 0]


def test_hamming_distance_matrix_matches_jax():
    da = RNG.integers(0, 2**32, (37, 8), dtype=np.uint32)
    db = RNG.integers(0, 2**32, (53, 8), dtype=np.uint32)
    ref = _np(jmatch.hamming_distance_matrix(jnp.asarray(da), jnp.asarray(db)))
    ours = frontend.hamming_distance_matrix(torch.from_numpy(da.view(np.int32)),
                                   torch.from_numpy(db.view(np.int32)))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    as_uint = frontend.hamming_distance_matrix(torch.from_numpy(da).view(torch.uint32),
                                      torch.from_numpy(db).view(torch.uint32))
    np.testing.assert_array_equal(as_uint.numpy(), ref)
    # The plain version takes any width on the CPU.
    narrow = frontend.hamming_distance_matrix(torch.from_numpy(da[:, :3].copy().view(np.int32)),
                                     torch.from_numpy(db[:, :3].copy().view(np.int32)))
    np.testing.assert_array_equal(
        narrow.numpy(), _np(jmatch.hamming_distance_matrix(jnp.asarray(da[:, :3]),
                                                           jnp.asarray(db[:, :3]))))


def test_native_functions_match_jax_and_numpy():
    assert native.available() and native.whitener_available() and native.bag_available()
    rng = np.random.default_rng(0)
    pivot = np.sort(rng.uniform(0, 30, 100))
    s1, s2 = np.sort(rng.uniform(0, 30, 120)), np.sort(rng.uniform(0, 30, 90))
    for streams in ([s1], [s1, s2]):
        ours = native.approx_time_join(pivot, streams, 0.2)
        assert ours == jnative.approx_time_join(pivot, streams, 0.2)
        assert ours == approximate_time_join(pivot, streams, 0.2)
    with pytest.raises(ValueError, match="1 or 2 streams"):
        native.approx_time_join(pivot, [s1, s2, s1], 0.2)

    ids = rng.integers(0, 40, 200)
    rows, m = native.intern_ids(ids)
    first = {}
    expect = [first.setdefault(int(v), len(first)) for v in ids]
    assert m == len(first) and rows.tolist() == expect
    jrows, jm = jnative.intern_ids(ids)
    assert m == jm and np.array_equal(rows, jrows)

    imu = rng.normal(size=(50, 6))
    lo, hi = np.array([0, 10, 45]), np.array([10, 45, 45])
    out, mask = native.pack_imu_intervals(imu, lo, hi, S=16, dt=0.005)
    jout, jmask = jnative.pack_imu_intervals(imu, lo, hi, S=16, dt=0.005)
    assert np.array_equal(out, jout) and np.array_equal(mask, jmask)
    assert out.shape == (3, 16, 7) and mask.tolist() == [1.0, 1.0, 0.0]
    with pytest.raises(ValueError, match="inside"):
        native.pack_imu_intervals(imu, np.array([40]), np.array([60]), S=16, dt=0.005)

    acc, gyro, dt = _imu_samples(17, 24, seed=3)
    dt[2] = 0.0    # an empty interval
    cfg = config_to_port(UslamConfig())
    covs = (cfg.imu.accel_cov, cfg.imu.gyro_cov, cfg.imu.integration_cov)
    got = native.imu_whiteners(acc, gyro, dt, *covs)
    for ref in (jnative.imu_whiteners(acc, gyro, dt, *covs),
                compute_imu_whiteners(ImuIntervalData(acc, gyro, dt), cfg)):
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    with pytest.raises(ValueError):
        native.imu_whiteners(acc, gyro[:, :-1], dt, *covs)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A library that does not build raises with the compiler's output;
    ``available`` says False instead of raising."""
    bad = tmp_path / "ingest.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_INGEST_SRC", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_INGEST_LIB", None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on ingest.cpp"):
        native.intern_ids(np.arange(3))


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_extract_orb_on_the_card(cuda):
    img = torch.from_numpy(textured_image(96, 128))
    cfg = config_to_port(FrontendConfig())
    kernels.reset_launch_counts()
    ours = frontend.extract_orb(img.to(cuda), cfg)
    assert kernels.launch_counts["fast_harris"] == cfg.pyramid_levels
    batch = extract_orb_batch(img[None].to(cuda), cfg)
    cpu = frontend.extract_orb(img, cfg)
    for f, a, b, c in zip(ours._fields, ours, batch, cpu):
        assert torch.equal(a, b[0]), f
        if f in ("mask", "xy", "level", "desc"):
            assert torch.equal(a.cpu(), c), f


@pytest.mark.cuda
def test_hamming_distance_matrix_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    da, db = (torch.randint(-2**31, 2**31 - 1, (n, 8), generator=gen, device=cuda,
                            dtype=torch.int32) for n in (1000, 1200))
    kernels.reset_launch_counts()
    out = frontend.hamming_distance_matrix(da, db)
    assert kernels.launch_counts["hamming"] == 1
    assert torch.equal(out, kernels.hamming_plain(da[None], db[None])[0])
    with pytest.raises(ValueError):
        frontend.hamming_distance_matrix(da[:, :4].contiguous(), db[:, :4].contiguous())
