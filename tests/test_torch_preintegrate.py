"""The port's IMU preintegration (uslam_tpu_torch/factors/imu.py) and the
CUDA-graph cache of the linearization (uslam_tpu_torch/solvers/compiled.py).

On the CPU: the plain version (the recursion carrying the six bias
tangents) against the JAX package's ``preintegrate`` (a ``lax.scan``) and
``jax.jacfwd`` of it with respect to the bias, on seeded numpy samples with
padded rows, a fully padded interval and one of zero rotation (so3_exp's
small-angle branch at a nonzero dt). Tolerances, relative to each output's
largest entry: float64 (JAX under ``jax.enable_x64``) 1e-12, the same
formulas rounding in another order; float32 1e-5, where the 64-step
recursion compounds that reordering.

The linearization through the ``torch.autograd.Function`` is held to the
JAX package's by tests/test_torch_backend.py::test_linearization_matches_jax_f64.
Its IMU block, which preintegrates once per interval and reaches the 24
tangent rows through the bias Jacobian, is held here to the 24-row path
it replaces (``imu_residual`` under ``torch.func.jvp``, one
preintegration per tangent row) bit for bit, and to the JAX package's
``jax.jacfwd`` linearization of the IMU factor on the same numpy inputs,
at the tolerances above, relative to each block's largest entry.

On the CPU the plain version is also bit-identical to that JAX-free
oracle, ``preintegrate_loop`` under ``torch.func.jvp``: it writes out the
same operations in the same order.

Marked ``cuda`` (skipped without a GPU): the kernel against the plain
version and, bit for bit, against the loop under ``torch.func.jvp`` (the
eager path it replaces); its value-only variant against the full kernel's
value and the loop bit for bit; the graphed linearize_graph / graph_error
against their eager bodies (chip_smoke.py does all at the main path's
shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uslam_tpu.config import UslamConfig as JaxConfig
from uslam_tpu.factors.imu import ImuIntervalData as JaxImuData
from uslam_tpu.factors.imu import imu_residual as jax_imu_residual
from uslam_tpu.factors.imu import preintegrate as jax_preintegrate
from uslam_tpu.geometry.se3 import Pose3 as JaxPose3
from uslam_tpu.geometry.se3 import pose_retract as jax_retract
from uslam_tpu.graph.packing import pack_sequence as jax_pack
from uslam_tpu.io.synthetic import SyntheticSpec, generate_synthetic_sequence
from uslam_tpu_torch import cuda_build
from uslam_tpu_torch.device import cast_tree
from uslam_tpu_torch.factors import imu
from uslam_tpu_torch.geometry.camera import StereoCamera
from uslam_tpu_torch.geometry.se3 import pose_retract
from uslam_tpu_torch.interop import config_to_port, to_port
from uslam_tpu_torch.solvers import compiled
from uslam_tpu_torch.solvers import linearize as L

RTOL = {"float64": 1e-12, "float32": 1e-5}


def _samples(n, S, seed):
    """(acc, gyro, dt) float64 numpy: interval 0 fully padded, interval 1
    without rotation, the others with a padded tail of random length."""
    rng = np.random.default_rng(seed)
    acc = rng.normal(size=(n, S, 3)) + np.array([0.0, 0.0, 9.81])
    gyro = rng.normal(scale=0.4, size=(n, S, 3))
    gyro[1] = 0.0
    counts = rng.integers(S // 2, S + 1, size=n)
    counts[0] = 0
    dt = np.where(np.arange(S)[None, :] < counts[:, None], 0.005, 0.0)
    acc[dt == 0], gyro[dt == 0] = 0.0, 0.0
    return acc, gyro, dt


def _jax_reference(acc, gyro, dt, bias):
    """JAX values (n, 10), dt_total (n,) and bias Jacobians (n, 10, 6)."""

    def value(d, b):
        out = jax_preintegrate(d, b)
        return jnp.concatenate([out.delta_q, out.delta_v, out.delta_p]), out.dt_total

    def flat(d, b):
        return value(d, b)[0]

    data = JaxImuData(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dt))
    b = jnp.asarray(bias)
    vals, t = jax.vmap(value)(data, b)
    jac = jax.vmap(jax.jacfwd(flat, argnums=1))(data, b)
    return jax.device_get((vals, t, jac))


def _rel(ours, ref):
    return float(np.abs(np.asarray(ours) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,S,shared_bias", [(6, 64, False), (6, 64, True)])
def test_plain_preintegration_matches_jax(n, S, shared_bias, dtype):
    acc, gyro, dt = _samples(n, S, seed=n + S)
    rng = np.random.default_rng(1)
    bias = rng.normal(scale=[0.05] * 3 + [0.005] * 3, size=(1 if shared_bias else n, 6))
    if dtype == "float64":
        with jax.enable_x64(True):
            vals, t, jac = _jax_reference(acc, gyro, dt, np.broadcast_to(bias, (n, 6)))
    else:
        f32 = [x.astype(np.float32) for x in (acc, gyro, dt, bias)]
        vals, t, jac = _jax_reference(*f32[:3], np.broadcast_to(f32[3], (n, 6)))
    tdt = getattr(torch, dtype)
    data = imu.ImuIntervalData(*(torch.tensor(x, dtype=tdt) for x in (acc, gyro, dt)))
    b = torch.tensor(bias[0] if shared_bias else bias, dtype=tdt)
    delta, J = imu.preintegrate_plain(data, b)
    assert J.shape == (n, 10, 6) and J.dtype == tdt
    ours = torch.cat([delta.delta_q, delta.delta_v, delta.delta_p], -1).numpy()
    tol = RTOL[dtype]
    for name, sl in (("q", slice(0, 4)), ("v", slice(4, 7)), ("p", slice(7, 10))):
        assert _rel(ours[:, sl], vals[:, sl]) <= tol, name
        assert _rel(J[:, sl].numpy(), jac[:, sl]) <= tol, f"J_{name}"
    assert _rel(delta.dt_total.numpy(), t) <= tol
    # The fully padded interval: identity, zero deltas, zero Jacobian.
    assert np.array_equal(ours[0], [1.0] + [0.0] * 9)
    assert not J[0].any()


def test_function_jvp_is_the_bias_jacobian():
    """torch.func.jvp through preintegrate (the Function) gives the plain
    version's Jacobian times the tangent, over a batch of tangent rows; its
    value and Jacobian are the loop's under torch.func.jvp, bit for bit."""
    acc, gyro, dt = _samples(5, 16, seed=3)
    data = imu.ImuIntervalData(*(torch.tensor(x) for x in (acc, gyro, dt)))
    bias = torch.tensor([0.03, -0.02, 0.01, 0.002, -0.004, 0.001], dtype=torch.float64)
    tangent = torch.eye(6, dtype=torch.float64)[:, None, :].expand(6, 5, 6)

    def f(d):
        out = imu.preintegrate(data, bias + d)
        return torch.cat([out.delta_q, out.delta_v, out.delta_p], -1)

    value, jt = torch.func.jvp(f, (torch.zeros_like(tangent),), (tangent,))
    loop = imu.preintegrate_loop(data, bias)
    assert torch.equal(value[0], torch.cat([loop.delta_q, loop.delta_v, loop.delta_p], -1))
    _, J = imu.preintegrate_plain(data, bias)
    assert torch.equal(jt.movedim(0, -1), J)
    # ... and the plain version's Jacobian is the loop's under torch.func.jvp.
    _, jt_loop = torch.func.jvp(
        lambda d: torch.cat(list(imu.preintegrate_loop(data, bias + d))[:3], -1),
        (torch.zeros_like(tangent),), (tangent,))
    assert torch.equal(jt_loop.movedim(0, -1), J)
    assert torch.equal(imu.preintegrate_value(data, bias).delta_p, loop.delta_p)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_value_only_path_is_the_loop(dtype):
    """preintegrate_value (the error's path) on the CPU: the loop, bit for
    bit, with one bias per interval and with one for all."""
    acc, gyro, dt = _samples(5, 64, seed=8)
    tdt = getattr(torch, dtype)
    data = imu.ImuIntervalData(*(torch.tensor(x, dtype=tdt) for x in (acc, gyro, dt)))
    bias = torch.tensor(np.random.default_rng(9).normal(scale=0.02, size=(5, 6)), dtype=tdt)
    for b in (bias, bias[2]):
        got, ref = imu.preintegrate_value(data, b), imu.preintegrate_loop(data, b)
        assert all(torch.equal(x, y) for x, y in zip(got, ref))


def test_cpu_tensors_never_reach_the_kernel():
    acc, gyro, dt = _samples(3, 16, seed=4)
    data = imu.ImuIntervalData(*(torch.tensor(x) for x in (acc, gyro, dt)))
    cuda_build.reset_launch_counts()
    imu.preintegrate(data, torch.zeros(6, dtype=torch.float64))
    imu.preintegrate_value(data, torch.zeros(6, dtype=torch.float64))
    assert cuda_build.launch_counts["preintegrate"] == 0
    with pytest.raises(ValueError):
        imu.preintegrate_cuda(data, torch.zeros(6, dtype=torch.float64))


def test_graph_cache_key_follows_structure_shapes_and_constants():
    """The cache key: tree structure, leaf shapes and dtypes, non-tensor
    leaves' values; not the tensors' values (they are copied in)."""
    cam = imu.PreintegratedDelta(torch.zeros(4), torch.ones(3), torch.zeros(3), 0.5)
    leaves = []
    key = compiled._flatten((cam, (torch.zeros(2, 3),)), leaves)
    assert len(leaves) == 4
    again = compiled._flatten((cam._replace(delta_v=torch.full((3,), 7.0)), (torch.ones(2, 3),)), [])
    assert again == key
    assert compiled._flatten((cam._replace(dt_total=0.25), (torch.zeros(2, 3),)), []) != key
    assert compiled._flatten((cam, (torch.zeros(3, 3),)), []) != key
    assert compiled._flatten((cam, (torch.zeros(2, 3, dtype=torch.float64),)), []) != key
    rebuilt = compiled._unflatten(key, iter(leaves))
    assert type(rebuilt[0]) is imu.PreintegratedDelta and rebuilt[0].dt_total == 0.5
    assert rebuilt[0].delta_v is leaves[1] and rebuilt[1][0] is leaves[3]
    with pytest.raises(ValueError):
        compiled.call("f", lambda x: x, (leaves[0],), ())


# ---- the linearizer's IMU block ----------------------------------------------
IMU_FIELDS = ("imu_r", "imu_J_pose_i", "imu_J_vel_i", "imu_J_pose_j", "imu_J_vel_j", "imu_J_bias")
SIGMAS = (0.1, 10.0)  # dvl_sigma, stereo_sigma


@pytest.fixture(scope="module")
def imu_problem():
    """The JAX package's packing of a 2 s synthetic dive (9 IMU intervals
    of 64 samples), as numpy, with the velocities and the bias perturbed so
    that every IMU block is nonzero."""
    cfg = JaxConfig()
    seq = generate_synthetic_sequence(SyntheticSpec(duration=2.0, odom_drift_rate=0.05))
    graph, values = jax.device_get(jax_pack(seq, cfg)[:2])
    rng = np.random.default_rng(7)
    values = values._replace(
        vel=values.vel + rng.normal(0, 0.1, values.vel.shape),
        bias=values.bias + rng.normal(scale=[0.05] * 3 + [0.005] * 3),
    )
    return cfg, graph, values


def _port(problem, dtype):
    cfg, graph, values = problem
    tdt = getattr(torch, dtype)
    g = cast_tree(to_port(graph, "cpu"), tdt, "cpu")
    v = cast_tree(to_port(values, "cpu"), tdt, "cpu")
    cam = StereoCamera.from_config(config_to_port(cfg.camera), device="cpu", dtype=tdt)
    return g, v, cam


def _imu_block_24_rows(g, v, gravity):
    """The IMU block as the linearizer took it before it preintegrated once
    per interval: imu_residual under torch.func.jvp, the public
    preintegrate run for each of the 24 tangent rows of every interval."""
    n_int = g.imu.mask.shape[0]
    pose_i, vel_i, pose_j, vel_j = L._frame_pairs(v, n_int)

    def f(d):
        return imu.imu_residual(
            pose_retract(pose_i, d[..., 0:6]), vel_i + d[..., 6:9],
            pose_retract(pose_j, d[..., 9:15]), vel_j + d[..., 15:18],
            v.bias + d[..., 18:24], g.imu.data, gravity, g.imu.whitener)

    r, J = L._lin(f, (n_int,), 24, v.pose_trans)
    J = J * g.imu.mask[:, None, None]
    return (r * g.imu.mask[:, None], J[..., 0:6], J[..., 6:9], J[..., 9:15], J[..., 15:18],
            J[..., 18:24])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_imu_block_equals_the_24_row_path(imu_problem, dtype):
    g, v, cam = _port(imu_problem, dtype)
    gravity = imu_problem[0].imu.gravity
    lin = L.linearize_graph_eager(g, v, cam, *SIGMAS, gravity)
    ref = _imu_block_24_rows(g, v, gravity)
    for f, b in zip(IMU_FIELDS, ref):
        assert torch.equal(getattr(lin, f), b), f
    assert lin.imu_J_bias.abs().max() > 0


def _jax_imu_block(graph, values, gravity):
    """The JAX package's IMU block (uslam_tpu/solvers/linearize.py:133-174):
    jax.jacfwd of its imu_residual at the zero tangent, vmapped over the
    intervals, masked."""
    n_int = graph.imu.mask.shape[0]
    ki = np.minimum(np.arange(n_int), values.pose_quat.shape[0] - 1)
    kj = np.minimum(np.arange(n_int) + 1, values.pose_quat.shape[0] - 1)

    def lin(qi, ti, vi, qj, tj, vj, data, whitener, mask):
        def fn(d):
            return jax_imu_residual(
                jax_retract(JaxPose3(qi, ti), d[0:6]), vi + d[6:9],
                jax_retract(JaxPose3(qj, tj), d[9:15]), vj + d[15:18],
                values.bias + d[18:24], data, gravity, whitener)

        zero = jnp.zeros(24, values.bias.dtype)
        return fn(zero) * mask, jax.jacfwd(fn)(zero) * mask

    r, J = jax.device_get(jax.jit(jax.vmap(lin))(
        values.pose_quat[ki], values.pose_trans[ki], values.vel[ki], values.pose_quat[kj],
        values.pose_trans[kj], values.vel[kj], JaxImuData(*graph.imu.data), graph.imu.whitener,
        graph.imu.mask))
    return r, J[..., 0:6], J[..., 6:9], J[..., 9:15], J[..., 15:18], J[..., 18:24]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_imu_block_matches_jax(imu_problem, dtype):
    """The IMU block against the JAX package's linearization of the IMU
    factor on the same numpy inputs, to RTOL."""
    cfg, graph, values = imu_problem
    ndt = np.dtype(dtype)
    graph, values = (jax.tree.map(
        lambda a: a.astype(ndt) if np.issubdtype(a.dtype, np.floating) else a, t)
        for t in (graph, values))
    with jax.enable_x64(dtype == "float64"):
        ref = _jax_imu_block(graph, values, cfg.imu.gravity)
    lin = L.linearize_graph_eager(*_port(imu_problem, dtype), *SIGMAS, cfg.imu.gravity)
    for f, a in zip(IMU_FIELDS, ref):
        b = getattr(lin, f).numpy()
        assert a.shape == b.shape, f
        assert _rel(b, a) <= RTOL[dtype], f


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_preintegrate_kernel_matches_plain(cuda, dtype):
    acc, gyro, dt = _samples(40, 64, seed=5)
    tdt = getattr(torch, dtype)
    data = imu.ImuIntervalData(*(torch.tensor(x, dtype=tdt, device=cuda)
                                 for x in (acc, gyro, dt)))
    bias = torch.tensor(np.random.default_rng(6).normal(scale=0.02, size=(24, 40, 6)),
                        dtype=tdt, device=cuda)
    before = cuda_build.launch_counts["preintegrate"]
    dk, jk = imu.preintegrate_cuda(data, bias)
    dp, jp = imu.preintegrate_plain(data, bias)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["preintegrate"] == before + 1
    for a, b in [*zip(dk, dp), (jk, jp)]:
        assert a.shape == b.shape
        assert float((a - b).abs().max() / b.abs().max()) <= RTOL[dtype]
    assert not jk[:, 0].any()
    # Bit for bit the eager path it replaces: the loop under torch.func.jvp,
    # one bias for every row and the six bias tangents.
    b6 = bias[0, 0]
    tangent = torch.eye(6, dtype=tdt, device=cuda)[:, None, :].expand(6, 40, 6)

    def f(d):
        out = imu.preintegrate_loop(data, b6 + d)
        return torch.cat([out.delta_q, out.delta_v, out.delta_p], -1)

    value, jt = torch.func.jvp(f, (torch.zeros_like(tangent),), (tangent,))
    d6, j6 = imu.preintegrate_cuda(data, b6)
    assert torch.equal(torch.cat([d6.delta_q, d6.delta_v, d6.delta_p], -1), value[0])
    assert torch.equal(j6, jt.movedim(0, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_value_only_kernel_matches_full_kernel_and_loop(cuda, dtype):
    """The error's variant (no Jacobian): the full kernel's value and the
    loop's bit for bit, the plain version's to RTOL; per-row and shared bias."""
    acc, gyro, dt = _samples(40, 64, seed=10)
    tdt = getattr(torch, dtype)
    data = imu.ImuIntervalData(*(torch.tensor(x, dtype=tdt, device=cuda)
                                 for x in (acc, gyro, dt)))
    bias = torch.tensor(np.random.default_rng(11).normal(scale=0.02, size=(40, 6)),
                        dtype=tdt, device=cuda)
    for b in (bias, bias[3]):
        before = cuda_build.launch_counts["preintegrate"]
        got, none = imu.preintegrate_cuda(data, b, jacobian=False)
        assert none is None and cuda_build.launch_counts["preintegrate"] == before + 1
        full = imu.preintegrate_cuda(data, b)[0]
        loop = imu.preintegrate_loop(data, b)
        plain = imu.preintegrate_plain(data, b)[0]
        torch.cuda.synchronize()
        for x, y, z, w in zip(got, full, loop, plain):
            assert torch.equal(x, y) and torch.equal(x, z)
            assert float((x - w).abs().max() / w.abs().max()) <= RTOL[dtype]
        assert all(torch.equal(x, y) for x, y in zip(imu.preintegrate_value(data, b), got))


@pytest.mark.cuda
def test_graphed_linearization_matches_eager(cuda):
    from uslam_tpu_torch.config import UslamConfig
    from uslam_tpu_torch.geometry.camera import StereoCamera
    from uslam_tpu_torch.graph.packing import pack_sequence
    from uslam_tpu_torch.interop import to_port
    from uslam_tpu_torch.io.synthetic import SyntheticSpec, generate_synthetic_sequence
    from uslam_tpu_torch.solvers import linearize as L

    cfg = UslamConfig()
    seq = generate_synthetic_sequence(SyntheticSpec(duration=2.0, odom_drift_rate=0.05))
    g, v = (to_port(x, cuda) for x in pack_sequence(seq, cfg)[:2])
    cam = StereoCamera.from_config(cfg.camera, device=cuda)
    sig = (cfg.noise.dvl_sigma, cfg.noise.stereo_sigma, cfg.imu.gravity)
    first = L.linearize_graph(g, v, cam, *sig)
    captured = dict(compiled.captures)
    shifted = v._replace(pose_trans=v.pose_trans + 0.01)
    second = L.linearize_graph(g, shifted, cam, *sig)
    assert compiled.captures == captured  # the same shapes replay
    eager = L.linearize_graph_eager(g, v, cam, *sig)
    # The first result outlived the second replay of the same graph.
    assert all(torch.equal(a, b) for a, b in zip(first, eager))
    assert all(torch.equal(a, b) for a, b in
               zip(second, L.linearize_graph_eager(g, shifted, cam, *sig)))
    assert torch.equal(L.graph_error(g, v, cam, *sig), L.graph_error_eager(g, v, cam, *sig))
