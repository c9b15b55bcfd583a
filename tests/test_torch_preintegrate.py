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

On the CPU the plain version is also bit-identical to that JAX-free
oracle, ``preintegrate_loop`` under ``torch.func.jvp``: it writes out the
same operations in the same order.

Marked ``cuda`` (skipped without a GPU): the kernel against the plain
version and, bit for bit, against the loop under ``torch.func.jvp`` (the
eager path it replaces); the graphed linearize_graph / graph_error against
their eager bodies (chip_smoke.py does both at the main path's shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uslam_tpu.factors.imu import ImuIntervalData as JaxImuData
from uslam_tpu.factors.imu import preintegrate as jax_preintegrate
from uslam_tpu_torch import cuda_build
from uslam_tpu_torch.factors import imu
from uslam_tpu_torch.solvers import compiled

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
