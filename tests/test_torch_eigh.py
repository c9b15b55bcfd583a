"""The port's symmetric eigensolver (uslam_tpu_torch/solvers/eig.py: the
``jacobi_eigh`` kernel's plain version ``sym_eigh_plain``, which CPU
tensors take) against ``jnp.linalg.eigh``, which the JAX package's window
step calls on the marginal (uslam_tpu/solvers/fixed_lag.py:677), on the
CPU.

Inputs, made with numpy from seeds: a random SPD 15 x 15 (the marginal's
size); an indefinite one with eigenvalues near -1e-9 (what sparsification
leaves, the PSD projection's reason); repeated eigenvalues (identity
blocks); diagonal; zero; random symmetric n = 2, 9 and 32 (the kernel's
largest).

Tolerances, relative to the input's Frobenius norm (Jacobi stops when the
off-diagonal norm is below the type's epsilon times it, and each rotation
rounds at that level): eigenvalues within 1e-12 in float64 and 1e-5 in
float32, where LAPACK's own error is of the same order; V orthonormal to
the same bounds; the PSD projection V diag(max(w, 0)) V^T against JAX's to
the same bounds. Eigenvectors are compared only through the projection:
their signs, and any basis of a repeated eigenvalue, are free.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uslam_tpu_torch.cuda_build import launch_counts
from uslam_tpu_torch.solvers import eig

RTOL = {np.float64: 1e-12, np.float32: 1e-5}


# Each case's numpy seed.
CASES = {"spd15": 0, "indefinite15": 1, "repeated15": 2, "diagonal15": 3, "zero15": 4,
         "symmetric2": 5, "symmetric9": 6, "symmetric32": 7}


def _case(name: str) -> np.ndarray:
    rng = np.random.default_rng(CASES[name])
    if name == "spd15":
        J = rng.normal(size=(15, 15))
        return J @ J.T
    if name == "indefinite15":
        Q, _ = np.linalg.qr(rng.normal(size=(15, 15)))
        w = np.concatenate([rng.uniform(1.0, 10.0, 10), rng.uniform(-2e-9, -5e-10, 5)])
        return (Q * w) @ Q.T
    if name == "repeated15":
        return np.kron(np.eye(5), np.ones((3, 3))) + 2.0 * np.eye(15)
    if name == "diagonal15":
        return np.diag(rng.normal(size=15))
    if name == "zero15":
        return np.zeros((15, 15))
    n = int(name[len("symmetric"):])
    J = rng.normal(size=(n, n))
    return J + J.T



def _psd(w, V):
    return (V * np.clip(w, 0.0, None)) @ V.T


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(CASES))
def test_sym_eigh_plain_matches_jax(name, dtype):
    A = _case(name).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        w_ref, V_ref = jax.device_get(jnp.linalg.eigh(jnp.asarray(A)))
    assert w_ref.dtype == dtype
    w, V, sweeps = eig.sym_eigh_plain(torch.from_numpy(A))
    w, V = w.numpy(), V.numpy()
    assert w.dtype == V.dtype == dtype and V.shape == A.shape
    assert int(sweeps) < eig.MAX_SWEEPS                      # converged
    bound = RTOL[dtype] * np.linalg.norm(A.astype(np.float64))
    assert np.all(np.diff(w) >= 0)
    assert np.abs(w.astype(np.float64) - w_ref).max() <= bound
    n = len(A)
    V64 = V.astype(np.float64)
    assert np.abs(V64.T @ V64 - np.eye(n)).max() <= RTOL[dtype] * max(n, 1)
    assert np.abs(_psd(w.astype(np.float64), V64)
                  - _psd(w_ref.astype(np.float64), V_ref.astype(np.float64))).max() <= bound


def test_batch_lower_triangle_and_cpu_dispatch():
    """A batch of (2, 3) matrices equals its matrices one by one; only the
    lower triangle is read, as torch.linalg.eigh reads it; sym_eigh of a
    CPU tensor is the plain version and counts no launch."""
    rng = np.random.default_rng(7)
    B = rng.normal(size=(2, 3, 15, 15))
    A = torch.from_numpy(np.tril(B) + np.swapaxes(np.tril(B, -1), -1, -2))
    w, V, sweeps = eig.sym_eigh_plain(A)
    assert w.shape == (2, 3, 15) and V.shape == (2, 3, 15, 15) and sweeps.shape == (2, 3)
    for i in range(2):
        for j in range(3):
            one = eig.sym_eigh_plain(A[i, j])
            assert torch.equal(one[0], w[i, j]) and torch.equal(one[1], V[i, j])
    upper_junk = torch.from_numpy(np.tril(B) + np.triu(rng.normal(size=B.shape), 1))
    assert all(torch.equal(x, y) for x, y in zip(eig.sym_eigh_plain(upper_junk), (w, V, sweeps)))
    ref = torch.linalg.eigh(A)
    assert (w - ref.eigenvalues).abs().max() <= 1e-12 * torch.linalg.norm(A, dim=(-2, -1)).max()
    before = dict(launch_counts)
    got = eig.sym_eigh(A)
    assert all(torch.equal(x, y) for x, y in zip(got, (w, V, sweeps)))
    assert launch_counts == before


def test_round_robin_meets_every_pair_once():
    for m in (2, 4, 16, 32):
        P, Q = eig.round_robin(m)
        assert P.shape == Q.shape == (m - 1, m // 2) and (P < Q).all()
        for r in range(m - 1):
            assert sorted(np.concatenate([P[r], Q[r]])) == list(range(m))   # disjoint
        pairs = set(zip(P.ravel().tolist(), Q.ravel().tolist()))
        assert len(pairs) == m * (m - 1) // 2


def test_sym_eigh_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        eig.sym_eigh(torch.zeros((33, 33)))
    with pytest.raises(ValueError):
        eig.sym_eigh(torch.zeros((4, 5)))
    with pytest.raises(ValueError):
        eig.sym_eigh(torch.zeros((4, 4), dtype=torch.float16))
