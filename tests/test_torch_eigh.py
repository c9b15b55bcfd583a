"""The port's symmetric eigensolver (uslam_tpu_torch/solvers/eig.py: the
``jacobi_eigh`` kernel's plain version ``sym_eigh_plain``, which CPU
tensors take) against ``jnp.linalg.eigh``, which the JAX package's window
step calls on the marginal (uslam_tpu/solvers/fixed_lag.py:677), on the
CPU; and a numpy replay of the kernel's own schedule (csrc/jacobi_eigh.cu:
one warp per matrix, each round's (c, s) by one lane per pair, then the
fused pass over 2 x 2 blocks, the stop test's column sums and shuffle tree)
against ``sym_eigh_plain``, bit for bit.

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



def _sqrt(x: np.ndarray) -> np.ndarray:
    """The square root sym_eigh_plain takes on this device: PyTorch's CPU
    sqrt, which is not correctly rounded on every input (numpy's is; on the
    card torch.sqrt and the kernel's __fsqrt_rn / __dsqrt_rn both are)."""
    return torch.sqrt(torch.from_numpy(np.asarray(x))).numpy()


def _replay(A: np.ndarray):
    """``jacobi_eigh``'s schedule in numpy, in A's type, every operation
    rounded on its own: the lanes of a warp are array elements. Returns
    (w, V, sweeps) as the kernel writes them."""
    dt = A.dtype.type
    n = len(A)
    m, lanes = n + n % 2, np.arange(32)
    half = m // 2
    a = np.zeros((m, m), dt)
    low = np.tril(A)
    a[:n, :n] = low + np.tril(A, -1).T                  # the lower triangle, mirrored
    V = np.eye(m, dtype=dt)

    def squares():
        """Lane j sums down column j; then the shuffle tree (lane i adds
        lane i + d, a lane past the warp's end adds its own value)."""
        sq = a * a
        s, o = np.zeros(32, dt), np.zeros(32, dt)
        for i in range(m):
            s[:m] = s[:m] + sq[i]
            o[:m] = np.where(np.arange(m) != i, o[:m] + sq[i], o[:m])
        for d in (16, 8, 4, 2, 1):
            src = np.where(lanes + d < 32, lanes + d, lanes)
            s, o = s + s[src], o + o[src]
        return s[0], o[0]

    eps = dt(np.finfo(dt).eps)
    total, off = squares()
    tol2 = (eps * eps) * total
    stop, sweeps = off <= tol2, 0
    P, Q = eig.round_robin(m)
    one, two = dt(1), dt(2)
    while not stop and sweeps < eig.MAX_SWEEPS:
        for p, q in zip(P, Q):
            # One lane per pair: the rotation's chain.
            app, aqq, apq = a[p, p], a[q, q], a[p, q]
            theta = (aqq + -app) / (two * apq)
            sgn = np.where(theta >= 0, one, -one).astype(dt)
            t = sgn / (np.abs(theta) + _sqrt(theta * theta + one))
            c = one / _sqrt(t * t + one)
            s = t * c
            # A zero a_pq skips the chain: c = 1, s = +0.
            c, s = np.where(apq == 0, one, c).astype(dt), np.where(apq == 0, dt(0), s).astype(dt)
            # The fused pass: lane b owns block (k, l) = divmod(b, half).
            k, l = np.divmod(np.arange(half * half), half)
            pk, qk, pl, ql = p[k], q[k], p[l], q[l]
            ck, sk, cl, sl = c[k], s[k], c[l], s[l]

            def rot(c, s, x, y):
                return c * x + -(s * y), s * x + c * y

            x11, x21 = rot(ck, sk, a[pk, pl], a[qk, pl])      # the rows of pair k
            x12, x22 = rot(ck, sk, a[pk, ql], a[qk, ql])
            y11, y12 = rot(cl, sl, x11, x12)                  # then the columns of pair l
            y21, y22 = rot(cl, sl, x21, x22)
            diag = k == l
            y12, y21 = np.where(diag, dt(0), y12), np.where(diag, dt(0), y21)
            z11, z12 = rot(cl, sl, V[pk, pl], V[pk, ql])
            z21, z22 = rot(cl, sl, V[qk, pl], V[qk, ql])
            a[pk, pl], a[pk, ql], a[qk, pl], a[qk, ql] = y11, y12, y21, y22
            V[pk, pl], V[pk, ql], V[qk, pl], V[qk, ql] = z11, z12, z21, z22
        sweeps += 1
        total, off = squares()
        stop = off <= tol2
    d = np.diagonal(a)[:n]
    # Lane j's slot: the entries before it (NaN last), ties in index order.
    slot = [sum((d[i] < d[j]) or (np.isnan(d[j]) and not np.isnan(d[i]))
                or (i < j and (d[i] == d[j] or (np.isnan(d[i]) and np.isnan(d[j]))))
                for i in range(n)) for j in range(n)]
    w, Vout = np.empty(n, dt), np.empty((n, n), dt)
    w[slot] = d
    Vout[:, slot] = V[:n, :n]
    return w, Vout, sweeps


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


def _seeded_spd15() -> np.ndarray:
    J = np.random.default_rng(11).normal(size=(15, 15))
    return J @ J.T + 0.1 * np.eye(15)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", [*CASES, "seeded spd15"])
def test_kernel_schedule_replay_equals_plain(name, dtype):
    """The kernel's fused two-sided rotation, replayed lane by lane in
    numpy (every operation rounded in the input's type), equals
    sym_eigh_plain (rows, then columns, then a_pq = 0) bit for bit: the
    same rotations, the same stop, the same sort. Upper-triangle junk is
    ignored by both."""
    A = (_seeded_spd15() if name == "seeded spd15" else _case(name)).astype(dtype)
    junk = np.tril(A) + np.triu(np.full_like(A, 7.0), 1)
    with np.errstate(all="ignore"):
        w, V, sweeps = _replay(junk)
    wp, Vp, swp = eig.sym_eigh_plain(torch.from_numpy(A))
    assert w.dtype == V.dtype == dtype
    assert sweeps == int(swp) < eig.MAX_SWEEPS
    assert np.array_equal(w, wp.numpy()) and np.array_equal(V, Vp.numpy())


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
