"""Symmetric eigendecomposition of small matrices: the ``jacobi_eigh``
CUDA kernel, its plain PyTorch version and its launch counter.

==============  ==========================  ==================================
wrapper         CUDA source                 replaces (JAX package)
==============  ==========================  ==================================
``sym_eigh``    ``csrc/jacobi_eigh.cu``     ``jnp.linalg.eigh`` of the window
                                            step's marginal
                                            (``solvers/fixed_lag.py:677``);
                                            no Pallas kernel
==============  ==========================  ==================================

The online window step PSD-projects the 15 x 15 marginal information of
the departing keyframe through its eigendecomposition. ``torch.linalg.eigh``
checks its status on the host, so no CUDA graph can hold it and it would
cost a host wait per keyframe; the kernel reads nothing on the host.

Both versions run the same cyclic Jacobi (the kernel's source describes it):
round-robin rounds of disjoint rotations, a stop when the off-diagonal norm
is at most the type's machine epsilon times the input's Frobenius norm, or
after ``MAX_SWEEPS`` sweeps; eigenvalues ascending, ties in index order, as
``torch.linalg.eigh`` returns them; only the lower triangle is read. The
plain version rotates all the pairs of a round at once with the kernel's
operations in the kernel's order, so the two agree bit for bit where they
stop after the same sweep (their norms are summed in other orders).

:func:`sym_eigh` dispatches on the device of the tensor it is given: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel, anything
else raises; a failed build or launch raises, nothing falls back to
``torch.linalg.eigh``. Each launch adds one to
``cuda_build.launch_counts["jacobi_eigh"]``; the plain version never does.
"""

from __future__ import annotations

import numpy as np
import torch

from uslam_tpu_torch.cuda_build import launch_counts, load, raise_on, stream_of

MAX_N = 32
# Jacobi converges quadratically: a 15 x 15 marginal takes a handful of
# sweeps; the cap only bounds a matrix holding NaN or Inf.
MAX_SWEEPS = 30


def _check(A: torch.Tensor) -> int:
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sym_eigh: need float32 or float64, got {A.dtype}")
    if A.dim() < 2 or A.shape[-1] != A.shape[-2] or not 1 <= A.shape[-1] <= MAX_N:
        raise ValueError(f"sym_eigh: need (..., n, n) with 1 <= n <= {MAX_N}, got "
                         f"{tuple(A.shape)}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sym_eigh: unsupported device {A.device}")
    return A.shape[-1]


def round_robin(m: int) -> tuple[np.ndarray, np.ndarray]:
    """The ``m - 1`` rounds of ``m / 2`` disjoint pairs (p < q) of indices
    0..m-1 (m even) that meet every pair once: index m - 1 stays, the others
    turn. Returns (P, Q), each (m - 1, m / 2)."""
    P = np.empty((m - 1, m // 2), np.int64)
    Q = np.empty_like(P)
    for r in range(m - 1):
        for k in range(m // 2):
            p, q = (m - 1, r) if k == 0 else ((r + k) % (m - 1), (r - k + m - 1) % (m - 1))
            P[r, k], Q[r, k] = min(p, q), max(p, q)
    return P, Q


def _off2(a: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    return (a * a).masked_fill(diag, 0.0).sum(dim=(-2, -1))


def sym_eigh_plain(A: torch.Tensor):
    """Plain version of :func:`sym_eigh`: (..., n, n) symmetric -> (w
    (..., n) ascending, V (..., n, n) with the eigenvector of w[k] in
    column k, sweeps (...) int32), the kernel's Jacobi with each round's
    pairs rotated together. Reads the host once per sweep (whether every
    matrix has stopped)."""
    n = _check(A)
    lead, dt, dev = A.shape[:-2], A.dtype, A.device
    a = A.reshape(-1, n, n)
    B, m = a.shape[0], n + n % 2
    low = torch.ones((n, n), dtype=torch.bool, device=dev).tril()
    a = torch.where(low, a, a.mT)                      # the lower triangle, as eigh reads it
    a = torch.nn.functional.pad(a, (0, m - n, 0, m - n))
    V = torch.eye(m, dtype=dt, device=dev).expand(B, m, m).clone()
    diag = torch.eye(m, dtype=torch.bool, device=dev)
    eps = torch.finfo(dt).eps
    tol2 = (eps * eps) * (a * a).sum(dim=(-2, -1))
    done = _off2(a, diag) <= tol2
    sweeps = torch.zeros(B, dtype=torch.int32, device=dev)
    P, Q = (torch.from_numpy(x).to(dev) for x in round_robin(m))
    for _ in range(MAX_SWEEPS):
        if bool(done.all()):
            break
        a0, V0 = a, V
        a, V = a.clone(), V.clone()
        for p, q in zip(P, Q):
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]
            theta = (aqq - app) / (2 * apq)
            sgn = torch.where(theta >= 0, 1.0, -1.0).to(dt)
            t = sgn / (torch.abs(theta) + torch.sqrt(theta * theta + 1))
            t = torch.where(apq == 0, 0.0, t)
            c = 1 / torch.sqrt(t * t + 1)
            s = t * c
            cr, sr = c[:, :, None], s[:, :, None]          # rows p, q
            ap, aq = a[:, p, :], a[:, q, :]
            a[:, p, :] = cr * ap - sr * aq
            a[:, q, :] = sr * ap + cr * aq
            cc, sc = c[:, None, :], s[:, None, :]          # columns p, q
            ap, aq = a[:, :, p], a[:, :, q]
            a[:, :, p] = cc * ap - sc * aq
            a[:, :, q] = sc * ap + cc * aq
            vp, vq = V[:, :, p], V[:, :, q]
            V[:, :, p] = cc * vp - sc * vq
            V[:, :, q] = sc * vp + cc * vq
            a[:, p, q] = 0.0
            a[:, q, p] = 0.0
        keep = done[:, None, None]
        a, V = torch.where(keep, a0, a), torch.where(keep, V0, V)
        sweeps += (~done).to(torch.int32)
        done = done | (_off2(a, diag) <= tol2)
    w, idx = torch.sort(torch.diagonal(a, dim1=-2, dim2=-1)[:, :n], dim=-1, stable=True)
    V = torch.gather(V[:, :n, :n], 2, idx[:, None, :].expand(B, n, n))
    return w.reshape(*lead, n), V.reshape(*lead, n, n), sweeps.reshape(lead)


def sym_eigh(A: torch.Tensor):
    """Eigenvalues (ascending), eigenvectors (columns) and the sweeps each
    matrix took, of symmetric (..., n, n) float32 / float64 matrices,
    n <= 32: what ``torch.linalg.eigh`` returns, and the sweeps. The
    ``jacobi_eigh`` kernel on a CUDA tensor (one launch, no host read),
    :func:`sym_eigh_plain` on a CPU one."""
    n = _check(A)
    if A.device.type == "cpu":
        return sym_eigh_plain(A)
    lead = A.shape[:-2]
    a = A.reshape(-1, n, n).contiguous()
    B = a.shape[0]
    w = torch.empty((B, n), dtype=A.dtype, device=A.device)
    V = torch.empty((B, n, n), dtype=A.dtype, device=A.device)
    sweeps = torch.empty(B, dtype=torch.int32, device=A.device)
    if B:
        if B > 2**31 - 1:
            raise ValueError(f"sym_eigh: batch {B} too large for one launch")
        lib = load()
        code = lib.uslam_jacobi_eigh(
            0 if A.dtype == torch.float32 else 1, a.data_ptr(), w.data_ptr(), V.data_ptr(),
            sweeps.data_ptr(), B, n, MAX_SWEEPS, stream_of(a),
        )
        raise_on(lib, code, "jacobi_eigh")
        launch_counts["jacobi_eigh"] += 1
    return w.reshape(*lead, n), V.reshape(*lead, n, n), sweeps.reshape(lead)
