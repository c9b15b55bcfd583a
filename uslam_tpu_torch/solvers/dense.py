"""Dense normal equations and the Jacobi-scaled Cholesky solve.

Port of :mod:`uslam_tpu.solvers.dense`. Assembly scatters every factor's
J^T J and -J^T r blocks into one dense (H, g) with ``index_put_(...,
accumulate=True)``, an atomic add on the GPU. The factorization is
``torch.linalg.cholesky_ex`` plus ``solve_triangular``, where the JAX
package used XLA's.

Tangent layout (graph/values.py): [frame_0(9) ... frame_{N-1}(9) | bias(6) |
lm_0(3) ...]; each frame block is [pose(6), vel(3)].
"""

from __future__ import annotations

import torch

from uslam_tpu_torch.graph.values import BIAS_DIM, FRAME_DIM, LM_DIM, POSE_DIM, VEL_DIM
from uslam_tpu_torch.solvers.linearize import Linearization


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of batched 3x3 matrices (..., 3, 3)
    plus one Newton step X <- X (2I - A X), which squares the cofactor
    form's ~2e-4 relative f32 residual to ~1e-7 (the JAX package's
    docstring measures why that matters for LM step quality). Operands are
    damped SPD landmark blocks; a padded landmark's block is 1e-8 I
    (det 1e-24, representable in f32)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    C00 = e * i - f * h
    C01 = c * h - b * i
    C02 = b * f - c * e
    C10 = f * g - d * i
    C11 = a * i - c * g
    C12 = c * d - a * f
    C20 = d * h - e * g
    C21 = b * g - a * h
    C22 = a * e - b * d
    det = a * C00 + b * C10 + c * C20
    adj = torch.stack(
        [
            torch.stack([C00, C01, C02], -1),
            torch.stack([C10, C11, C12], -1),
            torch.stack([C20, C21, C22], -1),
        ],
        -2,
    )
    X = adj / det[..., None, None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    return X @ (2.0 * eye - A @ X)


def _block_rows(off: torch.Tensor, d: int) -> torch.Tensor:
    """(F,) offsets + block dim -> (F, d) row indices."""
    return off[:, None] + torch.arange(d, device=off.device)[None, :]


def scatter_H(H, off_a, off_b, blocks) -> None:
    """H[off_a:off_a+da, off_b:off_b+db] += blocks in place, batched over
    factors; off_a/off_b (F,), blocks (F, da, db)."""
    da, db = blocks.shape[-2], blocks.shape[-1]
    rows = _block_rows(off_a, da)[:, :, None].expand(blocks.shape)
    cols = _block_rows(off_b, db)[:, None, :].expand(blocks.shape)
    H.index_put_((rows, cols), blocks, accumulate=True)


def scatter_g(g, off, vecs) -> None:
    """g[off:off+d] += vecs in place, batched; off (F,), vecs (F, d)."""
    g.index_put_((_block_rows(off, vecs.shape[-1]),), vecs, accumulate=True)


def _jtj(Ja, Jb):
    return torch.einsum("fda,fdb->fab", Ja, Jb)


def _jtr(J, r):
    return -torch.einsum("fda,fd->fa", J, r)


def assemble_dense(lin: Linearization, num_poses: int, num_landmarks: int):
    """(H, g, lm_base) = (J^T J, -J^T r, landmark offset) over the full
    tangent space, without the stereo factors."""
    n, m = num_poses, num_landmarks
    D = FRAME_DIM * n + BIAS_DIM + LM_DIM * m
    bias_off = FRAME_DIM * n
    lm_base = FRAME_DIM * n + BIAS_DIM
    r = lin.stereo_r
    H = r.new_zeros((D, D))
    g = r.new_zeros(D)

    def add_single(off, J, res):
        d = J.shape[-1]
        H[off : off + d, off : off + d] += J.T @ J
        g[off : off + d] += -J.T @ res

    add_single(0, lin.prior_pose_J, lin.prior_pose_r)
    add_single(POSE_DIM, lin.prior_vel_J, lin.prior_vel_r)
    add_single(bias_off, lin.prior_bias_J, lin.prior_bias_r)

    # Dense marginal prior on [pose_0(6), vel_0(3), bias(6)].
    Jm, rm = lin.marg_J, lin.marg_r
    offs = (0, POSE_DIM, bias_off)
    dims = (POSE_DIM, VEL_DIM, BIAS_DIM)
    col0 = (0, POSE_DIM, POSE_DIM + VEL_DIM)
    for a in range(3):
        Ja = Jm[:, col0[a] : col0[a] + dims[a]]
        g[offs[a] : offs[a] + dims[a]] += -Ja.T @ rm
        for b in range(3):
            Jb = Jm[:, col0[b] : col0[b] + dims[b]]
            H[offs[a] : offs[a] + dims[a], offs[b] : offs[b] + dims[b]] += Ja.T @ Jb

    # IMU: interval k couples frames (k, k+1) and the bias.
    k = torch.arange(lin.imu_r.shape[0], device=r.device)
    blocks = [
        (FRAME_DIM * k, lin.imu_J_pose_i),
        (FRAME_DIM * k + POSE_DIM, lin.imu_J_vel_i),
        (FRAME_DIM * (k + 1), lin.imu_J_pose_j),
        (FRAME_DIM * (k + 1) + POSE_DIM, lin.imu_J_vel_j),
        (torch.full_like(k, bias_off), lin.imu_J_bias),
    ]
    for off_a, Ja in blocks:
        scatter_g(g, off_a, _jtr(Ja, lin.imu_r))
        for off_b, Jb in blocks:
            scatter_H(H, off_a, off_b, _jtj(Ja, Jb))

    # DVL: per frame (pose, vel).
    i = torch.arange(lin.dvl_r.shape[0], device=r.device)
    blocks = [(FRAME_DIM * i, lin.dvl_J_pose), (FRAME_DIM * i + POSE_DIM, lin.dvl_J_vel)]
    for off_a, Ja in blocks:
        scatter_g(g, off_a, _jtr(Ja, lin.dvl_r))
        for off_b, Jb in blocks:
            scatter_H(H, off_a, off_b, _jtj(Ja, Jb))
    return H, g, lm_base


def assemble_dense_with_landmarks(
    lin: Linearization, cam_idx, lm_idx, num_poses: int, num_landmarks: int
):
    """Full dense (H, g) including the stereo factors and landmark blocks."""
    H, g, lm_base = assemble_dense(lin, num_poses, num_landmarks)
    blocks = [
        (FRAME_DIM * cam_idx.long(), lin.stereo_J_pose),
        (lm_base + LM_DIM * lm_idx.long(), lin.stereo_J_lm),
    ]
    for off_a, Ja in blocks:
        scatter_g(g, off_a, _jtr(Ja, lin.stereo_r))
        for off_b, Jb in blocks:
            scatter_H(H, off_a, off_b, _jtj(Ja, Jb))
    return H, g


def _add_diag(H: torch.Tensor, v) -> torch.Tensor:
    """H + v*I (v scalar or (D,)), out of place."""
    out = H.clone()
    out.diagonal().add_(v)
    return out


def cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of A. A failed factorization does not raise:
    like XLA's, it yields NaN, which the LM loop rejects as a non-finite
    step (no host sync here)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def scaled_cho_solve(
    H: torch.Tensor, g: torch.Tensor, refine_iters: int = 4, jitter: float = 1e-7
) -> torch.Tensor:
    """Cholesky solve of D^-1/2 H D^-1/2 (unit diagonal, so every f32 pivot
    is O(1)) with a relative jitter, then Richardson refinement against the
    unjittered scaled system (see the JAX package's docstring for why these
    defaults). ``g`` is one right-hand side (D,) or several (D, K)."""
    d_inv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-20))
    Hs = H * d_inv[:, None] * d_inv[None, :]
    L = cholesky_or_nan(_add_diag(Hs, jitter))

    def tri_solve(b):
        y = torch.linalg.solve_triangular(L, b, upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True)

    bs = (g if g.ndim == 2 else g[:, None]) * d_inv[:, None]
    x = tri_solve(bs)
    for _ in range(refine_iters):
        x = x + tri_solve(bs - Hs @ x)
    x = x * d_inv[:, None]
    return x if g.ndim == 2 else x[:, 0]


def solve_dense_gn(
    H: torch.Tensor,
    g: torch.Tensor,
    damping=0.0,
    refine_iters: int = 4,
    jitter: float = 1e-7,
    diag_damping: bool = False,
) -> torch.Tensor:
    """Solve (H + lambda I) delta = g, or (H + lambda diag(H)) with
    ``diag_damping`` (Marquardt), by the scaled Cholesky. A 1e-8 diagonal
    floor keeps masked padding rows nonsingular. ``damping`` is a number or
    a 0-d tensor (the LM's lambda on the device); lambda + 1e-8 is summed in
    float64 either way and rounded once to H's type."""
    if diag_damping:
        damp = damping * torch.diagonal(H) + 1e-8
    else:
        damp = (damping.double() if isinstance(damping, torch.Tensor) else damping) + 1e-8
    return scaled_cho_solve(_add_diag(H, damp), g, refine_iters, jitter)
