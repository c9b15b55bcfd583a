"""Marginal covariances at a solution, GTSAM ``Marginals`` semantics (port
of :mod:`uslam_tpu.solvers.marginals`).

With ``H = [[A, W], [W^T, D]]`` the undamped normal equations over camera
states ``c = [poses(6N) | vels(3N) | bias(6)]`` and landmarks, and
``S = A - W D^-1 W^T`` the reduced camera matrix the solver factors:

- camera marginals are blocks of ``S^-1``, from one multi-column scaled
  Cholesky solve ``S X = E`` (unit columns at the requested rows);
- landmark marginals are ``D_j^-1 + U_j^T S^-1 U_j`` with ``U = W D^-1``,
  the stacks landmark elimination already makes, whose ``S^-1 U_j``
  columns ride the same solve.

The float32 caveat is the solver's: the weak global modes make S
ill-conditioned, so the pipeline recovers marginals in float64.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from uslam_tpu_torch.device import cast_tree, resolve_device
from uslam_tpu_torch.geometry.camera import StereoCamera
from uslam_tpu_torch.graph.builder import GraphArrays
from uslam_tpu_torch.graph.values import BIAS_DIM, LM_DIM, POSE_DIM, VEL_DIM, Values
from uslam_tpu_torch.solvers.bands import assemble_cam_bands, expand_cam_dense
from uslam_tpu_torch.solvers.dense import scaled_cho_solve
from uslam_tpu_torch.solvers.linearize import linearize_graph
from uslam_tpu_torch.solvers.schur import landmark_elimination


class MarginalCovariances(NamedTuple):
    """Requested marginal covariance blocks, in request order. ``pose``
    blocks are over the SE3 retract tangent [rot(3), trans(3)];
    ``vel``/``landmark`` plain R^3; ``bias`` [accel(3), gyro(3)]."""

    pose: torch.Tensor         # (P, 6, 6)
    vel: torch.Tensor          # (V, 3, 3)
    landmark: torch.Tensor     # (L, 3, 3)
    bias: torch.Tensor | None  # (6, 6) or None


def _reduced_system(graph, values, cam, dvl_sigma, stereo_sigma, gravity, jitter, device):
    """(graph, values, cam) on ``device``; the undamped reduced camera
    matrix S, Hll^-1 and U at ``values``; the jitter resolved per float
    type: 1e-7 in float64, 1e-5 in float32, where the undamped system's
    weak modes sit below Cholesky roundoff (the JAX package's rule)."""
    dev = resolve_device(device)
    dtype = values.pose_trans.dtype
    graph, values, cam = (cast_tree(t, dtype, dev) for t in (graph, values, cam))
    if jitter is None:
        jitter = 1e-7 if dtype == torch.float64 else 1e-5
    n = values.num_poses
    lin = linearize_graph(graph, values, cam, dvl_sigma, stereo_sigma, gravity)
    # damping 0: both helpers keep their 1e-8 diagonal floor, ~1e-14
    # relative on these whitened systems.
    Hll_inv, _g_l, U, V = landmark_elimination(lin, graph.stereo, n, 0.0)
    S, _g = expand_cam_dense(assemble_cam_bands(lin, graph.stereo, n, 0.0), pp_extra=-(U @ V.T))
    return S, Hll_inv, U, jitter


def _unit_columns(Dc: int, off: int, d: int, like: torch.Tensor) -> torch.Tensor:
    E = like.new_zeros((Dc, d))
    E[off : off + d].fill_diagonal_(1.0)
    return E


def marginal_covariances(
    graph: GraphArrays,
    values: Values,
    cam: StereoCamera,
    dvl_sigma: float,
    stereo_sigma: float,
    gravity: float,
    pose_indices: Sequence[int] = (),
    vel_indices: Sequence[int] = (),
    landmark_indices: Sequence[int] = (),
    include_bias: bool = False,
    jitter: float | None = None,
    refine_iters: int = 4,
    *,
    device="cuda",
) -> MarginalCovariances:
    """Marginal covariances of selected states at ``values`` (a converged
    estimate), computed on ``device`` in the float type of ``values``."""
    S, Hll_inv, U, jitter = _reduced_system(
        graph, values, cam, dvl_sigma, stereo_sigma, gravity, jitter, device
    )
    n = values.num_poses
    pose_total = POSE_DIM * n
    Dc = S.shape[0]

    cols = [_unit_columns(Dc, POSE_DIM * int(i), POSE_DIM, S) for i in pose_indices]
    cols += [_unit_columns(Dc, pose_total + VEL_DIM * int(i), VEL_DIM, S) for i in vel_indices]
    if include_bias:
        cols.append(_unit_columns(Dc, pose_total + VEL_DIM * n, BIAS_DIM, S))
    # S^-1 U_j needs U_j zero-padded onto the camera layout (W couples
    # landmarks to poses only).
    U_cols = [U[:, LM_DIM * int(j) : LM_DIM * int(j) + LM_DIM] for j in landmark_indices]
    cols += [torch.cat([Uj, S.new_zeros((Dc - pose_total, LM_DIM))]) for Uj in U_cols]

    def empty(d):
        return S.new_zeros((0, d, d))

    if not cols:
        return MarginalCovariances(empty(POSE_DIM), empty(VEL_DIM), empty(LM_DIM), None)
    X = scaled_cho_solve(S, torch.cat(cols, dim=1), refine_iters, jitter)

    off = 0
    pose_blocks, vel_blocks, lm_blocks, bias_block = [], [], [], None
    for i in pose_indices:
        r0 = POSE_DIM * int(i)
        pose_blocks.append(X[r0 : r0 + POSE_DIM, off : off + POSE_DIM])
        off += POSE_DIM
    for i in vel_indices:
        r0 = pose_total + VEL_DIM * int(i)
        vel_blocks.append(X[r0 : r0 + VEL_DIM, off : off + VEL_DIM])
        off += VEL_DIM
    if include_bias:
        r0 = pose_total + VEL_DIM * n
        bias_block = X[r0 : r0 + BIAS_DIM, off : off + BIAS_DIM]
        off += BIAS_DIM
    for j, Uj in zip(landmark_indices, U_cols):
        lm_blocks.append(Hll_inv[int(j)] + Uj.T @ X[:pose_total, off : off + LM_DIM])
        off += LM_DIM

    def stack(blocks, d):
        return torch.stack(blocks) if blocks else empty(d)

    def symm(A):
        return 0.5 * (A + A.transpose(-1, -2))

    return MarginalCovariances(
        pose=symm(stack(pose_blocks, POSE_DIM)),
        vel=symm(stack(vel_blocks, VEL_DIM)),
        landmark=symm(stack(lm_blocks, LM_DIM)),
        bias=None if bias_block is None else symm(bias_block),
    )


def joint_marginal_covariance(
    graph: GraphArrays,
    values: Values,
    cam: StereoCamera,
    dvl_sigma: float,
    stereo_sigma: float,
    gravity: float,
    keys: Sequence[tuple],
    jitter: float | None = None,
    refine_iters: int = 4,
    *,
    device="cuda",
) -> torch.Tensor:
    """Joint covariance over a set of states (GTSAM
    ``Marginals::jointMarginalCovariance``). ``keys``: ``("pose", i)``,
    ``("vel", i)``, ``("bias",)``, ``("landmark", j)``; returns the dense
    (D, D) covariance over the concatenated tangents in request order, from

        H^-1 = [[S^-1,         -S^-1 U          ],
                [-U^T S^-1,    D^-1 + U^T S^-1 U]],   U = W D^-1,

    every block riding one multi-column solve against S."""
    S, Hll_inv, U, jitter = _reduced_system(
        graph, values, cam, dvl_sigma, stereo_sigma, gravity, jitter, device
    )
    n = values.num_poses
    pose_total = POSE_DIM * n
    Dc = S.shape[0]

    def key_info(k):
        """(kind, camera-layout row offset or landmark index, tangent dim)."""
        if k[0] == "pose":
            return ("cam", POSE_DIM * int(k[1]), POSE_DIM)
        if k[0] == "vel":
            return ("cam", pose_total + VEL_DIM * int(k[1]), VEL_DIM)
        if k[0] == "bias":
            return ("cam", pose_total + VEL_DIM * n, BIAS_DIM)
        if k[0] == "landmark":
            return ("lm", int(k[1]), LM_DIM)
        raise ValueError(f"unknown marginal key kind {k[0]!r}")

    infos = [key_info(k) for k in keys]

    def U_of(j):
        return U[:, LM_DIM * j : LM_DIM * j + LM_DIM]

    cols = [
        _unit_columns(Dc, off, d, S) if kind == "cam"
        else torch.cat([U_of(off), S.new_zeros((Dc - pose_total, LM_DIM))])
        for kind, off, d in infos
    ]
    X = scaled_cho_solve(S, torch.cat(cols, dim=1), refine_iters, jitter)
    col_offs = np.concatenate([[0], np.cumsum([d for _, _, d in infos])]).astype(int)

    rows_out = []
    for kind_a, off_a, da in infos:
        row_blocks = []
        for b, (kind_b, off_b, db) in enumerate(infos):
            Xb = X[:, col_offs[b] : col_offs[b] + db]
            if kind_a == "cam":
                blk = Xb[off_a : off_a + da]
                if kind_b == "lm":
                    blk = -blk                          # top-right: -S^-1 U
            else:
                blk = U_of(off_a).T @ Xb[:pose_total]
                if kind_b == "cam":
                    blk = -blk                          # bottom-left: -U^T S^-1
                elif off_a == off_b:
                    blk = blk + Hll_inv[off_a]          # + D^-1 on the diagonal
            row_blocks.append(blk)
        rows_out.append(torch.cat(row_blocks, dim=1))
    J = torch.cat(rows_out, dim=0)
    return 0.5 * (J + J.T)


def marginal_sigmas(cov_blocks: torch.Tensor) -> np.ndarray:
    """Per-axis marginal standard deviations of stacked covariance blocks."""
    d = torch.diagonal(cov_blocks, dim1=-2, dim2=-1).detach().cpu().numpy()
    return np.sqrt(np.maximum(d, 0.0))
