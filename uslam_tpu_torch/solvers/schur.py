"""Schur complement over landmarks, velocity elimination and the reduced
camera solve (port of :mod:`uslam_tpu.solvers.schur`).

Every landmark (a 3x3 block) is eliminated onto the camera system, the
reduced system is solved by the Jacobi-scaled Cholesky (or CG), and the
landmarks are back-substituted. With ``eliminate_velocities`` the
velocity chain is eliminated too, so the Cholesky that remains is over
poses and bias only, 6N+6 instead of 9N+6.

Landmark-grouped quantities are gathers of the per-observation arrays
(``lm_obs_idx``/``lm_obs_mask``, padded to K; padded slots carry zero
Jacobians). The coupling blocks go into the (6N, 3M) operands U, V of the
one correction product U V^T by ``index_add_`` over (camera, landmark)
rows, where the JAX package used a one-hot matmul. Accumulating matters:
a padded slot points at observation 0's camera, and a plain indexed
assignment would let its zero block overwrite a real one. A row gets at
most one real block (a landmark is seen once per frame) plus zero blocks,
so the float atomics of ``index_add_`` on the GPU give the same sum in any
order.

Precision: :func:`solve_schur` eliminates and solves in float64 whatever
the linearization's type, and returns the step in that type. The JAX
package runs it in float32 (its TPU has no float64), and there it fails on
landmarks seen by one camera: such a landmark's correction W Hll^-1 W^T
cancels the camera's stereo block Jp^T Jp up to the damping, the float32
difference keeps rounding noise of the size of that block, and the
refinement of the reduced Cholesky cannot remove it, because it refines
against the same reduced matrix. The dense solve is spared: it refines
against the full matrix. On such graphs a float32 Schur LM stops far above
the dense one. tests/test_torch_single_obs.py and chip_smoke.py hold the
float32-input step to the float64 dense step. Products run without TF32
(checked by the pipeline).

Sharded over landmarks (``group``, :mod:`uslam_tpu_torch.parallel.mesh`):
each rank eliminates its contiguous slice of the landmark grouping, one
all-reduce sums the corrections H_corr and g_corr, the reduced solve runs
on every rank, and one all-gather collects the landmark delta.
"""

from __future__ import annotations

import torch

from uslam_tpu_torch.collectives import all_gather_rows, all_reduce_sum
from uslam_tpu_torch.device import cast_tree
from uslam_tpu_torch.graph.builder import StereoObservations
from uslam_tpu_torch.graph.values import BIAS_DIM, LM_DIM, POSE_DIM, VEL_DIM
from uslam_tpu_torch.solvers import compiled
from uslam_tpu_torch.solvers.bands import (
    CamBands,
    assemble_cam_bands,
    band_dense,
    damping_scalars,
    expand_cam_dense,
)
from uslam_tpu_torch.solvers.dense import cholesky_or_nan, inv3x3, scaled_cho_solve
from uslam_tpu_torch.solvers.linearize import Linearization

# CG iterations between two host reads of the stopping test.
CG_BLOCK = 16


def landmark_elimination(
    lin: Linearization, stereo: StereoObservations, n: int, damping,
    diag_damping: bool = False,
):
    """Returns (Hll_inv (M,3,3), g_l (M,3), U (6N,3M), V (6N,3M)) with
    U = stacked W Hll^-1 and V = stacked W, W the pose-landmark coupling."""
    Jp, Jl, r = lin.stereo_J_pose, lin.stereo_J_lm, lin.stereo_r
    lam, lam_floor = damping_scalars(damping, r.dtype)
    m, K = stereo.lm_obs_idx.shape
    idx = stereo.lm_obs_idx.long()
    mask = stereo.lm_obs_mask

    Jp_g = Jp[idx] * mask[..., None, None]                # (M,K,3,6)
    Jl_g = Jl[idx] * mask[..., None, None]                # (M,K,3,3)
    r_g = r[idx] * mask[..., None]

    Hll = torch.einsum("mkda,mkdb->mab", Jl_g, Jl_g)
    g_l = -torch.einsum("mkda,mkd->ma", Jl_g, r_g)
    # Damped 3x3 inverses; the 1e-8 floor keeps padded landmarks invertible.
    eye3 = torch.eye(LM_DIM, dtype=r.dtype, device=r.device)
    if diag_damping:
        Hll_inv = inv3x3(Hll + (lam * Hll) * eye3 + 1e-8 * eye3)
    else:
        Hll_inv = inv3x3(Hll + lam_floor * eye3)

    W = torch.einsum("mkda,mkdb->mkab", Jp_g, Jl_g)       # (M,K,6,3)
    Y = torch.einsum("mkab,mbc->mkac", W, Hll_inv)        # (M,K,6,3)

    # Row (camera, landmark) of a flat (N*M, 36) stack of [Y | W] blocks.
    cam_g = stereo.cam_idx.long()[idx]                    # (M,K)
    rows = cam_g * m + torch.arange(m, device=r.device)[:, None]
    YW = torch.cat([Y.reshape(m, K, 18), W.reshape(m, K, 18)], dim=-1)
    stacked = YW.new_zeros((n * m, 36)).index_add_(
        0, rows.reshape(-1), YW.reshape(m * K, 36)
    ).reshape(n, m, 36)

    def to_flat(x):                                       # (N,M,18) -> (6N,3M)
        return (
            x.reshape(n, m, POSE_DIM, LM_DIM)
            .permute(0, 2, 1, 3)
            .reshape(n * POSE_DIM, m * LM_DIM)
        )

    return Hll_inv, g_l, to_flat(stacked[..., :18]), to_flat(stacked[..., 18:])


def solve_schur(
    lin: Linearization,
    stereo: StereoObservations,
    num_poses: int,
    num_landmarks: int,
    damping,
    cg: bool = False,
    cg_iters: int = 200,
    cg_tol: float = 1e-8,
    return_aux: bool = False,
    refine_iters: int = 4,
    jitter: float = 1e-7,
    diag_damping: bool = False,
    eliminate_velocities: bool = False,
    check=None,
    group=None,
):
    """Solve the damped normal equations; returns delta over the global
    tangent layout [frames(9N), bias(6), landmarks(3M)].

    With ``return_aux`` also returns g.delta, the gradient-step inner
    product of the 0.5||r||^2 objective (damping never enters g).
    ``eliminate_velocities`` (ignored with ``cg``) eliminates the velocity
    chain before the reduced factorization (:func:`_solve_vel_eliminated`).
    The work runs in float64 (module docstring); delta and g.delta come back
    in the linearization's type. ``check`` (the LM's ``debug_nans``) is
    called on the landmark Schur reduction and on the reduced solve.

    ``group`` (a ``torch.distributed`` process group, the JAX package's
    ``axis_name``): ``stereo.lm_obs_idx``/``lm_obs_mask`` hold this rank's
    contiguous slice of the landmarks, in rank order, and every other input
    is the same on every rank; H_corr, g_corr and the landmark part of
    g.delta are summed over the group and the landmark delta is gathered,
    so every rank returns the whole delta."""
    out_dtype = lin.stereo_r.dtype
    if out_dtype != torch.float64:
        delta = solve_schur(
            cast_tree(lin, torch.float64, lin.stereo_r.device),
            cast_tree(stereo, torch.float64, lin.stereo_r.device),
            num_poses, num_landmarks, damping, cg=cg, cg_iters=cg_iters, cg_tol=cg_tol,
            return_aux=return_aux, refine_iters=refine_iters, jitter=jitter,
            diag_damping=diag_damping, eliminate_velocities=eliminate_velocities,
            check=check, group=group,
        )
        if return_aux:
            return delta[0].to(out_dtype), delta[1].to(out_dtype)
        return delta.to(out_dtype)
    n = num_poses
    pose_total = POSE_DIM * n

    Hll_inv, g_l, U, V = landmark_elimination(lin, stereo, n, damping, diag_damping)
    m = g_l.shape[0]                                      # this rank's landmarks
    bands = assemble_cam_bands(lin, stereo, n, damping, diag_damping)
    # The step's collectives: these two sums, and the sum and gather of
    # back_substitute. Nothing between them reads the host, so a CUDA graph
    # holds them (the sharded LM's block of steps). The CG's WHILE node below
    # holds none: H_corr is summed before it.
    H_corr = all_reduce_sum(U @ V.T, group)               # (6N, 6N)
    g_corr = all_reduce_sum(U @ g_l.reshape(-1), group)   # (6N,)
    if check:
        check("landmark Schur", Hll_inv, g_l, H_corr, g_corr)

    def back_substitute(dpose):
        """dl = Hll^-1 (g_l - V^T dpose) on this rank's landmarks; returns
        (every rank's dl in rank order, g.delta over the landmarks or None
        without ``return_aux``)."""
        rhs = g_l - (V.T @ dpose).reshape(m, LM_DIM)
        dl = torch.einsum("mab,mb->ma", Hll_inv, rhs)
        g_dot_l = all_reduce_sum(torch.sum(g_l * dl), group) if return_aux else None
        return all_gather_rows(dl, group), g_dot_l

    if eliminate_velocities and not cg:
        dpose, dvel, dbias, g_dot_cam = _solve_vel_eliminated(
            bands, H_corr, g_corr, n, refine_iters, jitter, check
        )
        delta_l, g_dot_l = back_substitute(dpose)
        frames = torch.cat([dpose.reshape(n, POSE_DIM), dvel], dim=1)
        delta = torch.cat([frames.reshape(-1), dbias, delta_l.reshape(-1)])
        if return_aux:
            return delta, g_dot_cam + g_dot_l
        return delta

    H_red, g_c_raw = expand_cam_dense(bands, pp_extra=-H_corr)
    g_c = torch.cat([g_c_raw[:pose_total] - g_corr, g_c_raw[pose_total:]])
    if cg:
        delta_perm = _cg_solve(H_red, g_c, cg_iters, cg_tol)
    else:
        delta_perm = scaled_cho_solve(H_red, g_c, refine_iters, jitter)
    if check:
        check("reduced solve", delta_perm)

    dpose = delta_perm[:pose_total]
    delta_l, g_dot_l = back_substitute(dpose)
    # Camera delta back to the interleaved frame layout.
    dvel = delta_perm[pose_total : pose_total + VEL_DIM * n].reshape(n, VEL_DIM)
    frames = torch.cat([dpose.reshape(n, POSE_DIM), dvel], dim=1)
    delta_c = torch.cat([frames.reshape(-1), delta_perm[pose_total + VEL_DIM * n :]])
    delta = torch.cat([delta_c, delta_l.reshape(-1)])
    if return_aux:
        return delta, g_c_raw @ delta_perm + g_dot_l
    return delta


def _solve_vel_eliminated(
    b: CamBands, H_corr: torch.Tensor, g_corr: torch.Tensor, n: int,
    refine_iters: int, jitter: float, check=None,
):
    """Eliminate the velocity chain, solve the (6N+6) pose+bias system,
    back-substitute the velocities.

    The block-tridiagonal velocity block Avv is factored densely after
    Jacobi scaling, G = L^-1 [Avp | Avb | gv] is one wide triangular solve,
    and every elimination correction comes from one product G^T G.

    Returns (dpose (6N,), dvel (N,3), dbias (6,), g.delta over the camera
    variables with the raw gradients)."""
    pose_total = POSE_DIM * n
    vel_total = VEL_DIM * n

    # Avp rows (3N, 6N): [v_k,p_k] = pv_d^T, [v_k,p_{k+1}] = pv_sub^T,
    # [v_{k+1},p_k] = pv_sup^T.
    Avp = band_dense(
        b.pv_d.transpose(1, 2), b.pv_sub.transpose(1, 2), b.pv_sup.transpose(1, 2)
    )
    R = torch.cat(
        [Avp, b.vb.reshape(vel_total, BIAS_DIM), b.gv.reshape(vel_total, 1)], dim=1
    )                                                     # (3N, 6N+7)
    Avv = band_dense(b.vv_d, b.vv_o, b.vv_o.transpose(1, 2))
    dv_inv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Avv), min=1e-20))
    Avv_s = Avv * dv_inv[:, None] * dv_inv[None, :]
    # The velocity solve has no refinement, so any jitter is a real bias:
    # apply it only in the no-floor regime (jitter >= 1e-7 by the LM's
    # rule), scaled by the float type's eps so float64 stays exact to
    # rounding (the JAX package's rule, kept exactly).
    eps_ratio = torch.finfo(Avv.dtype).eps / torch.finfo(torch.float32).eps
    avv_jitter = jitter if jitter >= 1e-7 else 0.0
    Avv_s = Avv_s + (avv_jitter * eps_ratio) * torch.eye(
        vel_total, dtype=Avv.dtype, device=Avv.device
    )
    L = cholesky_or_nan(Avv_s)

    G = torch.linalg.solve_triangular(L, R * dv_inv[:, None], upper=False)
    corr = G.T @ G                                        # over [poses | bias | g]

    Hpp = (
        band_dense(b.pp_d, b.pp_o, b.pp_o.transpose(1, 2))
        - H_corr
        - corr[:pose_total, :pose_total]
    )
    Hpb = b.pb.reshape(pose_total, BIAS_DIM) - corr[:pose_total, pose_total:-1]
    Hbb = b.bb - corr[pose_total:-1, pose_total:-1]
    g_p = b.gp.reshape(-1) - g_corr - corr[:pose_total, -1]
    g_b = b.gb - corr[pose_total:-1, -1]

    H_red = torch.cat(
        [torch.cat([Hpp, Hpb], dim=1), torch.cat([Hpb.T, Hbb], dim=1)], dim=0
    )
    sol = scaled_cho_solve(H_red, torch.cat([g_p, g_b]), refine_iters, jitter)
    if check:
        check("reduced solve", sol)
    dpose, dbias = sol[:pose_total], sol[pose_total:]

    # dv = Avv^-1 (gv - Avp dp - Avb db): the forward solves of all three
    # terms are columns of G, so only the backward substitution remains.
    y = G[:, -1] - G[:, :pose_total] @ dpose - G[:, pose_total:-1] @ dbias
    dvel = (
        torch.linalg.solve_triangular(L.T, y[:, None], upper=True)[:, 0] * dv_inv
    ).reshape(n, VEL_DIM)
    g_dot = b.gp.reshape(-1) @ dpose + torch.sum(b.gv * dvel) + b.gb @ dbias
    return dpose, dvel, dbias, g_dot


def _cg_solve(A: torch.Tensor, b: torch.Tensor, iters: int, tol: float) -> torch.Tensor:
    """CG on the symmetrically Jacobi-scaled system (D^-1/2 A D^-1/2) y =
    D^-1/2 b, x = D^-1/2 y, with the JAX package's stopping rule: iterate
    while it < iters and rr > tol^2 ||b||^2.

    Inside a CUDA graph's capture (the LM's) the loop is the JAX package's
    ``lax.while_loop``, a WHILE node
    (:func:`uslam_tpu_torch.solvers.compiled.while_loop`) whose body is one
    iteration, its test a :class:`~uslam_tpu_torch.solvers.compiled.Test`
    that the condition kernel computes (one kernel node). Eagerly,
    iterations run in blocks of ``CG_BLOCK``: inside a block an iteration
    whose stopping test holds leaves the state as it is (``torch.where``),
    and the host reads the test once per block, so the result is the JAX
    loop's, bit for bit the same as the graph's, with one sync per block
    instead of one per iteration. Either way the iterations
    run are counted in ``compiled.runs["cg"]``."""
    d_inv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-20))
    As = A * d_inv[:, None] * d_inv[None, :]
    bs = b * d_inv
    rr = bs @ bs
    thresh = tol * tol * torch.clamp(rr, min=1e-30)
    tiny = torch.full((), 1e-30, dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    def going(state):
        _, _, _, rr, it = state
        return compiled.Test(it, iters, rr, thresh)

    def iteration(state):
        x, r, p, rr, it = state
        Ap = As @ p
        pAp = p @ Ap
        alpha = torch.where(pAp > 1e-30, rr / torch.maximum(pAp, tiny), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = r @ r
        beta = torch.where(rr > 1e-30, rr_new / torch.maximum(rr, tiny), zero)
        return x, r, r + beta * p, rr_new, it + 1

    state = (torch.zeros_like(bs), bs, bs, rr, torch.zeros((), dtype=torch.int64, device=b.device))
    if compiled.capturing():
        return compiled.while_loop(going, iteration, state, name="cg")[0] * d_inv
    done = 0
    for _ in range(-(-iters // CG_BLOCK)):
        for _ in range(CG_BLOCK):
            active = going(state).flag()
            state = tuple(torch.where(active, new, old)
                          for new, old in zip(iteration(state), state))
        go, done = torch.stack([going(state).flag().long(), state[4]]).tolist()
        if not go:
            break
    compiled.count_runs("cg", done)
    return state[0] * d_inv
