"""Large-N reduced camera solve without a dense (6N)^2 matrix (port of
:mod:`uslam_tpu.solvers.banded`).

The Schur solver (solvers/schur.py) factors the reduced camera system
densely: (6N+6)^2 float64 entries, 4.6 GB per copy at N = 4000, and the
solve keeps several copies alive. When every landmark track spans at most
W frames (surveys and transects, where a feature leaves the view within
seconds), the same damped normal equations are block-banded:

- in frame-major layout (x_k = [pose_k(6), vel_k(3)], the bias as a
  6-wide border) the camera system has half-bandwidth W frames: IMU
  couples (k, k+1), DVL and priors are diagonal, and the landmark Schur
  correction couples only frames that co-observe a landmark;
- cut into panels of P >= W frames, the band is block-tridiagonal: one
  dense (9P)^2 diagonal block and one super-diagonal block per panel;
- a blocked Thomas factorization (a Python loop over the N/P panels, one
  triangular solve, one GEMM and one Cholesky per step) solves it in
  O(N P^2) memory;
- the bias border is eliminated by solving 7 right-hand sides at once
  ([g | bias columns]) and a 6x6 Schur complement;
- symmetric Jacobi scaling, PD jitter and iterative refinement with the
  factor reused across passes, as in the JAX package, but for one thing:
  the refinement takes its residuals against the scaled system without
  the jitter, as the Schur and dense solves do (``scaled_cho_solve``), so
  it removes the jitter's bias. The JAX package adds the jitter to the band
  and refines against that, which keeps the bias: on the float64 test
  survey (tests/test_torch_banded.py) its step is off the dense step by
  1.4e-4 relative at the LM's settings (lambda 1e-5, jitter 1e-8) and by
  9.3e-7 at the polish's (lambda 1e-7, jitter 1e-12). With a jitter small
  enough not to matter the two agree to 1e-9.

Precision: like :func:`uslam_tpu_torch.solvers.schur.solve_schur`,
:func:`solve_schur_banded` eliminates and solves in float64 whatever the
linearization's type and returns the step in that type (the landmarks are
eliminated the same way, so the float32 failure on landmarks seen once,
tests/test_torch_single_obs.py, would apply here too).

Layouts: the JAX package places the band into panels by shear reshapes and
sums per-frame blocks by one-hot matmuls (scatter-free TPU shapes). The
port keeps the math: panels are gathered by index, the windowed landmark
correction is added chunk by chunk with ``index_add_`` over distinct rows
(so each call adds every entry once and two calls end bit-identical), and
the pairwise fallback sums per frame by
:func:`uslam_tpu_torch.solvers.bands.frame_sum` (JAX's
``_chunked_frame_sum``), in a fixed order for the same reason. A failed
panel Cholesky raises.

Sharded over landmarks (``group``), as :func:`solve_schur_banded` says:
one all-reduce of the correction band, one all-gather of the landmark
delta.
"""

from __future__ import annotations

import numpy as np
import torch

from uslam_tpu_torch.collectives import all_gather_rows, all_reduce_sum
from uslam_tpu_torch.device import cast_tree
from uslam_tpu_torch.graph.builder import StereoObservations
from uslam_tpu_torch.graph.values import BIAS_DIM, FRAME_DIM, LM_DIM, POSE_DIM
from uslam_tpu_torch.solvers.bands import (
    CamBands,
    assemble_cam_bands,
    damping_scalars,
    frame_sum,
    observed_frames,
)
from uslam_tpu_torch.solvers.dense import inv3x3
from uslam_tpu_torch.solvers.linearize import Linearization


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def measure_band_width(stereo: StereoObservations) -> int:
    """Largest frame span of any landmark's kept observations: the band
    half-width the banded solver needs. Host numpy (one copy off the
    device)."""
    cam = _host(stereo.cam_idx)
    mask = _host(stereo.lm_obs_mask) > 0
    if not mask.any():
        return 1
    cam_g = cam[_host(stereo.lm_obs_idx)]                 # (M, K)
    lo = np.where(mask, cam_g, np.iinfo(np.int32).max).min(axis=1)
    hi = np.where(mask, cam_g, -1).max(axis=1)
    span = int(np.maximum(hi - lo, 0).max())
    return max(span, 1)


def measure_corr_window(stereo: StereoObservations, lm_chunk: int = 128) -> int:
    """Largest frame span (inclusive width) of the observations of any
    ``lm_chunk`` consecutive landmarks: the safe ``corr_window`` for
    :func:`_band_correction`. Sliding, so independent of where chunks
    start. Landmarks are interned in first-appearance order, so this is
    usually far below N; at worst it is N (then windowing is off). Host
    numpy."""
    cam = _host(stereo.cam_idx)
    mask = _host(stereo.lm_obs_mask) > 0
    # int64 BEFORE the where: an int64 sentinel against an int32 cam_g
    # wraps to -1 inside np.where (the dtype stays int32), which makes lo -1
    # for every landmark with a masked slot and the window the whole run.
    cam_g = cam[_host(stereo.lm_obs_idx)].astype(np.int64)
    m = cam_g.shape[0]
    if not mask.any():
        return 1
    big = np.iinfo(np.int64).max
    lo_m = np.where(mask, cam_g, big).min(axis=1)                    # (M,)
    hi_m = np.where(mask, cam_g, -1).max(axis=1)
    w = min(lm_chunk, m)
    lo = np.lib.stride_tricks.sliding_window_view(lo_m, w).min(axis=1)
    hi = np.lib.stride_tricks.sliding_window_view(hi_m, w).max(axis=1)
    valid = (hi >= 0) & (lo < big)
    if not valid.any():
        return 1
    return max(int((hi[valid] - lo[valid]).max()) + 1, 1)


# --------------------------------------------------------------------------
# Landmark elimination pieces
# --------------------------------------------------------------------------


def _landmark_parts(lin: Linearization, stereo: StereoObservations, damping,
                    diag_damping: bool):
    """Per-landmark damped elimination quantities in (M, K) group layout:
    Hll_inv (M,3,3), g_l (M,3), W (M,K,6,3), Y = W Hll_inv (M,K,6,3).
    Padded slots carry zero blocks."""
    Jp, Jl, r = lin.stereo_J_pose, lin.stereo_J_lm, lin.stereo_r
    lam, lam_floor = damping_scalars(damping, r.dtype)
    idx = stereo.lm_obs_idx.long()
    mask = stereo.lm_obs_mask

    Jp_g = Jp[idx] * mask[..., None, None]                # (M,K,3,6)
    Jl_g = Jl[idx] * mask[..., None, None]                # (M,K,3,3)
    r_g = r[idx] * mask[..., None]

    Hll = torch.einsum("mkda,mkdb->mab", Jl_g, Jl_g)
    g_l = -torch.einsum("mkda,mkd->ma", Jl_g, r_g)
    eye3 = torch.eye(LM_DIM, dtype=r.dtype, device=r.device)
    if diag_damping:
        Hll_inv = inv3x3(Hll + (lam * Hll) * eye3 + 1e-8 * eye3)
    else:
        Hll_inv = inv3x3(Hll + lam_floor * eye3)

    W = torch.einsum("mkda,mkdb->mkab", Jp_g, Jl_g)       # (M,K,6,3)
    Y = torch.einsum("mkab,mbc->mkac", W, Hll_inv)        # (M,K,6,3)
    return Hll_inv, g_l, W, Y


def _band_correction(W, Y, g_l, cam_g, obs_mask, n: int, band_w: int,
                     lm_chunk: int = 128, corr_window: int = 0):
    """Landmark Schur correction as (band, gradient), never a dense
    (6N)^2 matrix.

    Returns (B_corr (N, band_w+1, 6, 6) upper band offsets 0..band_w,
    g_corr (N, 6)). B_corr[f, d] sums Y_i W_j^T over the observation pairs
    (i, j) of one landmark with cam_i = f, cam_j = f + d; pairs below the
    diagonal are the transposes (restored at panelization). Pairs with span
    > band_w are dropped, so callers pass band_w >= measure_band_width.

    ``corr_window`` (0 = off): with corr_window >= measure_corr_window(
    stereo, lm_chunk), each chunk of lm_chunk landmarks observes a window
    of F frames starting at its ``base``. A landmark has at most one
    observation per frame, so the pair sum separates,

        B[f, f+d] = sum_m Ytil[m, f] Wtil[m, f+d]^T,

    with Ytil/Wtil the blocks placed on window-local frame rows: one
    (6F x 6F) product per chunk, whose diagonals d in [0, band_w] are read
    by index and added onto rows base..base+F-1.
    The bases are computed on the device, so no chunk reads back to the
    host. 0 = the pairwise placement over every observation pair (always
    safe)."""
    m, K = cam_g.shape
    dtype, dev = W.dtype, W.device
    wp1 = band_w + 1
    X = wp1 * POSE_DIM * POSE_DIM
    B = W.new_zeros((n, X))

    if 0 < corr_window < n:
        F = max(corr_window, wp1)  # the extraction reads wp1 diagonals
        n_chunks = -(-m // lm_chunk)
        pad = n_chunks * lm_chunk - m
        valid = torch.cat([obs_mask > 0, obs_mask.new_zeros((pad, K), dtype=torch.bool)])
        cg = torch.cat([cam_g, cam_g.new_zeros((pad, K))])
        base = torch.where(valid, cg, n).reshape(n_chunks, -1).amin(1)
        base = torch.clamp(base, 0, max(n - F, 0))          # (C,)
        rel = cg - base.repeat_interleave(lm_chunk)[:, None]
        # Masked or (for an undersized window) out-of-window observations
        # go to a discarded slot F, as JAX's one-hot drops them.
        rel = torch.where(valid & (rel < F), rel, F)
        slots = torch.arange(m, device=dev)[:, None] * (F + 1) + rel[:m]
        YW = torch.cat([Y.reshape(m, K, 18), W.reshape(m, K, 18)], dim=-1)
        til = W.new_zeros((n_chunks * lm_chunk * (F + 1), 36)).index_add_(
            0, slots.reshape(-1), YW.reshape(m * K, 36)
        ).reshape(n_chunks, lm_chunk, F + 1, 36)[:, :, :F]
        Ytil = til[..., :18].reshape(n_chunks, lm_chunk, F, POSE_DIM, LM_DIM)
        Wtil = til[..., 18:].reshape(n_chunks, lm_chunk, F, POSE_DIM, LM_DIM)

        g_lp = torch.nn.functional.pad(g_l, (0, 0, 0, pad)).reshape(n_chunks, lm_chunk, LM_DIM)
        qf = torch.einsum("cmfab,cmb->cfa", Ytil, g_lp)   # (C, F, 6)
        g_corr = W.new_zeros((n, POSE_DIM))
        f_ar = torch.arange(F, device=dev)
        d_ar = f_ar[:, None] + torch.arange(wp1, device=dev)   # column f + d of row f

        def flat(t):                                      # (Mc, F, 6, 3) -> (6F, 3 Mc)
            return t.permute(1, 2, 0, 3).reshape(F * POSE_DIM, -1)

        for c in range(n_chunks):
            P = flat(Ytil[c]) @ flat(Wtil[c]).T           # (6F, 6F)
            Pb = P.reshape(F, POSE_DIM, F, POSE_DIM).permute(0, 2, 1, 3).reshape(F, F, 36)
            # Rows with f + d >= F read the band_w zero columns padded on the
            # right; without them row f would wrap into row f+1 when
            # F < 2 band_w (the reference's "a0" bug).
            diags = torch.nn.functional.pad(Pb, (0, 0, 0, band_w))[f_ar[:, None], d_ar]
            rows = base[c] + f_ar
            B.index_add_(0, rows, diags.reshape(F, X))
            g_corr.index_add_(0, rows, qf[c])
        return B.reshape(n, wp1, POSE_DIM, POSE_DIM), g_corr

    # ---- pairwise placement over every observation pair --------------------
    q = torch.einsum("mkab,mb->mka", Y, g_l)              # (M,K,6)
    frames = observed_frames(cam_g, obs_mask, n)         # (M, K)
    g_corr = frame_sum(q.reshape(m * K, POSE_DIM), frames.reshape(-1), n)
    offs = torch.arange(wp1, device=dev)
    for s in range(0, m, lm_chunk):
        Yc, Wc = Y[s : s + lm_chunk], W[s : s + lm_chunk]
        cg, mk = cam_g[s : s + lm_chunk], obs_mask[s : s + lm_chunk]
        C = torch.einsum("mkab,mlcb->mklac", Yc, Wc)      # (Mc,K,K,6,6)
        d = cg[:, None, :] - cg[:, :, None]               # (Mc,K,K) col - row
        pair_ok = (d >= 0) & (d <= band_w) & (mk[:, :, None] > 0) & (mk[:, None, :] > 0)
        oh_d = (d[..., None] == offs).to(dtype) * pair_ok[..., None].to(dtype)
        Cd = torch.einsum(
            "mklx,mkld->mkdx", C.reshape(*C.shape[:3], 36), oh_d
        ).reshape(-1, X)                                  # (Mc*K, X)
        B = B + frame_sum(Cd, frames[s : s + lm_chunk].reshape(-1), n)
    return B.reshape(n, wp1, POSE_DIM, POSE_DIM), g_corr


# --------------------------------------------------------------------------
# Frame-major band and panels
# --------------------------------------------------------------------------


def _frame_band(bands: CamBands, B_corr, g_corr, n: int, band_w: int):
    """CamBands (pose-major pieces) + landmark correction -> frame-major
    9x9 block band.

    Returns (band (N, band_w+1, 9, 9) upper offsets, bias_col (N, 9, 6),
    bb (6,6), g (N, 9), gb (6,)). Offset-0 blocks are whole symmetric
    diagonals; offsets >= 1 are stored once (row frame k, column k+d)."""
    b = bands
    P, V = POSE_DIM, FRAME_DIM
    band = b.pp_d.new_zeros((n, band_w + 1, V, V))
    corr0 = B_corr[:, 0]
    corr0 = 0.5 * (corr0 + corr0.transpose(1, 2))         # numerical symmetry
    band[:, 0, :P, :P] = b.pp_d - corr0
    band[:, 0, :P, P:] = b.pv_d
    band[:, 0, P:, :P] = b.pv_d.transpose(1, 2)
    band[:, 0, P:, P:] = b.vv_d
    band[: n - 1, 1, :P, :P] = b.pp_o
    band[: n - 1, 1, :P, P:] = b.pv_sup
    band[: n - 1, 1, P:, :P] = b.pv_sub.transpose(1, 2)
    band[: n - 1, 1, P:, P:] = b.vv_o
    band[:, 1:, :P, :P] -= B_corr[:, 1:]                  # d >= 1: pose-pose only
    bias_col = torch.cat([b.pb, b.vb], dim=1)             # (N, 9, 6)
    g = torch.cat([b.gp - g_corr, b.gv], dim=1)           # (N, 9)
    return band, bias_col, b.bb, g, b.gb


def _panel_blocks(blocks: torch.Tensor, first_col: int) -> torch.Tensor:
    """blocks (Np, P, wp1, 9, 9) of the padded band -> (Np, P, P, 9, 9)
    whose [j, p, q] is band[j P + p, first_col + q - p] where that offset
    lies in [0, wp1), else zero."""
    P, wp1 = blocks.shape[1], blocks.shape[2]
    ar = torch.arange(P, device=blocks.device)
    d = first_col + ar[None, :] - ar[:, None]             # (P, P)
    inside = (d >= 0) & (d < wp1)
    out = blocks[:, ar[:, None], d.clamp(0, wp1 - 1)]
    return torch.where(inside[None, :, :, None, None], out, 0.0)


def _panelize(band: torch.Tensor, P: int):
    """(N, wp1, 9, 9) upper band -> block-tridiagonal panels: D (Np, 9P, 9P)
    symmetric diagonal blocks, O (Np-1, 9P, 9P) super-diagonal blocks.
    Needs P >= wp1 - 1 (panel >= band_w)."""
    n, wp1 = band.shape[:2]
    Np = -(-n // P)
    blocks = torch.nn.functional.pad(band, (0, 0, 0, 0, 0, 0, 0, Np * P - n)).reshape(
        Np, P, wp1, FRAME_DIM, FRAME_DIM
    )

    def dense(b5):                                        # (k, P, P, 9, 9) -> (k, 9P, 9P)
        return b5.permute(0, 1, 3, 2, 4).reshape(b5.shape[0], P * FRAME_DIM, P * FRAME_DIM)

    Du = _panel_blocks(blocks, 0)
    ar = torch.arange(P, device=band.device)
    strict = (ar[None, :] > ar[:, None])[None, :, :, None, None]
    D = dense(Du + torch.where(strict, Du, 0.0).permute(0, 2, 1, 4, 3))  # mirror
    # O[j, p, q] = band[j P + p, P + q - p]: the offsets reaching panel j+1.
    O = dense(_panel_blocks(blocks[:-1], P))
    return D, O


# --------------------------------------------------------------------------
# Block-tridiagonal factor / apply (panel granularity)
# --------------------------------------------------------------------------


def _raise_on_failed_panels(info: torch.Tensor) -> None:
    """One host read after a sweep: raise if any panel's Cholesky failed."""
    bad = torch.nonzero(info).flatten().tolist()
    if bad:
        raise torch.linalg.LinAlgError(
            f"banded solve: the Cholesky factorization of panel(s) {bad} of "
            f"{info.numel()} failed (Schur-complemented panel not positive definite)"
        )


def block_tridiag_factor(D, O):
    """Thomas forward factorization: the lower Cholesky factors L (Np, d, d)
    of the Schur-complemented diagonal panels t_k = D_k - O_{k-1}^T
    t_{k-1}^-1 O_{k-1}, with u = L_{k-1}^-1 O_{k-1} and t_k = D_k - u^T u
    (one triangular solve, one GEMM, one Cholesky per panel). D must be
    SPD-damped; a failed panel raises after the sweep."""
    L = torch.empty_like(D)
    info = []
    for k in range(D.shape[0]):
        t = D[k]
        if k:
            u = torch.linalg.solve_triangular(L[k - 1], O[k - 1], upper=False)
            t = t - u.T @ u
        L[k], ik = torch.linalg.cholesky_ex(t)
        info.append(ik)
    _raise_on_failed_panels(torch.stack(info))
    return L


def _backward(L, u, O):
    """Backward Thomas sweep: x_k = u_k - t_k^-1 O_k x_{k+1}."""
    x = torch.empty_like(u)
    x[-1] = u[-1]
    for k in range(u.shape[0] - 2, -1, -1):
        x[k] = u[k] - torch.cholesky_solve(O[k] @ x[k + 1], L[k])
    return x


def block_tridiag_factor_apply(D, O, rhs):
    """Factorization fused with the forward substitution of ``rhs`` (Np, d,
    K), then the backward sweep. Returns (L, x); the same as
    :func:`block_tridiag_factor` followed by :func:`block_tridiag_apply`
    with one sweep fewer."""
    L = torch.empty_like(D)
    u = torch.empty_like(rhs)
    info = []
    for k in range(D.shape[0]):
        t, r = D[k], rhs[k]
        if k:
            w = torch.linalg.solve_triangular(L[k - 1], O[k - 1], upper=False)
            t = t - w.T @ w
            r = r - O[k - 1].T @ u[k - 1]
        L[k], ik = torch.linalg.cholesky_ex(t)
        info.append(ik)
        u[k] = torch.cholesky_solve(r, L[k])
    _raise_on_failed_panels(torch.stack(info))
    return L, _backward(L, u, O)


def block_tridiag_apply(L, O, rhs):
    """Solve A x = rhs (Np, d, K) given the Thomas factor L: two sweeps."""
    u = torch.empty_like(rhs)
    for k in range(L.shape[0]):
        r = rhs[k] - O[k - 1].T @ u[k - 1] if k else rhs[k]
        u[k] = torch.cholesky_solve(r, L[k])
    return _backward(L, u, O)


def _band_matvec(band, bias_col, bb, x, y, n: int):
    """H [x; y] for the frame band + bias border; x (N, 9), y (6,) ->
    (N, 9), (6,). O(N band_w) by windows of x, no dense matrix."""
    wp1 = band.shape[1]
    bw = wp1 - 1
    dev = x.device
    # Upper (and diagonal): row k gets band[k, d] x[k+d].
    x_win = torch.cat([x, x.new_zeros((bw, FRAME_DIM))]).unfold(0, wp1, 1).transpose(1, 2)
    out = torch.einsum("ndab,ndb->na", band, x_win)
    if bw:
        # Lower: row k gets band[k-d, d]^T x[k-d] for d >= 1.
        contrib = torch.einsum("ndba,nb->nda", band[:, 1:], x)      # at source rows
        c_pad = torch.cat([contrib.new_zeros((bw, bw, FRAME_DIM)), contrib])
        src = torch.arange(n, device=dev)[:, None] - torch.arange(1, wp1, device=dev) + bw
        out = out + c_pad[src, torch.arange(bw, device=dev)].sum(1)
    out = out + bias_col @ y
    out_b = torch.einsum("nab,na->b", bias_col, x) + bb @ y
    return out, out_b


# --------------------------------------------------------------------------
# The solve
# --------------------------------------------------------------------------


def auto_panel(band_w: int) -> int:
    """The JAX package's default panel: the next power of two >= band_w
    (at least 16), or above 64 the next multiple of 32."""
    panel = 16
    while panel < band_w:
        panel *= 2
    if panel > 64:
        panel = -(-band_w // 32) * 32
    return panel


def solve_schur_banded(
    lin: Linearization,
    stereo: StereoObservations,
    num_poses: int,
    num_landmarks: int,
    damping,
    band_w: int,
    panel: int | None = None,
    refine_iters: int = 2,
    jitter: float = 1e-7,
    diag_damping: bool = False,
    return_aux: bool = False,
    corr_window: int = 0,
    corr_lm_chunk: int = 128,
    check=None,
    group=None,
):
    """Banded counterpart of :func:`uslam_tpu_torch.solvers.schur.solve_schur`
    (same delta layout [frames(9N), bias(6), landmarks(3M)]; with
    ``return_aux`` also g.delta).

    ``band_w`` must be >= the longest landmark track span in frames
    (:func:`measure_band_width`); ``panel`` defaults to :func:`auto_panel`.
    ``corr_window`` (0 = off) places the landmark correction per chunk of
    ``corr_lm_chunk`` landmarks in a window of that many frames (pass
    :func:`measure_corr_window`). Runs in float64 and returns the
    linearization's type (module docstring). ``check`` (the LM's
    ``debug_nans``) is called on the banded reduction and on the reduced
    solve.

    ``group``: landmark-sharded as in
    :func:`uslam_tpu_torch.solvers.schur.solve_schur` (this rank's slice of
    ``lm_obs_idx``/``lm_obs_mask``, the rest the same on every rank). The
    correction band B_corr, g_corr and the landmark part of g.delta are
    summed over the group, the panel factorization runs on every rank, and
    the landmark delta is gathered. Correction chunks start at the slice's
    first landmark; :func:`measure_corr_window` slides over every start."""
    out_dtype = lin.stereo_r.dtype
    if out_dtype != torch.float64:
        dev = lin.stereo_r.device
        out = solve_schur_banded(
            cast_tree(lin, torch.float64, dev), cast_tree(stereo, torch.float64, dev),
            num_poses, num_landmarks, damping, band_w, panel=panel,
            refine_iters=refine_iters, jitter=jitter, diag_damping=diag_damping,
            return_aux=return_aux, corr_window=corr_window, corr_lm_chunk=corr_lm_chunk,
            check=check, group=group,
        )
        if return_aux:
            return out[0].to(out_dtype), out[1].to(out_dtype)
        return out.to(out_dtype)
    n = num_poses
    dtype, dev = lin.stereo_r.dtype, lin.stereo_r.device
    if band_w < 1:
        raise ValueError(f"band_w {band_w} < 1: the IMU couples neighbouring frames")
    if panel is None:
        panel = auto_panel(band_w)
    if panel < band_w:
        raise ValueError(f"panel {panel} < band_w {band_w}")

    Hll_inv, g_l, W, Y = _landmark_parts(lin, stereo, damping, diag_damping)
    cam_g = stereo.cam_idx.long()[stereo.lm_obs_idx.long()]         # (M, K)
    B_corr, g_corr = _band_correction(
        W, Y, g_l, cam_g, stereo.lm_obs_mask, n, band_w,
        corr_window=corr_window, lm_chunk=corr_lm_chunk,
    )
    all_reduce_sum(B_corr, group)
    all_reduce_sum(g_corr, group)
    bands = assemble_cam_bands(lin, stereo, n, damping, diag_damping)
    band, bias_col, bb, g, gb = _frame_band(bands, B_corr, g_corr, n, band_w)
    if check:
        check("banded reduction", Hll_inv, g_l, band, bias_col, bb, g, gb)

    # ---- symmetric Jacobi scaling -------------------------------------------
    diag_entries = torch.diagonal(band[:, 0], dim1=1, dim2=2)        # (N, 9)
    s_inv = 1.0 / torch.sqrt(torch.clamp(diag_entries, min=1e-20))
    sb_inv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(bb), min=1e-20))
    # Column frame k+d of offset d; ones past the last frame.
    col_s = torch.cat([s_inv, s_inv.new_ones((band_w, FRAME_DIM))]).unfold(0, band_w + 1, 1)
    band_s = band * s_inv[:, None, :, None] * col_s.transpose(1, 2)[:, :, None, :]
    bias_s = bias_col * s_inv[..., None] * sb_inv[None, None, :]
    bb_s = bb * sb_inv[:, None] * sb_inv[None, :]
    g_s = g * s_inv
    gb_s = gb * sb_inv

    # ---- panelize + factor, with the PD jitter --------------------------------
    # The jitter enters the factorization only; the refinement below takes
    # its residuals against the scaled system without it (module docstring).
    D, O = _panelize(band_s, panel)
    Np = D.shape[0]
    n_pad = Np * panel
    # Padded tail frames: identity on their diagonal (decoupled, solution 0).
    pad_diag = (torch.arange(n_pad, device=dev) >= n).repeat_interleave(FRAME_DIM)
    D.diagonal(dim1=1, dim2=2).add_(pad_diag.to(dtype).reshape(Np, -1) + jitter)

    def pad_rhs(rhs_flat):
        k = rhs_flat.shape[-1]
        r = torch.nn.functional.pad(rhs_flat, (0, 0, 0, (n_pad - n) * FRAME_DIM))
        return r.reshape(Np, panel * FRAME_DIM, k)

    def unpad(x):
        return x.reshape(n_pad * FRAME_DIM, -1)[: n * FRAME_DIM]

    # ---- bordered (bias) solve with refinement --------------------------------
    bias_flat = bias_s.reshape(n * FRAME_DIM, BIAS_DIM)
    rhs = torch.cat([g_s.reshape(-1, 1), bias_flat], dim=1)
    L, X0 = block_tridiag_factor_apply(D, O, pad_rhs(rhs))
    X = unpad(X0)
    X1, X2 = X[:, 0], X[:, 1:]
    S = bb_s + jitter * torch.eye(BIAS_DIM, dtype=dtype, device=dev) - bias_flat.T @ X2
    y = torch.linalg.solve(S, gb_s - bias_flat.T @ X1)
    x = X1 - X2 @ y
    for _ in range(refine_iters):
        hx, hb = _band_matvec(band_s, bias_s, bb_s, x.reshape(n, FRAME_DIM), y, n)
        rx = (g_s - hx).reshape(-1, 1)
        u = unpad(block_tridiag_apply(L, O, pad_rhs(rx)))[:, 0]
        dy = torch.linalg.solve(S, gb_s - hb - bias_flat.T @ u)
        x = x + (u - X2 @ dy)
        y = y + dy
    if check:
        check("reduced solve", x, y)

    # ---- unscale + landmark back-substitution ---------------------------------
    frames = x.reshape(n, FRAME_DIM) * s_inv               # (N, 9) [pose | vel]
    dbias = y * sb_inv
    dpose = frames[:, :POSE_DIM]
    # dl = Hll^-1 (g_l - sum_k W_mk^T dpose[cam_g]); padded slots have W = 0.
    t = torch.einsum("mkab,mka->mb", W, dpose[cam_g])
    delta_l = torch.einsum("mab,mb->ma", Hll_inv, g_l - t)
    if return_aux:
        g_dot_l = all_reduce_sum(torch.sum(g_l * delta_l), group)
    delta_l = all_gather_rows(delta_l, group)
    delta = torch.cat([frames.reshape(-1), dbias, delta_l.reshape(-1)])
    if return_aux:
        g_dot = (
            torch.sum(bands.gp * dpose) + torch.sum(bands.gv * frames[:, POSE_DIM:])
            + bands.gb @ dbias + g_dot_l
        )
        return delta, g_dot
    return delta
