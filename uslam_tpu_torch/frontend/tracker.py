"""Stereo front end with persistent track ids: the chunked offline path and
the per-frame online path.

Port of :mod:`uslam_tpu.frontend.tracker`: per chunk of C stereo pairs
(C = 1 per frame), ORB on all 2C images, stereo matching, temporal
matching against the previous left frame, gyro rotation compensation and
1-point translation RANSAC, all batched over the chunk; then host-side id
interning and the nodelet's normalized [-1, 1] output contract. With
``temporal_tracker="klt"`` the temporal association is pyramidal KLT
(:mod:`uslam_tpu_torch.frontend.klt`) from the previous raw left image,
frame by frame; ORB still detects and stereo-matches.

Randomness is explicit: the RANSAC hypothesis indices are one (H,) index
tensor, drawn once per front end from a seeded ``torch.Generator``
(``jax.random`` streams cannot be reproduced in torch; tests inject the
JAX package's own indices).
"""

from __future__ import annotations

import numpy as np
import torch

from uslam_tpu_torch.config import CameraConfig, FrontendConfig
from uslam_tpu_torch.io.sequence import FeatureFrame
from uslam_tpu_torch.frontend.kernels import hamming
from uslam_tpu_torch.frontend.klt import klt_track
from uslam_tpu_torch.frontend.match import (
    Matches,
    match_from_dist,
    stereo_match,
    stereo_match_from_dist,
)
from uslam_tpu_torch.frontend.orb import Keypoints, extract_orb_batch
from uslam_tpu_torch.geometry.so3 import quat_rotate, so3_exp

RANSAC_HYPOTHESES = 64


def integrate_gyro_rotvec(gyro: np.ndarray, dt) -> np.ndarray:
    """Integrate body rates (S, 3) over steps ``dt`` to one rotation vector
    (3,), composing per-sample exponentials (host numpy/scipy)."""
    from scipy.spatial.transform import Rotation

    gyro = np.asarray(gyro, np.float64).reshape(-1, 3)
    if gyro.size == 0:
        return np.zeros(3)
    dt = np.broadcast_to(np.asarray(dt, np.float64), (len(gyro),))
    R = Rotation.identity()
    for w, h in zip(gyro, dt):
        R = R * Rotation.from_rotvec(w * h)
    return R.as_rotvec()


def rotation_warp(xy: torch.Tensor, rel_rotvec: torch.Tensor, kvec: torch.Tensor):
    """Warp pixels (..., K, 2) through the infinite-depth homography
    K R^T K^-1 of the body rotation prev->cur ``rel_rotvec`` (..., 3);
    ``kvec`` = [fx, fy, cx, cy]."""
    fx, fy, cx, cy = kvec.unbind(-1)
    d = torch.stack(
        [(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy, torch.ones_like(xy[..., 0])],
        dim=-1,
    )
    q = so3_exp(-rel_rotvec)[..., None, :]      # (DeltaR)^T = exp(-w)
    d2 = quat_rotate(q, d)
    z = torch.where(torch.abs(d2[..., 2]) > 1e-6, d2[..., 2], torch.full_like(d2[..., 2], 1e-6))
    return torch.stack([fx * d2[..., 0] / z + cx, fy * d2[..., 1] / z + cy], dim=-1)


def ransac_translation(
    flow: torch.Tensor, mask: torch.Tensor, hyp_idx: torch.Tensor, threshold: float = 3.0
) -> torch.Tensor:
    """1-point translation RANSAC per frame: flow (C, K, 2), mask (C, K),
    hypothesis indices (H,) into K -> inlier mask (C, K)."""
    hyp = flow[:, hyp_idx]                                   # (C, H, 2)
    hyp_valid = mask[:, hyp_idx]
    diff = flow[:, None, :, :] - hyp[:, :, None, :]          # (C, H, K, 2)
    d = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    inlier = (d <= threshold) & mask[:, None, :]
    support = inlier.sum(dim=2) * hyp_valid
    best = torch.argmax(support, dim=1)                      # first maximum
    best_inl = inlier[torch.arange(flow.shape[0], device=flow.device), best]
    return torch.where(mask.any(dim=1, keepdim=True), best_inl & mask, mask)


def chunk_matches(kp_l: Keypoints, kp_r: Keypoints, prev: Keypoints, cfg: FrontendConfig):
    """Stereo (left -> right) and temporal (left -> previous left) matches
    of a chunk's C frames, from ONE ``hamming`` launch over (2C, K, 8):
    rows 0..C-1 left vs right, rows C..2C-1 left vs previous left (``prev``
    before the first frame). Returns (stereo Matches, temporal Matches)."""
    c = kp_l.desc.shape[0]
    pdesc = torch.cat([prev.desc[None], kp_l.desc[:-1]])
    pmask = torch.cat([prev.mask[None], kp_l.mask[:-1]])
    dist = hamming(torch.cat([kp_l.desc, kp_l.desc]), torch.cat([kp_r.desc, pdesc]))
    sm = stereo_match_from_dist(
        dist[:c], kp_l.xy, kp_l.mask, kp_r.xy, kp_r.mask,
        max_distance=cfg.match_max_distance,
        ratio=cfg.match_ratio,
        max_v_diff=cfg.stereo_max_v_diff,
        min_disparity=cfg.stereo_min_disparity,
    )
    tm = match_from_dist(
        dist[c:], kp_l.mask, pmask, max_distance=cfg.match_max_distance, ratio=cfg.match_ratio
    )
    return sm, tm


def orb_chunk_step(pairs, prev: Keypoints, cfg: FrontendConfig, rotvecs, kvec, hyp_idx):
    """C stereo pairs (C, 2, H, W) float32 -> per-frame (kp_left, kp_right,
    stereo idx, stereo mask, temporal idx or -1), leading dim C.

    ``prev``: left keypoints of the frame before the chunk (all-false mask
    at sequence start). ``rotvecs`` (C, 3): gyro rotation frame i-1 -> i;
    an exactly-zero rotvec skips the warp (the f32 round trip is not a
    bit-exact identity)."""
    c = pairs.shape[0]
    kp = extract_orb_batch(pairs.reshape((2 * c,) + pairs.shape[2:]), cfg)
    kp_l = Keypoints(*(a[0::2] for a in kp))
    kp_r = Keypoints(*(a[1::2] for a in kp))
    pxy = torch.cat([prev.xy[None], kp_l.xy[:-1]])
    sm, tm = chunk_matches(kp_l, kp_r, prev, cfg)
    rotating = torch.any(rotvecs != 0.0, dim=-1)[:, None, None]
    pxy_w = torch.where(rotating, rotation_warp(pxy, rotvecs, kvec), pxy)
    prev_at = torch.gather(pxy_w, 1, torch.clamp(tm.idx, min=0)[..., None].expand(-1, -1, 2))
    inlier = ransac_translation(kp_l.xy - prev_at, tm.mask, hyp_idx, cfg.ransac_threshold_px)
    return kp_l, kp_r, sm.idx, sm.mask, torch.where(inlier, tm.idx, -1)


def orb_pair_step(pair, prev: Keypoints, cfg: FrontendConfig, rotvec, kvec, hyp_idx):
    """One stereo pair (2, H, W) float32 -> (kp_left, kp_right, stereo idx,
    stereo mask, temporal idx or -1): :func:`orb_chunk_step` with C = 1,
    so one ``fast_harris`` launch per pyramid level and one ``hamming``
    launch for the stereo and temporal matrices. ``rotvec`` (3,): gyro
    rotation since ``prev``'s frame, zeros to skip the warp."""
    out = orb_chunk_step(pair[None], prev, cfg, rotvec[None], kvec, hyp_idx)
    kp_l, kp_r = (Keypoints(*(a[0] for a in kp)) for kp in out[:2])
    return (kp_l, kp_r, *(a[0] for a in out[2:]))


class StereoFrontend:
    """Stateful per-sequence wrapper around :func:`orb_chunk_step`.

    ``ransac_idx`` (H,) overrides the hypothesis indices, which are
    otherwise drawn from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(
        self,
        cam: CameraConfig = CameraConfig(),
        cfg: FrontendConfig = FrontendConfig(),
        *,
        device,
        seed: int = 0,
        ransac_idx=None,
    ):
        if cfg.temporal_tracker not in ("orb", "klt"):
            raise ValueError(f"temporal_tracker={cfg.temporal_tracker!r}: 'orb' or 'klt'")
        self.cam = cam
        self.cfg = cfg
        self.device = torch.device(device)
        K = cfg.max_features
        if ransac_idx is None:
            gen = torch.Generator().manual_seed(seed)
            ransac_idx = torch.randint(0, K, (RANSAC_HYPOTHESES,), generator=gen)
        self.ransac_idx = torch.tensor(np.asarray(ransac_idx), dtype=torch.int64,
                                       device=self.device)
        self.kvec = torch.tensor([cam.fx, cam.fy, cam.cx, cam.cy], dtype=torch.float32,
                                 device=self.device)
        self.reset()

    def reset(self) -> None:
        """Forget the previous frame and restart the ids at 0."""
        K, dev = self.cfg.max_features, self.device
        self._prev = Keypoints(
            xy=torch.zeros((K, 2), device=dev),
            score=torch.zeros(K, device=dev),
            angle=torch.zeros(K, device=dev),
            level=torch.zeros(K, dtype=torch.int32, device=dev),
            desc=torch.zeros((K, 8), dtype=torch.int32, device=dev),
            mask=torch.zeros(K, dtype=torch.bool, device=dev),
        )
        self._prev_ids: np.ndarray | None = None
        self._prev_img: torch.Tensor | None = None   # KLT: previous left image
        self._next_id = 0

    def _emit_frame(self, t, ids, xy_l_all, xy_r_raw, sm_idx_np) -> FeatureFrame:
        sel = ids >= 0
        xy_l = xy_l_all[sel]
        xy_r = xy_r_raw[sm_idx_np[sel]]
        rx, ry = self.cam.resolution_x, self.cam.resolution_y
        return FeatureFrame(
            t=t,
            ids=ids[sel],
            u0=xy_l[:, 0] / (0.5 * rx) - 1.0,
            v0=xy_l[:, 1] / (0.5 * ry) - 1.0,
            u1=xy_r[:, 0] / (0.5 * rx) - 1.0,
            v1=xy_r[:, 1] / (0.5 * ry) - 1.0,
        )

    def _intern_ids(self, stereo_ok, tm_idx) -> np.ndarray:
        """Tracked keypoints inherit the previous frame's id; fresh
        stereo-matched keypoints get new ids."""
        ids = np.full(len(stereo_ok), -1, np.int64)
        for i in range(len(stereo_ok)):
            if not stereo_ok[i]:
                continue
            j = int(tm_idx[i])
            if j >= 0 and self._prev_ids is not None and self._prev_ids[j] >= 0:
                ids[i] = self._prev_ids[j]
            else:
                ids[i] = self._next_id
                self._next_id += 1
        self._prev_ids = ids
        return ids

    def _associate_klt(self, left: torch.Tensor, kp_l: Keypoints):
        """KLT-predict the previous keypoints into this frame and associate
        each current detection with the nearest prediction within
        ``klt_gate_px`` (the reference nodelet's strategy,
        stereo.launch:41-43). Returns (index into the previous keypoints
        or -1, mask)."""
        cfg, prev = self.cfg, self._prev
        tracked, ok = klt_track(
            self._prev_img, left, prev.xy, prev.mask,
            levels=cfg.pyramid_levels, radius=cfg.patch_size // 2,
        )
        diff = kp_l.xy[:, None, :] - tracked[None, :, :]
        d = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
        d = torch.where(ok[None, :] & prev.mask[None, :], d, torch.inf)
        best, j = torch.min(d, dim=1)
        mask = (best <= cfg.klt_gate_px) & kp_l.mask
        return torch.where(mask, j, -1), mask

    def _klt_pair_step(self, pair: torch.Tensor, rotvec: torch.Tensor):
        """One stereo pair (2, H, W) float32 with KLT temporal association:
        ORB on both images (one ``fast_harris`` launch per level), the
        stereo match (one ``hamming`` launch), KLT from the previous left
        image, the gyro warp and RANSAC. Returns (kp_left, kp_right, stereo
        idx, stereo mask, temporal idx or -1)."""
        cfg = self.cfg
        kp = extract_orb_batch(pair, cfg)
        sm = stereo_match(
            kp.desc[:1], kp.xy[:1], kp.mask[:1], kp.desc[1:], kp.xy[1:], kp.mask[1:],
            max_distance=cfg.match_max_distance,
            ratio=cfg.match_ratio,
            max_v_diff=cfg.stereo_max_v_diff,
            min_disparity=cfg.stereo_min_disparity,
        )
        sm = Matches(*(a[0] for a in sm))
        kp_l = Keypoints(*(a[0] for a in kp))
        kp_r = Keypoints(*(a[1] for a in kp))
        if self._prev_img is None:
            tm_idx = torch.full_like(sm.idx, -1)
        else:
            tm_idx, tm_mask = self._associate_klt(pair[0], kp_l)
            prev_xy = torch.where(
                torch.any(rotvec != 0.0), rotation_warp(self._prev.xy, rotvec, self.kvec),
                self._prev.xy,
            )
            flow = kp_l.xy - prev_xy[torch.clamp(tm_idx, min=0)]
            inlier = ransac_translation(
                flow[None], tm_mask[None], self.ransac_idx, cfg.ransac_threshold_px
            )[0]
            tm_idx = torch.where(inlier, tm_idx, -1)
        self._prev_img = pair[0]
        return kp_l, kp_r, sm.idx, sm.mask, tm_idx

    def process(self, left, right, t: float, gyro_rotvec=None) -> FeatureFrame:
        """One rectified stereo pair (numpy (H, W), any real dtype) ->
        FeatureFrame. The pair goes up as one (2, H, W) copy in its own
        dtype (uint8 frames: a quarter of float32's bytes) and is cast on
        the device. ``gyro_rotvec`` (3,): integrated gyro rotation since the
        previous frame; None or zeros skip the warp."""
        pair = torch.from_numpy(np.stack([np.asarray(left), np.asarray(right)]))
        pair = pair.to(self.device).to(torch.float32)
        rv = np.zeros(3, np.float32) if gyro_rotvec is None else gyro_rotvec
        rv = torch.as_tensor(np.asarray(rv, np.float32), device=self.device)
        if self.cfg.temporal_tracker == "klt":
            out = self._klt_pair_step(pair, rv)
        else:
            out = orb_pair_step(pair, self._prev, self.cfg, rv, self.kvec, self.ransac_idx)
        kp_l, kp_r, sm_idx, sm_mask, tm_idx = out
        tm_idx, stereo_ok, sm_idx, xy_l_all, xy_r_raw = (
            a.cpu().numpy() for a in (tm_idx, sm_mask, sm_idx, kp_l.xy, kp_r.xy)
        )
        ids = self._intern_ids(stereo_ok, tm_idx)
        self._prev = kp_l
        return self._emit_frame(t, ids, xy_l_all, xy_r_raw, sm_idx)

    def process_chunk(
        self, lefts, rights, ts, gyro_rotvecs=None, pad_to: int | None = None
    ) -> list[FeatureFrame]:
        """C rectified stereo pairs (numpy (C, H, W)) -> C FeatureFrames.
        ``pad_to`` pads a ragged tail chunk with zero images (no corners),
        whose outputs are discarded. With the KLT tracker the pairs go
        through :meth:`process` one by one (KLT needs the previous raw
        image) and ``pad_to`` is not needed. An ORB chunk leaves no
        previous image for a later KLT frame, which then starts new
        tracks."""
        n_real = len(ts)
        if n_real == 0:
            return []
        if self.cfg.temporal_tracker == "klt":
            return [
                self.process(lefts[i], rights[i], float(ts[i]),
                             None if gyro_rotvecs is None else gyro_rotvecs[i])
                for i in range(n_real)
            ]
        pairs = np.stack([np.asarray(lefts), np.asarray(rights)], axis=1)
        rot = (
            np.zeros((n_real, 3), np.float32)
            if gyro_rotvecs is None
            else np.asarray(gyro_rotvecs, np.float32)
        )
        if pad_to is not None and n_real < pad_to:
            pad = pad_to - n_real
            pairs = np.concatenate([pairs, np.zeros((pad,) + pairs.shape[1:], pairs.dtype)])
            rot = np.concatenate([rot, np.zeros((pad, 3), np.float32)])

        pairs_t = torch.from_numpy(pairs).to(self.device).to(torch.float32)
        kp_l, kp_r, sm_idx, sm_mask, tm_idx = orb_chunk_step(
            pairs_t, self._prev, self.cfg, torch.from_numpy(rot).to(self.device),
            self.kvec, self.ransac_idx,
        )
        tm_idx, stereo_ok, sm_idx, xy_l_all, xy_r_raw = (
            a.cpu().numpy() for a in (tm_idx, sm_mask, sm_idx, kp_l.xy, kp_r.xy)
        )
        frames = []
        for f in range(n_real):
            ids = self._intern_ids(stereo_ok[f], tm_idx[f])
            frames.append(
                self._emit_frame(float(ts[f]), ids, xy_l_all[f], xy_r_raw[f], sm_idx[f])
            )
        # Carry the last REAL frame's left keypoints.
        self._prev = Keypoints(*(a[n_real - 1] for a in kp_l))
        self._prev_img = None
        return frames
