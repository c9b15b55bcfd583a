"""Pyramidal Lucas-Kanade (KLT) feature tracking (port of
:mod:`uslam_tpu.frontend.klt`).

The reference nodelet tracks features with pyramidal KLT
(launch/stereo.launch:41-43: pyramid_levels 3, patch_size 15,
max_iteration 30, track_precision 0.01); the tracker's
``temporal_tracker="klt"`` uses it for temporal association.

Batched over the K points: bilinear sampling by gathers, one 2x2
Gauss-Newton system per point, a fixed loop of ``iters`` iterations in
which a point whose step fell below ``precision`` keeps its flow (the JAX
package's ``lax.scan`` with its frozen mask; an early exit would need a
host read per iteration and change nothing), and a Python loop over the
pyramid levels, coarse to fine. Every formula (clamping, the ``det > 1e-6``
test, the in-bounds mask) is the JAX package's.
"""

from __future__ import annotations

import torch

from uslam_tpu_torch.frontend.pyramid import build_pyramid


def _bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img (H, W) at float coordinates (y, x of one
    shape); coordinates clamp to the image."""
    h, w = img.shape
    x0 = torch.clamp(torch.floor(x), 0, w - 2)
    y0 = torch.clamp(torch.floor(y), 0, h - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    x0i, y0i = x0.long(), y0.long()
    p00 = img[y0i, x0i]
    p01 = img[y0i, x0i + 1]
    p10 = img[y0i + 1, x0i]
    p11 = img[y0i + 1, x0i + 1]
    return (
        p00 * (1 - fy) * (1 - fx)
        + p01 * (1 - fy) * fx
        + p10 * fy * (1 - fx)
        + p11 * fy * fx
    )


def _track_level(
    prev_im: torch.Tensor,
    next_im: torch.Tensor,
    pts_prev: torch.Tensor,   # (K, 2) [x, y] at this level
    guess: torch.Tensor,      # (K, 2) current displacement estimate
    radius: int,
    iters: int,
    precision: float,
):
    """One pyramid level of LK for all K points. Returns (flow (K, 2),
    valid (K,))."""
    win = 2 * radius + 1
    dy = torch.arange(-radius, radius + 1, dtype=prev_im.dtype, device=prev_im.device)
    oy = dy.repeat_interleave(win)
    ox = dy.repeat(win)
    px, py = pts_prev[:, :1], pts_prev[:, 1:]
    ys, xs = py + oy, px + ox                              # (K, win^2)
    # Template and spatial gradients from the previous image (fixed).
    T = _bilinear(prev_im, ys, xs)
    Ix = 0.5 * (_bilinear(prev_im, ys, xs + 1.0) - _bilinear(prev_im, ys, xs - 1.0))
    Iy = 0.5 * (_bilinear(prev_im, ys + 1.0, xs) - _bilinear(prev_im, ys - 1.0, xs))
    Gxx = torch.sum(Ix * Ix, -1)
    Gxy = torch.sum(Ix * Iy, -1)
    Gyy = torch.sum(Iy * Iy, -1)
    det = Gxx * Gyy - Gxy * Gxy
    ok_G = det > 1e-6
    inv_det = torch.where(ok_G, 1.0 / torch.clamp(det, min=1e-12), 0.0)

    v, frozen = guess, ~ok_G
    for _ in range(iters):
        d = T - _bilinear(next_im, ys + v[:, 1:], xs + v[:, :1])
        bx = torch.sum(d * Ix, -1)
        by = torch.sum(d * Iy, -1)
        dvx = inv_det * (Gyy * bx - Gxy * by)
        dvy = inv_det * (-Gxy * bx + Gxx * by)
        small = torch.sqrt(dvx * dvx + dvy * dvy) < precision
        v = torch.where(frozen[:, None], v, v + torch.stack([dvx, dvy], -1))
        frozen = frozen | small

    h, w = next_im.shape
    tx, ty = pts_prev[:, 0] + v[:, 0], pts_prev[:, 1] + v[:, 1]
    inb = (tx >= radius) & (tx < w - radius) & (ty >= radius) & (ty < h - radius)
    return v, ok_G & inb


def klt_track(
    prev_img: torch.Tensor,
    next_img: torch.Tensor,
    pts: torch.Tensor,            # (K, 2) [x, y] full-resolution coordinates
    mask: torch.Tensor,           # (K,) bool
    levels: int = 3,
    radius: int = 7,              # patch_size 15 (stereo.launch:44)
    iters: int = 30,              # stereo.launch:42
    precision: float = 0.01,      # stereo.launch:43
):
    """Track points from prev_img to next_img ((H, W) float32), coarse to
    fine over ``levels``. Returns (new_pts (K, 2), valid (K,))."""
    prev_pyr = build_pyramid(prev_img, levels)
    next_pyr = build_pyramid(next_img, levels)
    flow = torch.zeros_like(pts)
    valid = mask
    for lvl in range(levels - 1, -1, -1):
        scale = 2.0**lvl
        v, ok = _track_level(
            prev_pyr[lvl], next_pyr[lvl], pts / scale, flow / scale, radius, iters, precision
        )
        flow = v * scale
        valid = valid & ok
    return pts + flow, valid
