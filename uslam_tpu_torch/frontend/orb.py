"""ORB keypoints: grid-limited FAST+Harris, intensity-centroid orientation,
steered BRIEF descriptors.

Port of :mod:`uslam_tpu.frontend.orb`, batched over images: one call
extracts a whole chunk of frames, and each pyramid level is ONE launch of
the ``fast_harris`` kernel for every image of the chunk. Every image yields
exactly ``grid_rows * grid_cols * max_features_per_cell`` slots; ``mask``
marks the real ones. :func:`extract_orb` is the same on one image.

``jax.lax.top_k`` returns the lowest index first among equal values (and
the cells are full of equal filler scores); ``torch.topk`` promises no
order on ties, so the top-K here is a stable descending sort, sliced.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uslam_tpu_torch.config import FrontendConfig
from uslam_tpu_torch.frontend.fast import interior_mask, nms3
from uslam_tpu_torch.frontend.kernels import fast_harris
from uslam_tpu_torch.frontend.pyramid import box_blur, build_pyramid

_PATTERN_BITS = 256
_PATCH_RADIUS = 18          # patch half-size for descriptor sampling
_EDGE_MARGIN = _PATCH_RADIUS + 1
_NEG = -3.4e38              # filler score of empty slots
# Slots scoring above it are real: float32(_NEG) * 0.5, rounded to float32.
# Both constants go into ops as Python floats: a CUDA graph capture cannot
# copy a tensor from the host.
_NEG_HALF = float(np.float32(_NEG) * np.float32(0.5))


def _make_pattern(bits: int = _PATTERN_BITS, seed: int = 42) -> np.ndarray:
    """(bits, 4) int8 offsets (y1, x1, y2, x2): the JAX package's pattern
    (Gaussian sigma 6.5, clipped to +-13), from the same numpy seed."""
    rng = np.random.default_rng(seed)
    pts = np.clip(np.round(rng.normal(0.0, 6.5, size=(bits, 4))), -13, 13)
    return pts.astype(np.int8)


BRIEF_PATTERN = _make_pattern()
_PATTERN_ON: dict = {}      # BRIEF_PATTERN as float32, per device


def _pattern(device: torch.device) -> torch.Tensor:
    """BRIEF_PATTERN on ``device``, copied there once, before any capture
    (a graph's warm-up runs first)."""
    pat = _PATTERN_ON.get(device)
    if pat is None:
        pat = _PATTERN_ON[device] = torch.as_tensor(BRIEF_PATTERN, dtype=torch.float32,
                                                     device=device)
    return pat


class Keypoints(NamedTuple):
    """Fixed-size keypoint sets, leading dimensions (..., K)."""

    xy: torch.Tensor      # (..., K, 2) [x, y] level-0 pixel coords
    score: torch.Tensor   # (..., K) Harris response
    angle: torch.Tensor   # (..., K) radians
    level: torch.Tensor   # (..., K) int32 pyramid level
    desc: torch.Tensor    # (..., K, 8) int32 bit-views of packed rBRIEF
    mask: torch.Tensor    # (..., K) bool


def _topk_stable(x: torch.Tensor, k: int):
    """Largest ``k`` along the last dim, ties lowest index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _grid_topk(score_map, valid, rows: int, cols: int, per_cell: int):
    """Top-``per_cell`` pixels per grid cell of (B, h, w) maps.

    Returns (ys, xs, scores, mask), each (B, rows*cols*per_cell)."""
    B, h, w = score_map.shape
    ch, cw = -(-h // rows), -(-w // cols)
    s = torch.where(valid, score_map, _NEG)
    s = torch.nn.functional.pad(s, (0, cw * cols - w, 0, ch * rows - h), value=_NEG)
    cells = (
        s.reshape(B, rows, ch, cols, cw).permute(0, 1, 3, 2, 4).reshape(B, rows * cols, ch * cw)
    )
    vals, idx = _topk_stable(cells, per_cell)
    r = torch.arange(rows * cols, device=s.device)[:, None]
    ys = (r // cols) * ch + idx // cw
    xs = (r % cols) * cw + idx % cw
    mask = vals > _NEG_HALF
    return ys.reshape(B, -1), xs.reshape(B, -1), vals.reshape(B, -1), mask.reshape(B, -1)


def _orientation(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle atan2(m01, m10) over a circular window;
    (..., P, P) -> (...)."""
    P = patches.shape[-1]
    r = (P - 1) / 2.0
    c = torch.arange(P, dtype=patches.dtype, device=patches.device) - r
    yy = c[:, None].expand(P, P)
    xx = c[None, :].expand(P, P)
    circ = (yy**2 + xx**2 <= r * r).to(patches.dtype)
    m01 = torch.sum(patches * yy * circ, dim=(-2, -1))
    m10 = torch.sum(patches * xx * circ, dim=(-2, -1))
    return torch.atan2(m01, m10)


def _rbrief(patches: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF on (..., K, P, P) blurred patches at (..., K) angles:
    rotate the pattern, sample nearest, compare, pack 256 bits into 8 int32
    words (bit-views of the JAX package's uint32 words)."""
    P = patches.shape[-1]
    c0 = (P - 1) // 2
    pat = _pattern(patches.device)
    ca, sa = torch.cos(angles)[..., None], torch.sin(angles)[..., None]

    def sample(y, x):
        # p' = R(theta) p: x' = x cos - y sin, y' = x sin + y cos.
        xr = x * ca - y * sa
        yr = x * sa + y * ca
        iy = torch.clamp(torch.round(yr).to(torch.int64) + c0, 0, P - 1)
        ix = torch.clamp(torch.round(xr).to(torch.int64) + c0, 0, P - 1)
        flat = patches.flatten(-2)
        return torch.gather(flat, -1, iy * P + ix)

    a = sample(pat[:, 0], pat[:, 1])
    b = sample(pat[:, 2], pat[:, 3])
    bits = (a < b).to(torch.int64).unflatten(-1, (8, 32))
    shifts = torch.arange(32, device=patches.device)
    words = torch.sum(bits << shifts, dim=-1)                  # in [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _extract_patches(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, radius: int):
    """(B, h, w) images, (B, K) centres -> (B, K, P, P) patches, windows
    clamped inside the image."""
    P = 2 * radius + 1
    B, h, w = img.shape
    ar = torch.arange(P, device=img.device)
    y0 = torch.clamp(ys - radius, 0, h - P)
    x0 = torch.clamp(xs - radius, 0, w - P)
    rows = (y0[..., None] + ar)[..., :, None]                   # (B, K, P, 1)
    cols = (x0[..., None] + ar)[..., None, :]                   # (B, K, 1, P)
    b = torch.arange(B, device=img.device)[:, None, None, None]
    return img[b, rows, cols]


def extract_orb_batch(imgs: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> Keypoints:
    """ORB over a batch of (B, H, W) float32 images: detect and describe
    per pyramid level, then a per-cell top-K over the union of levels keeps
    the grid budget at level-0 resolution."""
    rows, cols, K_cell = cfg.grid_rows, cfg.grid_cols, cfg.max_features_per_cell
    per_level = []
    for lvl, im in enumerate(build_pyramid(imgs, cfg.pyramid_levels)):
        im = im.contiguous()
        _, h, w = im.shape
        corner, harris = fast_harris(im, cfg.fast_threshold)
        corners = corner & interior_mask(h, w, 3, im.device)
        # NMS among corner candidates only: non-corners must not suppress.
        valid = corners & nms3(torch.where(corners, harris, _NEG))
        inside = interior_mask(h, w, _EDGE_MARGIN, im.device)
        ys, xs, scores, mask = _grid_topk(harris, valid & inside, rows, cols, K_cell)

        patches = _extract_patches(box_blur(im, 2), ys, xs, _PATCH_RADIUS)
        angles = _orientation(_extract_patches(im, ys, xs, _PATCH_RADIUS))
        scale = 2.0**lvl
        per_level.append(
            Keypoints(
                xy=torch.stack([xs.to(torch.float32) * scale, ys.to(torch.float32) * scale], -1),
                score=scores,
                angle=angles,
                level=torch.full(ys.shape, lvl, dtype=torch.int32, device=im.device),
                desc=_rbrief(patches, angles),
                mask=mask,
            )
        )
    cand = Keypoints(*(torch.cat(f, dim=1) for f in zip(*per_level)))

    # Global per-cell budget over the level union (cells at level-0 res).
    h0, w0 = imgs.shape[-2:]
    ch, cw = -(-h0 // rows), -(-w0 // cols)
    cell = (cand.xy[..., 1] // ch).to(torch.int64) * cols + (cand.xy[..., 0] // cw).to(torch.int64)
    scores = torch.where(cand.mask, cand.score, _NEG)
    cell_ids = torch.arange(rows * cols, device=imgs.device)[None, :, None]
    s_cells = torch.where(cell[:, None, :] == cell_ids, scores[:, None, :], _NEG)
    _, idx = _topk_stable(s_cells, K_cell)                     # (B, cells, K_cell)
    sel = idx.reshape(idx.shape[0], -1)

    def take(a):
        if a.dim() == 2:
            return torch.gather(a, 1, sel)
        return torch.gather(a, 1, sel[..., None].expand(-1, -1, a.shape[-1]))

    out = Keypoints(*(take(a) for a in cand))
    return out._replace(
        mask=out.mask & (out.score > _NEG_HALF) & (take(scores) > _NEG_HALF)
    )


def extract_orb(img: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> Keypoints:
    """ORB on one (H, W) float32 image: :func:`extract_orb_batch` of a batch
    of one (one ``fast_harris`` launch per pyramid level on the card), the
    keypoints without the batch dimension."""
    return Keypoints(*(f[0] for f in extract_orb_batch(img[None], cfg)))
