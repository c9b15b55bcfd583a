"""Brute-force Hamming matching, temporal and stereo, batched over frames.

Port of :mod:`uslam_tpu.frontend.match`. The distance matrices of all the
frames of a chunk come from ONE launch of the ``hamming`` kernel: the
chunked tracker computes the stereo and the temporal matrices together and
hands each to :func:`match_from_dist` / :func:`stereo_match_from_dist`;
:func:`match_descriptors` and :func:`stereo_match` compute their own, and
:func:`hamming_distance_matrix` one frame's (a launch of one). Policy:
mutual nearest neighbour + Lowe ratio + absolute distance gate; stereo adds
the rectified-row gate and a positive-disparity gate.

``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does; integer
distances tie often, so this matters for parity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uslam_tpu_torch.frontend.kernels import hamming, hamming_plain

BIG = 1 << 20


def hamming_distance_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(Na, W) x (Nb, W) packed descriptor words -> (Na, Nb) int32 Hamming
    distances. Words are int32 bit-views (uint32 is viewed as int32). On
    the card: one ``hamming`` launch, which takes W = 8 (256 bits) and
    raises on any other width; on the CPU: its plain version, any W."""
    if da.dim() != 2 or db.dim() != 2 or da.shape[1] != db.shape[1]:
        raise ValueError(f"hamming_distance_matrix: shapes {tuple(da.shape)} x {tuple(db.shape)}")
    da, db = (x.view(torch.int32) if x.dtype == torch.uint32 else x for x in (da, db))
    if da.dtype != torch.int32 or db.dtype != torch.int32:
        raise ValueError(f"hamming_distance_matrix: words of {da.dtype}, {db.dtype}")
    if da.device.type == "cpu" and db.device.type == "cpu":
        return hamming_plain(da[None], db[None])[0]
    return hamming(da.contiguous()[None], db.contiguous()[None])[0]


class Matches(NamedTuple):
    """Per row of A (..., Na): matched column of B or -1, distance, mask."""

    idx: torch.Tensor
    dist: torch.Tensor
    mask: torch.Tensor


def match_from_dist(dist, mask_a, mask_b, max_distance: int = 64, ratio: float = 0.8) -> Matches:
    """Matching A -> B given their distance matrix: dist (B, Na, Nb) int32;
    masks (B, Na), (B, Nb). Temporal matching is A current, B previous."""
    big = dist.new_tensor(BIG)
    dist = torch.where(mask_a[:, :, None] & mask_b[:, None, :], dist, big)
    na = dist.shape[1]
    best_j = torch.argmin(dist, dim=2)                                # (B, Na)
    best_d = torch.gather(dist, 2, best_j[..., None])[..., 0]
    second_d = dist.scatter(2, best_j[..., None], BIG).amin(dim=2)
    best_i_per_col = torch.argmin(dist, dim=1)                        # (B, Nb)
    rows = torch.arange(na, device=dist.device)
    mutual = torch.gather(best_i_per_col, 1, best_j) == rows
    ok = (
        mutual
        & (best_d <= max_distance)
        & (best_d.to(torch.float32) <= ratio * second_d.to(torch.float32))
        & mask_a
    )
    return Matches(torch.where(ok, best_j, -1), best_d, ok)


def match_descriptors(
    desc_a, mask_a, desc_b, mask_b, max_distance: int = 64, ratio: float = 0.8
) -> Matches:
    """Temporal matching A (current) -> B (previous), (B, N, 8) descriptors."""
    return match_from_dist(
        hamming(desc_a.contiguous(), desc_b.contiguous()), mask_a, mask_b, max_distance, ratio
    )


def stereo_match_from_dist(
    dist, xy_l, mask_l, xy_r, mask_r,
    max_distance: int = 64,
    ratio: float = 0.8,
    max_v_diff: float = 5.0,
    min_disparity: float = 0.25,
    max_disparity: float = 512.0,
) -> Matches:
    """Left -> right matching on rectified pairs given their distance matrix
    (B, Nl, Nr) int32: |vL - vR| <= max_v_diff and disparity uL - uR in
    (min_disparity, max_disparity)."""
    d_v = torch.abs(xy_l[:, :, None, 1] - xy_r[:, None, :, 1])
    disp = xy_l[:, :, None, 0] - xy_r[:, None, :, 0]
    geom = (d_v <= max_v_diff) & (disp > min_disparity) & (disp < max_disparity)
    dist = torch.where(geom, dist, dist.new_tensor(BIG))
    return match_from_dist(dist, mask_l, mask_r, max_distance, ratio)


def stereo_match(
    desc_l, xy_l, mask_l, desc_r, xy_r, mask_r,
    max_distance: int = 64,
    ratio: float = 0.8,
    max_v_diff: float = 5.0,
    min_disparity: float = 0.25,
    max_disparity: float = 512.0,
) -> Matches:
    """:func:`stereo_match_from_dist` on the descriptors' distance matrix."""
    return stereo_match_from_dist(
        hamming(desc_l.contiguous(), desc_r.contiguous()), xy_l, mask_l, xy_r, mask_r,
        max_distance, ratio, max_v_diff, min_disparity, max_disparity,
    )
