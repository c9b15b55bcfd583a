"""Data parallelism over frames: the front end's axis (port of
:mod:`uslam_tpu.parallel.frames`).

A batch of frames (or stereo pairs) is cut into one contiguous slice per
rank; each rank runs the whole ORB pipeline (pyramid, FAST + Harris,
orientation, rBRIEF, stereo Hamming matching) on its slice as one batch:
one ``fast_harris`` launch per pyramid level, and for pairs one
``hamming`` launch. The ranks do not talk while they compute. The JAX
package returns arrays sharded on the batch axis; here the slices are
gathered in rank order, so every rank returns the whole batch, equal to
the single-device call.

This is the offline throughput path (a recorded sequence, N frames at a
time); the online path stays per pair (``frontend.tracker``).
"""

from __future__ import annotations

import numpy as np
import torch

from uslam_tpu_torch.collectives import all_gather_rows
from uslam_tpu_torch.config import FrontendConfig
from uslam_tpu_torch.frontend.match import stereo_match
from uslam_tpu_torch.frontend.orb import Keypoints, extract_orb_batch
from uslam_tpu_torch.parallel.mesh import Mesh


def _local_slice(imgs, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slice of a (B, H, W) batch (numpy or tensor)
    as float32 on its device; B must divide the mesh size."""
    b = imgs.shape[0]
    if b % mesh.size:
        raise ValueError(
            f"frame batch {b} must divide the mesh size {mesh.size} "
            "(pad the batch; masks make padded frames cheap no-ops)"
        )
    per = b // mesh.size
    part = imgs[mesh.rank * per : (mesh.rank + 1) * per]
    part = torch.from_numpy(np.ascontiguousarray(part)) if isinstance(part, np.ndarray) else part
    return part.to(mesh.device).to(torch.float32)


def _gather(kp: Keypoints, mesh: Mesh) -> Keypoints:
    return Keypoints(*(all_gather_rows(a, mesh.group) for a in kp))


def extract_orb_frames_sharded(
    imgs, mesh: Mesh, cfg: FrontendConfig = FrontendConfig()
) -> Keypoints:
    """ORB over a frame batch (B, H, W), each rank on its slice:
    :func:`uslam_tpu_torch.frontend.orb.extract_orb_batch` of the whole
    batch, on every rank."""
    return _gather(extract_orb_batch(_local_slice(imgs, mesh), cfg), mesh)


def process_stereo_pairs_sharded(
    lefts, rights, mesh: Mesh, cfg: FrontendConfig = FrontendConfig()
):
    """ORB on both images and stereo Hamming matching over a batch of
    stereo pairs (B, H, W) each, each rank on its slice: the nodelet thread
    pool's per-frame image work (reference launch/stereo.launch:33). The
    rank's pairs go interleaved through one ``extract_orb_batch`` and one
    batched ``stereo_match``.

    Returns (kp_left, kp_right, stereo_idx, stereo_mask) of the whole
    batch on every rank. Temporal association (track ids) is sequential
    and stays in ``frontend.tracker``."""
    if lefts.shape != rights.shape:
        raise ValueError(f"lefts {tuple(lefts.shape)} != rights {tuple(rights.shape)}")
    left, right = _local_slice(lefts, mesh), _local_slice(rights, mesh)
    c = left.shape[0]
    kp = extract_orb_batch(torch.stack([left, right], 1).reshape((2 * c,) + left.shape[1:]), cfg)
    kp_l = Keypoints(*(a[0::2] for a in kp))
    kp_r = Keypoints(*(a[1::2] for a in kp))
    sm = stereo_match(
        kp_l.desc, kp_l.xy, kp_l.mask, kp_r.desc, kp_r.xy, kp_r.mask,
        max_distance=cfg.match_max_distance,
        ratio=cfg.match_ratio,
        max_v_diff=cfg.stereo_max_v_diff,
        min_disparity=cfg.stereo_min_disparity,
    )
    return (
        _gather(kp_l, mesh), _gather(kp_r, mesh),
        all_gather_rows(sm.idx, mesh.group), all_gather_rows(sm.mask, mesh.group),
    )
