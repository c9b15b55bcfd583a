"""The front end's two hand-written CUDA kernels, their plain PyTorch
versions, their launch counters and their build.

==============  ========================  =================================
wrapper         CUDA source               replaces (JAX package, Pallas)
==============  ========================  =================================
``fast_harris`` ``csrc/fast_harris.cu``   ``_fast_harris_kernel``
``hamming``     ``csrc/hamming.cu``       ``_hamming_kernel``
==============  ========================  =================================

Each wrapper dispatches on the device of the tensor it is given, and on
nothing else: a CPU tensor goes to the plain version, a CUDA tensor to the
kernel, anything else raises. There is no fallback from a failed build or
launch; both raise. ``FrontendConfig.use_pallas`` is not read.

The kernels are built, loaded and counted by
:mod:`uslam_tpu_torch.cuda_build` (one ``nvcc`` library of every
``csrc/*.cu``, built at first use); ``load``, ``launch_counts`` and
``reset_launch_counts`` are re-exported here.
"""

from __future__ import annotations

import torch

from uslam_tpu_torch.cuda_build import (  # noqa: F401  (re-exported)
    check_tensor as _check,
    launch_counts,
    load,
    raise_on as _raise_on,
    reset_launch_counts,
    stream_of as _stream,
)
from uslam_tpu_torch.frontend.fast import fast_corners, harris_response


# --------------------------------------------------------------------------
# FAST-9 + Harris
# --------------------------------------------------------------------------


def fast_harris_plain(imgs: torch.Tensor, threshold: float, k: float = 0.04):
    """Plain version: (B, H, W) f32 -> (corner bool, harris f32)."""
    return fast_corners(imgs, threshold), harris_response(imgs, k=k)


def fast_harris(imgs: torch.Tensor, threshold: float, k: float = 0.04):
    """FAST-9 corner flags (bool) and Harris response (f32) of a (B, H, W)
    float32 batch.

    Agrees with :func:`fast_harris_plain` on pixels at least 5 px inside the
    border; callers mask the 3 px border of ``corner`` themselves."""
    _check("fast_harris", imgs, torch.float32, 3)
    if imgs.device.type == "cpu":
        return fast_harris_plain(imgs, threshold, k)
    B, H, W = imgs.shape
    if not (B > 0 and H > 0 and W > 0):
        raise ValueError(f"fast_harris: unsupported shape {tuple(imgs.shape)}")
    lib = load()
    corner = torch.empty(imgs.shape, dtype=torch.bool, device=imgs.device)
    harris = torch.empty_like(imgs)
    code = lib.uslam_fast_harris(
        imgs.data_ptr(), corner.data_ptr(), harris.data_ptr(), B, H, W,
        float(threshold), float(k), _stream(imgs),
    )
    _raise_on(lib, code, "fast_harris")
    launch_counts["fast_harris"] += 1
    return corner, harris


# --------------------------------------------------------------------------
# Hamming distance matrices
# --------------------------------------------------------------------------


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word (its 32-bit pattern), SWAR on int64."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_plain(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, Na, 8) x (B, Nb, 8) int32 -> (B, Na, Nb) int32."""
    x = torch.bitwise_xor(da[:, :, None, :], db[:, None, :, :])
    return popcount32(x).sum(dim=-1, dtype=torch.int32)


def hamming(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Hamming distances between the 256-bit descriptors of each frame:
    (B, Na, 8) x (B, Nb, 8) int32 bit-views -> (B, Na, Nb) int32."""
    _check("hamming", da, torch.int32, 3)
    _check("hamming", db, torch.int32, 3)
    if da.shape[0] != db.shape[0] or da.shape[2] != 8 or db.shape[2] != 8:
        raise ValueError(f"hamming: shapes {tuple(da.shape)} x {tuple(db.shape)}")
    if da.device != db.device:
        raise ValueError(f"hamming: devices {da.device} and {db.device}")
    if da.device.type == "cpu":
        return hamming_plain(da, db)
    B, Na, Nb = da.shape[0], da.shape[1], db.shape[1]
    out = torch.empty((B, Na, Nb), dtype=torch.int32, device=da.device)
    if out.numel() == 0:
        return out
    # Grid (B, Na / 64, Nb / 64); descriptors read as 16-byte words.
    if max(-(-Na // 64), -(-Nb // 64)) > 65535 or da.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError(
            f"hamming: unsupported shape or alignment {tuple(da.shape)} x {tuple(db.shape)}"
        )
    lib = load()
    code = lib.uslam_hamming(
        da.data_ptr(), db.data_ptr(), out.data_ptr(), B, Na, Nb, _stream(da)
    )
    _raise_on(lib, code, "hamming")
    launch_counts["hamming"] += 1
    return out
