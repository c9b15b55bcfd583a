"""Where the port's entry points run: the caller's device, the card by
default. Nothing here picks the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA without a usable GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cast_tree(tree, dtype: torch.dtype, device):
    """Container tree (NamedTuples of tensors) on ``device`` with every
    floating leaf cast to ``dtype``; integer leaves keep their type."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(cast_tree(x, dtype, device) for x in tree))
    return tree.to(device=device, dtype=dtype if tree.is_floating_point() else tree.dtype)
