"""Checkpoint and resume of a container tree (port of
:mod:`uslam_tpu.utils.checkpoint`).

A NamedTuple tree of tensors (``Values``, ``GraphArrays``, ...) goes to one
npz: its leaves as ``leaf_{i}`` in field order, depth first, so the arrays
equal the JAX package's for the same tree, and a structure stamp of the
port's own under ``structure`` (type and field names, nested). The JAX
package stamps its own treedef under ``treedef``; each package checks only
its own stamp, so either loads the other's leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from uslam_tpu_torch.device import resolve_device


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves`` in field order; return its stamp."""
    if hasattr(tree, "_fields"):
        parts = [f"{f}={_flatten(getattr(tree, f), leaves)}" for f in tree._fields]
        return f"{type(tree).__name__}({','.join(parts)})"
    leaves.append(tree)
    return "*"


def _unflatten(like, it):
    if hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), it) for f in like._fields))
    return next(it)


def save_state(path: str, tree) -> None:
    leaves: list = []
    stamp = _flatten(tree, leaves)
    arrays = {
        f"leaf_{i}": leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
        for i, leaf in enumerate(leaves)
    }
    arrays["structure"] = np.frombuffer(stamp.encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path: str, like, device="cuda"):
    """Restore into the structure of ``like`` (a tree of the same types);
    tensor leaves go to ``device``. A file whose structure stamp differs
    from ``like``'s raises ValueError."""
    dev = resolve_device(device)
    leaves: list = []
    stamp = _flatten(like, leaves)
    with np.load(path) as z:
        if "structure" in z.files and z["structure"].tobytes() != stamp.encode():
            raise ValueError(
                f"checkpoint structure mismatch: {z['structure'].tobytes().decode()!r} "
                f"in the file, {stamp!r} expected"
            )
        new = [
            torch.tensor(z[f"leaf_{i}"], device=dev) if torch.is_tensor(leaf) else z[f"leaf_{i}"]
            for i, leaf in enumerate(leaves)
        ]
    return _unflatten(like, iter(new))
