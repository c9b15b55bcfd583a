"""The collectives of the landmark-sharded solve and the frame-parallel front
end, over a ``torch.distributed`` process group (the counterpart of the JAX
package's ``axis_name``). ``group=None`` means one device: every function
is then the identity and makes no call into ``torch.distributed``.

Every rank of a group must make the same calls in the same order; a rank
that does not leaves the others waiting until the group's timeout
(``parallel.mesh.make_mesh``) raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group, in place (``jax.lax.psum``)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order
    (``jax.lax.all_gather(..., tiled=True)``). Booleans travel as uint8,
    which every backend carries."""
    if group is None:
        return x
    send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def from_first_rank(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the group's first rank holds it, on every rank, so that a
    host decision taken on it is the same bits everywhere."""
    if group is not None:
        x = x.clone()
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x


def any_rank(flag: torch.Tensor, group) -> bool:
    """True when ``flag`` (a 0-d bool tensor) is true on any rank."""
    count = flag.to(torch.int32)
    return bool(all_reduce_sum(count, group) > 0)
