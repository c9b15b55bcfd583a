"""The collectives of the landmark-sharded solve and the frame-parallel front
end, over a ``torch.distributed`` process group (the counterpart of the JAX
package's ``axis_name``). ``group=None`` means one device: every function
is then the identity and makes no call into ``torch.distributed``.

Every rank of a group must make the same calls in the same order; a rank
that does not leaves the others waiting until the group's timeout
(``parallel.mesh.make_mesh``) raises. Inside a CUDA graph (the sharded
LM's) nothing raises: a rank that makes a collective the others do not
hangs its replay. :func:`wait` bounds the host's wait on such a replay by
the group's timeout, past which it raises, as an eager collective does.
The first three functions read nothing on the host
(``dist.get_world_size`` and ``dist.get_global_rank`` are host lookups),
so a graph can hold them.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
import torch.distributed as dist

# How often a bounded wait asks the device whether the work has finished.
POLL_S = 1e-4


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group, in place (``jax.lax.psum``)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order
    (``jax.lax.all_gather(..., tiled=True)``), gathered by one call into
    one output. Booleans travel as uint8, which every backend carries."""
    if group is None:
        return x
    send = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    out = send.new_empty((dist.get_world_size(group) * send.shape[0], *send.shape[1:]))
    dist.all_gather_into_tensor(out, send, group=group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def from_first_rank(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the group's first rank holds it, on every rank, so that a
    decision taken on it (on the host, or on the device in a graph) is
    taken on the same bits everywhere."""
    if group is not None:
        x = x.clone()
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x


def any_rank(flag: torch.Tensor, group) -> bool:
    """True when ``flag`` (a 0-d bool tensor) is true on any rank."""
    count = flag.to(torch.int32)
    return bool(all_reduce_sum(count, group) > 0)


def timeout_s(group, device: torch.device) -> float:
    """The group's timeout in seconds (``parallel.mesh.make_mesh``'s
    ``timeout_s``), as its backend for ``device`` holds it."""
    return group._get_backend(device).options._timeout.total_seconds()


def wait(group, device: torch.device, what: str) -> None:
    """Wait on the host for the work queued so far on ``device``'s current
    stream (a replayed graph holding the group's collectives), at most the
    group's timeout, then raise ``RuntimeError``. A replay is out of reach
    of the group's watchdog and timeout: without this bound a peer that
    crashed or fell out of step would hang this rank for good.

    The group is not aborted: a replay stuck in an all-reduce its peers
    never joined outlived ``ProcessGroup.abort`` on four H100s, and the
    abort left the process's next CUDA call blocked (``chip_smoke.py``
    phase 12 (b)). After the error the replay may still run, so nothing
    may wait on the device or destroy the group: the process has to end
    (``os._exit``), as NCCL's watchdog ends it after an eager collective's
    timeout."""
    if group is None or device.type != "cuda":
        return
    done = torch.cuda.Event()
    done.record()
    bounded_wait(done.query, timeout_s(group, device), what)


def bounded_wait(done: Callable[[], bool], limit_s: float, what: str) -> None:
    """Poll ``done()`` every ``POLL_S`` until it is true; if ``limit_s``
    passes first, raise ``RuntimeError``."""
    deadline = time.monotonic() + limit_s
    while not done():
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"{what}: the process group's collectives did not finish within its "
                f"{limit_s} s timeout (a rank crashed or fell out of step); the replay may "
                "still run, so this process has to end without waiting on the device"
            )
        time.sleep(POLL_S)
