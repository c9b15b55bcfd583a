"""CUDA graphs of the linearization and the error: the port's counterpart of
``jax.jit``.

The JAX package runs the LM's linearization and error as compiled device
programs (``_jitted_lm`` in ``uslam_tpu/pipeline.py``, the window steps in
``uslam_tpu/solvers/fixed_lag.py``). Run eagerly from Python, each call of
:func:`uslam_tpu_torch.solvers.linearize.linearize_graph` or ``graph_error``
is thousands of small launches, each paid for on the host. Here each is
captured once per input shape into a ``torch.cuda.CUDAGraph`` and replayed.

:func:`call` keeps a cache keyed as ``jax.jit`` keys its compilations:

- the input trees' structure (NamedTuples and tuples, by type), each
  tensor leaf's shape, dtype and device, and the value of every leaf that
  is not a tensor;
- the static scalars (sigmas, gravity, Huber delta).

The camera's intrinsics are tensor leaves and are copied in like the rest,
so a call with another camera of the same shapes replays the same graph.

An entry holds static input tensors (outside the graph's memory pool), the
graph, captured after one warm-up call on a side stream, and its static
outputs. A call copies the leaves into the static inputs, replays, and
returns clones of the outputs, so a result outlives the next replay of the
same entry (the LM keeps one linearization across several error replays;
the marginal linearizes again after the LM). Every entry on a device
shares one memory pool: the graphs run one at a time on one stream and
hold no state between replays outside their static inputs, and each
replay's outputs are cloned before another graph runs.

A failed capture raises; nothing falls back to the eager body. The
counters ``captures`` and ``replays`` (per function name) show whether a
stream of same-shaped calls recaptures. The kernel launches a graph holds
(counted by the wrappers while it was captured, when nothing ran) are
added to :data:`uslam_tpu_torch.cuda_build.launch_counts` at each replay.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from uslam_tpu_torch.cuda_build import launch_counts

captures: dict[str, int] = {}
replays: dict[str, int] = {}
_CACHE: dict = {}
_POOLS: dict = {}


class _Entry(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: object
    launches: dict


def reset_counts() -> None:
    captures.clear()
    replays.clear()


def _flatten(tree, leaves: list):
    """Structure key of ``tree``; its tensors are appended to ``leaves``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("T", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, tuple):  # NamedTuples too
        return ("N", type(tree), tuple(_flatten(t, leaves) for t in tree))
    return ("C", tree)


def _unflatten(struct, leaves):
    kind = struct[0]
    if kind == "T":
        return next(leaves)
    if kind == "N":
        children = [_unflatten(s, leaves) for s in struct[2]]
        cls = struct[1]
        return cls(*children) if cls is not tuple else tuple(children)
    return struct[1]


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        children = [_map_tensors(fn, t) for t in tree]
        return type(tree)(*children) if type(tree) is not tuple else tuple(children)
    return tree


def _capture(name: str, fn: Callable, struct, leaves: list, statics: tuple) -> _Entry:
    inputs = [leaf.clone() for leaf in leaves]
    args = _unflatten(struct, iter(inputs))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args, *statics)  # warm-up: lazy initialisation, kernel builds
    torch.cuda.current_stream().wait_stream(side)
    device = leaves[0].device
    pool = _POOLS.get(device)
    if pool is None:
        pool = _POOLS[device] = torch.cuda.graph_pool_handle()
    before = dict(launch_counts)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool):
            outputs = fn(*args, *statics)
    finally:
        # A captured launch does not run; the replays count it.
        launches = {k: launch_counts[k] - before.get(k, 0) for k in launch_counts}
        launch_counts.update(before)
    captures[name] = captures.get(name, 0) + 1
    return _Entry(graph, inputs, outputs, launches)


def call(name: str, fn: Callable, trees: tuple, statics: tuple):
    """``fn(*trees, *statics)`` through the graph cached for ``name``, the
    structure and shapes of ``trees`` and the values of ``statics``; every
    tensor of ``trees`` must lie on one CUDA device."""
    leaves: list = []
    struct = _flatten(tuple(trees), leaves)
    if not leaves:
        raise ValueError(f"{name}: no tensor to place the graph")
    device = leaves[0].device
    if device.type != "cuda" or any(leaf.device != device for leaf in leaves):
        raise ValueError(
            f"{name}: a CUDA graph needs every tensor on one CUDA device, got "
            f"{sorted({str(leaf.device) for leaf in leaves})}"
        )
    key = (name, struct, tuple(statics))
    with torch.cuda.device(device):
        entry = _CACHE.get(key)
        if entry is None:
            entry = _CACHE[key] = _capture(name, fn, struct, leaves, tuple(statics))
        for dst, src in zip(entry.inputs, leaves):
            dst.copy_(src)
        entry.graph.replay()
        for k, n in entry.launches.items():
            launch_counts[k] += n
        replays[name] = replays.get(name, 0) + 1
        return _map_tensors(torch.clone, entry.outputs)
