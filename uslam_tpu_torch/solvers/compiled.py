"""CUDA graphs of the linearization, the error and the LM: the port's
counterpart of ``jax.jit``.

The JAX package runs the LM as one compiled device program: a
``lax.while_loop`` under ``jax.jit`` (``_jitted_lm`` in
``uslam_tpu/pipeline.py``, the window steps in
``uslam_tpu/solvers/fixed_lag.py``). Run eagerly from Python, each call of
:func:`uslam_tpu_torch.solvers.linearize.linearize_graph`, ``graph_error``
or an LM iteration is thousands of small launches, each paid for on the
host. Here each is captured once per input shape into a
``torch.cuda.CUDAGraph`` and replayed.

:func:`call` keeps a cache keyed as ``jax.jit`` keys its compilations:

- the input trees' structure (NamedTuples and tuples, by type), each
  tensor leaf's shape, dtype and device, and the value of every leaf that
  is not a tensor;
- the static scalars (sigmas, gravity, Huber delta, a solver config).

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

:func:`loop` is the ``lax.while_loop``: one step captured once, whose
carried state lives in the graph's static inputs. The step writes its new
state back into them inside the graph, so the host replays it with no
copy in between, and reads one word, "stopped", after every block of
replays.

Graphs do not nest: while a body is warmed up or captured
(:func:`capturing`), a graphed function called inside it runs its eager
body, which is captured with the rest.

A failed capture raises; nothing falls back to the eager body. The
counters ``captures``, ``replays`` and ``reads`` (per name; ``reads``
counts the host reads of :func:`loop`) show whether a stream of
same-shaped calls recaptures and how often the host waits. The kernel
launches a graph holds (counted by the wrappers while it was captured,
when nothing ran) are added to
:data:`uslam_tpu_torch.cuda_build.launch_counts` at each replay.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, NamedTuple

import torch

from uslam_tpu_torch.cuda_build import launch_counts

captures: dict[str, int] = {}
replays: dict[str, int] = {}
reads: dict[str, int] = {}
capture_ms: dict[str, float] = {}   # host ms of the warm-ups and captures, per name
_CACHE: dict = {}
_POOLS: dict = {}
_DEPTH = [0]   # > 0 while a body is warmed up or captured


class _Entry(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: object
    launches: dict


def reset_counts() -> None:
    captures.clear()
    replays.clear()
    reads.clear()
    capture_ms.clear()


def capturing() -> bool:
    """True while a graph's body is being warmed up or captured: graphed
    functions run their eager bodies, and nothing may read the host."""
    return _DEPTH[0] > 0


@contextlib.contextmanager
def _tracing():
    _DEPTH[0] += 1
    try:
        yield
    finally:
        _DEPTH[0] -= 1


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


def _leaves(name: str, trees) -> tuple:
    """(structure, tensor leaves) of ``trees``, all on one CUDA device."""
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
    return struct, leaves


def _capture(name: str, body: Callable, inputs: list) -> tuple:
    """Warm up ``body()`` on a side stream, then capture it; returns
    (graph, its outputs, the kernel launches it holds)."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with _tracing():
        with torch.cuda.stream(side):
            body()  # lazy initialisation, kernel builds
        torch.cuda.current_stream().wait_stream(side)
        device = inputs[0].device
        pool = _POOLS.get(device)
        if pool is None:
            pool = _POOLS[device] = torch.cuda.graph_pool_handle()
        before = dict(launch_counts)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool):
                outputs = body()
        finally:
            # A captured launch does not run; the replays count it.
            launches = {k: launch_counts[k] - before.get(k, 0) for k in launch_counts}
            launch_counts.update(before)
    captures[name] = captures.get(name, 0) + 1
    capture_ms[name] = capture_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
    return graph, outputs, launches


def _replay(name: str, entry: _Entry) -> None:
    entry.graph.replay()
    for k, n in entry.launches.items():
        launch_counts[k] += n
    replays[name] = replays.get(name, 0) + 1


def call(name: str, fn: Callable, trees: tuple, statics: tuple):
    """``fn(*trees, *statics)`` through the graph cached for ``name``, the
    structure and shapes of ``trees`` and the values of ``statics``; every
    tensor of ``trees`` must lie on one CUDA device. Inside another body
    (:func:`capturing`) ``fn`` runs as it is."""
    if capturing():
        return fn(*trees, *statics)
    struct, leaves = _leaves(name, trees)
    key = (name, struct, tuple(statics))
    with torch.cuda.device(leaves[0].device):
        entry = _CACHE.get(key)
        if entry is None:
            inputs = [leaf.clone() for leaf in leaves]
            args = _unflatten(struct, iter(inputs))
            graph, outputs, launches = _capture(name, lambda: fn(*args, *statics), inputs)
            entry = _CACHE[key] = _Entry(graph, inputs, outputs, launches)
        for dst, src in zip(entry.inputs, leaves):
            dst.copy_(src)
        _replay(name, entry)
        return _map_tensors(torch.clone, entry.outputs)


def loop(name: str, step: Callable, consts: tuple, carry, statics: tuple, max_steps: int,
         per_read: int):
    """Replay the graph of ``step`` until it reports "stopped", at most
    ``max_steps`` times; returns the final carry (clones).

    ``step(*consts, carry, *statics)`` returns (the carry after one step, a
    0-d bool "stopped") and must leave a stopped carry as it is. The graph,
    cached as :func:`call` caches it (``consts`` and ``carry`` both key
    it), copies the new carry into its static inputs, so the replays chain
    with no copy in between. The host reads "stopped" after every
    ``per_read`` replays but after the last: at most ``ceil(max_steps /
    per_read) - 1`` reads, none when one block of replays is enough."""
    c_struct, c_leaves = _leaves(name, consts)
    s_struct, s_leaves = _leaves(name, (carry,))
    key = ("loop", name, c_struct, s_struct, tuple(statics))
    with torch.cuda.device(s_leaves[0].device):
        entry = _CACHE.get(key)
        if entry is None:
            c_in = [leaf.clone() for leaf in c_leaves]
            s_in = [leaf.clone() for leaf in s_leaves]
            args = _unflatten(c_struct, iter(c_in))
            state = _unflatten(s_struct, iter(s_in))[0]

            def body():
                new, stopped = step(*args, state, *statics)
                new_leaves: list = []
                if _flatten((new,), new_leaves) != s_struct:
                    raise ValueError(f"{name}: the step changed its carry's structure")
                for dst, src in zip(s_in, new_leaves):
                    dst.copy_(src)
                return stopped

            graph, stopped, launches = _capture(name, body, s_in)
            entry = _CACHE[key] = _Entry(graph, (c_in, s_in), stopped, launches)
        c_in, s_in = entry.inputs
        for dst, src in zip(c_in + s_in, c_leaves + s_leaves):
            dst.copy_(src)
        for done in range(1, max_steps + 1):
            _replay(name, entry)
            if done == max_steps:
                break
            if done % per_read == 0:
                reads[name] = reads.get(name, 0) + 1
                if bool(entry.outputs):
                    break
        return _unflatten(s_struct, iter([x.clone() for x in s_in]))[0]
