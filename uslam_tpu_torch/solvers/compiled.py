"""CUDA graphs of the linearization, the error and the LM: the port's
counterpart of ``jax.jit``, ``jax.lax.while_loop`` and ``jax.lax.cond``.

The JAX package runs the LM as one compiled device program: a
``lax.while_loop`` under ``jax.jit`` (``_jitted_lm`` in
``uslam_tpu/pipeline.py``, the window steps in
``uslam_tpu/solvers/fixed_lag.py``), whose step re-linearizes under
``lax.cond`` and whose CG is another ``lax.while_loop``. Run eagerly from
Python, each call of
:func:`uslam_tpu_torch.solvers.linearize.linearize_graph`, ``graph_error``
or an LM iteration is thousands of small launches, each paid for on the
host. Here each is captured once per input shape into a
``torch.cuda.CUDAGraph`` and replayed.

:func:`call` keeps a cache keyed as ``jax.jit`` keys its compilations:

- the input trees' structure (NamedTuples and tuples, by type), each
  tensor leaf's shape, dtype, device and strides, and the value of every
  leaf that is not a tensor;
- the static scalars (sigmas, gravity, Huber delta, a solver config);
- for a graph that holds collectives, its ``torch.distributed`` process
  group (the object itself, so a destroyed group's id cannot name another
  group's graph), this rank and the world size. Such a graph launches on
  the group's communicator: :func:`evict_group` drops it before the group
  is destroyed (``parallel.mesh.close_mesh``).

The camera's intrinsics are tensor leaves and are copied in like the rest,
so a call with another camera of the same shapes replays the same graph.

An entry holds static input tensors (outside the graph's memory pool, in
the layout of the call's leaves), the graph, captured after one warm-up
call on a side stream, and its static outputs. A call copies the leaves
into the static inputs, replays, and returns clones of the outputs, so a result outlives the next replay of the
same entry (the LM keeps one linearization across several error replays;
the marginal linearizes again after the LM). Every entry on a device
shares one memory pool: the graphs run one at a time on one stream and
hold no state between replays outside their static inputs, and each
replay's outputs are cloned before another graph runs.

:func:`while_loop` and :func:`cond` take the JAX primitives' arguments.
Outside a capture they run eagerly: the loop reads its condition on the
host before every iteration, ``cond`` reads its predicate and runs one
branch (the CPU, ``debug_nans``, ``graphed=False``). Inside a capture they
become the graph's conditional nodes (``csrc/graph_cond.cu``): a WHILE
node, whose body ends by setting the loop's handle from the condition of
the new carry, and an IF node with an else body, its handle set from the
predicate. A loop's condition may be a :class:`Test` (a counter below a
limit, a value above a threshold, a stop flag) instead of a bool tensor:
the condition kernel then computes it from the carry's own tensors, one
kernel node per test, and :meth:`Test.flag` is its plain version. The
carry lives in buffers made before the node, which the body writes; the
branches' results in buffers the then-body makes and the else-body
writes. A body is captured from a stream of its own per depth of
nesting, its allocations in a memory pool of that depth, so nodes nest (the
CG's loop inside the LM's). While a graph's body is warmed up, each
loop's body and both branches run once. A capture or instantiation that
fails raises; nothing falls back to the eager body.

Graphs do not nest otherwise: while a body is warmed up or captured
(:func:`capturing`), a graphed function called inside it runs its eager
body, which is captured with the rest.

The counters ``captures`` and ``replays`` show whether a stream of
same-shaped calls recaptures; ``reads`` counts the host reads of the eager
primitives and of :func:`read`, per name; ``runs`` how often each named
body ran (a loop's body, or then and else), eagerly or on the device. The
kernel launches a graph holds (counted by the wrappers while it was
captured, when nothing ran) are added to
:data:`uslam_tpu_torch.cuda_build.launch_counts` at each replay; those in
a conditional body are multiplied by the body's runs, which the condition
kernel counts on the device, when the host next reads them: in
:func:`read` (the LM's one read of its statistics) or
:func:`settle_launches`. Within :func:`recording_nodes` a capture reads the
node types of its graph and bodies into ``body_nodes`` (what a body holds:
NCCL's event nodes, for one, which no body takes).
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from uslam_tpu_torch import cuda_build
from uslam_tpu_torch.cuda_build import launch_counts, load

captures: dict[str, int] = {}
replays: dict[str, int] = {}
reads: dict[str, int] = {}
runs: dict[str, list] = {}          # name -> [then or loop body runs, else runs]
capture_ms: dict[str, float] = {}   # host ms of the warm-ups and captures, per name
body_nodes: dict[str, dict] = {}    # name -> body index -> node type -> count (recording_nodes)
_CACHE: dict = {}
_POOLS: dict = {}
_DEPTH = [0]        # > 0 while a body is warmed up or captured
_NODES: list = []   # per capture under way: (its conditional nodes, their counts)
_MAX_NODES = 64     # conditional nodes in one graph
_BODIES: dict = {}  # (device, depth) -> (stream, memory pool) of conditional bodies
_NESTING = [0]      # conditional bodies being captured
_UNSETTLED: dict = {}  # id(entry) -> an entry replayed since its counts were read
_RECORD = [False]   # inside recording_nodes()
_PENDING: list = []  # (name, body index, body graph) of the capture under way, to read
_IF, _WHILE = 0, 1


class Test(NamedTuple):
    """A loop's test: ``counter < limit``, and ``value > threshold`` where
    both are given, and ``not stop`` where ``stop`` is given. ``counter``
    is a 0-d int64 tensor, ``limit`` a Python int (fixed in a graph, as the
    loop's bound is in its cache key), ``value`` and ``threshold`` 0-d
    float32 or float64 tensors of one type, ``stop`` a 0-d bool tensor.
    In a capture the condition kernel computes it on the device; eagerly,
    and on the CPU, :meth:`flag` does, in torch (NaN > x is false in
    both)."""
    counter: torch.Tensor
    limit: int
    value: torch.Tensor | None = None
    threshold: torch.Tensor | None = None
    stop: torch.Tensor | None = None

    def flag(self) -> torch.Tensor:
        """The test as a 0-d bool tensor: the kernel's plain version."""
        go = self.counter < self.limit
        if self.value is not None:
            go = go & (self.value > self.threshold)
        if self.stop is not None:
            go = go & ~self.stop
        return go


class _CondArgs(ctypes.Structure):
    """``struct Cond`` of ``csrc/graph_cond.cu``: what the condition kernel
    sets a handle from (a bool's address, or a :class:`Test`'s operands)."""
    _fields_ = [("flag", ctypes.c_void_p), ("counter", ctypes.c_void_p),
                ("limit", ctypes.c_longlong), ("value", ctypes.c_void_p),
                ("threshold", ctypes.c_void_p), ("stop", ctypes.c_void_p),
                ("value_type", ctypes.c_int)]


class _CondNode(NamedTuple):
    name: str
    handle: int
    counts: torch.Tensor   # int64 (2,): the handle set to 1, to 0, over every replay
    launches: list         # per body (then, else; or the loop's): its kernel launches


class _Entry(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: object
    launches: dict
    nodes: tuple
    settled: list           # per node: its counts as last read


def reset_counts() -> None:
    """Clear the counters, after adding the runs still counted on the
    device (one host read when a conditional node ran)."""
    settle_launches()
    captures.clear()
    replays.clear()
    reads.clear()
    runs.clear()
    capture_ms.clear()
    body_nodes.clear()


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


def _flatten(tree, leaves: list, layout: bool = False):
    """Structure key of ``tree``; its tensors are appended to ``leaves``.
    With ``layout`` the key holds each tensor's strides too."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        key = ("T", tuple(tree.shape), tree.dtype, tree.device)
        return key + (tree.stride(),) if layout else key
    if isinstance(tree, tuple):  # NamedTuples too
        return ("N", type(tree), tuple(_flatten(t, leaves, layout) for t in tree))
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
    struct = _flatten(tuple(trees), leaves, layout=True)
    if not leaves:
        raise ValueError(f"{name}: no tensor to place the graph")
    device = leaves[0].device
    if device.type != "cuda" or any(leaf.device != device for leaf in leaves):
        raise ValueError(
            f"{name}: a CUDA graph needs every tensor on one CUDA device, got "
            f"{sorted({str(leaf.device) for leaf in leaves})}"
        )
    return struct, leaves


@contextlib.contextmanager
def recording_nodes():
    """Within: each capture keeps its graph until it has read the node
    types of the graph (``body_nodes[name]["graph"]``) and of every
    conditional body (``body_nodes[node name][body index]``) into
    :data:`body_nodes` (a failed read is recorded as ``{"error": ...}``),
    then instantiates it. A check's tool: it shows what a graph holds."""
    _RECORD[0] = True
    try:
        yield
    finally:
        _RECORD[0] = False


def _capture(name: str, body: Callable, inputs: list) -> tuple:
    """Warm up ``body()`` on a side stream, then capture it; returns
    (graph, its outputs, the kernel launches it holds outside conditional
    bodies, its conditional nodes)."""
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
        record = _RECORD[0]
        graph = torch.cuda.CUDAGraph(keep_graph=True) if record else torch.cuda.CUDAGraph()
        # The nodes' counts accumulate over every replay, so they live
        # outside the pools: memory a capture hands out is reused by the
        # graph's earlier nodes, in a loop's next iteration too.
        _NODES.append(([], torch.zeros((_MAX_NODES, 2), dtype=torch.int64, device=device)))
        try:
            with torch.cuda.graph(graph, pool=pool):
                outputs = body()
        finally:
            nodes = tuple(_NODES.pop()[0])
            # A captured launch does not run; the replays count it.
            launches = {k: launch_counts[k] - before.get(k, 0) for k in launch_counts}
            launch_counts.update(before)
            pending = list(_PENDING)
            _PENDING.clear()
        if record:
            body_nodes.setdefault(name, {})["graph"] = _node_types(graph.raw_cuda_graph())
            for body_name, index, body_graph in pending:
                body_nodes.setdefault(body_name, {})[index] = _node_types(body_graph)
            graph.instantiate()
    captures[name] = captures.get(name, 0) + 1
    capture_ms[name] = capture_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
    return graph, outputs, launches, nodes


def _replay(name: str, entry: _Entry) -> None:
    entry.graph.replay()
    for k, n in entry.launches.items():
        launch_counts[k] += n
    if entry.nodes:
        _UNSETTLED[id(entry)] = entry
    replays[name] = replays.get(name, 0) + 1


def _group_key(group) -> tuple | None:
    if group is None:
        return None
    return (group, dist.get_rank(group), dist.get_world_size(group))


def call(name: str, fn: Callable, trees: tuple, statics: tuple, group=None):
    """``fn(*trees, *statics)`` through the graph cached for ``name``, the
    structure, shapes and strides of ``trees`` and the values of
    ``statics``; every tensor of ``trees`` must lie on one CUDA device.
    ``group``: the process group whose collectives ``fn`` makes (every rank
    of it must make the same calls); the key is then ``(name, structure,
    statics, (group, rank, world size))``, else its last part is None.
    Inside another body (:func:`capturing`) ``fn`` runs as it is."""
    if capturing():
        return fn(*trees, *statics)
    struct, leaves = _leaves(name, trees)
    key = (name, struct, tuple(statics), _group_key(group))
    with torch.cuda.device(leaves[0].device):
        entry = _CACHE.get(key)
        if entry is None:
            # The leaves' own strides (the key holds them): a matrix product
            # sums in another order on a transposed operand, so a graph
            # computes as the eager body does on inputs of this layout.
            inputs = [torch.empty_strided(leaf.shape, leaf.stride(), dtype=leaf.dtype,
                                          device=leaf.device).copy_(leaf) for leaf in leaves]
            args = _unflatten(struct, iter(inputs))
            graph, outputs, launches, nodes = _capture(
                name, lambda: fn(*args, *statics), inputs)
            entry = _CACHE[key] = _Entry(graph, inputs, outputs, launches, nodes,
                                         [[0, 0] for _ in nodes])
        for dst, src in zip(entry.inputs, leaves):
            dst.copy_(src)
        _replay(name, entry)
        return _map_tensors(torch.clone, entry.outputs)


def evict_group(group) -> int:
    """Drop every cached graph that holds ``group``'s collectives (after
    reading the counts of those replayed since their last read); returns
    how many. Call it before the group is destroyed: a replay would launch
    on a dead communicator."""
    settle_launches()
    keys = [k for k in _CACHE if k[3] is not None and k[3][0] is group]
    for k in keys:
        del _CACHE[k]
    return len(keys)


# ---- reading the device's counts -------------------------------------------

def count_runs(name: str, then: int, other: int = 0) -> None:
    """Add to ``runs[name]``: a loop body's (or a then-branch's) runs and an
    else-branch's."""
    if not (then or other):
        return
    r = runs.setdefault(name, [0, 0])
    r[0] += then
    r[1] += other


def _settle(device: torch.device, values: tuple = ()) -> list:
    """One host read of ``values`` (0-d tensors on ``device``) and of the
    counts of the conditional nodes replayed on ``device`` since their last
    read; adds the launches their bodies held times their runs to
    ``launch_counts``. Returns ``values`` as Python floats."""
    entries = [e for e in _UNSETTLED.values() if e.inputs[0].device == device]
    counts = [node.counts for e in entries for node in e.nodes]
    parts = [torch.stack([v.double() for v in values]).reshape(-1)] if values else []
    parts += [c.double() for c in counts]
    if not parts:
        return []
    flat = torch.cat(parts).tolist()
    out, flat = flat[:len(values)], iter(flat[len(values):])
    for e in entries:
        for node, seen in zip(e.nodes, e.settled):
            now = [int(next(flat)), int(next(flat))]
            ran = [now[0] - seen[0], now[1] - seen[1]]
            seen[:] = now
            for body, n in zip(node.launches, ran):
                for k, per in body.items():
                    launch_counts[k] += per * n
            # A WHILE node's second count is its exits, not a body's runs.
            count_runs(node.name, ran[0], ran[1] if len(node.launches) == 2 else 0)
        del _UNSETTLED[id(e)]
    return out


def read(values, name: str = "read") -> list:
    """The one host read: ``values`` (0-d tensors on one device) as Python
    floats, with the device's counts of the conditional nodes replayed
    since their last read (:func:`settle_launches`) in the same copy."""
    values = tuple(values)
    reads[name] = reads.get(name, 0) + 1
    if values[0].device.type != "cuda":
        return torch.stack([v.double() for v in values]).tolist()
    return _settle(values[0].device, values)


def settle_launches() -> None:
    """Read the counts of every conditional node replayed since their last
    read (one host read per device) and add the launches their bodies ran
    to ``launch_counts`` and their runs to ``runs``."""
    for device in {e.inputs[0].device for e in _UNSETTLED.values()}:
        _settle(device)


cuda_build.before_reset.append(settle_launches)


# ---- conditional nodes -------------------------------------------------------

def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.uslam_cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA graph conditional node: {what} failed: {msg} ({code})")


def _flag(flag, what: str) -> torch.Tensor:
    if not (isinstance(flag, torch.Tensor) and flag.dtype == torch.bool and flag.numel() == 1
            and flag.device.type == "cuda"):
        raise ValueError(f"{what} needs a one-element bool tensor on a CUDA device in a graph, "
                         f"got {flag!r}")
    return flag


def _scalar(t, dtypes: tuple, device, what: str, part: str) -> int:
    if not (isinstance(t, torch.Tensor) and t.dtype in dtypes and t.dim() == 0
            and t.device == device):
        raise ValueError(f"{what}: the test's {part} must be a 0-d {' or '.join(map(str, dtypes))} "
                         f"tensor on {device}, got {t!r}")
    return t.data_ptr()


def _cond_args(cond, what: str) -> tuple:
    """(``_CondArgs`` of ``cond``, its device): a one-element bool tensor
    on a CUDA device, or a :class:`Test` of 0-d tensors on one."""
    if not isinstance(cond, Test):
        flag = _flag(cond, what)
        return _CondArgs(flag=flag.data_ptr()), flag.device
    device = cond.counter.device if isinstance(cond.counter, torch.Tensor) else None
    if device is None or device.type != "cuda":
        raise ValueError(f"{what}: a test in a graph needs its tensors on a CUDA device, "
                         f"got {cond!r}")
    if not isinstance(cond.limit, int) or not -2**63 <= cond.limit < 2**63:
        raise ValueError(f"{what}: the test's limit must be an int64, got {cond.limit!r}")
    args = _CondArgs(counter=_scalar(cond.counter, (torch.int64,), device, what, "counter"),
                     limit=cond.limit)
    if (cond.value is None) != (cond.threshold is None):
        raise ValueError(f"{what}: a test needs both value and threshold, or neither")
    if cond.value is not None:
        floats = (torch.float32, torch.float64)
        args.value = _scalar(cond.value, floats, device, what, "value")
        args.threshold = _scalar(cond.threshold, (cond.value.dtype,), device, what, "threshold")
        args.value_type = int(cond.value.dtype == torch.float64)
    if cond.stop is not None:
        args.stop = _scalar(cond.stop, (torch.bool,), device, what, "stop")
    return args, device


def _read_flag(flag, name: str) -> bool:
    reads[name] = reads.get(name, 0) + 1
    return bool(flag.flag() if isinstance(flag, Test) else flag)


def _body_stream(device: torch.device, depth: int) -> tuple:
    """(stream, memory pool) of the conditional bodies at ``depth``."""
    key = (device, depth)
    if key not in _BODIES:
        lib = load()
        ptr = ctypes.c_void_p()
        _check(lib, lib.uslam_stream_create(ctypes.byref(ptr)), "stream creation")
        _BODIES[key] = (torch.cuda.ExternalStream(ptr.value, device=device),
                        torch.cuda.graph_pool_handle())
    return _BODIES[key]


def _node(kind: int, cond, name: str) -> tuple:
    """Add a conditional node after the kernel that sets its handle from
    ``cond`` (a bool tensor or a :class:`Test`), on the stream under
    capture; returns (the node, its body graphs)."""
    args, device = _cond_args(cond, name)
    lib = load()
    stream = torch.cuda.current_stream(device)
    nodes, all_counts = _NODES[-1]
    if len(nodes) == _MAX_NODES:
        raise ValueError(f"{name}: more than {_MAX_NODES} conditional nodes in one graph")
    counts = all_counts[len(nodes)]
    handle = ctypes.c_ulonglong()
    bodies = (ctypes.c_void_p * 2)()
    _check(lib, lib.uslam_cond_node(stream.cuda_stream, kind, ctypes.addressof(args),
                                    counts.data_ptr(), ctypes.byref(handle), bodies),
           f"{name}: adding the node")
    launch_counts["graph_cond"] += 1
    node = _CondNode(name, handle.value, counts, [])
    nodes.append(node)
    return node, list(bodies)[: 2 if kind == _IF else 1]


@contextlib.contextmanager
def _body(node: _CondNode, graph: int, device: torch.device):
    """Capture what runs inside into the body ``graph`` of ``node``, from
    this depth's stream, allocating from this depth's pool; the kernel
    launches it holds go to ``node.launches``."""
    stream, pool = _body_stream(device, _NESTING[0])
    lib = load()
    _check(lib, lib.uslam_capture_to(stream.cuda_stream, graph), f"{node.name}: body capture")
    before = dict(launch_counts)
    _NESTING[0] += 1
    try:
        with torch.cuda.stream(stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(device.index, pool)
            try:
                yield
            finally:
                torch._C._cuda_endAllocateToPool(device.index, pool)
    finally:
        _NESTING[0] -= 1
        node.launches.append({k: launch_counts[k] - before[k] for k in launch_counts})
        launch_counts.update(before)
        code = lib.uslam_capture_end(stream.cuda_stream)
    _check(lib, code, f"{node.name}: body capture")
    if _RECORD[0]:
        _PENDING.append((node.name, len(node.launches) - 1, graph))


# cudaGraphNodeType, by value
_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "child graph", "empty", "event wait",
               "event record", "semaphore signal", "semaphore wait", "mem alloc", "mem free",
               "batch mem op", "conditional")


def _node_types(graph: int) -> dict:
    """Node type -> count of the nodes of a body ``graph`` whose capture
    has ended, or ``{"error": ...}``."""
    lib = load()
    count = ctypes.c_int()
    code = lib.uslam_graph_node_types(graph, None, 0, ctypes.byref(count))
    types = (ctypes.c_int * max(count.value, 1))()
    if code == 0:
        code = lib.uslam_graph_node_types(graph, types, count.value, ctypes.byref(count))
    if code != 0:
        return {"error": f"{lib.uslam_cuda_error_string(code).decode()} ({code})"}
    out: dict = {}
    for t in types[: count.value]:
        if t < 0:
            label = f"unread: {lib.uslam_cuda_error_string(-t).decode()} ({-t})"
        else:
            label = _NODE_TYPES[t] if t < len(_NODE_TYPES) else f"type {t}"
        out[label] = out.get(label, 0) + 1
    return out


def _set(node: _CondNode, cond) -> None:
    """The condition kernel on the stream under capture: ``node``'s handle
    from ``cond``, a bool tensor or a :class:`Test` (a WHILE body's last
    node)."""
    args, device = _cond_args(cond, node.name)
    lib = load()
    stream = torch.cuda.current_stream(device)
    _check(lib, lib.uslam_cond_set(stream.cuda_stream, node.handle, ctypes.addressof(args),
                                   node.counts.data_ptr()), f"{node.name}: the condition kernel")
    launch_counts["graph_cond"] += 1


def _assign(dsts: list, srcs: list) -> None:
    """Copy ``srcs`` into ``dsts`` leaf by leaf; a source that shares memory
    with a destination is cloned first, so no copy reads what another
    wrote."""
    held = {d.untyped_storage().data_ptr() for d in dsts}
    srcs = [s.clone() if s is not d and s.untyped_storage().data_ptr() in held else s
            for s, d in zip(srcs, dsts)]
    for d, s in zip(dsts, srcs):
        if s is not d:
            d.copy_(s)


def _warming_up() -> bool:
    """Inside :func:`capturing`: a body's warm-up, not its capture."""
    return not torch.cuda.is_current_stream_capturing()


def while_loop(cond_fun: Callable, body_fun: Callable, init, *, name: str = "while_loop"):
    """``jax.lax.while_loop``: ``body_fun`` applied to the carry while
    ``cond_fun`` of it is true (a one-element bool tensor, or a
    :class:`Test` of the carry's tensors); ``body_fun`` keeps the carry's
    structure, shapes and dtypes. Eagerly one host read per test; in a
    capture a WHILE node (no host read), each test one condition kernel
    (a bool tensor's flag is computed first, in the kernels that make
    it)."""
    if not capturing():
        val = init
        while _read_flag(cond_fun(val), name):
            val = body_fun(val)
            count_runs(name, 1)
        return val
    if _warming_up():
        return body_fun(init)
    leaves: list = []
    struct = _flatten(init, leaves)
    carry_leaves = [leaf.clone() for leaf in leaves]
    carry = _unflatten(struct, iter(carry_leaves))
    first = cond_fun(carry)
    node, (graph,) = _node(_WHILE, first, name)
    with _body(node, graph, (first.counter if isinstance(first, Test) else first).device):
        new_leaves: list = []
        if _flatten(body_fun(carry), new_leaves) != struct:
            raise ValueError(f"while_loop {name!r}: the body changed its carry's structure")
        _assign(carry_leaves, new_leaves)
        _set(node, cond_fun(carry))
    return carry


def cond(pred, true_fun: Callable, false_fun: Callable, *operands, name: str = "cond"):
    """``jax.lax.cond``: ``true_fun(*operands)`` if ``pred`` (a one-element
    bool tensor) else ``false_fun(*operands)``; both give the same
    structure, shapes and dtypes. Eagerly one host read; in a capture an
    IF node with an else body (no host read)."""
    if not capturing():
        if _read_flag(pred, name):
            count_runs(name, 1)
            return true_fun(*operands)
        count_runs(name, 0, 1)
        return false_fun(*operands)
    if _warming_up():
        out = true_fun(*operands)
        if _flatten(false_fun(*operands), []) != _flatten(out, []):
            raise ValueError(f"cond {name!r}: the branches differ in structure")
        return out
    pred = _flag(pred, f"cond {name!r}")
    node, (then_graph, else_graph) = _node(_IF, pred, name)
    leaves: list = []
    with _body(node, then_graph, pred.device):
        struct = _flatten(true_fun(*operands), leaves)
        out = [leaf.clone() for leaf in leaves]   # written by either body
    other: list = []
    with _body(node, else_graph, pred.device):
        if _flatten(false_fun(*operands), other) != struct:
            raise ValueError(f"cond {name!r}: the branches differ in structure")
        _assign(out, other)
    return _unflatten(struct, iter(out))
