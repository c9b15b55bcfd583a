"""Start the ranks of a mesh on one host: one process per rank.

    results = run_ranks(fn, world_size, *args, device="cuda")

Each rank calls ``fn(mesh, *args)`` with its
:class:`uslam_tpu_torch.parallel.mesh.Mesh` and the results come back in
rank order. Ranks are started with the ``spawn`` method (the caller may
hold threads, and a fork after them is unsafe), meet through a
``FileStore`` in a temporary directory (no TCP port to pick), and run
torch on one thread each. ``fn`` must be importable by name, and
``args`` and the results must pickle: they travel through files written
by ``torch.save`` (pass tensors on the CPU; each rank moves its part to
its device). ``device="cuda"`` gives rank r the GPU ``cuda:r`` over
NCCL, ``device="cpu"`` runs gloo ranks on the CPU. A world of one rank
runs in the calling process.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from uslam_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, close_mesh, make_mesh


def _rank_device(device, rank: int):
    return f"cuda:{rank}" if torch.device(device).type == "cuda" else device


def _rank_main(fn, rank: int, world_size: int, device, tmp: str, timeout_s: float) -> None:
    torch.set_num_threads(1)
    try:
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        store = dist.FileStore(os.path.join(tmp, "store"), world_size)
        mesh = make_mesh(rank, world_size, _rank_device(device, rank), store, timeout_s)
        try:
            out = fn(mesh, *args)
        finally:
            close_mesh(mesh)
        torch.save(out, os.path.join(tmp, f"result{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world_size: int, *args, device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S):
    """``[fn(mesh_r, *args) for r in range(world_size)]``, rank r in a
    process of its own (module docstring). Raises RuntimeError with the
    failed ranks' tracebacks, and TimeoutError (after stopping every
    rank) when a rank has not ended ``timeout_s`` after the last started."""
    if world_size == 1:
        mesh = make_mesh(0, 1, _rank_device(device, 0), timeout_s=timeout_s)
        try:
            return [fn(mesh, *args)]
        finally:
            close_mesh(mesh)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="uslam_ranks_") as tmp:
        torch.save(args, os.path.join(tmp, "args.pt"))
        procs = [
            ctx.Process(target=_rank_main, args=(fn, r, world_size, device, tmp, timeout_s))
            for r in range(world_size)
        ]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            stuck = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = []
        for r in range(world_size):
            path = os.path.join(tmp, f"error{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r} of {world_size}:\n{f.read()}")
        if errors:
            raise RuntimeError("ranks failed:\n" + "\n".join(errors))
        if stuck:
            raise TimeoutError(f"ranks {stuck} of {world_size} still running after {timeout_s} s")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(world_size)]
