"""The landmark-sharded LM as one CUDA graph per solve on each rank: what
the CPU can hold of it. The graphs themselves run only on the card
(``chip_smoke.py`` phases 2 and 12); here, the refusal on CPU tensors, the
graph cache's eviction by process group, ``close_mesh``'s use of it, and
the one-call gather on a gloo group of one rank. No JAX: the rest of the
sharded path is held to the JAX package by tests/test_torch_parallel.py.
"""

import time

import pytest
import torch

from uslam_tpu_torch import collectives
from uslam_tpu_torch.collectives import all_gather_rows
from uslam_tpu_torch.config import SolverConfig
from uslam_tpu_torch.graph.values import Values
from uslam_tpu_torch.parallel import make_mesh
from uslam_tpu_torch.parallel.mesh import close_mesh
from uslam_tpu_torch.solvers import compiled
from uslam_tpu_torch.solvers.lm import solve_lm


def _values(n: int = 3, m: int = 2) -> Values:
    z = torch.zeros
    return Values(pose_quat=z((n, 4)), pose_trans=z((n, 3)), vel=z((n, 3)), bias=z((6,)),
                  landmarks=z((m, 3)))


def test_graphed_sharded_solve_on_cpu_raises_naming_cuda():
    with pytest.raises(ValueError, match="CUDA") as err:
        solve_lm(None, _values(), None, 0.1, 1.0, 9.81, SolverConfig(), group=object(),
                 graphed=True)
    assert "group" not in str(err.value)


class _Equal:
    """A stand-in group equal to every other one: the cache must match the
    object itself."""

    def __eq__(self, other):
        return True

    def __hash__(self):
        return 0


def test_evict_group_drops_that_groups_entries_and_no_other(monkeypatch):
    g1, g2 = _Equal(), _Equal()
    entries = {
        ("lm_solve", ("T",), (1.0,), (g1, 0, 2)): "g1 solve",
        ("sharded_lm_step", ("T",), (), (g1, 0, 2)): "g1 step",
        ("lm_solve", ("T",), (1.0,), (g2, 1, 2)): "g2 solve",
        ("lm_solve", ("T",), (1.0,), None): "one device",
        ("linearize_graph", ("T",), (), None): "linearization",
    }
    monkeypatch.setattr(compiled, "_CACHE", dict(entries))
    assert compiled.evict_group(g1) == 2
    assert sorted(compiled._CACHE.values()) == ["g2 solve", "linearization", "one device"]
    assert compiled.evict_group(g1) == 0
    assert compiled.evict_group(g2) == 1
    assert sorted(compiled._CACHE.values()) == ["linearization", "one device"]


def test_close_mesh_evicts_the_groups_graphs(monkeypatch):
    calls = []
    evict = compiled.evict_group
    monkeypatch.setattr(compiled, "evict_group", lambda g: calls.append(g) or evict(g))
    monkeypatch.setattr(compiled, "_CACHE", {})
    mesh = make_mesh(0, 1, "cpu")
    try:
        key = compiled._group_key(mesh.group)
        assert key == (mesh.group, 0, 1)
        compiled._CACHE[("lm_solve", ("T",), (), key)] = "this group's solve"
        compiled._CACHE[("lm_solve", ("T",), (), None)] = "one device"
    finally:
        close_mesh(mesh)
    assert calls == [mesh.group]
    assert list(compiled._CACHE.values()) == ["one device"]


def test_all_gather_rows_one_rank_gloo():
    mesh = make_mesh(0, 1, "cpu")
    try:
        x = torch.arange(12, dtype=torch.float64).reshape(3, 4).T    # not contiguous
        out = all_gather_rows(x, mesh.group)
        assert out.dtype == x.dtype and torch.equal(out, x)
        flags = torch.tensor([[True, False], [False, True], [True, True]]).T
        out = all_gather_rows(flags, mesh.group)
        assert out.dtype == torch.bool and torch.equal(out, flags)
    finally:
        close_mesh(mesh)


@pytest.mark.parametrize("polls_until_done", [0, 3])
def test_bounded_wait_returns_once_done(polls_until_done):
    polls = []

    def done():
        polls.append(1)
        return len(polls) > polls_until_done

    collectives.bounded_wait(done, 60.0, "test")
    assert len(polls) == polls_until_done + 1


@pytest.mark.parametrize("limit_s", [0.0, 0.01])
def test_bounded_wait_raises_past_its_limit(limit_s):
    polls = []

    def never():
        polls.append(time.monotonic())
        return False

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=f"within its {limit_s} s timeout"):
        collectives.bounded_wait(never, limit_s, "test")
    assert polls[-1] - t0 >= limit_s


def test_wait_reads_the_groups_timeout_and_passes_off_cuda():
    mesh = make_mesh(0, 1, "cpu", timeout_s=123.0)
    try:
        assert collectives.timeout_s(mesh.group, mesh.device) == 123.0
        collectives.wait(mesh.group, mesh.device, "test")   # nothing queued on a CUDA stream
        collectives.wait(None, mesh.device, "test")
    finally:
        close_mesh(mesh)
