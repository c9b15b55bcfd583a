"""Landmark-sharded SLAM solve over a ``torch.distributed`` process group
(port of :mod:`uslam_tpu.parallel.mesh`).

The problem has two parallel axes (SURVEY.md §2.2): frames (the front end,
:mod:`uslam_tpu_torch.parallel.frames`) and landmarks (Schur elimination,
here):

- every rank holds the camera-state arrays and the flat stereo
  linearization, the same on every rank;
- the per-landmark observation groups (``lm_obs_idx``/``lm_obs_mask``) are
  cut into one contiguous slice per rank, in rank order;
- each rank eliminates its slice; one all-reduce sums the reduced camera
  corrections (H_corr and g_corr, or the banded correction band), the
  reduced solve runs on every rank, and one all-gather collects the
  landmark delta.

The collectives live inside :func:`uslam_tpu_torch.solvers.schur.solve_schur`
and :func:`uslam_tpu_torch.solvers.banded.solve_schur_banded` (``group=``),
so the sharded path is the production solver: the whole LM policy runs
unchanged through :func:`sharded_optimize_lm`, with either reduced solver.

The JAX package runs one process over many devices (``shard_map``); torch
runs one process per device. :func:`make_mesh` is called inside a rank
(:func:`uslam_tpu_torch.parallel.launch.run_ranks` starts the ranks and
calls it), and the results come back whole on every rank.
"""

from __future__ import annotations

import datetime
from typing import NamedTuple

import torch
import torch.distributed as dist

from uslam_tpu_torch.config import SolverConfig
from uslam_tpu_torch.device import cast_tree, resolve_device
from uslam_tpu_torch.geometry.camera import StereoCamera
from uslam_tpu_torch.graph.builder import GraphArrays
from uslam_tpu_torch.graph.values import Values, values_retract
from uslam_tpu_torch.solvers.banded import solve_schur_banded
from uslam_tpu_torch.solvers.linearize import linearize_graph
from uslam_tpu_torch.solvers.lm import LMStats, optimize_lm
from uslam_tpu_torch.solvers.schur import solve_schur

# A collective that one rank never joins raises after this long instead of
# hanging (the 1k solve's longest wait between two collectives is seconds).
DEFAULT_TIMEOUT_S = 300.0


class Mesh(NamedTuple):
    """One rank's view of the process group: the group, this rank, the
    world size and the device this rank computes on."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device


def make_mesh(
    rank: int = 0,
    world_size: int = 1,
    device=None,
    store: dist.Store | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Mesh:
    """Join the default process group as ``rank`` of ``world_size``.

    ``device`` defaults to ``cuda:<rank>`` (one rank per GPU of the host);
    a CUDA device without a GPU raises. The backend follows the device:
    NCCL on CUDA, gloo on the CPU. ``store`` is the rendezvous (a
    ``FileStore`` from :func:`uslam_tpu_torch.parallel.launch.run_ranks`);
    a world of one rank may leave it out. Release with :func:`close_mesh`."""
    dev = resolve_device(f"cuda:{rank}" if device is None else device)
    if store is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs a store (run_ranks)")
        store = dist.HashStore()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw,
    )
    return Mesh(dist.group.WORLD, rank, world_size, dev)


def close_mesh(mesh: Mesh) -> None:
    """Leave the process group :func:`make_mesh` joined."""
    dist.destroy_process_group(mesh.group)


def shard_landmarks(graph: GraphArrays, values: Values, mesh: Mesh):
    """This rank's graph and values on its device: ``lm_obs_idx`` /
    ``lm_obs_mask`` cut to the rank's M/W contiguous landmark rows, the
    rest whole. (Landmark estimates stay whole: the flat stereo
    linearization indexes the full table.)"""
    m = graph.stereo.lm_obs_idx.shape[0]
    if m % mesh.size:
        raise ValueError(
            f"num_landmarks {m} must divide the mesh size {mesh.size} "
            "(the builder buckets to powers of two)"
        )
    rows = slice(mesh.rank * m // mesh.size, (mesh.rank + 1) * m // mesh.size)
    stereo = graph.stereo._replace(
        lm_obs_idx=graph.stereo.lm_obs_idx[rows], lm_obs_mask=graph.stereo.lm_obs_mask[rows]
    )
    return (cast_tree(graph._replace(stereo=stereo), None, mesh.device),
            cast_tree(values, None, mesh.device))


def _check_sharded(graph: GraphArrays, values: Values, mesh: Mesh) -> None:
    m_loc = graph.stereo.lm_obs_idx.shape[0]
    if m_loc * mesh.size != values.num_landmarks:
        raise ValueError(
            f"{m_loc} landmark rows on rank {mesh.rank} x {mesh.size} ranks != "
            f"{values.num_landmarks} landmarks: pass shard_landmarks' output"
        )


def sharded_optimize_lm(
    graph: GraphArrays,
    initial: Values,
    cam: StereoCamera,
    dvl_sigma: float,
    stereo_sigma: float,
    gravity: float,
    mesh: Mesh,
    cfg: SolverConfig = SolverConfig(),
    huber_delta: float | None = None,
) -> tuple[Values, LMStats]:
    """The production LM solve (:func:`uslam_tpu_torch.solvers.lm.optimize_lm`:
    velocity elimination, Marquardt damping, accept/reject, plateau stop)
    landmark-sharded over the mesh, on :func:`shard_landmarks`' output.
    Every rank returns the same values and stats; the single-device solve
    up to the order of the all-reduce's sums (bit-identical on one rank)."""
    _check_sharded(graph, initial, mesh)
    return optimize_lm(
        graph, initial, cam, dvl_sigma, stereo_sigma, gravity,
        cfg=cfg, huber_delta=huber_delta, group=mesh.group,
    )


def sharded_lm_step(
    graph: GraphArrays,
    values: Values,
    cam: StereoCamera,
    dvl_sigma: float,
    stereo_sigma: float,
    gravity: float,
    damping,
    mesh: Mesh,
    refine_iters: int = 4,
    jitter: float = 1e-7,
    diag_damping: bool = True,
    eliminate_velocities: bool = True,
    reduced_solver: str = "cholesky",
    band_w: int = 0,
    corr_window: int = 0,
) -> Values:
    """One fixed-lambda Gauss-Newton/LM step, landmark-sharded, on
    :func:`shard_landmarks`' output: the production linear solve with the
    production defaults (velocity elimination, Marquardt damping).
    ``reduced_solver="banded"`` takes the banded solve with ``band_w``
    and ``corr_window`` (``solvers.banded.measure_band_width`` /
    ``measure_corr_window`` of the whole graph)."""
    if reduced_solver not in ("cholesky", "banded"):
        raise ValueError(f"reduced_solver={reduced_solver!r}: 'cholesky' or 'banded'")
    _check_sharded(graph, values, mesh)
    n, m = values.num_poses, values.num_landmarks
    lin = linearize_graph(graph, values, cam, dvl_sigma, stereo_sigma, gravity)
    if reduced_solver == "banded":
        delta = solve_schur_banded(
            lin, graph.stereo, n, m, damping, band_w, refine_iters=refine_iters,
            jitter=jitter, diag_damping=diag_damping, corr_window=corr_window,
            group=mesh.group,
        )
    else:
        delta = solve_schur(
            lin, graph.stereo, n, m, damping, refine_iters=refine_iters, jitter=jitter,
            diag_damping=diag_damping, eliminate_velocities=eliminate_velocities,
            group=mesh.group,
        )
    return values_retract(values, delta)
