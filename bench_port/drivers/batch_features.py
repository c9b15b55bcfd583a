"""Driver of the batch deployment: ``uslam_tpu_torch.pipeline.run_sequence``
over whole dives, one client in a closed loop (the next dive starts when
the previous one's solution is on the host).

Set-up generates the traffic's pool of dives from the seed with the frozen
generator, keeps the tracks that the configuration's front-end grid keeps
(``front_end_budget``, :func:`synth.track_budget`), hands each dive to the
program as its public ``SensorSequence`` (feature tracks, the front end's
output), and solves each once, which captures every CUDA graph the window
replays. The window solves the pool's dives in turn, starting a dive while
less than ``--seconds`` have passed, and keeps each solution (values,
statistics and timings; the packed graph of each dive's first solve).

The check draws 2 of the dives that the window solved from the seed, packs
each again with the plain reference, solves it with the float64 oracle,
and compares: the program's packed graph (leaf by leaf, relative to the
leaf's largest magnitude) and, for every solution of those dives in the
window, its cost in float64 over the oracle's (``cost_excess``).
"""

from __future__ import annotations

import time

import numpy as np

import synth
from reference import batch_solve, packing

CHECK_DIVES = 2    # dives whose every solve in the window is checked, drawn from the seed


def dive_seeds(seed: int, count: int) -> list:
    """Seeds of the pool's dives, drawn from the run's seed."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(count, np.uint32)]


def make_dives(run) -> list:
    cfg, traffic = run.cell.config, run.cell.traffic
    dive = dict(cfg["dive"])
    if run.rehearse:
        dive.update(cfg["rehearse"]["dive"])
    cam = synth.Camera.from_dict(cfg["uslam"]["camera"])
    fe = cfg["uslam"]["frontend"]
    dives = []
    for s in dive_seeds(run.seed, int(traffic["pool"])):
        d = synth.generate(synth.DiveSpec(**dive, seed=s), cam, cfg["uslam"]["pressure"])
        if traffic.get("front_end_budget"):
            d.features = synth.track_budget(d.features, cam, fe["grid_rows"], fe["grid_cols"],
                                            fe["max_features_per_cell"], s)
        dives.append(d)
    return dives


def to_sequence(dive):
    """The program's public input type, from the benchmark's arrays."""
    from uslam_tpu_torch.io.sequence import FeatureFrame, SensorSequence

    return SensorSequence(features=[FeatureFrame(**f) for f in dive.features],
                          **dive.streams, **dive.truth)


def setup(run) -> None:
    from uslam_tpu_torch.config import UslamConfig
    from uslam_tpu_torch.pipeline import run_sequence

    st = run.state
    t0 = time.perf_counter()
    st["ucfg"] = UslamConfig.from_dict(run.cell.config["uslam"])
    st["dives"] = make_dives(run)
    st["seqs"] = [to_sequence(d) for d in st["dives"]]
    t1 = time.perf_counter()
    rate = run.cell.config["dive"]["keyframe_rate"]
    st["dive_s"] = [len(d.keyframes["t"]) / rate for d in st["dives"]]
    st["run_sequence"] = run_sequence
    for seq in st["seqs"]:
        solve(run, seq)
    st["captures"] = _captures()
    run.log(f"batch: set-up: {len(st['seqs'])} dives made in {t1 - t0!r} s, solved once "
            f"(graph captures {st['captures']}) in {time.perf_counter() - t1!r} s")


def _captures() -> int:
    from uslam_tpu_torch.solvers import compiled

    return sum(compiled.captures.values())


def solve(run, seq):
    st = run.state
    return st["run_sequence"](seq, st["ucfg"], device=run.device)


def window(run, seconds: float) -> None:
    st = run.state
    pool = len(st["seqs"])
    run.t_start = time.perf_counter()
    i = 0
    while time.perf_counter() - run.t_start < seconds:
        k = i % pool
        run.attempted += 1
        try:
            r = solve(run, st["seqs"][k])
        except Exception as exc:  # a request that fails counts, and the loop goes on
            run.failed += 1
            run.log(f"batch: dive {k} failed: {exc!r}")
            i += 1
            continue
        done = time.perf_counter()
        run.records.append({
            "dive": k, "done": done, "dive_s": st["dive_s"][k],
            "metrics": dict(r.metrics), "values": r.values,
            "graph": r.graph if i < pool else None,   # each dive's first solve
        })
        i += 1
    run.log(f"batch: graph captures in the window: {_captures() - st['captures']}")
    if run.records:
        walls = np.diff([run.t_start] + [r["done"] for r in run.records]) * 1e3
        packs = [1e3 * r["metrics"]["pack_seconds"] for r in run.records]
        solves = [1e3 * r["metrics"]["solve_seconds"] for r in run.records]
        for name, xs in (("wall", walls), ("pack", packs), ("solve", solves)):
            run.log(f"batch: per-dive {name} ms: median {float(np.median(xs))!r}, "
                    f"min {float(np.min(xs))!r}, max {float(np.max(xs))!r}")


def profile(run) -> dict:
    """One dive of the pool under the profiler, after the window."""
    import devtrace

    st = run.state
    return devtrace.profile(lambda: solve(run, st["seqs"][0]), workdir=None)


def release(run) -> None:
    """Free what only the program needs before the reference runs."""
    st = run.state
    for key in ("seqs", "run_sequence"):
        st.pop(key, None)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return dict(tree)
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_flat(getattr(tree, f), prefix + f + "."))
        return out
    return {prefix[:-1]: tree}


def graph_gap(program_graph, leaves: dict) -> float:
    """Largest leaf gap between the program's packed graph and the
    reference's (float leaves rounded to the program's float32), relative
    to the reference leaf's largest magnitude; inf where a leaf is missing
    or its shape differs."""
    got = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
           for k, v in _flat(program_graph).items()}
    worst = 0.0
    for k, ref in leaves.items():
        ref = np.asarray(ref)
        if k not in got or got[k].shape != ref.shape:
            return float("inf")
        r = ref.astype(np.float32).astype(np.float64) if ref.dtype.kind == "f" else ref.astype(np.float64)
        g = got[k].astype(np.float64)
        scale = max(float(np.abs(r).max()), 1e-30) if r.size else 1.0
        gap = float(np.abs(g - r).max()) / scale if r.size else 0.0
        worst = max(worst, gap if np.isfinite(gap) else float("inf"))
    return worst


def check_dives(run, done=None) -> list:
    """The dives that the check compares: drawn from the seed among those
    the window solved (or among ``done``)."""
    done = sorted({r["dive"] for r in run.records} if done is None else done)
    rng = np.random.default_rng([int(run.seed), 0x636865636B])
    return sorted(int(k) for k in rng.choice(done, min(CHECK_DIVES, len(done)), replace=False))


def reference_solutions(run, dives) -> dict:
    """Per dive index in ``dives``: (leaves, problem, initial values, oracle
    values, oracle cost)."""
    import torch

    cfg = run.cell.config["uslam"]
    out = {}
    for k in dives:
        d = run.state["dives"][k]
        leaves, initial, m = packing.pack(d.streams, d.features, cfg)
        P = batch_solve.problem(leaves, m, cfg, run.device)
        v0 = batch_solve.values_to(
            {k: np.asarray(a, np.float32) for k, a in initial.items()}, run.device)
        with torch.no_grad():
            vo, eo, iters = batch_solve.optimize(P, v0)
        run.log(f"batch: oracle {iters} iterations, cost {eo!r}")
        out[k] = (leaves, P, v0, vo, eo)
    return out


def judge(run, refs, records) -> dict:
    """The compared numbers over the ``records`` (dicts with ``dive``,
    ``values`` and optionally ``graph``) of the checked dives, each the
    worst over them."""
    import torch

    worst_graph, worst_excess = 0.0, 0.0
    for rec in (r for r in records if r["dive"] in refs):
        leaves, P, _, _, eo = refs[rec["dive"]]
        if rec.get("graph") is not None:
            worst_graph = max(worst_graph, graph_gap(rec["graph"], leaves))
        vals = rec["values"]
        vals = vals._asdict() if hasattr(vals, "_asdict") else vals
        with torch.no_grad():
            e = float(batch_solve.cost(P, batch_solve.values_to(vals, run.device)))
        excess = e / eo - 1.0 if np.isfinite(e) else float("inf")
        worst_excess = max(worst_excess, excess)
    return {"graph_gap": worst_graph, "cost_excess": worst_excess}


def check(run) -> dict:
    if not run.records:
        return {}
    refs = reference_solutions(run, check_dives(run))
    return judge(run, refs, run.records)
