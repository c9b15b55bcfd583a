"""Readings that the limits of a cell's check are set from: the program's
numbers and the control's, seed by seed, at the cell's own size.

    python3 bench_port/readings.py --workload batch_1k.features --seeds 11 12 13

For each seed it makes the run's pool of dives, solves each with the
program's timed entry, works out the reference (packing and the float64
oracle) of the dives that a run with that seed checks, and prints one JSON line per seed with the program's numbers, the
control's numbers and the program's counts (LM iterations, stereo
observations). The control is the reference put in the program's place,
each stage in the nearest precision below the configuration's: the packed
graph's float32 leaves and the residuals (elementwise float32 in the
program) in bfloat16, the matrix products in TF32, and the float64
reduced solve in float32: its normal equations and their factorization in
float32. ``control_solve`` is the solve stage alone at those precisions,
from the stated float32 leaves and residuals. The benchmark's own runs
never run either.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def control_records(run, refs, graph_dtype=None) -> list:
    """The control's outputs, shaped as the window's records: the graph's
    leaves and residuals in ``graph_dtype`` (default bfloat16, one below
    the stated float32), TF32 products, float32 normal equations and
    factorization."""
    import numpy as np
    import torch

    from reference import batch_solve

    dt = torch.bfloat16 if graph_dtype is None else graph_dtype
    cfg = run.cell.config["uslam"]
    out = []
    for k, (leaves, P, v0, _, _) in refs.items():
        Pc = batch_solve.problem(leaves, P.m, cfg, run.device, dtype=dt)
        v0 = {a: b.to(torch.float32) for a, b in v0.items()}
        with torch.no_grad(), batch_solve.tf32(True):
            vc, ec, iters = batch_solve.optimize(Pc, v0)
        graph = {a: (torch.as_tensor(np.asarray(b, np.float32)).to(dt).float().numpy()
                     if np.asarray(b).dtype.kind == "f" else np.asarray(b))
                 for a, b in leaves.items()}
        run.log(f"control ({dt}): dive {k}: {iters} iterations, own cost {ec!r}")
        out.append({"dive": k, "values": vc, "graph": graph})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    import harness
    import numpy as np
    import torch

    from run import Run

    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"), args.workload, ROOT)
    device = torch.device("cpu" if args.rehearse else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    drv = cell.driver
    for seed in args.seeds:
        t0 = time.perf_counter()
        ns = argparse.Namespace(rehearse=args.rehearse, seed=seed)
        run = Run(ns, cell, device)
        line = {"seed": seed}
        drv.setup(run)
        run.t_start = time.perf_counter()
        for k, seq in enumerate(run.state["seqs"]):
            r = drv.solve(run, seq)
            run.records.append({"dive": k, "done": time.perf_counter(), "dive_s": 0.0,
                                "metrics": dict(r.metrics), "values": r.values,
                                "graph": r.graph})
        line["program_counts"] = [
            {"lm_iterations": rec["metrics"]["lm_iterations"],
             "solve_s": rec["metrics"]["solve_seconds"],
             "pack_s": rec["metrics"]["pack_seconds"],
             "final_error": rec["metrics"]["final_error"],
             "stereo_obs": int(rec["graph"].stereo.mask.sum()),
             "F": int(rec["graph"].stereo.mask.shape[0]),
             "M": int(rec["values"].landmarks.shape[0]),
             "tracks": len(np.unique(np.concatenate([f["ids"] for f in d.features])))}
            for rec, d in zip(run.records, run.state["dives"])]
        drv.release(run)
        refs = drv.reference_solutions(run, drv.check_dives(run))
        line["program"] = drv.judge(run, refs, run.records)
        line["control"] = drv.judge(run, refs, control_records(run, refs))
        line["control_solve"] = drv.judge(run, refs,
                                          control_records(run, refs, torch.float32))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
