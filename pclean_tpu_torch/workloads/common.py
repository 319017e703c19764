"""The workloads' command line: experiments/common.py's flags and report
line, for the port.

`python -m pclean_tpu_torch.workloads.<name> [flags]` (hospital, flights,
rents, scaled) compiles the workload's seeded tables (or, for hospital,
the CSVs given by --dirty/--clean), runs init_state, Engine.initialize,
Engine.run and evaluate_accuracy_device, and prints `report`'s line.
It takes experiments/common.py's std_argparser flags except --shard, and
--device (default cuda; cpu runs the plain versions of the kernels).
"""
from __future__ import annotations

import argparse
import json
import time


def std_argparser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--rows", type=int, default=None,
                   help="rows of the seeded tables (the workload's own "
                        "default when not given)")
    p.add_argument("--sweeps", type=int, default=None,
                   help="override number of rejuvenation sweeps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", action="store_true",
                   help="export result CSVs under results/")
    p.add_argument("--json", action="store_true",
                   help="print one JSON line with metrics")
    p.add_argument("--batch", type=int, default=1,
                   help="rows per device dispatch (blocked-Gibbs batching)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="save inference state to this .npz before evaluation")
    p.add_argument("--repeat", type=int, default=1,
                   help="tile the dataset N times (synthetic scaling runs)")
    p.add_argument("--particles", type=int, default=None,
                   help="run particle-Gibbs with N particles instead of the "
                        "reference MH config")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p


def tile(data: dict, times: int) -> dict:
    """experiments/common.py's tile: the dataset's rows repeated `times`
    times (the source's 100,000-row hospital runs)."""
    if times <= 1:
        return data
    return {k: list(v) * times for k, v in data.items()}


def report(name: str, results: dict, elapsed: float, n_rows: int,
           sweeps: int, as_json: bool) -> None:
    """experiments/common.py's report line."""
    rows_per_sec = n_rows * (1 + sweeps) / elapsed if elapsed > 0 else 0.0
    line = dict(experiment=name, elapsed_sec=round(elapsed, 2),
                rows=n_rows, sweeps=sweeps,
                rows_cleaned_per_sec=round(rows_per_sec, 2), **results)
    if as_json:
        print(json.dumps(line))
    else:
        print(line)


def run(name: str, args, setup, extra=None, **setup_kw) -> dict:
    """One workload from the command line, as experiments/<name>.py's
    main runs it: setup(**setup_kw) (its seeded tables), init_state from
    --seed and Engine.initialize from --seed + 1, Engine.run, the card
    synchronised before the clock stops; --checkpoint saves the state
    (Engine.log_ml in its meta) before evaluate_accuracy_device, whose
    results extra(eng, arenas), where given, adds to; --save exports the
    results under results/<name>-<timestamp>/ (save_results). Prints
    `report`'s line and returns its results."""
    import torch

    from ..analysis import evaluate_accuracy_device, save_results
    from ..engine.compile import init_state
    from ..engine.smc import Engine
    from ..model.query import ObservedDataset

    kw = {k: v for k, v in dict(rows=args.rows, sweeps=args.sweeps,
                                  batch=args.batch,
                                  particles=args.particles).items()
          if v is not None}
    t0 = time.time()
    cm, config, dirty, clean, query, sweeps = setup(
        device=args.device, **kw, **setup_kw)
    arenas, params = init_state(cm, args.seed, device=args.device)
    eng = Engine(cm, config, device=args.device)
    arenas, params, gen = eng.initialize(args.seed + 1, arenas, params)
    arenas, params, gen = eng.run(gen, arenas, params)
    if cm.device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.time() - t0

    if args.checkpoint:
        from ..engine.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, cm, arenas, params, gen,
                        meta={"log_ml": eng.log_ml})

    results = evaluate_accuracy_device(cm, arenas, params, dirty, clean,
                                       query)
    if extra is not None:
        results.update(extra(eng, arenas))
    if args.save:
        save_results(cm, arenas, params, "results", name,
                     [ObservedDataset(query, dirty)])
    report(name, results, elapsed, len(next(iter(dirty.values()))), sweeps,
           args.json)
    return results
