"""F1 of the JAX package on the port's synthetic flights workload.

    JAX_PLATFORMS=cpu python scripts/flights_jax_floor.py --rows 2376 \\
        --seeds 0,1,2 --out DIR

Generates the data with pclean_tpu_torch.workloads.flights.synth (the same
seeded dirty/clean tables chip_smoke.py's flights path runs on), builds the
model with experiments/flights.py's build_model, and runs pclean_tpu's
reference config (MH, 2 particles, 5 sweeps, batch_rows 1: the sequential
scan_init and the fused sequential sweep) through init, the sweeps and
evaluate_accuracy_device for each seed: init_state's key is PRNGKey(seed),
initialize's PRNGKey(seed + 1). Prints one JSON line per seed and a summary
line whose `floor` is the lowest F1 minus 0.03, the floor chip_smoke.py
holds the port's flights F1 to; with --out also writes
DIR/flights_jax_floor.json.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import jax  # noqa: E402

import flights as jflights  # noqa: E402  (experiments/flights.py)
from pclean_tpu.analysis import evaluate_accuracy_device  # noqa: E402
from pclean_tpu.engine.compile import compile_model, init_state  # noqa: E402
from pclean_tpu.engine.smc import Engine, InferenceConfig  # noqa: E402
from pclean_tpu.model.query import ObservedDataset, Query  # noqa: E402
from pclean_tpu_torch.workloads import flights as tflights  # noqa: E402


def jax_setup(dirty, sweeps=5, capacities=None, **cfg):
    """experiments/flights.py's setup on given tables: (cm, config,
    query)."""
    model = jflights.build_model(*tflights.model_inputs(dirty))
    query = Query.build(model, "Obs", jflights.QUERY_CLAUSES)
    cm = compile_model(model, [ObservedDataset(query, dirty)],
                       capacities=capacities or jflights.CAPACITIES)
    config = InferenceConfig(num_iters=sweeps, batch_rows=1,
                             use_mh_instead_of_pg=True, **cfg)
    return cm, config, query


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=2376)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--sweeps", type=int, default=5)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    dirty, clean = tflights.synth(a.rows)
    t = time.time()
    cm, config, query = jax_setup(dirty, a.sweeps)
    compile_s = time.time() - t
    runs = []
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.time()
        arenas, params = init_state(cm, jax.random.PRNGKey(seed))
        eng = Engine(cm, config)
        arenas, params, key = eng.initialize(jax.random.PRNGKey(seed + 1),
                                             arenas, params)
        arenas, params, key = eng.run(key, arenas, params)
        res = evaluate_accuracy_device(cm, arenas, params, dirty, clean,
                                       query)
        runs.append(dict(seed=seed, wall_s=time.time() - t, **res))
        print(json.dumps(runs[-1]), flush=True)
    f1 = [r["f1"] for r in runs]
    summary = dict(rows=a.rows, sweeps=a.sweeps, compile_s=compile_s,
                   backend=jax.default_backend(), f1=f1, min_f1=min(f1),
                   floor=min(f1) - 0.03, runs=runs)
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}))
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "flights_jax_floor.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
