"""F1 of the JAX package on the port's synthetic hospital workload.

    JAX_PLATFORMS=cpu python scripts/hospital_jax_floor.py --rows 1000 \\
        --repeat 5 --batch 256 --seeds 0,1,2 --out DIR

Generates the tables with pclean_tpu_torch.workloads.hospital.synth (the
same seeded dirty/clean tables chip_smoke.py's hospital path runs on),
tiles them `repeat` times as experiments/hospital.py's setup does, builds
the model with experiments/hospital.py's build_model, QUERY_CLAUSES and
CAPACITIES, and runs pclean_tpu's batched MH path (segmented batched
drivers, fused_dispatch_rows=0, the drivers the port has) through init, one
sweep and evaluate_accuracy_device for each seed: init_state's key is
PRNGKey(seed), initialize's PRNGKey(seed + 1). Prints one JSON line per
seed and a summary line whose `floor` is the lowest F1 minus 0.03, the
floor chip_smoke.py holds the port's hospital F1 to; with --out also writes
DIR/hospital_jax_floor.json.

The chip's configuration, repeat 100 (100,000 rows) at B = 4096, does not
fit a CPU host: pclean_tpu's County and Hospital sweeps ask XLA:CPU for
single buffers of 73 GB (5,000 rows) to 109 GB (100,000 rows) at B = 4096,
and of 90 GB at 100,000 rows and B = 256. So the defaults are the largest
that run in a few minutes a seed on a CPU host with tens of GB: 5,000 rows
(repeat 5) at B = 256.
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

import hospital as jhospital  # noqa: E402  (experiments/hospital.py)
from pclean_tpu.analysis import evaluate_accuracy_device  # noqa: E402
from pclean_tpu.engine.compile import compile_model, init_state  # noqa: E402
from pclean_tpu.engine.smc import Engine, InferenceConfig  # noqa: E402
from pclean_tpu.io import possibilities_from  # noqa: E402
from pclean_tpu.model.query import ObservedDataset, Query  # noqa: E402
from pclean_tpu_torch.workloads import hospital as thospital  # noqa: E402


def jax_setup(dirty, batch, **cfg):
    """experiments/hospital.py's setup on given tables: (cm, config,
    query)."""
    model = jhospital.build_model(possibilities_from(dirty))
    query = Query.build(model, "Record", jhospital.QUERY_CLAUSES)
    cm = compile_model(model, [ObservedDataset(query, dirty)],
                       capacities=jhospital.CAPACITIES)
    config = InferenceConfig(num_iters=1, batch_rows=batch,
                             use_mh_instead_of_pg=True,
                             fused_dispatch_rows=0, **cfg)
    return cm, config, query


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    dirty, clean = thospital.synth(a.rows)
    dirty = thospital.tile(dirty, a.repeat)
    clean = thospital.tile(clean, a.repeat)
    t = time.time()
    cm, config, query = jax_setup(dirty, a.batch)
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
    summary = dict(rows=a.rows, repeat=a.repeat, batch=a.batch,
                   compile_s=compile_s, backend=jax.default_backend(), f1=f1,
                   min_f1=min(f1), floor=min(f1) - 0.03, runs=runs)
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}))
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "hospital_jax_floor.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
