"""Particle-Gibbs F1 of the JAX package on the port's synthetic hospital
workload: the floors of chip_smoke.py's two PG paths.

    JAX_PLATFORMS=cpu python scripts/hospital_pg_jax_floor.py --path collapsed
    JAX_PLATFORMS=cpu python scripts/hospital_pg_jax_floor.py --path vmapped

Generates the tables with pclean_tpu_torch.workloads.hospital.synth (the
seeded dirty/clean tables chip_smoke.py's hospital paths run on), tiles them
`repeat` times, builds experiments/hospital.py's model through
scripts/hospital_jax_floor.py's jax_setup and runs pclean_tpu's batched PG
path (use_mh_instead_of_pg=False, the segmented batched drivers with
pg_row_step, fused_dispatch_rows=0) through init, one sweep and
evaluate_accuracy_device for each seed: init_state's key is PRNGKey(seed),
initialize's PRNGKey(seed + 1). Prints one JSON line per seed (F1 and the
init log-ML) and a summary line whose `floor` is the lowest F1 minus 0.03;
with --out also writes DIR/hospital_pg_jax_floor_<path>.json. With
--package torch the port (pclean_tpu_torch) runs the same configuration
and seeds on the CPU instead (init_state(seed), initialize(seed + 1)), for
its F1 and log-ML beside JAX's; the two packages run in separate
processes, since XLA:CPU's code memory ran out when both shared one.

--path collapsed: P = 1,024 with the exact-Gibbs collapse (the audit passes
on this model), 1,000 rows tiled 5 times (5,000 rows) at B = 256. The
chip's configuration, 100,000 rows at B = 4,096, does not fit a CPU host
(XLA:CPU asks for single buffers of 73-109 GB at B = 4,096; see
hospital_jax_floor.py).
--path vmapped: P = 16 with collapse_exact_pg=False, the full particle path
the audit-failing models take, 1,000 rows at B = 64: chip_smoke.py's
hospital_pg16_vmapped configuration itself.

The JAX package's vmapped path carries an F1 deficit against its collapsed
one on the same model that has not been explained (VERDICT.md:132-147), so
the vmapped floor comes from the vmapped runs, not from the collapsed ones.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402

from hospital_jax_floor import jax_setup  # noqa: E402
from pclean_tpu.analysis import evaluate_accuracy_device  # noqa: E402
from pclean_tpu.engine.compile import init_state  # noqa: E402
from pclean_tpu.engine.smc import Engine, InferenceConfig  # noqa: E402
from pclean_tpu_torch.workloads import hospital as thospital  # noqa: E402

PATHS = {
    "collapsed": dict(rows=1000, repeat=5, batch=256, particles=1024,
                      collapse=True),
    "vmapped": dict(rows=1000, repeat=1, batch=64, particles=16,
                    collapse=False),
}


def port_run(p: dict, dirty, clean, seed: int) -> dict:
    """The port's PG path on the same tables and configuration, on the
    CPU: F1, precision, log-ML and wall seconds."""
    from pclean_tpu_torch.analysis import evaluate_accuracy_device as t_eval
    from pclean_tpu_torch.engine.compile import init_state as t_init
    from pclean_tpu_torch.engine.smc import Engine as TEngine

    t = time.time()
    cm, config, _d, _c, query, _s = thospital.setup(
        rows=p["rows"], repeat=p["repeat"], batch=p["batch"],
        particles=p["particles"], collapse_exact_pg=p["collapse"],
        device="cpu")
    arenas, params = t_init(cm, seed, device="cpu")
    eng = TEngine(cm, config, device="cpu")
    arenas, params, gen = eng.initialize(seed + 1, arenas, params)
    log_ml = float(eng.log_ml)
    arenas, params, gen = eng.run(gen, arenas, params)
    res = t_eval(cm, arenas, params, dirty, clean, query)
    return dict(f1=res["f1"], precision=res["precision"], log_ml=log_ml,
                wall_s=time.time() - t)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=sorted(PATHS), required=True)
    ap.add_argument("--seeds", default="0,1,2")
    for knob in ("rows", "repeat", "batch", "particles"):
        ap.add_argument(f"--{knob}", type=int, default=None,
                        help=f"override the path's {knob}")
    ap.add_argument("--package", choices=("jax", "torch"), default="jax",
                    help="run pclean_tpu (jax) or the port (torch)")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    p = dict(PATHS[a.path])
    p.update({k: getattr(a, k) for k in ("rows", "repeat", "batch",
                                         "particles")
              if getattr(a, k) is not None})
    dirty, clean = thospital.synth(p["rows"])
    dirty = thospital.tile(dirty, p["repeat"])
    clean = thospital.tile(clean, p["repeat"])
    seeds = [int(s) for s in a.seeds.split(",")]
    if a.package == "torch":
        runs = []
        for seed in seeds:
            runs.append(dict(seed=seed, **port_run(p, dirty, clean, seed)))
            print(json.dumps(runs[-1]), flush=True)
        f1 = [r["f1"] for r in runs]
        print(json.dumps(dict(path=a.path, package="torch", **p, f1=f1,
                              log_ml=[r["log_ml"] for r in runs])))
        return 0
    t = time.time()
    cm, _mh, query = jax_setup(dirty, p["batch"])
    config = InferenceConfig(num_iters=1, batch_rows=p["batch"],
                             use_mh_instead_of_pg=False,
                             num_particles=p["particles"],
                             collapse_exact_pg=p["collapse"],
                             fused_dispatch_rows=0)
    compile_s = time.time() - t
    runs = []
    for seed in seeds:
        t = time.time()
        arenas, params = init_state(cm, jax.random.PRNGKey(seed))
        eng = Engine(cm, config)
        arenas, params, key = eng.initialize(jax.random.PRNGKey(seed + 1),
                                             arenas, params)
        log_ml = float(eng.log_ml)
        arenas, params, key = eng.run(key, arenas, params)
        res = evaluate_accuracy_device(cm, arenas, params, dirty, clean,
                                       query)
        runs.append(dict(seed=seed, wall_s=time.time() - t, log_ml=log_ml,
                         exact_accept=bool(eng.exact_accept), **res))
        print(json.dumps(runs[-1]), flush=True)
    f1 = [r["f1"] for r in runs]
    summary = dict(path=a.path, **p, compile_s=compile_s,
                   backend=jax.default_backend(), f1=f1, min_f1=min(f1),
                   floor=min(f1) - 0.03, runs=runs)
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}))
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out,
                               f"hospital_pg_jax_floor_{a.path}.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
