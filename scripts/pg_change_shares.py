"""How often a particle-Gibbs sweep moves a row, in both packages.

    JAX_PLATFORMS=cpu python scripts/pg_change_shares.py --package jax
    JAX_PLATFORMS=cpu python scripts/pg_change_shares.py --package torch

On the port's synthetic hospital tables (pclean_tpu_torch.workloads.
hospital.synth, 1,000 rows), at B = 64 and P = 16, for each seed (init_state
from seed, initialize from seed + 1) and each of the two PG forms (written
out: collapse_exact_pg off, the particle path of hospital_pg16_vmapped; and
collapsed: the exact one-draw form), it runs init and then `--sweeps`
sweeps, and after each sweep counts, class by class, the share of the rows
that were live before the sweep (the observed class's arena alive bits, a
latent class's refreshed ones) whose stored values the sweep changed; it
also takes the F1 of the repaired cells after init and after each sweep
(evaluate_accuracy_device), which says whether a gap in the shares comes
from the state the init left or from the sweeps. On a
model that passes the exact-Gibbs audit the written-out and the collapsed
forms sample the same conditional, so their shares must agree within each
package; the two packages must agree too. Both packages run on the
segmented batched drivers (fused_dispatch_rows=0 on the JAX side), and each
in its own process (XLA:CPU's code memory ran out when both shared one).
Prints one JSON line per (form, seed) and a summary line of the per-sweep
shares averaged over the seeds; with --out also DIR/pg_change_shares_
<package>_<forms joined by +>.json. It changes nothing in either package. For JAX run
one form a process (--forms written_out, then --forms collapsed).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, ROOT)

from pclean_tpu_torch.workloads import hospital as thospital  # noqa: E402

FORMS = {"written_out": False, "collapsed": True}


def shares(before: dict, after: dict, live: dict) -> dict:
    """{class: share of its live rows whose stored values changed}."""
    out = {}
    for cid, vals in before.items():
        changed = np.zeros(len(live[cid]), bool)
        for v, x in vals.items():
            changed |= x != after[cid][v]
        n = int(live[cid].sum())
        out[cid] = float((changed & live[cid]).sum() / n) if n else None
    return out


_JAX = {}


def run_jax(rows, batch, P, collapse, seed, sweeps, dirty, clean):
    import jax
    from hospital_jax_floor import jax_setup
    from pclean_tpu.analysis import evaluate_accuracy_device
    from pclean_tpu.engine.compile import init_state
    from pclean_tpu.engine.refresh import refresh
    from pclean_tpu.engine.smc import Engine, InferenceConfig

    # one model and one engine a form, reused over the seeds: every new
    # engine compiles its programs again, and XLA:CPU's code memory runs out
    if collapse not in _JAX:
        cm, _c, query = jax_setup(dirty, batch)
        _JAX[collapse] = (Engine(cm, InferenceConfig(
            num_iters=1, batch_rows=batch, use_mh_instead_of_pg=False,
            num_particles=P, collapse_exact_pg=collapse,
            fused_dispatch_rows=0)), query)
    eng, query = _JAX[collapse]
    cm = eng.cm
    arenas, params = init_state(cm, jax.random.PRNGKey(seed))
    arenas, params, key = eng.initialize(jax.random.PRNGKey(seed + 1),
                                         arenas, params)

    def snap(a):
        rel = refresh(cm, a, eng.obs_dev)
        vals = {c: {v: np.asarray(x) for v, x in a[c]["values"].items()}
                for c in a}
        live = {c: np.asarray(a[c]["alive"] if cm.layouts[c].observed
                              else rel[c]["alive"]) for c in a}
        return vals, live

    def f1(a, p):
        return evaluate_accuracy_device(cm, a, p, dirty, clean, query)["f1"]

    out, f1s = [], [f1(arenas, params)]
    for _ in range(sweeps):
        vals, live = snap(arenas)
        arenas, params, key = eng.sweep(key, arenas, params)
        out.append(shares(vals, snap(arenas)[0], live))
        f1s.append(f1(arenas, params))
    return out, f1s, bool(eng.exact_accept)


def run_torch(rows, batch, P, collapse, seed, sweeps, dirty, clean):
    from pclean_tpu_torch.analysis import evaluate_accuracy_device
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.refresh import refresh
    from pclean_tpu_torch.engine.smc import Engine

    cm, config, _d, _c, query, _s = thospital.setup(
        rows=rows, batch=batch, particles=P, collapse_exact_pg=collapse,
        device="cpu", fused_dispatch_rows=0)
    eng = Engine(cm, config, device="cpu")
    arenas, params = init_state(cm, seed, device="cpu")
    arenas, params, gen = eng.initialize(seed + 1, arenas, params)

    def snap(a):
        rel = refresh(cm, a, eng.obs_dev)
        vals = {c: {v: x.numpy().copy() for v, x in a[c]["values"].items()}
                for c in a}
        live = {c: (a[c]["alive"] if cm.layouts[c].observed
                    else rel[c]["alive"]).numpy().copy() for c in a}
        return vals, live

    def f1(a, p):
        return evaluate_accuracy_device(cm, a, p, dirty, clean, query)["f1"]

    out, f1s = [], [f1(arenas, params)]
    for _ in range(sweeps):
        vals, live = snap(arenas)
        arenas, params, gen = eng.sweep(gen, arenas, params)
        out.append(shares(vals, snap(arenas)[0], live))
        f1s.append(f1(arenas, params))
    return out, f1s, bool(eng.exact_accept)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--particles", type=int, default=16)
    ap.add_argument("--sweeps", type=int, default=2)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--forms", default=",".join(FORMS),
                    help="which PG forms to run (JAX: run each in a process "
                         "of its own)")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    dirty, clean = thospital.synth(a.rows)
    run = run_jax if a.package == "jax" else run_torch
    runs = []
    forms = a.forms.split(",")
    for form, collapse in ((f, FORMS[f]) for f in forms):
        for seed in (int(s) for s in a.seeds.split(",")):
            t = time.time()
            per_sweep, f1s, exact = run(a.rows, a.batch, a.particles,
                                        collapse, seed, a.sweeps, dirty,
                                        clean)
            runs.append(dict(package=a.package, form=form, seed=seed,
                             exact_gibbs=exact, shares=per_sweep, f1=f1s,
                             wall_s=time.time() - t))
            print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for form in forms:
        mine = [r["shares"] for r in runs if r["form"] == form]
        summary[form] = [
            {c: float(np.mean([m[s][c] for m in mine
                               if m[s][c] is not None]))
             for c in mine[0][s] if any(m[s][c] is not None for m in mine)}
            for s in range(a.sweeps)]
    print(json.dumps(dict(package=a.package, rows=a.rows, batch=a.batch,
                          particles=a.particles, mean_shares=summary)))
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(
                a.out, f"pg_change_shares_{a.package}_{'+'.join(forms)}.json"),
                  "w") as f:
            json.dump(dict(runs=runs, mean_shares=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
