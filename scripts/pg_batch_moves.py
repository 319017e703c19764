"""Where a particle-Gibbs first sweep moves its Record rows, batch by batch.

    JAX_PLATFORMS=cpu python scripts/pg_batch_moves.py --package torch
    JAX_PLATFORMS=cpu python scripts/pg_batch_moves.py --package jax \\
        --forms written_out
    JAX_PLATFORMS=cpu python scripts/pg_batch_moves.py --package jax \\
        --forms collapsed
    JAX_PLATFORMS=cpu python scripts/pg_batch_moves.py --package both \\
        --forms written_out --init jax        # (or --init torch)

The configuration of scripts/pg_change_shares.py (the port's synthetic
hospital tables, 1,000 rows, B = 64, P = 16, the segmented batched drivers,
init_state from seed, initialize from seed + 1), then one sweep. For the
observed class (Record) it counts, in each batch of B slots, the live rows
whose stored values the sweep changed, and splits them into the rows the
batched pass deferred to the sequential replay (Engine.replay_rows, whose
row list is recorded as the sweep calls it) and the rest, which the
batched pass itself moved. One JSON line per (form, seed): per-batch moved,
deferred and moved-deferred counts and their totals; then a summary line
of the totals' means over the seeds. `--package both` runs one package's
init (`--init jax` or `torch`) and then both packages' first sweep from
that one state, so that a difference in the moves shows whether it
follows the init or the sweep. With --out also
DIR/pg_batch_moves_<package>_<init>_<forms>.json. It changes nothing in either
package; JAX runs one form a process, as pg_change_shares.py says why.
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

from pg_change_shares import FORMS  # noqa: E402
from pclean_tpu_torch.workloads import hospital as thospital  # noqa: E402

CID = "Record"


def _record_replays(eng, seen: list):
    """Wrap eng.replay_rows so that the rows it replays of CID land in
    `seen`."""
    orig = eng.replay_rows

    def replay_rows(cid, arenas, params, idx, *a, **k):
        if cid == CID:
            seen.extend(int(i) for i in np.asarray(idx))
        return orig(cid, arenas, params, idx, *a, **k)

    eng.replay_rows = replay_rows


def batch_moves(before: dict, after: dict, live, deferred, B: int) -> dict:
    """Per batch of B slots: live rows moved, rows deferred, and deferred
    rows moved (the replay's moves), with the totals."""
    moved = np.zeros(len(live), bool)
    for v, x in before.items():
        moved |= x != after[v]
    moved &= live
    dmask = np.zeros(len(live), bool)
    dmask[np.asarray(deferred, np.int64)] = True
    nb = (len(live) + B - 1) // B

    def per(m):
        return [int(m[i * B:(i + 1) * B].sum()) for i in range(nb)]

    return dict(moved=per(moved), deferred=per(dmask),
                moved_deferred=per(moved & dmask),
                live=int(live.sum()), moved_total=int(moved.sum()),
                deferred_total=int(dmask.sum()),
                moved_deferred_total=int((moved & dmask).sum()),
                moved_batched_total=int((moved & ~dmask).sum()))


_JAX = {}


def _jax_engine(batch, P, collapse, dirty):
    """pclean_tpu's engine of one form, built once and reused over the
    seeds (every new engine compiles its programs again)."""
    from hospital_jax_floor import jax_setup
    from pclean_tpu.engine.smc import Engine, InferenceConfig

    if collapse not in _JAX:
        cm, _c, _q = jax_setup(dirty, batch)
        _JAX[collapse] = Engine(cm, InferenceConfig(
            num_iters=1, batch_rows=batch, use_mh_instead_of_pg=False,
            num_particles=P, collapse_exact_pg=collapse,
            fused_dispatch_rows=0))
    return _JAX[collapse]


def run_jax(rows, batch, P, collapse, seed, dirty):
    import jax
    from pclean_tpu.engine.compile import init_state

    eng = _jax_engine(batch, P, collapse, dirty)
    arenas, params = init_state(eng.cm, jax.random.PRNGKey(seed))
    arenas, params, key = eng.initialize(jax.random.PRNGKey(seed + 1),
                                         arenas, params)
    before = {v: np.asarray(x) for v, x in arenas[CID]["values"].items()}
    live = np.asarray(arenas[CID]["alive"])
    seen: list = []
    _record_replays(eng, seen)
    try:
        arenas, params, key = eng.sweep(key, arenas, params)
    finally:
        del eng.replay_rows
    after = {v: np.asarray(x) for v, x in arenas[CID]["values"].items()}
    return batch_moves(before, after, live, seen, batch)


def run_torch(rows, batch, P, collapse, seed, dirty):
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine

    cm, config, _d, _c, _q, _s = thospital.setup(
        rows=rows, batch=batch, particles=P, collapse_exact_pg=collapse,
        device="cpu", fused_dispatch_rows=0)
    eng = Engine(cm, config, device="cpu")
    arenas, params = init_state(cm, seed, device="cpu")
    arenas, params, gen = eng.initialize(seed + 1, arenas, params)
    before = {v: x.numpy().copy() for v, x in arenas[CID]["values"].items()}
    live = arenas[CID]["alive"].numpy().copy()
    seen: list = []
    _record_replays(eng, seen)
    arenas, params, gen = eng.sweep(gen, arenas, params)
    after = {v: x.numpy() for v, x in arenas[CID]["values"].items()}
    return batch_moves(before, after, live, seen, batch)


def run_both(rows, batch, P, collapse, seed, dirty, init="jax"):
    """One package's init (`init`: pclean_tpu's, its keys from seed, or
    the port's, init_state from seed and initialize from seed + 1), then
    both packages' first sweep from that same state (pclean_tpu's key
    PRNGKey(seed + 2), the port's generator seeded seed + 2): which moves
    follow the state and which the package."""
    import jax
    import jax.numpy as jnp
    from pclean_tpu.engine import compile as jcompile
    from pclean_tpu_torch.convert import to_numpy, to_torch
    from pclean_tpu_torch.engine import compile as tcompile
    from pclean_tpu_torch.engine.smc import Engine

    eng_j = _jax_engine(batch, P, collapse, dirty)
    cm, config, _d, _c, _q, _s = thospital.setup(
        rows=rows, batch=batch, particles=P, collapse_exact_pg=collapse,
        device="cpu", fused_dispatch_rows=0)
    eng = Engine(cm, config, device="cpu")
    if init == "jax":
        arenas, params = jcompile.init_state(eng_j.cm, jax.random.PRNGKey(seed))
        arenas, params, _k = eng_j.initialize(jax.random.PRNGKey(seed + 1),
                                              arenas, params)
        state = jax.tree_util.tree_map(np.asarray, (arenas, params))
    else:
        arenas, params = tcompile.init_state(cm, seed, device="cpu")
        arenas, params, _g = eng.initialize(seed + 1, arenas, params)
        state = (to_numpy(arenas), to_numpy(params))
    before = {v: x.copy() for v, x in state[0][CID]["values"].items()}
    live = state[0][CID]["alive"].copy()
    seen: list = []
    _record_replays(eng_j, seen)
    try:
        aj, _p, _k = eng_j.sweep(jax.random.PRNGKey(seed + 2),
                                 *jax.tree_util.tree_map(jnp.asarray, state))
    finally:
        del eng_j.replay_rows
    out = {"jax": batch_moves(before, {v: np.asarray(x) for v, x in
                                       aj[CID]["values"].items()},
                              live, seen, batch)}
    at, pt = to_torch(state[0], "cpu"), to_torch(state[1], "cpu")
    seen = []
    _record_replays(eng, seen)
    at, pt, _g = eng.sweep(seed + 2, at, pt)
    out["torch"] = batch_moves(before, {v: x.numpy() for v, x in
                                        at[CID]["values"].items()},
                               live, seen, batch)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("jax", "torch", "both"),
                    required=True,
                    help="both: pclean_tpu's init, then each package's "
                         "first sweep from that state")
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--particles", type=int, default=16)
    ap.add_argument("--seeds", default="0,1,2,3,4,5")
    ap.add_argument("--forms", default=",".join(FORMS))
    ap.add_argument("--init", choices=("jax", "torch"), default="jax",
                    help="with --package both: whose init the two sweeps "
                         "start from")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    dirty, _clean = thospital.synth(a.rows)
    run = {"jax": run_jax, "torch": run_torch, "both": run_both}[a.package]
    runs = []
    forms = a.forms.split(",")
    for form in forms:
        for seed in (int(s) for s in a.seeds.split(",")):
            t = time.time()
            kw = dict(init=a.init) if a.package == "both" else {}
            r = run(a.rows, a.batch, a.particles, FORMS[form], seed, dirty,
                    **kw)
            for pkg, x in (r.items() if a.package == "both"
                           else ((a.package, r),)):
                runs.append(dict(package=pkg, form=form, seed=seed,
                                 init=a.init if a.package == "both"
                                 else a.package,
                                 wall_s=time.time() - t, **x))
                print(json.dumps(runs[-1]), flush=True)
    keys = ("live", "moved_total", "deferred_total", "moved_deferred_total",
            "moved_batched_total")
    summary = {f"{pkg} {form}": {k: float(np.mean([
        r[k] for r in runs if r["form"] == form and r["package"] == pkg]))
        for k in keys}
        for form in forms for pkg in sorted({r["package"] for r in runs})}
    print(json.dumps(dict(package=a.package, rows=a.rows, batch=a.batch,
                          particles=a.particles, init=runs[0]["init"],
                          mean=summary)))
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(
                a.out, f"pg_batch_moves_{a.package}_{runs[0]['init']}_"
                f"{'+'.join(forms)}.json"),
                  "w") as f:
            json.dump(dict(runs=runs, mean=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
