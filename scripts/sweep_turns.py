"""Time chip_smoke.py's paths' init and sweeps of two or more checkouts in
turns on one card.

Each tree in --trees is a directory holding a checkout of the repository
(its chip_smoke.py and pclean_tpu_torch/, for example a `git archive`
unpacked under _tree/). In the order --turns gives (indices into
--trees), a fresh process in that tree runs each path named in --paths
(scaled, rents, flights or one of HOSPITAL_PATHS, each built as the
tree's chip_smoke.py builds it): init_state and
Engine.initialize, timed, then --sweeps sweeps (Engine.sweep), each timed
alone, with Engine.phase_times after each and, where the tree has it, the
one-row loops' counts of that sweep (engine/row_graph.STATS: segments,
rows replayed and eager, captures and their seconds). --settle names
what runs between the init and the sweeps: nothing (none), the caching
allocator's release of its cached blocks (empty_cache) or a full garbage
collection (gc). Every process prints one JSON line a path; all of
them, with the card's name and power limit, go to --out/sweep_turns.json
(sweep_turns_<settle>.json where --settle is not none). Needs one CUDA
card.

    python scripts/sweep_turns.py --trees _tree/parent _tree/change \
        --turns 0,1,1,0 --sweeps 3 --out sweeps_out
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

PATHS = "hospital,hospital_pg1024,hospital_pg16_vmapped"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def setup(cs, path: str):
    """A path's model as chip_smoke.py builds it (cs: the tree's
    chip_smoke module): workloads.<name>.setup's tuple."""
    from pclean_tpu_torch.workloads import flights, hospital, rents, scaled

    if path in cs.HOSPITAL_PATHS:
        return hospital.setup(**cs.HOSPITAL_PATHS[path], device="cuda")
    if path == "scaled":
        return scaled.setup(rows=cs.ROWS, batch=cs.BATCH, device="cuda",
                            **cs.SCALED)
    if path == "rents":
        r = cs.RENTS
        return rents.setup(rows=r["rows"], states=r["states"],
                           counties=r["counties"], batch=r["batch"],
                           device="cuda")
    if path == "flights":
        return flights.setup(**cs.FLIGHTS, device="cuda")
    raise SystemExit(f"sweep_turns: no path {path!r}")


def worker(paths: list, sweeps: int, settle: str) -> None:
    """In a tree (the working directory): each path's init and sweeps, one
    JSON line a path."""
    import torch

    import chip_smoke as cs
    from pclean_tpu_torch import ops
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine

    try:
        from pclean_tpu_torch.engine import row_graph
    except ImportError:   # a tree from before the one-row loops' graphs
        row_graph = None
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.build_kernels()
    for path in paths:
        cm, config, *_rest = setup(cs, path)
        if row_graph is not None:
            row_graph.reset_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        arenas, params = init_state(cm, 0, device="cuda")
        eng = Engine(cm, config, device="cuda")
        arenas, params, gen = eng.initialize(1, arenas, params)
        torch.cuda.synchronize()
        rep = dict(path=path, init_s=time.perf_counter() - t,
                   init_phases=dict(eng.phase_times),
                   init_loops=None if row_graph is None
                   else {k: dict(v) for k, v in row_graph.STATS.items()},
                   settle=settle, sweeps=[])
        if settle == "empty_cache":
            torch.cuda.empty_cache()
        elif settle == "gc":
            gc.collect()
        for _i in range(sweeps):
            if row_graph is not None:
                row_graph.reset_stats()
            eng.phase_times.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            arenas, params, gen = eng.sweep(gen, arenas, params)
            torch.cuda.synchronize()
            rep["sweeps"].append(dict(
                s=time.perf_counter() - t, phases=dict(eng.phase_times),
                loops=None if row_graph is None
                else {k: dict(v) for k, v in row_graph.STATS.items()}))
        print("SWEEP_TURN " + json.dumps(rep, default=str), flush=True)
        del arenas, params, eng, gen, cm
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+")
    ap.add_argument("--turns", default=None,
                    help="indices into --trees, comma-separated (default: "
                    "each tree once)")
    ap.add_argument("--paths", default=PATHS)
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--settle", default="none",
                    choices=("none", "empty_cache", "gc"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    paths = a.paths.split(",")
    if a.worker:
        worker(paths, a.sweeps, a.settle)
        return 0
    turns = [int(i) for i in a.turns.split(",")] if a.turns else \
        list(range(len(a.trees)))
    card = card_line()
    print(f"card: {card}", flush=True)
    out = dict(card=card, trees=a.trees, turns=turns, settle=a.settle,
               runs=[])
    for n, i in enumerate(turns):
        tree = os.path.abspath(a.trees[i])
        env = dict(os.environ, PYTHONPATH=tree)
        t = time.perf_counter()
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--paths", a.paths, "--sweeps", str(a.sweeps),
             "--settle", a.settle],
            cwd=tree, env=env, capture_output=True, text=True)
        wall = time.perf_counter() - t
        if p.returncode != 0:
            print(p.stdout[-4000:], p.stderr[-8000:], sep="\n",
                  file=sys.stderr)
            raise SystemExit(f"turn {n} ({a.trees[i]}) exited "
                             f"{p.returncode}")
        for line in p.stdout.splitlines():
            if not line.startswith("SWEEP_TURN "):
                continue
            r = json.loads(line[len("SWEEP_TURN "):])
            r.update(turn=n, tree=a.trees[i])
            out["runs"].append(r)
            print(f"turn {n} {a.trees[i]} {r['path']}: init "
                  f"{r['init_s']:.4f} s, sweeps "
                  + ", ".join(f"{s['s']:.4f}" for s in r["sweeps"]) + " s",
                  flush=True)
            for k, s in enumerate(r["sweeps"]):
                print(f"  sweep {k} phases {s['phases']}", flush=True)
                if s["loops"] is not None:
                    print(f"  sweep {k} one-row loops {s['loops']}",
                          flush=True)
        print(f"turn {n} took {wall:.1f} s", flush=True)
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        name = "sweep_turns.json" if a.settle == "none" else \
            f"sweep_turns_{a.settle}.json"
        with open(os.path.join(a.out, name), "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
