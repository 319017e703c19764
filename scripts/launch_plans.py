"""K12's, K13's, K16's, K17's, K18's and K20's launches of small CPU runs
of the six paths, counted.

On the CPU the wrappers run their plain versions and count nothing; this
script counts the launches the card would make for the same calls: a
row_gather call one launch and one a fold (ops.chain_folds), a
row_gather_group call (where the package has one) one launch a launch of
ops.row_gather_plan for its chains of at most K18_MAX_HOPS hops, a
level_sum call one launch a stage (ops.level_stages), a fk_score,
choice_score, fk_sample or choice_sample call one launch, a
choice_sample_group call (where the package has one: K17's group mode)
one launch a launch of ops.group_chunks, and, where the package fuses the child
levels into it (ops.score_fusion), the K20 launches of a level's earlier
stages or of a ch_n summed first; a fused level counts no K20 launch of
its own. It runs the
package of the checkout it is started from (the working directory is put
first on sys.path), so a parent's checkout counts the parent's calls:

    cd <checkout> && JAX_PLATFORMS=cpu python <this script> [--json]

Per path (the six paths' models at small sizes: scaled 4,000 rows B = 256,
rents 4,000 rows B = 256, flights 600 rows one sweep, hospital 240 rows B
= 64, its collapsed PG form at P = 64 and its written-out form at B = 16,
P = 16): init and one sweep. Per one proposal of every block of the
hospital model's Record, the flights model's Obs and the scaled model's
Hospital class at one row and at 16: the same launches (a one-row
proposal is a graphed ramp, sweep or replay row's proposal). The ratio of two checkouts' counts a path
scales the card's census of that path.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from pclean_tpu_torch import ops  # noqa: E402
from pclean_tpu_torch.engine.compile import init_state  # noqa: E402
from pclean_tpu_torch.engine.refresh import refresh  # noqa: E402
from pclean_tpu_torch.engine.smc import Engine  # noqa: E402
from pclean_tpu_torch.workloads import (flights, hospital, rents,  # noqa
                                        scaled)

COUNT = {"row_gather": 0, "level_sum": 0, "fk_score": 0, "choice_score": 0,
         "fk_sample": 0, "choice_sample": 0}


def _spy() -> None:
    """Wrap the K18 and K20 entry points to add their card launches to
    COUNT (they still run their plain versions)."""
    rg = ops.row_gather

    def row_gather(slot, hops, leaf, label=None):
        COUNT["row_gather"] += 1 + len(ops.chain_folds(
            len(hops) + 1, ops.K18_MAX_HOPS + 1))
        return rg(slot, hops, leaf, label)

    ops.row_gather = row_gather
    if hasattr(ops, "row_gather_group"):
        group = ops.row_gather_group

        def row_gather_group(slot, chains, label=None):
            short = [c for c in chains if len(c[0]) <= ops.K18_MAX_HOPS]
            if short:   # the long ones go through row_gather, counted there
                COUNT["row_gather"] += len(ops.row_gather_plan(
                    ops._chain_spec(short)[1]))
            return group(slot, chains, label)

        ops.row_gather_group = row_gather_group
    ls = ops.level_sum

    def level_sum(prog, operands, rank, B=1, label=None):
        COUNT["level_sum"] += len(ops.level_stages(prog, operands))
        return ls(prog, operands, rank, B, label)

    ops.level_sum = level_sum

    def score(name, levels):
        real = getattr(ops, name)

        def call(*a, **kw):
            COUNT[name] += 1
            if hasattr(ops, "score_fusion"):   # a fused package's K20s
                COUNT["level_sum"] += sum(ops.score_fusion(
                    levels(a))["stages"])
            return real(*a, **kw)
        setattr(ops, name, call)

    score("fk_score", lambda a: list(a[6:8]))
    score("choice_score", lambda a: [a[1]])
    for name in ("fk_sample", "choice_sample"):
        real = getattr(ops, name)

        def sample(*a, _real=real, _name=name, **kw):
            COUNT[_name] += 1
            return _real(*a, **kw)
        setattr(ops, name, sample)
    if hasattr(ops, "choice_sample_group"):
        csg = ops.choice_sample_group

        def choice_sample_group(recs, pool, cols, label=None):
            COUNT["choice_sample"] += len(ops.group_chunks(len(recs)))
            return csg(recs, pool, cols, label)

        ops.choice_sample_group = choice_sample_group


PATHS = {
    "scaled": lambda: scaled.setup(rows=4000, counties=40, hospitals=320,
                                   names=80, zips=20, batch=256,
                                   device="cpu"),
    "rents": lambda: rents.setup(rows=4000, states=51, counties=120,
                                 batch=256, device="cpu"),
    "flights": lambda: flights.setup(rows=600, flights=24, websites=10,
                                     sweeps=1, device="cpu"),
    "hospital": lambda: hospital.setup(rows=240, batch=64, device="cpu"),
    "hospital_pg1024": lambda: hospital.setup(rows=240, batch=64,
                                              particles=64, device="cpu"),
    "hospital_pg16_vmapped": lambda: hospital.setup(
        rows=240, batch=16, particles=16, collapse_exact_pg=False,
        device="cpu"),
}
PROPOSALS = {   # (path, class): the one-row loops' proposing classes
    ("hospital", "Record"): lambda: hospital.setup(rows=240, batch=16,
                                                   device="cpu"),
    ("flights", "Obs"): lambda: flights.setup(
        rows=300, flights=12, websites=8,
        capacities={"Flight": 16, "TrackingWebsite": 16}, device="cpu"),
    ("scaled", "Hospital"): lambda: scaled.setup(
        rows=2000, counties=20, hospitals=160, names=40, zips=10,
        batch=256, device="cpu"),
}


def _reset() -> None:
    for k in COUNT:
        COUNT[k] = 0


def main() -> int:
    _spy()
    out = {"paths": {}, "proposals": {}}
    for name, make in PATHS.items():
        t = time.time()
        cm, cfg = make()[:2]
        _reset()
        eng = Engine(cm, cfg, device="cpu")
        arenas, params = init_state(cm, 0, device="cpu")
        arenas, params, gen = eng.initialize(1, arenas, params)
        eng.run(gen, arenas, params)
        out["paths"][name] = dict(COUNT, seconds=round(time.time() - t, 1))
        print(name, out["paths"][name], flush=True)
    for (name, cid), make in PROPOSALS.items():
        cm, cfg = make()[:2]
        eng = Engine(cm, cfg, device="cpu")
        arenas, params = init_state(cm, 0, device="cpu")
        arenas, params, _g = eng.initialize(1, arenas, params)
        rel = refresh(cm, arenas, eng.obs_dev)
        for B in (1, 16):
            _reset()
            eng._propose(cid, arenas, rel, params, torch.arange(B),
                         torch.Generator().manual_seed(B), False)
            out["proposals"][f"{name} {cid} B={B}"] = dict(COUNT)
            print(name, cid, B, COUNT, flush=True)
    if "--json" in sys.argv[1:]:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
