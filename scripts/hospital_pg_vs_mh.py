"""The port's hospital path at bench.py's 100,000 rows, MH against
1,024-particle PG (collapsed), in turns on one card.

    python scripts/hospital_pg_vs_mh.py --turns mh,pg,pg,mh --out DIR

Each turn runs pclean_tpu_torch.workloads.hospital.setup(rows=1000,
repeat=100, batch=4096), with particles=1024 for "pg", through
init_state(seed 0), Engine.initialize(1), Engine.run and
evaluate_accuracy_device, with the launch counts set to 0 just before, and
prints one JSON line (after the card's name and power limit): init s,
sweep s, rows-cleaned/s, F1, init log-ML, peak device memory, each
kernel's launches and the init's phase times.
The two configurations run the same kernels at the same shapes; under the
exact-Gibbs collapse a PG row is MH's one proposal plus one uniform, so
the turns tell the collapse's cost from the host's noise. With --out the
lines also go to DIR/hospital_pg_vs_mh.json.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pclean_tpu_torch import ops  # noqa: E402
from pclean_tpu_torch.analysis import evaluate_accuracy_device  # noqa: E402
from pclean_tpu_torch.engine.compile import init_state  # noqa: E402
from pclean_tpu_torch.engine.smc import Engine  # noqa: E402
from pclean_tpu_torch.workloads import hospital  # noqa: E402

CONFIGS = {"mh": dict(rows=1000, repeat=100, batch=4096),
           "pg": dict(rows=1000, repeat=100, batch=4096, particles=1024)}


def turn(name: str) -> dict:
    cm, config, dirty, clean, query, _s = hospital.setup(**CONFIGS[name],
                                                         device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    torch.cuda.synchronize()
    t = time.time()
    arenas, params = init_state(cm, 0, device="cuda")
    eng = Engine(cm, config, device="cuda")
    arenas, params, gen = eng.initialize(1, arenas, params)
    torch.cuda.synchronize()
    init_s = time.time() - t
    t = time.time()
    arenas, params, gen = eng.run(gen, arenas, params)
    torch.cuda.synchronize()
    sweep_s = time.time() - t
    res = evaluate_accuracy_device(cm, arenas, params, dirty, clean, query)
    rows = len(next(iter(dirty.values())))
    return dict(config=name, rows=rows, init_s=init_s, sweep_s=sweep_s,
                rows_cleaned_per_s=rows / (init_s + sweep_s), f1=res["f1"],
                log_ml=float(eng.log_ml),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                launches={k: v for k, v in ops.LAUNCHES.items() if v},
                init_phases=eng.phase_times["Record"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", default="mh,pg,pg,mh")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("hospital_pg_vs_mh: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; build {ops.build_kernels():.2f} s", flush=True)
    out = []
    for name in a.turns.split(","):
        out.append(turn(name))
        print(json.dumps(out[-1]), flush=True)
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "hospital_pg_vs_mh.json"), "w") as f:
            json.dump(dict(card=card, turns=out), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
