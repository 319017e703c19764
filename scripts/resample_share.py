"""How much of each path's init and sweeps is resample_all, on one card.

In the checkout it runs from (the working directory: its chip_smoke.py and
pclean_tpu_torch/), it runs chip_smoke's hospital, hospital_pg1024 and
flights paths (init_state and Engine.initialize, timed, then Engine.run,
timed) with engine.smc's resample_all wrapped: the wrapper synchronises the card before and after each call and adds
the call's wall seconds to its caller's tally (the caller's qualified
name, e.g. Engine.scan_init.<locals>.run, the one-row ramp). Prints one
JSON line a path (init s, sweep s, Engine.phase_times, resample_all's
calls and seconds by caller in the init and in Engine.run, which runs
the config's sweeps) and writes them all, with the card's name and power
limit, to --out/resample_share.json. The syncs add a wait before each
call, so the path's walls here are a little longer than chip_smoke.py's.
Needs one CUDA card.

    python scripts/resample_share.py --out share_out
    python scripts/resample_share.py --paths flights --out DIR
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="hospital,hospital_pg1024,flights")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from pclean_tpu_torch import ops
    from pclean_tpu_torch.engine import smc
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.workloads import flights, hospital

    if not torch.cuda.is_available():
        print("resample_share: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.build_kernels()
    tally: dict = {}
    inner = smc.resample_all

    def timed(*a, **kw):
        caller = sys._getframe(1).f_code.co_qualname
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        n, s = tally.get(caller, (0, 0.0))
        tally[caller] = (n + 1, s + time.perf_counter() - t)
        return out

    smc.resample_all = timed
    card = card_line()
    reps = []
    for path in args.paths.split(","):
        if path == "flights":
            cm, config, *_r = flights.setup(**cs.FLIGHTS, device="cuda")
        else:
            cm, config, *_r = hospital.setup(**cs.HOSPITAL_PATHS[path],
                                             device="cuda")
        tally.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        arenas, params = init_state(cm, 0, device="cuda")
        eng = smc.Engine(cm, config, device="cuda")
        arenas, params, gen = eng.initialize(1, arenas, params)
        torch.cuda.synchronize()
        rep = dict(path=path, card=card, init_s=time.perf_counter() - t,
                   init_phases=dict(eng.phase_times),
                   init_resample={k: dict(calls=n, s=s)
                                  for k, (n, s) in tally.items()})
        tally.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        arenas, params, gen = eng.run(gen, arenas, params)
        torch.cuda.synchronize()
        rep.update(sweep_s=time.perf_counter() - t,
                   sweep_phases=dict(eng.phase_times),
                   sweep_resample={k: dict(calls=n, s=s)
                                   for k, (n, s) in tally.items()})
        reps.append(rep)
        print(json.dumps(rep), flush=True)
        del cm, arenas, params, eng
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "resample_share.json"), "w") as f:
            json.dump(dict(card=card, paths=reps), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
