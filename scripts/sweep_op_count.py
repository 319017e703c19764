"""Count the PyTorch operator calls of one hospital sweep on the CPU.

Runs a checkout's port (--tree, default this repository) on the hospital
model at a small size: Engine.initialize, then one Engine.sweep under a
TorchDispatchMode that counts every ATen operator call (views included).
Prints the total, the rows each class's sequential replay took, and the
most frequent operators. Two trees' counts side by side tell whether a
change added host-side work to the batched sweep.

    JAX_PLATFORMS=cpu python scripts/sweep_op_count.py --tree _tree/parent --kind pg16
"""
from __future__ import annotations

import argparse
import collections
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--kind", choices=("mh", "pg16"), default="mh",
                    help="mh: MH at B = --batch; pg16: written-out PG, "
                    "P = 4, at B = --batch")
    ap.add_argument("--rows", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    sys.path.insert(0, tree)

    import torch  # noqa: F401
    from torch.utils._python_dispatch import TorchDispatchMode

    import pclean_tpu_torch
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.workloads import hospital

    if not os.path.abspath(pclean_tpu_torch.__file__).startswith(tree):
        raise SystemExit(f"imported {pclean_tpu_torch.__file__}, not {tree}")
    kw = dict(rows=a.rows, repeat=1, batch=a.batch)
    if a.kind == "pg16":
        kw.update(particles=4, collapse_exact_pg=False)
    cm, config, *_rest = hospital.setup(**kw, device="cpu")
    arenas, params = init_state(cm, 0, device="cpu")
    eng = Engine(cm, config, device="cpu")
    arenas, params, gen = eng.initialize(1, arenas, params)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        eng.sweep(gen, arenas, params)
    print(f"{a.kind} {a.tree}: {sum(c.n.values())} operator calls in one "
          f"sweep")
    print("sequential replay rows:", {
        k: v.get("replayed_seq_rows") for k, v in eng.phase_times.items()})
    for name, n in c.n.most_common(8):
        print(f"  {name} {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
