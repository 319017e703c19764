"""K2 inv_cdf_sample of several checkouts on one card, bit for bit.

    python scripts/k2_bits.py --trees TREE_A TREE_B [--out DIR]

Each tree is a directory holding a `pclean_tpu_torch/` (its kernels built
into its own _build/). On the same seeded inputs, K2 of every tree must
give the same indices as the first tree's at every shape: one row and
4,096 rows of each row length the port's paths draw over (2 to 11,265,
and 70,001, which streams through shared memory), with 30% of each row's
logits at NEG_INF and the uniforms 0 and 1 - 2^-24 among them. Prints one
JSON line (and writes DIR/k2_bits.json): the shapes, the rows compared
and the rows that differ (which must be none).
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

ROWS = (1, 4096)
LENGTHS = (2, 9, 23, 65, 161, 1473, 5125, 11265, 70001)


def inputs(dev, R: int, K: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, K)).astype(np.float32) * 3
    x[rng.random((R, K)) < 0.3] = -1e30
    x[np.arange(R), rng.integers(0, K, R)] = 0.0
    u = rng.random(R).astype(np.float32)
    u[0] = 0.0
    if R > 1:
        u[1] = np.float32(1.0 - 2.0 ** -24)
    return (torch.as_tensor(x, device=dev), torch.as_tensor(u, device=dev))


def main(argv=None) -> int:
    from pclean_tpu_torch.kernel_bench import _load_tree_ops, require

    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    trees = [_load_tree_ops(t, f"_k2tree{i}")
             for i, t in enumerate(args.trees)]
    for ops in trees:
        ops.build_kernels()
    shapes = []
    for K in LENGTHS:
        for R in ROWS:
            lg, u = inputs(dev, R, K, seed=K + R)
            got = [ops.inv_cdf_sample(lg, u) for ops in trees]
            torch.cuda.synchronize()
            diff = [int((g != got[0]).sum()) for g in got[1:]]
            shapes.append(dict(R=R, K=K, rows=R, differ=diff))
            print(f"K2 [{R}, {K}]: rows differing from {args.trees[0]}: "
                  f"{diff}", flush=True)
    report = dict(trees=args.trees, shapes=shapes,
                  differ=sum(sum(s["differ"]) for s in shapes))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "k2_bits.json"), "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    require(report["differ"] == 0, "K2 differs between the trees")
    return 0


if __name__ == "__main__":
    sys.exit(main())
