"""Inputs, checks and timings of the port's hand kernels on the card.

chip_smoke.py uses it to hold every kernel against its plain version and
time it at the shapes the main path launches it at: the batch shape
(B = batch_rows rows), the sequential shape (one row, the ramp and replay
loops) and, for K1 and K2, every row length and mode the main path gives
them (`k1_shapes`: each fk target's capacity and each choice's vocabulary).
Run alone, it compares the kernels of several checkouts on one card, in
turns, on the same inputs:

    python -m pclean_tpu_torch.kernel_bench --trees PARENT CHANGE \\
        --turns 0,1,1,0 --out DIR

(each tree a directory holding a `pclean_tpu_torch/`; the model is built
once by this checkout's package; DIR/kernel_ab.json gets every turn). Its
shapes are those two and two more batches the main path also launches:
66 rows, the fewest that K3's plan stages, and 1,024, the chunk of the
batched birth-allocation replay; and K1 (with K2 on K1's record) at one
row and at the batch shape for every entry of `k1_shapes`. Every turn
checks K1 in both modes, K2 and K3 against their plain versions before it
times them. The turns also time K4 at 50,000 seeded referrers into
[4,096, 5] (AB_K4, beside its library call: a zeroed buffer and one
index_add_ of n, sz, szz and pre0, k4_library), K5 at AB_K5 (the rents
path's County batch [256, 51] with C = 5, one row, C = 1 and 17, and
4,096 rows, seeded; each twice: the whole step from the env coordinates
to the term, which for a tree whose K5 takes a row index includes its
caller's torch build of that index, and the kernel alone on a prebuilt
index, k5_ab_call), K6 at the flights path's four list shapes and its
dense shape (AB_K6), K7 at AB_K7's shapes (scaled's, rents' and
hospital's hoisted histograms, one row and 4,096 rows of V = 5,125, and
hospital's shapes with their counts crowded into few cells) and K8 at
AB_K8's (the hospital census shapes' sizes on seeded inputs, and a batch
whose every row holds referrers), K9 at AB_K9's (the
hospital_pg16_vmapped path's census shapes, seeded), K18 at AB_K18's
(one chain at one slot and at 1,000,000 beside torch.take, a copy group
of five as one group launch or a launch a chain) and K20 at AB_K20's
(one output, rents' [256, 4,096, 2] with one add and with its own
program) and AB_K20_GATHERS' (the hospital Record block's one-row level
of 512 candidates and 11 gathers), K19 at AB_K19's (one row at every
census count of pairs, beside torch.where at one pair, and the batched
census shapes), K10 at AB_K10's (the census classes of the six paths,
both signs, on seeded states of small models of theirs, k10_ab_inputs),
K11 at one row of every class of the same models (k11_ab_inputs: each
census shape, a class and its births) and K21 at AB_K21's shapes or,
with --k21-shapes, at every census shape a chip_smoke.py run checked
(k21_census_shapes), each checked against its plain version, K10, K11
and K18-K21 also with their host microseconds a call back to back
(host_us); with k10 or k19 the run also prints what a launch's parameter
block costs by its size and by the lines read of it (param_block_ms,
this checkout's probe); `--kernels k4,k5,k6,k7,k8,k9,k10,k11,k18,k19,
k20,k21` (any of them) times only those, with no model to build but the
small ones of K10 and K11. With --paths it also
times each of K1's paths
at each of those shapes and over an R x K grid in both modes (the last
tree's kernels; PERF.md takes the plan's cut-overs from that
table). With --census hospital it first runs the hospital workload at
bench.py's configuration (HOSPITAL_PATH: 100,000 rows, B = 4,096, MH, one
sweep; chip_smoke.py runs it with PG as hospital_pg1024) with this
checkout's package, then times K7 and K8
(those in --kernels) in the turns at every shape of that run's launch
census too, on inputs from its state (`k7_census_inputs`,
`k8_census_inputs`): the hospital's Records crowd into its few live
slots, which seeded inputs do not reproduce.

Two times are kept for each kernel: `ms`, CUDA events around one call
(median), which also counts the host's time for the call where it exceeds
the device's, and `device_ms`, the device time per call from a CUDA graph
of many calls. Two yardsticks stand beside K1's device time, both timed
the same way and never called by the port: `library_device_ms`, one
torch.logsumexp over the same rows, and the launch floor
(`launch_floor_ms`), one PyTorch op on one element.

K4 and K5 (the rents path's Gaussian statistics and external term) take
their inputs from the rents model's own state (`rents_inputs`): K4 over
every Obs row into County's slots, K5 over a County batch of B rows and
the state axis, from the env coordinates as the tracer holds them; and
K5 at every shape of the rents path's launch census, over every batch of
County's sweep (`k5_census_inputs`); `k5_seeded` draws seeded inputs of
the County block's form for the A/B. K6 (the flights path's MaybeSwap
external) takes its inputs from the flights model's state
(`flights_inputs`): one Flight slot against its referrers, for each of
the four time fields, and at every shape of a path's launch census (`k6_census_inputs`); `k6_inputs` draws
seeded inputs of any shape for the card tests and the A/B. K7 and K8 (the
referrer histograms and the hospital's composed stateavg term) take
theirs from a path's state at every shape of its launch census
(`k7_census_inputs`, `k8_census_inputs`); `k7_seeded` and `k8_seeded` draw
seeded inputs for the card tests, and `k3_seeded` K3's at any shape of a
census. K9 (the particle resampling) takes seeded weights at every shape
of a path's launch census (`k9_census_inputs`, `k9_inputs`, half the rows
spread so that they resample). K7's yardstick is one torch.bincount of the kept
cells, which reads its input's maximum back to the host and so is timed by
events only. K12 and K13 (the one-row score glue) take seeded inputs at
every shape of a path's census (`score_census`, `k12_inputs`,
`k13_inputs`), checked by `check_score` and timed by `time_score` beside
torch.logsumexp over the record. `graph_against_eager` runs rows of a
one-row loop once eagerly and once as replays of its CUDA graph and
compares every leaf bit for bit. K14 and K15 (the relational scatters and
the batched row write) take seeded inputs of every shape of a path's
census, rebuilt from its census mode (`k14_inputs`, `k15_inputs`),
checked bit-equal against the plain versions on a CPU copy
(`check_k14`, `check_k15`) and timed beside one `index_add_` (K14) or
`index_copy_` of one column (K15) (`time_k14`, `time_k15`; a call
that launches nothing, or a library write with no kept value, is not
timed: its CUDA graph would be empty);
`check_rel_state` holds refresh and the hop histograms on a path's state
to their plain versions. K16-K19 (the sample pass and row lookups) take
seeded inputs of every shape of a path's census, rebuilt from the fields
its wrapper recorded (`ops.CENSUS_FIELDS`; `sample_inputs`:
`k16_inputs`-`k19_inputs`), checked bit-equal against the plain versions
drawing with K2 (`check_sample`) and timed beside the plain versions and,
for K17's pick mode, K18 and K19, torch.take of the record or the leaf
and torch.where of one pair (`time_sample`, `sample_bytes`). K20 and K21
(the score pass's level sum and a batched fk's prior) likewise
(`level_inputs`: `k20_inputs` from the recorded program and operands,
`k21_inputs`), checked bit-equal against the plain versions on the card
(`check_level`) and timed beside them (`time_level`, `level_bytes`).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import importlib
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from .utils import chase, take

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
KERNELS = ("enum_logsumexp", "inv_cdf_sample", "obs_gather_sum")
# K2: share of rows allowed to differ from torch.cumsum's pick, and how
# close to a CDF boundary (as a share of the total) a differing draw must be
K2_MAX_MISMATCH = 1e-2
K2_BOUNDARY = 1e-5


def require(cond, what: str) -> None:
    """Fail the run when a check does not hold (unlike assert, also under
    python -O)."""
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps=20, warmup=3) -> float:
    """Median ms per call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, reps=10) -> float:
    """Median device ms per call of `fn`, from a CUDA graph of n calls
    replayed reps times between CUDA events (n so that a replay takes about
    20 ms, 5 to 100 calls): the host's time per call (Python, ctypes, the
    launch) is left out. Events around a single call (cuda_ms) also count
    the host's time wherever it exceeds the device's, about 0.03 ms for a
    kernel's wrapper here."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    n = int(min(100, max(5, 20.0 / max(cuda_ms(fn, reps=3, warmup=0),
                                        1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return float(np.median(times))


def main_path_inputs(cm, dev, B: int, seed: int = 0) -> dict:
    """Seeded inputs of K1-K3 at B rows against the Hospital candidate axis
    (K = its capacity; _kc keeps the full axis at the scaled workload's size
    since ~8,000 live hospitals exceed half of 11,264): K1's and K2's from
    k1_inputs in fk mode (K2's logits = K1's record [B, K+1]); K3's
    Record-block AddTypos matrices (C = 3), the data's first B observed
    codes and random word codes."""
    from .engine.kernels import _AddTyposK

    K = cm.layouts["Hospital"].capacity
    inp = k1_inputs(dev, B, K, "fk", seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    spec = cm.obs_specs[0]
    cols = [v for v in sorted(spec.columns)
            if isinstance(cm.kernels[cm.canon("Record", v)], _AddTyposK)]
    mats = [cm.use(cm.kernels[cm.canon("Record", v)].M) for v in cols]
    obs = torch.as_tensor(np.stack([spec.columns[v][0][:B] for v in cols],
                                   1).astype(np.int32), device=dev)
    word = torch.stack([torch.randint(0, m.shape[0], (K,), generator=g,
                                      device=dev) for m in mats]) \
        .to(torch.int32)
    return dict(inp, B=B, mats=mats, obs=obs, word=word)


def k1_shapes(cm) -> list:
    """(mode, K) of every K1 launch of the scaled workload's main path: an
    fk enumeration over each fk target's capacity (Hospital, County) and a
    choice enumeration over each Record AddTypos column's vocabulary."""
    from .engine.kernels import _AddTyposK

    spec = cm.obs_specs[0]
    vs = [cm.kernels[cm.canon("Record", v)].M.shape[0]
          for v in sorted(spec.columns)
          if isinstance(cm.kernels[cm.canon("Record", v)], _AddTyposK)]
    return ([("fk", cm.layouts[c].capacity) for c in ("Hospital", "County")]
            + [("choice", int(v)) for v in vs])


def k1_inputs(dev, R: int, K: int, mode: str, seed: int = 0) -> dict:
    """Seeded K1 inputs of R rows of K logits (a fifth of them NEG_INF, as
    main_path_inputs): exist [R, K], new [R] in fk mode (None in choice
    mode); K2's logits = K1's record (exist itself in choice mode) and one
    uniform per row."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    exist = torch.randn((R, K), generator=g, device=dev) * 3.0
    exist = torch.where(torch.rand((R, K), generator=g, device=dev) < 0.2,
                        torch.full_like(exist, -1e30), exist)
    new = torch.randn((R,), generator=g, device=dev) if mode == "fk" \
        else None
    u = torch.rand((R,), generator=g, device=dev)
    logits = exist if new is None else torch.cat([exist, new[:, None]], 1)
    return dict(R=R, K=K, mode=mode, exist=exist, new=new, logits=logits,
                u=u)


def k1_bytes(R: int, K: int, mode: str) -> int:
    """K1's bytes: exist read once and logZ written; in fk mode also new
    read and the record [R, K+1] written."""
    if mode == "fk":
        return R * K * 4 + R * 4 + R * (K + 1) * 4 + R * 4
    return R * K * 4 + R * 4


def k2_bytes(R: int, K: int) -> int:
    """K2's bytes: logits [R, K] and u read once, indices written."""
    return R * K * 4 + R * 4 + R * 4


def launch_floor_ms() -> float:
    """Device ms of one PyTorch op on one element (graph_ms): what any
    launch costs on the card whatever it does."""
    x = torch.zeros((1,), device="cuda")
    return graph_ms(lambda: x.add_(1.0))


def time_k1(ops, inp: dict, plain: bool = True) -> dict:
    """K1 on these inputs, and K2 on K1's record: ms / device_ms of each
    (cuda_ms / graph_ms), K1's plain_ms and library_ms (events) and
    library_device_ms (graph_ms of torch.logsumexp over the record)."""
    exist, new, lg, u = inp["exist"], inp["new"], inp["logits"], inp["u"]
    k1 = lambda: ops.enum_logsumexp(exist, new)  # noqa: E731
    k2 = lambda: ops.inv_cdf_sample(lg, u)  # noqa: E731
    res = dict(ms=cuda_ms(k1), device_ms=graph_ms(k1),
               k2_ms=cuda_ms(k2), k2_device_ms=graph_ms(k2))
    if plain:
        lib = lambda: torch.logsumexp(lg, dim=1)  # noqa: E731
        res.update(plain_ms=cuda_ms(lambda: ops.enum_logsumexp_plain(exist,
                                                                     new)),
                   library_ms=cuda_ms(lib), library_device_ms=graph_ms(lib),
                   k2_plain_ms=cuda_ms(
                       lambda: ops.inv_cdf_sample_plain(lg, u)))
    return res


def k1_path_ms(ops, inp: dict) -> dict:
    """{path: device ms} of every path of K1's plan on these inputs, each
    checked against the plain version first (check_k1)."""
    exist, new = inp["exist"], inp["new"]
    out = {}
    for path in ops.K1_PATHS:
        check_k1(ops, exist, new, path=path)
        out[path] = graph_ms(lambda: ops.enum_logsumexp(exist, new,
                                                        path=path))
    return out


# R x K grid over which --paths also times K1's paths (PERF.md's cut-overs)
PATH_GRID_R = (1, 8, 66, 1024, 4096)
PATH_GRID_K = (138, 512, 1024, 1472, 2048, 5125, 8192, 11264)


def check_k1(ops, exist, new, path=None) -> float:
    """Record bit-equal, logZ within 1e-6 of the larger of |logZ| and the
    row's |max| (the same f32 formula, max + log(sum of exp), summed in
    another order: its rounding scales with the max, and logZ itself can
    lie near 0 in a row of a few options). `new` None checks choice mode.
    Returns max |dlogZ|."""
    r0, z0 = ops.enum_logsumexp_plain(exist, new)
    r1, z1 = (ops.enum_logsumexp(exist, new) if path is None
              else ops.enum_logsumexp(exist, new, path=path))
    torch.cuda.synchronize()
    require(torch.equal(r0, r1), "K1 record differs from the plain version")
    d = (z1 - z0).abs()
    scale = torch.maximum(z0.abs(), r0.amax(-1).abs())
    require(bool(((d <= 1e-6 * scale) | (z1 == z0)).all()),
            f"K1 logZ err {float(d.max())}")
    return float(d.max())


def check_k2(ops, logits, u) -> dict:
    """Indices equal to the plain version's on all but K2_MAX_MISMATCH of
    the rows (a share that only means something over 100 rows or more, so
    fewer rows are held to the next rule alone); on a differing row every
    entry between the two picks has its exact (float64) prefix sum within
    K2_BOUNDARY of the total from the threshold (the draw sat on a boundary
    that the kernel's exact fixed-point sums and torch.cumsum's f32 sums
    place apart); the pick in range and never an entry of zero mass."""
    a = ops.inv_cdf_sample(logits, u)
    b = ops.inv_cdf_sample_plain(logits, u)
    torch.cuda.synchronize()
    diff = a != b
    rate = float(diff.float().mean())
    if a.numel() * K2_MAX_MISMATCH >= 1:
        require(rate <= K2_MAX_MISMATCH, f"K2 mismatch rate {rate}")
    gap = 0.0
    if bool(diff.any()):
        rows = torch.nonzero(diff)[:, 0]
        lg = logits[rows].double()
        c = torch.cumsum(torch.exp(lg - lg.max(1, keepdim=True).values), 1)
        ub = (1.0 - u[rows].double()) * c[:, -1]
        lo = torch.minimum(a[rows], b[rows]).long()[:, None]
        hi = torch.maximum(a[rows], b[rows]).long()[:, None]
        pos = torch.arange(c.shape[1], device=logits.device)[None, :]
        between = (pos >= lo) & (pos < hi)
        gap = float(((c - ub[:, None]).abs() / c[:, -1:])
                    .masked_fill(~between, 0).max())
        require(gap <= K2_BOUNDARY,
                f"K2 differs away from a boundary ({gap})")
    require(bool(((a >= 0) & (a < logits.shape[1])).all()), "K2 out of range")
    p = torch.exp(logits - logits.amax(1, keepdim=True))
    picked = p.gather(1, a.long()[:, None])[:, 0]
    require(bool((picked > 0).all()), "K2 drew a zero-mass entry")
    return dict(mismatch_rate=rate, max_abs_err=float((a - b).abs().max()),
                boundary_gap=gap)


def check_k3(ops, mats, obs, word) -> float:
    """Bit-equal to the plain version (same column order)."""
    o0 = ops.obs_gather_sum_plain(mats, obs, word)
    o1 = ops.obs_gather_sum(mats, obs, word)
    torch.cuda.synchronize()
    require(torch.equal(o0, o1), "K3 differs from the plain version")
    return float((o1 - o0).abs().max())


def gauss_external(cm, cid="County"):
    """(node, kern, inv) of class cid's Gaussian external (the rents
    model's rent likelihood seen from County)."""
    from .engine.kernels import _GaussianK
    from .model.ir import ExternalLikelihoodNode

    c = cm.cls(cid)
    for node in c.nodes:
        if isinstance(node, ExternalLikelihoodNode):
            kern = cm.kernels.get(cm.canon(node.path[-1][0], node.ext_id))
            if isinstance(kern, _GaussianK):
                inv = {sv: tv for tv, sv in
                       c.incoming_references[node.path].items()}
                return node, kern, inv
    raise ValueError(f"{cid} has no Gaussian external")


def rents_inputs(cm, arenas, params, obs_dev, B: int) -> dict:
    """K4's and K5's inputs at the shapes the rents path launches them at,
    from the rents model's state: K4 over every Obs row into County's
    slots (propose.gauss_stats_inputs); K5 over the first B live County
    slots and every state, with the statistics K4 makes of that state,
    the indexed Mean's values, the key table in the order _ext_gauss_term
    reads it and its env coordinates as the tracer holds them
    (rents_k5_coords). Returns dict(k4=..., k5=...)."""
    from . import ops
    from .engine.propose import gauss_stats_inputs
    from .engine.refresh import refresh

    node, kern, inv = gauss_external(cm)
    rel = refresh(cm, arenas, obs_dev)
    cap = cm.layouts["County"].capacity
    k4 = gauss_stats_inputs(cm, arenas, params, rel, obs_dev, cap, node,
                            kern, inv)
    n, sz, szz, pre0 = ops.gauss_suffstats_plain(**k4)
    slots = torch.nonzero(rel["County"]["alive"])[:B, 0]
    k5 = dict(rents_k5_coords(cm, arenas, params, slots, node, kern, inv),
              n=n, sz=sz, szz=szz, pre0=pre0)
    return dict(k4=k4, k5=k5)


def rents_k5_coords(cm, arenas, params, slots, node, kern, inv) -> dict:
    """K5's inputs but the statistics for the County rows `slots` (int64,
    as the tracer's row_slot): the Mean's values, the key table with its
    env axes first (gauss_key_table), and the env coordinates as
    BlockTracer.aligned gives them at depth 1: the enumerated state
    arange(A) as [1, A] int64, and the row's own key, the arena column
    taken at the slots (clamped, as the tracer takes it) as [B, 1]."""
    from .engine.propose import gauss_key_table, gauss_mean_lookup

    src = node.path[-1][0]
    mnode, knode = gauss_mean_lookup(cm, src, kern)
    env = [a for a in knode.arg_ids if a in inv]
    ref = [a for a in knode.arg_ids if a not in inv]
    order = tuple(knode.arg_ids.index(a) for a in env + ref)
    env_shape, tbl = gauss_key_table(cm, src, mnode.key_id, order)
    state_vid = cm.cls("County").names["state"]
    A = cm.domain("County", state_vid).size
    coords = []
    for a in env:
        if inv[a] == state_vid:  # the enumerated axis
            coords.append(torch.arange(A, device=cm.device)[None, :])
        else:
            coords.append(take(arenas["County"]["values"][inv[a]],
                               slots)[:, None])
    pv = cm.canon(src, mnode.param_id)
    return dict(values=params[pv[0]][pv[1]]["value"], tbl=cm.use(tbl),
                coords=tuple(coords), env_shape=tuple(env_shape),
                slot=slots, full=(len(slots), A),
                coef=-0.5 * (1.0 / (kern.std * kern.std)))


def k5_census_inputs(cm, arenas, params, obs_dev, census: list,
                     B: int) -> list:
    """K5's inputs at every shape of the rents path's launch census
    (ops.census() rows of gauss_ext_term: route and output "coords,BxA",
    r1 or rn, C), from its state: for a batched shape every batch of
    County's sweep (slots bi * B + arange(B) up to the capacity, the last
    padded past it as the sweep pads it), for a one-row shape the first
    live slot. Returns [(census row, [inputs, ...])]."""
    from .engine.refresh import refresh

    node, kern, inv = gauss_external(cm)
    rel = refresh(cm, arenas, obs_dev)
    cap = cm.layouts["County"].capacity
    base = rents_inputs(cm, arenas, params, obs_dev, 1)["k5"]
    stats = {k: base[k] for k in ("n", "sz", "szz", "pre0")}
    out = []
    for r in census:
        if r["kernel"] != "gauss_ext_term":
            continue
        route, shape = r["mode"].split(",")
        rows, A = (int(x) for x in shape.split("x"))
        require(route == "coords" and A == base["full"][1]
                and r["K"] == base["tbl"].shape[1]
                and rows == (1 if r["rows"] == "r1" else B),
                f"K5 census shape {r} is not the County block's")
        if r["rows"] == "r1":
            batches = [torch.nonzero(rel["County"]["alive"])[:1, 0]]
        else:
            batches = [bi * B + torch.arange(B, device=cm.device)
                       for bi in range(-(-cap // B))]
        out.append((r, [dict(rents_k5_coords(cm, arenas, params, sl, node,
                                             kern, inv), **stats)
                        for sl in batches]))
    return out


def check_k4(ops, k4: dict) -> float:
    """n equal to the plain version's; sz, szz and pre0 within rtol 1e-5 of
    each cell's sum of |terms| (the atomics add in another order). Returns
    the largest |difference|."""
    got = ops.gauss_suffstats(**k4)
    want = ops.gauss_suffstats_plain(**k4)
    mag = ops.gauss_suffstats_plain(**dict(
        k4, z=k4["z"].abs(), ld=-(k4["const"] - k4["ld"]).abs(), const=0.0))
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]), "K4 n differs from the plain "
            "version")
    err = 0.0
    for i, nm in ((1, "sz"), (2, "szz"), (3, "pre0")):
        d = (got[i] - want[i]).abs()
        require(bool((d <= 1e-5 * mag[i] + 1e-6).all()),
                f"K4 {nm} differs by {float(d.max())}")
        err = max(err, float(d.max()))
    return err


def check_k5(ops, k5: dict) -> float:
    """Within 2^-20 * |coef| * (|sum szz| + 2 |sum mu sz| + |sum mu^2 n|)
    + 1e-5 of the plain version (the three f32 sums in another order, then
    subtracted), and two launches bit-equal (a fixed order). Returns the
    largest |difference|."""
    got = ops.gauss_ext_term(**k5)
    again = ops.gauss_ext_term(**k5)
    torch.cuda.synchronize()
    require(torch.equal(got, again), "K5 differs between two launches")
    return k5_error(k5, got)


def k5_error(k5: dict, got) -> float:
    """The largest |got - this checkout's plain version| on k5 (got
    reshaped to the output shape), failing beyond check_k5's tolerance."""
    from . import ops

    want = ops.gauss_ext_term_plain(**k5)
    part = {k: k5[k] for k in ("values", "tbl", "coords", "env_shape",
                               "slot", "n", "sz", "szz", "full") if k in k5}
    a_szz, a_sz, a_n = ops.gauss_ext_term_parts(**part)
    scale = abs(k5["coef"]) * (a_szz.abs() + 2 * a_sz.abs() + a_n.abs())
    torch.cuda.synchronize()
    d = (got.reshape(want.shape) - want).abs()
    require(bool((d <= 2.0 ** -20 * scale + 1e-5).all()),
            f"K5 differs by {float(d.max())}")
    return float(d.max())


def k4_bytes(k4: dict) -> int:
    """K4's bytes: t, rv, z, ld (4 B) and w (1 B) of every referrer read
    once, n, sz, szz and pre0 written once."""
    R = k4["z"].shape[0]
    return R * 17 + (3 * k4["cap"] * k4["C"] + k4["cap"]) * 4


def k5_bytes(k5: dict) -> int:
    """K5's bytes on these inputs: each coordinate's own elements (not its
    broadcast), the slots and out [full], each key table row and Mean value
    the batch touches, and the distinct slots' statistics (3 C + 1
    floats), each once."""
    from . import ops

    tbl, slot = k5["tbl"], k5["slot"]
    full = tuple(k5.get("full") or ())
    rows = ops.gauss_key_rows(k5["coords"], k5["env_shape"], full,
                              tbl.device)
    rows = torch.unique(rows.clamp(0, tbl.shape[0] - 1))
    C = tbl.shape[1]
    vals = torch.unique(tbl[rows].long().clamp(0, k5["values"].shape[0] - 1))
    nslot = int(torch.unique(slot.long().clamp(0, k5["n"].shape[0] - 1))
                .numel())
    coords = sum(e.numel() * e.element_size() for e in k5["coords"])
    out = 1
    for x in full:
        out *= x
    return (coords + slot.numel() * slot.element_size() + out * 4
            + int(rows.numel()) * C * 4 + int(vals.numel()) * 4
            + nslot * (3 * C + 1) * 4)


def k5_seeded(dev, B: int, A: int, C: int, keys: int = 1500,
              cap: int = 4096, seed: int = 0) -> dict:
    """Seeded K5 inputs shaped as the rents County block: the state axis
    [1, A] int64 and a county key of `keys` per row [B, 1] int32 as the
    env coordinates (env_shape (A, keys)), the rents key table's form (row
    r's C entries point at values r * C to r * C + C - 1: a Mean per
    (state, county key, room type)), seeded values, int64 slots drawn from
    `cap`, and the statistics K4 makes of 50,000 seeded referrers
    (k4_seeded)."""
    from . import ops

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    E = A * keys
    n, sz, szz, pre0 = ops.gauss_suffstats_plain(**k4_seeded(dev, 50_000,
                                                             cap, C))
    values = torch.randn((E * C,), generator=g, device=dev) * 1000 + 1500
    tbl = torch.arange(E * C, device=dev, dtype=torch.int32).reshape(E, C)
    key = torch.randint(0, keys, (B, 1), generator=g, device=dev,
                        dtype=torch.int32)
    slot = torch.randperm(cap, generator=g, device=dev)[:B] if B <= cap \
        else torch.randint(0, cap, (B,), generator=g, device=dev)
    return dict(values=values, tbl=tbl,
                coords=(torch.arange(A, device=dev)[None, :], key),
                env_shape=(A, keys), slot=slot, n=n, sz=sz, szz=szz,
                pre0=pre0, coef=-0.5 / 150.0 ** 2, full=(B, A))


def k5_parent_index(k5: dict):
    """The row index as the parent's caller built it before K5 took the
    coordinates (engine/propose.py's torch.zeros, then idx * n_i +
    clamp(e_i) for each env axis): [B, A] int64."""
    idx = torch.zeros(k5["full"], dtype=torch.long, device=k5["tbl"].device)
    for e, n in zip(k5["coords"], k5["env_shape"]):
        idx = idx * n + e.long().clamp(0, n - 1)
    return idx.reshape(k5["full"][0], -1)


def k5_ab_call(ops, k5: dict, part: str):
    """One tree's K5 `part` on k5, as a call: "step", everything from the
    env coordinates to the term (a tree whose K5 takes the row index: its
    caller's torch build of the index, the int32 casts and the launch; a
    tree whose K5 takes the coordinates: the one call), or "kernel", the
    kernel alone on the same prebuilt int32 index and slots (as one
    coordinate over the table's rows where K5 takes coordinates)."""
    import inspect

    legacy = "idx" in inspect.signature(ops.gauss_ext_term).parameters
    if part == "step" and not legacy:
        return lambda: ops.gauss_ext_term(**k5)
    full, B = tuple(k5["full"]), k5["full"][0]
    vt = (k5["values"], k5["tbl"])
    stats = (k5["n"], k5["sz"], k5["szz"], k5["pre0"], k5["coef"])
    if part == "step":
        def step():
            idx = k5_parent_index(k5)
            return ops.gauss_ext_term(*vt, idx.to(torch.int32),
                                      k5["slot"].to(torch.int32),
                                      *stats).reshape(full)
        return step
    idx = k5_parent_index(k5).to(torch.int32)
    slot = k5["slot"].to(torch.int32)
    if legacy:
        return lambda: ops.gauss_ext_term(*vt, idx, slot, *stats)
    return lambda: ops.gauss_ext_term(*vt, (idx,), (k5["tbl"].shape[0],),
                                      slot, *stats, full=(B, idx.shape[1]),
                                      route="index")


def time_k45(ops, inp: dict) -> dict:
    """{kernel: {ms, device_ms, plain_ms, library_ms}} of K4 and K5 on
    rents_inputs (ms, plain_ms, library_ms: cuda_ms; device_ms: graph_ms;
    K5 from the env coordinates to the term, one launch).
    K4's library call: k4_library, a zeroed buffer and one index_add_ of
    n, sz, szz and pre0 (checked against the plain version first); K5 has
    none."""
    k4, k5 = inp["k4"], inp["k5"]
    res = {}
    for name, fn, plain in (
            ("gauss_suffstats", lambda: ops.gauss_suffstats(**k4),
             lambda: ops.gauss_suffstats_plain(**k4)),
            ("gauss_ext_term", lambda: ops.gauss_ext_term(**k5),
             lambda: ops.gauss_ext_term_plain(**k5))):
        res[name] = dict(ms=cuda_ms(fn), device_ms=graph_ms(fn),
                         plain_ms=cuda_ms(plain), library_ms=None)
    lib = k4_library(k4)
    check_k4_library(ops, k4, lib)
    res["gauss_suffstats"]["library_ms"] = cuda_ms(lib)
    res["gauss_suffstats"]["library_device_ms"] = graph_ms(lib)
    return res


def k4_library(k4: dict):
    """K4's yardstick, a call the port never makes: one graphable PyTorch
    expression of K4's whole output, a zeroed [cap * C + cap, 3] buffer
    and one index_add_ into it of 2R rows: each referrer's (1, z, z^2) at
    its cell t * C + rv (rows 0 to cap * C - 1: n, sz, szz) and its
    const - ld at row cap * C + t (column 0 of the last cap rows: pre0).
    A referrer that is not kept (K4's mode="drop") adds weight 0 at its
    cell clamped into range: weights masked to 0, not a boolean index,
    which would sync, and spread over the cells as the kept ones are, so
    none of them queues on one cell. The index and the weighted rows are
    built once from the inputs, before the timing."""
    t, rv, z = k4["t"].long(), k4["rv"].long(), k4["z"]
    cap, C = k4["cap"], k4["C"]
    ok = k4["w"] & (t >= 0) & (t < cap)
    m = ok.to(z.dtype)
    m2 = (ok & (rv >= 0) & (rv < C)).to(z.dtype)
    slot = t.clamp(0, cap - 1)
    idx = torch.cat([slot * C + rv.clamp(0, C - 1), cap * C + slot])
    zero = torch.zeros_like(z)
    rows = torch.cat([torch.stack([m2, z * m2, z * z * m2], 1),
                      torch.stack([(k4["const"] - k4["ld"]) * m, zero, zero],
                                  1)])
    n = cap * C + cap
    return lambda: torch.zeros((n, 3), device=z.device).index_add_(
        0, idx, rows)


def check_k4_library(ops, k4: dict, lib) -> None:
    """The yardstick computes K4's function: its [cap * C + cap, 3] buffer
    read as (n, sz, szz, pre0) holds the plain version's counts exactly and
    its sums within check_k4's tolerance."""
    cap, C = k4["cap"], k4["C"]
    out = lib()
    got = (out[:cap * C, 0].reshape(cap, C), out[:cap * C, 1].reshape(cap, C),
           out[:cap * C, 2].reshape(cap, C), out[cap * C:, 0])
    want = ops.gauss_suffstats_plain(**k4)
    mag = ops.gauss_suffstats_plain(**dict(
        k4, z=k4["z"].abs(), ld=-(k4["const"] - k4["ld"]).abs(), const=0.0))
    require(torch.equal(got[0], want[0]), "K4's yardstick n differs")
    for i in (1, 2, 3):
        require(bool(((got[i] - want[i]).abs() <= 1e-5 * mag[i] + 1e-6)
                     .all()), "K4's yardstick differs from K4's function")


def k4_seeded(dev, R: int, cap: int, C: int, live: int = None,
              seed: int = 0, dead: float = 0.2) -> dict:
    """Seeded K4 inputs in the rents path's form without its model: R
    referrers into `live` of the cap slots (cap * 1,500 / 4,096 by
    default: the rents path's ~1,500 live counties of 4,096, about 33
    referrers a slot at 50,000), groups in [0, C), w set on all but `dead`
    of them, z about rents (normal 1,500, sd 700), ld log(1000) on a tenth
    (the rents in thousands) and the rents model's const."""
    rng = np.random.default_rng(seed)
    live = max(1, cap * 1500 // 4096) if live is None else live
    as_t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return dict(
        t=as_t(rng.integers(0, live, R).astype(np.int32)),
        rv=as_t(rng.integers(0, C, R).astype(np.int32)),
        w=as_t(rng.random(R) >= dead),
        z=as_t(rng.normal(1500, 700, R).astype(np.float32)),
        ld=as_t(np.where(rng.random(R) < 0.1, np.log(1000.0), 0.0)
                .astype(np.float32)),
        const=-5.9295738, cap=cap, C=C)


def k4_call_split(ops, k4: dict, n: int = 200) -> dict:
    """Where one K4 call's time goes, host side: mean host ms per call over
    n calls issued back to back (time.perf_counter, one synchronize at the
    end) of the whole wrapper, of its zeroed output buffer alone
    (torch.zeros), and of the bare ctypes launch with prepared arguments;
    `rest_ms` is the wrapper less those two (argument checks, conversions,
    views, the count)."""
    import ctypes
    import time

    cap, C, R = k4["cap"], k4["C"], k4["z"].shape[0]
    size = 3 * cap * C + cap

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - t) / n * 1e3
        torch.cuda.synchronize()
        return host

    buf = torch.zeros((size,), device=k4["z"].device)
    t32, rv32 = k4["t"].to(torch.int32), k4["rv"].to(torch.int32)
    plan = ops.gauss_suffstats_plan(R)
    fn = ops._fn("gauss_suffstats")
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    launch = lambda: fn(  # noqa: E731
        ptr(t32), ptr(rv32), ptr(k4["w"]), ptr(k4["z"]), ptr(k4["ld"]),
        float(k4["const"]), ptr(buf), ptr(buf), ptr(buf), ptr(buf), R, cap,
        C, plan["threads"], plan["grid"], stream)
    out = dict(wrapper_ms=host_ms(lambda: ops.gauss_suffstats(**k4)),
               zeros_ms=host_ms(lambda: torch.zeros((size,),
                                                    device=buf.device)),
               launch_ms=host_ms(launch))
    out["rest_ms"] = out["wrapper_ms"] - out["zeros_ms"] - out["launch_ms"]
    return out


def swap_externals(cm, cid="Flight") -> list:
    """[(field vid, node, kern)] of class cid's MaybeSwap externals whose
    val is one of cid's own choices (the flights model's four time fields
    seen from Flight), in node order."""
    from .engine.kernels import _MaybeSwapK
    from .model.ir import ExternalLikelihoodNode

    c = cm.cls(cid)
    out = []
    for node in c.nodes:
        if not isinstance(node, ExternalLikelihoodNode):
            continue
        kern = cm.kernels.get(cm.canon(node.path[-1][0], node.ext_id))
        if isinstance(kern, _MaybeSwapK):
            inv = {sv: tv for tv, sv in
                   c.incoming_references[node.path].items()}
            out.append((inv[node.ext_node.arg_ids["val"]], node, kern))
    return out


def flights_inputs(eng, arenas, params, slots=None) -> list:
    """K6's inputs at the shapes the flights path launches it at, from the
    flights model's state (`eng` an Engine of the flights model): for each
    time field, Flight slots (the first live one, as the path's one-row
    launches, or `slots`) with their referrers in the form the tracer holds
    them: the list form over Engine._ref_comp's per-slot lists where the
    model has a referrer bound (the flights path at 2,376 rows: 256), else
    the dense form over every Obs row; each slot's own atom list, and each
    referrer's gated error rate (propose.row_value of the lookup, which
    reads the referrer's own flight: the swept slot's). Returns
    [dict(field, V, k6=...)]."""
    from .engine.propose import row_value
    from .engine.refresh import refresh

    cm = eng.cm
    rel = refresh(cm, arenas, eng.obs_dev)
    if slots is None:
        slots = torch.nonzero(rel["Flight"]["alive"])[:1, 0]
    st = torch.as_tensor(slots, device=cm.device).long().reshape(-1)
    comp = eng._ref_comp("Flight", arenas, rel)
    names = {v: k for k, v in cm.cls("Flight").names.items()}
    out = []
    for fv, node, kern in swap_externals(cm):
        src, fk = node.path[-1]
        codes, state = eng.obs_dev[src][node.ext_id]
        lc = row_value(cm, arenas, params, "Flight",
                       cm.cls("Flight").nodes[fv].arg_ids["atoms"], st)
        k6 = dict(lc=lc.to(torch.int32), lens=cm.use(kern.lens)
                  .to(torch.int32), member=cm.use(kern.mask))
        if node.path in comp:
            idx, cnt = comp[node.path]
            rows = idx[st]                                       # [B, R]
            k6.update(cnt=cnt[st].to(torch.int32))
        else:
            rows = torch.arange(cm.layouts[src].capacity, device=cm.device)
            k6.update(t=arenas[src]["values"][fk].to(torch.int32),
                      alive=rel[src]["alive"], slot=st.to(torch.int32))
        p = row_value(cm, arenas, params, src,
                      node.ext_node.arg_ids["prob"], rows)
        k6.update(obs=take(codes, rows).to(torch.int32).contiguous(),
                  st=take(state, rows).to(torch.int8).contiguous(),
                  p=p.to(torch.float32).reshape(-1 if "cnt" in k6 else 1,
                                                rows.shape[-1]).contiguous())
        out.append(dict(field=names.get(fv, str(fv)), V=kern.V, k6=k6))
    return out


def k6_census_inputs(eng, arenas, params, census: list, B: int) -> list:
    """K6's inputs at every shape of a path's launch census (ops.census()
    rows of maybe_swap_ext: form and referrer axis "list,N" or "dense,N",
    r1 or rn, V), from its state: flights_inputs at _census_slots' rows of
    Flight, the time field whose vocabulary is V. Raises where no field
    has that V and form. Returns [(census row, field, inputs)]."""
    from .engine.refresh import refresh

    cm = eng.cm
    rel = refresh(cm, arenas, eng.obs_dev)
    out = []
    for r in census:
        if r["kernel"] != "maybe_swap_ext":
            continue
        form, N = r["mode"].split(",")
        slots = _census_slots(cm, rel, "Flight", r["rows"], B)
        found = [(r, f["field"], f["k6"]) for f in flights_inputs(
            eng, arenas, params, slots) if f["V"] == r["K"]
            and ("cnt" in f["k6"]) == (form == "list")
            and f["k6"]["obs"].shape[-1] == int(N)]
        require(bool(found), f"K6 census shape {r} has no MaybeSwap field "
                f"of its form and V")
        out.append(found[0])
    return out


def k6_inputs(dev, B: int, V: int, N: int, L: int = 64, seed: int = 0,
              missing: float = 0.03, shared_p: bool = False,
              lists: bool = False, per_slot: int = 0) -> dict:
    """Seeded K6 inputs with codes in [0, V), 3% missing and 1% unobserved
    states, p in (0, 0.5) with every tenth 1e-5 (the gated rate), and L
    option lists of 1 to V options (list 0 empty; lens = max(list length,
    1)). Dense form: N source rows over `per_slot`-sized groups of slots
    (0: 2 * B slots), a fifth dead, the B rows the even slots. List form
    (`lists`): each row's N entries, of which a random count in [0, N] are
    its referrers."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (B, N) if lists else (N,)
    obs = torch.randint(0, V, shape, generator=g, device=dev,
                        dtype=torch.int32)
    u = torch.rand(shape, generator=g, device=dev)
    st = torch.where(u < missing, 2, torch.where(u < missing + 0.01, 0, 1)) \
        .to(torch.int8)
    p = torch.rand((1 if shared_p else B, N), generator=g, device=dev) * 0.5
    p = torch.where((torch.arange(N, device=dev) % 10 == 0)[None, :],
                    torch.full_like(p, 1e-5), p.clamp_min(1e-6))
    member = torch.rand((L, V), generator=g, device=dev) < \
        torch.rand((L, 1), generator=g, device=dev)
    member[0] = False
    k6 = dict(obs=obs, st=st, p=p, member=member,
              lens=member.sum(1).clamp_min(1).to(torch.int32),
              lc=torch.randint(0, L, (B,), generator=g, device=dev,
                               dtype=torch.int32))
    if lists:
        k6["cnt"] = torch.randint(0, N + 1, (B,), generator=g, device=dev,
                                  dtype=torch.int32)
    else:
        slots = max(2 * B, N // per_slot) if per_slot else 2 * B
        k6.update(t=torch.randint(0, slots, (N,), generator=g, device=dev,
                                  dtype=torch.int32),
                  alive=torch.rand((N,), generator=g, device=dev) >= 0.2,
                  slot=(2 * torch.arange(B, device=dev)).to(torch.int32))
    return k6


def check_k6(ops, k6: dict) -> float:
    """Within 1e-5 of each cell's sum of |terms| (+1e-6) of the plain
    version (the same f32 terms, summed in another order). Returns the
    largest |difference|."""
    got = ops.maybe_swap_ext(**k6)
    want = ops.maybe_swap_ext_plain(**k6)
    mag = ops.maybe_swap_ext_plain(**k6, absolute=True)
    torch.cuda.synchronize()
    d = (got - want).abs()
    require(bool((d <= 1e-5 * mag + 1e-6).all()),
            f"K6 differs by {float(d.max())}")
    return float(d.max())


def k6_bytes(k6: dict) -> int:
    """K6's bytes on these inputs: each row's list code, the length and
    member-mask row of each list the rows use, out [B, V] written once;
    in list form each row's count and its first cnt entries of obs (4 B),
    st (1 B) and p (4 B); in dense form each row's slot and t, obs (4 B),
    alive, st (1 B) of every source row and p's rows."""
    B, V = k6["lc"].shape[0], k6["member"].shape[1]
    nl = int(torch.unique(k6["lc"].long().clamp(
        0, k6["member"].shape[0] - 1)).numel())
    common = B * 4 + nl * (4 + V) + B * V * 4
    if "cnt" in k6:
        n = int(k6["cnt"].clamp(0, k6["obs"].shape[1]).sum())
        return common + B * 4 + n * 9
    N = k6["obs"].shape[0]
    return common + B * 4 + N * 10 + k6["p"].numel() * 4


def time_k6(ops, k6: dict) -> dict:
    """K6 on these inputs: ms and plain_ms (cuda_ms), device_ms
    (graph_ms); no single PyTorch call computes it (library_ms None)."""
    fn = lambda: ops.maybe_swap_ext(**k6)  # noqa: E731
    return dict(ms=cuda_ms(fn), device_ms=graph_ms(fn),
                plain_ms=cuda_ms(lambda: ops.maybe_swap_ext_plain(**k6)),
                library_ms=None)


def addtypos_externals(cm, cid) -> list:
    """[(node, kern, word_sv, inv)] of class cid's AddTypos externals, in
    node order (inv maps the source class's vertices to cid's)."""
    from .engine.kernels import _AddTyposK
    from .model.ir import ChoiceNode, ExternalLikelihoodNode

    c = cm.cls(cid)
    out = []
    for node in c.nodes:
        if not (isinstance(node, ExternalLikelihoodNode)
                and isinstance(node.ext_node, ChoiceNode)):
            continue
        kern = cm.kernels.get(cm.canon(node.path[-1][0], node.ext_id))
        word = node.ext_node.arg_ids.get("word")
        if isinstance(kern, _AddTyposK) and word is not None:
            inv = {sv: tv for tv, sv in
                   c.incoming_references[node.path].items()}
            out.append((node, kern, word, inv))
    return out


def _referrers(cm, arenas, params, obs_dev, node):
    """(t, val, st) of an external's source rows: the slot each row's fk
    chain leads to, its observed-or-stored value and obs state (None where
    the column is not observed), as the tracer reads them."""
    from .engine.propose import row_value

    src = node.path[-1][0]
    hops = [arenas[c]["values"][f] for c, f in reversed(node.path)]
    slots = torch.arange(cm.layouts[src].capacity, device=cm.device)
    stored = row_value(cm, arenas, params, src, node.ext_id, slots)
    oa = obs_dev.get(src, {}).get(node.ext_id)
    if oa is None:
        return hops, stored.to(torch.int32), None
    codes, state = oa
    val = torch.where(state == 1, codes, stored.to(codes.dtype))
    return hops, val.to(torch.int32), state


def k7_hoisted_inputs(cm, arenas, params, rel, obs_dev, cid, node,
                      kern) -> dict:
    """K7's hoisted-form inputs for one external of class cid, as
    referrer_histograms launches it: every source row, w = alive and not
    missing, the fk chain's hop columns."""
    src = node.path[-1][0]
    hops, val, state = _referrers(cm, arenas, params, obs_dev, node)
    w = rel[src]["alive"]
    if state is not None:
        w = w & (state != 2)
    return dict(val=val, w=w, V=kern.V, cap=cm.layouts[cid].capacity,
                hops=hops)


def k7_rows_inputs(cm, arenas, params, rel, obs_dev, node, kern,
                   slots) -> dict:
    """K7's per-row inputs for one external at the batch rows `slots`
    (dense form, as _ext_hist_term launches it where no histogram is
    hoisted): w [B, Cs] = alive and t == slot and not missing, val [1,
    Cs]."""
    src = node.path[-1][0]
    hops, val, state = _referrers(cm, arenas, params, obs_dev, node)
    t = chase(hops)
    ok = rel[src]["alive"]
    if state is not None:
        ok = ok & (state != 2)
    w = ok[None, :] & (t[None, :] == slots.to(t.dtype)[:, None])
    return dict(val=val.reshape(1, -1), w=w, V=kern.V)


def k8_inputs(cm, arenas, params, rel, obs_dev, cid, slots) -> list:
    """K8's inputs as the sweep of class cid launches it at the rows
    `slots` (dense form: w [B, Cs] = alive and t == slot and not missing),
    one per composed AddTypos external of cid (the hospital stateavg seen
    from County or Measure): dict(SA [E, Vc, V], rv, val [1, Cs], w), with
    SA from the compile-time cache in _ext_hist_term's axis order."""
    from .engine.propose import row_value
    from .model.ir import ComputeNode

    out = []
    for node, kern, word, inv in addtypos_externals(cm, cid):
        src = node.path[-1][0]
        snode = cm.node(src, word)
        if word in inv or not (isinstance(snode, ComputeNode)
                               and snode.kind == "table"):
            continue
        env = [a for a in snode.arg_ids if a in inv]
        ref = [a for a in snode.arg_ids if a not in inv]
        order = tuple(snode.arg_ids.index(a) for a in env + ref)
        SA = cm._ext_sa_cache[("sa", cm.canon(src, word),
                               cm.canon(src, node.ext_id), order)]
        E = int(np.prod(SA.shape[:len(env)]))
        hops, val, state = _referrers(cm, arenas, params, obs_dev, node)
        t = chase(hops)
        ok = rel[src]["alive"] if state is None else \
            rel[src]["alive"] & (state != 2)
        rv = row_value(cm, arenas, params, src, ref[0],
                       torch.arange(cm.layouts[src].capacity,
                                    device=cm.device))
        out.append(dict(SA=cm.use(SA).reshape(E, -1, SA.shape[-1]),
                        rv=rv.to(torch.int32).reshape(1, -1),
                        val=val.reshape(1, -1),
                        w=ok[None, :] & (t[None, :] == slots[:, None])))
    return out


def _census_slots(cm, rel, cid, rows: str, B: int):
    """The swept rows of a launch of census class `rows`: class cid's first
    live slot ("r1", the sequential replays) or its first B slots ("rn", a
    batch, padded past the capacity as the batched sweep pads it)."""
    if rows == "r1":
        return torch.nonzero(rel[cid]["alive"])[:1, 0]
    return torch.arange(B, device=cm.device)


def k7_census_inputs(eng, arenas, params, census: list, B: int) -> list:
    """K7's inputs at every shape of a path's launch census (ops.census()
    rows of referrer_hist: form, r1 or rn, V), from its state: for each,
    the first latent class's AddTypos external whose histogram has V bins,
    hoisted over every source row, or per row (dense over every source
    row) at _census_slots' rows. Returns [(census row, class, inputs)]."""
    from .engine.refresh import refresh

    cm = eng.cm
    rel = refresh(cm, arenas, eng.obs_dev)
    by_v = {}
    for cid in cm.model.class_order:
        if cm.layouts[cid].observed:
            continue
        for node, kern, word, inv in addtypos_externals(cm, cid):
            if word in inv:
                by_v.setdefault(kern.V, (cid, node, kern))
    out = []
    for r in census:
        if r["kernel"] != "referrer_hist":
            continue
        require(r["K"] in by_v, f"K7 census shape {r} has no AddTypos "
                f"external of its V")
        cid, node, kern = by_v[r["K"]]
        if r["mode"] == "hoisted":
            k = k7_hoisted_inputs(cm, arenas, params, rel, eng.obs_dev, cid,
                                  node, kern)
        else:
            k = k7_rows_inputs(cm, arenas, params, rel, eng.obs_dev, node,
                               kern, _census_slots(cm, rel, cid, r["rows"],
                                                   B))
        out.append((r, cid, k))
    return out


def k8_census_inputs(eng, arenas, params, census: list, B: int) -> list:
    """K8's inputs at every shape of a path's launch census (ops.census()
    rows of sa_ext_term: SA's shape "ExVcxV", r1 or rn, referrer axis R),
    from its state: the composed external of the latent class whose SA has
    that shape, at _census_slots' rows. Raises where no composed external
    has the shape or its referrer axis is not R (a referrer list, which
    this does not build). Returns [(census row, class, inputs)]."""
    from .engine.refresh import refresh

    cm = eng.cm
    rel = refresh(cm, arenas, eng.obs_dev)
    out = []
    for r in census:
        if r["kernel"] != "sa_ext_term":
            continue
        found = None
        for cid in cm.model.class_order:
            if cm.layouts[cid].observed:
                continue
            slots = _census_slots(cm, rel, cid, r["rows"], B)
            for k in k8_inputs(cm, arenas, params, rel, eng.obs_dev, cid,
                               slots):
                if "x".join(map(str, k["SA"].shape)) == r["mode"] \
                        and k["w"].shape[1] == r["K"]:
                    found = (r, cid, k)
                    break
            if found:
                break
        require(found is not None, f"K8 census shape {r} has no composed "
                f"external of its shape")
        out.append(found)
    return out


def k3_seeded(dev, B: int, K: int, Vs, seed: int = 0) -> dict:
    """Seeded K3 inputs: one square f32 matrix [V, V] per vocabulary in
    `Vs` (log densities, normal about -20), obs [B, C] and word [C, K] codes
    in range."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    mats = [torch.randn((V, V), generator=g, device=dev) * 5.0 - 20.0
            for V in Vs]
    i32 = dict(device=dev, dtype=torch.int32, generator=g)
    obs = torch.stack([torch.randint(0, V, (B,), **i32) for V in Vs], 1)
    word = torch.stack([torch.randint(0, V, (K,), **i32) for V in Vs])
    return dict(mats=mats, obs=obs, word=word)


def k3_bytes(k3: dict) -> int:
    """K3's bytes (kernel_bytes' count): out [B, K] written, word [C, K],
    obs [B, C] and the M rows the batch observes read once."""
    obs, mats, word = k3["obs"], k3["mats"], k3["word"]
    B, C = obs.shape
    K = word.shape[1]
    distinct = sum(int(torch.unique(obs[:, c]).numel()) * m.shape[0]
                   for c, m in enumerate(mats))
    return B * K * 4 + C * K * 4 + B * C * 4 + distinct * 4


def time_k3(ops, k3: dict) -> dict:
    """K3 on these inputs: ms, plain_ms and library_ms (cuda_ms), device_ms
    and library_device_ms (graph_ms); the library call is the JAX
    package's one-hot contraction as one matmul, as time_kernels."""
    mats, obs, word = k3["mats"], k3["obs"], k3["word"]
    oh = torch.cat([torch.nn.functional.one_hot(obs[:, c].long(),
                                                m.shape[0]).float()
                    for c, m in enumerate(mats)], 1)
    T = torch.cat([m[:, word[c].long()] for c, m in enumerate(mats)], 0)
    fn = lambda: ops.obs_gather_sum(mats, obs, word)  # noqa: E731
    return dict(ms=cuda_ms(fn), device_ms=graph_ms(fn),
                plain_ms=cuda_ms(lambda: ops.obs_gather_sum_plain(
                    mats, obs, word)),
                library_ms=cuda_ms(lambda: oh @ T),
                library_device_ms=graph_ms(lambda: oh @ T))


def k7_seeded(dev, G: int, V: int, R: int, per_row: bool, hops: int = 1,
              rows_val: int = 1, seed: int = 0, dead: float = 0.2,
              density: float = None, skew: tuple = None) -> dict:
    """Seeded K7 inputs with some slots and values out of range. Hoisted:
    R referrers, `hops` hop columns (the first [R] into a class of 2 * G
    rows, each later one into the next class, the last into [-1, G + 2)),
    val [R] in [-1, V + 1), w set on all but `dead` of them. Per row: w [G,
    R] set with `density` (1 / G by default, as t == slot keeps), val
    [rows_val, R] in [-1, V + 1). `skew` (live, values): the counts crowd
    into few cells, as the hospital path's do (55 live hospitals of 512
    slots, a value or two each): the last hop column leads into `live` of
    the G slots and val takes `values` of the V values (no value out of
    range)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    i32 = dict(device=dev, dtype=torch.int32, generator=g)

    def pick(n, k, shape):   # `shape` entries drawn from k of range(n)
        keep = torch.randperm(n, generator=g, device=dev)[:k]
        return keep[torch.randint(0, k, shape, **i32).long()].to(
            torch.int32)

    vals = (lambda shape: pick(V, skew[1], shape)) if skew else \
        (lambda shape: torch.randint(-1, V + 1, shape, **i32))
    if per_row:
        p = 1.0 / max(G, 1) if density is None else density
        return dict(val=vals((rows_val, R)),
                    w=torch.rand((G, R), generator=g, device=dev) < p, V=V)
    lens = [R] + [2 * G] * (hops - 1)
    cols = [torch.randint(0, lens[h + 1], (lens[h],), **i32)
            for h in range(hops - 1)]
    cols.append(pick(G, skew[0], (lens[-1],)) if skew else
                torch.randint(-1, G + 2, (lens[-1],), **i32))
    return dict(val=vals((R,)),
                w=torch.rand((R,), generator=g, device=dev) >= dead, V=V,
                cap=G, hops=cols)


def k8_seeded(dev, B: int, E: int, Vc: int, V: int, R: int,
              rows_pairs: int = 1, seed: int = 0,
              density: float = None, live: int = None) -> dict:
    """Seeded K8 inputs: SA [E, Vc, V] of typo log densities (normal about
    -20, a tenth at the -1e5 the typo model gives beyond its edit limit),
    rv and val [rows_pairs, R] with some out of range, w [B, R] set with
    `density` (1 / B by default) on its first `live` rows (all by default)
    and empty on the others, as a batch whose rows past the class's live
    slots hold no referrer."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    SA = torch.randn((E, Vc, V), generator=g, device=dev) * 5.0 - 20.0
    SA = torch.where(torch.rand((E, Vc, V), generator=g, device=dev)
                     < 0.1, torch.full_like(SA, -1e5), SA)
    i32 = dict(device=dev, dtype=torch.int32, generator=g)
    p = 1.0 / max(B, 1) if density is None else density
    w = torch.rand((B, R), generator=g, device=dev) < p
    if live is not None:
        w[live:] = False
    return dict(SA=SA, rv=torch.randint(-1, Vc + 1, (rows_pairs, R), **i32),
                val=torch.randint(-1, V + 1, (rows_pairs, R), **i32), w=w)


def check_k7(ops, k7: dict) -> float:
    """Bit-equal to the plain version (integer counts, exact in f32 in any
    order of addition)."""
    got = ops.referrer_hist(**k7)
    want = ops.referrer_hist_plain(**k7)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "K7 differs from the plain version")
    return float((got - want).abs().max())


def check_k8(ops, k8: dict) -> float:
    """Within 1e-5 of each cell's sum of |terms| (+1e-6) of the plain
    version (the same terms summed in double in a fixed order, against an
    f32 histogram-times-SA product). Returns the largest |difference|."""
    got = ops.sa_ext_term(**k8)
    want = ops.sa_ext_term_plain(**k8)
    mag = ops.sa_ext_term_plain(**dict(k8, SA=k8["SA"].abs()))
    torch.cuda.synchronize()
    d = (got - want).abs()
    require(bool((d <= 1e-5 * mag + 1e-6).all()),
            f"K8 differs by {float(d.max())}")
    return float(d.max())


def k7_flat(k7: dict):
    """(cells, G * V) of the library call: the kept pairs' flat cells
    g * V + v, for torch.bincount(cells, minlength=G * V)."""
    from . import ops

    cell, ok, G = ops.referrer_hist_cells(**k7)
    return cell[ok], G * k7["V"]


def k7_bytes(k7: dict) -> int:
    """K7's bytes: hoisted, w (1 B), val and each hop column's entries (4
    B) of every referrer read once; per row, w [B, R] (1 B) and val's rows
    (4 B); [G, V] written once."""
    V = k7["V"]
    if k7.get("hops") is not None:
        R = k7["w"].shape[0]
        return R * 5 + sum(int(h.shape[0]) for h in k7["hops"]) * 4 \
            + k7["cap"] * V * 4
    B, R = k7["w"].shape
    return B * R + k7["val"].numel() * 4 + B * V * 4


def k8_bytes(k8: dict) -> int:
    """K8's bytes on these inputs: w [B, R] (1 B), rv and val (4 B each)
    read once, the SA entries the kept referrers touch (each distinct (rv,
    val) pair's E floats) and out [B, E] written once."""
    SA, w = k8["SA"], k8["w"]
    E, Vc, V = SA.shape
    B, R = w.shape
    rv, val = k8["rv"].long(), k8["val"].long()
    kept = w.any(0, keepdim=True) if rv.shape[0] == 1 else w
    ok = kept & (rv >= 0) & (rv < Vc) & (val >= 0) & (val < V)
    pairs = int(torch.unique((rv * V + val)[ok]).numel())
    return B * R + 2 * k8["rv"].numel() * 4 + pairs * E * 4 + B * E * 4


def time_k7(ops, k7: dict) -> dict:
    """K7 on these inputs: ms, plain_ms and library_ms (cuda_ms) and
    device_ms (graph_ms). The library call is one torch.bincount of the
    kept pairs' flat cells (masked before the call) with minlength G * V;
    it reads its input's maximum back to the host, so no CUDA graph can
    hold it and only its events time (`ms`'s timer) is taken."""
    fn = lambda: ops.referrer_hist(**k7)  # noqa: E731
    cells, n = k7_flat(k7)
    lib = lambda: torch.bincount(cells, minlength=n)  # noqa: E731
    return dict(ms=cuda_ms(fn), device_ms=graph_ms(fn),
                plain_ms=cuda_ms(lambda: ops.referrer_hist_plain(**k7)),
                library_ms=cuda_ms(lib), library_device_ms=None)


def time_k8(ops, k8: dict) -> dict:
    """K8 on these inputs: ms and plain_ms (cuda_ms), device_ms (graph_ms);
    no single PyTorch call computes it (library_ms None)."""
    fn = lambda: ops.sa_ext_term(**k8)  # noqa: E731
    return dict(ms=cuda_ms(fn), device_ms=graph_ms(fn),
                plain_ms=cuda_ms(lambda: ops.sa_ext_term_plain(**k8)),
                library_ms=None, library_device_ms=None)


# K9: how close to a CDF boundary (as a share of the row's total) a pick
# that differs from the plain version's may lie, the share of picks that
# may differ, and how close to P / 2 an ESS may lie whose decision differs
K9_BOUNDARY = 1e-4
K9_MAX_MISMATCH = 1e-2
K9_ESS_EDGE = 1e-6


def k9_inputs(dev, R: int, P: int, mode: str, retained: bool = False,
              seed: int = 0) -> dict:
    """Seeded K9 inputs: R rows of P log weights around -30, every other
    row spread (sd 6: ESS < P / 2, the row resamples) and the others flat
    (sd 0.05: it keeps its particles), and the mode's uniforms."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    sd = torch.where(torch.arange(R, device=dev) % 2 == 0, 6.0, 0.05)
    ws = torch.randn((R, P), generator=g, device=dev) * sd[:, None] - 30.0
    shape = (R,) if mode == "final" else (R, P)
    return dict(ws=ws, u=torch.rand(shape, generator=g, device=dev),
                mode=mode, retained=retained)


def k9_census_inputs(dev, census: list, B: int) -> list:
    """[(census row, inputs)] for every shape of a path's K9 launch census
    (its mode, P and one row or B rows), on seeded inputs (k9_inputs;
    resample shapes with the retained particle)."""
    return [(r, k9_inputs(dev, B if r["rows"] == "rn" else 1, r["K"],
                          r["mode"], retained=r["mode"] == "resample"))
            for r in census if r["kernel"] == "pg_resample"]


def check_k9(ops, k9: dict) -> dict:
    """K9 against its plain version on the same inputs. Rows whose ESS lies
    within K9_ESS_EDGE * P of P / 2 (f64 ESS of the weights) may decide
    either way and are left out; on the others the decision is equal,
    ws_out and lml lie within 1e-6 of max(1, |logsumexp|) of the plain
    version's, and the picks (sel, j) are equal except on at most
    K9_MAX_MISMATCH of them (where there are 100 or more), each with its
    threshold within K9_BOUNDARY of a CDF boundary (the kernel's exact
    fixed-point prefix sums against torch.cumsum's f32 ones). Returns
    dict(max_abs_err, mismatch_rate, edge_rows)."""
    ws, u, mode, retained = k9["ws"], k9["u"], k9["mode"], k9["retained"]
    got = ops.pg_resample(ws, u, mode, retained)
    want = ops.pg_resample_plain(ws, u, mode, retained)
    torch.cuda.synchronize()
    R, P = ws.shape
    w64 = ws.double()
    lse = torch.logsumexp(w64, -1)
    ess = torch.exp(2 * lse - torch.logsumexp(2 * w64, -1))
    keep = (ess - P / 2.0).abs() > K9_ESS_EDGE * P
    tol = 1e-6 * lse.abs().clamp(min=1.0)
    d_lml = (got[-1] - want[-1]).double().abs()
    require(bool((d_lml <= tol)[keep].all()),
            f"K9 {mode} lml differs by {float(d_lml[keep].max())}")
    err = float(d_lml[keep].max()) if bool(keep.any()) else 0.0
    c = torch.cumsum(torch.exp(w64 - w64.amax(-1, keepdim=True)), -1)
    if mode == "final":
        pick_g, pick_w = got[0][:, None], want[0][:, None]
        ub = ((1.0 - u.double()) * c[:, -1])[:, None]
        on = keep[:, None]
    else:
        d_w = (got[1] - want[1]).double().abs()
        require(bool((d_w <= tol[:, None])[keep].all()),
                f"K9 ws_out differs by {float(d_w[keep].max())}")
        err = max(err, float(d_w[keep].max()) if bool(keep.any()) else 0.0)
        pick_g, pick_w = got[0], want[0]
        ub = (1.0 - u.double()) * c[:, -1:]
        resampled = want[1] == 0
        on = keep[:, None] & resampled
        # rows that keep their particles pick themselves, bit for bit
        require(bool((pick_g == pick_w)[keep[:, None] & ~resampled].all()),
                "K9: a row that keeps its particles moved one")
        if retained:
            require(bool((got[0][:, 0] == torch.arange(R, device=ws.device)
                          * P).all()), "K9: the retained particle moved")
    gap = (c[:, None, :] - ub[:, :, None]).abs().amin(-1) / c[:, -1:]
    diff = (pick_g != pick_w) & on
    n = int(on.sum())
    rate = int(diff.sum()) / max(1, n)
    require(bool((gap[diff] <= K9_BOUNDARY).all()),
            "K9 picks differ away from a CDF boundary")
    require(n < 100 or rate <= K9_MAX_MISMATCH,
            f"K9 picks differ on {rate:.3g} of draws")
    return dict(max_abs_err=err, mismatch_rate=rate,
                edge_rows=int((~keep).sum()))


def k9_bytes(R: int, P: int, mode: str) -> int:
    """K9's bytes: resample reads ws and u and writes sel (int64) and
    ws_out, 20 bytes a particle, and lml, 4 a row; final reads ws, 4 bytes
    a particle, and u, and writes j (int64) and lml, 16 bytes a row."""
    return R * P * 20 + R * 4 if mode == "resample" else R * P * 4 + R * 16


def time_k9(ops, k9: dict) -> dict:
    """K9 on these inputs: ms and plain_ms (cuda_ms), device_ms
    (graph_ms); no single PyTorch call computes it (library_ms None)."""
    args = (k9["ws"], k9["u"], k9["mode"], k9["retained"])
    fn = lambda: ops.pg_resample(*args)  # noqa: E731
    return dict(ms=cuda_ms(fn), device_ms=graph_ms(fn),
                plain_ms=cuda_ms(lambda: ops.pg_resample_plain(*args)),
                library_ms=None, library_device_ms=None)


def k9_launch(ops, k9: dict, plan: dict):
    """k9's inputs in one K9 launch of `plan` (pg_resample_plan's dict,
    its words set by hand: group 0 with 12 P bytes of shared memory takes
    the block path at any P), not counted (the card tests' group against
    block path). Returns (sel or j, ws_out or None, lml)."""
    ws, u, mode, retained = k9["ws"], k9["u"], k9["mode"], k9["retained"]
    R, P = ws.shape
    final = mode == "final"
    idx = torch.empty((R,) if final else (R, P), dtype=torch.int64,
                      device=ws.device)
    ws_out = None if final else torch.empty_like(ws)
    lml = torch.empty((R,), dtype=torch.float32, device=ws.device)
    ops._check(ops._fn("pg_resample")(
        ops._ptr(ws), ops._ptr(u), ops._ptr(idx), ops._ptr(ws_out),
        ops._ptr(lml), R, P, int(final), int(bool(retained)),
        plan["threads"], plan["smem"], plan.get("group", 0),
        ops._stream(ws)), "pg_resample")
    return idx, ws_out, lml


def k9_chain(sass: dict, P: int, mode: str) -> int:
    """The instructions of the longest dependent chain one K9 row needs
    (LATENCY_GLUE above): the max's levels (a shuffle and a max each) and
    exp, then the longest of the branches that run side by side after
    it: s1's levels (a shuffle and an add) and log (lse); the q scan's
    levels (two shuffles and a 64-bit add, K9_SCAN_LEVEL) and one pick
    (a compare a level and a count); in resample mode s2's levels and the
    ESS test (a multiply, a division and a compare), log2 P levels each;
    K9_GLUE for the adds and selects around them."""
    lv = max(0, int(P) - 1).bit_length()
    lse = 2 * lv + sass["logf"]
    pick = K9_SCAN_LEVEL * lv + lv + 2
    ess = 2 * lv + 2 + sass["fdiv"] if mode == "resample" else 0
    return 2 * lv + sass["expf"] + max(lse, pick, ess) + K9_GLUE


def kernel_bytes(inp: dict) -> dict:
    """Bytes each kernel must move on these inputs (each input read once,
    each output written once; for K3 only the M rows the batch observes)."""
    B, K = inp["B"], inp["K"]
    obs, mats = inp["obs"], inp["mats"]
    distinct = sum(int(torch.unique(obs[:, c]).numel()) * m.shape[0]
                   for c, m in enumerate(mats))
    C = len(mats)
    return {"enum_logsumexp": k1_bytes(B, K, "fk"),
            "inv_cdf_sample": k2_bytes(B, K + 1),
            "obs_gather_sum": B * K * 4 + C * K * 4 + B * C * 4
            + distinct * 4}


def time_kernels(ops, inp: dict, plain: bool = True,
                 library: bool = True) -> dict:
    """{kernel: {ms, device_ms, plain_ms, library_ms}} on these inputs.
    ms, plain_ms and library_ms are CUDA events around one call (cuda_ms);
    device_ms is the kernel's device time (graph_ms). Library calls:
    torch.logsumexp for K1, none for K2, and for K3 the JAX package's
    one-hot contraction as one matmul (a yardstick the port never calls)."""
    exist, new, lg, u = inp["exist"], inp["new"], inp["logits"], inp["u"]
    mats, obs, word = inp["mats"], inp["obs"], inp["word"]
    timer = cuda_ms
    calls = {
        "enum_logsumexp": lambda: ops.enum_logsumexp(exist, new),
        "inv_cdf_sample": lambda: ops.inv_cdf_sample(lg, u),
        "obs_gather_sum": lambda: ops.obs_gather_sum(mats, obs, word),
    }
    res = {k: dict(ms=timer(fn), device_ms=graph_ms(fn))
           for k, fn in calls.items()}
    if plain:
        res["enum_logsumexp"]["plain_ms"] = timer(
            lambda: ops.enum_logsumexp_plain(exist, new))
        res["inv_cdf_sample"]["plain_ms"] = timer(
            lambda: ops.inv_cdf_sample_plain(lg, u))
        res["obs_gather_sum"]["plain_ms"] = timer(
            lambda: ops.obs_gather_sum_plain(mats, obs, word))
    if library:
        oh = torch.cat([torch.nn.functional.one_hot(obs[:, c].long(),
                                                    m.shape[0]).float()
                        for c, m in enumerate(mats)], 1)
        T = torch.cat([m[:, word[c].long()] for c, m in enumerate(mats)], 0)
        res["enum_logsumexp"]["library_ms"] = timer(
            lambda: torch.logsumexp(lg, dim=1))
        res["inv_cdf_sample"]["library_ms"] = None
        res["obs_gather_sum"]["library_ms"] = timer(lambda: oh @ T)
        res["obs_gather_sum"]["library_device_ms"] = graph_ms(lambda: oh @ T)
        del oh, T
    return res


# ------------------------------------------------------------- K10, K11
#
# K10 (the one-row relational delta) and K11 (the one-row write) are
# checked in a shadow run on each path's final state: the kernels on one
# copy of the loop's carry, the plain versions on a CPU copy, over rows of
# every class kind the path swept, bit for bit (`shadow_rows`); and timed
# at every shape of the path's census (`time_k10`, `time_k11`) beside
# their bytes bound and their dependent-load bound: the chain of dependent
# loads a call makes (`k10_dep_loads`, `k11_dep_loads`, counted from the
# plan) times the latency of one load that hits L2 (`l2_latency_ms`, K10's
# probe). No single PyTorch call computes either.

SHADOW_ROWS = 256


def row_state(cm, seed: int = 0, oob: float = 0.05, device="cuda"):
    """A seeded arena state of cm's model (numpy, then torch on `device`):
    every fk column uniform over its target's slots with a share `oob` of
    out-of-range values (the target's capacity), other int columns in
    [0, 4), float columns in [0, 1), alive bits with probability 0.8."""
    rng = np.random.default_rng(seed)
    out = {}
    for cid in cm.model.class_order:
        lay = cm.layouts[cid]
        cap = lay.capacity
        vals = {}
        for vid, dt in lay.store.items():
            if vid in lay.fk_vertices:
                tcap = cm.layouts[cm.node(cid, vid).target_class].capacity
                v = rng.integers(0, tcap, cap)
                v[rng.random(cap) < oob] = tcap
            elif dt == "i":
                v = rng.integers(0, 4, cap)
            else:
                v = rng.random(cap)
            vals[vid] = torch.as_tensor(
                v.astype(np.int32 if dt == "i" else np.float32),
                device=device)
        out[cid] = {"values": vals, "alive": torch.as_tensor(
            rng.random(cap) < 0.8, device=device)}
    return out


def _tree_map(x, fn):
    if isinstance(x, dict):
        return {k: _tree_map(v, fn) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):   # ops.Level
        return type(x)(*(_tree_map(v, fn) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(v, fn) for v in x)
    return fn(x) if torch.is_tensor(x) else x


def _births_to(births, dev):
    from .engine.propose import Birth
    return [Birth(b.fk_vid, b.target_class, b.is_new.to(dev),
                  b.slot.to(dev), {k: v.to(dev) for k, v in b.values.items()},
                  depth=b.depth) for b in births]


def row_kinds(census: list) -> list:
    """The (class, kind) pairs a path's K10 and K11 census shows it swept:
    "init" (K11 marking alive, then K10 +1: the ramp and init replays) for
    every observed class K10 added rows of, "obs" (K10 -1, K11, K10 +1)
    where it also removed them, "latent" (K10 -1 saving the fks, K11,
    K10 +1 with the hop entries where it had them) for every latent class
    K10 removed rows of, "leaf" (K11 alone) for a class only K11 wrote."""
    modes: dict = {}
    for r in census:
        if r["kernel"] == "row_delta":
            parts = r["mode"].split(" ")
            modes.setdefault(parts[0], set()).add((parts[1], parts[-1]))
        elif r["kernel"] == "row_write":
            modes.setdefault(r["mode"], set())
    out = []
    for cid, ms in modes.items():
        if ("obs", "+1") in ms:
            out.append((cid, "init"))
        if ("obs", "-1") in ms:
            out.append((cid, "obs"))
        if ("latent", "-1") in ms:
            out.append((cid, "latent"))
        if not ms:
            out.append((cid, "leaf"))
    return out


def row_cases(eng, arenas, params, rel, cid, n: int, seed: int = 0):
    """n rows of class cid in the form the loops give K10 and K11: one
    real proposal (Engine._propose of one live slot) fixes env2's vertices
    and dtypes and the births' classes and vertices; each row gets a slot
    (live slots first, then dead ones), env2 values drawn from its
    columns' own values, births at seeded slots of their class (one in
    twenty -1), seeded is_new and accept bits. Returns [(slot [1], env2,
    births, accept [1])] on the card."""
    from .engine.propose import Birth

    cm, dev = eng.cm, eng.cm.device
    rng = np.random.default_rng(seed)
    cap = cm.layouts[cid].capacity
    alive = (arenas[cid]["alive"] if cm.layouts[cid].observed
             else rel[cid]["alive"]).cpu().numpy()
    order = np.concatenate([np.flatnonzero(alive), np.flatnonzero(~alive)])
    slots = order[np.arange(n) % len(order)]
    hists = None if cm.layouts[cid].observed else \
        eng._ext_hists(cid, arenas, params, rel)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = torch.as_tensor(slots[:1], device=dev)
    env2, births, _w = eng._propose(cid, arenas, rel, params, st, gen, False,
                                    ext_hists=hists,
                                    ref_comp=eng._ref_comp(cid, arenas, rel))

    def draw(col, like):
        c = col.cpu().numpy()
        return torch.as_tensor(c[rng.integers(0, len(c), 1)],
                               device=dev).to(like.dtype)

    out = []
    for s in slots:
        e = {v: draw(arenas[cid]["values"][v], x) if v in
             arenas[cid]["values"] else x for v, x in env2.items()}
        bs = []
        for b in births:
            tc = b.target_class
            bcap = cm.layouts[tc].capacity
            bslot = -1 if rng.random() < 0.05 else int(rng.integers(0, bcap))
            bs.append(Birth(
                b.fk_vid, tc, torch.as_tensor([rng.random() < 0.5],
                                              device=dev),
                torch.as_tensor([bslot], device=dev).to(b.slot.dtype),
                {tv: draw(arenas[tc]["values"][tv], v)
                 if tv in arenas[tc]["values"] else v
                 for tv, v in b.values.items()}, depth=b.depth))
        out.append((torch.as_tensor([int(s)], device=dev), e, bs,
                    torch.as_tensor([rng.random() < 0.8], device=dev)))
    return out


def shadow_rows(ops, eng, arenas, params, cid, kind: str,
                n: int = SHADOW_ROWS, seed: int = 0) -> dict:
    """K10 and K11 on one copy of class cid's carry (smc.own_carry) over n
    rows (row_cases) in the loop order of `kind` (row_kinds), under
    torch.cuda.set_sync_debug_mode("error") (a call that makes the host
    wait for the card raises), the plain versions on a CPU copy of the
    same carry, then every leaf of the two compared bit for bit. Returns
    dict(class, kind, rows, launches, mismatches: the leaves that
    differ)."""
    from .engine.refresh import hop_histograms, refresh
    from .engine.smc import own_carry

    cm = eng.cm
    rel = refresh(cm, arenas, eng.obs_dev)
    cases = row_cases(eng, arenas, params, rel, cid, n, seed)
    hops = hop_histograms(cm, cid, arenas, eng.obs_dev) \
        if kind == "latent" else []
    n_fk = len(cm.layouts[cid].fk_vertices)
    a_dev, r_dev = own_carry(cm, cid, arenas, rel)
    cpu = lambda t: t.cpu()  # noqa: E731
    a_cpu, r_cpu = _tree_map(a_dev, cpu), _tree_map(r_dev, cpu)
    car_dev = ops.RowCarry(cm, cid, a_dev, r_dev, eng.obs_dev, hops)
    car_cpu = ops.RowCarry(cm, cid, a_cpu, r_cpu, _tree_map(eng.obs_dev, cpu),
                           _tree_map(hops, cpu))
    mode = "obs" if cm.layouts[cid].observed else "latent"
    fk_dev = torch.zeros((max(n_fk, 1),), dtype=torch.int64,
                         device=cm.device)
    fk_cpu = fk_dev.cpu()
    cases_cpu = [(s.cpu(), _tree_map(env2, cpu), _births_to(births, "cpu"),
                  acc.cpu()) for s, env2, births, acc in cases]
    before = ops.LAUNCHES["row_delta"] + ops.LAUNCHES["row_write"]
    torch.cuda.synchronize()
    # the kernels' calls may not wait for the card (CPU ops never do)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for case, case_cpu in zip(cases, cases_cpu):
            for (s, e, b, acc), (car, fk) in ((case, (car_dev, fk_dev)),
                                              (case_cpu, (car_cpu, fk_cpu))):
                if kind in ("obs", "latent"):
                    ops.row_delta(car, s, -1, mode,
                                  save_fk=fk if kind == "latent" else None)
                if kind == "init":
                    ops.row_write(car, s, e, b, mark_alive=True)
                else:
                    ops.row_write(car, s, e, b, acc)
                if kind != "leaf":
                    ops.row_delta(car, s, +1, mode, old_fk=fk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = ops.LAUNCHES["row_delta"] + ops.LAUNCHES["row_write"] - before
    bad = []
    for name, x, y in _leaves(a_dev, a_cpu, "arenas") + \
            _leaves(r_dev, r_cpu, "rel"):
        if not torch.equal(x.cpu(), y):
            bad.append(name)
    return dict(cls=cid, kind=kind, rows=n, launches=launches,
                hop_entries=len(hops), mismatches=bad)


def _leaves(x, y, path):
    if isinstance(x, dict):
        return [leaf for k in x for leaf in _leaves(x[k], y[k],
                                                     f"{path}.{k}")]
    if isinstance(x, (list, tuple)):
        return [leaf for i, (u, v) in enumerate(zip(x, y))
                for leaf in _leaves(u, v, f"{path}[{i}]")]
    return [(path, x, y)] if torch.is_tensor(x) else []


def l2_latency_ms() -> float:
    """Device ms of one dependent load that hits L2: K10's probe (one
    thread following a random cycle through 2^20 int32 in L2) at 257
    steps less at 1, over 256 (graph_ms)."""
    from . import ops

    ops.build_kernels()
    n = 1 << 20
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    nxt = torch.empty(n, dtype=torch.int32)
    nxt[perm] = perm.roll(-1).to(torch.int32)
    nxt, out = nxt.cuda(), torch.zeros(1, dtype=torch.int32, device="cuda")
    probe = ops._libs["chase_probe"]

    def run(k):
        return lambda: ops._check(probe(ops._ptr(nxt), k, ops._ptr(out),
                                        ops._stream(nxt)), "chase_probe")

    return (graph_ms(run(257)) - graph_ms(run(1))) / 256


def k10_dep_loads(plan: dict) -> int:
    """The rounds of dependent loads one K10 call needs at least, counted
    from what the function needs, not from the order the kernel loads in:
    the slot; then the fk tree, one round a level (a node's fk value needs
    only its parent's t); then one round of refcount and alive loads (they
    need only t; a parent's flip, and an earlier node's update of the same
    index, reach a node as arithmetic). The chains of one (target class,
    vertex), whose later updates must see the earlier ones' stores: a
    propagated chain the slot, the longest chain's hops, its count and
    code, and one round for each later chain; a hop entry the slot, its
    first fk column (the saved old fk beside it), the longest suffix's
    hops, its old and new targets' counts and codes at once, and one round
    for each later entry."""
    tree = 2 + max((nd["depth"] for nd in plan["nodes"]), default=-1)
    groups: dict = {}
    for e in plan["props"]:
        groups.setdefault(e["target"], []).append(e)
    chains = []
    for g in groups.values():
        if "chain" in g[0]:
            chains.append(1 + max(len(e["chain"]) for e in g) + 1
                          + len(g) - 1)
        else:
            chains.append(2 + max(len(e["suffix"]) for e in g) + 1
                          + len(g) - 1)
    return max([tree] + chains)


def k10_schedule_rounds(plan: dict) -> int:
    """The rounds of dependent loads K10's schedule makes
    (csrc/row_delta.cu), reported beside k10_dep_loads: the tree's as
    there; a chain lane's the slot, then each of its entries in turn (an
    entry's reads wait for the stores of the one before): a propagated
    chain its hops (its state and codes beside the first) and its count
    and code, a hop entry its first fk column (the histograms and the
    saved old fk beside it), the suffix's hops and its old and new
    targets' counts and codes at once."""
    tree = 2 + max((nd["depth"] for nd in plan["nodes"]), default=-1)
    lanes: dict = {}
    for e in plan["props"]:
        hops = len(e["chain"]) if "chain" in e else len(e["suffix"]) + 1
        lanes[e["lane"]] = lanes.get(e["lane"], 1) + max(hops, 1) + 1
    return max([tree] + list(lanes.values()))


# K19's and K11's plans pass by value; what a parameter block's size costs
# a launch (step 0 of the parameter blocks' sizes): the probe's sizes in
# bytes (csrc/row_delta.cu pclean_param_probe; 8 is one word)
PARAM_PROBE_BYTES = (8, 64, 512, 1024, 2048, 4096, 4128, 8192, 11840, 32000)


# the lines a read of the probe's mode 1-3 touches
PARAM_PROBE_LINES = (1, 2, 4, 8, 16, 32)


def param_block_ms() -> dict:
    """Device ms of one launch of a one-warp kernel with a
    __grid_constant__ parameter block (graph_ms; csrc/row_delta.cu
    pclean_param_probe): {"floor": the launch floor (one add_ on one
    element) in the same run, "size": {bytes: ms reading one word, at
    each size of PARAM_PROBE_BYTES}, "lines": {n: {"independent",
    "divergent", "dependent": ms}}, n of PARAM_PROBE_LINES 64-byte lines
    of a 4,096-byte block read by one lane one after another, by n lanes
    in one instruction, or by one lane each read's address the one
    before's value}."""
    from . import ops

    ops.build_kernels()
    probe = ops._libs["param_probe"]
    out = torch.zeros(32, dtype=torch.int64, device="cuda")

    def run(nbytes, mode, n):
        return lambda: ops._check(probe(nbytes, mode, n, ops._ptr(out),
                                        ops._stream(out)), "param_probe")

    res = {"floor": launch_floor_ms(),
           "size": {n: graph_ms(run(n, 0, 1)) for n in PARAM_PROBE_BYTES}}
    res["lines"] = {n: {way: graph_ms(run(4096, mode, n)) for mode, way in
                        ((1, "independent"), (2, "divergent"),
                         (3, "dependent"))}
                    for n in PARAM_PROBE_LINES}
    return res


def param_block_lines(res: dict) -> str:
    """param_block_ms's table as lines of text."""
    return "\n".join(
        [f"parameter block, one word read (bytes: device ms; floor, one "
         f"add_: {res['floor']:.5f}): " + ", ".join(
             f"{n}: {v:.5f}" for n, v in res["size"].items())]
        + [f"parameter block, {n} lines read: " + ", ".join(
            f"{way} {v:.5f}" for way, v in ways.items())
           for n, ways in res["lines"].items()])


def k10_bytes(plan: dict) -> int:
    """K10's bytes: one element of every leaf its plan names read once
    (slot, alive bit, fk values, obs codes and states, hop histograms),
    and the leaves it updates written once (each node's refcount, alive,
    total and nrows; each chain's count and code, a hop entry's at its old
    and its new target)."""
    size = {"alive": 1, "refcount": 4, "total": 8, "nrows": 8}
    n = 8 + 1
    for nd in plan["nodes"]:
        n += 4 + 2 * sum(size.values())
    for e in plan["props"]:
        hops = e.get("chain", e.get("suffix", ()))
        n += 4 * len(hops) * (1 if "chain" in e else 2) + 2 * 4
        n += (1 + 4) if "chain" in e else (4 + 4 + 4 + 8)
        n += 2 * 2 * 4 * (1 if "chain" in e else 2)
    return n


def k11_dep_loads(writes: list) -> int:
    """The rounds of dependent loads one K11 call needs at least: every
    write's slot, masks and value are read side by side, then stored (the
    writes into one column apply in order, stores that need no load)."""
    return 1 if writes else 0


def k11_schedule_rounds(writes: list) -> int:
    """The rounds of dependent loads K11's launches make
    (csrc/row_write.cu), reported beside k11_dep_loads: one a launch
    (every group's slot and masks and every write's value side by side),
    the launches one after another (ops.row_write_chunks)."""
    from . import ops

    return len(ops.row_write_chunks(len(writes))) if writes else 0


def k11_bytes(writes: list) -> int:
    """K11's bytes: each write's slot, masks and value read once and its
    element written once."""
    n = 0
    for dst, src, s, ma, mb in writes:
        n += dst.element_size() + s.element_size()
        n += sum(t.element_size() for t in (src, ma, mb) if t is not None)
    return n


def time_k10(ops, eng, arenas, params, census: list, floor: float,
             lat: float) -> list:
    """K10 at every shape of a path's census (class, mode, sign), on a
    copy of the carry of the path's state at its first live slot: ms and
    plain_ms (cuda_ms; the plain version on the card's tensors), device_ms
    (graph_ms: the call has no sync, so it can be captured), the bytes
    bound, the dependent loads and their bound, the launch floor."""
    from .engine.refresh import hop_histograms, refresh
    from .engine.smc import own_carry

    cm = eng.cm
    out = []
    rel0 = refresh(cm, arenas, eng.obs_dev)
    for r in census:
        if r["kernel"] != "row_delta":
            continue
        parts = r["mode"].split(" ")
        cid, sign, mode = parts[0], int(parts[-1]), parts[1]
        hop = "hop" in parts
        a, rel = own_carry(cm, cid, arenas, rel0)
        alive = (a[cid]["alive"] if mode == "obs" else rel[cid]["alive"])
        s = torch.nonzero(alive)[:1].reshape(1)
        hops = hop_histograms(cm, cid, arenas, eng.obs_dev) if hop else None
        fk = torch.zeros((max(1, len(cm.layouts[cid].fk_vertices)),),
                         dtype=torch.int64, device=cm.device)
        save = fk if mode == "latent" and sign < 0 else None
        args = (ops.RowCarry(cm, cid, a, rel, eng.obs_dev, hops), s, sign,
                mode, save, fk if hop else None)
        fn = lambda: ops.row_delta(*args)  # noqa: E731
        plan = ops.row_delta_plan(cm, cid, mode, hop)
        nbytes, dep = k10_bytes(plan), k10_dep_loads(plan)
        rounds = k10_schedule_rounds(plan)
        out.append(dict(
            shape=r["mode"], K=r["K"], launches=r["launches"],
            ms=cuda_ms(fn), device_ms=graph_ms(fn),
            plain_ms=cuda_ms(lambda: ops.row_delta_plain(*args)),
            library_ms=None, library_device_ms=None, bytes=nbytes,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, dep_loads=dep,
            dep_bound_ms=dep * lat, floor_ms=floor,
            schedule_rounds=rounds, nodes=len(plan["nodes"]),
            chains=len(plan["props"])))
        x = out[-1]
        print(f"row_delta {x['shape']} ({x['launches']} launches): kernel "
              f"{x['ms']:.4f} ms (device {x['device_ms']:.4f} ms) plain "
              f"{x['plain_ms']:.4f} ms bound {x['bound_ms']:.7f} ms "
              f"(bytes), {dep} dependent loads {x['dep_bound_ms']:.4f} ms "
              f"({rounds} in the kernel's schedule), floor {floor:.4f} ms",
              flush=True)
    return out


def time_k11(ops, eng, arenas, params, census: list, floor: float,
             lat: float) -> list:
    """K11 at every shape of a path's census (class, births), on one
    synthetic row of that class (row_cases) and a copy of the arenas:
    as time_k10."""
    from .engine.refresh import refresh
    from .engine.smc import own_carry

    cm = eng.cm
    out = []
    rel = refresh(cm, arenas, eng.obs_dev)
    for r in census:
        if r["kernel"] != "row_write":
            continue
        cid = r["mode"]
        s, env2, births, acc = row_cases(eng, arenas, params, rel, cid, 1)[0]
        a, _r = own_carry(cm, cid, arenas)
        car = ops.RowCarry(cm, cid, a)
        args = (car, s, env2, births, acc)
        fn = lambda: ops.row_write(*args)  # noqa: E731
        writes = ops.row_write_writes(car, s, env2, births, acc, False)
        nbytes, dep = k11_bytes(writes), k11_dep_loads(writes)
        rounds = k11_schedule_rounds(writes)
        out.append(dict(
            shape=f"{cid} births {len(births)}", K=r["K"],
            launches=r["launches"], ms=cuda_ms(fn), device_ms=graph_ms(fn),
            host_us=host_us(fn, 500),
            plain_ms=cuda_ms(lambda: ops.row_write_plain(*args)),
            library_ms=None, library_device_ms=None, bytes=nbytes,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, dep_loads=dep,
            dep_bound_ms=dep * lat, floor_ms=floor, writes=len(writes),
            schedule_rounds=rounds))
        x = out[-1]
        print(f"row_write {x['shape']} ({x['launches']} launches, "
              f"{len(writes)} writes): kernel {x['ms']:.4f} ms (device "
              f"{x['device_ms']:.4f} ms, host {x['host_us']:.1f} us a call) "
              f"plain {x['plain_ms']:.4f} ms bound {x['bound_ms']:.7f} ms "
              f"(bytes), {dep} dependent loads {x['dep_bound_ms']:.4f} ms "
              f"({rounds} in the kernel's launches), floor {floor:.4f} ms",
              flush=True)
    return out


def score_census(census: list, kernel: str) -> list:
    """K12's or K13's census rows (kernel "fk_score" or "choice_score"),
    each with its enumeration rows R (from the mode "class R ...") and
    its mode without the class (`shape`: R and the child levels' shapes
    and kinds)."""
    return [dict(r, R=int(r["mode"].split(" ")[1]),
                 shape=r["mode"].split(" ", 1)[1]) for r in census
            if r["kernel"] == kernel]


def _bench_level(dev, f: dict, seed: int):
    """A seeded child level from its census fields (k20_inputs)."""
    from . import ops

    prog, operands, rank = k20_inputs(dev, f, seed)["args"]
    return ops.Level(prog, operands, rank, "bench")


def k12_inputs(dev, R: int, K: int, seed: int = 0, fields=None) -> dict:
    """Seeded K12 inputs of R enumeration rows and K slots: refcounts 0-5
    with a fifth of the slots dead, total and nrows int64 as refresh keeps
    them, strength and discount device scalars; the children: with a
    census shape's `fields` (ops.CENSUS_FIELDS) its two levels rebuilt
    seeded (_bench_level: its program, operand kinds, shapes and dtypes)
    over its rows `full`, else tensors ch_e [1, R, K] (a tenth NEG_INF)
    and ch_n [1, R] (R = 1: [1, K] and [1])."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    full = tuple(fields["full"]) if fields else ((1,) if R == 1 else (1, R))
    refc = torch.randint(0, 6, (K,), generator=g, device=dev,
                         dtype=torch.int32)
    alive = torch.rand((K,), generator=g, device=dev) >= 0.2
    if fields:
        ch = _bench_level(dev, fields["level_e"], seed + 1)
        nch = _bench_level(dev, fields["level_n"], seed + 2)
    else:
        ch = torch.randn(full + (K,), generator=g, device=dev) * 2.0
        ch = torch.where(torch.rand(full + (K,), generator=g, device=dev)
                         < 0.1, torch.full_like(ch, -1e30), ch)
        nch = torch.randn(full, generator=g, device=dev)
    return dict(args=(refc, alive, (refc * alive).sum(), alive.sum(),
                      torch.full((), 1.5, device=dev),
                      torch.full((), 0.25, device=dev), ch, nch, full),
                R=R, K=K)


# K13's further checks at a census shape, beside the default inputs: every
# row observed (the delta branch alone) and a choice with no observation
# (the static code 0)
K13_CHECKS = (1, "static")


def k13_inputs(dev, R: int, V: int, seed: int = 0, state="rows",
               fields=None) -> dict:
    """Seeded K13 inputs of R enumeration rows and V options: enum [1, R,
    V], obs_ld [1, R] and the observed code on the batch axis; the
    children: with a census shape's `fields` its level rebuilt seeded
    (_bench_level) over its rows `full`, else a tensor [1, R, V].
    `state`: "rows", an int8 flag per enumeration row, 0, 1, 2 in turn (0
    unobserved and 2 missing read the enum logits, 1 the delta; one row:
    0); an int, that flag on every row (on the batch axis); "static", no
    observation and the static code 0."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    full = tuple(fields["full"]) if fields else ((1,) if R == 1 else (1, R))
    en = torch.randn(full + (V,), generator=g, device=dev)
    ch = torch.randn(full + (V,), generator=g, device=dev)
    if fields:
        ch = _bench_level(dev, fields["level"], seed + 1)
    ld = torch.randn(full, generator=g, device=dev) - 2.0
    lead = (1,) * len(full)
    obs = torch.randint(0, V, lead, generator=g, device=dev,
                        dtype=torch.int32)
    if state == "static":
        ld, obs, st = None, None, 0
    elif state == "rows":
        st = (torch.arange(R, device=dev) % 3).to(torch.int8).reshape(full)
    else:
        st = torch.full(lead, int(state), dtype=torch.int8, device=dev)
    return dict(args=(en, ch, full, ld, obs, st), R=R, K=V)


def child_bytes(x) -> int:
    """A child's bytes read once: a tensor's elements, or a fused level's
    (each reference's elements and each gather's distinct matrix entries,
    as level_bytes counts them, without an output)."""
    from . import ops

    if not isinstance(x, ops.Level):
        return x.numel() * x.element_size()
    shape = ops.level_shape(x.operands, x.rank)
    inp = dict(kernel="level_sum", args=(x.prog, x.operands, x.rank))
    return level_bytes(inp) - 4 * int(np.prod(shape))


def k12_bytes(inp: dict) -> int:
    """K12's bytes: refcount, alive, total, nrows, strength, discount and
    the children (child_bytes) read once, the record [R, K + 1] and logZ
    written once."""
    refc, alive, tot, nr, s, d, ch, nch, _full = inp["args"]
    R, K = inp["R"], inp["K"]
    n = sum(t.numel() * t.element_size() for t in (refc, alive, tot, nr, s,
                                                   d))
    return n + child_bytes(ch) + child_bytes(nch) + 4 * R * (K + 1) + 4 * R


def k13_bytes(inp: dict) -> int:
    """K13's bytes on these inputs: the children (child_bytes) and the
    state read once; the enum logits only of the rows not in state 1
    (k13_inputs gives them one [V] row each), obs_ld of the rows in state
    1 and the observed code (one, on the batch axis) where any row is;
    the record [R, V] and logZ written once."""
    en, ch, full, ld, obs, st = inp["args"]
    R, V = inp["R"], inp["K"]
    if obs is None:
        seen = 0
    elif torch.is_tensor(st):
        seen = int((st.expand(full) == 1).sum())
    else:
        seen = R if st == 1 else 0
    n = child_bytes(ch) + (R - seen) * V * en.element_size()
    if torch.is_tensor(st):
        n += st.numel() * st.element_size()
    if seen:
        n += seen * ld.element_size() + obs.numel() * obs.element_size()
    return n + 4 * R * V + 4 * R


def _score_fns(ops, kernel: str, path=None):
    """(the wrapper, its plain version); with `path`, the launch with its
    geometry forced (ops._fk_score, ops._choice_score)."""
    fn, plain = (ops.fk_score, ops.fk_score_plain) if kernel == "fk_score" \
        else (ops.choice_score, ops.choice_score_plain)
    if path is not None:
        forced = ops._fk_score if kernel == "fk_score" else ops._choice_score
        fn = functools.partial(forced, path=path)
    return fn, plain


def time_score(ops, kernel: str, inp: dict, path=None) -> dict:
    """K12 or K13 on these inputs (the child levels summed in the launch;
    `path` forces one of ops.SCORE_PATHS) beside its plain version and the
    library call of its logsumexp alone (torch.logsumexp over the record):
    ms (cuda_ms) and device_ms (graph_ms) of each."""
    fn, plain = _score_fns(ops, kernel, path)
    args = inp["args"]
    rec, _z = plain(*args)
    lib = lambda: torch.logsumexp(rec, dim=1)  # noqa: E731
    call = lambda: fn(*args)  # noqa: E731
    return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                plain_ms=cuda_ms(lambda: plain(*args)),
                library_ms=cuda_ms(lib), library_device_ms=graph_ms(lib))


def check_score(ops, kernel: str, inp: dict, path=None) -> float:
    """K12 or K13 against its plain version on the card (`path` forces
    one of ops.SCORE_PATHS): record bit-equal, logZ within K1's rule
    (check_k1). Returns max |dlogZ|."""
    fn, plain = _score_fns(ops, kernel, path)
    r0, z0 = plain(*inp["args"])
    r1, z1 = fn(*inp["args"])
    torch.cuda.synchronize()
    require(torch.equal(r0, r1), f"{kernel} record differs from the plain "
            f"version at R = {inp['R']}, K = {inp['K']}")
    d = (z1 - z0).abs()
    scale = torch.maximum(z0.abs(), r0.amax(-1).abs())
    require(bool(((d <= 1e-6 * scale) | (z1 == z0)).all()),
            f"{kernel} logZ err {float(d.max())}")
    return float(d.max())


# ---------------------------------------------------------------- K14, K15

_TD = {"b": torch.bool, "i8": torch.int8, "u8": torch.uint8,
       "i16": torch.int16, "i32": torch.int32, "i64": torch.int64,
       "f32": torch.float32, "f64": torch.float64}


def k14_parse(mode: str) -> dict:
    """The spec a K14 census mode names (ops._k14_sig; cascade: "cascade
    class fks=F")."""
    parts = mode.split(" ")
    if parts[0] == "cascade":
        return dict(kind="cascade", fks=int(parts[-1].split("=")[1]))
    sides = []
    for sd in parts[3].split("/"):
        head, hops = sd.split(":")
        sides.append(dict(sign=int(head[:2]), f=head[2:], hops=[
            (int(h.rstrip("q")), h.endswith("q")) for h in hops.split(",")
            if h]))
    return dict(kind=parts[0], n=int(parts[1][2:]), src=int(parts[2][4:]),
                sides=sides, code=parts[4], slots="idx" in parts[5:])


def k14_inputs(dev, mode: str, C: int, seed: int = 0) -> dict:
    """Seeded inputs of the K14 spec `mode` into C targets (numpy, then
    `dev`): fk columns uniform over the next class (the last over the
    targets) with 5% out of range, alive bits 0.8, states 0-2, weights
    0-3, codes 0-49, counts 0-5 (a delta updates a carried count) or 0,
    distinct source slots with 1% out of range, the excluded slot a
    tensor; cascade: deltas -2-2, refcounts 0-4, fk columns into a class
    of max(64, C / 4) slots. dict(kind, mode, C, args: ops.rel_scatter's
    or ops.rel_cascade's arguments)."""
    rng = np.random.default_rng(seed)
    sp = k14_parse(mode)

    def t(x, dt):
        return torch.as_tensor(x, device=dev).to(dt)

    def col(n, hi, q=False):
        v = rng.integers(0, hi, n)
        v[rng.random(n) < 0.05] = hi
        return t(v, torch.int64 if q else torch.int32)

    if sp["kind"] == "cascade":
        C2 = max(64, C // 4)
        fks = [(col(C, C2), t(np.zeros(C2), torch.int32))
               for _ in range(sp["fks"])]
        rc = rng.integers(0, 5, C)
        return dict(kind="cascade", mode=mode, C=C, args=(
            t(rng.integers(-2, 3, C), torch.int32), t(rc, torch.int32),
            t(rc > 0, torch.bool), fks))
    n, src = sp["n"], sp["src"]
    code = None if sp["code"] == "-" else \
        t(rng.integers(0, 50, C), _TD[sp["code"]])
    cnt = t(rng.integers(0, 6, C) if sp["kind"] == "delta"
            else np.zeros(C), torch.int32)
    slots = None
    if sp["slots"]:
        v = rng.permutation(max(src, n))[:n]
        v[rng.random(n) < 0.01] = src + 3
        slots = t(v, torch.int64)
    exclude = None
    sides = []
    from . import ops
    for sd in sp["sides"]:
        f = sd["f"]
        lens = [h[0] for h in sd["hops"]]
        hops = [col(L, (lens[j + 1] if j + 1 < len(lens) else C), q)
                for j, (L, q) in enumerate(sd["hops"])]
        if "x" in f:
            exclude = t([src // 2], torch.int64)
        sides.append(ops.scatter_side(
            hops,
            alive=t(rng.random(src) < 0.8, torch.bool) if "a" in f else None,
            state=t(rng.integers(0, 3, src), torch.int8) if "s" in f
            else None,
            weight=t(rng.integers(0, 4, src), torch.int32) if "w" in f
            else None,
            code=t(rng.integers(0, 50, src), code.dtype) if "c" in f
            else None,
            sign=sd["sign"], exclude="x" in f))
    return dict(kind=sp["kind"], mode=mode, C=C, args=(
        sp["kind"], cnt, code, sides, n, slots, exclude, src))


def k14_launch(ops, inp: dict, route: str, blocks=None) -> None:
    """inp's scatter in one K14 launch on `route` ("thread" or "local")
    with `blocks` (None: the route's own count, ops._k14_blocks): the
    words rel_scatter passes (ops.k14_words) with their route words set,
    launched as it launches them, not counted (the A/B's --routes and
    the card tests' forced routes)."""
    kind, cnt, code, sides, n, slots, exclude, src = inp["args"]
    words, _keep, _run = ops.k14_words(kind, cnt, code, sides, n, slots,
                                       exclude, src)
    words[13] = ops.K14_ROUTES.index(route)
    words[15] = blocks or ops._k14_blocks(route, n, ops.sm_count(cnt.device))
    arr = (ctypes.c_int64 * len(words))(*words)
    ops._check(ops._fn("rel_scatter")(arr, len(arr), ops._stream(cnt)),
               "rel_scatter")


def _k14_call(ops, inp: dict, plain: bool = False, route=None,
              blocks=None):
    """One K14 call on inp's arguments; `route` (and `blocks`) forces a
    scatter's launch (k14_launch)."""
    if inp["kind"] == "cascade":
        fn = ops.rel_cascade_plain if plain else ops.rel_cascade
        return fn(*inp["args"])
    if plain:
        return ops.rel_scatter_plain(*inp["args"])
    if route is not None:
        return k14_launch(ops, inp, route, blocks)
    return ops.rel_scatter(*inp["args"])


def _k14_outputs(inp: dict, res) -> list:
    """The tensors one K14 call writes: cnt and code (scatter), or the new
    refcount, alive, sums and every pending delta (cascade)."""
    if inp["kind"] == "cascade":
        return list(res) + [p for _c, p in inp["args"][3]]
    return [x for x in inp["args"][1:3] if x is not None]


def check_k14(ops, inp: dict, route=None, blocks=None) -> float:
    """K14 on a copy of the inputs on the card (on the plan's route, or on
    `route` with `blocks`, k14_launch) against its plain version on a CPU
    copy: every output bit-equal (integer atomics are exact in any order).
    Returns 0.0 (or fails)."""
    dev_in = _tree_map(inp, lambda x: x.clone())
    cpu_in = _tree_map(inp, lambda x: x.cpu())
    got = _k14_outputs(dev_in, _k14_call(ops, dev_in, route=route,
                                         blocks=blocks))
    want = _k14_outputs(cpu_in, _k14_call(ops, cpu_in, plain=True))
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        require(torch.equal(g.cpu(), w), f"rel_scatter differs from its "
                f"plain version at {inp['mode']}, C = {inp['C']} (output "
                f"{i}{', ' + route if route else ''})")
    return 0.0


def k14_plan(ops, inp: dict):
    """The launch rel_scatter_plan gives a scatter's inputs on this card
    (None for a cascade)."""
    if inp["kind"] == "cascade":
        return None
    _k, cnt, code, sides, n, slots = inp["args"][:6]
    return ops.rel_scatter_plan(n, cnt.shape[0], sides, code, slots,
                                ops.sm_count(cnt.device))


def k14_bytes(inp: dict) -> int:
    """K14's bytes: each input element read once (the slots, each side's
    per-source factors and hop columns at the sources they are read at,
    the counts and codes it updates, a cascade's deltas, refcounts, alive
    bits, fk columns and pending deltas) and each output element written
    once."""
    if inp["kind"] == "cascade":
        d, rc, alive, fks = inp["args"]
        C = d.shape[0]
        n = C * (4 + 4 + 1) + C * (4 + 1) + 16
        for c, p in fks:
            n += C * c.element_size() + 2 * 4 * p.shape[0]
        return n
    _k, cnt, code, sides, n_src, slots, _x, _s = inp["args"]
    C = cnt.shape[0]
    n = 2 * C * (4 + (code.element_size() if code is not None else 0))
    n += 8 * n_src if slots is not None else 0
    for sd in sides:
        for key in ("alive", "state", "weight", "code"):
            if sd[key] is not None:
                n += n_src * sd[key].element_size()
        n += sum(n_src * h.element_size() for h in sd["hops"])
    return n


def time_k14(ops, inp: dict) -> dict:
    """K14 on a copy of these inputs (in place, so the calls accumulate)
    beside its plain version on the card and the library call of its
    count alone: one index_add_ of the first side's weights at its
    targets, precomputed (the sign and the drop rule applied), into a
    buffer one longer: ms (cuda_ms) and device_ms (graph_ms) of each."""
    from .utils import drop_index
    x = _tree_map(inp, lambda t: t.clone())
    call = lambda: _k14_call(ops, x)  # noqa: E731
    y = _tree_map(inp, lambda t: t.clone())
    if inp["kind"] == "cascade":
        d, rc, alive, fks = inp["args"]
        c, p = fks[0] if fks else (torch.arange(d.shape[0], device=d.device),
                                   torch.zeros_like(d))
        flip = (rc + d > 0).to(torch.int32) - alive.to(torch.int32)
        idx, w, buf = drop_index(c, p.shape[0]), flip, \
            torch.zeros(p.shape[0] + 1, dtype=torch.int32, device=d.device)
    else:
        _k, cnt, _c, sides, n, slots, exclude, src = inp["args"]
        sd = sides[0]
        s = torch.arange(n, device=cnt.device) if slots is None else \
            slots.clamp(0, src - 1)
        m = torch.ones((n,), dtype=torch.bool, device=cnt.device)
        if sd["alive"] is not None:
            m = m & sd["alive"][s]
        if sd["state"] is not None:
            m = m & (sd["state"][s] == 1)
        w = m.to(torch.int32) * sd["sign"]
        if sd["weight"] is not None:
            w = w * sd["weight"][s]
        t = s
        for h in sd["hops"]:
            t = take(h, t)
        idx, buf = drop_index(t, cnt.shape[0]), \
            torch.zeros(cnt.shape[0] + 1, dtype=torch.int32,
                        device=cnt.device)
    lib = lambda: buf.index_add_(0, idx, w)  # noqa: E731
    return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                plain_ms=cuda_ms(lambda: _k14_call(ops, y, plain=True)),
                library_ms=cuda_ms(lib), library_device_ms=graph_ms(lib))


def k15_parse(mode: str) -> dict:
    """The columns a K15 census mode names ("class cap=C dst<src,...[,
    alive]")."""
    parts = mode.split(" ")
    cols, alive = [], False
    for c in parts[2].split(","):
        if c == "alive":
            alive = True
        elif c:
            d, s = c.split("<")
            cols.append((_TD[d], _TD[s]))
    return dict(cls=parts[0], cap=int(parts[1][4:]), cols=cols, alive=alive)


def k15_inputs(dev, mode: str, B: int, seed: int = 0) -> dict:
    """Seeded inputs of the K15 census mode `mode` at B rows: columns of
    the census's capacity and dtypes (ints 0-99, floats in [0, 1)), values
    [B] of their dtypes (ints 0-199, floats in [0, 4)), distinct slots
    (those past the capacity drop, as in a class's last batch), the first
    -1 where the last slot is free (it wraps), ok bits 0.8. dict(mode, B,
    args: ops.batch_write's arguments)."""
    rng = np.random.default_rng(seed)
    sp = k15_parse(mode)
    cap = sp["cap"]

    def t(x, dt):
        return torch.as_tensor(x, device=dev).to(dt)

    def draw(n, dt, hi, fhi):
        return t(rng.random(n) * fhi if dt.is_floating_point
                 else rng.integers(0, hi, n), dt)

    cols = [draw(cap, d, 100, 1.0) for d, _s in sp["cols"]]
    vals = [draw(B, s, 200, 4.0) for _d, s in sp["cols"]]
    v = rng.permutation(max(cap, B) + max(1, B // 64))[:B]
    if cap - 1 not in v:
        v[0] = -1
    alive = t(rng.random(cap) < 0.5, torch.bool) if sp["alive"] else None
    return dict(mode=mode, B=B, args=(
        cols, vals, t(v, torch.int64), t(rng.random(B) < 0.8, torch.bool),
        alive))


def check_k15(ops, inp: dict) -> float:
    """K15 on a copy of the inputs on the card against its plain version
    on a CPU copy: every column and the alive bits bit-equal. Returns 0.0
    (or fails)."""
    dev_in = _tree_map(inp["args"], lambda x: x.clone())
    cpu_in = _tree_map(inp["args"], lambda x: x.cpu())
    ops.batch_write(*dev_in)
    ops.batch_write_plain(*cpu_in)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(
            dev_in[0] + [dev_in[4]], cpu_in[0] + [cpu_in[4]])):
        if g is not None:
            require(torch.equal(g.cpu(), w), f"batch_write differs from "
                    f"its plain version at {inp['mode']}, B = {inp['B']} "
                    f"(column {i})")
    return 0.0


def k15_bytes(inp: dict) -> int:
    """K15's bytes: the slots, the ok bits and every value read once, one
    element of each column (and the alive bits) written a row the ok
    bits keep and the drop rule leaves in range."""
    cols, vals, slots, ok, alive = inp["args"]
    B = slots.shape[0]
    n = B * (8 + 1) + sum(B * v.element_size() for v in vals)
    cap = cols[0].shape[0] if cols else alive.shape[0]
    s = torch.where(slots < 0, slots + cap, slots)
    kept = int((ok & (s >= 0) & (s < cap)).sum())
    n += kept * (sum(c.element_size() for c in cols)
                 + (1 if alive is not None else 0))
    return n


def time_k15(ops, inp: dict) -> dict:
    """K15 on a copy of these inputs beside its plain version on the card
    and the library call of one column's write: one index_copy_ of the
    first column's kept values at their slots (precomputed): ms (cuda_ms)
    and device_ms (graph_ms) of each. A call that launches nothing (no
    rows, or no column and no alive bits) is not timed, and neither is a
    library call with no kept value to write (a CUDA graph of it would be
    empty): those times are None."""
    x = _tree_map(inp["args"], lambda t: t.clone())
    y = _tree_map(inp["args"], lambda t: t.clone())
    cols, vals, slots, ok, alive = x
    out = dict(ms=None, device_ms=None, plain_ms=None, library_ms=None,
               library_device_ms=None)
    if slots.shape[0] == 0 or (not cols and alive is None):
        return out
    call = lambda: ops.batch_write(*x)  # noqa: E731
    out.update(ms=cuda_ms(call), device_ms=graph_ms(call),
               plain_ms=cuda_ms(lambda: ops.batch_write_plain(*y)))
    if cols:
        cap = cols[0].shape[0]
        s = torch.where(slots < 0, slots + cap, slots)
        keep = torch.nonzero(ok & (s >= 0) & (s < cap))[:, 0]
        if keep.numel():
            lib_col = cols[0].clone()
            li, lv = s[keep], vals[0][keep].to(lib_col.dtype)
            lib = lambda: lib_col.index_copy_(0, li, lv)  # noqa: E731
            out.update(library_ms=cuda_ms(lib), library_device_ms=graph_ms(lib))
    return out


def check_rel_state(ops, eng, arenas) -> dict:
    """refresh (K14's refcount and prop specs) and each latent class's
    hop_histograms on a path's state on the card, against the plain
    versions on a CPU copy of the same state: every leaf bit-equal, under
    torch.cuda.set_sync_debug_mode("error"), so no launch waits for the
    card. Returns dict(launches, mismatches)."""
    import copy

    from .engine.refresh import hop_histograms, refresh

    cm = eng.cm
    cm_cpu = copy.copy(cm)   # the same model, its buffers made on the CPU
    cm_cpu.device = torch.device("cpu")
    cpu = lambda t: t.cpu()  # noqa: E731
    a_cpu, obs_cpu = _tree_map(arenas, cpu), _tree_map(eng.obs_dev, cpu)
    latents = [c for c in cm.model.class_order
               if not cm.layouts[c].observed and cm.layouts[c].fk_vertices]
    before = ops.LAUNCHES["rel_scatter"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [refresh(cm, arenas, eng.obs_dev)] + \
            [hop_histograms(cm, c, arenas, eng.obs_dev) for c in latents]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = ops.LAUNCHES["rel_scatter"] - before
    want = [refresh(cm_cpu, a_cpu, obs_cpu)] + \
        [hop_histograms(cm_cpu, c, a_cpu, obs_cpu) for c in latents]
    bad = [name for name, x, y in _leaves(got, want, "rel")
           if not torch.equal(x.cpu(), y)]
    return dict(launches=launches, mismatches=bad)


LOOPS = ("ramp", "sweep", "replay")


def graph_against_eager(eng, arenas, params, loop: str, cid, rows: int,
                        pg_P=None, rejuv: bool = True, seed: int = 0) -> dict:
    """`rows` rows of one one-row loop (`loop`: "ramp", scan_init's run
    from row 0; "sweep", _sweep_segment from slot 0; "replay",
    _replay_chunk of the first `rows` slots, `rejuv` or not) of class
    cid, twice from the same state and generator state: once every row
    eager with the kernels (graph=False), once as replays of the captured
    row step. Every carry leaf, params leaf and output (the log-ML) and the
    generator's final state must be bit-equal, and the launch counts of
    the two runs equal (a row step that waited for the card could not be
    captured: the capture raises). Returns dict(kind, rows, mismatches,
    launches, stats: the graphed run's row_graph.STATS entry)."""
    import copy

    from . import ops
    from .engine import row_graph

    cm = eng.cm
    out, counts, gens = [], [], []
    g = torch.Generator(device=cm.device)
    g.manual_seed(seed)
    state = g.get_state()
    stats = None
    for graph in (False, True):
        g.set_state(state)
        row_graph.reset_stats()
        before = ops.snapshot()
        e = copy.copy(eng)
        e.config = copy.copy(eng.config)
        if loop == "ramp":
            e.config.scan_segment = rows
            run, _seg = e.scan_init(cid, rows, pg_P=pg_P)
            res = run(arenas, params, 0, g, graph=graph)
        elif loop == "sweep":
            res = e._sweep_segment(cid, arenas, params, 0, g, rows,
                                   pg_P=pg_P, graph=graph)
        else:
            res = e._replay_chunk(cid, arenas, params,
                                  np.arange(rows, dtype=np.int64), g,
                                  rejuv, pg_P, graph=graph)
        if cm.device.type == "cuda":
            torch.cuda.synchronize()
        out.append(res)
        counts.append(ops.counts_since(before)["launches"])
        gens.append(g.get_state())
        stats = dict(next(iter(row_graph.STATS.values()), {}),
                     kind=next(iter(row_graph.STATS), None))
    bad = [name for name, x, y in _leaves(out[0], out[1], "out")
           if not torch.equal(x, y)]
    if not torch.equal(gens[0], gens[1]):
        bad.append("generator state")
    if counts[0] != counts[1]:
        bad.append(f"launch counts {counts[0]} != {counts[1]}")
    return dict(kind=stats["kind"], loop=loop, cls=cid, rows=rows,
                mismatches=bad, launches=sum(counts[1].values()),
                stats=stats)


def _load_tree_ops(tree: str, alias: str):
    """The `ops` module of the pclean_tpu_torch package under `tree`,
    imported as package `alias` (so several trees load side by side, each
    building its kernels into its own _build/)."""
    pkg = os.path.join(os.path.abspath(tree), "pclean_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(alias + ".ops")


AB_K7 = (  # K7's shapes in the A/B: (label, G, V, R, per_row, density,
    # skew)
    ("hoisted scaled [11264, 1832]", 11264, 1832, 100_000, False, None,
     None),
    ("hoisted rents [4096, 1766]", 4096, 1766, 50_000, False, None, None),
    ("hoisted hospital [512, 111]", 512, 111, 100_000, False, None, None),
    ("hoisted hospital [512, 111] crowded", 512, 111, 100_000, False, None,
     (55, 2)),
    ("hoisted hospital County [128, 14] crowded", 128, 14, 100_000, False,
     None, (18, 2)),
    ("rows one row [1, 5125]", 1, 5125, 100_000, True, 12 / 100_000, None),
    ("rows [4096, 5125]", 4096, 5125, 100_000, True, 12 / 100_000, None),
    ("rows [64, 111] crowded", 64, 111, 100_000, True, 1 / 55, (55, 2)),
)
AB_K4 = ("rents 50000 -> [4096, 5]", 50_000, 4096, 5)
AB_K6 = (  # K6's shapes in the A/B: (label, B, V, N, list form, kept)
    # the flights path's four time fields: one Flight slot, a list of 23
    # kept of its 256 (the referrer bound)
    ("list of 23 of 256 [1, 222]", 1, 222, 256, True, 23),
    ("list of 23 of 256 [1, 236]", 1, 236, 256, True, 23),
    ("list of 23 of 256 [1, 238]", 1, 238, 256, True, 23),
    ("list of 23 of 256 [1, 241]", 1, 241, 256, True, 23),
    # the dense form over the flights path's 2,376 Obs rows, one slot
    ("dense over 2376 [1, 241]", 1, 241, 2376, False, None),
)
AB_K8 = (  # K8's seeded shapes in the A/B: (label, B, E, Vc, V, R, density,
    # live rows): the hospital path's four census shapes' sizes (100,000
    # Records into 9 live counties of ~11,100 or 40 measures of 2,500, the
    # batch's other rows empty), and every row of a batch holding referrers
    ("one row County [1, 14], 11% kept", 1, 14, 78, 1133, 100_000, 0.112,
     None),
    ("one row Measure [1, 78], 2.6% kept", 1, 78, 14, 1133, 100_000, 0.026,
     None),
    ("County [4096, 14], 9 live rows", 4096, 14, 78, 1133, 100_000, 1 / 9,
     9),
    ("Measure [4096, 78], 40 live rows", 4096, 78, 14, 1133, 100_000,
     1 / 40, 40),
    ("County [4096, 14], every row 1/128 kept", 4096, 14, 78, 1133, 100_000,
     1 / 128, None),
)
AB_K5 = (  # K5's seeded shapes in the A/B: (label, B, A, C): the rents
    # path's census shape (a County batch of 256 rows over 51 states, C =
    # 5, two env axes), one row, C = 1 and 17 (the generic loop) and 4,096
    # rows
    ("rents census [256, 51] C 5", 256, 51, 5),
    ("one row [1, 51] C 5", 1, 51, 5),
    ("[256, 51] C 1", 256, 51, 1),
    ("[256, 51] C 17", 256, 51, 17),
    ("[4096, 51] C 5", 4096, 51, 5),
)
AB_K9 = (  # K9's shapes in the A/B: (label, R, P, mode): the
    # hospital_pg16_vmapped path's census (B = 64 rows and one row of 16
    # particles) and one row of 1,024
    ("resample [64, 16]", 64, 16, "resample"),
    ("final [64, 16]", 64, 16, "final"),
    ("resample [1, 16]", 1, 16, "resample"),
    ("final [1, 16]", 1, 16, "final"),
    ("resample [1, 1024]", 1, 1024, "resample"),
)
AB_K18 = (  # K18's shapes in the A/B: (label, slots, chains, leaf
    # length): one chain (an int32 leaf of 1,000,000, scaled's Record
    # columns) at one slot and at every slot, beside torch.take; a copy
    # group as the flights Obs block reads its Flight candidates (five
    # int32 leaves of 160 at 160 slots, and at one slot as its sample pass
    # does), one call a chain where the tree has no group form
    ("one chain i32:1000000 at 1 slot", 1, 1, 1_000_000),
    ("one chain i32:1000000 at 1000000 slots", 1_000_000, 1, 1_000_000),
    ("copy group 5 x i32:160 at 160 slots", 160, 5, 160),
    ("copy group 5 x i32:160 at 1 slot", 1, 5, 160),
)
AB_K20 = (  # K20's levels in the A/B: (label, output shape, the dense
    # term's shape, the program's depth): one output (the most launched
    # one-row shape), rents' [256, 4,096, 2] as one add and with rents'
    # own program (five zeros pushed, the term added at depth 4: the
    # nested sums of its County block's level, a stack of 5)
    ("one output a1", (1,), (1,), 1),
    ("[256, 4096, 2] a1", (256, 4096, 2), (256, 4096, 2), 1),
    ("[256, 4096, 2] a1 rents' program", (256, 4096, 2), (256, 4096, 2),
     5),
)
AB_K20_GATHERS = (  # (label, candidates, gathers, V): the hospital Record
    # block's one-row level over its 512 Hospital candidates with its 11
    # deferred AddTypos columns (K3's gathers at one row), a graphed ramp
    # row's slowest K20 launch
    ("one row [1, 512] 11 gathers", 512, 11, 1133),
)
AB_SCORE = (  # K12's and K13's levels in the A/B: (label, kernel, slots or
    # options, gathers of the child level, the gathers' V): the hospital
    # Record block's K12 into its 512 Hospital candidates, whose child
    # level carries 11 deferred AddTypos columns (a graphed ramp row's
    # slowest level), and a K13 of 23 options with its one-gather level
    # (hospital's Measure name); each as the parent's pair (K20, then the
    # score kernel on its sum) and, where the tree has ops.Level, fused
    ("K12 hospital Record [1, 512] 11 gathers", "fk_score", 512, 11, 1133),
    ("K13 [1, 23] 1 gather", "choice_score", 23, 1, 1133),
)
AB_K22 = (  # K22's shapes in the A/B: (label, descriptors (mode, rows,
    # width, counts)): the six paths' census shapes: rents' County
    # Proportions, one Dirichlet row of 51; scaled's of 50; hospital's
    # three Proportions of 23, 14 and 8 in one call; flights' 39 Beta pairs
    ("rents [1, 51] Dirichlet", (("dirichlet_log", 1, 51, True),)),
    ("scaled [1, 50] Dirichlet", (("dirichlet_log", 1, 50, True),)),
    ("hospital [1, 23] [1, 14] [1, 8] Dirichlet", (
        ("dirichlet_log", 1, 23, True), ("dirichlet_log", 1, 14, True),
        ("dirichlet_log", 1, 8, True))),
    ("flights [39, 2] Beta", (("beta", 39, 2, True),)),
)
AB_K14 = (  # K14's shapes in the A/B without --census-shapes: (census
    # mode, C): scaled's refcount of its Records and of its Hospitals (the
    # latent replay row's, excluding a slot), a propagated observation with
    # a code over 1,000,000 sources, batched deltas, a cascade
    ("refcount n=1000000 src=1000000 +1a:1000000 -", 11264),
    ("refcount n=11264 src=11264 +1ax:11264 -", 1472),
    ("prop n=1000000 src=1000000 +1asc:1000000,11264 i32", 11264),
    ("delta n=4096 src=100000 -1as:100000,1000 - idx", 1000),
    ("delta n=64 src=11264 +1wc:11264,1472 i32 idx", 1472),
    ("cascade Hospital fks=2", 11264),
)
AB_K23 = (  # K23's shapes in the A/B without --census-shapes: (label,
    # caps): scaled's Hospital and County, rents' County, six classes of
    # 64-512 as hospital's
    ("scaled [11264, 1472]", (11264, 1472)),
    ("rents [4096]", (4096,)),
    ("hospital-like [64, 128, 256, 512, 64, 128]", (64, 128, 256, 512, 64,
                                                     128)),
)
# what --routes times beside the plans, with this checkout's kernels (the
# launch words set by hand, k14_launch and k23_launch): K14 at each A/B
# shape on both routes where the spec takes the histogram, and over
# K14_ROUTE_GRID's refcounts (sources, sources a target), which set
# ops.K14_HIST_MIN and K14_HIST_RATIO; K23 at each A/B shape of more than
# 1,024 slots in clusters of CL blocks of T threads
K14_ROUTE_GRID = tuple((n, r) for n in (2048, 8192, 32768, 65536, 262144,
                                        1000000)
                       for r in (8, 16, 32, 64, 256))
K23_VARIANTS = ((16, 256), (8, 256), (16, 128), (16, 512), (16, 1024),
                (8, 1024))


def _k16f(mask, B, cap):
    return dict(form="drawn", mask=mask, B=B, cap=cap, comp=False, d=0)


def _k17f(B, d=0):
    return dict(form="draw", dtype=torch.float32, B=B, d=d)


def _groupf(B, Vs, rows=None):
    return dict(form="group", B=B, Vs=tuple(Vs),
                rows=tuple(rows or (B,) * len(Vs)))


# K16's and K17's shapes in the A/B and the geometry sweep, each (label,
# fields, K): the census shapes of the six paths (PERF.md §6): one-row
# draws at hospital's, flights', scaled's and rents' row lengths, the
# batched [4,096, V] draws of scaled and rents, K16's one-row fks and its
# [4,096, 11,265] draws on the shared and the own mask, and K17's group
# shapes (a tree without the group mode launches a member at a time):
# hospital's Record block (11 choices) and flights' Obs block at one
# row, scaled's Record block at one row and at 4,096
AB_K17 = (
    ("one row V=14", _k17f(1), 14),
    ("one row V=111", _k17f(1), 111),
    ("one row V=241", _k17f(1), 241),
    ("one row V=1766", _k17f(1), 1766),
    ("one row V=1914", _k17f(1), 1914),
    ("one row V=7735", _k17f(1), 7735),
    ("one row V=2 d=1", _k17f(1, 1), 2),
    ("[4096, 138]", _k17f(4096), 138),
    ("[4096, 1914]", _k17f(4096), 1914),
    ("[4096, 7735]", _k17f(4096), 7735),
    ("[256, 1766]", _k17f(256), 1766),
    ("group hospital Record one row", _groupf(
        1, (14, 50, 75, 13, 99, 94, 102, 111, 23, 88, 8)), None),
    ("group flights Obs one row", _groupf(1, (222, 238, 236, 241)), None),
    ("group scaled Record one row", _groupf(1, (138, 7735, 1914)), None),
    ("group scaled Record [4096]", _groupf(4096, (138, 7735, 1914)), None),
)
AB_K16 = (
    ("one row 65 shared", _k16f("shared", 1, 64), 65),
    ("one row 161 shared", _k16f("shared", 1, 160), 161),
    ("one row 1473 shared", _k16f("shared", 1, 1472), 1473),
    ("one row 4097 shared", _k16f("shared", 1, 4096), 4097),
    ("one row 11265 shared", _k16f("shared", 1, 11264), 11265),
    ("[256, 4097] own", _k16f("own", 256, 4096), 4097),
    ("[4096, 11265] shared", _k16f("shared", 4096, 11264), 11265),
    ("[4096, 11265] own", _k16f("own", 4096, 11264), 11265),
)
# and beside them, in the geometry sweep only, the row lengths and row
# counts between the census shapes that draw_plan's thresholds fall in
SWEEP_K17 = tuple((f"sweep [{B}, {V}]", _k17f(B), V) for B, V in (
    (1, 32), (1, 64), (1, 128), (1, 384), (1, 512), (1, 1024), (1, 4096),
    (1, 16384), (1, 70_001), (16, 111), (16, 1024), (256, 138),
    (256, 512), (4096, 256), (4096, 512), (4096, 1024), (4096, 4096)))
SWEEP_K16 = tuple((f"sweep {m} [{B}, {c + 1}]", _k16f(m, B, c), c + 1)
                  for m, B, c in (("shared", 1, 512), ("shared", 1, 2048),
                                  ("shared", 16, 1472), ("own", 256, 1472),
                                  ("shared", 4096, 1472),
                                  ("own", 4096, 4096)))
_I32, _F32 = torch.int32, torch.float32
AB_K19 = (  # K19's census shapes in the A/B: (label, B, the pairs'
    # (new, existing) dtypes): one row at every census count of pairs
    # (flights' 3 and rents' 11 with their float pairs), pg16's [16, 2],
    # scaled's [4,096, 7] and [4,096, 2], rents' [256, 11]
    *((f"one row, {n} pairs", 1, [(_I32, _I32)] * n)
      for n in (1, 2, 4, 7, 9, 25)),
    ("one row, 3 pairs (flights)", 1, [(_I32, _I32)] * 2 + [(_F32, _F32)]),
    ("one row, 11 pairs (rents)", 1,
     [(_I32, _I32)] * 8 + [(_F32, _F32)] * 3),
    ("[16, 2]", 16, [(_I32, _I32)] * 2),
    ("[4096, 2]", 4096, [(_I32, _I32)] * 2),
    ("[4096, 7]", 4096, [(_I32, _I32)] * 7),
    ("[256, 11] (rents)", 256, [(_I32, _I32)] * 8 + [(_F32, _F32)] * 3),
)
AB_K10 = (  # K10's census classes in the A/B: (label, workload, class,
    # setup's arguments), each at both signs in obs mode on a seeded state
    ("hospital Record", "hospital", "Record", dict(rows=240, batch=16)),
    ("flights Obs", "flights", "Obs", dict(rows=300, flights=12,
                                           websites=8)),
    ("scaled Record", "scaled", "Record", dict(rows=2000, counties=50,
                                               hospitals=200, names=100,
                                               zips=50)),
    ("rents Obs", "rents", "Obs", dict(rows=1000, counties=100)),
)
# K21's census shapes in the A/B without --k21-shapes: (label, fields, K)
# as the wrapper records them (ops.CENSUS_FIELDS), scaled's Hospital level
# over 4,096 rows with its leaves per row and shared, and its County's
# [16, 128]
_I64 = torch.int64
AB_K21 = (
    ("scaled Hospital [4096, 11264] rows", dict(
        B=4096, full=(4096,), cap=11264, comp=False, per_row=True, sd=True,
        counts=(_I64, _I64), ch="rows"), 11264),
    ("scaled Hospital [4096, 11264] shared", dict(
        B=4096, full=(4096,), cap=11264, comp=False, per_row=False, sd=True,
        counts=(_I64, _I64), ch="rows"), 11264),
    ("scaled County [16, 128]", dict(
        B=16, full=(16,), cap=128, comp=False, per_row=True, sd=True,
        counts=(_I64, _I64), ch="rows"), 128),
)
AB_KINDS = ("k1-k3", "k4", "k5", "k6", "k7", "k8", "k9", "k10", "k11", "k12",
            "k13", "k14", "k16", "k17", "k18", "k19", "k20", "k21", "k22",
            "k23")


def host_us(fn, n: int = 2000) -> float:
    """Wall microseconds a call, n calls enqueued back to back and then a
    synchronize: the host's time a call wherever it exceeds the
    device's."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def k18_ab_inputs(dev, N: int, chains: int, n: int, seed: int = 0):
    """K18's A/B inputs: slots int32 [N] over [0, n) (1% past it) and
    `chains` int32 leaves of n entries (0-99), a chain each."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, N)
    s[rng.random(N) < 0.01] = n + 2
    leaves = [torch.as_tensor(rng.integers(0, 100, n), dtype=torch.int32,
                              device=dev) for _ in range(chains)]
    return dict(slot=torch.as_tensor(s, dtype=torch.int32, device=dev),
                chains=[([], leaf) for leaf in leaves])


def k18_ab_call(ops, inp):
    """The tree's gathers of inp's chains: one row_gather_group call where
    the tree has the group form and there is more than one chain, else one
    row_gather call a chain."""
    s, chains = inp["slot"], inp["chains"]
    if len(chains) > 1 and hasattr(ops, "row_gather_group"):
        return lambda: ops.row_gather_group(s, chains, label="ab")
    return lambda: [ops.row_gather(s, h, leaf, label="ab")
                    for h, leaf in chains]


def k20_gather_inputs(dev, K: int, n: int, V: int, seed: int = 0):
    """K20's A/B one-row gather level: n AddTypos columns M_i[obs_i,
    word_i[k]] over [1, K] candidates (M_i [V, V] normal, the codes int32
    in [0, V)), the code as the tracer writes a one-row level's deferred
    columns after an empty plan (ZERO, ZERO, ADDOP each, ADD)."""
    from . import ops

    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x, device=dev)

    operands = [ops.level_gather(
        t(rng.normal(0, 1, (V, V)).astype(np.float32)),
        t(rng.integers(0, V, (1, 1)).astype(np.int32)),
        t(rng.integers(0, V, (1, K)).astype(np.int32)), (1, K))
        for _ in range(n)]
    prog = [(ops.LEVEL_ZERO, 0)] * 2 + [(ops.LEVEL_ADDOP, i)
                                        for i in range(n)] + \
        [(ops.LEVEL_ADD, 0)]
    return dict(prog=prog, operands=operands, rank=2)


def k20_ab_inputs(dev, shape, x_shape, depth: int, seed: int = 0):
    """K20's A/B level over an output of `shape` (rank len(shape)): one
    dense float32 term of x_shape added to `depth` nested zeros, the code
    as the tracer writes it (ZERO x depth, ADD, PUSH, ADD x (depth - 1);
    depth 1: ZERO, PUSH, ADD), which each tree's level_program folds."""
    from . import ops

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(0, 2, x_shape).astype(np.float32),
                        device=dev)
    Z, A, P = ops.LEVEL_ZERO, ops.LEVEL_ADD, ops.LEVEL_PUSH
    prog = [(Z, 0), (P, 0), (A, 0)] if depth == 1 else \
        [(Z, 0)] * depth + [(A, 0), (P, 0)] + [(A, 0)] * (depth - 1)
    return dict(prog=prog, operands=[ops.level_dense(x)], rank=len(shape))


def score_ab_inputs(dev, kernel: str, K: int, n: int, V: int,
                    seed: int = 0) -> dict:
    """An A/B score call's inputs, as the tracer makes them at one row:
    K12's leaves and counts (k12_inputs) with ch_e the [1, K] level of n
    deferred gathers (k20_gather_inputs) and ch_n [1] two dense terms;
    K13's enum, observation and per-row state (k13_inputs) with the
    [1, K] gather level. The levels as (prog, operands, rank): each tree
    folds the program (level_program) and makes its own Level."""
    rng = np.random.default_rng(seed)
    lv = k20_gather_inputs(dev, K, n, V, seed)
    e = (lv["prog"], lv["operands"], 2)
    if kernel == "choice_score":
        inp = k13_inputs(dev, 1, K, seed)
        return dict(kernel=kernel, head=inp["args"][:1],
                    tail=inp["args"][2:], levels=[e], R=1, K=K)
    from . import ops

    inp = k12_inputs(dev, 1, K, seed)
    x = [torch.as_tensor(rng.normal(0, 2, (1,)).astype(np.float32),
                         device=dev) for _ in range(2)]
    Z, O = ops.LEVEL_ZERO, ops.LEVEL_ADDOP
    nl = ([(Z, 0), (O, 0), (O, 1)], [ops.level_dense(t) for t in x], 1)
    return dict(kernel=kernel, head=inp["args"][:6], tail=inp["args"][8:],
                levels=[e, nl], R=1, K=K)


def score_ab_call(ops, inp: dict, fused: bool):
    """The tree's call of an A/B score input: the parent's pair (each
    level summed by K20, then the score kernel on the sums) or, fused,
    the levels handed to the score kernel (None where the tree has no
    ops.Level)."""
    if fused and not hasattr(ops, "Level"):
        return None
    fn = getattr(ops, inp["kernel"])
    lvs = [(ops.level_program(p), o, r) for p, o, r in inp["levels"]]
    if fused:
        lvs = [ops.Level(p, o, r, "ab") for p, o, r in lvs]
        return lambda: fn(*inp["head"], *lvs, *inp["tail"])
    return lambda: fn(*inp["head"], *[ops.level_sum(p, o, r, B=1,
                                                    label="ab")
                                      for p, o, r in lvs], *inp["tail"])


def score_ab_bytes(inp: dict) -> int:
    """An A/B score call's bytes: the kernel's own inputs and outputs and
    its child levels' (k12_bytes, k13_bytes: each reference once, each
    gather's distinct matrix entries once)."""
    from . import ops

    lvs = [ops.Level(ops.level_program(p), o, r, "ab")
           for p, o, r in inp["levels"]]
    args = tuple(inp["head"]) + tuple(lvs) + tuple(inp["tail"])
    f = k12_bytes if inp["kernel"] == "fk_score" else k13_bytes
    return f(dict(args=args, R=inp["R"], K=inp["K"]))


def dirichlet_library(descs):
    """The PyTorch calls drawing the same Dirichlet rows or Beta pairs as
    a K22 call (torch._sample_dirichlet over each descriptor's alphas, a
    Beta pair as a two-entry row; no log, which K22 also takes in
    dirichlet_log mode), and how many calls that is; None where a
    descriptor draws plain gammas."""
    from . import ops

    if any(d["mode"] == "gamma" for d in descs):
        return None, 0
    alphas = [ops._desc_alpha(d).contiguous() for d in descs]
    return (lambda: [torch._sample_dirichlet(a) for a in alphas]), \
        len(alphas)


def census_shapes(path: str, kernel: str) -> list:
    """K14's or K23's census shapes from a chip_smoke.json (--out): every
    distinct shape checked on a path that holds >= 1% of that path's
    launches of the kernel, as (label with its launches by path, K14's
    mode and C, or K23's caps)."""
    with open(path) as f:
        rep = json.load(f)
    rows = next(k["shapes"] for k in rep["kernels"] if k["name"] == kernel)
    totals: dict = {}
    for r in rows:
        totals[r["path"]] = totals.get(r["path"], 0) + r["launches"]
    shapes: dict = {}
    for r in rows:
        if r["launches"] < 0.01 * totals[r["path"]]:
            continue
        key = (r["shape"], r["K"]) if kernel == "rel_scatter" else \
            tuple(r["caps"])
        shapes.setdefault(key, {})[r["path"]] = r["launches"]
    return [(f"{k[0]} K={k[1]} {by}" if kernel == "rel_scatter"
             else f"classes={len(k)} cap={max(k)} {by}", k)
            for k, by in shapes.items()]


def ab_seeded(dev, kinds, k21_shapes=None, census=None) -> dict:
    """The A/B's seeded K4-K8 inputs, {label: (kernel, inputs)}: K7 at
    AB_K7 (k7_seeded, one hop, as scaled's, rents' and hospital's hoisted
    histograms; per row at scaled's density of about 12 referrers a row;
    hospital's shapes also with its counts crowded into few cells), K4 at
    AB_K4 (k4_seeded), K5 at AB_K5 (k5_seeded; each shape twice, the step
    from the env coordinates and the kernel alone, k5_ab_call), K6 at
    AB_K6 (k6_inputs; the dense shape with about 24 referrers a slot, as
    flights' 100 flights over 2,376 rows), K8 at AB_K8 (k8_seeded) and K9
    at AB_K9 (k9_inputs, resample with the retained particle); K11 at
    every class of AB_K10's models (k11_ab_inputs), K21 at `k21_shapes`
    (k21_census_shapes) or AB_K21."""
    out = {}
    if "k19" in kinds:
        for label, B, pairs in AB_K19:
            out["K19 " + label] = ("branch_select", k19_inputs(
                dev, dict(B=B, pairs=pairs), len(pairs)))
    models = ab_models(dev) if {"k10", "k11"} & set(kinds) else {}
    if "k10" in kinds:
        out.update(k10_ab_inputs(models))
    if "k11" in kinds:
        out.update(k11_ab_inputs(models))
    if "k21" in kinds:
        for label, f, K in k21_shapes or AB_K21:
            out["K21 " + label] = ("py_prior", k21_inputs(dev, f, K))
    for kind, kernel, shapes in (("k16", "fk_sample", AB_K16),
                                 ("k17", "choice_sample", AB_K17)):
        if kind in kinds:
            for label, f, K in shapes:
                out[f"K{kind[1:]} {label}"] = (kernel, sample_inputs(
                    dev, kernel, f, K))
    for label, kernel, K, n, V in AB_SCORE:
        if f"k{12 if kernel == 'fk_score' else 13}" in kinds:
            inp = score_ab_inputs(dev, kernel, K, n, V)
            for form in ("pair", "fused"):
                out[f"{label} {form}"] = (kernel, dict(inp, form=form))
    if "k14" in kinds:
        for label, (mode, C) in census and census.get("rel_scatter") or \
                [(f"{m} K={C}", (m, C)) for m, C in AB_K14]:
            out["K14 " + label] = ("rel_scatter", k14_inputs(dev, mode, C))
    if "k23" in kinds:
        for label, caps in census and census.get("py_resample") or AB_K23:
            out["K23 " + label] = ("py_resample", k23_inputs(
                dev, dict(caps=list(caps))))
    if "k22" in kinds:
        for label, descs in AB_K22:
            out["K22 " + label] = ("gamma_draw",
                                   k22_inputs(dev, dict(descs=descs)))
    if "k18" in kinds:
        for label, N, chains, n in AB_K18:
            out["K18 " + label] = ("row_gather",
                                   k18_ab_inputs(dev, N, chains, n))
    if "k20" in kinds:
        for label, shape, x_shape, depth in AB_K20:
            out["K20 " + label] = ("level_sum",
                                   k20_ab_inputs(dev, shape, x_shape, depth))
        for label, K, n, V in AB_K20_GATHERS:
            out["K20 " + label] = ("level_sum",
                                   k20_gather_inputs(dev, K, n, V))
    if "k9" in kinds:
        for label, R, P, mode in AB_K9:
            out["K9 " + label] = ("pg_resample", k9_inputs(
                dev, R, P, mode, retained=mode == "resample"))
    if "k6" in kinds:
        for label, B, V, N, lists, kept in AB_K6:
            k6 = k6_inputs(dev, B, V, N, lists=lists,
                           per_slot=0 if lists else 24)
            if lists:
                k6["cnt"].fill_(kept)
            out["K6 " + label] = ("maybe_swap_ext", k6)
    if "k8" in kinds:
        for label, B, E, Vc, V, R, density, live in AB_K8:
            out["K8 " + label] = ("sa_ext_term", k8_seeded(
                dev, B, E, Vc, V, R, density=density, live=live))
    if "k7" in kinds:
        for label, G, V, R, per_row, density, skew in AB_K7:
            out["K7 " + label] = ("referrer_hist", k7_seeded(
                dev, G, V, R, per_row, density=density, skew=skew))
    if "k4" in kinds:
        label, R, cap, C = AB_K4
        out["K4 " + label] = ("gauss_suffstats", k4_seeded(dev, R, cap, C))
    if "k5" in kinds:
        for label, B, A, C in AB_K5:
            k5 = k5_seeded(dev, B, A, C)
            for part in ("step", "kernel"):
                out[f"K5 {part} {label}"] = ("gauss_ext_term",
                                             dict(k5=k5, part=part))
    return out


def ab_models(dev) -> dict:
    """{workload: (cm, engine, seeded arenas, params, refresh)} of every
    AB_K10 model, built by this checkout's package: K10's and K11's A/B
    inputs."""
    import importlib as il

    from .engine.compile import init_state
    from .engine.refresh import refresh
    from .engine.smc import Engine

    out = {}
    for _label, wl, _cid, kw in AB_K10:
        cm, cfg = il.import_module(f"{__package__}.workloads.{wl}").setup(
            **kw, device=dev)[:2]
        eng = Engine(cm, cfg, device=dev)
        arenas = row_state(cm, 5, device=dev)
        out[wl] = (cm, eng, arenas, init_state(cm, 0, device=dev)[1],
                   refresh(cm, arenas, eng.obs_dev))
    return out


def k10_ab_inputs(models: dict) -> dict:
    """K10's A/B inputs, {label: ("row_delta", inputs)}: each AB_K10 class
    on its model's seeded state (ab_models), at its first live slot, sign
    +1 and -1."""
    out = {}
    for label, wl, cid, _kw in AB_K10:
        cm, eng, arenas, _p, rel = models[wl]
        obs = eng.obs_dev
        slot = torch.nonzero(arenas[cid]["alive"])[:1].reshape(1)
        for sign in (1, -1):
            out[f"K10 {label} obs {sign:+d}"] = ("row_delta", dict(
                cm=cm, cid=cid, arenas=arenas, rel=rel, obs=obs, slot=slot,
                sign=sign))
    return out


def k11_ab_inputs(models: dict) -> dict:
    """K11's A/B inputs, {label: ("row_write", inputs)}: one row
    (row_cases: a real proposal's structure, seeded values, births and
    accept bit) of every class of each AB_K10 model, on its seeded state
    (ab_models), labelled by the census shape (class, births)."""
    out = {}
    for wl, (cm, eng, arenas, params, rel) in models.items():
        for cid in cm.model.class_order:
            s, env2, births, acc = row_cases(eng, arenas, params, rel, cid,
                                             1, seed=1)[0]
            out[f"K11 {wl} {cid} births {len(births)}"] = ("row_write", dict(
                cm=cm, cid=cid, arenas=arenas, slot=s, env2=env2,
                births=births, accept=acc))
    return out


def k11_ab_call(ops, inp: dict):
    """A call of the tree's K11 on a copy of inp's arenas (smc.own_carry),
    checked bit-equal against the plain version on a CPU copy after one
    call."""
    from .engine.smc import own_carry

    cm, cid = inp["cm"], inp["cid"]
    a, _r = own_carry(cm, cid, inp["arenas"])
    cpu = lambda t: t.cpu()  # noqa: E731
    ac = _tree_map(a, cpu)
    args = (inp["slot"], inp["env2"], inp["births"], inp["accept"])
    car = ops.RowCarry(cm, cid, a)
    ops.row_write(car, *args)
    ops.row_write_plain(ops.RowCarry(cm, cid, ac), args[0].cpu(),
                        _tree_map(args[1], cpu), _births_to(args[2], "cpu"),
                        args[3].cpu())
    torch.cuda.synchronize()
    bad = [n for n, x, y in _leaves(a, ac, "arenas")
           if not torch.equal(x.cpu(), y)]
    require(not bad, f"K11 differs from its plain version at {cid}: {bad}")
    return lambda: ops.row_write(car, *args)


def variant_ms(ops, kernel: str, inp: dict) -> dict:
    """K14 on each route that takes inp's spec, or K23 in every geometry
    of K23_VARIANTS (a class of more than 1,024 slots), with this
    checkout's kernels: each checked bit-equal to the plain version, then
    device_ms (graph_ms) and host_us; the plan's own launch beside them."""
    out = {}
    if kernel == "rel_scatter":
        if inp["kind"] == "cascade":
            return out
        _k, cnt, code, sides, n, slots = inp["args"][:6]
        out["plan"] = k14_plan(ops, inp)
        routes = ["thread"]
        if ops._k14_hist_spec(sides, code, slots) and \
                4 * cnt.shape[0] <= ops.K14_SMEM_MAX:
            routes.append("local")
        for route in routes:
            check_k14(ops, inp, route)
            x = _tree_map(inp, lambda t: t.clone())
            call = lambda: k14_launch(ops, x, route)  # noqa: E731
            out[route] = dict(device_ms=graph_ms(call),
                              host_us=host_us(call, 500))
    elif kernel == "py_resample":
        caps = [c["refcount"].shape[0] for c in inp["classes"]]
        out["plan"] = ops.py_resample_plan(caps)
        for cl, th in K23_VARIANTS if max(caps) > 1024 else ():
            check_k23(ops, inp, (cl, th))
            call = lambda: k23_launch(ops, inp, cl, th)  # noqa: E731
            out[f"cluster {cl} threads {th}"] = dict(
                device_ms=graph_ms(call), host_us=host_us(call, 500))
    return out


def k14_route_grid(ops, dev) -> dict:
    """Both K14 routes over K14_ROUTE_GRID's refcounts (k14_inputs: fk
    uniform over C = sources / per target, 3/4 alive), each checked
    bit-equal: {(n, per target): dict(thread, local device ms, plan's
    route)}."""
    out = {}
    for n, r in K14_ROUTE_GRID:
        C = n // r
        if 4 * C > ops.K14_SMEM_MAX:
            continue
        inp = k14_inputs(dev, f"refcount n={n} src={n} +1a:{n} -", C)
        row = dict(plan=k14_plan(ops, inp)["route"])
        for route in ("thread", "local"):
            check_k14(ops, inp, route)
            x = _tree_map(inp, lambda t: t.clone())
            row[route] = graph_ms(lambda: k14_launch(ops, x, route))
        out[(n, r)] = row
    return out


def k21_census_shapes(path: str) -> list:
    """K21's census shapes from a chip_smoke.json (--out): every distinct
    (mode, K) checked on a path (each holds >= 1% of that path's K21
    launches), as (label with its launches by path, fields, K), the
    fields' dtypes read back from their names."""
    with open(path) as f:
        rep = json.load(f)
    rows = next(k["shapes"] for k in rep["kernels"]
                if k["name"] == "py_prior")
    shapes: dict = {}
    for r in rows:
        if "fields" not in r:
            continue
        f = dict(r["fields"])
        f["full"] = tuple(f["full"])
        f["counts"] = tuple(getattr(torch, str(d).split(".")[-1])
                            for d in f["counts"])
        sh = shapes.setdefault((r["shape"], r["K"]), dict(f=f, by={}))
        sh["by"][r["path"]] = r["launches"]
    return [(f"{mode} K={K} {sh['by']}", sh["f"], K)
            for (mode, K), sh in shapes.items()]


def k10_ab_call(ops, inp: dict, check: bool = True):
    """A call of the tree's K10 on a copy of inp's carry (the model's
    cached plans dropped first: each tree builds its own), checked
    bit-equal against the plain version on a CPU copy after one call."""
    from .engine.smc import own_carry

    cm, cid = inp["cm"], inp["cid"]
    cm.__dict__.pop("_row_plans", None)
    a, r = own_carry(cm, cid, inp["arenas"], inp["rel"])
    car = ops.RowCarry(cm, cid, a, r, inp["obs"])
    s, sign = inp["slot"], inp["sign"]
    if check:
        cpu = lambda t: t.cpu()  # noqa: E731
        ac, rc = _tree_map(a, cpu), _tree_map(r, cpu)
        ops.row_delta(car, s, sign, "obs")
        ops.row_delta_plain(ops.RowCarry(cm, cid, ac, rc,
                                         _tree_map(inp["obs"], cpu)),
                            s.cpu(), sign, "obs")
        torch.cuda.synchronize()
        bad = [n for n, x, y in _leaves(a, ac, "arenas") + _leaves(r, rc,
                                                                  "rel")
               if not torch.equal(x.cpu(), y)]
        require(not bad, f"K10 differs from its plain version at {cid} "
                f"{sign:+d}: {bad}")
    return lambda: ops.row_delta(car, s, sign, "obs")


def ab_outputs(ops, kernel: str, inp: dict) -> list:
    """K9's or K22's outputs on inp, on the host (the A/B holds every
    tree's to the first tree's, bit for bit)."""
    if kernel == "pg_resample":
        got = ops.pg_resample(inp["ws"], inp["u"], inp["mode"],
                              inp["retained"])
    else:
        got = ops.gamma_draw(inp["descs"], inp["seed"])
    return [x.cpu() for x in got if x is not None]


def time_ab_seeded(ops, kernel: str, inp: dict) -> dict:
    """One A/B turn of K4, K5, K6, K7 or K8 on `inp`: checked against the
    plain version, then ms (cuda_ms) and device_ms (graph_ms), with the
    library call beside them (K7: torch.bincount, events only; K4: zeros
    and index_add_, both; K5, K6 and K8 have none). K5's `inp` is dict(k5,
    part): the tree's whole step from the env coordinates, or its kernel
    alone on a prebuilt index (k5_ab_call). K9 has no library call. K18
    (k18_ab_call: one group launch, or a launch a chain) and K20, checked
    bit-equal to the plain versions, add host_us, each beside its library
    call where there is one (K18 one chain: torch.take of the leaf at the
    clamped slots; K18 a group of five, and K20: none)."""
    if kernel in ("fk_sample", "choice_sample"):
        check_sample(ops, inp)
        x = _clone_inputs(inp)
        call = lambda: _sample_call(ops, x)  # noqa: E731
        return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                    host_us=host_us(call), library_ms=None,
                    library_device_ms=None)
    if kernel == "branch_select":   # one pair: beside torch.where
        check_sample(ops, inp)
        x = _clone_inputs(inp)
        call = lambda: _sample_call(ops, x)  # noqa: E731
        lib = sample_library(x)
        return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                    host_us=host_us(call),
                    library_ms=lib and cuda_ms(lib),
                    library_device_ms=lib and graph_ms(lib),
                    library_host_us=lib and host_us(lib))
    if kernel in ("row_delta", "row_write"):
        call = (k10_ab_call if kernel == "row_delta" else k11_ab_call)(ops,
                                                                       inp)
        return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                    host_us=host_us(call), library_ms=None,
                    library_device_ms=None)
    if kernel == "rel_scatter":   # in place: the calls accumulate
        check_k14(ops, inp)
        x = _tree_map(inp, lambda t: t.clone())
        call = lambda: _k14_call(ops, x)  # noqa: E731
        return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                    host_us=host_us(call, 500), library_ms=None,
                    library_device_ms=None)
    if kernel == "py_resample":
        check_k23(ops, inp)
        call = lambda: ops.py_resample(inp["classes"], inp["seed"])  # noqa
        return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                    host_us=host_us(call, 500), library_ms=None,
                    library_device_ms=None)
    if kernel == "py_prior":
        check_level(ops, inp)
        call = lambda: _level_call(ops, inp)  # noqa: E731
        return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                    host_us=host_us(call, 500), library_ms=None,
                    library_device_ms=None)
    if kernel == "row_gather":
        call = k18_ab_call(ops, inp)
        got = call()
        s, chains = inp["slot"], inp["chains"]
        want = [ops.row_gather_plain(s, h, leaf) for h, leaf in chains]
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                "K18 differs from its plain version in the A/B")
        lib = None
        if len(chains) == 1:
            leaf = chains[0][1]
            t = s.long().clamp(0, leaf.shape[0] - 1)
            lib = lambda: torch.take(leaf, t)  # noqa: E731
        return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                    host_us=host_us(call),
                    library_ms=None if lib is None else cuda_ms(lib),
                    library_device_ms=None if lib is None else graph_ms(lib),
                    library_host_us=None if lib is None else host_us(lib))
    if kernel in ("fk_score", "choice_score"):
        call = score_ab_call(ops, inp, inp["form"] == "fused")
        if call is None:
            return None
        r1, z1 = call()
        pl = [ops.level_sum_plain(ops.level_program(p), o, r)
              for p, o, r in inp["levels"]]
        r0, z0 = getattr(ops, kernel + "_plain")(*inp["head"], *pl,
                                                 *inp["tail"])
        torch.cuda.synchronize()
        d = (z1 - z0).abs()
        scale = torch.maximum(z0.abs(), r0.amax(-1).abs())
        require(torch.equal(r1, r0) and bool(((d <= 1e-6 * scale)
                                              | (z1 == z0)).all()),
                f"{kernel} {inp['form']} differs from its plain version in "
                f"the A/B")
        return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                    host_us=host_us(call), library_ms=None,
                    library_device_ms=None)
    if kernel == "gamma_draw":
        check_k22(ops, inp)
        t = time_k22(ops, inp)
        t.pop("plain_ms")
        t["host_us"] = host_us(lambda: ops.gamma_draw(inp["descs"],
                                                      inp["seed"]))
        alpha = _k22_alpha(inp["descs"])
        t["library_host_us"] = host_us(lambda: torch._standard_gamma(alpha))
        return t
    if kernel == "level_sum":   # the code as the tree's tracer folds it
        args = (ops.level_program(inp["prog"]), inp["operands"], inp["rank"])
        call = lambda: ops.level_sum(*args, B=1, label="ab")  # noqa: E731
        got, want = call(), ops.level_sum_plain(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want), "K20 differs from its plain version "
                "in the A/B")
        return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                    host_us=host_us(call), library_ms=None,
                    library_device_ms=None)
    if kernel == "pg_resample":
        check_k9(ops, inp)
        t = time_k9(ops, inp)
        t.pop("plain_ms")
        t["host_us"] = host_us(lambda: ops.pg_resample(
            inp["ws"], inp["u"], inp["mode"], inp["retained"]))
        return t
    if kernel == "gauss_ext_term":
        call = k5_ab_call(ops, inp["k5"], inp["part"])
        k5_error(inp["k5"], call())
        return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                    library_ms=None, library_device_ms=None)
    if kernel in ("maybe_swap_ext", "sa_ext_term"):
        (check_k6 if kernel == "maybe_swap_ext" else check_k8)(ops, inp)
        fn = getattr(ops, kernel)
        call = lambda: fn(**inp)  # noqa: E731
        return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                    library_ms=None, library_device_ms=None)
    if kernel == "referrer_hist":
        check_k7(ops, inp)
        fn = lambda: ops.referrer_hist(**inp)  # noqa: E731
        cells, n = k7_flat(inp)
        lib = lambda: torch.bincount(cells, minlength=n)  # noqa: E731
        return dict(ms=cuda_ms(fn), device_ms=graph_ms(fn),
                    library_ms=cuda_ms(lib), library_device_ms=None)
    check_k4(ops, inp)
    fn = lambda: ops.gauss_suffstats(**inp)  # noqa: E731
    lib = k4_library(inp)
    check_k4_library(ops, inp, lib)
    return dict(ms=cuda_ms(fn), device_ms=graph_ms(fn),
                library_ms=cuda_ms(lib), library_device_ms=graph_ms(lib))


# bench.py's hospital configuration, whose launch census --census replays
# (chip_smoke.py's hospital_pg1024 path runs it with PG, the same shapes)
HOSPITAL_PATH = dict(rows=1000, repeat=100, batch=4096)


def hospital_census(kinds=("k7", "k8"), device="cuda",
                    path: dict = HOSPITAL_PATH) -> dict:
    """K7's and K8's inputs (of those in `kinds`) at every shape of the
    hospital path's launch census, {label: (kernel, inputs)}: the path run
    as chip_smoke.py runs its paths (`path`; init_state, Engine.initialize,
    Engine.run, with this checkout's package and its launch counts set to
    0 just before), then `k7_census_inputs` and `k8_census_inputs` on its
    state."""
    from . import ops
    from .engine.compile import init_state
    from .engine.smc import Engine
    from .workloads import hospital

    cm, config = hospital.setup(**path, device=device)[:2]
    ops.reset_counts()
    arenas, params = init_state(cm, 0, device=device)
    eng = Engine(cm, config, device=device)
    arenas, params, gen = eng.initialize(1, arenas, params)
    arenas, params, gen = eng.run(gen, arenas, params)
    out = {}
    census = ops.census()
    if "k7" in kinds:
        for r, cid, k in k7_census_inputs(eng, arenas, params, census,
                                          path["batch"]):
            G = k.get("cap") or k["w"].shape[0]
            out[f"K7 hospital census {cid} {r['mode']} {r['rows']} [{G}, "
                f"{k['V']}] ({r['launches']} launches)"] = ("referrer_hist",
                                                            k)
    if "k8" in kinds:
        for r, cid, k in k8_census_inputs(eng, arenas, params, census,
                                          path["batch"]):
            out[f"K8 hospital census {cid} {r['rows']} [{k['w'].shape[0]}, "
                f"{k['SA'].shape[0]}] ({r['launches']} launches, "
                f"{int(k['w'].sum())} kept)"] = ("sa_ext_term", k)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--turns", default="0,1,1,0")
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernels", default=",".join(AB_KINDS),
                    help="which kernels the turns time, of "
                         f"{','.join(AB_KINDS)} (default all)")
    ap.add_argument("--paths", action="store_true",
                    help="also time every path of K1's plan at every K1 "
                         "shape and over PATH_GRID_R x PATH_GRID_K in both "
                         "modes, with the last tree's kernels")
    ap.add_argument("--geometries", action="store_true",
                    help="also time K16 and K17 (those in --kernels) in "
                         "every draw geometry that takes each A/B shape, "
                         "with the last tree's kernels (draw_plan's "
                         "thresholds come from it)")
    ap.add_argument("--k21-shapes", default=None,
                    help="a chip_smoke.json (chip_smoke.py --out): time K21 "
                         "at every census shape it checked, in place of "
                         "AB_K21")
    ap.add_argument("--census-shapes", default=None,
                    help="a chip_smoke.json (chip_smoke.py --out): time K14 "
                         "and K23 at every census shape it checked that "
                         "holds >= 1%% of a path's launches, in place of "
                         "AB_K14 and AB_K23")
    ap.add_argument("--routes", action="store_true",
                    help="also time K14 on both routes at each A/B shape "
                         "that takes them and over K14_ROUTE_GRID, and K23 "
                         "in every geometry of K23_VARIANTS, with the last "
                         "tree's kernels")
    ap.add_argument("--builds", default=None,
                    help="also time one nvcc of each of these kernels' "
                         "sources alone (comma-separated names, e.g. "
                         "gamma_draw,pg_resample), every tree in the order "
                         "of --turns (source_build_s)")
    ap.add_argument("--census", choices=("hospital",), default=None,
                    help="also time K7 and K8 (those in --kernels) at every "
                         "shape of the hospital path's launch census, on "
                         "inputs from its state (runs the path first, about "
                         "4 minutes)")
    a = ap.parse_args(argv)
    kinds = a.kernels.split(",")
    if not set(kinds) <= set(AB_KINDS) or (a.paths and "k1-k3" not in kinds) \
            or (a.census and not {"k7", "k8"} & set(kinds)):
        ap.error(f"--kernels takes {AB_KINDS}; --paths needs k1-k3; "
                 f"--census needs k7 or k8")
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device available", file=sys.stderr)
        return 1
    from . import ops as own
    from .workloads import scaled

    dev = torch.device("cuda")
    tree_ops = [_load_tree_ops(t, f"_tree{i}_pclean_tpu_torch")
                for i, t in enumerate(a.trees)]
    for t, o in zip(a.trees, tree_ops):
        print(f"{t}: kernel build {o.build_kernels():.2f} s", flush=True)
    builds = []
    for t in [int(x) for x in a.turns.split(",")] if a.builds else ():
        for name in a.builds.split(","):
            sec = source_build_s(tree_ops[t], name)
            builds.append(dict(tree=a.trees[t], kernel=name, s=sec))
            print(f"build alone: {a.trees[t]} {name} {sec:.2f} s",
                  flush=True)
    shapes, k1s, bounds = {}, {}, {}
    B = 4096
    if "k1-k3" in kinds:
        # chip_smoke.py's main path: the scaled workload's entity counts,
        # 100,000 rows, batch_rows 4096
        cm = scaled.setup(rows=100_000, batch=B, device="cuda")[0]
        shapes = {"batch": main_path_inputs(cm, dev, B),
                  "r1": main_path_inputs(cm, dev, 1),
                  "b66": main_path_inputs(cm, dev, 66),
                  "b1024": main_path_inputs(cm, dev, 1024)}
        bounds = {s: {k: v / HBM_BYTES_PER_S * 1e3
                      for k, v in kernel_bytes(inp).items()}
                  for s, inp in shapes.items()}
        # K1 (and K2 on its record) at the main path's other shapes
        for mode, K in k1_shapes(cm):
            for R in (1, B):
                if (mode, K) != ("fk", shapes["batch"]["K"]):
                    k1s[f"{mode} K={K} R={R}"] = k1_inputs(dev, R, K, mode)
        for s, inp in k1s.items():
            R, K, mode = inp["R"], inp["K"], inp["mode"]
            bounds[s] = {
                "enum_logsumexp": k1_bytes(R, K, mode) / HBM_BYTES_PER_S
                * 1e3,
                "inv_cdf_sample": k2_bytes(R, inp["logits"].shape[1])
                / HBM_BYTES_PER_S * 1e3}
    seeded = ab_seeded(dev, kinds, a.k21_shapes and k21_census_shapes(
        a.k21_shapes), a.census_shapes and {
            k: census_shapes(a.census_shapes, k)
            for k in ("rel_scatter", "py_resample")})
    seeded.update(hospital_census(kinds) if a.census else {})
    count_bytes = {"referrer_hist": k7_bytes, "gauss_suffstats": k4_bytes,
                   "gauss_ext_term": lambda inp: k5_bytes(inp["k5"]),
                   "maybe_swap_ext": k6_bytes, "sa_ext_term": k8_bytes,
                   "pg_resample": lambda inp: k9_bytes(*inp["ws"].shape,
                                                       inp["mode"]),
                   "row_gather": lambda inp: inp["slot"].numel() * (
                       4 + 8 * len(inp["chains"])),
                   "level_sum": lambda inp: level_bytes(dict(
                       kernel="level_sum", args=(inp["prog"],
                                                 inp["operands"],
                                                 inp["rank"]))),
                   "fk_score": score_ab_bytes,
                   "choice_score": score_ab_bytes,
                   "gamma_draw": lambda inp: k22_bounds(inp)["bytes"],
                   "fk_sample": sample_bytes,
                   "choice_sample": sample_bytes,
                   "branch_select": sample_bytes,
                   "row_delta": lambda inp: k10_bytes(own.row_delta_plan(
                       inp["cm"], inp["cid"], "obs")),
                   "row_write": lambda inp: k11_bytes(own.row_write_writes(
                       own.RowCarry(inp["cm"], inp["cid"], inp["arenas"]),
                       inp["slot"], inp["env2"], inp["births"],
                       inp["accept"], False)),
                   "py_prior": level_bytes,
                   "rel_scatter": k14_bytes,
                   "py_resample": lambda inp: k23_bounds(inp)["bytes"]}
    for s, (k, inp) in seeded.items():
        bounds[s] = {k: count_bytes[k](inp) / HBM_BYTES_PER_S * 1e3}
    turns, same_outputs = [], {}

    def log(tree, s, k, times):
        turns.append(dict(tree=tree, shape=s, kernel=k, **times))
        print(f"turn {len(turns)}: {tree} {s} {k} {times}", flush=True)

    for t in [int(x) for x in a.turns.split(",")]:
        ops = tree_ops[t]
        for s, inp in shapes.items():
            check_k1(ops, inp["exist"], inp["new"])
            check_k1(ops, inp["exist"], None)
            check_k3(ops, inp["mats"], inp["obs"], inp["word"])
            check_k2(ops, inp["logits"], inp["u"])
            times = time_kernels(ops, inp, plain=False, library=False)
            for k in KERNELS:
                log(a.trees[t], s, k, times[k])
        for s, inp in k1s.items():
            check_k1(ops, inp["exist"], inp["new"])
            check_k1(ops, inp["exist"], None)
            check_k2(ops, inp["logits"], inp["u"])
            times = time_k1(ops, inp, plain=False)
            log(a.trees[t], s, "enum_logsumexp",
                dict(ms=times["ms"], device_ms=times["device_ms"]))
            log(a.trees[t], s, "inv_cdf_sample",
                dict(ms=times["k2_ms"], device_ms=times["k2_device_ms"]))
        for s, (k, inp) in seeded.items():
            times = time_ab_seeded(ops, k, inp)
            if times is not None:   # (a form the tree does not have)
                log(a.trees[t], s, k, times)
            if k in ("pg_resample", "gamma_draw"):
                same_outputs.setdefault(s, {})[a.trees[t]] = ab_outputs(
                    ops, k, inp)
    # K9 and K22 give every tree's kernel the same bits
    for s, by_tree in same_outputs.items():
        first = next(iter(by_tree.values()))
        require(all(len(o) == len(first) and all(
            torch.equal(x, y) for x, y in zip(o, first))
            for o in by_tree.values()), f"{s}: the trees' outputs differ")
        print(f"{s}: outputs bit-equal across {len(by_tree)} trees",
              flush=True)
    # K9's and K22's plans and latency bounds (this checkout's)
    latency = {}
    if {"k9", "k22"} & set(kinds):
        floor, l2, sass = launch_floor_ms(), l2_latency_ms(), k23_sass(own)
        print(f"SASS shortest paths (instructions): "
              f"{ {k: v for k, v in sass.items() if k != 'all'} }",
              flush=True)
        for s, (k, inp) in seeded.items():
            if k == "pg_resample":
                R, P = inp["ws"].shape
                chain = k9_chain(sass, P, inp["mode"])
                plan = own.pg_resample_plan(R, P)
            elif k == "gamma_draw":
                chain = k22_chain(sass, inp["descs"])
                plan = [dict(threads=L["threads"], rows=len(L["rows"]),
                             parts=[p[2:] for p in L["parts"]])
                        for L in own.gamma_draw_plan(
                            [(d["mode"], d["rows"], d["width"])
                             for d in inp["descs"]])]
            else:
                continue
            latency[s] = dict(chain=chain, plan=plan, latency_bound_ms=(
                latency_bound_ms(chain, floor, l2)), floor_ms=floor,
                l2_ms=l2)
    summary = {}
    for tree in a.trees:
        for s, kb in bounds.items():
            for k in kb:
                rows = [r for r in turns if r["tree"] == tree
                        and r["shape"] == s and r["kernel"] == k]
                if not rows:
                    continue
                dev_ms = [r["device_ms"] for r in rows]
                summary[f"{tree} {s} {k}"] = dict(
                    ms=[r["ms"] for r in rows], device_ms=dev_ms,
                    dirichlet_device_ms=[r.get("dirichlet_device_ms")
                                         for r in rows],
                    host_us=[r.get("host_us") for r in rows],
                    library_host_us=[r.get("library_host_us")
                                     for r in rows],
                    library_ms=[r.get("library_ms") for r in rows],
                    library_device_ms=[r.get("library_device_ms")
                                       for r in rows],
                    bound_ms=kb[k],
                    share_of_bound=kb[k] / float(np.median(dev_ms)),
                    **latency.get(s, {}))
    fmt = lambda xs: [x if x is None else "%.4f" % x  # noqa: E731
                      for x in xs]
    for key, v in summary.items():
        print(f"{key}: ms {fmt(v['ms'])} device_ms {fmt(v['device_ms'])} "
              f"host_us {fmt(v['host_us'])} library host_us "
              f"{fmt(v['library_host_us'])} "
              f"library ms {fmt(v['library_ms'])} library device_ms "
              f"{fmt(v['library_device_ms'])} _sample_dirichlet device_ms "
              f"{fmt(v['dirichlet_device_ms'])} bound {v['bound_ms']:.5f} ms "
              f"share of bound (device) {v['share_of_bound']:.3f}"
              + (f" latency bound {v['latency_bound_ms']:.5f} ms (chain "
                 f"{v['chain']} instructions) plan {v['plan']}"
                 if "latency_bound_ms" in v else ""))
    # yardsticks (never called by the port), and with --paths K1's paths
    k1_all = dict(k1s, **{"fk K=%d R=%d" % (shapes[s]["K"], shapes[s]["B"]):
                          shapes[s] for s in ("batch", "r1") if s in shapes})
    floor = launch_floor_ms()
    yard = {s: dict(library_device_ms=graph_ms(
        lambda: torch.logsumexp(inp["logits"], dim=1)))
        for s, inp in k1_all.items()}
    print(f"launch floor (one PyTorch op on one element): {floor:.4f} ms")
    blocks = {}
    if {"k10", "k19"} & set(kinds):   # this checkout's probe
        blocks = param_block_ms()
        print(param_block_lines(blocks), flush=True)
    for s, y in yard.items():
        print(f"{s}: torch.logsumexp device {y['library_device_ms']:.4f} ms")
    geos = {}
    if a.geometries:
        sweep = dict(seeded)
        for kind, kernel, shapes in (("k16", "fk_sample", SWEEP_K16),
                                     ("k17", "choice_sample", SWEEP_K17)):
            if kind in kinds:
                for label, f, K in shapes:
                    sweep[f"K{kind[1:]} {label}"] = (kernel, sample_inputs(
                        dev, kernel, f, K))
        for s, (k, inp) in sweep.items():
            if k in ("fk_sample", "choice_sample"):
                geos[s] = geometry_ms(tree_ops[-1], inp)
                print(f"geometries {s}: " + " ".join(
                    f"{g} {v['device_ms']:.4f} ms / {v['host_us']:.1f} us"
                    for g, v in geos[s].items() if g != "plan")
                    + f" plan {geos[s]['plan']}", flush=True)
    routes = {}
    if a.routes:
        for s, (k, inp) in seeded.items():
            if k in ("rel_scatter", "py_resample"):
                routes[s] = variant_ms(tree_ops[-1], k, inp)
                print(f"routes {s}: " + " ".join(
                    f"{v} {r['device_ms']:.5f} ms / {r['host_us']:.1f} us"
                    for v, r in routes[s].items() if v != "plan")
                    + f" plan {routes[s].get('plan')}", flush=True)
        if "k14" in kinds:
            grid = k14_route_grid(tree_ops[-1], dev)
            for (n, r), row in grid.items():
                print(f"route grid refcount n={n} C={n // r} ({r} a "
                      f"target): thread {row['thread']:.4f} local "
                      f"{row['local']:.4f} ms plan {row['plan']}",
                      flush=True)
            routes["grid"] = {f"{n} {r}": row for (n, r), row in grid.items()}
        if "k23" in kinds:
            sass = k23_sass(tree_ops[-1])
            print(f"K23 SASS shortest paths: lgammaf {sass['lgammaf']} logf "
                  f"{sass['logf']} instructions (of {sass['all']})",
                  flush=True)
    paths = {}
    if a.paths:
        ops = tree_ops[-1]
        for s, inp in k1_all.items():
            R, K = inp["exist"].shape
            mode = "choice" if inp["new"] is None else "fk"
            paths[s] = dict(plan=ops.enum_logsumexp_plan(R, K, mode),
                            bound_ms=k1_bytes(R, K, mode)
                            / HBM_BYTES_PER_S * 1e3,
                            **k1_path_ms(ops, inp))
            print(f"paths {s}: {paths[s]}", flush=True)
        for mode in ("fk", "choice"):
            for R in PATH_GRID_R:
                for K in PATH_GRID_K:
                    inp = k1_inputs(dev, R, K, mode)
                    s = f"grid {mode} K={K} R={R}"
                    paths[s] = dict(plan=ops.enum_logsumexp_plan(R, K, mode),
                                    bound_ms=k1_bytes(R, K, mode)
                                    / HBM_BYTES_PER_S * 1e3,
                                    **k1_path_ms(ops, inp))
                    print(f"paths {s}: " + " ".join(
                        f"{p} {paths[s][p]:.4f}" for p in ops.K1_PATHS)
                        + f" plan {paths[s]['plan']['path']}", flush=True)
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "kernel_ab.json"), "w") as f:
            json.dump(dict(card=torch.cuda.get_device_name(0), turns=turns,
                           summary=summary, launch_floor_ms=floor,
                           yardsticks=yard, paths=paths, geometries=geos,
                           routes=routes, param_blocks=blocks,
                           builds=builds),
                      f, indent=1)
    return 0



# ------------------------------------------------------------ K16-K19

SAMPLE_KERNELS = ("fk_sample", "choice_sample", "row_gather",
                  "branch_select")
_ANC_AXIS = 3   # each ancestor axis of a seeded record


def _seeded_rec(rng, B: int, d: int, V: int, dead: float = 0.3):
    """A float32 record [B, 3 x d, V] of normal logits with a share `dead`
    at NEG_INF (at least one live entry a row), and d ancestors [B]."""
    x = rng.standard_normal((B,) + (_ANC_AXIS,) * d + (V,)) \
        .astype(np.float32) * 2
    x[rng.random(x.shape) < dead] = -1e30
    live = rng.integers(0, V, x.shape[:-1])
    np.put_along_axis(x, live[..., None], 1.0, axis=-1)
    anc = [rng.integers(0, _ANC_AXIS, B).astype(np.int32) for _ in range(d)]
    return x, anc


def k16_inputs(dev, f: dict, K1: int, seed: int = 0) -> dict:
    """Seeded inputs of a K16 census shape (its ops.CENSUS_FIELDS `f`) at
    K + 1 = K1 logits: a record [B, 3 x d, K1] (30% of it NEG_INF),
    ancestors in [0, 3), uniforms, a gate 0.8; the working mask in the
    shape's form, 60% alive: shared, the class's [cap] mask and a separate
    [B, cap] buffer; own, a [B, cap] mask and the buffer; inplace, the
    buffer itself; in the last two one row in ten (and the first) full, so
    the full-arena guard takes the argmax; the retained form's stored
    slots (2% past cap) and relational alive (0.7) and refcounts (0-3);
    comp: the live slots first, padded with cap, and its inverse.
    dict(mode, args, kwargs)."""
    rng = np.random.default_rng(seed)
    B, cap, K = f["B"], f["cap"], K1 - 1
    rec, anc = _seeded_rec(rng, B, f["d"], K1)

    def t(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dt)

    if f["mask"] == "shared":
        mask_in = t(rng.random(cap) < 0.6, torch.bool)
        mask_out = torch.zeros((B, cap), dtype=torch.bool, device=dev)
    else:
        mask = rng.random((B, cap)) < 0.6
        full = rng.random(B) < 0.1
        full[0] = True
        mask[full] = True
        mask_in = t(mask, torch.bool)
        mask_out = mask_in if f["mask"] == "inplace" else \
            torch.zeros((B, cap), dtype=torch.bool, device=dev)
    kw = dict(comp=None)
    if f["comp"]:
        live = np.flatnonzero(rng.random(cap) < 0.7)[:K]
        idx = np.full(K, cap, np.int64)
        idx[:len(live)] = live
        inv = np.full(cap, K, np.int64)
        inv[live] = np.arange(len(live))
        kw["comp"] = (t(idx, torch.int64), t(inv, torch.int64))
    if f["form"] == "retained":
        rv = rng.integers(0, cap, B)
        rv[rng.random(B) < 0.02] = cap + 1
        kw.update(rv=t(rv, torch.int32),
                  rel_alive=t(rng.random(cap) < 0.7, torch.bool),
                  rel_refcount=t(rng.integers(0, 4, cap), torch.int32))
    else:
        kw["u"] = t(rng.random(B), torch.float32)
    return dict(mode=f, kernel="fk_sample", args=(
        t(rec, torch.float32), tuple(t(a, torch.int32) for a in anc),
        t(rng.random(B) < 0.8, torch.bool), mask_in, mask_out), kwargs=kw)


def k17_inputs(dev, f: dict, V: int, seed: int = 0) -> dict:
    """Seeded inputs of a K17 census shape (its ops.CENSUS_FIELDS `f`):
    draw and retained, a record
    [B, 3 x d, V] (30% NEG_INF), uniforms or stored values in [0, V + 2)
    (past the options: clamped) with the dummy code V - 1; pick, a record
    [B, 3 x d] of the census dtype. dict(mode, args, kwargs)."""
    rng = np.random.default_rng(seed)
    B, d = f["B"], f.get("d", 0)

    def t(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dt)

    if f["form"] == "group":
        return k17_group_inputs(dev, f, seed)
    if f["form"] == "pick":
        rec = rng.integers(0, 100, (B,) + (_ANC_AXIS,) * d) \
            if not f["dtype"].is_floating_point else \
            rng.random((B,) + (_ANC_AXIS,) * d)
        anc = [rng.integers(0, _ANC_AXIS, B) for _ in range(d)]
        return dict(mode=f, kernel="choice_sample", args=(
            t(rec, f["dtype"]), tuple(t(a, torch.int32) for a in anc), B),
            kwargs=dict(mode="pick"))
    rec, anc = _seeded_rec(rng, B, d, V)
    kw = dict(mode=f["form"])
    if f["form"] == "retained":
        kw.update(rv=t(rng.integers(0, V + 2, B), torch.int32),
                  dummy=V - 1)
    else:
        kw["u"] = t(rng.random(B), torch.float32)
    return dict(mode=f, kernel="choice_sample", args=(
        t(rec, torch.float32), tuple(t(a, torch.int32) for a in anc), B),
        kwargs=kw)


def k17_group_inputs(dev, f: dict, seed: int = 0) -> dict:
    """Seeded inputs of a K17 group (fields form "group", B, Vs and each
    record's rows): a record [rows_m, V_m] a member (_seeded_rec, 30%
    NEG_INF), a pool [B, n + 3] of uniforms and the members' columns, a
    shuffled subset. dict(mode, group True, args (recs, pool, cols))."""
    rng = np.random.default_rng(seed)
    B, Vs = f["B"], f["Vs"]
    rows = f.get("rows") or (B,) * len(Vs)
    recs = [torch.as_tensor(_seeded_rec(rng, r, 0, V)[0], device=dev)
            for r, V in zip(rows, Vs)]
    n = len(Vs) + 3
    pool = torch.as_tensor(rng.random((B, n)).astype(np.float32),
                           device=dev)
    cols = [int(c) for c in rng.permutation(n)[:len(Vs)]]
    return dict(mode=f, kernel="choice_sample", group=True,
                args=(recs, pool, cols), kwargs={})


def k18_inputs(dev, f: dict, N: int, seed: int = 0) -> dict:
    """Seeded inputs of a K18 census shape (its ops.CENSUS_FIELDS `f`: the
    launch's distinct columns `cols` and its chains over them, or one
    chain through every column where `chains` is absent) at N slots: each
    column that is some chain's hop of the census's dtype and length with
    values over the column each chain reads next (2% past it), a leaf of
    its dtype (ints 0-99, floats in [0, 4)), slots int32 [N] over the
    first chain's first column (1% past it). dict(mode, args: (slot,
    chains))."""
    rng = np.random.default_rng(seed)
    cols = f["cols"]
    chains = f.get("chains") or [(tuple(range(len(cols) - 1)),
                                  len(cols) - 1)]
    nxt = {}
    for hops, leaf in chains:
        for a, b in zip(hops, hops[1:] + (leaf,)):
            nxt.setdefault(a, cols[b][1])

    def t(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dt)

    out = []
    for j, (dt, n) in enumerate(cols):
        if j in nxt:
            hi = nxt[j]
            v = rng.integers(0, hi, n)
            v[rng.random(n) < 0.02] = hi + 1
        else:
            v = rng.random(n) * 4 if dt.is_floating_point \
                else rng.integers(0, 100, n)
        out.append(t(v, dt))
    hops0, leaf0 = chains[0]
    n0 = cols[(hops0 + (leaf0,))[0]][1]
    s = rng.integers(0, n0, N)
    s[rng.random(N) < 0.01] = n0 + 2
    return dict(mode=f, kernel="row_gather", args=(
        t(s, torch.int32), [([out[j] for j in hops], out[leaf])
                            for hops, leaf in chains]))


def k19_inputs(dev, f: dict, n_pairs: int, seed: int = 0) -> dict:
    """Seeded inputs of a K19 census shape (its ops.CENSUS_FIELDS `f`):
    is_new 0.5 over B rows, each
    pair's values [B] of its dtypes (ints 0-99, floats in [-4, 4),
    bools 0.5). dict(mode, args)."""
    rng = np.random.default_rng(seed)
    B = f["B"]

    def draw(dt):
        if dt == torch.bool:
            v = rng.random(B) < 0.5
        elif dt.is_floating_point:
            v = rng.random(B) * 8 - 4
        else:
            v = rng.integers(0, 100, B)
        return torch.as_tensor(v, device=dev).to(dt)

    return dict(mode=f, kernel="branch_select", args=(
        torch.as_tensor(rng.random(B) < 0.5, device=dev),
        [(draw(a), draw(b)) for a, b in f["pairs"]]))


def sample_inputs(dev, kernel: str, f: dict, K: int, seed: int = 0):
    """Seeded inputs of a K16-K19 census shape: `f` its fields
    (ops.CENSUS_FIELDS[kernel][mode]), K its census K."""
    return {"fk_sample": k16_inputs, "choice_sample": k17_inputs,
            "row_gather": k18_inputs, "branch_select": k19_inputs}[kernel](
        dev, f, K, seed)


def _sample_call(ops, inp: dict, plain: bool = False, draw=None,
                 geometry=None):
    """One K16-K19 call on `inp` (the plain version with `plain`, its draw
    `draw` where it draws; K16's and K17's draws in `geometry`, else the
    plan's); returns the tensors it wrote. A K17 group in a tree without
    the group mode is a launch a member."""
    k, a = inp["kernel"], inp["args"]
    geo = {} if geometry is None else dict(geometry=geometry)
    if k == "fk_sample":
        if plain:
            out = ops.fk_sample_plain(*a, draw=draw, **inp["kwargs"])
        else:
            out = ops.fk_sample(*a, **inp["kwargs"], **geo)
        return list(out) + [a[4]]
    if k == "choice_sample" and inp.get("group"):
        recs, pool, cols = a
        B = pool.shape[0]
        if plain:   # choice_sample_group_plain, in either tree
            return [torch.stack([ops.choice_sample_plain(
                r, (), B, u=pool[:, c], draw=draw)
                for r, c in zip(recs, cols)])]
        if not hasattr(ops, "choice_sample_group"):
            return [ops.choice_sample(r, (), B, u=pool[:, c], mode="draw")
                    for r, c in zip(recs, cols)]
        return [ops.choice_sample_group(recs, pool, cols, **geo)]
    if k == "choice_sample":
        if plain:
            r = ops.choice_sample_plain(*a, draw=draw, **inp["kwargs"])
        else:
            r = ops.choice_sample(*a, **inp["kwargs"], **geo)
        return [r]
    if k == "row_gather":   # one chain through row_gather, as row_value
        s, chains = a
        if plain:
            return ops.row_gather_group_plain(s, chains)
        if len(chains) == 1:
            return [ops.row_gather(s, *chains[0])]
        return ops.row_gather_group(s, chains)
    return (ops.branch_select_plain if plain else ops.branch_select)(*a)


def _clone_inputs(inp: dict) -> dict:
    """`inp` with each distinct tensor cloned once (K16's in-place mask
    stays one tensor)."""
    seen: dict = {}

    def clone(t):
        if id(t) not in seen:
            seen[id(t)] = t.clone()
        return seen[id(t)]

    return _tree_map(inp, clone)


def check_sample(ops, inp: dict, geometry=None) -> dict:
    """K16-K19 on a copy of the inputs against the plain version on
    another copy, on the card: every output bit-equal, the plain version
    of K16 and K17 drawing with K2 (ops.inv_cdf_sample: every geometry of
    the kernels' draw gives K2's index; `geometry` forces one). Where they
    draw, K2 on the picked logits against the fully plain draw
    (torch.cumsum) within K2's stated allowance (check_k2; a group's
    members each, the worst kept). Returns dict(max_abs_err 0.0, and
    check_k2's numbers)."""
    a, b = _clone_inputs(inp), _clone_inputs(inp)
    got = _sample_call(ops, a, geometry=geometry)
    want = _sample_call(ops, b, plain=True, draw=ops.inv_cdf_sample)
    if len(got) != len(want):   # a group as a launch a member
        got = [torch.stack(got)]
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.dtype == w.dtype and g.shape == w.shape and
                torch.equal(g, w), f"{inp['kernel']} differs from its plain "
                f"version at {inp['mode']} (output {i}, geometry "
                f"{geometry or 'planned'})")
    out = dict(max_abs_err=0.0)
    kw = inp.get("kwargs", {})
    if inp.get("group"):
        recs, pool, cols = inp["args"]
        B = pool.shape[0]
        for r, c in zip(recs, cols):
            k2 = check_k2(ops, r.expand(B, r.shape[1]).contiguous(),
                          pool[:, c].contiguous())
            if k2.get("mismatch_rate", 0) >= out.get("mismatch_rate", 0):
                out.update(k2)
        out["max_abs_err"] = 0.0
    elif kw.get("u") is not None:
        rec, anc = inp["args"][0], inp["args"][1]
        B = kw["u"].shape[0]
        out.update(check_k2(ops, ops.pick_plain(rec, anc, B).contiguous(),
                            kw["u"]))
        out["max_abs_err"] = 0.0
    return out


def sample_bytes(inp: dict) -> int:
    """K16-K19's bytes: each input element read once and each output
    written once (K16: a drawn row's logits, the mask row, and the mask
    row written where it is copied; K17: a drawn row's logits, else a
    value a row; K18: a slot, an entry of each distinct hop column, and
    each chain's leaf entry and output; K19: the is_new bits and each
    pair's two values and output)."""
    k, a = inp["kernel"], inp["args"]
    kw = inp.get("kwargs", {})
    if inp.get("group"):   # a member's logits, its uniform and its index
        recs, pool, _cols = a
        B = pool.shape[0]
        return sum(r.numel() * 4 + B * (4 + 4) for r in recs)
    if k == "fk_sample":
        rec, anc, gate, mi, mo = a
        B, cap, K1 = gate.shape[0], mo.shape[-1], rec.shape[-1]
        n = B * (1 + 4 * len(anc) + 4 * 4 + 2)
        n += B * (K1 * 4 + 4) if kw.get("u") is not None else B * (4 + 1 + 4)
        n += mi.numel() + (mo.numel() if mi.data_ptr() != mo.data_ptr()
                           else B)
        return n
    if k == "choice_sample":
        rec, anc, B = a
        n = B * 4 * len(anc)
        if kw["mode"] == "draw":
            return n + B * (rec.shape[-1] * 4 + 4 + 4)
        if kw["mode"] == "retained":
            return n + B * (4 + 4 + 4)
        return n + 2 * B * rec.element_size()
    if k == "row_gather":
        s, chains = a
        hops = {id(h): h for hs, _l in chains for h in hs}
        return s.numel() * (s.element_size() + sum(
            h.element_size() for h in hops.values()) + sum(
            2 * leaf.element_size() for _h, leaf in chains))
    is_new, pairs = a
    B = is_new.shape[0]
    return B + sum(B * (2 * nv.element_size() + ev.element_size())
                   for nv, ev in pairs)


def sample_library(inp: dict):
    """The one PyTorch call computing the same function, where there is
    one: K17's pick mode torch.take of the record at each row's clamped
    ancestor position (the flat indices precomputed); K18 of one chain
    torch.take of the leaf at the final indices (the hops precomputed), of
    a group none; K19 of one pair torch.where, of more none; K16 and
    K17's draw and retained modes none."""
    k, a = inp["kernel"], inp["args"]
    if k == "choice_sample" and inp["kwargs"].get("mode") == "pick":
        rec, anc, B = a
        st = rec.contiguous().expand((B,) + tuple(rec.shape[1:])).stride()
        idx = torch.arange(B, device=rec.device) * st[0]
        for i, x in enumerate(anc):
            idx = idx + x.long().clamp(0, rec.shape[1 + i] - 1) * st[1 + i]
        return lambda: torch.take(rec, idx)
    if k == "row_gather":
        s, chains = a
        if len(chains) > 1:
            return None
        hops, leaf = chains[0]
        t = s.long()
        for h in hops:
            t = h[t.clamp(0, h.shape[0] - 1)].long()
        t = t.clamp(0, leaf.shape[0] - 1)
        return lambda: torch.take(leaf, t)
    if k == "branch_select" and len(a[1]) == 1:
        is_new, ((nv, ev),) = a
        ev = ev.to(nv.dtype)
        return lambda: torch.where(is_new, nv, ev)
    return None


def time_sample(ops, inp: dict, geometry=None) -> dict:
    """A K16-K19 call on a copy of these inputs (K16's and K17's draws in
    `geometry`, else the plan's) beside its plain version (its own draw,
    torch.cumsum) and the library call: ms (cuda_ms) and device_ms
    (graph_ms) of each; library None where there is none."""
    x, y = _clone_inputs(inp), _clone_inputs(inp)
    call = lambda: _sample_call(ops, x, geometry=geometry)  # noqa: E731
    lib = sample_library(x)
    return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                plain_ms=cuda_ms(lambda: _sample_call(ops, y, plain=True)),
                library_ms=None if lib is None else cuda_ms(lib),
                library_device_ms=None if lib is None else graph_ms(lib))


def draw_geometries(ops, inp: dict) -> list:
    """The geometries of ops.DRAW_GEOMETRIES that take `inp`'s K16 or K17
    draw (K16 retained: its mask pass and argmax): every one, but a
    stream only for rows of more than 4 logits (a drawn K16, a K17 draw
    or a group whose every member has them) and a block only for rows
    that fit its shared memory; [] for the other kernels and modes."""
    k, a = inp["kernel"], inp["args"]
    if k == "fk_sample":
        lens = [a[0].shape[-1]] if inp["kwargs"].get("u") is not None \
            else []
    elif k == "choice_sample" and inp.get("group"):
        lens = [r.shape[-1] for r in a[0]]
    elif k == "choice_sample" and inp["kwargs"].get("mode") == "draw":
        lens = [a[0].shape[-1]]
    else:
        return []
    fits = (ops.SMEM_MAX - ops._K2_STATIC_SMEM) // 4 - 4
    return [g for g in ops.DRAW_GEOMETRIES
            if (g != "stream" or (lens and min(lens) > 4))
            and (g != "block" or all(n <= fits for n in lens))]


def geometry_ms(ops, inp: dict) -> dict:
    """K16's or K17's call on `inp` in every geometry that takes it
    (draw_geometries), each checked bit-equal to the plain version
    drawing with K2 first: {geometry: dict(device_ms (graph_ms), host_us
    (host_us))}, and the plan's own under "plan"."""
    out = {}
    for g in draw_geometries(ops, inp):
        check_sample(ops, inp, geometry=g)
        x = _clone_inputs(inp)
        call = lambda: _sample_call(ops, x, geometry=g)  # noqa: E731
        out[g] = dict(device_ms=graph_ms(call), host_us=host_us(call, 500))
    a = inp["args"]
    if inp["kernel"] == "fk_sample":
        B, cap = a[2].shape[0], a[4].shape[-1]
        K = a[0].shape[-1] if inp["kwargs"].get("u") is not None else 0
        out["plan"] = ops.draw_plan(B, K, cap)["geometry"]
    elif inp.get("group"):
        B = a[1].shape[0]
        out["plan"] = [ops.draw_plan(B, r.shape[-1])["geometry"]
                       for r in a[0]]
    else:
        out["plan"] = ops.draw_plan(a[2], a[0].shape[-1])["geometry"]
    return out


# ---------------------------------------------------------------- K20, K21

LEVEL_KERNELS = ("level_sum", "py_prior")


def k20_inputs(dev, f: dict, seed: int = 0) -> dict:
    """Seeded inputs of a K20 census shape (its ops.CENSUS_FIELDS `f`: the
    program, rank, output shape and each operand's kind and references):
    every reference a tensor of its recorded (aligned) shape and dtype:
    dense terms and log-densities normal (sd 2, 10% NEG_INF), values and
    observations ints 0-3 (FLOAT columns: observations normal, sd 50, and
    values at 0, 1e-7 or 1e-3 of max(1, |obs|) from them), states 0-2,
    gather codes in [-1, V + 1] (clamped), matrices [V, V] normal.
    dict(mode, args: ops.level_sum's (prog, operands, rank))."""
    from . import ops

    rng = np.random.default_rng(seed)

    def t(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dt)

    def normal(shape):
        x = rng.normal(0.0, 2.0, shape).astype(np.float32)
        x[rng.random(shape) < 0.1] = -1e30
        return t(x, torch.float32)

    operands = []
    for o in f["ops"]:
        refs = {n: (shape, dt) for n, shape, dt in o["refs"]}
        k = o["kind"]
        if k == "dense":
            operands.append(dict(kind=k, x=normal(refs["x"][0])))
            continue
        st = o["state"]
        if "state" in refs:
            shape, dt = refs["state"]
            st = t(rng.integers(0, 3, shape), dt)
        if k == "eq":
            (vs, vdt), (os_, odt) = refs["val"], refs["obs"]
            if o["float"]:
                ov = rng.normal(0, 50, os_).astype(np.float32)
                jit = rng.choice([0.0, 1e-7, 1e-3], np.broadcast_shapes(
                    vs, os_)).astype(np.float32)
                v = (ov + jit * np.maximum(np.abs(ov), 1.0)).astype(
                    np.float32)
                v = v[tuple(slice(0, n) for n in vs)]
                operands.append(ops.level_eq(t(v, vdt), t(ov, odt), st,
                                             True))
            else:
                operands.append(ops.level_eq(
                    t(rng.integers(0, 4, vs), vdt),
                    t(rng.integers(0, 4, os_), odt), st, False))
        elif k == "sel":
            operands.append(ops.level_sel(normal(refs["obs_ld"][0]),
                                          normal(refs["miss"][0]), st))
        else:
            V = o["V"]
            (os_, odt), (ws, wdt) = refs["obs"], refs["word"]
            M = t(rng.normal(0, 1, (V, V)).astype(np.float32),
                  torch.float32)
            operands.append(ops.level_gather(
                M, t(rng.integers(-1, V + 2, os_), odt),
                t(rng.integers(-1, V + 2, ws), wdt), o["shape"]))
    return dict(mode=f, kernel="level_sum",
                args=(list(f["prog"]), operands, f["rank"]))


def k21_inputs(dev, f: dict, K: int, seed: int = 0) -> dict:
    """Seeded inputs of a K21 census shape (its ops.CENSUS_FIELDS `f`) at
    K candidates: refcounts 0-5 and alive bits 0.7 over cap slots (per
    row where the shape's leaves are), totals and nrows from them in the
    census dtypes, compaction (the live slots of the first row first,
    ascending, padded with cap; nc of them real), children normal (10%
    NEG_INF) in the shape's form (f["ch"]: [full, K] varying over the
    rows, [1.., K] one row's, or [1..] one value) and new_children [full]
    normal, the Pitman-Yor strength and discount device scalars or
    numbers as the shape took them. dict(mode, args: ops.py_prior's
    arguments)."""
    rng = np.random.default_rng(seed)
    B, cap, full = f["B"], f["cap"], tuple(f["full"])

    def t(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dt)

    lead = (B,) if f["per_row"] else ()
    refc = rng.integers(0, 6, lead + (cap,))
    alive = rng.random(lead + (cap,)) < 0.7
    total, nrows = (refc * alive).sum(-1), alive.sum(-1)
    comp = None
    if f["comp"]:
        first = (refc.reshape(-1, cap)[0] > 0) & alive.reshape(-1, cap)[0]
        live = np.flatnonzero(first)[:K]
        idx = np.full(K, cap, np.int64)
        idx[:len(live)] = live
        comp = (t(idx, torch.int64), t(np.int64(len(live)), torch.int64))
    form = f.get("ch", "rows")
    ones = (1,) * len(full)
    ch = rng.normal(0.0, 2.0, full + (K,) if form == "rows" else
                    ones + (K,) if form == "shared" else ones + (1,))
    ch = ch.astype(np.float32)
    ch[rng.random(ch.shape) < 0.1] = -1e30
    nch = rng.normal(0.0, 2.0, full).astype(np.float32)
    s, d = float(rng.uniform(0.5, 3.0)), float(rng.uniform(0.0, 0.6))
    if f["sd"]:
        s, d = t(np.float32(s), torch.float32), t(np.float32(d),
                                                  torch.float32)
    tdt, ndt = f["counts"]
    return dict(mode=f, kernel="py_prior", args=(
        t(refc, torch.int32), t(alive, torch.bool), t(total, tdt),
        t(nrows, ndt), s, d, comp, t(ch, torch.float32),
        t(nch, torch.float32), full))


def level_inputs(dev, kernel: str, f: dict, K: int, seed: int = 0):
    """Seeded inputs of a K20 or K21 census shape: `f` its fields
    (ops.CENSUS_FIELDS[kernel][mode]), K its census K."""
    if kernel == "level_sum":
        return k20_inputs(dev, f, seed)
    return k21_inputs(dev, f, K, seed)


def _level_call(ops, inp: dict, plain: bool = False):
    a = inp["args"]
    if inp["kernel"] == "level_sum":
        return [(ops.level_sum_plain if plain else ops.level_sum)(*a)]
    return list((ops.py_prior_plain if plain else ops.py_prior)(*a))


def check_level(ops, inp: dict) -> float:
    """K20 or K21 on these inputs against its plain version on the card:
    every output bit-equal (the same float operations, one rounding
    each). Returns 0.0 (or fails)."""
    got = _level_call(ops, inp)
    want = _level_call(ops, inp, plain=True)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.shape == w.shape and torch.equal(g, w),
                f"{inp['kernel']} differs from its plain version at "
                f"{inp['mode'].get('shape', inp['mode'])} (output {i})")
    return 0.0


def level_bytes(inp: dict) -> int:
    """K20's and K21's bytes: each input element read once, each output
    written once. K20: every reference's own elements (it is read at
    stride 0 along the axes it broadcasts over), the distinct matrix
    entries each gather reads (counted on these codes), the output [N];
    K21: the leaves at the K candidate slots (per row where they are per
    row: refcount 4 and alive 1 byte a slot), totals and nrows, the
    compaction's indices, the children and new_children, exist [R, K] and
    new [R]."""
    from . import ops

    a = inp["args"]
    if inp["kernel"] == "level_sum":
        prog, operands, rank = a
        shape = ops.level_shape(operands, rank)
        n = 4 * int(np.prod(shape))
        for o in operands:
            for key in ("x", "val", "obs", "state", "obs_ld", "miss",
                        "word"):
                x = o.get(key)
                if torch.is_tensor(x):
                    n += x.numel() * x.element_size()
            if o["kind"] == "gather":
                V = o["M"].shape[0]
                cell = (o["obs"].long().clamp(0, V - 1) * V
                        + o["word"].long().clamp(0, V - 1))
                n += 4 * int(torch.unique(cell.expand(o["shape"])).numel())
        return n
    refc, alive, total, nrows, _s, _d, comp, ch, nch, full = a
    R, K = int(np.prod(full)), int(ch.shape[-1])
    rows = refc.shape[0] if refc.dim() == 2 else 1
    n = rows * K * 5 + total.numel() * total.element_size() \
        + nrows.numel() * nrows.element_size()
    if comp is not None:
        n += comp[0].numel() * comp[0].element_size() + 8
    n += 4 * (ch.numel() + nch.numel()) + 4 * (R * K + R)
    return n


def time_level(ops, inp: dict) -> dict:
    """K20 or K21 on these inputs beside its plain version: ms (cuda_ms)
    and device_ms (graph_ms) of each; no PyTorch call computes either
    function alone (library None)."""
    call = lambda: _level_call(ops, inp)  # noqa: E731
    return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                plain_ms=cuda_ms(lambda: _level_call(ops, inp, plain=True)),
                library_ms=None, library_device_ms=None)


# ------------------------------------------------------------- K22, K23

# floating-point operations of one K22 gamma draw round (Box-Muller's log,
# sqrt and cos, the Marsaglia-Tsang test's mul/adds and log, the boost's
# pow counted as one each), for its operations bound against the card's
# float32 rate outside the tensor cores (67 TFLOP/s)
K22_ROUND_FLOPS = 20
# K22's and K9's latency bounds (latency_bound_ms): the launch floor, one
# L2 load and the instructions of the longest dependent chain the function
# needs at one instruction a clock (a warp issues at most one a clock; the
# H100's 1.98 GHz boost clock), each library function counted by the
# shortest path through its SASS (k23_sass), the rest by hand: K22_GLUE
# and K9_GLUE the multiplies, adds, conversions and compares between them,
# K9_SCAN_LEVEL a level of the 64-bit scan (two shuffles and an add with
# carry). A lower bound: a dependent instruction waits some clocks more
K22_GLUE, K9_GLUE, K9_SCAN_LEVEL = 10, 6, 4
CLOCK_HZ = 1.98e9
# K23's operations are counted in instructions, those the function needs:
# a counted slot's three scores take 5 logf (log(j d + s) at (s0, d0),
# (s_prop, d0) and (s1, d_prop); log(n_before + s) at s0 and s_prop, s1
# being one of them) and K23_ONE_OPS adds, multiplies, clamps and
# subtractions around them (the three sums' adds among them); a slot of
# size > 1 6 lgammaf more (lgamma(max(size - d, 1e-30)) at d0 and d_prop,
# lgamma(n_before + size + s) and lgamma(n_before + 1 + s) at s0 and
# s_prop) and K23_MORE_OPS around them; a class 2 lgammaf (lgamma(1 - d)
# at d0 and d_prop) and 2 logf (the accepts). lgammaf and logf count the
# instructions of the shortest path through their SASS (k23_sass), a
# lower bound of any argument's path. The card issues 4 warp
# instructions a clock on each SM: 132 x 128 lanes at its 1.98 GHz boost
# clock (H100 SXM data sheet)
K23_ONE_OPS, K23_MORE_OPS = 16, 20
ISSUE_PER_S = 132 * 128 * 1.98e9
F32_FLOPS_PER_S = 67e12


def k22_inputs(dev, f: dict, seed: int = 0) -> dict:
    """Seeded inputs of a K22 census shape (its ops.CENSUS_FIELDS `f`:
    each descriptor's mode, rows, width, counts or not): priors in [0.05,
    3) ([10, 50] for a Beta pair), counts 0-40, a seed buffer. dict(mode,
    descs, seed)."""
    from . import ops

    rng = np.random.default_rng(seed)
    descs = []
    for mode, rows, width, counts in f["descs"]:
        base = rng.uniform(0.05, 3.0, width).astype(np.float32)
        if mode == "beta":
            base = np.asarray([10.0, 50.0], np.float32)
        cnt = torch.as_tensor(rng.integers(0, 40, (rows, width)),
                              device=dev).to(torch.int32) if counts else None
        descs.append(ops.gamma_desc(mode, torch.as_tensor(base, device=dev),
                                    rows, width, cnt))
    seed_t = torch.as_tensor([int(rng.integers(0, 2 ** 62))], device=dev)
    return dict(mode=ops.gamma_draw_mode(descs), descs=descs, seed=seed_t)


def _k22_alpha(descs):
    from . import ops

    return torch.cat([ops._desc_alpha(d).reshape(-1) for d in descs])


def check_k22(ops, inp: dict) -> dict:
    """K22 against its plain version on the card, on the same seed buffer:
    every output bit-equal. Returns dict(max_abs_err 0.0, differ: the
    elements whose draw differs, 0, which is what the check requires)."""
    got = ops.gamma_draw(inp["descs"], inp["seed"])
    want = ops.gamma_draw_plain(inp["descs"], inp["seed"])
    torch.cuda.synchronize()
    differ = sum(int((g != w).sum()) for g, w in zip(got, want))
    require(differ == 0, f"gamma_draw differs from its plain version at "
            f"{inp['mode']} ({differ} elements)")
    return dict(max_abs_err=0.0, differ=differ)


def k22_bounds(inp: dict) -> dict:
    """K22's bytes (each prior entry and count read once, each output
    written once, the seed) and operations (K22_ROUND_FLOPS a round, the
    rounds these inputs take: counted by the plain version's rounds on
    the card), and the bound, the larger of bytes / 3.35 TB/s and
    operations / 67 TFLOP/s."""
    from . import ops

    n, flops = 8, 0
    for d in inp["descs"]:
        R, W = d["rows"], d["width"]
        n += d["base"].numel() * 4 + (R * W * 4 if d["counts"] is not None
                                      else 0)
        n += 4 * (R if d["mode"] == "beta" else R * W)
    alpha = _k22_alpha(inp["descs"])
    elem = torch.arange(alpha.numel(), device=alpha.device)
    rounds = gamma_rounds(ops, alpha, elem, inp["seed"])
    flops = K22_ROUND_FLOPS * int(rounds.sum())
    ms = 1e3 * max(n / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    return dict(bytes=n, flops=flops, bound_ms=ms,
                bound_by="bytes" if n / HBM_BYTES_PER_S >=
                flops / F32_FLOPS_PER_S else "operations",
                mean_rounds=float(rounds.float().mean()))


def gamma_rounds(ops, alpha, elem, seed):
    """The rounds each gamma draw takes on this stream (the first that
    accepts, 1-based; GAMMA_ROUNDS where none does), from the plain
    version's rounds (ops.gamma_trials)."""
    ok = ops.gamma_trials(alpha, elem, seed)[2]
    return torch.where(ok.any(0), ok.to(torch.int8).argmax(0) + 1,
                       torch.full_like(elem, ops.GAMMA_ROUNDS))


def k22_chain(sass: dict, descs) -> int:
    """The instructions of the longest dependent chain a K22 call needs
    (LATENCY_GLUE above): one rejection round of an element (Philox, then
    the Box-Muller log and square root beside its cos, then the log of v;
    the log of the acceptance uniform runs beside them; K22_GLUE
    multiplies and adds between them), then for a Dirichlet row or a Beta
    pair its sum's log2 P levels (a shuffle and an add each) and the
    division, and a Dirichlet row's log; the largest over the call's
    descriptors."""
    draw = sass["philox"] + max(sass["logf"] + sass["sqrt"],
                                sass["cosf"]) + sass["logf"] + K22_GLUE
    out = 0
    for d in descs:
        if d["mode"] == "gamma":
            out = max(out, draw)
            continue
        lv = max(0, d["width"] - 1).bit_length()
        out = max(out, draw + 2 * lv + sass["fdiv"] +
                  (sass["logf"] if d["mode"] == "dirichlet_log" else 0))
    return out


def source_build_s(ops, name: str) -> float:
    """Wall seconds of one nvcc of kernel `name`'s source alone, with the
    flags ops.build_kernels gives it, into a file of its own under the
    build directory (removed after)."""
    os.makedirs(ops.BUILD_DIR, exist_ok=True)
    out = os.path.join(ops.BUILD_DIR, f"timed_{name}.{os.getpid()}.so")
    t0 = time.time()
    subprocess.run([ops._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-Xptxas", "-v", "-I", os.path.join(ops._HERE, "csrc"),
                    "-o", out,
                    os.path.join(ops._HERE, "csrc", ops._SOURCES[name])],
                   check=True, capture_output=True)
    sec = time.time() - t0
    os.remove(out)
    return sec


def latency_bound_ms(chain: int, floor_ms: float, l2_ms: float) -> float:
    """The latency bound: the launch floor, one L2 load and `chain`
    dependent instructions at one a clock (CLOCK_HZ)."""
    return floor_ms + l2_ms + 1e3 * chain / CLOCK_HZ


def time_k22(ops, inp: dict) -> dict:
    """K22 beside its plain version, torch._standard_gamma at the same
    alphas (one PyTorch call drawing the same gammas, no normalisation)
    and torch._sample_dirichlet over each descriptor's rows
    (dirichlet_library: a Dirichlet row or a Beta pair normalised as K22
    does, without its log; dirichlet_calls of them, None where a
    descriptor draws plain gammas): ms (cuda_ms) and device_ms (graph_ms)
    of each."""
    call = lambda: ops.gamma_draw(inp["descs"], inp["seed"])  # noqa: E731
    alpha = _k22_alpha(inp["descs"])
    lib = lambda: torch._standard_gamma(alpha)  # noqa: E731
    dirichlet, n = dirichlet_library(inp["descs"])
    return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                plain_ms=cuda_ms(lambda: ops.gamma_draw_plain(
                    inp["descs"], inp["seed"])),
                library_ms=cuda_ms(lib), library_device_ms=graph_ms(lib),
                dirichlet_ms=None if dirichlet is None else
                cuda_ms(dirichlet),
                dirichlet_device_ms=None if dirichlet is None else
                graph_ms(dirichlet), dirichlet_calls=n)


def k23_inputs(dev, f: dict, seed: int = 0) -> dict:
    """Seeded inputs of a K23 census shape (its fields: each class's cap):
    refcounts 0-8 (30% 0), alive 0.75, strength 0.1 + Gamma(1),
    discount in [0, 0.9), a seed buffer. dict(mode, classes, seed)."""
    from . import ops

    rng = np.random.default_rng(seed)
    classes = []
    for cap in f["caps"]:
        rc = rng.integers(0, 9, cap).astype(np.int32)
        rc[rng.random(cap) < 0.3] = 0
        t = lambda x, dt=None: torch.as_tensor(x, device=dev)  # noqa: E731
        classes.append(ops.py_class(
            t(rc), t(rng.random(cap) < 0.75),
            t(np.float32(rng.gamma(1.0) + 0.1)),
            t(np.float32(rng.random() * 0.9))))
    seed_t = torch.as_tensor([int(rng.integers(0, 2 ** 62))], device=dev)
    return dict(mode=f"classes={len(f['caps'])} cap={max(f['caps'])}",
                classes=classes, seed=seed_t)


def k23_launch(ops, inp: dict, cluster: int, threads: int, outs=None):
    """inp's classes in one K23 launch of clusters of `cluster` blocks of
    `threads` threads: the words py_resample passes (ops.k23_classes)
    with their geometry words set by hand, not counted (the A/B's
    --routes). Returns each class's (s1, d1)."""
    recs, res = ops.k23_classes(inp["classes"], inp["seed"], outs)
    words = [len(recs), inp["seed"].data_ptr(), threads, cluster]
    for r in recs:
        words += r
    arr = (ctypes.c_int64 * len(words))(*words)
    ops._check(ops._fn("py_resample")(arr, len(arr),
                                       ops._stream(inp["seed"])),
               "py_resample")
    return res


def check_k23(ops, inp: dict, geometry=None) -> dict:
    """K23 against its plain version on the card, on the same seed buffer,
    out of place and in place (into copies of the leaves): every (s1, d1)
    bit-equal; the plan's launches, or one launch in `geometry` (cluster,
    threads; k23_launch). Returns dict(max_abs_err 0.0)."""
    want = ops.py_resample_plain(inp["classes"], inp["seed"])
    leaves = [(c["strength"].clone(), c["discount"].clone())
              for c in inp["classes"]]
    classes = [dict(c, strength=s, discount=d)
               for c, (s, d) in zip(inp["classes"], leaves)]
    if geometry is None:
        got = ops.py_resample(inp["classes"], inp["seed"])
        ins = ops.py_resample(classes, inp["seed"], outs=leaves)
    else:
        got = k23_launch(ops, inp, *geometry)
        ins = k23_launch(ops, dict(inp, classes=classes), *geometry,
                         outs=leaves)
    torch.cuda.synchronize()
    for k, ((a, b), (c, d), (e, g)) in enumerate(zip(got, want, ins)):
        require(torch.equal(a, c) and torch.equal(b, d) and
                torch.equal(e, c) and torch.equal(g, d),
                f"py_resample differs from its plain version at "
                f"{inp['mode']} (class {k})")
    return dict(max_abs_err=0.0)


# the probes whose SASS k23_sass reads: one lgammaf, one logf (K23), one
# cosf, expf, correctly rounded square root and division, one Philox
# block of csrc/gamma.cuh (K22's and K9's latency bounds), and one that
# only loads and stores
K23_SASS_PROBES = r"""
#include "gamma.cuh"
extern "C" __global__ void copy_probe(const float* x, float* y) {
  y[threadIdx.x] = x[threadIdx.x];
}
extern "C" __global__ void cosf_probe(const float* x, float* y) {
  y[threadIdx.x] = cosf(x[threadIdx.x]);
}
extern "C" __global__ void expf_probe(const float* x, float* y) {
  y[threadIdx.x] = expf(x[threadIdx.x]);
}
extern "C" __global__ void sqrt_probe(const float* x, float* y) {
  y[threadIdx.x] = __fsqrt_rn(x[threadIdx.x]);
}
extern "C" __global__ void fdiv_probe(const float* x, float* y) {
  y[threadIdx.x] = __fdiv_rn(x[threadIdx.x], y[threadIdx.x]);
}
extern "C" __global__ void philox_probe(const float* x, float* y) {
  const uint64_t s = reinterpret_cast<const uint64_t*>(x)[threadIdx.x];
  const pclean_gamma::Block b = pclean_gamma::draw(s, s >> 7, 0, 0);
  y[threadIdx.x] = __uint_as_float(b.x ^ b.y ^ b.z ^ b.w);
}
extern "C" __global__ void lgammaf_probe(const float* x, float* y) {
  y[threadIdx.x] = lgammaf(x[threadIdx.x]);
}
extern "C" __global__ void logf_probe(const float* x, float* y) {
  y[threadIdx.x] = logf(x[threadIdx.x]);
}
"""


def sass_paths(text: str) -> dict:
    """Each function of a cuobjdump -sass listing: dict(shortest: the
    fewest instructions on a path from its first to an EXIT, all: its
    instructions but the trailing self-branch and NOPs). A predicated
    BRA or EXIT may go either way; a CALL counts as one instruction (the
    callee not entered) and an indirect branch ends a path, so
    `shortest` is a lower bound of any run's instructions."""
    import heapq

    funcs, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if fn is not None and m:
            fn.append((int(m.group(1), 16), m.group(2).strip()))
    out = {}
    for name, ins in funcs.items():
        while ins and (ins[-1][1] == "NOP" or ins[-1][1].startswith("BRA")
                       and int(re.search(r"0x([0-9a-f]+)",
                                         ins[-1][1]).group(1), 16)
                       == ins[-1][0]):
            ins.pop()
        at = {a: i for i, (a, _t) in enumerate(ins)}
        seen, heap, shortest = set(), [(1, 0)], None
        while heap:   # d: the instructions up to and with the i-th
            d, i = heapq.heappop(heap)
            if i in seen or i >= len(ins):
                continue
            seen.add(i)
            text_i = ins[i][1]
            pred = re.match(r"@(!?)(U?P\w+)\s+", text_i)
            op = text_i[pred.end():] if pred else text_i
            always = pred is None or pred.group(2) in ("PT", "UPT") and \
                not pred.group(1)
            never = pred is not None and pred.group(2) in ("PT", "UPT") and \
                bool(pred.group(1))
            nxt = []
            if op.startswith(("EXIT", "BRX", "JMX", "RET")) and not never:
                shortest = d if shortest is None else min(shortest, d)
                if always:
                    continue
                nxt.append(i + 1)
            elif op.startswith(("BRA", "JMP")) and not never:
                tgt = re.search(r"0x([0-9a-f]+)", op)
                if tgt and int(tgt.group(1), 16) in at:
                    nxt.append(at[int(tgt.group(1), 16)])
                if not always:
                    nxt.append(i + 1)
            else:
                nxt.append(i + 1)
            for j in nxt:
                heapq.heappush(heap, (d + 1, j))
        out[name] = dict(shortest=shortest, all=len(ins))
    return out


def k23_sass(ops) -> dict:
    """The instructions of one lgammaf and one logf as K23's kernel builds
    them (nvcc with the kernels' architecture and -O3, into a cubin of
    its own beside the libraries): each probe's shortest path (sass_paths)
    less the copy probe's; `all`, their listings' lengths so. Read once a
    process."""
    if _K23_SASS:
        return _K23_SASS
    os.makedirs(ops.BUILD_DIR, exist_ok=True)
    src = os.path.join(ops.BUILD_DIR, "k23_sass_probes.cu")
    cubin = os.path.join(ops.BUILD_DIR, "k23_sass_probes.cubin")
    with open(src, "w") as f:
        f.write(K23_SASS_PROBES)
    subprocess.run([ops._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-cubin", "-I", os.path.join(ops._HERE, "csrc"),
                    "-o", cubin, src], check=True, capture_output=True)
    tool = os.path.join(os.path.dirname(ops._nvcc()), "cuobjdump")
    paths = sass_paths(subprocess.run([tool, "-sass", cubin],
                                      capture_output=True, text=True,
                                      check=True).stdout)
    base = paths["copy_probe"]
    names = ("lgammaf", "logf", "cosf", "expf", "sqrt", "fdiv", "philox")
    _K23_SASS.update(
        {n: paths[n + "_probe"]["shortest"] - base["shortest"]
         for n in names},
        all={n: paths[n + "_probe"]["all"] - base["all"] for n in names})
    return _K23_SASS


_K23_SASS: dict = {}


def k23_bounds(inp: dict, ops=None) -> dict:
    """K23's bytes (refcount 4 and alive 1 byte a slot, the four scalars)
    and operations (instructions the function needs, as counted above
    K23_ONE_OPS), and the bound, the larger of bytes / 3.35 TB/s and
    instructions / ISSUE_PER_S. Without `ops` (no compiler) the
    operations are not counted."""
    n, ones, more = 8, 0, 0
    for c in inp["classes"]:
        n += c["refcount"].numel() * 5 + 16
        on = c["alive"] & (c["refcount"] > 0)
        ones += int(on.sum())
        more += int((on & (c["refcount"] > 1)).sum())
    ins = None
    if ops is not None:
        sass = k23_sass(ops)
        lg, lo = sass["lgammaf"], sass["logf"]
        ins = ones * (5 * lo + K23_ONE_OPS) + \
            more * (6 * lg + K23_MORE_OPS) + \
            (2 * lg + 2 * lo) * len(inp["classes"])
    ops_s = 0.0 if ins is None else ins / ISSUE_PER_S
    ms = 1e3 * max(n / HBM_BYTES_PER_S, ops_s)
    return dict(bytes=n, flops=ins, instructions=ins, bound_ms=ms,
                bytes_bound_ms=1e3 * n / HBM_BYTES_PER_S,
                ops_bound_ms=None if ins is None else 1e3 * ops_s,
                bound_by="bytes" if n / HBM_BYTES_PER_S >= ops_s
                else "operations")


def time_k23(ops, inp: dict) -> dict:
    """K23 beside its plain version: ms and device_ms of each; no PyTorch
    call computes the function (library None)."""
    call = lambda: ops.py_resample(inp["classes"], inp["seed"])  # noqa
    return dict(ms=cuda_ms(call), device_ms=graph_ms(call),
                plain_ms=cuda_ms(lambda: ops.py_resample_plain(
                    inp["classes"], inp["seed"])),
                library_ms=None, library_device_ms=None)


# ------------------------------------------------------ the split limits


def split_level(rng, n_ops: int = 260, depth: int = 40, B: int = 3,
                V: int = 5) -> tuple:
    """(prog, operands) of a seeded level past K20's single launch: n_ops
    operands (dense [B, V] and [B, 1] terms and gathers of seeded [6, 6]
    matrices) whose program nests `depth` deep, then adds every operand
    (level_program folds the adds), rank 2."""
    from . import ops

    operands = []
    for i in range(n_ops):
        if i % 3 == 2:
            M = torch.tensor(rng.normal(size=(6, 6)).astype(np.float32))
            operands.append(ops.level_gather(
                M, torch.tensor(rng.integers(0, 6, (B, 1))),
                torch.tensor(rng.integers(0, 6, (1, V))), (B, V)))
        else:
            shape = (B, V) if i % 3 == 0 else (B, 1)
            operands.append(ops.level_dense(torch.tensor(
                rng.normal(size=shape).astype(np.float32))))
    Z, P, A = ops.LEVEL_ZERO, ops.LEVEL_PUSH, ops.LEVEL_ADD
    code = [(Z, 0)]
    for k in range(depth):
        code += [(Z, 0), (P, k)]
    code += [(A, 0)] * (2 * depth)
    for k in range(n_ops):
        code += [(P, k), (A, 0)]
    return ops.level_program(code), operands


class LimitCalls:
    """Records, while active, the first call of each K7, K12, K14, K15,
    K16, K17 (and its group mode), K18 and K20 wrapper that went past its
    kernel's single-launch
    limit (the call that added to ops.SPLITS; K12's: a child level cut
    into stages), its inputs as they were
    before the call, so that `replay` can hold each split or raised
    launch to its plain version at the model's own shapes. Calls inside
    a CUDA graph capture are not recorded (a copy there would live in the
    graph's memory pool)."""

    WRAPPERS = ("row_gather", "referrer_hist", "rel_scatter", "batch_write",
                "fk_sample", "choice_sample", "choice_sample_group",
                "level_sum", "fk_score")

    def __init__(self, ops):
        self.ops, self.calls, self._real = ops, {}, {}

    def __enter__(self):
        o = self
        self._real = {}

        def wrap(name, real):
            def call(*a, **kw):
                if name in o.calls or torch.cuda.is_current_stream_capturing():
                    return real(*a, **kw)
                before = o.ops.SPLITS.get(name, 0)
                inputs = _clone_inputs((a, kw))
                out = real(*a, **kw)
                if o.ops.SPLITS.get(name, 0) > before:
                    o.calls[name] = inputs
                return out
            return call

        for name in self.WRAPPERS:
            self._real[name] = getattr(self.ops, name)
            setattr(self.ops, name, wrap(name, self._real[name]))
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(self.ops, name, real)
        return False

    def replay(self) -> dict:
        """Each recorded call on the card against its plain version on
        copies of its inputs: {kernel: dict(launches, max_abs_err 0.0)},
        every output bit-equal (K16/K17 through check_sample: their plain
        versions draw with K2; K12's logZ within K1's rule,
        check_score)."""
        o, out = self.ops, {}
        for name, (a, kw) in self.calls.items():
            kernel = "choice_sample" if name == "choice_sample_group" \
                else name
            before = o.LAUNCHES[kernel]
            if name == "choice_sample_group":   # K17's group, split
                check_sample(o, dict(kernel=kernel, group=True,
                                     mode="limits", args=a[:3], kwargs={}))
            elif name in ("fk_sample", "choice_sample"):
                args = a if name == "fk_sample" else a[:3]
                kwa = dict(kw) if name == "fk_sample" else \
                    dict(kw, **dict(zip(("u", "rv", "dummy", "mode"),
                                        a[3:])))
                kwa.pop("label", None)
                check_sample(o, dict(kernel=name, mode="limits",
                                     args=args, kwargs=kwa))
            elif name == "fk_score":   # its levels' stages by K20 first
                full = a[8]
                check_score(o, name, dict(args=a[:9], R=int(np.prod(full)),
                                          K=int(a[0].shape[-1])))
            else:
                x, y = _clone_inputs((a, kw)), _clone_inputs((a, kw))
                kw_plain = {k: v for k, v in y[1].items()
                            if k not in ("label", "cls", "B")}
                got = getattr(o, name)(*x[0], **x[1])
                want = getattr(o, name + "_plain")(*y[0], **kw_plain)
                if name in ("rel_scatter", "batch_write"):   # in place
                    got, want = x, y
                torch.cuda.synchronize()
                bad = [p for p, g, w in _leaves(got, want, name)
                       if not torch.equal(g, w)]
                require(not bad, f"{name} past its old limit differs from "
                        f"its plain version: {bad}")
            out[name] = dict(launches=o.LAUNCHES[kernel] - before,
                             max_abs_err=0.0)
        return out


if __name__ == "__main__":
    sys.exit(main())
