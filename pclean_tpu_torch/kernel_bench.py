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
times them. With --paths it also times each of K1's paths at each of
those shapes and over an R x K grid in both modes (the last tree's
kernels; PERF.md takes the plan's cut-overs from that table).

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
the state axis. K6 (the flights path's MaybeSwap external) takes its
inputs from the flights model's state (`flights_inputs`): one Flight slot
against every Obs row, for each of the four time fields; `k6_inputs`
draws seeded inputs of any shape for the card tests. K7 and K8 (the
referrer histograms and the hospital's composed stateavg term) take
theirs from a path's state at every shape of its launch census
(`k7_census_inputs`, `k8_census_inputs`); `k7_seeded` and `k8_seeded` draw
seeded inputs for the card tests, and `k3_seeded` K3's at any shape of a
census. K7's yardstick is one torch.bincount of the kept
cells, which reads its input's maximum back to the host and so is timed by
events only.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys

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
    slots and every state, with the statistics K4 makes of that state, the
    indexed Mean's values and the key table in the order _ext_gauss_term
    reads it (idx[b, a] = the row-major position of (state a, slot b's
    county key)). Returns dict(k4=..., k5=...)."""
    from . import ops
    from .engine.propose import (gauss_key_table, gauss_mean_lookup,
                                 gauss_stats_inputs)
    from .engine.refresh import refresh

    node, kern, inv = gauss_external(cm)
    src = node.path[-1][0]
    rel = refresh(cm, arenas, obs_dev)
    cap = cm.layouts["County"].capacity
    k4 = gauss_stats_inputs(cm, arenas, params, rel, obs_dev, cap, node,
                            kern, inv)
    n, sz, szz, pre0 = ops.gauss_suffstats_plain(**k4)
    mnode, knode = gauss_mean_lookup(cm, src, kern)
    env = [a for a in knode.arg_ids if a in inv]
    ref = [a for a in knode.arg_ids if a not in inv]
    order = tuple(knode.arg_ids.index(a) for a in env + ref)
    env_shape, tbl = gauss_key_table(cm, src, mnode.key_id, order)
    slots = torch.nonzero(rel["County"]["alive"])[:B, 0]
    A = cm.domain("County", cm.cls("County").names["state"]).size
    idx = torch.zeros((len(slots), A), dtype=torch.long, device=cm.device)
    state_vid = cm.cls("County").names["state"]
    for a, size in zip(env, env_shape):
        if inv[a] == state_vid:  # the enumerated axis
            v = torch.arange(A, device=cm.device)[None, :]
        else:
            v = arenas["County"]["values"][inv[a]][slots][:, None].long()
        idx = idx * size + v.clamp(0, size - 1)
    pv = cm.canon(src, mnode.param_id)
    k5 = dict(values=params[pv[0]][pv[1]]["value"], tbl=cm.use(tbl),
              idx=idx.to(torch.int32), slot=slots.to(torch.int32), n=n,
              sz=sz, szz=szz, pre0=pre0,
              coef=-0.5 * (1.0 / (kern.std * kern.std)))
    return dict(k4=k4, k5=k5)


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
    subtracted). Returns the largest |difference|."""
    got = ops.gauss_ext_term(**k5)
    want = ops.gauss_ext_term_plain(**k5)
    a_szz, a_sz, a_n = ops.gauss_ext_term_parts(
        k5["values"], k5["tbl"], k5["idx"], k5["slot"], k5["n"], k5["sz"],
        k5["szz"])
    scale = abs(k5["coef"]) * (a_szz.abs() + 2 * a_sz.abs() + a_n.abs())
    torch.cuda.synchronize()
    d = (got - want).abs()
    require(bool((d <= 2.0 ** -20 * scale + 1e-5).all()),
            f"K5 differs by {float(d.max())}")
    return float(d.max())


def k4_bytes(k4: dict) -> int:
    """K4's bytes: t, rv, z, ld (4 B) and w (1 B) of every referrer read
    once, n, sz, szz and pre0 written once."""
    R = k4["z"].shape[0]
    return R * 17 + (3 * k4["cap"] * k4["C"] + k4["cap"]) * 4


def k5_bytes(k5: dict) -> int:
    """K5's bytes on these inputs: idx and out [B, A], the slots, each key
    table row and Mean value the batch touches, and the B slots' statistics
    (3 C + 1 floats), each once."""
    idx, tbl = k5["idx"], k5["tbl"]
    B, A = idx.shape
    C = tbl.shape[1]
    rows = torch.unique(idx.long().clamp(0, tbl.shape[0] - 1))
    vals = torch.unique(tbl[rows].long())
    nslot = int(torch.unique(k5["slot"]).numel())
    return (2 * B * A * 4 + B * 4 + int(rows.numel()) * C * 4
            + int(vals.numel()) * 4 + nslot * (3 * C + 1) * 4)


def time_k45(ops, inp: dict) -> dict:
    """{kernel: {ms, device_ms, plain_ms, library_ms}} of K4 and K5 on
    rents_inputs (ms, plain_ms, library_ms: cuda_ms; device_ms: graph_ms).
    K4's library call: one index_add_ of the stacked [R, 3] statistics
    (1, z, z^2) into [cap * C, 3] (the pre0 sum left out); K5 has none."""
    k4, k5 = inp["k4"], inp["k5"]
    res = {}
    for name, fn, plain in (
            ("gauss_suffstats", lambda: ops.gauss_suffstats(**k4),
             lambda: ops.gauss_suffstats_plain(**k4)),
            ("gauss_ext_term", lambda: ops.gauss_ext_term(**k5),
             lambda: ops.gauss_ext_term_plain(**k5))):
        res[name] = dict(ms=cuda_ms(fn), device_ms=graph_ms(fn),
                         plain_ms=cuda_ms(plain), library_ms=None)
    ok = k4["w"] & (k4["t"] >= 0) & (k4["t"] < k4["cap"]) & \
        (k4["rv"] >= 0) & (k4["rv"] < k4["C"])
    cell = torch.where(ok, k4["t"].long() * k4["C"] + k4["rv"].long(),
                       torch.zeros_like(k4["t"].long()))
    z = torch.where(ok, k4["z"], torch.zeros_like(k4["z"]))
    stacked = torch.stack([ok.float(), z, z * z], 1)
    out = torch.zeros((k4["cap"] * k4["C"], 3), device=z.device)
    lib = lambda: out.index_add_(0, cell, stacked)  # noqa: E731
    res["gauss_suffstats"]["library_ms"] = cuda_ms(lib)
    res["gauss_suffstats"]["library_device_ms"] = graph_ms(lib)
    return res


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
              density: float = None) -> dict:
    """Seeded K7 inputs with some slots and values out of range. Hoisted:
    R referrers, `hops` hop columns (the first [R] into a class of 2 * G
    rows, each later one into the next class, the last into [-1, G + 2)),
    val [R] in [-1, V + 1), w set on all but `dead` of them. Per row: w [G,
    R] set with `density` (1 / G by default, as t == slot keeps), val
    [rows_val, R] in [-1, V + 1)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    i32 = dict(device=dev, dtype=torch.int32, generator=g)
    if per_row:
        p = 1.0 / max(G, 1) if density is None else density
        return dict(val=torch.randint(-1, V + 1, (rows_val, R), **i32),
                    w=torch.rand((G, R), generator=g, device=dev) < p, V=V)
    lens = [R] + [2 * G] * (hops - 1)
    cols = [torch.randint(0, lens[h + 1], (lens[h],), **i32)
            for h in range(hops - 1)]
    cols.append(torch.randint(-1, G + 2, (lens[-1],), **i32))
    return dict(val=torch.randint(-1, V + 1, (R,), **i32),
                w=torch.rand((R,), generator=g, device=dev) >= dead, V=V,
                cap=G, hops=cols)


def k8_seeded(dev, B: int, E: int, Vc: int, V: int, R: int,
              rows_pairs: int = 1, seed: int = 0,
              density: float = None) -> dict:
    """Seeded K8 inputs: SA [E, Vc, V] of typo log densities (normal about
    -20, a tenth at the -1e5 the typo model gives beyond its edit limit),
    rv and val [rows_pairs, R] with some out of range, w [B, R] set with
    `density` (1 / B by default)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    SA = torch.randn((E, Vc, V), generator=g, device=dev) * 5.0 - 20.0
    SA = torch.where(torch.rand((E, Vc, V), generator=g, device=dev)
                     < 0.1, torch.full_like(SA, -1e5), SA)
    i32 = dict(device=dev, dtype=torch.int32, generator=g)
    p = 1.0 / max(B, 1) if density is None else density
    return dict(SA=SA, rv=torch.randint(-1, Vc + 1, (rows_pairs, R), **i32),
                val=torch.randint(-1, V + 1, (rows_pairs, R), **i32),
                w=torch.rand((B, R), generator=g, device=dev) < p)


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
    version (the same terms summed in double in referrer order, against an
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--turns", default="0,1,1,0")
    ap.add_argument("--out", default=None)
    ap.add_argument("--paths", action="store_true",
                    help="also time every path of K1's plan at every K1 "
                         "shape and over PATH_GRID_R x PATH_GRID_K in both "
                         "modes, with the last tree's kernels")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device available", file=sys.stderr)
        return 1
    from .workloads import scaled

    dev = torch.device("cuda")
    tree_ops = [_load_tree_ops(t, f"_tree{i}_pclean_tpu_torch")
                for i, t in enumerate(a.trees)]
    for t, o in zip(a.trees, tree_ops):
        print(f"{t}: kernel build {o.build_kernels():.2f} s", flush=True)
    # chip_smoke.py's main path: the scaled workload's entity counts, 100,000
    # rows, batch_rows 4096
    B = 4096
    cm = scaled.setup(rows=100_000, batch=B, device="cuda")[0]
    shapes = {"batch": main_path_inputs(cm, dev, B),
              "r1": main_path_inputs(cm, dev, 1),
              "b66": main_path_inputs(cm, dev, 66),
              "b1024": main_path_inputs(cm, dev, 1024)}
    bounds = {s: {k: v / HBM_BYTES_PER_S * 1e3
                  for k, v in kernel_bytes(inp).items()}
              for s, inp in shapes.items()}
    k1s = {}  # K1 (and K2 on its record) at the main path's other shapes
    for mode, K in k1_shapes(cm):
        for R in (1, B):
            if (mode, K) != ("fk", shapes["batch"]["K"]):
                k1s[f"{mode} K={K} R={R}"] = k1_inputs(dev, R, K, mode)
    for s, inp in k1s.items():
        R, K, mode = inp["R"], inp["K"], inp["mode"]
        bounds[s] = {
            "enum_logsumexp": k1_bytes(R, K, mode) / HBM_BYTES_PER_S * 1e3,
            "inv_cdf_sample": k2_bytes(R, inp["logits"].shape[1])
            / HBM_BYTES_PER_S * 1e3}
    turns = []

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
    summary = {}
    for tree in a.trees:
        for s in list(shapes) + list(k1s):
            for k in KERNELS:
                rows = [r for r in turns if r["tree"] == tree
                        and r["shape"] == s and r["kernel"] == k]
                if not rows:
                    continue
                dev_ms = [r["device_ms"] for r in rows]
                summary[f"{tree} {s} {k}"] = dict(
                    ms=[r["ms"] for r in rows], device_ms=dev_ms,
                    bound_ms=bounds[s][k],
                    share_of_bound=bounds[s][k] / float(np.median(dev_ms)))
    for key, v in summary.items():
        print(f"{key}: ms {['%.4f' % x for x in v['ms']]} device_ms "
              f"{['%.4f' % x for x in v['device_ms']]} bound "
              f"{v['bound_ms']:.5f} ms share of bound (device) "
              f"{v['share_of_bound']:.3f}")
    # yardsticks (never called by the port), and with --paths K1's paths
    k1_all = dict(k1s, **{"fk K=%d R=%d" % (shapes[s]["K"], shapes[s]["B"]):
                          shapes[s] for s in ("batch", "r1")})
    floor = launch_floor_ms()
    yard = {s: dict(library_device_ms=graph_ms(
        lambda: torch.logsumexp(inp["logits"], dim=1)))
        for s, inp in k1_all.items()}
    print(f"launch floor (one PyTorch op on one element): {floor:.4f} ms")
    for s, y in yard.items():
        print(f"{s}: torch.logsumexp device {y['library_device_ms']:.4f} ms")
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
                           yardsticks=yard, paths=paths), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
