"""Chip smoke run of the PyTorch/CUDA port (pclean_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the full run (one card)
    python3 chip_smoke.py --out DIR  # also write the details to
                                     # DIR/chip_smoke.json

It drives the port only (never jax, never pclean_tpu), in order:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the six CUDA kernels from pclean_tpu_torch/csrc/ (one nvcc per
     source, in parallel) and prints the build time and ptxas's registers,
     shared memory, stack frame and spills for each compiled function;
  3. checks the tracer's CUDA path against its CPU path (plain versions) on
     small inputs: same state, same injected uniforms, for the scaled
     workload's Record block, the rents workload's County block (K4's
     statistics and K5's closed form), and the flights workload's Flight
     time block (K6) and Obs blocks;
  4. runs the scaled workload's main path end to end — compile_model,
     init_state, Engine.initialize (sequential ramp, batched init segments,
     batched birth allocation, replay), Engine.run (segmented batched MH
     sweep with resample_all), evaluate_accuracy_device — at the entity
     counts of experiments/scaled.py (8,000 hospitals, 1,000 counties,
     2,000 names, 500 zips, typo 0.05, capacities Hospital 11,264 and
     County 1,472, batch_rows 4096, 1 sweep) with the rows cut from the
     source's 1,000,000 to 100,000 so the run fits its time limit; prints
     init s, sweep s, rows-cleaned/s, F1, precision, recall, arena
     occupancy, peak device memory and each kernel's launches on that run,
     split into one-row (r1) and batched (rn) launches, and K1's and K2's
     launch census by (mode, r1 or rn, row length K);
  5. after the main path (so that its peak memory is its own), for each
     kernel, at both shapes the main path launches it at (the
     batch shape, B = 4096 rows, and the sequential loops' one row), on
     seeded inputs (pclean_tpu_torch/kernel_bench.py): its error against
     its plain PyTorch version on the card (with the tolerance stated
     below), kernel / plain / library ms (median of CUDA events around one
     call, host side included where it is longer), the kernel's device time
     per call (`device_ms`: median over replays of a CUDA graph of many
     calls), the bytes bound on an H100 (3.35 TB/s) and the launch plan;
  6. K1, and K2 on K1's record, at the batch shape and at every one-row
     shape that holds >= 5% of K1's launches in the census, in the mode the
     main path used there (K1 also checked in the other mode): error,
     plan, device and events ms, bound, the launch floor (device time of
     one PyTorch op on one element) and torch.logsumexp's device time, the
     two yardsticks a one-row time is read against;
  7. runs the rents path end to end (pclean_tpu_torch/workloads/rents.py,
     the port's copy of experiments/rents.py on its seeded synthetic rents
     tables) at the source's 50,000 rows, 51 states, about 1,500 counties,
     County capacity 4,096, batch_rows 256, 1 sweep, rejuv_frequency 500,
     with the counts set to 0 just before it and read just after: init s,
     sweep s, rows-cleaned/s, F1, precision, recall, phase times,
     occupancy, peak device memory and each kernel's launches there;
  8. K4 and K5 at the shapes the rents path launches them at (K4 over the
     50,000 Obs rows into County's 4,096 slots, K5 over 256 County rows and
     51 states, inputs from the rents state, kernel_bench.rents_inputs):
     error against the plain version, kernel / plain / library ms, device
     ms (the library call's too), the bytes bound and the launch floor;
     K4's library call is one index_add_ of the stacked [R, 3] statistics,
     K5 has none; and where one K4 call's host time goes
     (kernel_bench.k4_call_split);
  9. runs the flights path end to end (pclean_tpu_torch/workloads/
     flights.py, the port's copy of experiments/flights.py on its seeded
     synthetic flights tables) at the source's 2,376 rows, 100 flights, 38
     websites, capacities Flight 160 and TrackingWebsite 64, MH, 5 sweeps,
     batch_rows 1 (the sequential drivers), rejuv_frequency 50, with the
     counts set to 0 just before it and read just after: the same report
     as the other paths, and K1's and K2's census there;
 10. K6 at the shape the flights path launches it at (one Flight slot
     against the 2,376 Obs rows, for each time field's vocabulary, inputs
     from the flights state, kernel_bench.flights_inputs): error against
     the plain version, kernel / plain / device ms, the bytes bound and the
     launch floor; and K1 and K2 at every one-row flights census shape
     holding >= 5% of either's launches there;
 11. prints the `kernels` JSON line (K1-K6; `launches` summed over the
     three paths, with each path's own beside it), then the card line,
     then the result.

Tolerances: K1 record bit-equal, logZ rtol 1e-6 (the same f32 formula
summed in another order); K2 indices equal on all but <= 1e-2 of rows (at
100 rows or more), and every differing row's threshold within 1e-5 of the
total from the exact prefix sums between the two picks (the kernel's exact
fixed-point prefix sums and torch.cumsum's f32 ones round differently: at
K ~ 11k logits about one row in a thousand sits that close to a boundary),
never a zero-mass pick; K3 bit-equal (same column order); K4's counts
equal and its sums within 1e-5 of each cell's sum of |terms| (atomics add
in any order); K5 within 2^-20 * |coef| * (|sum szz| + 2 |sum mu sz| +
|sum mu^2 n|) + 1e-5 (its f32 sums subtract); K6 within 1e-5 of each
cell's sum of |terms| + 1e-6 (the same terms summed in another order). It
fails (non-zero exit, no result line) if there is no card, a kernel does
not build, launch or agree, K1-K3 were not launched on the scaled path, K4
and K5 not on the rents path or K1, K2 and K6 not on the flights path, the
scaled F1 < 0.80, the rents F1 < RENTS_F1_FLOOR, the flights F1 <
FLIGHTS_F1_FLOOR, or any phase raises.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

ROWS = 100_000
BATCH = 4096
SCALED = dict(counties=1000, hospitals=8000, names=2000, zips=500,
              typo=0.05)
RENTS = dict(rows=50_000, states=51, counties=1500, batch=256)
# pclean_tpu on the CPU on the same rents tables (B = 256, seeds 0-2) reached
# F1 0.8941, 0.8890 and 0.8914 (scripts/rents_jax_floor.py); the floor is
# the lowest less 0.03
RENTS_F1_FLOOR = 0.8890112089671738 - 0.03
FLIGHTS = dict(rows=2376, flights=100, websites=38)
# pclean_tpu on the CPU on the same flights tables (MH, 5 sweeps, B = 1,
# seeds 0-2) reached F1 1.0, 0.9934 and 1.0 (scripts/flights_jax_floor.py);
# the floor is the lowest less 0.03
FLIGHTS_F1_FLOOR = 0.9933812949640289 - 0.03


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


SOURCES = {
    "enum_logsumexp": ("pclean_tpu_torch/csrc/enum_logsumexp.cu",
                       "pclean_tpu/engine/propose.py:559"),
    "inv_cdf_sample": ("pclean_tpu_torch/csrc/inv_cdf_sample.cu",
                       "pclean_tpu/engine/propose.py:1153"),
    "obs_gather_sum": ("pclean_tpu_torch/csrc/obs_gather_sum.cu",
                       "pclean_tpu/engine/propose.py:296"),
    "gauss_suffstats": ("pclean_tpu_torch/csrc/gauss_suffstats.cu",
                        "pclean_tpu/engine/propose.py:1348"),
    "gauss_ext_term": ("pclean_tpu_torch/csrc/gauss_ext_term.cu",
                       "pclean_tpu/engine/propose.py:856"),
    "maybe_swap_ext": ("pclean_tpu_torch/csrc/maybe_swap_ext.cu",
                       "pclean_tpu/engine/propose.py:683"),
}
SCALED_KERNELS = ("enum_logsumexp", "inv_cdf_sample", "obs_gather_sum")
RENTS_KERNELS = ("gauss_suffstats", "gauss_ext_term")
FLIGHTS_KERNELS = ("enum_logsumexp", "inv_cdf_sample", "maybe_swap_ext")
PATHS = ("scaled", "rents", "flights")


def bench_kernels(ops, cm, dev):
    """K1-K3 at the two shapes the main path launches them at: the batch
    shape (B = batch_rows rows) and the sequential shape (one row), against
    the Hospital candidate axis, with the model's own AddTypos matrices for
    K3 (kernel_bench.main_path_inputs). Each is checked against its plain
    version, then timed with its plain version and library call."""
    from pclean_tpu_torch import kernel_bench as kb

    out = {name: dict(name=name, route="cuda", source=SOURCES[name][0],
                      replaces=SOURCES[name][1], bound_by="bytes")
           for name in SCALED_KERNELS}
    for shape, B in (("", BATCH), ("_r1", 1)):
        inp = kb.main_path_inputs(cm, dev, B)
        K, C = inp["K"], len(inp["mats"])
        err1 = kb.check_k1(ops, inp["exist"], inp["new"])
        k2 = kb.check_k2(ops, inp["logits"], inp["u"])
        err3 = kb.check_k3(ops, inp["mats"], inp["obs"], inp["word"])
        times = kb.time_kernels(ops, inp)
        nbytes = kb.kernel_bytes(inp)
        errs = {"enum_logsumexp": err1, "inv_cdf_sample": k2["max_abs_err"],
                "obs_gather_sum": err3}
        shapes = {
            "enum_logsumexp": f"exist [{B}, {K}], new [{B}]",
            "inv_cdf_sample": f"logits [{B}, {K + 1}], u [{B}]",
            "obs_gather_sum": f"obs [{B}, {C}], word [{C}, {K}], V = "
                              f"{[m.shape[0] for m in inp['mats']]}",
        }
        plans = {
            "enum_logsumexp": ops.enum_logsumexp_plan(B, K, "fk"),
            "inv_cdf_sample": ops.inv_cdf_plan(K + 1),
            "obs_gather_sum": ops.obs_gather_plan(
                B, K, [m.shape[0] for m in inp["mats"]]),
        }
        for name, k in out.items():
            for key in ("ms", "device_ms", "plain_ms", "library_ms",
                        "library_device_ms"):
                k[key + shape] = times[name].get(key)
            k["max_abs_err" + shape] = errs[name]
            k["bytes" + shape] = nbytes[name]
            k["bound_ms" + shape] = nbytes[name] / kb.HBM_BYTES_PER_S * 1e3
            k["shape" + shape] = shapes[name]
            k["plan" + shape] = plans[name]
        out["inv_cdf_sample"]["mismatch_rate" + shape] = k2["mismatch_rate"]
        out["inv_cdf_sample"]["boundary_gap" + shape] = k2["boundary_gap"]
        del inp, times
        torch.cuda.empty_cache()
    return list(out.values())


def bench_k1_shapes(ops, dev, census, batch_pick=None) -> dict:
    """K1, and K2 on K1's record, at `batch_pick` (R, mode, K) (the scaled
    path's batch shape: B = batch_rows, fk mode over the Hospital axis) and
    at every one-row shape holding >= 5% of K1's launches in `census`
    (ops.census() of a path), in the path's mode there, and at every
    one-row K2 shape holding >= 5% of K2's launches that no K1 shape
    covers (as a choice row of that length): checked in both modes (record
    bit-equal, logZ rtol 1e-6; K2 as in bench_kernels), then timed.
    Returns {kernel: [one dict per shape]}, with each shape's launches from
    the census."""
    from pclean_tpu_torch import kernel_bench as kb

    count = {(r["kernel"], r["mode"], r["rows"], r["K"]): r["launches"]
             for r in census}
    picks = [batch_pick] if batch_pick else []
    picks += [(1, r["mode"], r["K"]) for r in census
              if r["kernel"] == "enum_logsumexp" and r["rows"] == "r1"
              and r["share"] >= 0.05]
    k2_rows = {K + (mode == "fk") for _R, mode, K in picks}
    picks += [(1, "choice", r["K"]) for r in census
              if r["kernel"] == "inv_cdf_sample" and r["rows"] == "r1"
              and r["share"] >= 0.05 and r["K"] not in k2_rows]
    floor = kb.launch_floor_ms()
    out = {"enum_logsumexp": [], "inv_cdf_sample": []}
    for R, mode, K in picks:
        inp = kb.k1_inputs(dev, R, K, mode)
        other = kb.k1_inputs(dev, R, K, "choice" if mode == "fk" else "fk",
                             seed=1)
        err = kb.check_k1(ops, inp["exist"], inp["new"])
        err_other = kb.check_k1(ops, other["exist"], other["new"])
        k2 = kb.check_k2(ops, inp["logits"], inp["u"])
        t = kb.time_k1(ops, inp)
        rows = "r1" if R == 1 else "rn"
        bound = kb.k1_bytes(R, K, mode) / kb.HBM_BYTES_PER_S * 1e3
        K2 = inp["logits"].shape[1]
        bound2 = kb.k2_bytes(R, K2) / kb.HBM_BYTES_PER_S * 1e3
        out["enum_logsumexp"].append(dict(
            mode=mode, rows=R, K=K,
            launches=count.get(("enum_logsumexp", mode, rows, K), 0),
            plan=ops.enum_logsumexp_plan(R, K, mode), max_abs_err=err,
            max_abs_err_other_mode=err_other, ms=t["ms"],
            device_ms=t["device_ms"], plain_ms=t["plain_ms"],
            library_ms=t["library_ms"],
            library_device_ms=t["library_device_ms"], floor_ms=floor,
            bound_ms=bound, share_of_bound=bound / t["device_ms"]))
        out["inv_cdf_sample"].append(dict(
            rows=R, K=K2, launches=count.get(("inv_cdf_sample", None, rows,
                                              K2), 0),
            max_abs_err=k2["max_abs_err"], mismatch_rate=k2["mismatch_rate"],
            ms=t["k2_ms"], device_ms=t["k2_device_ms"],
            plain_ms=t["k2_plain_ms"], floor_ms=floor, bound_ms=bound2,
            share_of_bound=bound2 / t["k2_device_ms"]))
        for name, r in ((n, out[n][-1]) for n in out):
            print(f"{name} at {mode} R={R} K={r['K']}: launches "
                  f"{r['launches']} max_abs_err {r['max_abs_err']:.3g} "
                  f"device {r['device_ms']:.4f} ms (events {r['ms']:.4f}) "
                  f"bound {r['bound_ms']:.5f} ms floor {floor:.4f} ms "
                  f"library device {r.get('library_device_ms')} plan "
                  f"{r.get('plan')}", flush=True)
        del inp, other
        torch.cuda.empty_cache()
    return out


def bench_rents_kernels(ops, cm, arenas, params, obs_dev, floor) -> list:
    """K4 and K5 at the shapes the rents path launches them at
    (kernel_bench.rents_inputs on the rents state): checked against their
    plain versions, timed beside their plain versions, K4's library call,
    the bytes bound and the launch floor."""
    from pclean_tpu_torch import kernel_bench as kb

    inp = kb.rents_inputs(cm, arenas, params, obs_dev, RENTS["batch"])
    errs = {"gauss_suffstats": kb.check_k4(ops, inp["k4"]),
            "gauss_ext_term": kb.check_k5(ops, inp["k5"])}
    times = kb.time_k45(ops, inp)
    times["gauss_suffstats"]["call_split"] = kb.k4_call_split(ops, inp["k4"])
    nbytes = {"gauss_suffstats": kb.k4_bytes(inp["k4"]),
              "gauss_ext_term": kb.k5_bytes(inp["k5"])}
    k4, k5 = inp["k4"], inp["k5"]
    B, A = k5["idx"].shape
    shapes = {"gauss_suffstats": f"R = {k4['z'].shape[0]} referrers, cap "
                                 f"{k4['cap']}, C {k4['C']}",
              "gauss_ext_term": f"out [{B}, {A}], C {k5['tbl'].shape[1]}, "
                                f"E {k5['tbl'].shape[0]}"}
    plans = {"gauss_suffstats": ops.gauss_suffstats_plan(k4["z"].shape[0]),
             "gauss_ext_term": ops.gauss_ext_term_plan(B, A)}
    out = []
    for name in RENTS_KERNELS:
        out.append(dict(
            name=name, route="cuda", source=SOURCES[name][0],
            replaces=SOURCES[name][1], bound_by="bytes",
            max_abs_err=errs[name], bytes=nbytes[name],
            bound_ms=nbytes[name] / kb.HBM_BYTES_PER_S * 1e3,
            floor_ms=floor, shape=shapes[name], plan=plans[name],
            **times[name]))
        k = out[-1]
        print(f"{name}: {k['shape']}: max_abs_err {k['max_abs_err']:.3g} "
              f"kernel {k['ms']:.4f} ms (device {k['device_ms']:.4f} ms) "
              f"plain {k['plain_ms']:.4f} ms library {k['library_ms']} ms "
              f"bound {k['bound_ms']:.5f} ms floor {floor:.4f} ms plan "
              f"{k['plan']} library device {k.get('library_device_ms')} ms "
              f"call split {k.get('call_split')}", flush=True)
    del inp
    torch.cuda.empty_cache()
    return out


def bench_flights_k6(ops, eng, arenas, params, floor) -> dict:
    """K6 at the shape the flights path launches it at, one Flight slot
    against its referrers, for each time field (kernel_bench.flights_inputs
    on the flights state: the list form over the referrer bound where the
    model has one, else the dense form over every Obs row): checked against
    its plain version, timed beside it, with the bytes bound and the launch
    floor. The kernels-line numbers are the largest vocabulary's; `shapes`
    holds each field's."""
    from pclean_tpu_torch import kernel_bench as kb

    shapes = []
    for f in kb.flights_inputs(eng, arenas, params):
        k6 = f["k6"]
        nbytes = kb.k6_bytes(k6)
        N = k6["obs"].shape[-1]
        form = (f"list of {int(k6['cnt'][0])} of {N}" if "cnt" in k6
                else f"dense over {N}")
        shapes.append(dict(
            field=f["field"], rows=1, V=f["V"], N=N, form=form,
            max_abs_err=kb.check_k6(ops, k6), bytes=nbytes,
            bound_ms=nbytes / kb.HBM_BYTES_PER_S * 1e3, floor_ms=floor,
            plan=ops.maybe_swap_ext_plan(1, f["V"]), **kb.time_k6(ops, k6)))
        r = shapes[-1]
        print(f"maybe_swap_ext {r['field']}: out [1, {r['V']}], referrers "
              f"{form}: max_abs_err {r['max_abs_err']:.3g} kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms) plain "
              f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.6f} ms floor "
              f"{floor:.4f} ms", flush=True)
    top = max(shapes, key=lambda r: r["V"])
    torch.cuda.empty_cache()
    return dict({k: top[k] for k in ("max_abs_err", "ms", "device_ms",
                                     "plain_ms", "library_ms", "bytes",
                                     "bound_ms", "floor_ms", "plan")},
                name="maybe_swap_ext", route="cuda",
                source=SOURCES["maybe_swap_ext"][0],
                replaces=SOURCES["maybe_swap_ext"][1], bound_by="bytes",
                shape=f"out [1, {top['V']}], referrers {top['form']}",
                shapes=shapes)


def ptxas_lines(ops) -> dict:
    """Per kernel source, the ptxas -v lines of each compiled function:
    registers, shared memory, stack frame and spills."""
    keep = ("Compiling entry function", "registers", "stack frame")
    return {name: [ln.strip() for ln in log.splitlines()
                   if any(x in ln for x in keep)]
            for name, log in ops.BUILD_LOG.items()}


def _small_state(mod, small):
    """The workload's model on the CPU and on the card, and a reachable
    state from the port's CPU init (numpy)."""
    from pclean_tpu_torch.convert import to_numpy
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine

    res = {}
    for d in ("cpu", "cuda"):
        cm, cfg, _dirty, _clean, _q, _ = mod.setup(**small, device=d)
        res[d] = (cm, cfg)
    cm_c, cfg_c = res["cpu"]
    a, p = init_state(cm_c, 0, device="cpu")
    eng = Engine(cm_c, cfg_c, device="cpu")
    a, p, g = eng.initialize(1, a, p)
    if cfg_c.batch_rows <= 1:   # the flights times settle in the sweeps
        a, p, g = eng.run(g, a, p)
    return res, to_numpy(a), to_numpy(p)


def small_device_check(dev, workload="scaled"):
    """The tracer's CUDA path (kernels) against its CPU path (plain
    versions) on a small config, same state, same injected uniforms ->
    same logZ and sampled values. "scaled": experiments/scaled.py's CPU
    config, the Record block, logZ rtol 1e-5 atol 1e-5. "rents": 1,000
    rows, 12 states, 40 counties, the County block with its hoisted
    statistics (K4) and closed-form Gaussian external (K5); logZ rtol 1e-5
    and, per row, atol |sum_c szz| * 2^-20 / (2 * 150^2) + 1e-5 (K4's
    atomics and K5's sums add in another order before the closed form
    subtracts). "flights": 300 rows, 12 flights, 8 websites, capacities 16,
    after init and 2 sweeps; every block of six live and two dead Flight
    slots (the time block through K6) and of 16 Obs rows whose four times
    are observed (their MaybeSwap prior draws are discarded, so the two
    devices' generators do not matter), through Engine._propose; the block
    weights rtol 1e-5 and, per Flight row, atol 1e-5 * (sum over the four
    fields of the largest option's sum of |terms|) + 1e-5 (K6's
    tolerance)."""
    from pclean_tpu_torch import kernel_bench as kb
    from pclean_tpu_torch import ops
    from pclean_tpu_torch.convert import to_torch
    from pclean_tpu_torch.engine.propose import (BlockTracer, _draw_bound,
                                                 referrer_histograms)
    from pclean_tpu_torch.kernel_bench import require
    from pclean_tpu_torch.engine.refresh import refresh
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.workloads import flights, rents, scaled

    if workload == "scaled":
        mod, need = scaled, ("enum_logsumexp", "inv_cdf_sample",
                             "obs_gather_sum")
        small = dict(rows=512, hospitals=48, counties=12, names=24, zips=32,
                     batch=8)
    elif workload == "rents":
        mod, need = rents, ("gauss_suffstats", "gauss_ext_term")
        small = dict(rows=1000, states=12, counties=40, batch=16)
    else:
        mod, need = flights, FLIGHTS_KERNELS
        small = dict(rows=300, flights=12, websites=8, sweeps=2,
                     capacities={"Flight": 16, "TrackingWebsite": 16})
    res, arenas, params = _small_state(mod, small)
    if workload == "scaled":
        checks = [("Record", 0, np.arange(0, small["rows"], 8)[:64])]
    elif workload == "rents":   # the live slots first, and two dead ones
        alive = arenas["County"]["alive"]
        checks = [("County", 0, np.concatenate([
            np.flatnonzero(alive)[:62], np.flatnonzero(~alive)[:2]]))]
    else:
        rel = refresh(res["cpu"][0], to_torch(arenas, "cpu"),
                      Engine(*res["cpu"], device="cpu").obs_dev)
        alive = rel["Flight"]["alive"].numpy()
        spec = res["cpu"][0].obs_specs[0]
        full = np.all([spec.columns[v][1] == 1 for v in spec.columns], 0)
        checks = [("Flight", None, np.concatenate([
            np.flatnonzero(alive)[:6], np.flatnonzero(~alive)[:2]])),
                  ("Obs", None, np.flatnonzero(full)[:16])]
    worst = 0.0
    before = dict(ops.LAUNCHES)
    for cid, plan_idx, slots in checks:
        outs = {}
        for d in ("cpu", "cuda"):
            cm, cfg = res[d]
            e = Engine(cm, cfg, device=d)
            at, pt = to_torch(arenas, d), to_torch(params, d)
            rel = refresh(cm, at, e.obs_dev)
            hists = None if cm.layouts[cid].observed else \
                referrer_histograms(cm, cid, at, pt, rel, e.obs_dev)
            st = torch.as_tensor(slots, device=d)
            plans = cm.cls(cid).plans if plan_idx is None \
                else [cm.cls(cid).plans[plan_idx]]
            pools = [torch.as_tensor(np.random.default_rng(1 + i).random(
                (len(slots), _draw_bound(cm, cid, pl))).astype(np.float32),
                device=d) for i, pl in enumerate(plans)]
            if plan_idx is None:
                gen = torch.Generator(device=d)
                gen.manual_seed(0)
                env, _b, logz = e._propose(cid, at, rel, pt, st, gen, False,
                                           ext_hists=hists, pools=pools)
            else:
                tr = BlockTracer(cm, cid, at, rel, pt, e.obs_dev,
                                 e._obs_row_slices(cid, st, rel), {}, st,
                                 ext_hists=hists)
                logz, r = tr.run(plans[0], pool=pools[0])
                env = r.env
            atol = torch.full((len(slots),), 1e-5)
            gauss = [v for v in (hists or {}).values()
                     if isinstance(v, tuple)]
            if gauss:
                atol = atol + gauss[0][3][st].sum(-1).abs().cpu() \
                    * 2.0 ** -20 / (2 * 150.0 ** 2)
            if cid == "Flight" and d == "cpu":
                for f in kb.flights_inputs(e, at, pt, st):
                    mag = ops.maybe_swap_ext_plain(**f["k6"], absolute=True)
                    atol = atol + 1e-5 * mag.amax(-1)
            outs[d] = (logz.cpu(), {v: x.cpu() for v, x in env.items()},
                       atol)
        dz = (outs["cuda"][0] - outs["cpu"][0]).abs()
        require(bool((dz <= outs["cpu"][2] + 1e-5 * outs["cpu"][0].abs())
                     .all()), f"{workload} {cid}: CUDA logZ differs by "
                f"{float(dz.max())}")
        for v, x in outs["cpu"][1].items():
            require(torch.equal(x.double(), outs["cuda"][1][v].double()),
                    f"{workload} {cid}: sampled vertex {v} differs")
        worst = max(worst, float(dz.max()))
    launched = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
    require(all(launched[k] > 0 for k in need),
            f"{workload} small check: kernels not launched: {launched}")
    return worst, launched


def run_path(ops, name, cm, config, dirty, clean, query, rows):
    """One workload's main path, with every launch count set to 0 just
    before it and read just after: init_state, Engine.initialize,
    Engine.run, evaluate_accuracy_device. Returns its report (and the
    state, for the kernel inputs drawn from it)."""
    from pclean_tpu_torch.analysis import evaluate_accuracy_device
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine

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
    launches = dict(ops.LAUNCHES)
    by_shape = {k: dict(v) for k, v in ops.LAUNCHES_BY_SHAPE.items()}
    census = ops.census()
    res = evaluate_accuracy_device(cm, arenas, params, dirty, clean, query)
    occ = eng.arena_occupancy(arenas)
    rep = dict(rows=rows, batch_rows=config.batch_rows, init_s=init_s,
               sweep_s=sweep_s, rows_cleaned_per_s=rows / (init_s + sweep_s),
               f1=res["f1"], precision=res["precision"],
               recall=res["recall"], occupancy=occ,
               phase_times=eng.phase_times,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=launches, launches_by_shape=by_shape, census=census)
    print(f"{name} path ({rows} rows, B={config.batch_rows}): init "
          f"{init_s:.2f} s, sweep {sweep_s:.2f} s, rows-cleaned/s "
          f"{rep['rows_cleaned_per_s']:.1f}", flush=True)
    print(f"{name} phases (wall s): {eng.phase_times}")
    print(f"{name} F1 {res['f1']:.4f} precision {res['precision']:.4f} "
          f"recall {res['recall']:.4f}; occupancy {occ}; "
          f"max_memory_allocated {rep['max_memory_allocated']}")
    print(f"{name} launches: {launches}; by shape (r1 = one row, rn = "
          f"more): {by_shape}", flush=True)
    for r in census:
        print(f"{name} census {r['kernel']} {r['mode'] or '-'} {r['rows']} "
              f"K={r['K']}: {r['launches']} ({100 * r['share']:.1f}%)")
    return rep, (arenas, params, eng)


def main() -> int:
    args = sys.argv[1:]
    out_dir = args[args.index("--out") + 1] if "--out" in args else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from pclean_tpu_torch import kernel_bench as kb
    from pclean_tpu_torch import ops
    from pclean_tpu_torch.kernel_bench import require
    from pclean_tpu_torch.workloads import flights, rents, scaled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    build_s = ops.build_kernels(force=True)
    print(f"kernel build: {build_s:.2f} s", flush=True)
    ptxas = ptxas_lines(ops)
    for name, lines in ptxas.items():
        for line in lines:
            print(f"  ptxas {name}: {line}")
    report = {"card": card, "build_s": build_s, "torch": torch.__version__,
              "cuda": torch.version.cuda, "ptxas": ptxas}
    for wl in PATHS:
        err, launched = small_device_check(dev, wl)
        report[f"small_check_{wl}_max_abs_err"] = err
        print(f"tracer cuda-vs-cpu check on the small {wl} config: max "
              f"|dlogZ| {err:.3g}, launches {launched}", flush=True)

    # the scaled path, then K1-K3 at its shapes
    t = time.time()
    cm, config, dirty, clean, query, _sweeps = scaled.setup(
        rows=ROWS, batch=BATCH, device="cuda", **SCALED)
    report["compile_s"] = time.time() - t
    caps = {c: cm.layouts[c].capacity for c in cm.model.class_order}
    print(f"scaled compile_model: {report['compile_s']:.2f} s, capacities "
          f"{caps}", flush=True)
    sc, _state = run_path(ops, "scaled", cm, config, dirty, clean, query,
                          ROWS)
    del _state
    report.update(sc)  # the scaled path's numbers at the report's top level
    # after the path, so that its peak memory is its own (CUDA graph timing
    # leaves allocator state behind, about 0.1 GB)
    kernels = bench_kernels(ops, cm, dev)
    for k in kernels:
        for sh in ("", "_r1"):
            print(f"{k['name']}: {k['shape' + sh]}: max_abs_err "
                  f"{k['max_abs_err' + sh]:.3g} kernel {k['ms' + sh]:.4f} ms"
                  f" (device {k['device_ms' + sh]:.4f} ms) plain "
                  f"{k['plain_ms' + sh]:.4f} ms library "
                  f"{k['library_ms' + sh]} ms (device "
                  f"{k['library_device_ms' + sh]} ms) bound "
                  f"{k['bound_ms' + sh]:.4f}"
                  f" ms ({k['bound_by']}) plan {k.get('plan' + sh)}",
                  flush=True)
    shapes = bench_k1_shapes(ops, dev, sc["census"], batch_pick=(
        BATCH, "fk", cm.layouts["Hospital"].capacity))
    del cm, dirty, clean, query
    torch.cuda.empty_cache()

    # the rents path, then K4 and K5 at its shapes
    t = time.time()
    cm, config, dirty, clean, query, _sweeps = rents.setup(
        rows=RENTS["rows"], states=RENTS["states"],
        counties=RENTS["counties"], batch=RENTS["batch"], device="cuda")
    compile_s = time.time() - t
    print(f"rents compile_model: {compile_s:.2f} s, capacities "
          f"{ {c: cm.layouts[c].capacity for c in cm.model.class_order} }, "
          f"referrer bounds {list(cm.ref_bounds.values())}", flush=True)
    rn, (arenas, params, eng) = run_path(ops, "rents", cm, config, dirty,
                                         clean, query, RENTS["rows"])
    report["rents"] = dict(rn, compile_s=compile_s, f1_floor=RENTS_F1_FLOOR)
    floor = kb.launch_floor_ms()
    kernels += bench_rents_kernels(ops, cm, arenas, params, eng.obs_dev,
                                   floor)
    del cm, dirty, clean, query, arenas, params, eng
    torch.cuda.empty_cache()

    # the flights path (batch_rows 1), then K6, K1 and K2 at its shapes
    t = time.time()
    cm, config, dirty, clean, query, _sweeps = flights.setup(
        **FLIGHTS, device="cuda")
    compile_s = time.time() - t
    print(f"flights compile_model: {compile_s:.2f} s, capacities "
          f"{ {c: cm.layouts[c].capacity for c in cm.model.class_order} }, "
          f"exact Gibbs {cm.exact_gibbs_ok}", flush=True)
    fl, (arenas, params, eng) = run_path(ops, "flights", cm, config, dirty,
                                         clean, query, FLIGHTS["rows"])
    report["flights"] = dict(fl, compile_s=compile_s,
                             f1_floor=FLIGHTS_F1_FLOOR)
    kernels.append(bench_flights_k6(ops, eng, arenas, params, floor))
    fl_shapes = bench_k1_shapes(ops, dev, fl["census"])
    runs = {"scaled": sc, "rents": rn, "flights": fl}
    for k in kernels:
        for path, r in runs.items():
            k[f"launches_{path}"] = r["launches"][k["name"]]
        k["launches"] = sum(k[f"launches_{p}"] for p in PATHS)
        if k["name"] in SCALED_KERNELS:
            k["launches_r1"] = sc["launches_by_shape"][k["name"]]["r1"]
            k["launches_rn"] = sc["launches_by_shape"][k["name"]]["rn"]
        if k["name"] in shapes:
            k["shapes"] = shapes[k["name"]]
            k["shapes_flights"] = fl_shapes[k["name"]]
    for path, need in (("scaled", SCALED_KERNELS), ("rents", RENTS_KERNELS),
                       ("flights", FLIGHTS_KERNELS)):
        missing = [k for k in need if runs[path]["launches"][k] <= 0]
        require(not missing, f"kernels never launched on the {path} path: "
                f"{missing}")
    require(sc["f1"] >= 0.80, f"scaled F1 {sc['f1']} < 0.80")
    require(rn["f1"] >= RENTS_F1_FLOOR,
            f"rents F1 {rn['f1']} < {RENTS_F1_FLOOR}")
    require(fl["f1"] >= FLIGHTS_F1_FLOOR,
            f"flights F1 {fl['f1']} < {FLIGHTS_F1_FLOOR}")
    report["total_s"] = time.time() - t0
    report["kernels"] = kernels
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "launches_scaled",
            "launches_rents", "launches_flights", "launches_r1", "ms_r1",
            "device_ms_r1", "plain_ms_r1", "bound_ms_r1", "library_ms_r1",
            "floor_ms", "shapes", "shapes_flights")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys if k in kk}
                                  for kk in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
