"""Chip smoke run of the PyTorch/CUDA port (pclean_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the full run (one card)
    python3 chip_smoke.py --out DIR  # also write the details to
                                     # DIR/chip_smoke.json

It drives the port only (never jax, never pclean_tpu), in order:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the eight CUDA kernels from pclean_tpu_torch/csrc/ (one nvcc per
     source, in parallel) and prints the build time and ptxas's registers,
     shared memory, stack frame and spills for each compiled function;
  3. checks the tracer's CUDA path against its CPU path (plain versions) on
     small inputs: same state, same injected uniforms, for the scaled
     workload's Record block, the rents workload's County block (K4's
     statistics and K5's closed form), the flights workload's Flight
     time block (K6) and Obs blocks, and the hospital workload's two
     Record blocks and its County and Measure blocks (K7's hoisted
     histograms, K8's composed stateavg term);
  4. runs the scaled workload's main path end to end — compile_model,
     init_state, Engine.initialize (sequential ramp, batched init segments,
     batched birth allocation, replay), Engine.run (segmented batched MH
     sweep with resample_all), evaluate_accuracy_device — at the entity
     counts of experiments/scaled.py (8,000 hospitals, 1,000 counties,
     2,000 names, 500 zips, typo 0.05, capacities Hospital 11,264 and
     County 1,472, batch_rows 4096, 1 sweep) with the rows cut from the
     source's 1,000,000 to 100,000 so the run fits its time limit; prints
     init s, sweep s, rows-cleaned/s, F1, precision, recall, arena
     occupancy, peak device memory (and what was allocated before the
     path) and each kernel's launches on that run, split into one-row
     (r1) and batched (rn) launches, and the launch census of K1, K2, K3,
     K7 and K8 by (mode, r1 or rn, row length K);
  5. right after each path, on its state, K7 and K8 at every shape of its
     census (kernel_bench.k7_census_inputs, k8_census_inputs: hoisted
     histograms over every source row, per-row histograms and composed terms
     at one row or B rows against every source row); after the scaled path
     also K1-K3 at the batch shape and at one row with the model's own
     AddTypos matrices (kernel_bench.main_path_inputs); and after all four
     paths (so that the CUDA graphs of the timings leave nothing in a path's
     peak memory), for each path, K1, and K2 on K1's record, at every census
     shape holding >= SHAPE_SHARE of the path's one-row or of its batched
     launches, in the path's mode there (K1 also checked in the other mode),
     and K3 likewise (seeded matrices of the launch's vocabularies,
     kernel_bench.k3_seeded). Each shape: its error against the plain
     PyTorch version on the card (with the tolerance stated below), kernel /
     plain / library ms (median of CUDA events around one call, host side
     included where it is longer), the kernel's device time per call
     (`device_ms`: median over replays of a CUDA graph of many calls), the
     bytes bound on an H100 (3.35 TB/s), the launch floor (device time of
     one PyTorch op on one element) and the launch plan;
  6. runs the rents path end to end (pclean_tpu_torch/workloads/rents.py,
     the port's copy of experiments/rents.py on its seeded synthetic rents
     tables) at the source's 50,000 rows, 51 states, about 1,500 counties,
     County capacity 4,096, batch_rows 256, 1 sweep, rejuv_frequency 500,
     with the counts set to 0 just before it and read just after: the same
     report; then K4 and K5 at its shapes (K4 over the 50,000 Obs rows into
     County's 4,096 slots, K5 over 256 County rows and 51 states,
     kernel_bench.rents_inputs; K4's library call is one index_add_ of the
     stacked [R, 3] statistics, K5 has none; where one K4 call's host time
     goes, kernel_bench.k4_call_split) and K7 as in step 5;
  7. runs the flights path end to end (pclean_tpu_torch/workloads/
     flights.py, the port's copy of experiments/flights.py on its seeded
     synthetic flights tables) at the source's 2,376 rows, 100 flights, 38
     websites, capacities Flight 160 and TrackingWebsite 64, MH, 5 sweeps,
     batch_rows 1 (the sequential drivers), rejuv_frequency 50: the same
     report; then K6 at its shape (one Flight slot against the 2,376 Obs
     rows, for each time field's vocabulary, kernel_bench.flights_inputs);
  8. runs the hospital path end to end (pclean_tpu_torch/workloads/
     hospital.py, the port's copy of experiments/hospital.py on its seeded
     synthetic hospital tables) at the source's config: 1,000 rows tiled
     100 times, capacities of experiments/hospital.py, MH, 1 sweep,
     batch_rows 4096 (bench.py:238-239): the same report, then K7 and K8
     as in step 5 (K7's library call is one torch.bincount, K8 has none);
  9. prints, for each kernel, how many shapes were checked and the worst
     error, then the `kernels` JSON line (K1-K8; `launches` summed over
     the four paths, with each path's own beside it; `max_abs_err` the
     worst over every shape checked; the times those of the shape named in
     `shape`; every shape's numbers in chip_smoke.json under --out), then
     the card line, then the result.

Tolerances: K1 record bit-equal, logZ within 1e-6 of the larger of |logZ|
and the row's |max| (the same f32 formula, max + log(sum of exp), summed in
another order; logZ can lie near 0 in a row of a few options); K2 indices
equal on all but <= 1e-2 of rows (at 100 rows or more), and every differing
row's threshold within 1e-5 of the total from the exact prefix sums between
the two picks (the kernel's exact fixed-point prefix sums and
torch.cumsum's f32 ones round differently: at K ~ 11k logits about one row
in a thousand sits that close to a boundary), never a zero-mass pick; K3
bit-equal (same column order); K4's counts equal and its sums within 1e-5
of each cell's sum of |terms| (atomics add in any order); K5 within 2^-20 *
|coef| * (|sum szz| + 2 |sum mu sz| + |sum mu^2 n|) + 1e-5 (its f32 sums
subtract); K6 within 1e-5 of each cell's sum of |terms| + 1e-6 (the same
terms summed in another order); K7 bit-equal (integer counts); K8 within
1e-5 of each cell's sum of |terms| + 1e-6 (double sums in referrer order
against an f32 histogram-times-SA product). It fails (non-zero exit, no
result line) if there is no card, a kernel does not build, launch or agree,
K1-K3 were not launched on the scaled path, K4 and K5 not on the rents
path, K1, K2 and K6 not on the flights path or K1-K3, K7 and K8 not on the
hospital path, the scaled F1 < SCALED_F1_FLOOR (0.80), the rents F1 <
RENTS_F1_FLOOR, the flights F1 < FLIGHTS_F1_FLOOR, the hospital F1 <
HOSPITAL_F1_FLOOR, or any phase raises.
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
SCALED_F1_FLOOR = 0.80
RENTS = dict(rows=50_000, states=51, counties=1500, batch=256)
# pclean_tpu on the CPU on the same rents tables (B = 256, seeds 0-2) reached
# F1 0.8941, 0.8890 and 0.8914 (scripts/rents_jax_floor.py); the floor is
# the lowest less 0.03
RENTS_F1_FLOOR = 0.8890112089671738 - 0.03
FLIGHTS = dict(rows=2376, flights=100, websites=38, sweeps=5)
# pclean_tpu on the CPU on the same flights tables (MH, 5 sweeps, B = 1,
# seeds 0-2) reached F1 1.0, 0.9934 and 1.0 (scripts/flights_jax_floor.py);
# the floor is the lowest less 0.03
FLIGHTS_F1_FLOOR = 0.9933812949640289 - 0.03
HOSPITAL = dict(rows=1000, repeat=100, batch=4096)
# pclean_tpu on the CPU on the same hospital tables (MH, 1 sweep, seeds 0-2,
# at 5,000 rows and B = 256: 100,000 rows at B = 4096 do not fit a CPU host)
# reached F1 0.99945, 0.99931 and 0.99931 (scripts/hospital_jax_floor.py);
# the floor is the lowest less 0.03
HOSPITAL_F1_FLOOR = 0.9993136582017845 - 0.03
# K1-K3 are checked at every census shape holding at least this share of
# a path's one-row, or of its batched, launches of the kernel; K7 and K8 at
# every census shape
SHAPE_SHARE = 0.01


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
    "referrer_hist": ("pclean_tpu_torch/csrc/referrer_hist.cu",
                      "pclean_tpu/engine/propose.py:1399"),
    "sa_ext_term": ("pclean_tpu_torch/csrc/sa_ext_term.cu",
                    "pclean_tpu/engine/propose.py:801"),
}
SCALED_KERNELS = ("enum_logsumexp", "inv_cdf_sample", "obs_gather_sum")
RENTS_KERNELS = ("gauss_suffstats", "gauss_ext_term")
FLIGHTS_KERNELS = ("enum_logsumexp", "inv_cdf_sample", "maybe_swap_ext")
HOSPITAL_KERNELS = ("enum_logsumexp", "inv_cdf_sample", "obs_gather_sum",
                    "referrer_hist", "sa_ext_term")
PATHS = ("scaled", "rents", "flights", "hospital")


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


def census_picks(census, kernel: str, rows: str) -> list:
    """The census rows of `kernel` in row class `rows` ("r1" or "rn") that
    hold at least SHAPE_SHARE of that class's launches."""
    mine = [r for r in census if r["kernel"] == kernel and r["rows"] == rows]
    total = sum(r["launches"] for r in mine)
    return [r for r in mine if r["launches"] >= SHAPE_SHARE * total]


def bench_k1_shapes(ops, dev, census, B: int) -> dict:
    """K1, and K2 on K1's record, at every shape of a path's census
    (ops.census()) holding >= SHAPE_SHARE of K1's one-row or batched
    launches, at one row or B rows, in the path's mode there, and at every
    such K2 shape that no K1 shape covers (as a choice row of that length):
    checked in both modes (kernel_bench.check_k1; K2 as in bench_kernels),
    then timed. Returns {kernel: [one dict per shape]},
    with each shape's launches from the census."""
    from pclean_tpu_torch import kernel_bench as kb

    count = {(r["kernel"], r["mode"], r["rows"], r["K"]): r["launches"]
             for r in census}
    picks = []
    for rows, R in (("rn", B), ("r1", 1)):
        mine = [(R, r["mode"], r["K"])
                for r in census_picks(census, "enum_logsumexp", rows)]
        k2_rows = {K + (mode == "fk") for _R, mode, K in mine}
        picks += mine + [(R, "choice", r["K"])
                         for r in census_picks(census, "inv_cdf_sample", rows)
                         if r["K"] not in k2_rows]
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


def bench_k3_shapes(ops, dev, census, B: int) -> list:
    """K3 at every shape of a path's census holding >= SHAPE_SHARE of its
    one-row or batched launches (one row or B rows, the launch's
    vocabularies, row length K), on seeded inputs (kernel_bench.k3_seeded):
    checked bit-equal against its plain version, timed beside it and the
    one-hot matmul, with the bytes bound."""
    from pclean_tpu_torch import kernel_bench as kb

    out = []
    for rows, R in (("rn", B), ("r1", 1)):
        for r in census_picks(census, "obs_gather_sum", rows):
            Vs = [int(v) for v in r["mode"].split(",")]
            k3 = kb.k3_seeded(dev, R, r["K"], Vs)
            nbytes = kb.k3_bytes(k3)
            out.append(dict(
                rows=R, K=r["K"], Vs=Vs, launches=r["launches"],
                max_abs_err=kb.check_k3(ops, k3["mats"], k3["obs"],
                                        k3["word"]),
                bytes=nbytes, bound_ms=nbytes / kb.HBM_BYTES_PER_S * 1e3,
                plan=ops.obs_gather_plan(R, r["K"], Vs), **kb.time_k3(ops,
                                                                     k3)))
            k = out[-1]
            print(f"obs_gather_sum at R={R} K={r['K']} V={Vs}: launches "
                  f"{k['launches']} max_abs_err {k['max_abs_err']:.3g} "
                  f"device {k['device_ms']:.4f} ms (events {k['ms']:.4f}) "
                  f"plain {k['plain_ms']:.4f} ms library device "
                  f"{k['library_device_ms']:.4f} ms bound "
                  f"{k['bound_ms']:.5f} ms plan {k['plan']}", flush=True)
            del k3
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


def bench_k7_k8_shape(ops, name, label, form, k, floor) -> dict:
    """K7 (`form` "hoisted" or "rows") or K8 on the inputs `k`: checked
    against its plain version, timed beside it (K7 also beside its library
    call, torch.bincount), with the bytes bound, the launch floor and the
    plan."""
    from pclean_tpu_torch import kernel_bench as kb

    if name == "referrer_hist":
        err, nbytes, t = kb.check_k7(ops, k), kb.k7_bytes(k), \
            kb.time_k7(ops, k)
        R = k["w"].shape[-1]
        G = k["cap"] if form == "hoisted" else k["w"].shape[0]
        plan = ops.referrer_hist_plan(R, G, k["V"], form == "rows")
        shape = (f"{form}: out [{G}, {k['V']}], {R} referrers"
                 + (f", {len(k['hops'])} hop(s)" if form == "hoisted"
                    else ""))
    else:
        err, nbytes, t = kb.check_k8(ops, k), kb.k8_bytes(k), \
            kb.time_k8(ops, k)
        E, Vc, V = k["SA"].shape
        B, R = k["w"].shape
        plan = ops.sa_ext_term_plan(B, E)
        shape = (f"out [{B}, {E}], SA [{E}, {Vc}, {V}], {R} referrers, "
                 f"{int(k['w'].sum())} kept")
    r = dict(label=label, shape=shape, max_abs_err=err, bytes=nbytes,
             bound_ms=nbytes / kb.HBM_BYTES_PER_S * 1e3, floor_ms=floor,
             plan=plan, **t)
    print(f"{name} {label}: {shape}: max_abs_err {err:.3g} kernel "
          f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms) plain "
          f"{r['plain_ms']:.4f} ms library {r['library_ms']} ms bound "
          f"{r['bound_ms']:.5f} ms floor {floor:.4f} ms plan {plan}",
          flush=True)
    return r


def bench_k7_k8_census(ops, eng, arenas, params, census, B: int, path: str,
                       floor) -> dict:
    """K7 and K8 at every shape of a path's launch census, on inputs from
    its state (kernel_bench.k7_census_inputs, k8_census_inputs), through
    bench_k7_k8_shape. Returns {kernel: [one dict per shape]}, each with
    the path, its batched-or-one-row class and its launches."""
    from pclean_tpu_torch import kernel_bench as kb

    out = {"referrer_hist": [], "sa_ext_term": []}
    for name, inputs in (
            ("referrer_hist", kb.k7_census_inputs(eng, arenas, params,
                                                  census, B)),
            ("sa_ext_term", kb.k8_census_inputs(eng, arenas, params, census,
                                                B))):
        for r, cid, k in inputs:
            form = r["mode"] if name == "referrer_hist" else "rows"
            label = f"{path} {cid} {r['rows']} ({r['launches']} launches)"
            out[name].append(dict(
                bench_k7_k8_shape(ops, name, label, form, k, floor),
                path=path, rows=r["rows"], launches=r["launches"]))
            del k
    torch.cuda.empty_cache()
    return out


def k7_k8_entry(name: str, shapes: list) -> dict:
    """K7's or K8's kernels-line entry: the numbers of the hospital path's
    batched shape that moves the most bytes (K7: its largest hoisted
    histogram; K8: the County or Measure sweep)."""
    top = max((r for r in shapes
               if r["path"] == "hospital" and r["rows"] == "rn"),
              key=lambda r: r["bytes"])
    return dict({key: top[key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
        "library_device_ms", "bytes", "bound_ms", "floor_ms", "plan",
        "shape")}, name=name, route="cuda", source=SOURCES[name][0],
        replaces=SOURCES[name][1], bound_by="bytes")


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
    from pclean_tpu_torch.workloads import flights, hospital, rents, scaled

    if workload == "scaled":
        mod, need = scaled, ("enum_logsumexp", "inv_cdf_sample",
                             "obs_gather_sum")
        small = dict(rows=512, hospitals=48, counties=12, names=24, zips=32,
                     batch=8)
    elif workload == "rents":
        mod, need = rents, ("gauss_suffstats", "gauss_ext_term")
        small = dict(rows=1000, states=12, counties=40, batch=16)
    elif workload == "hospital":
        mod, need = hospital, ("referrer_hist", "sa_ext_term")
        small = dict(rows=240, batch=16)
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
    elif workload == "hospital":   # both Record blocks, the composed term
        rel = refresh(res["cpu"][0], to_torch(arenas, "cpu"),
                      Engine(*res["cpu"], device="cpu").obs_dev)
        checks = [("Record", None, np.arange(0, small["rows"], 15))]
        for cid in ("County", "Measure"):
            alive = rel[cid]["alive"].numpy()
            checks.append((cid, 0, np.concatenate([
                np.flatnonzero(alive)[:14], np.flatnonzero(~alive)[:2]])))
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
    at_start = torch.cuda.memory_allocated()
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
               memory_allocated_at_start=at_start, launches=launches,
               launches_by_shape=by_shape, census=census)
    print(f"{name} path ({rows} rows, B={config.batch_rows}): init "
          f"{init_s:.2f} s, sweep {sweep_s:.2f} s, rows-cleaned/s "
          f"{rep['rows_cleaned_per_s']:.1f}", flush=True)
    print(f"{name} phases (wall s): {eng.phase_times}")
    print(f"{name} F1 {res['f1']:.4f} precision {res['precision']:.4f} "
          f"recall {res['recall']:.4f}; occupancy {occ}; "
          f"max_memory_allocated {rep['max_memory_allocated']} (of which "
          f"allocated before the path {at_start})")
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
    from pclean_tpu_torch.workloads import flights, hospital, rents, scaled

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
    floor = kb.launch_floor_ms()
    for wl in PATHS:
        err, launched = small_device_check(dev, wl)
        report[f"small_check_{wl}_max_abs_err"] = err
        print(f"tracer cuda-vs-cpu check on the small {wl} config: max "
              f"|dlogZ| {err:.3g}, launches {launched}", flush=True)

    checked = {name: [] for name in SOURCES}   # every shape checked

    def add(path, res):
        for name, rows in res.items():
            checked[name] += [dict(r, path=path) for r in rows]

    def phase(what):
        report["phase_s"][what] = time.time() - t0
        print(f"[{time.time() - t0:.1f} s] {what}", flush=True)

    report["phase_s"] = {}
    # the scaled path, K7 and K8 at its census shapes while its state
    # lives, then K1-K3 on the model's own matrices
    phase("scaled path")
    t = time.time()
    cm, config, dirty, clean, query, _sweeps = scaled.setup(
        rows=ROWS, batch=BATCH, device="cuda", **SCALED)
    report["compile_s"] = time.time() - t
    caps = {c: cm.layouts[c].capacity for c in cm.model.class_order}
    print(f"scaled compile_model: {report['compile_s']:.2f} s, capacities "
          f"{caps}", flush=True)
    sc, (arenas, params, eng) = run_path(ops, "scaled", cm, config, dirty,
                                         clean, query, ROWS)
    report.update(sc)  # the scaled path's numbers at the report's top level
    # after the path, so that its peak memory is its own (CUDA graph timing
    # leaves allocator state behind, about 0.1 GB)
    phase("scaled kernel checks")
    add("scaled", bench_k7_k8_census(ops, eng, arenas, params, sc["census"],
                                     BATCH, "scaled", floor))
    del arenas, params, eng
    torch.cuda.empty_cache()
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
            add("scaled", {k["name"]: [dict(
                shape=k["shape" + sh], max_abs_err=k["max_abs_err" + sh],
                device_ms=k["device_ms" + sh], bound_ms=k["bound_ms" + sh],
                model_inputs=True)]})
    del cm, dirty, clean, query
    torch.cuda.empty_cache()

    # the rents path, then K4, K5 and K7 at its shapes
    phase("rents path")
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
    phase("rents kernel checks")
    kernels += bench_rents_kernels(ops, cm, arenas, params, eng.obs_dev,
                                   floor)
    add("rents", {k["name"]: [k] for k in kernels[-2:]})
    add("rents", bench_k7_k8_census(ops, eng, arenas, params, rn["census"],
                                    RENTS["batch"], "rents", floor))
    del cm, dirty, clean, query, arenas, params, eng
    torch.cuda.empty_cache()

    # the flights path (batch_rows 1), then K6 at its shapes
    phase("flights path")
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
    phase("flights kernel checks")
    kernels.append(bench_flights_k6(ops, eng, arenas, params, floor))
    add("flights", {"maybe_swap_ext": kernels[-1].pop("shapes")})
    del cm, dirty, clean, query, arenas, params, eng
    torch.cuda.empty_cache()

    # the hospital path (100,000 rows, B = 4096), then K7 and K8 at its
    # shapes
    phase("hospital path")
    t = time.time()
    cm, config, dirty, clean, query, _sweeps = hospital.setup(
        **HOSPITAL, device="cuda")
    compile_s = time.time() - t
    rows = HOSPITAL["rows"] * HOSPITAL["repeat"]
    print(f"hospital compile_model: {compile_s:.2f} s, capacities "
          f"{ {c: cm.layouts[c].capacity for c in cm.model.class_order} }, "
          f"composed SA tensors "
          f"{[a.shape for a in cm._ext_sa_cache.values()]}", flush=True)
    hp, (arenas, params, eng) = run_path(ops, "hospital", cm, config, dirty,
                                         clean, query, rows)
    report["hospital"] = dict(hp, compile_s=compile_s,
                              f1_floor=HOSPITAL_F1_FLOOR)
    phase("hospital kernel checks")
    add("hospital", bench_k7_k8_census(ops, eng, arenas, params,
                                       hp["census"], BATCH, "hospital",
                                       floor))
    del cm, dirty, clean, query, arenas, params, eng
    torch.cuda.empty_cache()

    # K1-K3 at every path's census shapes, on seeded inputs: last, so that
    # the CUDA graphs they are timed in leave nothing behind in a path's
    # peak memory
    runs = {"scaled": sc, "rents": rn, "flights": fl, "hospital": hp}
    for path, B in (("scaled", BATCH), ("rents", RENTS["batch"]),
                    ("flights", 1), ("hospital", BATCH)):
        phase(f"{path} K1-K3 census shapes")
        add(path, bench_k1_shapes(ops, dev, runs[path]["census"], B))
        add(path, {"obs_gather_sum": bench_k3_shapes(
            ops, dev, runs[path]["census"], B)})
    kernels += [k7_k8_entry(name, checked[name])
                for name in ("referrer_hist", "sa_ext_term")]
    phase("done")

    for k in kernels:
        for path, r in runs.items():
            k[f"launches_{path}"] = r["launches"][k["name"]]
        k["launches"] = sum(k[f"launches_{p}"] for p in PATHS)
        if k["name"] in SCALED_KERNELS:
            k["launches_r1"] = sc["launches_by_shape"][k["name"]]["r1"]
            k["launches_rn"] = sc["launches_by_shape"][k["name"]]["rn"]
        # the line's error is the worst of every shape checked
        shapes = checked[k["name"]]
        k["shapes_checked"] = len(shapes)
        k["max_abs_err"] = max(
            [k["max_abs_err"]] + [r["max_abs_err"] for r in shapes]
            + [r.get("max_abs_err_other_mode", 0.0) for r in shapes])
        k["shapes"] = shapes
        print(f"{k['name']}: {len(shapes)} shapes checked on "
              f"{sorted({r['path'] for r in shapes})}, worst max_abs_err "
              f"{k['max_abs_err']:.3g}", flush=True)
    for path, need in (("scaled", SCALED_KERNELS), ("rents", RENTS_KERNELS),
                       ("flights", FLIGHTS_KERNELS),
                       ("hospital", HOSPITAL_KERNELS)):
        missing = [k for k in need if runs[path]["launches"][k] <= 0]
        require(not missing, f"kernels never launched on the {path} path: "
                f"{missing}")
    require(sc["f1"] >= SCALED_F1_FLOOR,
            f"scaled F1 {sc['f1']} < {SCALED_F1_FLOOR}")
    require(rn["f1"] >= RENTS_F1_FLOOR,
            f"rents F1 {rn['f1']} < {RENTS_F1_FLOOR}")
    require(fl["f1"] >= FLIGHTS_F1_FLOOR,
            f"flights F1 {fl['f1']} < {FLIGHTS_F1_FLOOR}")
    require(hp["f1"] >= HOSPITAL_F1_FLOOR,
            f"hospital F1 {hp['f1']} < {HOSPITAL_F1_FLOOR}")
    report["total_s"] = time.time() - t0
    report["kernels"] = kernels
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "launches_scaled",
            "launches_rents", "launches_flights", "launches_hospital",
            "launches_r1", "ms_r1",
            "device_ms_r1", "plain_ms_r1", "bound_ms_r1", "library_ms_r1",
            "floor_ms", "shape", "shapes_checked")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys if k in kk}
                                  for kk in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
