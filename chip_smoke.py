"""Chip smoke run of the PyTorch/CUDA port (pclean_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the full run (one card)
    python3 chip_smoke.py --out DIR  # also write the details to
                                     # DIR/chip_smoke.json

It drives the port only (never jax, never pclean_tpu), in order:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the three CUDA kernels from pclean_tpu_torch/csrc/ (one nvcc per
     source, in parallel) and prints the build time;
  3. for each kernel, at the main path's shapes on seeded inputs: its error
     against its plain PyTorch version on the card (with the tolerance
     stated below), kernel / plain / library ms (CUDA events, median), and
     the bytes bound on an H100 (3.35 TB/s);
  4. checks the tracer's CUDA path against its CPU path (plain versions) on
     a small input: same state, same injected uniforms;
  5. runs the scaled workload's main path end to end — compile_model,
     init_state, Engine.initialize (sequential ramp, batched init segments,
     batched birth allocation, replay), Engine.run (segmented batched MH
     sweep with resample_all), evaluate_accuracy_device — at the entity
     counts of experiments/scaled.py (8,000 hospitals, 1,000 counties,
     2,000 names, 500 zips, typo 0.05, capacities Hospital 11,264 and
     County 1,472, batch_rows 4096, 1 sweep) with the rows cut from the
     source's 1,000,000 to 100,000 so the run fits its time limit; prints
     init s, sweep s, rows-cleaned/s, F1, precision, recall, arena
     occupancy, peak device memory and each kernel's launches on that run;
  6. prints the `kernels` JSON line, then the card line, then the result.

Tolerances: K1 record bit-equal, logZ rtol 1e-6 (the same f32 formula
summed in another order); K2 indices equal on all but <= 1e-2 of rows, and
every differing row's threshold within 1e-5 of the total from the exact
prefix sums between the two picks (f32 prefix sums in the kernel's chunked
order and in torch.cumsum's round differently: at K ~ 11k logits about one
row in a thousand sits that close to a boundary), never a zero-mass pick; K3
bit-equal (same column order). It fails (non-zero exit, no result line) if
there is no card, a kernel does not build, launch or agree, a kernel was
not launched on the main path, F1 < 0.80, or any phase raises.
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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
ROWS = 100_000
BATCH = 4096
SCALED = dict(counties=1000, hospitals=8000, names=2000, zips=500,
              typo=0.05)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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


def bench_kernels(ops, cm, dev):
    """K1-K3 at the main path's shapes: B = batch_rows rows against the
    Hospital candidate axis (K = its capacity; _kc keeps the full axis at
    this scale since ~8,000 live hospitals exceed half of 11,264), the
    model's own AddTypos matrices for K3."""
    from pclean_tpu_torch.engine.kernels import _AddTyposK

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    B = BATCH
    K = cm.layouts["Hospital"].capacity
    out = []

    # K1: exist [B, K] (PY term + child terms, dead slots at NEG_INF), new [B]
    exist = torch.randn((B, K), generator=g, device=dev) * 3.0
    exist = torch.where(torch.rand((B, K), generator=g, device=dev) < 0.2,
                        torch.full_like(exist, -1e30), exist)
    new = torch.randn((B,), generator=g, device=dev)
    r0, z0 = ops.enum_logsumexp_plain(exist, new)
    r1, z1 = ops.enum_logsumexp(exist, new)
    torch.cuda.synchronize()
    assert torch.equal(r0, r1), "K1 record differs from the plain version"
    err1 = float((z1 - z0).abs().max())
    assert torch.allclose(z1, z0, rtol=1e-6, atol=0.0), f"K1 logZ err {err1}"
    cat = torch.cat([exist, new[:, None]], 1)
    out.append(dict(
        name="enum_logsumexp", route="cuda",
        source="pclean_tpu_torch/csrc/enum_logsumexp.cu",
        replaces="pclean_tpu/engine/propose.py:559",
        max_abs_err=err1,
        ms=cuda_ms(lambda: ops.enum_logsumexp(exist, new)),
        plain_ms=cuda_ms(lambda: ops.enum_logsumexp_plain(exist, new)),
        library_ms=cuda_ms(lambda: torch.logsumexp(cat, dim=1)),
        bytes=B * K * 4 + B * 4 + B * (K + 1) * 4 + B * 4,
        shape=f"exist [{B}, {K}], new [{B}]"))

    # K2: the recorded fk logits [B, K+1] and one uniform per row
    u = torch.rand((B,), generator=g, device=dev)
    a = ops.inv_cdf_sample(r0, u)
    b = ops.inv_cdf_sample_plain(r0, u)
    torch.cuda.synchronize()
    diff = (a != b)
    rate = float(diff.float().mean())
    assert rate <= 1e-2, f"K2 mismatch rate {rate}"
    if bool(diff.any()):
        # every entry between the two picks must have its exact (float64)
        # prefix sum within 1e-5 of the total from the threshold: the draw
        # sat on a boundary that the two f32 summation orders place apart
        rows = torch.nonzero(diff)[:, 0]
        lg = r0[rows].double()
        c = torch.cumsum(torch.exp(lg - lg.max(1, keepdim=True).values), 1)
        ub = (1.0 - u[rows].double()) * c[:, -1]
        lo = torch.minimum(a[rows], b[rows]).long()[:, None]
        hi = torch.maximum(a[rows], b[rows]).long()[:, None]
        pos = torch.arange(c.shape[1], device=dev)[None, :]
        between = (pos >= lo) & (pos < hi)
        gap = ((c - ub[:, None]).abs() / c[:, -1:]).masked_fill(~between, 0)
        assert float(gap.max()) <= 1e-5, "K2 differs away from a boundary"
    picked = r0.gather(1, a.long()[:, None])[:, 0]
    assert bool((picked > -1e29).all()), "K2 drew a zero-mass entry"
    out.append(dict(
        name="inv_cdf_sample", route="cuda",
        source="pclean_tpu_torch/csrc/inv_cdf_sample.cu",
        replaces="pclean_tpu/engine/propose.py:1153",
        max_abs_err=float((a - b).abs().max()), mismatch_rate=rate,
        ms=cuda_ms(lambda: ops.inv_cdf_sample(r0, u)),
        plain_ms=cuda_ms(lambda: ops.inv_cdf_sample_plain(r0, u)),
        library_ms=None,
        bytes=B * (K + 1) * 4 + B * 4 + B * 4,
        shape=f"logits [{B}, {K + 1}], u [{B}]"))

    # K3: the Record block's C = 3 observed AddTypos columns
    spec = cm.obs_specs[0]
    cols = [v for v in sorted(spec.columns)
            if isinstance(cm.kernels[cm.canon("Record", v)], _AddTyposK)]
    mats = [cm.use(cm.kernels[cm.canon("Record", v)].M) for v in cols]
    obs_np = np.stack([spec.columns[v][0][:B] for v in cols],
                      1).astype(np.int32)
    obs = torch.as_tensor(obs_np, device=dev)
    word = torch.stack([torch.randint(0, m.shape[0], (K,), generator=g,
                                      device=dev) for m in mats]) \
        .to(torch.int32)
    o0 = ops.obs_gather_sum_plain(mats, obs, word)
    o1 = ops.obs_gather_sum(mats, obs, word)
    torch.cuda.synchronize()
    assert torch.equal(o0, o1), "K3 differs from the plain version"
    # the JAX package's one-hot contraction, timed as a yardstick only
    oh = torch.cat([torch.nn.functional.one_hot(obs[:, c].long(),
                                                m.shape[0]).float()
                    for c, m in enumerate(mats)], 1)
    T = torch.cat([m[:, word[c].long()] for c, m in enumerate(mats)], 0)
    distinct = sum(int(torch.unique(obs[:, c]).numel()) * m.shape[0]
                   for c, m in enumerate(mats))
    out.append(dict(
        name="obs_gather_sum", route="cuda",
        source="pclean_tpu_torch/csrc/obs_gather_sum.cu",
        replaces="pclean_tpu/engine/propose.py:296",
        max_abs_err=float((o1 - o0).abs().max()),
        ms=cuda_ms(lambda: ops.obs_gather_sum(mats, obs, word)),
        plain_ms=cuda_ms(lambda: ops.obs_gather_sum_plain(mats, obs, word)),
        library_ms=cuda_ms(lambda: oh @ T),
        bytes=B * K * 4 + len(mats) * K * 4 + B * len(mats) * 4
        + distinct * 4,
        shape=f"obs [{B}, {len(mats)}], word [{len(mats)}, {K}], "
              f"V = {[m.shape[0] for m in mats]}"))
    for k in out:
        k["bound_ms"] = k["bytes"] / HBM_BYTES_PER_S * 1e3
        k["bound_by"] = "bytes"
    del exist, cat, oh, T, r0, r1
    torch.cuda.empty_cache()
    return out


def small_device_check(dev):
    """The tracer's CUDA path (kernels) against its CPU path (plain
    versions) on experiments/scaled.py's CPU config: same state, same
    injected uniforms -> same logZ (rtol 1e-5) and sampled values."""
    from pclean_tpu_torch.convert import to_numpy, to_torch
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.propose import BlockTracer, _draw_bound
    from pclean_tpu_torch.engine.refresh import refresh
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.workloads import scaled

    small = dict(rows=512, hospitals=48, counties=12, names=24, zips=32)
    res = {}
    for d in ("cpu", "cuda"):
        cm, cfg, _dirty, _clean, _q, _ = scaled.setup(**small, batch=8,
                                                      device=d)
        res[d] = (cm, cfg)
    cm_c, cfg_c = res["cpu"]
    a, p = init_state(cm_c, 0, device="cpu")
    eng = Engine(cm_c, cfg_c, device="cpu")
    a, p, _g = eng.initialize(1, a, p)
    arenas, params = to_numpy(a), to_numpy(p)
    slots = np.arange(0, 512, 8)
    rng = np.random.default_rng(0)
    outs = {}
    for d in ("cpu", "cuda"):
        cm, cfg = res[d]
        e = Engine(cm, cfg, device=d)
        at, pt = to_torch(arenas, d), to_torch(params, d)
        rel = refresh(cm, at, e.obs_dev)
        st = torch.as_tensor(slots, device=d)
        plan = cm.cls("Record").plans[0]
        n = _draw_bound(cm, "Record", plan)
        pool = torch.as_tensor(np.random.default_rng(1).random(
            (len(slots), n)).astype(np.float32), device=d)
        tr = BlockTracer(cm, "Record", at, rel, pt, e.obs_dev,
                         e._obs_row_slices("Record", st, rel), {}, st)
        logz, r = tr.run(plan, pool=pool)
        outs[d] = (logz.cpu(), {v: x.cpu() for v, x in r.env.items()})
    del rng
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    for v, x in outs["cpu"][1].items():
        assert torch.equal(x.to(torch.int64), outs["cuda"][1][v]
                           .to(torch.int64)), f"sampled vertex {v} differs"
    return float((outs["cuda"][0] - outs["cpu"][0]).abs().max())


def main() -> int:
    args = sys.argv[1:]
    out_dir = args[args.index("--out") + 1] if "--out" in args else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from pclean_tpu_torch import ops
    from pclean_tpu_torch.analysis import evaluate_accuracy_device
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.workloads import scaled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    build_s = ops.build_kernels()
    print(f"kernel build: {build_s:.2f} s", flush=True)
    for name, log in ops.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    report = {"card": card, "build_s": build_s, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t = time.time()
    cm, config, dirty, clean, query, _sweeps = scaled.setup(
        rows=ROWS, batch=BATCH, device="cuda", **SCALED)
    report["compile_s"] = time.time() - t
    caps = {c: cm.layouts[c].capacity for c in cm.model.class_order}
    print(f"compile_model: {report['compile_s']:.2f} s, capacities {caps}",
          flush=True)
    kernels = bench_kernels(ops, cm, dev)
    for k in kernels:
        print(f"{k['name']}: {k['shape']}: max_abs_err {k['max_abs_err']:.3g}"
              f" kernel {k['ms']:.4f} ms plain {k['plain_ms']:.4f} ms "
              f"library {k['library_ms']} ms bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})", flush=True)
    report["small_check_max_abs_err"] = small_device_check(dev)
    print(f"tracer cuda-vs-cpu check on the small config: max |dlogZ| "
          f"{report['small_check_max_abs_err']:.3g}", flush=True)

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
    res = evaluate_accuracy_device(cm, arenas, params, dirty, clean, query)
    occ = eng.arena_occupancy(arenas)
    report.update(
        rows=ROWS, batch_rows=BATCH, init_s=init_s, sweep_s=sweep_s,
        rows_cleaned_per_s=ROWS / (init_s + sweep_s),
        f1=res["f1"], precision=res["precision"], recall=res["recall"],
        occupancy=occ, phase_times=eng.phase_times,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=launches)
    print(f"main path ({ROWS} rows, B={BATCH}): init {init_s:.2f} s, "
          f"sweep {sweep_s:.2f} s, rows-cleaned/s "
          f"{report['rows_cleaned_per_s']:.1f}", flush=True)
    print(f"phases (wall s): {eng.phase_times}")
    print(f"F1 {res['f1']:.4f} precision {res['precision']:.4f} "
          f"recall {res['recall']:.4f}; occupancy {occ}; "
          f"max_memory_allocated {report['max_memory_allocated']}")
    print(f"launches on the main path: {launches}", flush=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    missing = [k for k, v in launches.items() if v <= 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    assert res["f1"] >= 0.80, f"F1 {res['f1']} < 0.80"
    report["total_s"] = time.time() - t0
    report["kernels"] = kernels
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys}
                                  for kk in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
