"""Chip smoke run of the PyTorch/CUDA port (pclean_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the full run (one card)
    python3 chip_smoke.py --out DIR  # also write the details to
                                     # DIR/chip_smoke.json
    python3 chip_smoke.py --trace    # the trace phase alone (below)

It drives the port only (never jax, never pclean_tpu), in order:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the twenty-three CUDA kernels from pclean_tpu_torch/csrc/ (one nvcc
     per source, in parallel) and prints the build time and ptxas's
     registers, shared memory, stack frame and spills for each compiled
     function; measures the launch floor and one dependent L2 load (K10's
     probe) and prints what a launch's parameter block costs by its size
     and by the lines read of it (kernel_bench.param_block_ms); runs the
     scaled workload's CPU config (512 rows, B = 8) at the default
     fused_dispatch_rows through init and one sweep, which must
     take the fused order (every class's batches, then every class's
     deferred rows) and reach F1 0.5;
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
     County 1,472, batch_rows 4096, 1 sweep) at the source's 1,000,000
     rows (bench.py:265-266); prints
     init s, sweep s, rows-cleaned/s, F1, precision, recall, arena
     occupancy, peak device memory (and what was allocated before the
     path) and each kernel's launches on that run, split into one-row
     (r1) and batched (rn) launches, and the launch census of K1, K2, K3,
     K5, K6, K7 and K8 by (mode, r1 or rn, row length K);
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
     one PyTorch op on one element) and the launch plan (K7's names its
     route: sparse, global atomics, or private, shared-memory tiles);
  6. runs the rents path end to end (pclean_tpu_torch/workloads/rents.py,
     the port's copy of experiments/rents.py on its seeded synthetic rents
     tables) at the source's 50,000 rows, 51 states, about 1,500 counties,
     County capacity 4,096, batch_rows 256, 1 sweep, rejuv_frequency 500,
     with the counts set to 0 just before it and read just after: the same
     report; then K4 and K5 at its shapes (K4 over the 50,000 Obs rows into
     County's 4,096 slots, K5 over 256 County rows and 51 states from the
     env coordinates, kernel_bench.rents_inputs; K4's library call is one
     zeroed buffer and index_add_ of its outputs, K5 has none; where one K4
     call's host time goes, kernel_bench.k4_call_split), K5 at every shape
     of its launch census over every batch of County's sweep
     (kernel_bench.k5_census_inputs; two launches bit-equal) and K7 as in
     step 5;
  7. runs the flights path end to end (pclean_tpu_torch/workloads/
     flights.py, the port's copy of experiments/flights.py on its seeded
     synthetic flights tables) at the source's 2,376 rows, 100 flights, 38
     websites, capacities Flight 160 and TrackingWebsite 64, MH, 5 sweeps,
     batch_rows 1 (the sequential drivers), rejuv_frequency 50: the same
     report; then K6 at every shape of its launch census (a Flight slot
     against its referrer list or the Obs rows, for the time field of
     each census vocabulary, kernel_bench.k6_census_inputs; the plan names
     its route: warp or block);
  8. runs the hospital model's three paths end to end (pclean_tpu_torch/
     workloads/hospital.py, the port's copy of experiments/hospital.py on
     its seeded synthetic hospital tables, capacities of
     experiments/hospital.py, 1 sweep), each followed by K7 and K8 as in
     step 5 (K7's library call is one torch.bincount, K8 has none):
       - hospital: the source's config, 1,000 rows tiled 100 times, MH,
         batch_rows 4096 (bench.py:238-239);
       - hospital_pg1024: bench.py:245-247's configuration, 1,000 rows
         tiled 100 times, batch_rows 4096, particle Gibbs with 1,024
         particles; the model passes the exact-Gibbs audit, so every row
         is the collapsed one-draw SMC; prints the init log-ML;
       - hospital_pg16_vmapped: scripts/pg_measurements.py's (b), 1,000
         rows, batch_rows 64, 16 particles with collapse_exact_pg off: the
         written-out particle path (64 x 16 particle-rows a step) with K9
         resampling between the two Record blocks and drawing the final
         particle; prints the init log-ML; then K9 at every shape of its
         launch census (kernel_bench.k9_census_inputs: seeded weights,
         half the rows spread so that they resample), its group path
         (P <= 32) bit-equal to its block path there, with its latency
         bound (kernel_bench.k9_chain);
  8b. after every path, on its final state, K10 row_delta and K11
     row_write (the one-row loops' relational delta and row write): a
     shadow run of 256 rows of every class kind the path's census shows
     it swept (kernel_bench.shadow_rows: the kernels on one copy of the
     carry under torch.cuda.set_sync_debug_mode("error"), the plain
     versions on a CPU copy, every leaf bit-equal), then each timed at
     every shape of the census beside its bytes bound and its
     dependent-load bound (kernel_bench.time_k10, time_k11; K11 also its
     host us a call back to back); K14
     rel_scatter and K15 batch_write (the relational scatters and the
     batched row write): refresh and every latent class's hop histograms
     on the path's state on the card against their plain versions on a
     CPU copy, under the sync debug mode's "error"
     (kernel_bench.check_rel_state), then each at every shape of the
     path's census on seeded inputs of that shape (kernel_bench.
     k14_inputs, k15_inputs), bit-equal (rel_checks); and the trace
     phase (trace_sections, at most about 30 s in all): torch.profiler
     over one hospital ramp row, one hospital batched init segment and
     one rents Obs batch from fresh states of those paths' models, where
     their inits start, one flights Obs sweep row on the flights path's
     final state and one scaled latent replay row on the scaled path's
     (the one-row sections: one replay of the row step's CUDA graph),
     printing each one's kernel launches, device ops
     (a replay's graph nodes, its K20 nodes and K12/K13 launches beside
     them), host syncs (the runtime's synchronize
     calls, and those PyTorch's sync debug mode flags), device-to-host
     copies, wall ms with and without the profiler, device busy ms, the
     card's idle share under the profiler and the busy ms over the wall
     ms without it (two runs: a ratio, no idle share);
  8c. after the flights and the hospital paths, on their states, the
     graph-against-eager phase (graph_checks): GRAPH_ROWS rows of each
     one-row loop kind the path runs (the MH and collapsed PG ramps from
     a fresh state, observed, latent-with-hops and leaf sweeps, replay
     chunks of the observed and of a latent class, the written-out PG
     replay and sweep), once eager with the
     kernels and once as replays of the captured row step from the same
     state and generator state: every carry and params leaf, the log-ML,
     the generator state and the launch counts bit-equal. Every path also
     prints, for each one-row loop kind, its segments (a replay chunk is
     one), the rows it replayed and ran eagerly and the captures it made
     with their seconds;
  8d. after every path, K16 fk_sample, K17 choice_sample, K18 row_gather
     and K19 branch_select (the block proposal's sample pass and row
     lookups) at every shape of the path's census holding >= SHAPE_SHARE
     of its launches of the kernel, on seeded inputs of that shape
     (kernel_bench.sample_inputs), against their plain versions on the
     card, bit-equal, the plain versions drawing with K2 (every geometry
     of the kernels' draw gives K2's index, csrc/inv_cdf.cuh), K16 and
     K17 (K17's group launches too) also in every draw geometry that
     takes the shape (kernel_bench.draw_geometries); where they draw, K2
     on the picked logits against the fully plain draw within K2's
     allowance (sample_checks); the trace phase also counts, for each of its
     sections, the device ops each port function issued in one eager run
     (a graphed row's warm-up row; ops_by_function), and those of the
     score pass (SCORE_PASS);
  8e. after every path, K20 level_sum and K21 py_prior (the score pass's
     accumulation glue: a level's terms summed, a batched foreign key's
     prior and children) at every shape of the path's census holding >=
     SHAPE_SHARE of its launches of the kernel, on seeded inputs of that
     shape (kernel_bench.level_inputs: K20's program and operand kinds,
     shapes and dtypes as the census recorded them), against their plain
     versions on the card, bit-equal (level_checks);
  8f. after every path, K22 gamma_draw and K23 py_resample (the parameter
     resampling: every Proportions and Prob draw of a resample_all, and
     every latent class's Pitman-Yor MH) at every shape of the path's
     census holding >= SHAPE_SHARE of its launches, on seeded inputs of
     that shape (kernel_bench.k22_inputs, k23_inputs), against their
     plain versions on the card on the same seed buffer, bit-equal, K22's
     count of differing draws reported (param_checks); the trace phase's
     eager runs also tally the parameter resampling's device ops
     (PARAM_MODULES);
  9. after all six paths, K12 fk_score and K13 choice_score at every
     shape of the paths' launch census holding >= SHAPE_SHARE of a path's
     launches (enumeration rows, slots or options, and each fused child
     level's shape and operand kinds) and at the most launched shape of
     every other (R, K) (seeded inputs of that shape, the
     levels rebuilt from ops.CENSUS_FIELDS, K13's rows in states 0, 1 and
     2 in turn, and again with every row observed and with a static code)
     against their plain versions on both geometries (the plan's and the
     other: ops.score_spread), timed beside them, torch.logsumexp over
     the record and the bytes bound (bench_score_shapes); K14 and
     K15 timed at every census shape holding >= SHAPE_SHARE of a path's
     launches, beside their plain versions, the library call of the
     count alone (index_add_; K15: index_copy_ of one column) and the
     bytes bound, K14 with the route its plan takes (a thread a source or
     a histogram in each block's shared memory, ops.rel_scatter_plan)
     (bench_rel_shapes); K16-K18 timed at their most
     launched one-row and batched census shapes holding >= SHAPE_SHARE of
     a path's launches and at the largest, K19 at every one with its host
     us a call back to back, K16 and K17 in every draw
     geometry that takes the shape side by side (device ms and host us,
     kernel_bench.geometry_ms), beside their plain versions,
     the library call (K18 of one chain: torch.take of the leaf at the
     final indices, none for a group of chains; K19 of one pair:
     torch.where; K16 and K17 none) and the bytes bound, and K18 as one
     chain at one slot and at 1,000,000 beside torch.take
     (SAMPLE_SINGLE) (bench_sample_shapes); K20 likewise at its most
     launched one-row and batched shapes and each path's largest, K21 at
     every census shape checked, beside their plain versions and the
     bytes bound, no library call (bench_level_shapes); K22 and K23 at
     every census shape checked, beside their plain versions, K22's
     library call
     (torch._standard_gamma at the same alphas, and
     torch._sample_dirichlet over the same rows) and the bound, the larger
     of the bytes and the operations the inputs need, K22 also its
     latency bound (the launch floor, one L2 load and the dependent chain
     of one draw and its row's sum, kernel_bench.k22_chain) (K23: the
     instructions the function needs, lgammaf's and logf's the shortest
     path through their SASS as the kernels are built, a lower bound,
     kernel_bench.k23_sass) (bench_param_shapes);
     then the limits phase (limits_phase): workloads/limits.py's
     synthetic model, past every old single-launch limit, through
     compile, init and one sweep on the card, each wrapper's first call
     past its old limit held to its plain version on those inputs, K10 and
     K11 shadow rows of every class kind, the relational state and a
     seeded 260-operand level through K20's stages; then prints, for
     each kernel, how many
     shapes were checked and the worst error, the run's seconds, then the
     `kernels` JSON line (K1-K23; `launches` summed over
     the six paths, with each path's own beside it; `max_abs_err` the
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
1e-5 of each cell's sum of |terms| + 1e-6 (double sums in a fixed order
against an f32 histogram-times-SA product); K9 (kernel_bench.check_k9):
rows whose ESS lies within 1e-6 P of P / 2 are left out, on the others the
resampling decision is equal, ws_out and lml within 1e-6 of max(1,
|logsumexp|), and the picks equal but on <= 1e-2 of them (at 100 or more),
each within 1e-4 of the total from a CDF boundary (exact fixed-point
prefix sums against torch.cumsum's f32 ones, K2's rule); K10 and K11
bit-equal (integer state and copied values); K12 and K13 record
bit-equal (the same float operations, one rounding each) and logZ within
K1's rule; K14 and K15 bit-equal (integer atomics, copied values); K16-K19
bit-equal to their plain versions drawing with K2 (integers and copied
values), and K2 against the fully plain draw as above; K20, K21, K22 and
K23 bit-equal (the same float operations and Philox stream, one rounding
each); every split or raised launch of the limits phase bit-equal. It
fails
(non-zero exit, no result line) if there is no card, a kernel does not
build, launch or agree, K1 and K3 were not launched on the scaled path,
K4 and K5 not on the rents path, K6 not on the flights path, K1, K3, K7
and K8 not on the hospital or the hospital_pg1024 path, K1, K3 and K9 in
both its modes not on the hospital_pg16_vmapped path (K2's draw runs
inside K16 and K17 on every path; K2 itself draws the MaybeSwap prior
only), K10 or K11 not on
any path, K12 or K13 not on any path but hospital_pg16_vmapped, K14 not
on any path or K15 not on a batched one, K16-K19 not on every path, K20
not on every path or K21 not on a path with batched steps, K22 or K23
not on every path, one of the six paths calling a wrapper past a single
launch's limit (ops.SPLITS: none passes one), a limits-phase wrapper never
called past its old limit or its model's F1 below LIMITS_F1_FLOOR, a
shadow run or the state check
of K14 differs or waits for the card, a graph replay differs from the
eager row or a graphed loop kind ran a row after its first eagerly, a PG
path's log-ML is not finite, a path's F1 is below its floor (F1_FLOORS: scaled, rents,
flights, hospital, and the two PG paths'), or any phase raises.
"""
import math
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

ROWS = 1_000_000
BATCH = 4096
SCALED = dict(counties=1000, hospitals=8000, names=2000, zips=500,
              typo=0.05)
# pclean_tpu on the CPU on the same scaled tables cut to 16,000 rows (the
# entity counts scaled alike, B = 256, seeds 0-2: 100,000 rows at B = 4096
# do not fit a CPU host) reached F1 0.8463, 0.8443 and 0.8451
# (scripts/scaled_jax_floor.py); the floor is the lowest less 0.03. F1 rises
# with the rows (0.75-0.76 at 8,000), so the 1,000,000-row path clears it;
# pclean_tpu cannot run 1,000,000 rows on a CPU host
SCALED_F1_FLOOR = 0.8443223443223444 - 0.03
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
# the hospital model's paths: MH and the collapsed PG path at bench.py's
# 100,000 rows, the written-out PG path at 1,000
HOSPITAL_PATHS = {
    "hospital": dict(rows=1000, repeat=100, batch=4096),
    "hospital_pg1024": dict(rows=1000, repeat=100, batch=4096,
                            particles=1024),
    "hospital_pg16_vmapped": dict(rows=1000, repeat=1, batch=64,
                                  particles=16, collapse_exact_pg=False),
}
# pclean_tpu on the CPU on the same hospital tables (MH, 1 sweep, seeds 0-2,
# at 5,000 rows and B = 256: 100,000 rows at B = 4096 do not fit a CPU host)
# reached F1 0.99945, 0.99931 and 0.99931 (scripts/hospital_jax_floor.py);
# the floor is the lowest less 0.03
HOSPITAL_F1_FLOOR = 0.9993136582017845 - 0.03
# pclean_tpu's PG path on the same tables (scripts/hospital_pg_jax_floor.py,
# seeds 0-2, 1 sweep), the lowest less 0.03: collapsed P = 1,024 at 5,000
# rows and B = 256 reached F1 0.99931, 0.99959 and 0.99931; the written-out
# P = 16 path at hospital_pg16_vmapped's own configuration 0.9265, 0.9744
# and 0.9191 (its F1 trails the collapsed path's, VERDICT.md:132-147, so it
# is held to its own runs)
PG1024_F1_FLOOR = 0.9993136582017845 - 0.03
PG16_F1_FLOOR = 0.9191270860077023 - 0.03
F1_FLOORS = {"scaled": SCALED_F1_FLOOR, "rents": RENTS_F1_FLOOR,
             "flights": FLIGHTS_F1_FLOOR, "hospital": HOSPITAL_F1_FLOOR,
             "hospital_pg1024": PG1024_F1_FLOOR,
             "hospital_pg16_vmapped": PG16_F1_FLOOR}
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
                       "pclean_tpu/engine/propose.py:850"),
    "maybe_swap_ext": ("pclean_tpu_torch/csrc/maybe_swap_ext.cu",
                       "pclean_tpu/engine/propose.py:683"),
    "referrer_hist": ("pclean_tpu_torch/csrc/referrer_hist.cu",
                      "pclean_tpu/engine/propose.py:1399"),
    "sa_ext_term": ("pclean_tpu_torch/csrc/sa_ext_term.cu",
                    "pclean_tpu/engine/propose.py:801"),
    "pg_resample": ("pclean_tpu_torch/csrc/pg_resample.cu",
                    "pclean_tpu/engine/particles.py:131"),
    "row_delta": ("pclean_tpu_torch/csrc/row_delta.cu",
                  "pclean_tpu/engine/refresh.py:209"),
    "row_write": ("pclean_tpu_torch/csrc/row_write.cu",
                  "pclean_tpu/engine/smc.py:173"),
    "fk_score": ("pclean_tpu_torch/csrc/fk_score.cu",
                 "pclean_tpu/engine/propose.py:521"),
    "choice_score": ("pclean_tpu_torch/csrc/choice_score.cu",
                     "pclean_tpu/engine/propose.py:454"),
    "rel_scatter": ("pclean_tpu_torch/csrc/rel_scatter.cu",
                    "pclean_tpu/engine/refresh.py:418"),
    "batch_write": ("pclean_tpu_torch/csrc/batch_write.cu",
                    "pclean_tpu/engine/smc.py:210"),
    "fk_sample": ("pclean_tpu_torch/csrc/fk_sample.cu",
                  "pclean_tpu/engine/propose.py:1026"),
    "choice_sample": ("pclean_tpu_torch/csrc/choice_sample.cu",
                      "pclean_tpu/engine/propose.py:981"),
    "row_gather": ("pclean_tpu_torch/csrc/row_gather.cu",
                   "pclean_tpu/engine/propose.py:1410"),
    "branch_select": ("pclean_tpu_torch/csrc/branch_select.cu",
                      "pclean_tpu/engine/propose.py:1093"),
    "level_sum": ("pclean_tpu_torch/csrc/level_sum.cu",
                  "pclean_tpu/engine/propose.py:383"),
    "py_prior": ("pclean_tpu_torch/csrc/py_prior.cu",
                 "pclean_tpu/engine/propose.py:241"),
    "gamma_draw": ("pclean_tpu_torch/csrc/gamma_draw.cu",
                   "pclean_tpu/dists/params.py:104"),
    "py_resample": ("pclean_tpu_torch/csrc/py_resample.cu",
                    "pclean_tpu/engine/gibbs_params.py:174"),
}
SCALED_KERNELS = ("enum_logsumexp", "inv_cdf_sample", "obs_gather_sum")
RENTS_KERNELS = ("gauss_suffstats", "gauss_ext_term")
FLIGHTS_KERNELS = ("enum_logsumexp", "inv_cdf_sample", "maybe_swap_ext")
# K12 and K13: the one-row blocks' score glue, on every path with a ramp
# or B = 1 sweeps (the written-out PG path's one-row rows are its replays,
# which its batched sweep may leave empty)
SCORE_KERNELS = ("fk_score", "choice_score")
HOSPITAL_KERNELS = ("enum_logsumexp", "inv_cdf_sample", "obs_gather_sum",
                    "referrer_hist", "sa_ext_term")
# K10 and K11: every path runs one-row loops (a ramp, replays or B = 1
# sweeps)
ROW_KERNELS = ("row_delta", "row_write")
# K14 and K15: every refresh and batched delta, every batched row write
# (the flights path has no batched step: its refreshes alone)
REL_KERNELS = ("rel_scatter", "batch_write")
# K16-K19: every block's sample pass and row lookups, on every path (K2's
# draw runs inside K16 and K17, so only flights, whose MaybeSwap prior
# draws through K2 itself, still needs K2)
SAMPLE_KERNELS = ("fk_sample", "choice_sample", "row_gather",
                  "branch_select")


# K20 and K21: the score pass's accumulation glue, every level's terms on
# every path, and a batched foreign key's prior and children (every path
# but flights, whose every row is a one-row step: K12 there)
LEVEL_KERNELS = ("level_sum", "py_prior")
# K22 and K23: the parameter resampling, every resample_all on every path
# (each path has learned parameters and latent Pitman-Yor classes)
PARAM_KERNELS = ("gamma_draw", "py_resample")


def _no_k2(names):
    return tuple(n for n in names if n != "inv_cdf_sample")


NEED = {"scaled": _no_k2(SCALED_KERNELS) + ROW_KERNELS + SCORE_KERNELS
        + REL_KERNELS + SAMPLE_KERNELS + LEVEL_KERNELS + PARAM_KERNELS,
        "rents": RENTS_KERNELS + ROW_KERNELS + SCORE_KERNELS + REL_KERNELS
        + SAMPLE_KERNELS + LEVEL_KERNELS + PARAM_KERNELS,
        # every flights row is a one-row step: K12/K13 in place of K1
        "flights": FLIGHTS_KERNELS[1:] + ROW_KERNELS + SCORE_KERNELS
        + REL_KERNELS[:1] + SAMPLE_KERNELS + LEVEL_KERNELS[:1]
        + PARAM_KERNELS,
        "hospital": _no_k2(HOSPITAL_KERNELS) + ROW_KERNELS + SCORE_KERNELS
        + REL_KERNELS + SAMPLE_KERNELS + LEVEL_KERNELS + PARAM_KERNELS,
        "hospital_pg1024": _no_k2(HOSPITAL_KERNELS) + ROW_KERNELS
        + SCORE_KERNELS + REL_KERNELS + SAMPLE_KERNELS + LEVEL_KERNELS
        + PARAM_KERNELS,
        "hospital_pg16_vmapped": _no_k2(SCALED_KERNELS) + ("pg_resample",)
        + ROW_KERNELS + REL_KERNELS + SAMPLE_KERNELS + LEVEL_KERNELS
        + PARAM_KERNELS}
PATHS = tuple(NEED)


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


def bench_rents_kernels(ops, cm, arenas, params, obs_dev, census,
                        floor) -> tuple:
    """K4 and K5 at the shapes the rents path launches them at
    (kernel_bench.rents_inputs on the rents state; K5 on the first B live
    County slots, from the env coordinates): checked against their plain
    versions, timed beside their plain versions, K4's library call, the
    bytes bound and the launch floor. Then K5 at every shape of the path's
    launch census, over every batch of County's sweep (kernel_bench.
    k5_census_inputs), each checked against its plain version and for two
    launches giving the same bits. Returns (the kernels-line entries, K5's
    census shapes)."""
    from pclean_tpu_torch import kernel_bench as kb

    inp = kb.rents_inputs(cm, arenas, params, obs_dev, RENTS["batch"])
    errs = {"gauss_suffstats": kb.check_k4(ops, inp["k4"]),
            "gauss_ext_term": kb.check_k5(ops, inp["k5"])}
    times = kb.time_k45(ops, inp)
    times["gauss_suffstats"]["call_split"] = kb.k4_call_split(ops, inp["k4"])
    nbytes = {"gauss_suffstats": kb.k4_bytes(inp["k4"]),
              "gauss_ext_term": kb.k5_bytes(inp["k5"])}
    k4, k5 = inp["k4"], inp["k5"]
    B, A = k5["full"]
    C = k5["tbl"].shape[1]
    shapes = {"gauss_suffstats": f"R = {k4['z'].shape[0]} referrers, cap "
                                 f"{k4['cap']}, C {k4['C']}",
              "gauss_ext_term": f"out [{B}, {A}], C {C}, E "
                                f"{k5['tbl'].shape[0]}, env axes "
                                f"{list(k5['env_shape'])}"}
    plans = {"gauss_suffstats": ops.gauss_suffstats_plan(k4["z"].shape[0]),
             "gauss_ext_term": ops.gauss_ext_term_plan(B, A, C)}
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
    k5_shapes = []
    for r, batches in kb.k5_census_inputs(cm, arenas, params, obs_dev,
                                          census, RENTS["batch"]):
        errs = [kb.check_k5(ops, x) for x in batches]
        nb = [kb.k5_bytes(x) for x in batches]
        k5_shapes.append(dict(
            shape=f"{r['mode']} {r['rows']} C {r['K']}", rows=r["rows"],
            launches=r["launches"], batches=len(batches),
            max_abs_err=max(errs), bytes=max(nb),
            bound_ms=max(nb) / kb.HBM_BYTES_PER_S * 1e3,
            plan=ops.gauss_ext_term_plan(*batches[0]["full"], r["K"])))
        x = k5_shapes[-1]
        print(f"gauss_ext_term census {x['shape']} ({x['launches']} "
              f"launches): {x['batches']} batches of County's sweep checked, "
              f"max_abs_err {x['max_abs_err']:.3g}, two launches bit-equal, "
              f"plan {x['plan']}", flush=True)
        del batches
    torch.cuda.empty_cache()
    return out, k5_shapes


def bench_flights_k6(ops, eng, arenas, params, census, floor) -> dict:
    """K6 at every shape of the flights path's launch census (form,
    referrer axis N, one row or batched, V), on inputs from its state
    (kernel_bench.k6_census_inputs: the time field of that V at Flight's
    first live slot, its referrers in the form the tracer holds them):
    checked against its plain version, timed beside it, with the bytes
    bound, the launch floor and the plan (its route). The kernels-line
    numbers are the largest vocabulary's; `shapes` holds each shape's."""
    from pclean_tpu_torch import kernel_bench as kb

    shapes = []
    for r, field, k6 in kb.k6_census_inputs(eng, arenas, params, census, 1):
        nbytes = kb.k6_bytes(k6)
        B, N, V = k6["lc"].shape[0], k6["obs"].shape[-1], \
            k6["member"].shape[1]
        form = (f"list of {int(k6['cnt'][0])} of {N}" if "cnt" in k6
                else f"dense over {N}")
        shapes.append(dict(
            field=field, rows=r["rows"], launches=r["launches"], V=V, N=N,
            form=form, max_abs_err=kb.check_k6(ops, k6), bytes=nbytes,
            bound_ms=nbytes / kb.HBM_BYTES_PER_S * 1e3, floor_ms=floor,
            plan=ops.maybe_swap_ext_plan(B, V, "cnt" not in k6),
            **kb.time_k6(ops, k6)))
        x = shapes[-1]
        print(f"maybe_swap_ext {x['field']} {x['rows']} ({x['launches']} "
              f"launches): out [{B}, {V}], referrers {form}: max_abs_err "
              f"{x['max_abs_err']:.3g} kernel {x['ms']:.4f} ms (device "
              f"{x['device_ms']:.4f} ms) plain {x['plain_ms']:.4f} ms bound "
              f"{x['bound_ms']:.6f} ms floor {floor:.4f} ms plan "
              f"{x['plan']}", flush=True)
    top = max(shapes, key=lambda x: x["V"])
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
        plan = ops.sa_ext_term_plan(B, E, R)
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
    """K7's or K8's kernels-line entry: the numbers of the 100,000-row
    hospital_pg1024 path's batched shape that moves the most bytes (K7:
    its largest hoisted histogram; K8: the County or Measure sweep)."""
    top = max((r for r in shapes
               if r["path"] == "hospital_pg1024" and r["rows"] == "rn"),
              key=lambda r: r["bytes"])
    return dict({key: top[key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
        "library_device_ms", "bytes", "bound_ms", "floor_ms", "plan",
        "shape")}, name=name, route="cuda", source=SOURCES[name][0],
        replaces=SOURCES[name][1], bound_by="bytes")


def bench_k9_census(ops, dev, census, B: int, path: str, floor,
                    lat) -> list:
    """K9 at every shape of a path's launch census (mode, P, one row or B
    rows), on seeded weights (kernel_bench.k9_census_inputs): checked
    against its plain version (kernel_bench.check_k9), and at P <= 32
    its group path bit-equal to its block path (kernel_bench.k9_launch
    with the block's words: sel, ws_out and lml), timed beside the plain
    version, with the bytes bound, the launch floor and the latency bound
    (the floor, one L2 load and the dependent chain a row needs,
    kernel_bench.k9_chain)."""
    from pclean_tpu_torch import kernel_bench as kb
    from pclean_tpu_torch.kernel_bench import require

    out = []
    for r, k9 in kb.k9_census_inputs(dev, census, B):
        R, P = k9["ws"].shape
        nbytes = kb.k9_bytes(R, P, r["mode"])
        plan = ops.pg_resample_plan(R, P)
        if plan["group"]:
            got = kb.k9_launch(ops, k9, plan)
            block = kb.k9_launch(ops, k9, dict(
                threads=32 * -(-P // 32), smem=12 * P, group=0))
            torch.cuda.synchronize()
            require(all(x is None and y is None or torch.equal(x, y)
                        for x, y in zip(got, block)),
                    f"K9's group path differs from its block path at "
                    f"{r['mode']} [{R}, {P}]")
        chain = kb.k9_chain(kb.k23_sass(ops), P, r["mode"])
        out.append(dict(
            kb.check_k9(ops, k9), path=path, mode=r["mode"], rows=r["rows"],
            launches=r["launches"], shape=f"{r['mode']} ws [{R}, {P}]",
            bytes=nbytes, bound_ms=nbytes / kb.HBM_BYTES_PER_S * 1e3,
            floor_ms=floor, plan=plan, chain=chain,
            latency_bound_ms=kb.latency_bound_ms(chain, floor, lat),
            **kb.time_k9(ops, k9)))
        x = out[-1]
        print(f"pg_resample {path} {x['shape']} ({x['launches']} launches):"
              f" max_abs_err {x['max_abs_err']:.3g} mismatch rate "
              f"{x['mismatch_rate']:.3g} kernel {x['ms']:.4f} ms (device "
              f"{x['device_ms']:.4f} ms) plain {x['plain_ms']:.4f} ms bound "
              f"{x['bound_ms']:.6f} ms latency bound "
              f"{x['latency_bound_ms']:.6f} ms ({chain} instructions) floor "
              f"{floor:.4f} ms plan {x['plan']}", flush=True)
    torch.cuda.empty_cache()
    return out


def latency_entry(top: dict) -> dict:
    """The kernels-line bound of K9's or K22's shape `top`: the larger of
    its bytes or operations bound and its latency bound, bound_by
    "operations" where the latency binds (K10's rule)."""
    lat = top["latency_bound_ms"] > top["bound_ms"]
    return dict(bytes_bound_ms=top["bound_ms"],
                latency_bound_ms=top["latency_bound_ms"],
                chain=top["chain"],
                bound_ms=max(top["bound_ms"], top["latency_bound_ms"]),
                bound_by="operations" if lat else top.get("bound_by",
                                                          "bytes"))


def k9_entry(shapes: list) -> dict:
    """K9's kernels-line entry: the numbers of its batched resample shape
    (the written-out path's [B, P] between the Record blocks)."""
    top = max(shapes, key=lambda r: (r["rows"] == "rn",
                                     r["mode"] == "resample", r["bytes"]))
    return dict({key: top[key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
        "library_device_ms", "bytes", "floor_ms", "plan", "shape")},
        name="pg_resample", route="cuda",
        source=SOURCES["pg_resample"][0],
        replaces=SOURCES["pg_resample"][1], **latency_entry(top),
        timed=[{key: r[key] for key in (
            "path", "shape", "launches", "device_ms", "latency_bound_ms")}
            for r in shapes])


def bench_rows(ops, eng, arenas, params, census, path, floor, lat) -> dict:
    """K10 and K11 after a path, on its final state: the shadow run
    (kernel_bench.shadow_rows: SHADOW_ROWS rows of every class kind the
    path's census shows it swept, the kernels on one copy of the carry and
    the plain versions on a CPU copy, every leaf bit-equal), then each
    kernel at every shape of the path's census (time_k10, time_k11).
    Returns ({kernel: [one dict per shape]}, the shadow runs); a shape's
    max_abs_err is 0 (every shadow run bit-equal, or the run fails)."""
    from pclean_tpu_torch import kernel_bench as kb
    from pclean_tpu_torch.kernel_bench import require

    shadows = []
    for cid, kind in kb.row_kinds(census):
        r = kb.shadow_rows(ops, eng, arenas, params, cid, kind)
        shadows.append(r)
        print(f"{path} shadow {cid} {kind}: {r['rows']} rows, "
              f"{r['launches']} launches, {r['hop_entries']} hop entries, "
              f"mismatching leaves {r['mismatches']}", flush=True)
        require(not r["mismatches"], f"{path}: K10/K11 differ from their "
                f"plain versions on {cid} ({kind}): {r['mismatches']}")
    out = {"row_delta": kb.time_k10(ops, eng, arenas, params, census, floor,
                                    lat),
           "row_write": kb.time_k11(ops, eng, arenas, params, census, floor,
                                    lat)}
    for rows in out.values():
        for r in rows:
            r.update(path=path, rows="r1", max_abs_err=0.0)
    torch.cuda.empty_cache()
    return out, shadows


def row_entry(name: str, shapes: list) -> dict:
    """K10's or K11's kernels-line entry: the numbers of the shape that
    launched most on one path. Its bound is the larger of the bytes bound
    and the dependent-load bound (the rounds of loads the function needs,
    each an operation that cannot start before the one it waits for ends:
    one L2 latency a round); bound_by names the one that binds."""
    top = max(shapes, key=lambda r: r["launches"])
    dep = top["dep_bound_ms"] > top["bound_ms"]
    return dict({key: top[key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
        "library_device_ms", "bytes", "floor_ms", "dep_loads",
        "dep_bound_ms")}, shape=f"{top['path']} {top['shape']}", name=name,
        route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
        bytes_bound_ms=top["bound_ms"],
        bound_ms=max(top["bound_ms"], top["dep_bound_ms"]),
        bound_by="operations" if dep else "bytes",
        timed=[{key: r[key] for key in (
            "path", "shape", "launches", "device_ms", "dep_loads",
            "dep_bound_ms")} for r in shapes])


def bench_score_shapes(ops, dev, runs: dict, floor) -> dict:
    """K12 and K13 at every shape of a path's launch census holding >=
    SHAPE_SHARE of its launches of the kernel (R, slots or options K, and
    each fused child level's shape and operand kinds: the mode less its
    class), and at the most launched shape of every (R, K) that no such
    shape covers (marked "[rare]"), on seeded inputs of that shape
    (kernel_bench.k12_inputs, k13_inputs: the child levels rebuilt from
    ops.CENSUS_FIELDS): checked
    against the plain version (record bit-equal, logZ within K1's rule),
    timed beside it and torch.logsumexp over the record (the logsumexp
    alone), with the bytes bound of the timed inputs (the levels' bytes
    included), and the other geometry's device ms beside the plan's (a
    plan's K1 geometry where it spreads the slots, else "slots":
    ops.score_spread).
    K13 is timed with its rows' states 0, 1, 2 in turn (one row: 0, which
    reads the enum logits) and also checked with every row observed (the
    delta) and with the static code of a choice with no observation
    (kernel_bench.K13_CHECKS). Each distinct shape once, with its
    launches on every path. Returns {kernel: [one dict per shape]}."""
    from pclean_tpu_torch import kernel_bench as kb

    out = {}
    for name, make, nbytes in (("fk_score", kb.k12_inputs, kb.k12_bytes),
                               ("choice_score", kb.k13_inputs,
                                kb.k13_bytes)):
        every: dict = {}
        for path, r in runs.items():
            for c in kb.score_census(r["census"], name):
                sh = every.setdefault((c["R"], c["K"], c["shape"]), dict(
                    R=c["R"], K=c["K"], classes=set(), launches_by_path={},
                    fields=ops.CENSUS_FIELDS[name][c["mode"]], share=0.0))
                sh["classes"].add(c["mode"].split(" ", 1)[0])
                lp = sh["launches_by_path"]
                lp[path] = lp.get(path, 0) + c["launches"]
                sh["share"] = max(sh["share"], c["share"])
        shapes = {k: sh for k, sh in every.items()
                  if sh["share"] >= SHAPE_SHARE}
        for k, sh in sorted(every.items(), key=lambda kv: -sum(
                kv[1]["launches_by_path"].values())):
            if not any(j[:2] == k[:2] for j in shapes):
                shapes[k] = dict(sh, rare=True)
        out[name] = []
        mode = "fk" if name == "fk_score" else "choice"
        for (R, K, shape), sh in sorted(shapes.items()):
            inp = make(dev, R, K, fields=sh["fields"])
            b = nbytes(inp)
            spread = ops.score_spread(R)
            plan = (ops.fk_score_plan if name == "fk_score"
                    else ops.choice_score_plan)(R, K, spread)
            alt = "slots" if plan["path"] != "slots" else \
                ops.enum_logsumexp_plan(R, K, mode)["path"].replace(
                    "split", "block")
            alt_fn = kb._score_fns(ops, name, alt)[0]
            err = kb.check_score(ops, name, inp)
            err = max(err, kb.check_score(ops, name, inp, path=alt))
            if name == "choice_score":
                for state in kb.K13_CHECKS:
                    err = max(err, kb.check_score(ops, name, make(
                        dev, R, K, state=state, fields=sh["fields"])))
            x = dict(shape=f"R {R}, K {K}, {shape} "
                     f"({', '.join(sorted(sh['classes']))})"
                     + (" [rare]" if sh.get("rare") else ""),
                     rows="r1", R=R, K=K,
                     launches=sum(sh["launches_by_path"].values()),
                     launches_by_path=sh["launches_by_path"],
                     max_abs_err=err, bytes=b,
                     bound_ms=b / kb.HBM_BYTES_PER_S * 1e3, floor_ms=floor,
                     plan=plan, spread=spread, alt_path=alt,
                     alt_device_ms=kb.graph_ms(lambda: alt_fn(*inp["args"])),
                     **kb.time_score(ops, name, inp))
            out[name].append(x)
            print(f"{name} {x['shape']} ({x['launches']} launches "
                  f"{x['launches_by_path']}): max_abs_err "
                  f"{x['max_abs_err']:.3g} kernel {x['ms']:.4f} ms (device "
                  f"{x['device_ms']:.4f} ms; {alt} "
                  f"{x['alt_device_ms']:.4f} ms) plain {x['plain_ms']:.4f} "
                  f"ms torch.logsumexp {x['library_ms']:.4f} ms (device "
                  f"{x['library_device_ms']:.4f} ms) bound "
                  f"{x['bound_ms']:.7f} ms floor {floor:.4f} ms plan "
                  f"{x['plan']}", flush=True)
            del inp
    torch.cuda.empty_cache()
    return out


def score_entry(name: str, shapes: list) -> dict:
    """K12's or K13's kernels-line entry: the numbers of the census shape
    launched most over the six paths."""
    top = max(shapes, key=lambda r: r["launches"])
    return dict({key: top[key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
        "library_device_ms", "bytes", "bound_ms", "floor_ms", "plan",
        "shape")}, name=name, route="cuda", source=SOURCES[name][0],
        replaces=SOURCES[name][1], bound_by="bytes")


def rel_checks(ops, eng, arenas, census, path: str) -> tuple:
    """K14 and K15 after a path, on its state: refresh and every latent
    class's hop histograms on the card against the plain versions on a CPU
    copy (kernel_bench.check_rel_state, under the sync debug mode's
    "error"), then each kernel at every shape of the path's launch census
    on seeded inputs of that shape (kernel_bench.k14_inputs, k15_inputs),
    against its plain version: every output bit-equal (integer atomics and
    copied values). Returns ({kernel: [one dict per shape]}, the state
    check)."""
    from pclean_tpu_torch import kernel_bench as kb
    from pclean_tpu_torch.kernel_bench import require

    dev = eng.cm.device
    st = kb.check_rel_state(ops, eng, arenas)
    print(f"{path} K14 on its state (refresh and hop histograms): "
          f"{st['launches']} launches, mismatching leaves "
          f"{st['mismatches']}", flush=True)
    require(not st["mismatches"], f"{path}: K14 differs from its plain "
            f"version on the path's state: {st['mismatches']}")
    out = {"rel_scatter": [], "batch_write": []}
    for c in census:
        if c["kernel"] not in out:
            continue
        if c["kernel"] == "rel_scatter":
            kb.check_k14(ops, kb.k14_inputs(dev, c["mode"], c["K"]))
        else:
            kb.check_k15(ops, kb.k15_inputs(dev, c["mode"], c["K"]))
        out[c["kernel"]].append(dict(shape=c["mode"], K=c["K"],
                                     rows=c["rows"], launches=c["launches"],
                                     max_abs_err=0.0, path=path))
    print(f"{path} K14/K15 census shapes checked bit-equal: "
          f"{ {k: len(v) for k, v in out.items()} }", flush=True)
    torch.cuda.empty_cache()
    return out, st


def bench_rel_shapes(ops, dev, checked: dict, floor) -> dict:
    """K14 and K15 timed at every census shape that holds >= SHAPE_SHARE of
    a path's launches of the kernel (each distinct shape once, with its
    launches on every path; every shape was checked after its path), on
    seeded inputs: kernel ms and device ms, the plain version, the library
    call of the count alone (K14: index_add_; K15: index_copy_ of one
    column), the bytes bound (kernel_bench.k14_bytes, k15_bytes) and the
    launch floor. Returns {kernel: [one dict per shape]}."""
    from pclean_tpu_torch import kernel_bench as kb

    out = {}
    for name in REL_KERNELS:
        shapes: dict = {}
        by_path: dict = {}
        for r in checked[name]:
            by_path.setdefault(r["path"], []).append(r)
        for path, rows in by_path.items():
            total = sum(r["launches"] for r in rows)
            for r in rows:
                sh = shapes.setdefault((r["shape"], r["K"]), dict(
                    launches_by_path={}, timed=False))
                sh["launches_by_path"][path] = r["launches"]
                sh["timed"] |= r["launches"] >= SHAPE_SHARE * total
        out[name] = []
        for (mode, K), sh in sorted(shapes.items()):
            if not sh["timed"]:
                continue
            if name == "rel_scatter":
                inp = kb.k14_inputs(dev, mode, K)
                b, t = kb.k14_bytes(inp), kb.time_k14(ops, inp)
                t["plan"] = kb.k14_plan(ops, inp)
            else:
                inp = kb.k15_inputs(dev, mode, K)
                b, t = kb.k15_bytes(inp), kb.time_k15(ops, inp)
            x = dict(shape=f"{mode} K={K}", K=K, max_abs_err=0.0,
                     launches=sum(sh["launches_by_path"].values()),
                     launches_by_path=sh["launches_by_path"], bytes=b,
                     bound_ms=b / kb.HBM_BYTES_PER_S * 1e3, floor_ms=floor,
                     **t)
            out[name].append(x)
            print(f"{name} {x['shape']} ({x['launches']} launches "
                  f"{x['launches_by_path']}): kernel {_ms(x['ms'])} "
                  f"(device {_ms(x['device_ms'])}) plain "
                  f"{_ms(x['plain_ms'])} library {_ms(x['library_ms'])} "
                  f"(device {_ms(x['library_device_ms'])}) bound "
                  f"{x['bound_ms']:.6f} ms floor {floor:.4f} ms plan "
                  f"{x.get('plan')}", flush=True)
            del inp
        torch.cuda.empty_cache()
    return out


def _ms(x) -> str:
    """A time for the log: "not timed" where a call launches nothing (a
    CUDA graph of it would be empty)."""
    return "not timed" if x is None else f"{x:.4f} ms"


def rel_entry(name: str, shapes: list) -> dict:
    """K14's or K15's kernels-line entry: the numbers of the timed shape
    launched most over the six paths (among those whose call launches
    work)."""
    top = max((r for r in shapes if r["ms"] is not None),
              key=lambda r: r["launches"])
    return dict({key: top[key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
        "library_device_ms", "bytes", "bound_ms", "floor_ms", "shape")},
        name=name, route="cuda", source=SOURCES[name][0],
        replaces=SOURCES[name][1], bound_by="bytes")


def sample_checks(ops, dev, census, path: str) -> dict:
    """K16-K19 after a path: every census shape holding >= SHAPE_SHARE of
    the path's launches of the kernel, on seeded inputs of that shape
    (kernel_bench.sample_inputs, from the fields the wrapper recorded in
    ops.CENSUS_FIELDS), against the plain version on the card
    (kernel_bench.check_sample: bit-equal, the plain version drawing with
    K2; where they draw, K2 on the picked logits against the fully plain
    draw within K2's allowance). Returns {kernel: [one dict per shape]}."""
    from pclean_tpu_torch import kernel_bench as kb

    out = {name: [] for name in SAMPLE_KERNELS}
    geoms = 0
    for c in census:
        if c["kernel"] not in out or c["share"] < SHAPE_SHARE:
            continue
        inp = kb.sample_inputs(
            dev, c["kernel"], ops.CENSUS_FIELDS[c["kernel"]][c["mode"]],
            c["K"])
        r = kb.check_sample(ops, inp)
        checked = kb.draw_geometries(ops, inp)
        for g in checked:
            kb.check_sample(ops, inp, geometry=g)
        geoms += len(checked)
        out[c["kernel"]].append(dict(
            shape=c["mode"], K=c["K"], rows=c["rows"], launches=c["launches"],
            share=c["share"], path=path, max_abs_err=r["max_abs_err"],
            k2_mismatch_rate=r.get("mismatch_rate"), geometries=checked))
        del inp
    print(f"{path} K16-K19 census shapes checked bit-equal: "
          f"{ {k: len(v) for k, v in out.items()} }, K16/K17 also in "
          f"every draw geometry that takes them ({geoms} checks)",
          flush=True)
    torch.cuda.empty_cache()
    return out


# K16-K19 are timed at their most launched one-row and batched census
# shapes and at the largest of each form
SAMPLE_TIMED = {"r1": 5, "rn": 3}
# K17's pick mode, which no path launches (every record the six paths pick
# from is constant along its ancestor axes, so BlockTracer._pick takes a
# view), checked and timed at one row and at 4,096 rows all the same
SAMPLE_PICK = tuple(dict(form="pick", dtype=torch.int32, B=B, d=1)
                    for B in (1, 4096))
# K18 as one chain, beside torch.take (the one PyTorch call computing the
# same gather), with their host sides: an int32 leaf of 1,000,000 entries
# (scaled's Record columns) at one slot and at 1,000,000
SAMPLE_SINGLE = tuple((dict(cols=[(torch.int32, 1_000_000)]), K)
                      for K in (1, 1_000_000))


def bench_sample_shapes(ops, dev, checked: dict, floor) -> dict:
    """K16-K19 timed, among the distinct census shapes checked (each holds
    >= SHAPE_SHARE of a path's launches), K16-K18 at the SAMPLE_TIMED most
    launched one-row and batched ones and at the largest of each form (K16
    drawn or retained and its mask form, K17 draw or retained; the most
    logits, options or slots, then the most rows), K19 at every one (with
    its host microseconds a call back to back), K17 at SAMPLE_PICK and K18
    at SAMPLE_SINGLE (checked bit-equal first), on seeded inputs: kernel
    ms and device ms, the plain version (its own draw), the library call
    (K17's pick mode torch.take of the record at the clamped ancestor
    positions, K18 torch.take of the leaf at the final indices, K19 of one
    pair torch.where; none for a K18 group of chains, K19 of more pairs,
    K16 and K17's draw and retained modes), the bytes bound
    (kernel_bench.sample_bytes) and the launch floor. Returns {kernel:
    [one dict per shape]}."""
    from pclean_tpu_torch import kernel_bench as kb

    out = {}
    for name in SAMPLE_KERNELS:
        fields = ops.CENSUS_FIELDS[name]
        shapes: dict = {}
        for r in checked[name]:
            sh = shapes.setdefault((r["shape"], r["K"]),
                                   dict(launches_by_path={}, rows=r["rows"]))
            sh["launches_by_path"][r["path"]] = r["launches"]
        ranked = sorted(shapes.items(), key=lambda kv: -sum(
            kv[1]["launches_by_path"].values()))
        top = [kv for rows, n in SAMPLE_TIMED.items()
               for kv in [x for x in ranked if x[1]["rows"] == rows][:n]]
        if name == "branch_select":   # every shape checked
            top = list(ranked)

        def form(kv):
            f = fields[kv[0][0]]
            return f.get("form"), f.get("mask")

        for fm in sorted({form(kv) for kv in ranked}, key=str):
            big = max((kv for kv in ranked if form(kv) == fm),
                      key=lambda kv: (kv[0][1], fields[kv[0][0]].get("B", 0)))
            if big not in top:
                top.append(big)
        todo = [(f"{mode} K={K}", fields[mode], K, sh["rows"],
                 sh["launches_by_path"]) for (mode, K), sh in top]
        if name == "choice_sample":
            todo += [(f"pick i32 B={f['B']} d={f['d']} K=1 (no path "
                      f"launches it)", f, 1, "r1" if f["B"] == 1 else "rn",
                      {}) for f in SAMPLE_PICK]
        if name == "row_gather":
            todo += [(f"single i32:1000000 K={K} (one chain)", f, K,
                      "r1" if K == 1 else "rn", {}) for f, K in SAMPLE_SINGLE]
        out[name] = []
        for shape, f, K, rows, by_path in todo:
            inp = kb.sample_inputs(dev, name, f, K)
            extra = f.get("form") == "pick" or shape.startswith("single")
            err = kb.check_sample(ops, inp)["max_abs_err"] if extra else 0.0
            b = kb.sample_bytes(inp)
            x = dict(shape=shape, K=K, rows=rows, max_abs_err=err,
                     launches=sum(by_path.values()), launches_by_path=by_path,
                     bytes=b, bound_ms=b / kb.HBM_BYTES_PER_S * 1e3,
                     floor_ms=floor, pick=f.get("form") == "pick",
                     single=shape.startswith("single"),
                     **kb.time_sample(ops, inp))
            if name == "branch_select":   # its host side, back to back
                y = kb._clone_inputs(inp)
                x["host_us"] = kb.host_us(lambda: kb._sample_call(ops, y))
            if kb.draw_geometries(ops, inp):   # K16, K17: side by side
                x["geometries"] = kb.geometry_ms(ops, inp)
                print(f"{name} {shape} by geometry (device ms / host us): "
                      + " ".join(f"{g} {v['device_ms']:.4f} / "
                                 f"{v['host_us']:.1f}"
                                 for g, v in x["geometries"].items()
                                 if g != "plan")
                      + f" (plan {x['geometries']['plan']})", flush=True)
            out[name].append(x)
            lib = "none" if x["library_ms"] is None else \
                f"{x['library_ms']:.4f} ms (device " \
                f"{x['library_device_ms']:.4f} ms)"
            host = f" host {x['host_us']:.1f} us" if "host_us" in x else ""
            print(f"{name} {x['shape']} ({x['launches']} launches "
                  f"{x['launches_by_path']}): kernel {x['ms']:.4f} ms "
                  f"(device {x['device_ms']:.4f} ms){host} plain "
                  f"{x['plain_ms']:.4f} ms library {lib} bound "
                  f"{x['bound_ms']:.6f} ms floor {floor:.4f} ms", flush=True)
            del inp
        print(f"{name}: timed {len(todo)} shapes, {len(top)} of "
              f"{len(shapes)} checked census shapes (the most launched "
              f"one-row and batched ones, the largest of each form)",
              flush=True)
        torch.cuda.empty_cache()
    return out


def _k19_short(shape: str) -> str:
    """A K19 census shape ("B=.. new<existing,... K=..") with each run of
    one pair's dtypes written once with its count."""
    head, sig, tail = shape.split(" ")
    runs = []
    for p in sig.split(","):
        if runs and runs[-1][0] == p:
            runs[-1][1] += 1
        else:
            runs.append([p, 1])
    return f"{head} " + ",".join(p if n == 1 else f"{p} x{n}"
                                 for p, n in runs) + f" {tail}"


def sample_entry(name: str, shapes: list) -> dict:
    """K16's-K21's kernels-line entry: the numbers of the timed shape
    launched most over the six paths, (as *_rn) those of the batched
    shape launched most, for K17 (as *_pick) those of its pick mode at one
    row (SAMPLE_PICK), for K18 (as single) those of one chain at one
    slot and at 1,000,000 (SAMPLE_SINGLE), beside their library call, and
    for K19 every census shape timed (timed) and (as *_one_pair) the one
    pair launched most beside torch.where."""
    pick = [r for r in shapes if r["pick"]]
    single = [r for r in shapes if r.get("single")]
    shapes = [r for r in shapes if not r["pick"] and not r.get("single")]
    top = max(shapes, key=lambda r: r["launches"])
    out = dict({key: top[key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
        "library_device_ms", "bytes", "bound_ms", "floor_ms", "shape")},
        name=name, route="cuda", source=SOURCES[name][0],
        replaces=SOURCES[name][1], bound_by="bytes")
    rn = [r for r in shapes if r["rows"] == "rn"]
    if rn:
        b = max(rn, key=lambda r: r["launches"])
        out.update({f"{key}_rn": b[key] for key in (
            "shape", "ms", "device_ms", "plain_ms", "library_ms",
            "bound_ms")})
    if pick:
        out.update({f"{key}_pick": pick[0][key] for key in (
            "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
            "library_ms", "library_device_ms", "bound_ms")})
    if single:
        out["single"] = [{key: r[key] for key in (
            "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
            "library_ms", "library_device_ms", "bound_ms")} for r in single]
    if name == "branch_select":   # every census shape, one pair's library
        out["timed"] = [dict({key: r.get(key) for key in (
            "launches", "device_ms", "host_us", "bound_ms",
            "library_device_ms")}, shape=_k19_short(r["shape"]))
            for r in shapes]
        one = [r for r in shapes if r["library_ms"] is not None]
        if one:
            b = max(one, key=lambda r: r["launches"])
            out.update({f"{key}_one_pair": b[key] for key in (
                "shape", "ms", "device_ms", "library_ms",
                "library_device_ms")})
    return out


def level_checks(ops, dev, census, path: str) -> dict:
    """K20 and K21 after a path: every census shape holding >= SHAPE_SHARE
    of the path's launches of the kernel, on seeded inputs of that shape
    (kernel_bench.level_inputs, from the fields the wrapper recorded in
    ops.CENSUS_FIELDS: K20's program, operand kinds, shapes and dtypes),
    against the plain version on the card, bit-equal
    (kernel_bench.check_level). Returns {kernel: [one dict per shape]}."""
    from pclean_tpu_torch import kernel_bench as kb

    out = {name: [] for name in LEVEL_KERNELS}
    for c in census:
        if c["kernel"] not in out or c["share"] < SHAPE_SHARE:
            continue
        fields = ops.CENSUS_FIELDS[c["kernel"]][c["mode"]]
        kb.check_level(ops, kb.level_inputs(dev, c["kernel"], fields,
                                            c["K"]))
        out[c["kernel"]].append(dict(
            shape=c["mode"], K=c["K"], rows=c["rows"], launches=c["launches"],
            share=c["share"], path=path, max_abs_err=0.0,
            **({"fields": fields} if c["kernel"] == "py_prior" else {})))
    print(f"{path} K20/K21 census shapes checked bit-equal: "
          f"{ {k: len(v) for k, v in out.items()} }", flush=True)
    torch.cuda.empty_cache()
    return out


# K20 is timed at its most launched one-row and batched census shapes and
# at the largest; K21 at every census shape checked
LEVEL_TIMED = {"r1": 4, "rn": 3}


def bench_level_shapes(ops, dev, checked: dict, floor) -> dict:
    """K20 and K21 timed, among the distinct census shapes checked (each
    holds >= SHAPE_SHARE of a path's launches): K20 at the LEVEL_TIMED
    most launched one-row and batched ones and at each path's largest (the
    most outputs), K21 at every one; on seeded inputs: kernel ms and
    device ms, the plain version, the bytes bound (kernel_bench.
    level_bytes) and the launch floor; no PyTorch call computes either
    function (library none). Returns {kernel: [one dict per shape]}."""
    from pclean_tpu_torch import kernel_bench as kb

    out = {}
    for name in LEVEL_KERNELS:
        fields = ops.CENSUS_FIELDS[name]
        shapes: dict = {}
        for r in checked[name]:
            sh = shapes.setdefault((r["shape"], r["K"]),
                                   dict(launches_by_path={}, rows=r["rows"]))
            sh["launches_by_path"][r["path"]] = r["launches"]
        ranked = sorted(shapes.items(), key=lambda kv: -sum(
            kv[1]["launches_by_path"].values()))
        top = [kv for rows, n in LEVEL_TIMED.items()
               for kv in [x for x in ranked if x[1]["rows"] == rows][:n]]
        if name == "py_prior":
            top = list(ranked)
        for path in sorted({r["path"] for r in checked[name]}):
            mine = [kv for kv in ranked if path in kv[1]["launches_by_path"]]
            big = max(mine, key=lambda kv: kv[0][1])
            if big not in top:
                top.append(big)
        out[name] = []
        for (mode, K), sh in top:
            inp = kb.level_inputs(dev, name, fields[mode], K)
            b = kb.level_bytes(inp)
            x = dict(shape=f"{mode} K={K}", K=K, rows=sh["rows"],
                     pick=False, max_abs_err=kb.check_level(ops, inp),
                     launches=sum(sh["launches_by_path"].values()),
                     launches_by_path=sh["launches_by_path"], bytes=b,
                     bound_ms=b / kb.HBM_BYTES_PER_S * 1e3, floor_ms=floor,
                     **kb.time_level(ops, inp))
            out[name].append(x)
            print(f"{name} {x['shape']} ({x['launches']} launches "
                  f"{x['launches_by_path']}): kernel {x['ms']:.4f} ms "
                  f"(device {x['device_ms']:.4f} ms) plain "
                  f"{x['plain_ms']:.4f} ms library none bound "
                  f"{x['bound_ms']:.6f} ms floor {floor:.4f} ms", flush=True)
            del inp
        print(f"{name}: timed {len(top)} of {len(shapes)} checked census "
              f"shapes (the most launched one-row and batched ones, each "
              f"path's largest)", flush=True)
        torch.cuda.empty_cache()
    return out


def param_checks(ops, dev, census, path: str) -> dict:
    """K22 and K23 after a path: every census shape holding >= SHAPE_SHARE
    of the path's launches of the kernel, on seeded inputs of that shape
    (kernel_bench.k22_inputs, k23_inputs, from the fields the wrapper
    recorded in ops.CENSUS_FIELDS: K22's descriptors, K23's capacities),
    against the plain version on the card on the same seed buffer,
    bit-equal (kernel_bench.check_k22: the count of elements whose draw
    differs, which must be 0; check_k23, out of place and in place).
    Returns {kernel: [one dict per shape]}."""
    from pclean_tpu_torch import kernel_bench as kb

    out = {name: [] for name in PARAM_KERNELS}
    for c in census:
        if c["kernel"] not in out or c["share"] < SHAPE_SHARE:
            continue
        f = ops.CENSUS_FIELDS[c["kernel"]][c["mode"]]
        r = kb.check_k22(ops, kb.k22_inputs(dev, f)) \
            if c["kernel"] == "gamma_draw" else \
            kb.check_k23(ops, kb.k23_inputs(dev, f))
        out[c["kernel"]].append(dict(
            shape=c["mode"], K=c["K"], rows=c["rows"], launches=c["launches"],
            share=c["share"], path=path, max_abs_err=r["max_abs_err"],
            differ=r.get("differ", 0), **({} if c["kernel"] == "gamma_draw"
                                         else dict(caps=f["caps"]))))
    print(f"{path} K22/K23 census shapes checked bit-equal: "
          f"{ {k: len(v) for k, v in out.items()} }", flush=True)
    return out


def bench_param_shapes(ops, dev, checked: dict, floor, lat) -> dict:
    """K22 and K23 timed at each distinct census shape checked (a call
    shape: its descriptors or classes), on seeded inputs: kernel ms and
    device ms, the plain version, K22's library calls (torch._standard_gamma
    at the same alphas: one PyTorch call drawing the same gammas; and
    torch._sample_dirichlet over each descriptor's rows, the same
    Dirichlet rows or Beta pairs, kernel_bench.dirichlet_library), and the
    bound: the larger of the bytes over 3.35 TB/s and the operations the
    inputs need (K22: its draws' rounds on this stream, over 67 TFLOP/s;
    K23: the instructions the three scores of every counted slot need,
    lgammaf and logf counted by the shortest path through their SASS,
    over the card's issue rate) (kernel_bench.k22_bounds, k23_bounds);
    K22 also its latency bound (the floor, one L2 load and the dependent
    chain of a draw and its row's sum, kernel_bench.k22_chain) and its
    geometry (ops.gamma_draw_plan). Returns {kernel: [one dict per
    shape]}."""
    from pclean_tpu_torch import kernel_bench as kb

    out = {}
    for name in PARAM_KERNELS:
        shapes: dict = {}
        for r in checked[name]:
            sh = shapes.setdefault(r["shape"], dict(launches_by_path={},
                                                    rows=r["rows"]))
            sh["launches_by_path"][r["path"]] = r["launches"]
        out[name] = []
        for mode, sh in sorted(shapes.items(), key=lambda kv: -sum(
                kv[1]["launches_by_path"].values())):
            f = ops.CENSUS_FIELDS[name][mode]
            if name == "gamma_draw":
                inp = kb.k22_inputs(dev, f)
                chain = kb.k22_chain(kb.k23_sass(ops), inp["descs"])
                x = dict(kb.k22_bounds(inp), **kb.time_k22(ops, inp),
                         chain=chain, latency_bound_ms=kb.latency_bound_ms(
                             chain, floor, lat),
                         plan=[dict(threads=L["threads"],
                                    parts=[p[2:] for p in L["parts"]])
                               for L in ops.gamma_draw_plan(
                                   [d[:3] for d in f["descs"]])])
            else:
                inp = kb.k23_inputs(dev, f)
                x = dict(kb.k23_bounds(inp, ops), **kb.time_k23(ops, inp))
            x.update(shape=mode, rows=sh["rows"], max_abs_err=0.0,
                     launches=sum(sh["launches_by_path"].values()),
                     launches_by_path=sh["launches_by_path"],
                     floor_ms=floor, pick=False)
            out[name].append(x)
            lib = "none" if x["library_ms"] is None else \
                f"{x['library_ms']:.4f} ms (device " \
                f"{x['library_device_ms']:.4f} ms)"
            if x.get("dirichlet_ms") is not None:
                lib += (f"; torch._sample_dirichlet x "
                        f"{x['dirichlet_calls']} {x['dirichlet_ms']:.4f} ms "
                        f"(device {x['dirichlet_device_ms']:.4f} ms)")
            lat_s = "" if name != "gamma_draw" else \
                f" latency bound {x['latency_bound_ms']:.6f} ms " \
                f"({x['chain']} instructions) plan {x['plan']}"
            print(f"{name} {mode} ({x['launches']} launches "
                  f"{x['launches_by_path']}): kernel {x['ms']:.4f} ms "
                  f"(device {x['device_ms']:.4f} ms) plain "
                  f"{x['plain_ms']:.4f} ms library {lib} bound "
                  f"{x['bound_ms']:.6f} ms ({x['bound_by']}: {x['bytes']} "
                  f"bytes, {x['flops']} "
                  f"{'flops' if name == 'gamma_draw' else 'instructions'}) "
                  f"floor {floor:.4f} ms{lat_s}",
                  flush=True)
    return out


def param_entry(name: str, shapes: list) -> dict:
    """K22's or K23's kernels-line entry: the numbers of the timed shape
    launched most over the six paths, with its bound and what binds it."""
    top = max(shapes, key=lambda r: r["launches"])
    out = dict({key: top[key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
        "library_device_ms", "bytes", "flops", "bound_ms", "bound_by",
        "floor_ms", "shape")}, name=name, route="cuda",
        source=SOURCES[name][0], replaces=SOURCES[name][1])
    if name == "gamma_draw":   # its latency bound, every shape's times
        out.update(latency_entry(top), timed=[{key: r[key] for key in (
            "shape", "launches", "device_ms", "library_device_ms",
            "latency_bound_ms")} for r in shapes])
    return out


# the synthetic model past every old single-launch limit (workloads/
# limits.py) on the card: its rows and batch, and its F1 floor (the CPU
# runs of both packages reach 1.0 on its tables, tests/test_torch_limits.py)
LIMITS = dict(rows=512, batch=64)
LIMITS_F1_FLOOR = 0.9
# the wrappers a limits run must call past their old limits, and each
# one's kernel (K7 hoisted chains, K14 sides, K15 columns, K17 ancestor
# axes and its group's members, K18 hops, K20 levels; K10's larger block
# and K11's split writes
# run in the shadow rows)
LIMIT_WRAPPERS = ("row_gather", "referrer_hist", "rel_scatter",
                  "batch_write", "choice_sample", "choice_sample_group",
                  "level_sum", "fk_score")
# and the wrappers that must have split or raised on its run (ops.SPLITS)
LIMIT_SPLITS = LIMIT_WRAPPERS + ("row_delta", "row_write")


def limits_phase(ops, dev) -> dict:
    """workloads/limits.py's synthetic model, past every old limit, on the
    card: compile -> init_state -> Engine.initialize -> one sweep ->
    evaluate_accuracy_device (run_path: the counts set to 0 before it and
    read after), the first call of each wrapper past its old limit
    recorded (kernel_bench.LimitCalls) and then held, split or raised, to
    its plain version on copies of those very inputs, bit-equal; K10 and
    K11 in shadow runs of every class kind (Record's plan in K10's larger
    block, Wide's rows past K11's 64 writes); refresh and the hop
    histograms through K14's folds against the CPU (check_rel_state); a
    seeded level of 260 operands nesting 40 deep through K20's stages.
    Fails where a wrapper was not called past its limit or did not split
    (LIMIT_SPLITS), a check differs, or the F1 is below LIMITS_F1_FLOOR."""
    from pclean_tpu_torch import kernel_bench as kb
    from pclean_tpu_torch.kernel_bench import require
    from pclean_tpu_torch.workloads import limits

    t = time.time()
    cm, config, dirty, clean, query, _s = limits.setup(**LIMITS,
                                                       device="cuda")
    compile_s = time.time() - t
    with kb.LimitCalls(ops) as rec:
        rep, (arenas, params, eng) = run_path(ops, "limits", cm, config,
                                              dirty, clean, query,
                                              LIMITS["rows"])
    missing = [w for w in LIMIT_WRAPPERS if w not in rec.calls] + \
        [w for w in LIMIT_SPLITS if w not in rep["splits"]]
    require(not missing, f"limits: never called past the old limit: "
            f"{missing}")
    replay = rec.replay()
    plan = ops.row_delta_plan(cm, "Record", "obs")
    shadow = {}
    for cid in cm.model.class_order:
        lay = cm.layouts[cid]
        kinds = (["init", "obs"] if lay.observed else
                 ["latent" if lay.fk_vertices else "leaf"])
        for kind in kinds:
            r = kb.shadow_rows(ops, eng, arenas, params, cid, kind, n=16,
                               seed=3)
            require(r["launches"] > 0 and r["mismatches"] == [],
                    f"limits shadow rows {cid} {kind}: {r}")
            shadow[f"{cid} {kind}"] = r["launches"]
    rs = kb.check_rel_state(ops, eng, arenas)
    require(rs["mismatches"] == [], f"limits rel state: {rs}")
    prog, operands = kb.split_level(np.random.default_rng(2))
    operands = kb._tree_map(operands, lambda x: x.to(dev))
    before = ops.LAUNCHES["level_sum"]
    got = ops.level_sum(prog, operands, 2, B=3, label="seeded")
    stages = ops.LAUNCHES["level_sum"] - before
    want = ops.level_sum_plain(prog, operands, 2)
    torch.cuda.synchronize()
    require(torch.equal(got, want) and stages > 1,
            f"limits: the seeded split level differs ({stages} stages)")
    require(rep["f1"] >= LIMITS_F1_FLOOR,
            f"limits F1 {rep['f1']} < {LIMITS_F1_FLOOR}")
    out = dict(rep, compile_s=compile_s, replay=replay, shadow=shadow,
               rel_state_launches=rs["launches"], k10_tier=plan["tier"],
               k10_nodes=len(plan["nodes"]), seeded_level_stages=stages)
    print(f"limits: every wrapper past its old limit equal to its plain "
          f"version {replay}; K10 Record plan tier {plan['tier']} "
          f"({len(plan['nodes'])} fk-tree nodes, chains "
          f"{sorted(len(e['chain']) for e in plan['props'])}); shadow "
          f"rows {shadow}; rel state {rs['launches']} K14 launches; seeded "
          f"level {stages} K20 stages; F1 {rep['f1']:.4f}", flush=True)
    return out


GRAPH_ROWS = 64   # rows of each loop kind the graph-against-eager phase runs


def graph_checks(path, eng, cm, state) -> list:
    """The graph-against-eager phase of a path, on its model and final
    state (the ramps from a fresh init_state): GRAPH_ROWS rows of each
    loop kind the path's configuration runs or graphs
    (kernel_bench.graph_against_eager): once every row eager with the
    kernels, once as replays of the captured row step, from the same state
    and generator state. hospital: the MH ramp, the observed (Record),
    latent-with-hops and leaf sweeps, and replay chunks (init and
    rejuvenation); hospital_pg1024: the collapsed PG ramp, sweep and
    replay; hospital_pg16_vmapped: the written-out PG replay chunk and
    sweep; flights: its Obs sweep and a leaf sweep; and on every path a
    latent class's replay chunks (rejuvenation and init: MH, the explicit
    MH comparison on flights, collapsed or written-out PG). Fails unless
    every leaf, the log-ML, the generator state and the launch counts are
    bit-equal and every row after the first was a replay."""
    from pclean_tpu_torch import kernel_bench as kb
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.refresh import hop_histograms
    from pclean_tpu_torch.kernel_bench import require

    arenas, params = state
    obs = cm.obs_specs[0].class_id
    pg0, pg = eng._pg_P(True), eng._pg_P(False)
    n = GRAPH_ROWS
    todo = []
    if path in ("hospital", "hospital_pg1024"):
        todo.append(("ramp", obs, True, "fresh"))
    if path in ("hospital", "hospital_pg1024", "hospital_pg16_vmapped",
                "flights"):
        todo.append(("sweep", obs, True, "state"))
    if path in ("hospital", "hospital_pg1024", "hospital_pg16_vmapped"):
        todo.append(("replay", obs, True, "state"))
        todo.append(("replay", obs, False, "state"))
    latents = [c for c in cm.model.class_order
               if not cm.layouts[c].observed]
    withfk = [c for c in latents if cm.layouts[c].fk_vertices]
    if path in ("hospital", "flights"):
        hops = [c for c in withfk
                if hop_histograms(cm, c, arenas, eng.obs_dev)]
        leaf = [c for c in latents if not cm.layouts[c].fk_vertices]
        for c in (hops or withfk)[:1] + leaf[:1]:
            todo.append(("sweep", c, True, "state"))
    # a latent class's replay rows: each refreshes the carry (K14), its row
    # excluded by the slot buffer where it rejuvenates
    for c in (withfk or latents)[:1]:
        todo.append(("replay", c, True, "state"))
        todo.append(("replay", c, False, "state"))
    out = []
    for loop, cid, rejuv, where in todo:
        if where == "fresh":
            a, p = init_state(cm, 0, device=cm.device)
        else:
            a, p = arenas, params
        rows = min(n, cm.layouts[cid].capacity)
        t = time.time()
        r = kb.graph_against_eager(eng, a, p, loop, cid, rows,
                                   pg_P=pg0 if loop == "ramp" or not rejuv
                                   else pg, rejuv=rejuv)
        r["s"] = time.time() - t
        out.append(r)
        st = r["stats"]
        print(f"{path} graph against eager: {r['kind']} ({cid}), {rows} "
              f"rows: {st['replayed']} replayed, {st['eager']} eager, "
              f"{st['captures']} capture(s) in {st['capture_s']:.3f} s, "
              f"{r['launches']} launches, mismatches {r['mismatches']} "
              f"({r['s']:.2f} s)", flush=True)
        require(not r["mismatches"], f"{path}: graph replays differ from the "
                f"eager rows in {r['kind']}: {r['mismatches']}")
        require(st["replayed"] == rows - 1 and st["captures"] == 1,
                f"{path}: {r['kind']} did not replay its rows: {st}")
        del a, p
    torch.cuda.empty_cache()
    return out


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
        mod, need = scaled, ("enum_logsumexp", "obs_gather_sum")
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
    # the sample pass's kernels (rents' County block has no foreign key)
    need = need + (SAMPLE_KERNELS if workload != "rents"
                   else ("choice_sample",))
    require(all(launched[k] > 0 for k in need),
            f"{workload} small check: kernels not launched: {launched}")
    return worst, launched


TRACE_N = 16   # a batched section: 1 + TRACE_N batches less 1 batch
# a graphed one-row section: 2 + TRACE_GRAPH_N rows less 2 rows (the
# warm-up row and the capture in both), so TRACE_GRAPH_N replays
TRACE_GRAPH_N = 128


def _trace(fn) -> dict:
    """fn() once under torch.profiler (CPU and CUDA activities), ending in a
    synchronize: its wall ms, device ops (kernels, copies and fills; in a
    CUDA graph's replay, its nodes), host syncs (the runtime's synchronize
    calls, less the closing one), device-to-host copies and device busy ms
    (the union of the device ops' intervals); and fn() three more times
    without the profiler, the least wall ms (wall_plain_ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    wall_plain = min(walls)
    spans, syncs, d2h, launches = [], 0, 0, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            spans.append((e.start_ns(), e.end_ns()))
            d2h += "DtoH" in name
        elif name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize"):
            syncs += 1
        elif name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += 1
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return dict(wall_ms=wall, wall_plain_ms=wall_plain,
                device_ops=len(spans), launches=launches, syncs=syncs - 1,
                d2h=d2h, busy_ms=busy / 1e6)


# ATen calls that issue no device work: views, allocations, metadata
_NOT_DEVICE = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "view", "_unsafe_view", "reshape",
               "expand", "as_strided", "slice", "select", "unsqueeze",
               "squeeze", "permute", "t", "transpose", "detach", "alias",
               "unbind", "split", "split_with_sizes", "lift_fresh",
               "set_", "resize_", "record_stream", "is_nonzero",
               "sym_size", "sym_stride", "sym_numel", "_reshape_alias",
               "view_as", "expand_as", "narrow", "chunk", "diagonal",
               "unfold", "movedim", "flatten", "unflatten"}


# the score pass's functions (engine/propose.py), this tree's and the
# parent's, so that a parent's checkout traced with this script sums them
# alike; py_logprobs, the batched fk's prior, is counted beside them
SCORE_PASS = ("score_plan", "score_step", "score_choice", "score_fk",
              "_gather_obs_term", "_mm_flush", "_level_sum")
# the parameter resampling's modules (resample_all and the conjugate
# draws, this tree's and the parent's: its pitman_yor_score, resample_py
# and sample_gamma's rejection loop count for these), tallied alike
PARAM_MODULES = ("engine.gibbs_params.", "dists.params.")


def ops_by_function(fn) -> dict:
    """fn() once, with every device op it issues attributed to the
    innermost function of the port's package on the Python stack: each
    ATen call that touches a CUDA tensor and is not a view or an
    allocation (a TorchDispatchMode), and each hand-kernel launch
    (ops._count, named "launch <kernel>"). Frames of utils.py count for
    their caller; a call inside ops.py counts as ops.<function> (a
    wrapper's own torch calls). Returns dict(total, launches, by_function
    [(function, ops), most first], by_kernel {kernel: launches},
    score_pass: the ops of SCORE_PASS's functions, py_logprobs: those of
    BlockTracer.py_logprobs, param_resampling: those of PARAM_MODULES)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from pclean_tpu_torch import ops

    pkg = os.path.dirname(os.path.abspath(ops.__file__)) + os.sep
    counts: dict = {}
    kernels: dict = {}

    def site(skip_ops: bool) -> str:
        f = sys._getframe(2)
        while f is not None:
            name = f.f_code.co_filename
            if name.startswith(pkg) and not name.endswith("utils.py") and \
                    not (skip_ops and name.endswith("ops.py")):
                mod = os.path.relpath(name, pkg)[:-3].replace(os.sep, ".")
                return f"{mod}.{f.f_code.co_name}"
            f = f.f_back
        return "(outside the package)"

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name not in _NOT_DEVICE and not getattr(func, "is_view",
                                                       False):
                flat = tree_flatten((args, kwargs, out))[0]
                if any(torch.is_tensor(x) and x.is_cuda for x in flat):
                    k = site(False)
                    counts[k] = counts.get(k, 0) + 1
            return out

    base = ops._count

    def counted(name, *args, **kwargs):
        k = site(True)
        counts[k] = counts.get(k, 0) + 1
        kernels[name] = kernels.get(name, 0) + 1
        return base(name, *args, **kwargs)

    torch.cuda.synchronize()
    ops._count = counted
    try:
        with Count():
            fn()
    finally:
        ops._count = base
    torch.cuda.synchronize()
    def of(names):
        return sum(n for f, n in counts.items()
                   if f.startswith("engine.propose.")
                   and f.rsplit(".", 1)[1] in names)

    return dict(total=sum(counts.values()), launches=sum(kernels.values()),
                by_function=sorted(counts.items(), key=lambda kv: -kv[1]),
                by_kernel=kernels, score_pass=of(SCORE_PASS),
                py_logprobs=of(("py_logprobs",)),
                param_resampling=sum(n for f, n in counts.items()
                                     if f.startswith(PARAM_MODULES)))


def _shares(r: dict) -> dict:
    """r with the device's idle share of the wall time under the profiler
    (idle_share) and, as a ratio of two runs, the busy time under the
    profiler over the wall time without it (busy_over_plain_wall): no idle
    share, since the two come from different runs. Each None where its
    wall is not above the busy time (a difference of two walls can come
    out below it: the runs' one-off costs, such as a graph's capture,
    differ more than the step)."""
    def ratio(wall):
        return r["busy_ms"] / wall if wall > r["busy_ms"] else None
    busy = ratio(r["wall_ms"])
    r["idle_share"] = None if busy is None else 1.0 - busy
    r["busy_over_plain_wall"] = ratio(r["wall_plain_ms"])
    return r


def _trace_per(big: dict, small: dict, n: int) -> dict:
    """One step's share: (big - small) / n for every count and time, with
    _shares."""
    out = {k: (big[k] - small[k]) / n for k in big
           if k not in ("sync_sites", "eager_row")}
    out["sync_sites"] = big["sync_sites"]
    return _shares(out)


def trace_sections(path, cm, config, state=None) -> dict:
    """The trace phase's sections of a path, each section's loop started
    from one state and its result dropped, each run once to warm up, then
    under _trace:
      hospital: one ramp row (scan_init, 2 + TRACE_GRAPH_N rows less 2
        rows, over TRACE_GRAPH_N: one replay of the captured row step; the
        warm-up row and the capture are in both) and one batched init
        segment (scan_init_batched at its B,
        batch_segment_rows // B batches, whole), from init_state, where
        the path's init starts (the batched segment without the ramp's
        rows before it);
      flights: one Obs sweep row (_sweep_segment, as the ramp row) on the
        path's state `state` (arenas, params) after its sweeps, or, where
        none is given, after an Engine.initialize of the path's rows;
      rents: one Obs init batch at its B (scan_init_batched, 3 batches less
        1, over 2), from init_state;
      scaled: one latent replay row (_replay_chunk of the first latent
        class with fks, rejuvenating, as the ramp row: one replay of the
        captured row step, which refreshes the carry with its row
        excluded) on the path's state `state`, or, where none is given,
        after an Engine.initialize of the path's rows.
    Returns {section: counts and times, with the idle share}."""
    import dataclasses
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine

    # the profiler's first use sets up its tracing: not inside a section
    _trace(lambda: torch.zeros((1,), device=cm.device).add_(1.0))
    eng = Engine(cm, dataclasses.replace(config), device=cm.device)
    gen = torch.Generator(device=cm.device)
    gen.manual_seed(0)
    if state is not None:
        arenas, params = state
    else:
        arenas, params = init_state(cm, 0, device=cm.device)
        if path in ("flights", "scaled"):
            arenas, params, _g = eng.initialize(1, arenas, params)
    cid = cm.obs_specs[0].class_id
    n_rows = cm.obs_specs[0].num_rows
    B = config.batch_rows

    # a row alone: no resample_all inside the traced rows (the eager rows
    # of earlier runs traced 17 rows of 50)
    eng1 = Engine(cm, dataclasses.replace(config, rejuv_frequency=10 ** 6),
                  device=cm.device)

    def rows(k, graph=True):
        if path == "flights":
            return lambda: eng1._sweep_segment(cid, arenas, params, 0, gen, k,
                                               graph=graph)
        if path == "scaled":
            lat = [c for c in cm.model.class_order
                   if not cm.layouts[c].observed and cm.layouts[c].fk_vertices]
            return lambda: eng1._replay_chunk(
                lat[0], arenas, params, np.arange(k, dtype=np.int64), gen,
                True, graph=graph)
        eng1.config.scan_segment = k
        run, _seg = eng1.scan_init(cid, n_rows)
        return lambda: run(arenas, params, 0, gen, graph=graph)

    def batches(k):
        eng.config.batch_segment_rows = k * B
        run, _nb, _sb = eng.scan_init_batched(cid, n_rows, B)
        return lambda: run(arenas, params, 0, gen)

    def measured(fn):
        fn()
        out = _trace(fn)
        # the syncs PyTorch itself flags (its sync debug mode), outside the
        # profiler
        import warnings
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
                torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        flagged = [w for w in caught if "synchroniz" in str(w.message)]
        out["flagged_syncs"] = len(flagged)
        # where they come from: the Python line of each, most frequent first
        sites: dict = {}
        for w in flagged:
            site = f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
        out["sync_sites"] = sorted(sites.items(), key=lambda kv: -kv[1])[:8]
        return out

    out = {}
    if path in ("hospital", "flights", "scaled"):
        label = {"hospital": "ramp row", "flights": "Obs sweep row",
                 "scaled": "latent replay row"}[path]
        small = measured(rows(2))
        big = measured(rows(2 + TRACE_GRAPH_N))
        out[f"{path} {label}"] = _trace_per(big, small, TRACE_GRAPH_N)
        # the device ops of one eager row (a replay's warm-up row), by
        # the port function that issued them
        eager = rows(1, graph=False)
        eager()
        out[f"{path} {label}"]["eager_row"] = ops_by_function(eager)
    if path == "hospital":
        seg_fn = batches(config.batch_segment_rows // B)
        seg = measured(seg_fn)
        seg["eager_row"] = ops_by_function(seg_fn)
        out["hospital batched segment"] = _shares(seg)
    if path == "rents":
        small, big = measured(batches(1)), measured(batches(3))
        out["rents Obs batch"] = _trace_per(big, small, 2)
    def f4(x):
        return "n/a" if x is None else f"{x:.4f}"

    for name, r in out.items():
        e = r.get("eager_row")
        if e is not None:
            print(f"trace {name}: one eager run issues {e['total']} device "
                  f"ops ({e['launches']} hand-kernel launches "
                  f"{e['by_kernel']}); the score pass {e['score_pass']} "
                  f"({', '.join(SCORE_PASS)}), py_logprobs "
                  f"{e['py_logprobs']}, the parameter resampling "
                  f"{e.get('param_resampling')} ({', '.join(PARAM_MODULES)})"
                  f"; by function: "
                  f"{e['by_function'][:30]}", flush=True)
            k = e["by_kernel"]
            r["k20_nodes"] = k.get("level_sum", 0)
            print(f"trace {name}: K20 nodes {r['k20_nodes']} of "
                  f"{r['device_ops']:.1f} device ops (graph nodes), beside "
                  f"K12 {k.get('fk_score', 0)} and K13 "
                  f"{k.get('choice_score', 0)}", flush=True)
        print(f"trace {name}: wall {r['wall_ms']:.3f} ms (without the "
              f"profiler {r['wall_plain_ms']:.3f} ms), device busy "
              f"{r['busy_ms']:.3f} ms, idle share {f4(r['idle_share'])} "
              f"(busy under the profiler over the wall without it "
              f"{f4(r['busy_over_plain_wall'])}), "
              f"device ops (graph nodes) {r['device_ops']:.1f}, kernel "
              f"launches "
              f"{r['launches']:.1f}, host syncs {r['syncs']:.1f}, "
              f"device-to-host copies {r['d2h']:.1f} (under the profiler); "
              f"syncs flagged by the sync debug mode {r['flagged_syncs']:.1f}"
              f", from {r['sync_sites']}", flush=True)
    del arenas, params, eng, eng1
    torch.cuda.empty_cache()
    return out


def trace_only() -> int:
    """`--trace`: the trace phase alone, on the scaled, MH hospital,
    flights and rents paths' models (compiled here; the only inference is
    the scaled and flights inits their rows start from); prints each
    section and, last, the trace as one JSON object."""
    from pclean_tpu_torch import ops
    from pclean_tpu_torch.workloads import flights, hospital, rents, scaled

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    print(f"package: {os.path.dirname(ops.__file__)}", flush=True)
    ops.build_kernels()
    setups = {"scaled": lambda: scaled.setup(
                  rows=ROWS, batch=BATCH, device="cuda", **SCALED),
              "hospital": lambda: hospital.setup(
                  **HOSPITAL_PATHS["hospital"], device="cuda"),
              "flights": lambda: flights.setup(**FLIGHTS, device="cuda"),
              "rents": lambda: rents.setup(
                  rows=RENTS["rows"], states=RENTS["states"],
                  counties=RENTS["counties"], batch=RENTS["batch"],
                  device="cuda")}
    trace = {}
    for path, setup in setups.items():
        cm, config, *_rest = setup()
        t = time.time()
        trace.update(trace_sections(path, cm, config))
        print(f"trace {path}: {time.time() - t:.2f} s", flush=True)
        del cm, config, _rest
    print(json.dumps({"trace": trace}))
    return 0


def fused_order_check() -> dict:
    """The fused order of a small batched MH sweep on the card
    (Engine._sweep_batched_fused: every class's batches, then every
    class's deferred rows, K10 and K11 in the replays): the scaled
    workload's CPU config (512 rows, B = 8) at the default
    fused_dispatch_rows, init and one sweep. Fails unless every class took
    the fused order and the F1 reaches 0.5."""
    from pclean_tpu_torch import ops
    from pclean_tpu_torch.analysis import evaluate_accuracy_device
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.kernel_bench import require
    from pclean_tpu_torch.workloads import scaled

    cm, config, dirty, clean, query, _s = scaled.setup(
        rows=512, hospitals=48, counties=12, names=24, zips=32, batch=8,
        device="cuda")
    arenas, params = init_state(cm, 0, device="cuda")
    eng = Engine(cm, config, device="cuda")
    arenas, params, gen = eng.initialize(1, arenas, params)
    before = dict(ops.LAUNCHES)
    arenas, params, gen = eng.run(gen, arenas, params)
    launched = {k: ops.LAUNCHES[k] - before[k] for k in ROW_KERNELS}
    f1 = evaluate_accuracy_device(cm, arenas, params, dirty, clean,
                                  query)["f1"]
    sweep = {k: v for k, v in eng.phase_times.items()
             if k.startswith("sweep:")}
    print(f"fused order check (scaled, 512 rows, B = 8): F1 {f1:.4f}, "
          f"phases {sweep}, K10/K11 launches in the sweep {launched}",
          flush=True)
    require(sweep and all(v.get("order") == "fused" for v in sweep.values()),
            f"the small sweep did not take the fused order: {sweep}")
    require(f1 >= 0.5, f"fused order check: F1 {f1}")
    return dict(f1=f1, phases=sweep, launches=launched)


def run_path(ops, name, cm, config, dirty, clean, query, rows):
    """One workload's main path, with every launch count set to 0 just
    before it and read just after: init_state, Engine.initialize,
    Engine.run, evaluate_accuracy_device; the report's `splits` are the
    wrapper calls that went past a single launch's limit (ops.SPLITS).
    Returns its report (and the state, for the kernel inputs drawn from
    it)."""
    from pclean_tpu_torch.analysis import evaluate_accuracy_device
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine

    from pclean_tpu_torch.engine import row_graph

    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    row_graph.reset_stats()
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
    loops = {k: dict(v) for k, v in row_graph.STATS.items()}
    res = evaluate_accuracy_device(cm, arenas, params, dirty, clean, query)
    occ = eng.arena_occupancy(arenas)
    rep = dict(rows=rows, batch_rows=config.batch_rows, init_s=init_s,
               sweep_s=sweep_s, rows_cleaned_per_s=rows / (init_s + sweep_s),
               f1=res["f1"], precision=res["precision"],
               recall=res["recall"], occupancy=occ,
               phase_times=eng.phase_times,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               memory_allocated_at_start=at_start, launches=launches,
               launches_by_shape=by_shape, census=census,
               log_ml=float(eng.log_ml), particles=config.num_particles,
               pg=not config.use_mh_instead_of_pg, loops=loops,
               splits=dict(ops.SPLITS))
    print(f"{name} path ({rows} rows, B={config.batch_rows}): init "
          f"{init_s:.2f} s, sweep {sweep_s:.2f} s, rows-cleaned/s "
          f"{rep['rows_cleaned_per_s']:.1f}"
          + (f", PG P={config.num_particles}, init log-ML {rep['log_ml']}"
             if rep["pg"] else ""), flush=True)
    print(f"{name} phases (wall s): {eng.phase_times}")
    print(f"{name} F1 {res['f1']:.4f} precision {res['precision']:.4f} "
          f"recall {res['recall']:.4f}; occupancy {occ}; "
          f"max_memory_allocated {rep['max_memory_allocated']} (of which "
          f"allocated before the path {at_start})")
    print(f"{name} launches: {launches}; by shape (r1 = one row, rn = "
          f"more): {by_shape}; calls past a single launch's limit: "
          f"{rep['splits']}", flush=True)
    for kind, st in sorted(loops.items()):
        print(f"{name} one-row loop {kind}: {st['segments']} segments, "
              f"{st['replayed']} rows replayed, {st['eager']} eager, "
              f"{st['captures']} captures in {st['capture_s']:.4f} s")
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
    lat = kb.l2_latency_ms()
    report["l2_latency_ms"] = lat
    print(f"launch floor {floor:.4f} ms, one dependent L2 load {lat:.6f} ms",
          flush=True)
    report["param_blocks"] = kb.param_block_ms()
    print(kb.param_block_lines(report["param_blocks"]), flush=True)
    report["fused_order_check"] = fused_order_check()
    for wl in ("scaled", "rents", "flights", "hospital"):
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
    report["trace"] = {}
    report["shadow"] = {}
    report["graph_checks"] = {}
    report["rel_state"] = {}

    def row_checks(path, eng, arenas, params, census):
        res, report["shadow"][path] = bench_rows(ops, eng, arenas, params,
                                                 census, path, floor, lat)
        add(path, res)
        res, report["rel_state"][path] = rel_checks(ops, eng, arenas, census,
                                                    path)
        add(path, res)
        add(path, sample_checks(ops, dev, census, path))
        add(path, level_checks(ops, dev, census, path))
        add(path, param_checks(ops, dev, census, path))
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
    row_checks("scaled", eng, arenas, params, sc["census"])
    phase("scaled trace")
    report["trace"].update(trace_sections("scaled", cm, config,
                                          (arenas, params)))
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
    rk, k5_shapes = bench_rents_kernels(ops, cm, arenas, params,
                                        eng.obs_dev, rn["census"], floor)
    kernels += rk
    add("rents", {k["name"]: [k] for k in rk})
    add("rents", {"gauss_ext_term": k5_shapes})
    add("rents", bench_k7_k8_census(ops, eng, arenas, params, rn["census"],
                                    RENTS["batch"], "rents", floor))
    row_checks("rents", eng, arenas, params, rn["census"])
    phase("rents trace")
    report["trace"].update(trace_sections("rents", cm, config))
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
    kernels.append(bench_flights_k6(ops, eng, arenas, params, fl["census"],
                                    floor))
    add("flights", {"maybe_swap_ext": kernels[-1].pop("shapes")})
    row_checks("flights", eng, arenas, params, fl["census"])
    phase("flights graph against eager")
    report["graph_checks"]["flights"] = graph_checks("flights", eng, cm,
                                                     (arenas, params))
    phase("flights trace")
    report["trace"].update(trace_sections("flights", cm, config,
                                          (arenas, params)))
    del cm, dirty, clean, query, arenas, params, eng
    torch.cuda.empty_cache()

    # the hospital model's paths: MH, collapsed PG at 100,000 rows and the
    # written-out PG path, each with K7 and K8 at its census shapes
    runs = {"scaled": sc, "rents": rn, "flights": fl}
    for path, cfg in HOSPITAL_PATHS.items():
        phase(f"{path} path")
        t = time.time()
        cm, config, dirty, clean, query, _sweeps = hospital.setup(
            **cfg, device="cuda")
        compile_s = time.time() - t
        rows = cfg["rows"] * cfg["repeat"]
        print(f"{path} compile_model: {compile_s:.2f} s, capacities "
              f"{ {c: cm.layouts[c].capacity for c in cm.model.class_order} }"
              f", exact Gibbs {cm.exact_gibbs_ok}, composed SA tensors "
              f"{[a.shape for a in cm._ext_sa_cache.values()]}", flush=True)
        hp, (arenas, params, eng) = run_path(ops, path, cm, config, dirty,
                                             clean, query, rows)
        runs[path] = hp
        report[path] = dict(hp, compile_s=compile_s,
                            f1_floor=F1_FLOORS[path])
        phase(f"{path} kernel checks")
        add(path, bench_k7_k8_census(ops, eng, arenas, params, hp["census"],
                                     cfg["batch"], path, floor))
        row_checks(path, eng, arenas, params, hp["census"])
        phase(f"{path} graph against eager")
        report["graph_checks"][path] = graph_checks(path, eng, cm,
                                                    (arenas, params))
        if path == "hospital":
            phase("hospital trace")
            report["trace"].update(trace_sections("hospital", cm, config))
        del cm, dirty, clean, query, arenas, params, eng
        torch.cuda.empty_cache()

    # K1-K3 and K9 at every path's census shapes, on seeded inputs: last, so
    # that the CUDA graphs they are timed in leave nothing behind in a
    # path's peak memory
    batch = dict({p: c["batch"] for p, c in HOSPITAL_PATHS.items()},
                 scaled=BATCH, rents=RENTS["batch"], flights=1)
    for path in PATHS:
        phase(f"{path} K1-K3 census shapes")
        B = batch[path]
        add(path, bench_k1_shapes(ops, dev, runs[path]["census"], B))
        add(path, {"obs_gather_sum": bench_k3_shapes(
            ops, dev, runs[path]["census"], B)})
        add(path, {"pg_resample": bench_k9_census(
            ops, dev, runs[path]["census"], B, path, floor, lat)})
    phase("K12 and K13 census shapes")
    score = bench_score_shapes(ops, dev, runs, floor)
    for name, rows in score.items():
        checked[name] += [dict(r, path="all") for r in rows]
    phase("K14 and K15 census shapes")
    rel = bench_rel_shapes(ops, dev, checked, floor)
    phase("K16-K19 census shapes")
    sample = bench_sample_shapes(ops, dev, checked, floor)
    phase("K20 and K21 census shapes")
    level = bench_level_shapes(ops, dev, checked, floor)
    phase("K22 and K23 census shapes")
    param = bench_param_shapes(ops, dev, checked, floor, lat)
    phase("limits")
    report["limits"] = limits_phase(ops, dev)
    kernels += [k7_k8_entry(name, checked[name])
                for name in ("referrer_hist", "sa_ext_term")]
    kernels.append(k9_entry(checked["pg_resample"]))
    kernels += [row_entry(name, checked[name]) for name in ROW_KERNELS]
    kernels += [score_entry(name, score[name]) for name in SCORE_KERNELS]
    kernels += [rel_entry(name, rel[name]) for name in REL_KERNELS]
    kernels += [sample_entry(name, sample[name]) for name in SAMPLE_KERNELS]
    kernels += [sample_entry(name, level[name]) for name in LEVEL_KERNELS]
    kernels += [param_entry(name, param[name]) for name in PARAM_KERNELS]
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
        if k["name"] == "gamma_draw":   # draws that differ (checks need 0)
            k["differ"] = sum(r.get("differ", 0) for r in shapes)
        print(f"{k['name']}: {len(shapes)} shapes checked on "
              f"{sorted({str(r['path']) for r in shapes})}, worst max_abs_err "
              f"{k['max_abs_err']:.3g}", flush=True)
    for path, need in NEED.items():
        # none of the six paths passes an old limit, so none splits
        require(not runs[path]["splits"], f"{path} split "
                f"{runs[path]['splits']}")
        missing = [k for k in need if runs[path]["launches"][k] <= 0]
        require(not missing, f"kernels never launched on the {path} path: "
                f"{missing}")
        require(runs[path]["f1"] >= F1_FLOORS[path],
                f"{path} F1 {runs[path]['f1']} < {F1_FLOORS[path]}")
        require(not runs[path]["pg"] or math.isfinite(runs[path]["log_ml"]),
                f"{path} log-ML {runs[path]['log_ml']} is not finite")
    k9_modes = {r["mode"] for r in runs["hospital_pg16_vmapped"]["census"]
                if r["kernel"] == "pg_resample"}
    require(k9_modes == set(ops.K9_MODES),
            f"K9 launched in modes {k9_modes} on hospital_pg16_vmapped")
    report["total_s"] = time.time() - t0
    print(f"chip_smoke: {report['total_s']:.1f} s from the build to here",
          flush=True)
    report["kernels"] = kernels
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "dep_loads", "dep_bound_ms",
            "bytes_bound_ms", "latency_bound_ms",
            *(f"launches_{p}" for p in PATHS), "launches_r1", "ms_r1",
            "device_ms_r1", "plain_ms_r1", "bound_ms_r1", "library_ms_r1",
            "shape_rn", "ms_rn", "device_ms_rn", "plain_ms_rn",
            "library_ms_rn", "bound_ms_rn", "shape_pick", "ms_pick",
            "device_ms_pick", "plain_ms_pick", "library_ms_pick",
            "library_device_ms_pick", "bound_ms_pick", "single",
            "shape_one_pair", "ms_one_pair", "device_ms_one_pair",
            "library_ms_one_pair", "library_device_ms_one_pair", "timed",
            "floor_ms", "shape", "shapes_checked", "differ")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys if k in kk}
                                  for kk in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(trace_only() if "--trace" in sys.argv[1:] else main())
