"""The port's hand-written CUDA kernels: build, bind, plain versions, counts.

Twenty-three kernels carry the block enumeration, the particle resampling,
the one-row loops' relational delta, row write and score glue, the
batched relational scatters and row writes, the block proposal's sample
pass and row lookups, the score pass's accumulation glue and the
parameter resampling of the port's paths (sources
in pclean_tpu_torch/csrc/, each with a header note on the JAX computation it
replaces, its bound on the H100 and its design):

  K1 enum_logsumexp  — record [R, K+1] = [exist, new] and logZ [R] in one
                       pass (propose.py score_fk / score_choice logsumexp);
  K2 inv_cdf_sample  — inverse-CDF categorical draw per row
                       (propose.py _inv_cdf_from_u);
  K3 obs_gather_sum  — out[b, k] = sum_c M_c[obs[b, c], word[c, k]], the
                       AddTypos observed-column score (propose.py
                       _matmul_obs_term/_mm_flush and the eager gather);
  K4 gauss_suffstats — per (slot, group) Gaussian sufficient statistics of
                       a latent class's referrers (propose.py
                       referrer_histograms' gauss_stats scatters);
  K5 gauss_ext_term  — the closed-form Gaussian external of a latent block
                       from the env coordinates and those statistics
                       (propose.py _ext_gauss_term);
  K6 maybe_swap_ext  — a MaybeSwap external summed over each row's
                       referrers for every option of its enumerated value
                       (propose.py _ext_terms' dense path, the flights
                       Flight time block);
  K7 referrer_hist   — referrer-observation histograms of the AddTypos
                       externals: hoisted over a class's slots through the
                       fk chain (propose.py referrer_histograms), or per
                       batch row (_ext_hist_term's in-step scatter);
  K8 sa_ext_term     — the composed AddTypos external (word = table[env
                       option, referrer value], the hospital stateavg)
                       summed over each row's referrers (propose.py
                       _ext_hist_term's composed case);
  K9 pg_resample     — a particle-Gibbs row's ESS-adaptive multinomial
                       resampling with retain-first, or its final
                       categorical, and the log-ML increment
                       (particles.py propose_row_pg);
  K10 row_delta      — one row's relational delta, in place: reference
                       counts, alive bits, totals and live counts down the
                       fk tree, propagated observations, a latent row's
                       hop moves (refresh.py row_delta, latent_row_delta,
                       hop_move);
  K11 row_write      — one row's accepted values, alive bit and births
                       written into the arenas, in place (smc.py
                       apply_row);
  K12 fk_score       — one row's foreign-key record [R, K+1] and logZ with
                       its Pitman-Yor prior, its two child levels summed
                       in the same launch by K20's code (propose.py
                       score_fk with py_logprobs and score_plan, B = 1);
  K13 choice_score   — one row's enumerable-choice record [R, V] and logZ
                       from its enum logits, observation and child level,
                       summed in the same launch (propose.py score_choice
                       and score_plan, B = 1);
  K14 rel_scatter    — one relational scatter with JAX's mode="drop" rule
                       inside the kernel: reference counts and propagated
                       observations along fk chains, the batched deltas'
                       old and new sides, a class's cascade (refresh.py
                       refresh, hop_histograms, batch_obs_delta,
                       batch_latent_delta, _cascade);
  K15 batch_write    — a batch of accepted rows written out of place: a
                       class's columns and alive bits copied and the rows
                       written into the copies in one launch (smc.py
                       _apply_batch);
  K16 fk_sample      — a foreign key's sample step for every row: the
                       record picked at the ancestors, the draw (K2's, from
                       csrc/inv_cdf.cuh) or the retained slot, the
                       full-arena guard, the free slot and the working
                       alive mask's write (propose.py sample_fk);
  K17 choice_sample  — a choice's sample step for every row: the draw, the
                       retained value with the dummy code, or a recorded
                       value picked at the ancestors (propose.py
                       sample_choice, _pick);
  K18 row_gather     — a group of vertices' stored values at one slot
                       tensor through their fk chains (propose.py
                       row_value's gathers, a foreign key's copy-mode
                       reads);
  K19 branch_select  — a foreign key's existing/fresh select over its
                       subtree's values (propose.py sample_fk's where);
  K20 level_sum      — one enumeration level's additive terms (dense
                       terms, copy-mode equalities, non-enumerable
                       observed terms, at one row the deferred AddTypos
                       gathers) summed in the parent's eager order from a
                       postfix program (propose.py score_plan, score_step,
                       score_choice, _mm_flush);
  K21 py_prior       — a batched foreign key's Pitman-Yor prior through
                       its compaction plus its children: K1's two inputs
                       (propose.py py_logprobs and score_fk's adds);
  K22 gamma_draw     — every Proportions and Prob draw of a parameter
                       resample: Gamma(alpha, 1) on a counter-based
                       Philox stream, Dirichlet rows and Beta pairs
                       (dists/params.py, gibbs_params.py's conjugate
                       draws; jax.random.gamma, dirichlet, beta);
  K23 py_resample    — the Pitman-Yor hyperparameter MH of every latent
                       class: the EPPF's scans and three scores, two
                       accepts (pclean_tpu's gibbs_params.py
                       resample_py, pitman_yor_score).

Each has a plain PyTorch version here. A wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches its kernel or
raises. `LAUNCHES` counts the wrapper calls that launch a kernel, one a
call (plain calls are not counted): a call is one launch of its kernel,
except that K7's wrapper zeroes its output with a PyTorch fill first and
K8's, where the plan splits a row's referrers (S > 1, as at one row),
adds a second launch that merges the splits;
`LAUNCHES_BY_SHAPE` splits the same launches into those over one row
("r1", the sequential loops) and over more ("rn", the batched phases);
`LAUNCH_CENSUS` splits K1's, K2's, K3's and K5-K23's further by mode and
row length. Inside a captured CUDA graph (engine/row_graph.py) a wrapper
runs once, at the capture; the graph then adds the captured step's counts
once for each replay (`snapshot`, `add_counts`), so the counts are
launches on the card either way.
Each kernel takes a launch plan (path and geometry: threads, tiles,
cluster, shared memory, grid) from a function of its shapes alone,
`enum_logsumexp_plan`, `inv_cdf_plan`, `obs_gather_plan`,
`gauss_suffstats_plan`, `gauss_ext_term_plan`, `maybe_swap_ext_plan`,
`referrer_hist_plan`, `sa_ext_term_plan`, `pg_resample_plan`,
`rel_scatter_plan` (K14's route: a thread a source, or a histogram in
each block's shared memory) and `py_resample_plan` (K23's
threads, cluster and slots a thread); the C
entry points launch
the plan they are given, so the plan the CPU tests check is the one
launched. K10's and K11's plans (`row_delta_plan`, built once a class and
cached on the model; K11's `row_write_plan` from a row's structure: a
table of index groups and three words a write) travel by value as the
kernel's argument, bound to the pointers of a loop segment's carry
(`RowCarry`) once, so no table lives on the card. K14's and K15's words
(pointers, dtypes, lengths, K14's route; K15's clusters, shares and block
table from `batch_write_plan`, built once a call structure)
are built at each call, also by value, and so are K16's, K17's and
K21-K23's (K21's `py_prior_words`; K22's descriptors, K23's classes).
K19's are built once a call structure (`_K19_PLANS`: each pair's dtypes,
lengths and broadcast), each call writing its pointers into them and
taking its outputs as views of one allocation.
K18's (a group's hop-column tree and chains, `row_gather_plan`,
`row_gather_words`), K20's (a level's references, operands and
program, `level_plan`) and K12's and K13's (their head words and their
child levels' `level_plan` words over the record, `fk_score_words`,
`choice_score_words`; the geometry `fk_score_plan`, `choice_score_plan`
from the rows, `score_spread`) are built once a call structure
(dtypes, shapes, strides, labels) and kept, each call writing only its
pointers into them (`_K18_PLANS`, `_K20_PLANS`, `_K12_PLANS`,
`_K13_PLANS`).

Fixed limits split or raise, never fall back to a plain version (each
split in a plan function the CPU tests read): K11's writes, K15's columns
and K14's cascade fk columns go in launches of at most the limit
(`row_write_chunks`, `batch_write_chunks`, `cascade_groups`); chains
longer than K7, K14 or K18 follow are folded first by K18 launches into
buffers the call owns (`chain_folds`, `fold_chain`); a K20 level past one
launch is cut at subexpressions whose sums the next stage pushes
(`level_stages`), and a K12/K13 child level so cut has its earlier
stages summed by K20, as has a K12 ch_n whose words do not fit one
parameter block beside ch_e's (`score_fusion`); K10 takes the smaller of
two parameter blocks that holds its plan (`K10_TIERS`, `k10_tier`; the
larger counted as a split), K19 up to 64 pairs a launch (`K19_MAX_PAIRS`;
more, launches of 64), K16/K17 up to `_MAX_ANC` ancestor axes and K23
up to K23_MAX_CLASSES classes a launch, each class at most K23_MAX_ROUNDS
slots a thread of its cluster (`py_resample_plan`: 134,217,728 slots; a
larger class raises).

Build: one `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared` per
source, all started together, into pclean_tpu_torch/_build/ (listed in
.gitignore) at first use, skipped where the library is newer than its
sources; the libraries have a plain C interface and are loaded with
ctypes. Nothing is built or loaded when the module is imported.
"""
from __future__ import annotations

import array
import bisect
import collections
import ctypes
import functools
import math
import os
import shutil
import subprocess
import threading
import time

import torch

from .utils import (NEG_INF, chase, effective_sample_size,
                    index_set_where, log_normalize, logsumexp,
                    scatter_add_drop, scatter_max_drop, take)

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
_SOURCES = {
    "enum_logsumexp": "enum_logsumexp.cu",
    "inv_cdf_sample": "inv_cdf_sample.cu",
    "obs_gather_sum": "obs_gather_sum.cu",
    "gauss_suffstats": "gauss_suffstats.cu",
    "gauss_ext_term": "gauss_ext_term.cu",
    "maybe_swap_ext": "maybe_swap_ext.cu",
    "referrer_hist": "referrer_hist.cu",
    "sa_ext_term": "sa_ext_term.cu",
    "pg_resample": "pg_resample.cu",
    "row_delta": "row_delta.cu",
    "row_write": "row_write.cu",
    "fk_score": "fk_score.cu",
    "choice_score": "choice_score.cu",
    "rel_scatter": "rel_scatter.cu",
    "batch_write": "batch_write.cu",
    "fk_sample": "fk_sample.cu",
    "choice_sample": "choice_sample.cu",
    "row_gather": "row_gather.cu",
    "branch_select": "branch_select.cu",
    "level_sum": "level_sum.cu",
    "py_prior": "py_prior.cu",
    "gamma_draw": "gamma_draw.cu",
    "py_resample": "py_resample.cu",
}
LAUNCHES = {name: 0 for name in _SOURCES}
LAUNCHES_BY_SHAPE = {name: {"r1": 0, "rn": 0} for name in _SOURCES}
# the calls that went past a kernel's single-launch limit, by wrapper: a
# row's writes, a batch's columns or a cascade's fk columns in more than
# one launch, a chain folded by K18 first or a K18 group in more than one
# launch, a level in stages, K10's largest block, K16/K17 past three
# ancestor axes (no path of the repository's workloads makes one;
# workloads/limits.py makes each)
SPLITS: dict = {}
# K1's, K2's, K3's and K5-K23's launches by (mode, "r1" or "rn", K): K1's
# mode is "fk" or "choice", K2's is None, K3's the launch's vocabularies
# ("V1,V2,..."), K5's its route and output ("coords,BxA" or "index,BxA"),
# K6's its referrers' form and axis ("list,N" or "dense,N"), K7's
# "hoisted" or "rows", K8's SA's shape ("ExVcxV"), K9's "resample" or
# "final", K10's "class mode sign" (mode "obs", "obs noprops", "latent" or
# "latent hop"), K11's class; K is the row length the kernel was given
# (K5: the groups C; K6: the options V; K7: the histogram's V; K8: the
# referrer axis R; K9: the particles P; K10: the plan's fk nodes; K11: the
# row's births; K12: the slots; K13: the options), and K12's and K13's mode
# is "class R" (K12 the target class, K13 the proposing one; R the
# enumeration rows of the record) and each child level's own output shape
# and kinds ("shape kinds"; K12 "e=shape kinds n=shape kinds"); K14's mode is the spec's signature
# (_k14_sig: kind, sources, sides; "cascade class fks=F" in cascade mode)
# and K its target length C, K15's "class cap=C columns" and K its rows B;
# K16's "class>target form mask B=.. cap=..[ comp] d=.." (form drawn or
# retained; mask the working mask's form: shared, the class's [cap] mask
# copied into the tracer's buffer, own, per-row [B, cap] relational
# leaves copied likewise, or inplace, that buffer itself) and K the
# record's K + 1; K17's "class.vertex form dtype B=..
# d=.." (form draw, retained or pick) and K the options V (1 in pick mode);
# K18's "class.vertex dtype:length,..." (its hop columns, then its leaf)
# and K the slots; K19's "B=.. new<existing,..." and K the pairs; K20's
# "class d=depth B=.. out=shape kinds" (kinds the count of each operand
# kind, a dense, b copy-mode equality, c non-enumerable observed term, d
# gather) and K the output's size, r1 or rn by the tracer's B; K21's
# "target full=rows cap=..[ comp][ rows]" (rows: per-row leaves) and K
# the candidates; K22's gamma_draw_mode (descriptors, elements, widest
# row) and K the elements; K23's "classes=.. cap=.." (the largest) and K
# that cap
LAUNCH_CENSUS = {"enum_logsumexp": {}, "inv_cdf_sample": {},
                 "obs_gather_sum": {}, "gauss_ext_term": {},
                 "maybe_swap_ext": {}, "referrer_hist": {},
                 "sa_ext_term": {}, "pg_resample": {}, "row_delta": {},
                 "row_write": {}, "fk_score": {}, "choice_score": {},
                 "rel_scatter": {}, "batch_write": {}, "fk_sample": {},
                 "choice_sample": {}, "row_gather": {},
                 "branch_select": {}, "level_sum": {}, "py_prior": {},
                 "gamma_draw": {}, "py_resample": {}}
# the fields each K12, K13 and K16-K23 census mode was formatted from, by
# kernel and mode (K12: R, K, full, sd, the counts' dtypes and each child
# level's _level_fields; K13: R, K, full, obs's dtype, the state, the
# level's _level_fields; K16: form, mask, B, cap, comp, d; K17: form, dtype, B, d; K18:
# cols, a (dtype, length) a hop column, then the leaf's; K19: B, pairs of
# (new, existing) dtypes; K20: the first such level's program, rank,
# shape and operands' kinds, codes and references, _level_fields; K21: B,
# full, cap, comp, per_row, sd, counts; K22: each descriptor's (mode,
# rows, width, counts or not); K23: each class's cap): kernel_bench
# rebuilds a census shape's inputs from them. A mode names the same fields in every run, so reset_counts
# keeps them (a graph captured before it replays its modes after it)
CENSUS_FIELDS = {"fk_score": {}, "choice_score": {}, "fk_sample": {},
                 "choice_sample": {}, "row_gather": {},
                 "branch_select": {}, "level_sum": {}, "py_prior": {},
                 "gamma_draw": {}, "py_resample": {}}
SMEM_MAX = 232448  # shared memory one block may use on an H100 (227 KB)
N_SMS = 132        # streaming multiprocessors of an H100 SXM
_SMS: dict = {}
_GRID_Y_MAX = 65535
_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}


def _split(name: str) -> None:
    SPLITS[name] = SPLITS.get(name, 0) + 1


def reset_counts() -> None:
    SPLITS.clear()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCHES_BY_SHAPE[k] = {"r1": 0, "rn": 0}
    for census in LAUNCH_CENSUS.values():
        census.clear()


def _count(name: str, rows: int, K=None, mode=None, fields=None) -> None:
    shape = "r1" if rows == 1 else "rn"
    LAUNCHES[name] += 1
    LAUNCHES_BY_SHAPE[name][shape] += 1
    if name in LAUNCH_CENSUS:
        key = (mode, shape, K)
        LAUNCH_CENSUS[name][key] = LAUNCH_CENSUS[name].get(key, 0) + 1
    if fields is not None:
        CENSUS_FIELDS[name][mode] = fields


def snapshot() -> dict:
    """A copy of every launch count (LAUNCHES, LAUNCHES_BY_SHAPE,
    LAUNCH_CENSUS)."""
    return dict(launches=dict(LAUNCHES),
                by_shape={k: dict(v) for k, v in LAUNCHES_BY_SHAPE.items()},
                census={k: dict(v) for k, v in LAUNCH_CENSUS.items()})


def counts_since(before: dict) -> dict:
    """The launch counts added since `before` (a snapshot), as a snapshot
    of differences."""
    now = snapshot()
    return dict(
        launches={k: v - before["launches"][k]
                  for k, v in now["launches"].items()},
        by_shape={k: {s: n - before["by_shape"][k][s] for s, n in v.items()}
                  for k, v in now["by_shape"].items()},
        census={k: {key: n - before["census"][k].get(key, 0)
                    for key, n in v.items()}
                for k, v in now["census"].items()})


def add_counts(delta: dict, times: int = 1) -> None:
    """Add `times` copies of the counts `delta` (counts_since) to every
    launch count: a captured CUDA graph's step, once for each replay (or
    -1 to take back what its capture counted)."""
    for k, n in delta["launches"].items():
        LAUNCHES[k] += times * n
    for k, v in delta["by_shape"].items():
        for s, n in v.items():
            LAUNCHES_BY_SHAPE[k][s] += times * n
    for k, v in delta["census"].items():
        c = LAUNCH_CENSUS[k]
        for key, n in v.items():
            c[key] = c.get(key, 0) + times * n
            if c[key] == 0:
                del c[key]


def census() -> list:
    """LAUNCH_CENSUS as rows dict(kernel, mode, rows, K, launches, share),
    share = launches / the kernel's launches, most launched first."""
    out = []
    for name, c in LAUNCH_CENSUS.items():
        total = sum(c.values())
        out += [dict(kernel=name, mode=mode, rows=shape, K=K, launches=n,
                     share=n / total)
                for (mode, shape, K), n in c.items()]
    return sorted(out, key=lambda r: (r["kernel"], -r["launches"]))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale(name: str, out: str) -> bool:
    """True when lib<name>.so is missing or older than its sources."""
    if not os.path.exists(out):
        return True
    csrc = os.path.join(_HERE, "csrc")
    srcs = [os.path.join(csrc, _SOURCES[name])] + [
        os.path.join(csrc, f) for f in os.listdir(csrc) if f.endswith(".cuh")]
    return os.path.getmtime(out) < max(os.path.getmtime(p) for p in srcs)


def build_kernels(force: bool = False) -> float:
    """Compile every kernel whose library is missing or older than its
    sources, or every kernel with `force` (one nvcc per source, in
    parallel), and load the libraries; returns the wall seconds the build
    took; BUILD_LOG keeps each compiler's output (ptxas -v). Raises with
    the compiler's output if any build fails. Each process compiles into a file of its own
    and renames it into place, so processes sharing a checkout never load a
    half-written library."""
    with _lock:
        if all(n in _libs for n in _SOURCES) and not force:
            return 0.0
        t0 = time.time()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, src in _SOURCES.items():
            out = os.path.join(BUILD_DIR, f"lib{name}.so")
            if not force and not _stale(name, out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-I", os.path.join(_HERE, "csrc"),
                   "-o", tmp, os.path.join(_HERE, "csrc", src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (p, tmp, out) in procs.items():
            log, _ = p.communicate(timeout=900)
            BUILD_LOG[name] = log
            if p.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
        P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        F32 = ctypes.c_float
        argtypes = {
            "enum_logsumexp": [P, P, P, P, I64, I64, I32, I32, I32, I32, I64,
                               I64, P],
            "inv_cdf_sample": [P, P, P, I64, I64, I64, I32, P],
            "obs_gather_sum": [ctypes.POINTER(I64),
                               ctypes.POINTER(ctypes.c_int32), P, P, P, I64,
                               I64, I32, I32, I32, I64, I32, I64, I64, P],
            "gauss_suffstats": [P, P, P, P, P, F32, P, P, P, P, I64, I64, I32,
                                I32, I64, P],
            "gauss_ext_term": [I32, ctypes.POINTER(I64),
                               ctypes.POINTER(I64), ctypes.POINTER(I64), P,
                               I64, P, I64, I32, P, I32, P, P, P, P, I64, F32,
                               P, I32, I64, I32, P],
            "maybe_swap_ext": [P, P, P, P, P, P, P, I64, P, P, I64, P, I64,
                               P, I64, I64, I32, I64, I64, P],
            "referrer_hist": [I32, ctypes.POINTER(I64), ctypes.POINTER(I64),
                              I32, P, I64, P, P, I64, I64, I64, I32, I64, I64,
                              I64, I64, I32, P],
            "sa_ext_term": [P, I64, I64, I64, P, P, I64, P, I64, P, P, I64,
                            I32, I64, I64, I64, I32, I64, P],
            "pg_resample": [P, P, P, P, P, I64, I32, I32, I32, I32, I32, I32,
                            P],
            "row_delta": [P, I32, P, I32, P, P, P],
            "row_write": [P, I32, P],
            "fk_score": [P, I32, I32, I32, I64, I64, P],
            "choice_score": [P, I32, I32, I32, I64, I64, P],
            "rel_scatter": [P, I32, P],
            "batch_write": [P, I32, P],
            "fk_sample": [P, I32, P],
            "choice_sample": [P, I32, P],
            "row_gather": [P, I32, P],
            "branch_select": [P, I32, P],
            "level_sum": [P, I32, P],
            "py_prior": [P, I32, P],
            "gamma_draw": [P, I32, P],
            "py_resample": [P, I32, P],
        }
        for name in _SOURCES:
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
            fn = getattr(lib, f"pclean_{name}")
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes[name]
            _libs[name] = fn
            if name == "choice_sample":   # K17's group mode
                group = lib.pclean_choice_sample_group
                group.restype = ctypes.c_int
                group.argtypes = [P, I32, P]
                _libs["choice_sample_group"] = group
            if name == "batch_write":   # the parent's K15, a yardstick
                scatter = lib.pclean_batch_write_scatter
                scatter.restype = ctypes.c_int
                scatter.argtypes = [P, I32, P]
                _libs["batch_write_scatter"] = scatter
            if name == "row_delta":   # the yardsticks beside K10
                probe = lib.pclean_chase_probe
                probe.restype = ctypes.c_int
                probe.argtypes = [P, I32, P, P]
                _libs["chase_probe"] = probe
                probe = lib.pclean_param_probe
                probe.restype = ctypes.c_int
                probe.argtypes = [I32, I32, I32, P, P]
                _libs["param_probe"] = probe
        return time.time() - t0


def _fn(name):
    if name not in _libs:
        build_kernels()
    return _libs[name]


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


# the current stream's handle as an int, without building a torch Stream
# object (a few microseconds of host time a launch)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(t: torch.Tensor):
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.get_device())
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of `device`'s card, read once a card;
    N_SMS (an H100 SXM's) for a plan read off the card."""
    if device.type != "cuda":
        return N_SMS
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _SMS.get(i)
    if n is None:
        n = _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return n


def _need(t: torch.Tensor, dtype, name: str, dim: int):
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def _route(t: torch.Tensor, name: str) -> bool:
    """True: launch the kernel. False: the tensor is on the CPU, take the
    plain version. Anything else raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel for device {t.device}")


# ---------------------------------------------------------------- K1


def enum_logsumexp_plain(exist: torch.Tensor, new=None):
    """(record, logZ): record = concat([exist, new[:, None]]) when `new` is
    given (fk mode) else exist itself (choice mode); logZ = logsumexp(record)
    with pclean_tpu.utils.logsumexp's NEG_INF rules."""
    rec = exist if new is None else torch.cat([exist, new[:, None]], dim=-1)
    return rec, logsumexp(rec, dim=-1)


K1_PATHS = ("warp", "block", "split")
_K1_WARP_ROWS = 8            # rows (warps) a block on the warp path
_K1_MAX_WARPS = 16           # 512 threads a block at most
_K1_SPLIT_THREADS = 256      # threads of each block of a split cluster
_K1_MAX_CLUSTER = 8          # the portable cluster size
_K1_TILE = 128               # floats a warp loads at once (a float4 a lane)
_K1_MAX_K = 1 << 30          # row-local indices stay 32-bit in the kernel
_K1_WARP_MAX_K = 512         # longest row a warp takes alone at any R
_K1_WARP_MANY_ROWS = 1024    # rows from which a warp a row pays ...
_K1_WARP_MANY_MAX_K = 2048   # ... up to this row length
_K1_SPLIT_MAX_ROWS = 8       # most rows a launch splits over clusters ...
_K1_SPLIT_MIN_K = 8193       # ... from this row length


def enum_logsumexp_plan(R: int, K: int, mode: str, path=None) -> dict:
    """K1's launch for R rows of K logits in `mode` ("fk": a record [R, K+1]
    is written; "choice": logZ only): dict(path, threads, rows, cluster,
    grid). The entry point launches `grid` blocks of `threads` threads as
    given. `path` forces one of K1_PATHS (tests, and the path timings in
    kernel_bench); by default it follows from the shape.

    "warp": one warp a row, `rows` rows a block, grid (ceil(R / rows), 1).
    "block": one block a row, a warp for each 128-float tile up to 16,
    grid (R, 1).
    "split": a cluster of `cluster` 256-thread blocks a row, one block for
    each 8 tiles up to 8 blocks, grid (cluster, R); R <= 65,535.

    Cut-overs, from every path timed over R in (1, 8, 66, 1,024, 4,096) x
    K in (138 ... 11,264) in both modes on an H100 (PERF.md,
    `kernel_bench --paths`; device ms, fk mode):
      - split for at most 8 rows longer than 8,192: at one row of 11,264,
        0.0032 against 0.0039 for block; at 8,192 the two tie (0.0030,
        0.0031), and at 66 rows of 11,264 split loses (0.0054 against
        0.0045);
      - warp for rows of at most 512 at any R (one row of 138: 0.0021
        against 0.0024), and from 1,024 rows for rows up to 2,048 (4,096
        rows of 1,472: 0.0172 against 0.0241; of 2,048: 0.0271 against
        0.0315); at 5,125 the block path wins (0.0603 against 0.0677).
        Between 66 and 1,024 rows, and between 2,048 and 5,125 long, the
        crossings are not measured;
      - block otherwise (one row of 1,024 to 8,192: 0.0024-0.0031 against
        0.0029-0.0120 for warp; 4,096 rows of 11,264: 0.1311 against
        0.1414).
    The mode moves no cut-over: choice mode orders the paths as fk mode
    does at every measured shape but rows of 8,192 at 1 and 8 rows, where
    fk's split leads block by 0.0001-0.0003 ms and choice's block leads
    split by as much; the main path launches no row of that length."""
    return dict(_k1_plan(int(R), int(K), mode, path))


@functools.lru_cache(maxsize=256)
def _k1_plan(R: int, K: int, mode: str, path) -> dict:
    if mode not in ("fk", "choice"):
        raise ValueError(f"enum_logsumexp: mode {mode!r} is not fk or choice")
    if R < 0 or not 0 <= K <= _K1_MAX_K:
        raise ValueError(f"enum_logsumexp: R = {R}, K = {K} out of range "
                         f"(K <= {_K1_MAX_K})")
    tiles = -(-K // _K1_TILE)
    if path is None:
        if R <= _K1_SPLIT_MAX_ROWS and K >= _K1_SPLIT_MIN_K:
            path = "split"
        elif K <= _K1_WARP_MAX_K or (R >= _K1_WARP_MANY_ROWS
                                     and K <= _K1_WARP_MANY_MAX_K):
            path = "warp"
        else:
            path = "block"
    if path == "warp":
        rows = min(_K1_WARP_ROWS, max(1, R))
        return dict(path=path, threads=32 * rows, rows=rows, cluster=1,
                    grid=(-(-R // rows), 1))
    if path == "block":
        return dict(path=path, threads=32 * min(_K1_MAX_WARPS, max(1, tiles)),
                    rows=1, cluster=1, grid=(R, 1))
    if path == "split":
        if R > _GRID_Y_MAX:
            raise ValueError(f"enum_logsumexp: R = {R} rows exceed the split "
                             f"path's grid")
        cluster = min(_K1_MAX_CLUSTER,
                      max(1, -(-tiles // (_K1_SPLIT_THREADS // 32))))
        return dict(path=path, threads=_K1_SPLIT_THREADS, rows=1,
                    cluster=cluster, grid=(cluster, R))
    raise ValueError(f"enum_logsumexp: path {path!r} is not one of "
                     f"{K1_PATHS}")


def enum_logsumexp(exist: torch.Tensor, new=None, path=None):
    """K1. exist [R, K] f32, new [R] f32 or None -> (record, logZ [R]).
    `path` forces a path of enum_logsumexp_plan."""
    if not _route(exist, "enum_logsumexp"):
        return enum_logsumexp_plain(exist, new)
    exist = exist.contiguous()
    _need(exist, torch.float32, "enum_logsumexp exist", 2)
    R, K = exist.shape
    mode = "choice" if new is None else "fk"
    plan = _k1_plan(R, K, mode, path)
    logz = torch.empty((R,), dtype=torch.float32, device=exist.device)
    if new is None:
        rec = exist
    else:
        new = new.contiguous()
        _need(new, torch.float32, "enum_logsumexp new", 1)
        if new.shape[0] != R:
            raise ValueError("enum_logsumexp: new must have one entry per row")
        rec = torch.empty((R, K + 1), dtype=torch.float32,
                          device=exist.device)
    rc = _fn("enum_logsumexp")(
        _ptr(exist), _ptr(new), _ptr(None if new is None else rec),
        _ptr(logz), R, K, K1_PATHS.index(plan["path"]), plan["threads"],
        plan["rows"], plan["cluster"], *plan["grid"], _stream(exist))
    _check(rc, "enum_logsumexp")
    _count("enum_logsumexp", R, K, mode)
    return rec, logz


# ---------------------------------------------------------------- K2


def inv_cdf_sample_plain(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """pclean_tpu.engine.propose._inv_cdf_from_u: index per row with the
    threshold drawn from (0, total]."""
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    c = torch.cumsum(p, dim=-1)
    ub = (1.0 - u) * c[..., -1]
    return torch.sum(c < ub[..., None], dim=-1).to(torch.int32)


_K2_MAX_K = 1 << 21      # the fixed-point total stays below 2^53
_K2_STREAM_TILE = 16384  # floats per tile for rows that do not fit
_K2_STATIC_SMEM = 1024   # room left for the kernel's static shared memory


def inv_cdf_plan(K: int) -> dict:
    """K2's launch, one 512-thread block per row: dict(path, tile, smem). A
    row of K floats that fits in shared memory (with 4 floats to align it
    and room for the kernel's own scan buffers) is read once ("smem", tile
    = K, at least 4); a longer one streams through a 64 KB tile ("stream").
    smem is the dynamic shared memory in bytes."""
    return dict(_inv_cdf_plan(int(K)))


@functools.lru_cache(maxsize=256)
def _inv_cdf_plan(K: int) -> dict:
    if K < 1 or K > _K2_MAX_K:
        raise ValueError(f"inv_cdf_sample: K must lie in [1, {_K2_MAX_K}]")
    if (K + 4) * 4 <= SMEM_MAX - _K2_STATIC_SMEM:
        # the entry takes tiles of >= 4 floats; a row of 1-3 (the rents
        # model's 2-unit choice) is still read whole
        path, tile = "smem", max(K, 4)
    else:
        path, tile = "stream", _K2_STREAM_TILE
    return dict(path=path, tile=tile, smem=(min(tile, K) + 4) * 4)


def inv_cdf_sample(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K2. logits [R, K] f32, u [R] f32 in [0, 1) -> idx [R] int32."""
    if not _route(logits, "inv_cdf_sample"):
        return inv_cdf_sample_plain(logits, u)
    logits = logits.contiguous()
    u = u.contiguous()
    _need(logits, torch.float32, "inv_cdf_sample logits", 2)
    _need(u, torch.float32, "inv_cdf_sample u", 1)
    R, K = logits.shape
    if u.shape[0] != R:
        raise ValueError("inv_cdf_sample: one uniform per row")
    plan = _inv_cdf_plan(K)
    idx = torch.empty((R,), dtype=torch.int32, device=logits.device)
    rc = _fn("inv_cdf_sample")(_ptr(logits), _ptr(u), _ptr(idx), R, K,
                               plan["tile"], plan["smem"], _stream(logits))
    _check(rc, "inv_cdf_sample")
    _count("inv_cdf_sample", R, K)
    return idx


# K16's and K17's draw geometries (csrc/inv_cdf.cuh), in the kernels' order
DRAW_GEOMETRIES = ("warp", "block", "cluster", "stream")
DRAW_WARP_SHORT = 256      # entries a warp row takes over rows or a mask
DRAW_WARP_ROWS = 1024      # rows from which a warp row takes up to
DRAW_WARP_MAX = 2048       # this many entries
DRAW_CLUSTER_ROWS = 1      # rows a cluster launch takes at most
DRAW_CLUSTER_MIN = 11265   # entries past which such a row takes a cluster
DRAW_CLUSTER_SLICE = 1536  # entries a block of a cluster is planned for
DRAW_MAX_CLUSTER = 8       # the portable cluster size
DRAW_THREADS = 512         # a block row's threads


def draw_plan(B: int, K: int, mask: int = 0, geometry=None) -> dict:
    """K16's and K17's draw geometry for B rows of K logits (K16: also a
    mask row of `mask` bytes, read as mask / 4 entries' worth of 16-byte
    words): dict(geometry, threads, rows, blocks, cluster, tile, smem).
    With n = max(K, ceil(mask / 4)):
      warp:    n <= DRAW_WARP_SHORT where B > 1 or there is a mask (K16),
               or B >= DRAW_WARP_ROWS and n <= DRAW_WARP_MAX: a warp a
               row, min(16, ceil(B / 264)) rows a block (two blocks an SM
               before a block takes more);
      cluster: B <= DRAW_CLUSTER_ROWS and n > DRAW_CLUSTER_MIN: a cluster
               of min(8, max(2, ceil(n / DRAW_CLUSTER_SLICE))) blocks of
               512 over each row, each block a slice of K / cluster
               logits (a multiple of 4) in shared memory;
      block:   a block of 512 a row, the row in shared memory (K2's
               inv_cdf_plan "smem");
      stream:  K2's streamed tiles, for rows past shared memory.
    The thresholds are kernel_bench's geometry sweep (`--kernels k16,k17
    --geometries`: every geometry at the census shapes and between them)
    on an NVIDIA H100 80GB HBM3 at 700.00 W (device ms a call): at one
    row a block beats a warp for K17 (0.0024-0.0026 against 0.0026-0.0029
    at 14-241 entries) and a warp beats a block for K16 up to 256 (0.0034
    and 0.0037 against 0.0037 and 0.0038 at 65 and 161: its mask pass
    needs no barrier); past 256 a block wins at one row (K17 0.0024
    against 0.0030 at 384, K16 0.0041 against 0.0084 at 1,473); over 16
    and 256 rows the two tie up to 256 (0.0027 and 0.0029 against 0.0028
    and 0.0030) and a block wins past it (0.0032 against 0.0037 at 512);
    over 4,096 rows a warp wins up to 2,048 (K17
    0.0049 against 0.0306 at 138, 0.0197 against 0.0406 at 1,914) and a
    block past it (0.0589 against 0.0662 at 4,096); a cluster beats a
    block only past 11,265 at one row (K16 0.0083 against 0.0077 at
    11,265, K17 0.0057 against 0.0066 at 16,384) and the stream past
    shared memory (0.0066 against 0.0235 at 70,001), and loses wherever
    several rows fill the card. `geometry` forces one (a cluster or a
    stream only where the row takes it: a stream needs K > 4, its tile
    the largest multiple of 4 below K up to K2's 16,384). smem: the
    dynamic shared memory in bytes (0 for a warp row or K16's retained
    form, whose plan the caller takes with K = 0)."""
    return dict(_draw_plan(int(B), int(K), int(mask), geometry))


@functools.lru_cache(maxsize=1024)
def _draw_plan(B: int, K: int, mask: int, geometry) -> dict:
    if K < 0 or K > _K2_MAX_K or B < 0:
        raise ValueError(f"draw_plan: K must lie in [0, {_K2_MAX_K}]")
    n = max(K, -(-mask // 4))
    fits = (K + 4) * 4 <= SMEM_MAX - _K2_STATIC_SMEM
    cluster = min(DRAW_MAX_CLUSTER, max(2, -(-n // DRAW_CLUSTER_SLICE)))
    g = geometry
    if g is None:
        if (n <= DRAW_WARP_SHORT and (B > 1 or mask > 0)) or \
                (B >= DRAW_WARP_ROWS and n <= DRAW_WARP_MAX):
            g = "warp"
        elif B <= DRAW_CLUSTER_ROWS and n > DRAW_CLUSTER_MIN and \
                (cluster_slice(K, cluster) + 4) * 4 <= SMEM_MAX - \
                _K2_STATIC_SMEM:
            g = "cluster"
        else:
            g = "block" if fits or K == 0 else "stream"
    if g not in DRAW_GEOMETRIES:
        raise ValueError(f"draw_plan: geometry {g!r} is not one of "
                         f"{DRAW_GEOMETRIES}")
    tile, smem = max(K, 4), 0
    if g == "block" and K:
        if not fits:
            raise ValueError(f"draw_plan: {K} logits do not fit one block")
        smem = (K + 4) * 4
    elif g == "stream":
        tile = min(_K2_STREAM_TILE, (K - 1) // 4 * 4)
        if tile < 4:
            raise ValueError(f"draw_plan: {K} logits are too few to stream")
        smem = (tile + 4) * 4
    elif g == "cluster" and K:
        smem = (cluster_slice(K, cluster) + 4) * 4
    rows = min(16, max(1, -(-B // (2 * N_SMS)))) if g == "warp" else 1
    threads = 32 * rows if g == "warp" else DRAW_THREADS
    blocks = -(-B // rows) if g == "warp" else \
        B * cluster if g == "cluster" else B
    return dict(geometry=g, threads=threads, rows=rows, blocks=blocks,
                cluster=cluster if g == "cluster" else 1, tile=tile,
                smem=smem)


def cluster_slice(K: int, C: int) -> int:
    """The logits a block of a C-block cluster row holds (inv_cdf.cuh's
    cluster_slice): ceil(K / C) rounded up to a multiple of 4."""
    return (-(-K // C) + 3) // 4 * 4


# ---------------------------------------------------------------- K3

_MAX_COLS = 8
_K3_STAGED_THREADS = 512
_K3_DIRECT_ROWS = 4
_K3_DIRECT_THREADS = 256  # candidates a direct block owns


def obs_gather_plan(B: int, K: int, Vs) -> dict:
    """K3's launch for B rows, K candidates and one group of <= 8 columns
    of vocabulary sizes Vs: dict(path, kt, smem, grid). A block owns kt
    candidates; smem is its dynamic shared memory in bytes; the entry point
    launches `grid` as given.

    "staged": one row a block, grid = (B, candidate tiles). The block
    copies its row's observed M rows (sum(Vs) floats) into shared memory.
    Staging is taken only where it pays:
      - the staged row fits at all;
      - it costs no more than the direct path's gathers for that row, one
        32-byte sector per candidate and column (32 * K * C bytes);
      - there are rows enough for half of the SMs: with fewer, as in the
        sequential loops' one-row calls, the direct path spreads the
        gathers over more blocks and has the shorter dependent chain. On
        an H100 at the scaled workload's V, 66 staged rows took 0.0056 ms
        against 0.0124 ms for the direct design (PERF.md); below 66 rows
        the crossing is not measured.
    Where the rows alone do not fill the SMs twice over, the candidate axis
    is cut into tiles of at least one pass of the block (2,048
    candidates), each block staging its row again.
    "direct": gathers straight from device memory, 4 rows and 256
    candidates a block, no shared memory, grid = (candidate tiles, row
    groups)."""
    return dict(_obs_gather_plan(int(B), int(K), tuple(int(v) for v in Vs)))


@functools.lru_cache(maxsize=256)
def _obs_gather_plan(B: int, K: int, Vs: tuple) -> dict:
    C = len(Vs)
    if not 1 <= C <= _MAX_COLS:
        raise ValueError(f"obs_gather_sum: 1 to {_MAX_COLS} columns a launch")
    row_bytes = 4 * sum(Vs)
    if (row_bytes <= SMEM_MAX and row_bytes <= 32 * K * C
            and B >= N_SMS // 2):
        tiles = max(1, min(-(-2 * N_SMS // B),
                           -(-K // (4 * _K3_STAGED_THREADS))))
        kt = -(-K // tiles)
        kt = -(-kt // 4) * 4
        return dict(path="staged", kt=kt, smem=row_bytes,
                    grid=(B, -(-K // kt)))
    groups = -(-B // _K3_DIRECT_ROWS)
    if groups > _GRID_Y_MAX:
        raise ValueError(f"obs_gather_sum: B = {B} rows exceed the direct "
                         f"path's grid")
    return dict(path="direct", kt=_K3_DIRECT_THREADS, smem=0,
                grid=(-(-K // _K3_DIRECT_THREADS), groups))


def obs_gather_sum_plain(mats, obs: torch.Tensor,
                         word: torch.Tensor) -> torch.Tensor:
    """sum_c mats[c][obs[:, c], word[c]] -> [B, K], columns summed in order
    from 0 (the kernel's order). Codes clamp like the JAX gathers."""
    out = torch.zeros((obs.shape[0], word.shape[1]), dtype=torch.float32,
                      device=obs.device)
    for c, M in enumerate(mats):
        V = M.shape[0]
        o = obs[:, c].long().clamp(0, V - 1)
        w = word[c].long().clamp(0, V - 1)
        out = out + M[o[:, None], w[None, :]]
    return out


def obs_gather_sum(mats, obs: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """K3. mats: C square f32 matrices [V_c, V_c]; obs [B, C] int32;
    word [C, K] int32 -> [B, K] f32. More than 8 columns launch once per
    group of 8, each later group adding into the output in column order."""
    if not _route(obs, "obs_gather_sum"):
        return obs_gather_sum_plain(mats, obs, word)
    obs = obs.to(torch.int32).contiguous()
    word = word.to(torch.int32).contiguous()
    _need(obs, torch.int32, "obs_gather_sum obs", 2)
    _need(word, torch.int32, "obs_gather_sum word", 2)
    for m in mats:
        if not (m.is_cuda and m.dtype == torch.float32 and m.dim() == 2
                and m.shape[0] == m.shape[1] and m.is_contiguous()):
            raise ValueError("obs_gather_sum: matrices must be contiguous "
                             "square f32 CUDA tensors")
    B, C = obs.shape
    K = word.shape[1]
    if C != len(mats) or word.shape[0] != C:
        raise ValueError("obs_gather_sum: one obs column and one word row "
                         "per matrix")
    out = torch.empty((B, K), dtype=torch.float32, device=obs.device)
    for c0 in range(0, C, _MAX_COLS):
        cs = slice(c0, min(C, c0 + _MAX_COLS))
        part_mats = mats[cs]
        n = len(part_mats)
        Vs = tuple(m.shape[0] for m in part_mats)
        plan = _obs_gather_plan(B, K, Vs)
        ptrs = (ctypes.c_int64 * n)(*[m.data_ptr() for m in part_mats])
        sizes = (ctypes.c_int32 * n)(*Vs)
        o = obs[:, cs].contiguous()
        w = word[cs].contiguous()
        rc = _fn("obs_gather_sum")(
            ptrs, sizes, _ptr(o), _ptr(w), _ptr(out), B, K, n, int(c0 > 0),
            0 if plan["path"] == "direct" else 1, plan["kt"], plan["smem"],
            *plan["grid"], _stream(obs))
        _check(rc, "obs_gather_sum")
        _count("obs_gather_sum", B, K, ",".join(map(str, Vs)))
    return out


# ---------------------------------------------------------------- K4

_K4_THREADS = 256


def gauss_suffstats_plan(R: int) -> dict:
    """K4's launch over R referrers: one thread a referrer, dict(threads,
    grid)."""
    return dict(threads=_K4_THREADS, grid=max(1, -(-int(R) // _K4_THREADS)))


def gauss_suffstats_plain(t, rv, w, z, ld, const: float, cap: int, C: int):
    """(n, sz, szz [cap, C], pre0 [cap]) f32: the scatters of
    pclean_tpu.engine.propose.referrer_histograms' gauss_stats, in referrer
    order. A referrer counts where w is set; (t, rv) out of range drops it
    from n/sz/szz, t out of range from pre0 too (mode="drop")."""
    ok = w & (t >= 0) & (t < cap)
    ok2 = ok & (rv >= 0) & (rv < C)
    cell = (t.long() * C + rv.long())[ok2]
    zz = z[ok2]
    stats = torch.zeros((3, cap * C), dtype=torch.float32, device=z.device)
    stats[0].index_add_(0, cell, torch.ones_like(zz))
    stats[1].index_add_(0, cell, zz)
    stats[2].index_add_(0, cell, zz * zz)
    pre0 = torch.zeros((cap,), dtype=torch.float32, device=z.device)
    pre0.index_add_(0, t.long()[ok], (const - ld)[ok].to(torch.float32))
    n, sz, szz = (x.reshape(cap, C) for x in stats)
    return n, sz, szz, pre0


def gauss_suffstats(t, rv, w, z, ld, const: float, cap: int, C: int):
    """K4. t, rv [R] int32, w [R] bool, z, ld [R] f32, the scalar const ->
    (n, sz, szz [cap, C], pre0 [cap]) f32, as gauss_suffstats_plain."""
    if not _route(z, "gauss_suffstats"):
        return gauss_suffstats_plain(t, rv, w, z, ld, const, cap, C)
    t, rv = t.to(torch.int32).contiguous(), rv.to(torch.int32).contiguous()
    w = w.to(torch.bool).contiguous()
    z, ld = z.contiguous(), ld.contiguous()
    for x, dt, nm in ((t, torch.int32, "t"), (rv, torch.int32, "rv"),
                      (w, torch.bool, "w"), (z, torch.float32, "z"),
                      (ld, torch.float32, "ld")):
        _need(x, dt, f"gauss_suffstats {nm}", 1)
        if x.shape != z.shape or not x.is_cuda:
            raise ValueError("gauss_suffstats: t, rv, w, z and ld must be "
                             "CUDA vectors of one length")
    R = z.shape[0]
    plan = gauss_suffstats_plan(R)
    buf = torch.zeros((3 * cap * C + cap,), dtype=torch.float32,
                      device=z.device)
    n, sz, szz = (buf[i * cap * C:(i + 1) * cap * C].view(cap, C)
                  for i in range(3))
    pre0 = buf[3 * cap * C:]
    rc = _fn("gauss_suffstats")(
        _ptr(t), _ptr(rv), _ptr(w), _ptr(z), _ptr(ld), float(const),
        _ptr(n), _ptr(sz), _ptr(szz), _ptr(pre0), R, cap, C,
        plan["threads"], plan["grid"], _stream(z))
    _check(rc, "gauss_suffstats")
    _count("gauss_suffstats", R)
    return n, sz, szz, pre0


# ---------------------------------------------------------------- K5

K5_MAX_AXES = 4   # env coordinates the kernel folds
K5_MAX_RANK = 4   # the output's axes it takes: B and up to 3 option axes
_K5_FIXED_C = 8   # C a template parameter up to here, else a generic loop
# warps a block (ceil(A / 32) warps a row): 1 to 8 time alike at the rents
# batch [256, 51] and 2 to 8 at [4,096, 51] (1 is slower there), C = 5, on
# an H100 (PERF.md §6, scripts/k5_probe.py); 2 give the rents batch 256
# blocks for the 132 SMs
_K5_WARPS = 2
K5_ROUTES = ("coords", "index")


def gauss_ext_term_plan(B: int, A: int, C: int) -> dict:
    """K5's launch over B rows of A options and C groups: a warp for each
    row and 32 of its options (`chunks` = ceil(A / 32) warps a row),
    _K5_WARPS warps a block (fewer when the launch has fewer), the kernel
    instantiated for C up to 8 (`fixed_c` = C: table words and values
    loaded flat over the warp's options and staged in shared memory) or
    the generic loop (`fixed_c` = 0: each lane its own option's groups):
    dict(threads, chunks, grid, fixed_c)."""
    B, A, C = int(B), int(A), int(C)
    if B < 0 or A < 1 or C < 1:
        raise ValueError(f"gauss_ext_term: B = {B}, A = {A}, C = {C} out "
                         f"of range")
    chunks = -(-A // 32)
    warps = B * chunks
    if warps > 2 ** 31 - 1:   # the kernel counts warps in 32 bits
        raise ValueError(f"gauss_ext_term: [{B}, {A}] exceeds the grid")
    per = max(1, min(_K5_WARPS, warps))
    return dict(threads=32 * per, chunks=chunks,
                grid=max(1, -(-warps // per)),
                fixed_c=C if C <= _K5_FIXED_C else 0)


def gauss_key_rows(coords, env_shape, full, device=None):
    """[full] int64: each output's row of the key table, sum over axes i of
    clamp(coords[i], 0, env_shape[i] - 1) * (row-major stride of axis i),
    each coordinate broadcast to `full`; zeros where there is no axis."""
    dev = coords[0].device if coords else device
    rows = torch.zeros(tuple(full), dtype=torch.long, device=dev)
    stride = 1
    for e, n in reversed(list(zip(coords, env_shape))):
        rows = rows + e.long().clamp(0, n - 1) * stride
        stride *= int(n)
    return rows


def gauss_ext_term_inputs(coords, env_shape, full, device=None) -> dict:
    """The coordinate arguments of gauss_ext_term for the block shape
    `full` = (B,) + option axes: the coordinates as given (route "coords")
    where the kernel takes them (at most K5_MAX_AXES axes, an output of
    rank at most K5_MAX_RANK), else the key-table row of each output
    folded here (gauss_key_rows) as one coordinate [B, A] over the table's
    E rows (route "index"); the caller reshapes the result to `full`."""
    coords, env_shape, full = tuple(coords), tuple(env_shape), tuple(full)
    if len(coords) <= K5_MAX_AXES and len(full) <= K5_MAX_RANK:
        return dict(coords=coords, env_shape=env_shape, full=full,
                    route="coords")
    rows = gauss_key_rows(coords, env_shape, full, device)
    return dict(coords=(rows.reshape(full[0], -1),),
                env_shape=(math.prod(env_shape),),
                full=(full[0], rows[0].numel()), route="index")


def gauss_ext_term_parts(values, tbl, coords, env_shape, slot, n, sz, szz,
                         full=None):
    """The three sums of the closed form, each of the output's shape
    (`full`, default the coordinates' broadcast with (B,)): sum_c
    szz[s_b, c], sum_c mu sz[s_b, c] and sum_c mu^2 n[s_b, c] with mu =
    values[tbl[row, c]], row the key-table row of the coordinates
    (gauss_key_rows; every gather clamped)."""
    full = _k5_full(coords, slot, full)
    s = slot.long().clamp(0, n.shape[0] - 1)
    rows = gauss_key_rows(coords, env_shape, full, tbl.device)
    t = tbl[rows.clamp(0, tbl.shape[0] - 1)]                     # [*, C]
    mu = values[t.long().clamp(0, values.shape[0] - 1)]
    lead = (len(s),) + (1,) * (len(full) - 1)
    a_szz = szz[s].sum(-1).reshape(lead).expand(full)
    a_sz = (mu * sz[s].reshape(lead + (-1,))).sum(-1)
    a_n = (mu * mu * n[s].reshape(lead + (-1,))).sum(-1)
    return a_szz, a_sz, a_n


def gauss_ext_term_plain(values, tbl, coords, env_shape, slot, n, sz, szz,
                         pre0, coef: float, full=None, route="coords"):
    """coef * (sum szz - 2 sum mu sz + sum mu^2 n) + pre0[slot], the
    formula of pclean_tpu.engine.propose._ext_gauss_term, over the output
    shape (`full`, default the coordinates' broadcast with (B,)). `route`
    only labels the kernel's census and is ignored here."""
    full = _k5_full(coords, slot, full)
    a_szz, a_sz, a_n = gauss_ext_term_parts(values, tbl, coords, env_shape,
                                            slot, n, sz, szz, full)
    s = slot.long().clamp(0, n.shape[0] - 1)
    lead = (len(s),) + (1,) * (len(full) - 1)
    return coef * (a_szz - 2.0 * a_sz + a_n) + pre0[s].reshape(lead)


def _k5_full(coords, slot, full):
    if full is not None:
        return tuple(full)
    rank = max([1] + [c.dim() for c in coords])
    return tuple(torch.broadcast_shapes(
        *[c.shape for c in coords], (slot.shape[0],) + (1,) * (rank - 1)))


def gauss_ext_term(values, tbl, coords, env_shape, slot, n, sz, szz, pre0,
                   coef: float, full=None, route: str = "coords"):
    """K5, as gauss_ext_term_plain: values [I] f32, tbl [E, C] int32 (E =
    the product of env_shape), coords a tuple of up to K5_MAX_AXES int32
    or int64 tensors, each broadcastable to the output shape `full` (B,) +
    up to 3 option axes (default the coordinates' broadcast with (B,)),
    coordinate i on the table's axis of env_shape[i]; slot [B] int32 or
    int64; n, sz, szz [cap, C] f32, pre0 [cap] f32, coef = -1/(2 std^2) ->
    [full] f32. The coordinates are read through their own strides, never
    copied. `route` names the caller's route in the launch census:
    "coords", or "index" where the caller folded the coordinates itself
    into one over (E,) (gauss_ext_term_inputs)."""
    if not _route(slot, "gauss_ext_term"):
        return gauss_ext_term_plain(values, tbl, coords, env_shape, slot, n,
                                    sz, szz, pre0, coef, full=full)
    coords, env_shape = tuple(coords), tuple(int(x) for x in env_shape)
    values, tbl, slot = values.contiguous(), tbl.contiguous(), \
        slot.contiguous()
    n, sz, szz, pre0 = (x.contiguous() for x in (n, sz, szz, pre0))
    _need(values, torch.float32, "gauss_ext_term values", 1)
    _need(tbl, torch.int32, "gauss_ext_term tbl", 2)
    if slot.dtype not in (torch.int32, torch.int64) or slot.dim() != 1:
        raise ValueError("gauss_ext_term: slot must be an int32 or int64 "
                         "vector")
    for x, nm in ((n, "n"), (sz, "sz"), (szz, "szz")):
        _need(x, torch.float32, f"gauss_ext_term {nm}", 2)
    _need(pre0, torch.float32, "gauss_ext_term pre0", 1)
    full = _k5_full(coords, slot, full)
    B = slot.shape[0]
    (E, C), cap = tbl.shape, n.shape[0]
    if route not in K5_ROUTES or (route == "index" and len(coords) != 1):
        raise ValueError(f"gauss_ext_term: route {route!r} is not coords, "
                         f"or index with one coordinate")
    if len(coords) != len(env_shape) or len(coords) > K5_MAX_AXES \
            or not 1 <= len(full) <= K5_MAX_RANK:
        raise ValueError(f"gauss_ext_term: {len(coords)} coordinates over "
                         f"{len(env_shape)} axes and an output of rank "
                         f"{len(full)}: the kernel takes up to "
                         f"{K5_MAX_AXES} axes and rank {K5_MAX_RANK} (fold "
                         f"the rest with gauss_ext_term_inputs)")
    if not (full[0] == B and math.prod(env_shape) == E
            and min(env_shape, default=1) >= 1
            and sz.shape == n.shape == szz.shape == (cap, C)
            and pre0.shape[0] == cap):
        raise ValueError("gauss_ext_term: shapes do not agree")
    views = []
    for e in coords:
        if e.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"gauss_ext_term: coordinates must be int32 or "
                             f"int64, got {e.dtype}")
        try:
            views.append(e.expand(full))
        except RuntimeError as err:
            raise ValueError(f"gauss_ext_term: a coordinate of shape "
                             f"{tuple(e.shape)} does not broadcast to "
                             f"{full}") from err
    if not all(x.is_cuda for x in (values, tbl, n, sz, szz, pre0) + coords):
        raise ValueError("gauss_ext_term: every input must be on the card")
    out = torch.empty(full, dtype=torch.float32, device=slot.device)
    if out.numel() == 0:
        return out
    A = out.numel() // B
    plan = gauss_ext_term_plan(B, A, C)
    pad = K5_MAX_RANK - len(full)
    dims = (ctypes.c_int64 * K5_MAX_RANK)(full[0], *([1] * pad), *full[1:])
    k = len(views)
    ptrs = (ctypes.c_int64 * max(1, k))(*[v.data_ptr() for v in views])
    meta, row = [], 1
    for v, ni in reversed(list(zip(views, env_shape))):
        st = v.stride()
        meta = [int(v.dtype == torch.int64), ni, row, st[0], *([0] * pad),
                *st[1:]] + meta
        row *= ni
    meta = (ctypes.c_int64 * max(1, len(meta)))(*meta)
    rc = _fn("gauss_ext_term")(
        k, ptrs, meta, dims, _ptr(values), values.shape[0], _ptr(tbl), E, C,
        _ptr(slot), int(slot.dtype == torch.int64), _ptr(n), _ptr(sz),
        _ptr(szz), _ptr(pre0), cap, float(coef), _ptr(out), plan["threads"],
        plan["grid"], plan["fixed_c"], _stream(slot))
    _check(rc, "gauss_ext_term")
    _count("gauss_ext_term", B, C, f"{route},{B}x{A}")
    return out


# ---------------------------------------------------------------- K6

_K6_THREADS = 512
_K6_OPTIONS = _K6_THREADS * 8  # options a dense-form block owns (8 a thread)
_K6_WARP_OPTIONS = 32 * 2      # options a warp owns in list form (2 a lane)
_K6_WARP_MAX_WARPS = 8


def maybe_swap_ext_plan(B: int, V: int, dense: bool = False) -> dict:
    """K6's launch for B rows of V options, the referrers in list form
    (each row's own list) or with `dense` the source axis every row walks
    whole: dict(route, threads, grid=(B, option groups)). The route goes
    by the form alone (the sweep behind it is in PERF.md §6):

    "warp" (lists): a warp a row and 64 options (2 a lane), min(8,
    ceil(V / 64)) warps a block; each warp stops at its row's count.
    "block" (dense): one 512-thread block a row and group of up to 4,096
    options, walking the whole axis with a block scan."""
    B, V = int(B), int(V)
    if B < 0 or V < 1:
        raise ValueError(f"maybe_swap_ext: B = {B}, V = {V} out of range")
    if dense:
        route, threads, per = "block", _K6_THREADS, _K6_OPTIONS
    else:
        warps = min(_K6_WARP_MAX_WARPS, -(-V // _K6_WARP_OPTIONS))
        route, threads, per = "warp", 32 * warps, _K6_WARP_OPTIONS * warps
    groups = -(-V // per)
    if groups > _GRID_Y_MAX:
        raise ValueError(f"maybe_swap_ext: V = {V} options exceed the grid")
    return dict(route=route, threads=threads, grid=(B, groups))


def maybe_swap_ext_plain(obs, st, p, lc, lens, member, t=None, alive=None,
                         slot=None, cnt=None, absolute: bool = False):
    """[B, V] f32: for each row b, the dense per-referrer MaybeSwap terms
    of pclean_tpu.engine.propose._ext_terms (obs == option ? log1p(-p) :
    log p - log lens[lc_b] where st is 1, member[lc_b, option] ? 0 : -1000
    where st is 2, else 0) over row b's referrers, summed. Dense form: obs,
    st [N] and p [1 or B, N] over the whole source axis, row b's referrers
    those alive with t == slot_b. List form (`cnt` given): obs, st [B, N]
    and p [1 or B, N] per row, row b's referrers its first min(cnt_b, N)
    entries. Indices clamp like the JAX gathers. `absolute` sums |terms|
    instead: the scale of the kernel's tolerance."""
    B, V = lc.shape[0], member.shape[1]
    lcc = lc.long().clamp(0, member.shape[0] - 1)
    loglen = torch.log(lens[lcc].to(torch.float32))
    a = torch.arange(V, device=obs.device)[:, None]
    zero = torch.zeros((), device=obs.device)
    out = torch.zeros((B, V), dtype=torch.float32, device=obs.device)
    for b in range(B):
        prow = p[0 if p.shape[0] == 1 else b]
        if cnt is None:
            r = torch.nonzero(alive & (t == slot[b]))[:, 0]
            o, sr, pr = obs[r], st[r], prow[r]
        else:
            n = int(cnt[b].clamp(0, obs.shape[1]))
            o, sr, pr = obs[b, :n], st[b, :n], prow[:n]
        pr = pr[None, :]
        obs_t = torch.where(o[None, :].long() == a, torch.log1p(-pr),
                            torch.log(pr) - loglen[b])
        miss_t = torch.where(member[lcc[b]], zero,
                             torch.full((), -1000.0, device=obs.device))
        sr = sr[None, :]
        term = torch.where(sr == 1, obs_t,
                           torch.where(sr == 2, miss_t[:, None], zero))
        out[b] = (term.abs() if absolute else term).sum(-1)
    return out


def maybe_swap_ext(obs, st, p, lc, lens, member, t=None, alive=None,
                   slot=None, cnt=None):
    """K6, as maybe_swap_ext_plain. Dense form: t, obs [N] int32, alive [N]
    bool, st [N] int8, slot [B] int32. List form: cnt [B] int32, obs
    [B, N] int32, st [B, N] int8. Both: p [1 or B, N] f32, lc [B] int32,
    lens [L] int32, member [L, V] bool -> [B, V] f32."""
    if not _route(obs, "maybe_swap_ext"):
        return maybe_swap_ext_plain(obs, st, p, lc, lens, member, t=t,
                                    alive=alive, slot=slot, cnt=cnt)
    dense = cnt is None
    args = dict(obs=(obs, torch.int32, 1 if dense else 2),
                st=(st, torch.int8, 1 if dense else 2),
                p=(p, torch.float32, 2), lc=(lc, torch.int32, 1),
                lens=(lens, torch.int32, 1), member=(member, torch.bool, 2))
    if dense:
        args.update(t=(t, torch.int32, 1), alive=(alive, torch.bool, 1),
                    slot=(slot, torch.int32, 1))
    else:
        args.update(cnt=(cnt, torch.int32, 1))
    for nm, (x, dt, dim) in args.items():
        _need(x, dt, f"maybe_swap_ext {nm}", dim)
        if not x.is_cuda:
            raise ValueError("maybe_swap_ext: every input must be on the card")
    B, N = lc.shape[0], obs.shape[-1]
    L, V = member.shape
    ok = (st.shape == obs.shape and p.shape[1] == N and p.shape[0] in (1, B)
          and lens.shape[0] == L)
    ok = ok and (t.shape[0] == alive.shape[0] == N and slot.shape[0] == B
                 if dense else obs.shape[0] == cnt.shape[0] == B)
    if not ok:
        raise ValueError("maybe_swap_ext: shapes do not agree")
    plan = maybe_swap_ext_plan(B, V, dense)
    out = torch.empty((B, V), dtype=torch.float32, device=obs.device)
    rc = _fn("maybe_swap_ext")(
        _ptr(t), _ptr(alive), _ptr(slot), _ptr(cnt), _ptr(obs), _ptr(st),
        _ptr(p), p.shape[0], _ptr(lc), _ptr(lens), L, _ptr(member), V,
        _ptr(out), B, N, plan["threads"], *plan["grid"], _stream(obs))
    _check(rc, "maybe_swap_ext")
    _count("maybe_swap_ext", B, V, f"{'dense' if dense else 'list'},{N}")
    return out


# ---------------------------------------------------------------- K7

_K7_THREADS = 256
# the private route's tile cap (48 KB of shared memory) and fewest
# referrers a chunk, the sparse route's referrers a chunk, and the counts a
# cell from which the private route is taken: geometries timed on seeded
# inputs, the route threshold from chip_smoke.py's census of the hospital
# path (PERF.md)
_K7_TILE = 12288
_K7_PRIVATE_PER = 1024
_K7_SPARSE_PER = 1024
_K7_LOAD_MIN = 2.0
_K7_MAX_HOPS = 8
K7_ROUTES = ("sparse", "private")  # the C entry's route numbers


def referrer_hist_plan(R: int, G: int, V: int, per_row: bool) -> dict:
    """K7's launch over R referrers into G rows of V cells: dict(route,
    threads, tile, chunks, per, tiles, grid, smem, load).

    The route follows `load`, the most counts that can land in each cell a
    private block zeroes and flushes: hoisted, all R referrers over the cap
    * V cells; per row, a block's chunk of `per` referrers, or a row's
    share R / B of the dense source axis if fewer, over the row's V cells.
    "private" where load >= _K7_LOAD_MIN (2; the hospital path's
    histograms, whose referrers crowd into the few cells of its live
    slots): each block counts a tile of up to _K7_TILE cells (12,288, 48
    KB of dynamic shared memory) over a chunk of referrers and adds its
    nonzero counters into the zeroed output; chunks split the referrer axis
    only as far as needed to give the card two blocks an SM, at least
    _K7_PRIVATE_PER referrers a chunk. "sparse" below (scaled's and rents'
    hoisted histograms, one row of a wide V): no tile (tile 0, tiles 1,
    smem 0), one global atomic a kept referrer into the zeroed output,
    chunks of _K7_SPARSE_PER referrers, per row only as many as give the
    card two blocks an SM.
    Hoisted: grid (chunks, tiles); per row: grid (G, chunks, tiles).

    `load` assumes the counts spread over every cell. The threshold of 2
    is fitted to the hospital synth's census, whose referrers crowd into
    its few live slots, so that R / cells tracks the crowding there; a
    deployment with another share of live slots crowds differently at the
    same load and may be given the slower route (PERF.md §7)."""
    R, G, V = int(R), int(G), int(V)
    if R < 0 or G < 0 or V < 1:
        raise ValueError(f"referrer_hist: R = {R}, G = {G}, V = {V} out of "
                         f"range")
    cells = V if per_row else G * V
    rows = G if per_row else 1
    tile = max(1, min(_K7_TILE, cells))
    tiles = -(-cells // tile)
    want = -(-2 * N_SMS // max(1, tiles * rows))
    chunks = max(1, min(want, -(-R // _K7_PRIVATE_PER)))
    per = -(-R // chunks)
    load = min(per, -(-R // max(1, G))) / V if per_row else R / cells
    route = "private" if load >= _K7_LOAD_MIN else "sparse"
    if route == "sparse":
        tile, tiles = 0, 1
        chunks = max(1, -(-R // _K7_SPARSE_PER))
        if per_row:
            chunks = min(chunks, -(-2 * N_SMS // max(1, G)))
        per = -(-R // chunks)
    chunks = max(1, -(-R // max(1, per)))
    if tiles > _GRID_Y_MAX or (per_row and chunks > _GRID_Y_MAX):
        raise ValueError(f"referrer_hist: {cells} cells or {R} referrers "
                         f"exceed the grid")
    grid = (G, chunks, tiles) if per_row else (chunks, tiles)
    return dict(route=route, threads=_K7_THREADS, tile=tile, chunks=chunks,
                per=per, tiles=tiles, grid=grid, smem=tile * 4, load=load)


def referrer_hist_cells(val, w, V: int, cap: int = None, hops=None):
    """(cell, ok, G): each counted pair's flat cell g * V + v of the [G, V]
    histogram (0 where dropped) and whether it counts. Hoisted (hops
    given): one pair per source row r, g = chase(hops)[r], kept where
    w[r]; per row: one pair per set w[b, r], g = b, v = val[b or 0, r]
    (torch.nonzero of w, so no [B, R] index tensor). Pairs out of range
    drop (mode="drop")."""
    if hops is not None:
        g, G, v, ok = chase(hops).long(), cap, val.long(), w
    else:
        G = w.shape[0]
        g, r = torch.nonzero(w, as_tuple=True)
        v = (val[0, r] if val.shape[0] == 1 else val[g, r]).long()
        ok = torch.ones_like(g, dtype=torch.bool)
    ok = ok & (g >= 0) & (g < G) & (v >= 0) & (v < V)
    return torch.where(ok, g * V + v, torch.zeros_like(v)), ok, G


def referrer_hist_plain(val, w, V: int, cap: int = None, hops=None):
    """[cap or B, V] f32 counts: the hoisted form (hops given) counts each
    referrer r with w[r] at (chase(hops)[r], val[r]) into [cap, V]; the
    per-row form counts row b's referrers r with w[b, r] at val[b or 0, r]
    into [B, V]. Pairs out of range drop (mode="drop"): they add weight 0
    in one index_put_, with no host synchronisation on their count."""
    cell, ok, G = referrer_hist_cells(val, w, V, cap=cap, hops=hops)
    out = torch.zeros((G * V,), dtype=torch.float32, device=w.device)
    out.index_put_((cell,), ok.to(torch.float32), accumulate=True)
    return out.reshape(G, V)


def referrer_hist(val, w, V: int, cap: int = None, hops=None):
    """K7, as referrer_hist_plain. Hoisted (hops: the chain's fk columns,
    the first [N], then each target class's column; a chain of more than
    _K7_MAX_HOPS columns first folded by K18, fold_chain, into a column
    [N] the call owns): val [N] int32, w [N] bool -> [cap, V]. Per row
    (hops None): w [B, R] bool, val [1 or B, R] int32 -> [B, V]."""
    if not _route(w, "referrer_hist"):
        return referrer_hist_plain(val, w, V, cap=cap, hops=hops)
    per_row = hops is None
    val = val.to(torch.int32).contiguous()
    w = w.to(torch.bool).contiguous()
    if per_row:
        _need(w, torch.bool, "referrer_hist w", 2)
        _need(val, torch.int32, "referrer_hist val", 2)
        (G, R), rows = w.shape, val.shape[0]
        if val.shape[1] != R or rows not in (1, G):
            raise ValueError("referrer_hist: val must be [1 or B, R] beside "
                             "w [B, R]")
        hop_t = []
    else:
        _need(w, torch.bool, "referrer_hist w", 1)
        _need(val, torch.int32, "referrer_hist val", 1)
        G, R, rows = int(cap), w.shape[0], 1
        hop_t = [h.to(torch.int32).contiguous() for h in hops]
        if not hop_t or val.shape[0] != R or hop_t[0].shape != (R,):
            raise ValueError("referrer_hist: hop columns, the first as long "
                             "as val and w")
        if len(hop_t) > _K7_MAX_HOPS:   # a long chain in stages (K18)
            first, rest = fold_chain(hop_t[0], hop_t[1:], _K7_MAX_HOPS - 1,
                                     caller="referrer_hist")
            hop_t = [first.contiguous()] + rest
        for h in hop_t:
            _need(h, torch.int32, "referrer_hist hop", 1)
    if not all(x.is_cuda for x in [val] + hop_t):
        raise ValueError("referrer_hist: every input must be on the card")
    plan = referrer_hist_plan(R, G, V, per_row)
    out = torch.zeros((G, V), dtype=torch.float32, device=w.device)
    n = len(hop_t)
    ptrs = (ctypes.c_int64 * max(1, n))(*[h.data_ptr() for h in hop_t])
    lens = (ctypes.c_int64 * max(1, n))(*[h.shape[0] for h in hop_t])
    rc = _fn("referrer_hist")(
        int(per_row), ptrs, lens, n, _ptr(val), rows, _ptr(w), _ptr(out), G,
        V, R, K7_ROUTES.index(plan["route"]), plan["tile"], plan["chunks"],
        plan["per"], plan["tiles"], plan["threads"], _stream(w))
    _check(rc, "referrer_hist")
    _count("referrer_hist", G, V, "rows" if per_row else "hoisted")
    return out


# ---------------------------------------------------------------- K8

_K8_THREADS = 256
_K8_GROUP = 128       # options a block owns (4 a lane)
# fewest referrers a split, and the blocks a launch aims at (3 an SM):
# from a sweep of split counts on an H100 (PERF.md §6)
_K8_MIN_PER = 256
_K8_BLOCKS = 3 * N_SMS
_K8_MERGE_THREADS = 256


def sa_ext_term_plan(B: int, E: int, R: int) -> dict:
    """K8's launch for B rows of E options over R referrers: dict(threads,
    splits, per, groups, grid, scratch, merge_grid).

    Each row's referrer axis is split over `splits` (S) blocks of `per`
    referrers (a multiple of 16, at least _K8_MIN_PER = 256) so that the
    launch gives the card three blocks an SM: S = ceil(396 / (B * groups)),
    fewer where R is short; at one row of 100,000 that is 391 blocks of
    256 referrers, from 396 rows on one block a row (splitting 4,096 rows
    further cost more in blocks and merging than it saved, PERF.md §6).
    Options go in groups of 128 a block. grid = (B, S, groups). Where S > 1 each block writes its
    partial sums into a [B, S, E] float64 scratch (`scratch` its elements,
    0 when S is 1), and a merge launch of `merge_grid` blocks of 256
    threads, a warp an output, sums them in a fixed order."""
    B, E, R = int(B), int(E), int(R)
    if B < 0 or E < 1 or R < 0:
        raise ValueError(f"sa_ext_term: B = {B}, E = {E}, R = {R} out of "
                         f"range")
    groups = -(-E // _K8_GROUP)
    if groups > _GRID_Y_MAX:
        raise ValueError(f"sa_ext_term: E = {E} options exceed the grid")
    want = -(-_K8_BLOCKS // max(1, B * groups))
    splits = max(1, min(want, -(-R // _K8_MIN_PER)))
    per = max(16, -(-(-(-R // splits)) // 16) * 16)
    splits = max(1, -(-R // per))
    warps = _K8_MERGE_THREADS // 32
    return dict(threads=_K8_THREADS, splits=splits, per=per, groups=groups,
                grid=(B, splits, groups),
                scratch=B * splits * E if splits > 1 else 0,
                merge_grid=-(-B * E // warps) if splits > 1 else 0)


def sa_ext_term_plain(SA, rv, val, w):
    """[B, E] f32: out[b, e] = sum over r with w[b, r] of SA[e, rv, val]
    (rv, val each [1 or B, R]; pairs out of [0, Vc) x [0, V) drop), as
    pclean_tpu.engine.propose._ext_hist_term's composed case computes it:
    the [B, Vc * V] pair histogram (K7's plain version) times SA as [E,
    Vc * V]. SA.abs() in place of SA gives the sum of |terms|, the scale
    of K8's tolerance."""
    E, Vc, V = SA.shape
    B, R = w.shape
    for x in (rv, val):
        if x.dim() != 2 or x.shape[1] != R or x.shape[0] not in (1, B):
            raise ValueError("sa_ext_term: rv and val must each be [1 or B, "
                             "R] beside w [B, R]")
    rv, val = torch.broadcast_tensors(rv.long(), val.long())
    ok = (rv >= 0) & (rv < Vc) & (val >= 0) & (val < V)
    cell = torch.where(ok, rv * V + val, torch.full_like(rv, -1))
    H = referrer_hist_plain(cell, w, Vc * V)
    return H @ SA.reshape(E, -1).T


def sa_ext_term(SA, rv, val, w):
    """K8. SA [E, Vc, V] f32, rv and val each [1 or B, R] int32 (a [1, R]
    side beside a [B, R] one is expanded to [B, R]), w [B, R] bool -> [B,
    E] f32, as sa_ext_term_plain."""
    if not _route(w, "sa_ext_term"):
        return sa_ext_term_plain(SA, rv, val, w)
    SA = SA.contiguous()
    w = w.to(torch.bool).contiguous()
    _need(SA, torch.float32, "sa_ext_term SA", 3)
    _need(w, torch.bool, "sa_ext_term w", 2)
    B, R = w.shape
    E, Vc, V = SA.shape
    for x in (rv, val):
        if x.dim() != 2 or x.shape[1] != R or x.shape[0] not in (1, B):
            raise ValueError("sa_ext_term: rv and val must each be [1 or B, "
                             "R] beside w [B, R]")
    if rv.shape != val.shape:
        rv, val = torch.broadcast_tensors(rv, val)
    rv = rv.to(torch.int32).contiguous()
    val = val.to(torch.int32).contiguous()
    if not all(x.is_cuda for x in (SA, rv, val)):
        raise ValueError("sa_ext_term: every input must be on the card")
    if Vc * V > 2 ** 31 - 1:
        raise ValueError("sa_ext_term: Vc * V must stay below 2^31")
    plan = sa_ext_term_plan(B, E, R)
    out = torch.empty((B, E), dtype=torch.float32, device=w.device)
    part = torch.empty((plan["scratch"],), dtype=torch.float64,
                       device=w.device) if plan["scratch"] else None
    rc = _fn("sa_ext_term")(
        _ptr(SA), E, Vc, V, _ptr(rv), _ptr(val), rv.shape[0], _ptr(w), R,
        _ptr(out), _ptr(part), B, plan["threads"], plan["splits"],
        plan["per"], plan["groups"], _K8_MERGE_THREADS, plan["merge_grid"],
        _stream(w))
    _check(rc, "sa_ext_term")
    _count("sa_ext_term", B, R, f"{E}x{Vc}x{V}")
    return out


# ---------------------------------------------------------------- K9

K9_MODES = ("resample", "final")
_K9_MAX_P = 16384        # 12 P bytes of shared memory stay under SMEM_MAX
_K9_MAX_THREADS = 256
K9_GROUP_MAX = 32        # the group path takes rows of up to a warp's lanes
K9_GROUP_WARPS = 8       # warps a block of the group path at most


def pg_resample_plan(R: int, P: int) -> dict:
    """K9's launch for R rows of P particles: dict(threads, smem, grid,
    group). P <= K9_GROUP_MAX: the group path, a group of `group` =
    _pow2(P) lanes a row (32 / group rows a warp), up to K9_GROUP_WARPS
    warps a block, no shared memory. Wider rows: one block a row (group
    0), a warp for every 32 particles up to 8 warps (a thread owns a
    contiguous chunk of ceil(P / threads) particles), the row's weights
    and prefix sums in 12 P bytes of dynamic shared memory."""
    R, P = int(R), int(P)
    if R < 0 or R > 2 ** 31 - 1 or not 1 <= P <= _K9_MAX_P:
        raise ValueError(f"pg_resample: R = {R}, P = {P} out of range "
                         f"(P <= {_K9_MAX_P})")
    if P <= K9_GROUP_MAX:
        G = _pow2(P)
        per = 32 // G
        warps = min(K9_GROUP_WARPS, max(1, -(-R // per)))
        return dict(threads=32 * warps, smem=0, grid=-(-R // (per * warps)),
                    group=G)
    threads = min(_K9_MAX_THREADS, 32 * -(-P // 32))
    return dict(threads=threads, smem=12 * P, grid=R, group=0)


def pg_resample_plain(ws: torch.Tensor, u: torch.Tensor,
                      mode: str = "resample", retained: bool = False):
    """pclean_tpu.engine.particles.propose_row_pg's resampling for rows of
    particle log weights ws [R, P], with injected uniforms in place of JAX's
    Gumbel noise; draws by K2's inverse-CDF rule (inv_cdf_sample_plain).

    mode "resample" (u [R, P]): every particle draws an ancestor from
    categorical(ws) with its own uniform, particle 0 keeps itself where
    `retained`, and rows whose ESS < P / 2 resample. Returns (sel [R, P]
    int64, ws_out [R, P], lml [R]): sel indexes the flattened [R * P]
    particle axis (r * P + ancestor; r * P + i where the row does not
    resample), ws_out is 0 where it resamples, else ws, and lml is the
    row's log-ML increment logsumexp(ws) - log P where it resamples,
    else 0.
    mode "final" (u [R]): (j [R] int64, lml [R]): one draw from
    categorical(ws) as an index of the flattened axis, and logsumexp(ws) -
    log P."""
    if mode not in K9_MODES:
        raise ValueError(f"pg_resample: mode {mode!r} is not one of "
                         f"{K9_MODES}")
    R, P = ws.shape
    lse = logsumexp(ws, dim=-1)
    inc = lse - math.log(P)
    m = torch.amax(ws, dim=-1, keepdim=True)
    c = torch.cumsum(torch.exp(ws - m), dim=-1)
    base = torch.arange(R, device=ws.device)[:, None] * P
    if mode == "final":
        ub = ((1.0 - u) * c[:, -1])[:, None]
        j = torch.searchsorted(c, ub.contiguous()).clamp(max=P - 1)
        return (base + j)[:, 0], inc
    ub = (1.0 - u) * c[:, -1:]
    idx = torch.searchsorted(c, ub.contiguous()).clamp(max=P - 1)
    if retained:
        idx[:, 0] = 0
    ess = effective_sample_size(log_normalize(ws))
    do = ess < P / 2.0
    ar = torch.arange(P, device=ws.device)[None, :]
    sel = base + torch.where(do[:, None], idx, ar)
    return (sel, torch.where(do[:, None], torch.zeros_like(ws), ws),
            torch.where(do, inc, torch.zeros_like(inc)))


def pg_resample(ws: torch.Tensor, u: torch.Tensor, mode: str = "resample",
                retained: bool = False):
    """K9. ws [R, P] f32 and u [R, P] ("resample") or [R] ("final") f32 in
    [0, 1) -> as pg_resample_plain."""
    if not _route(ws, "pg_resample"):
        return pg_resample_plain(ws, u, mode, retained)
    if mode not in K9_MODES:
        raise ValueError(f"pg_resample: mode {mode!r} is not one of "
                         f"{K9_MODES}")
    final = mode == "final"
    ws = ws.contiguous()
    u = u.contiguous()
    _need(ws, torch.float32, "pg_resample ws", 2)
    _need(u, torch.float32, "pg_resample u", 1 if final else 2)
    R, P = ws.shape
    if tuple(u.shape) != ((R,) if final else (R, P)):
        raise ValueError(f"pg_resample: u {tuple(u.shape)} does not fit ws "
                         f"{(R, P)} in {mode} mode")
    if not u.is_cuda:
        raise ValueError("pg_resample: u must be on the card")
    plan = pg_resample_plan(R, P)
    idx = torch.empty((R,) if final else (R, P), dtype=torch.int64,
                      device=ws.device)
    ws_out = None if final else torch.empty_like(ws)
    lml = torch.empty((R,), dtype=torch.float32, device=ws.device)
    rc = _fn("pg_resample")(_ptr(ws), _ptr(u), _ptr(idx), _ptr(ws_out),
                            _ptr(lml), R, P, int(final), int(bool(retained)),
                            plan["threads"], plan["smem"], plan["group"],
                            _stream(ws))
    _check(rc, "pg_resample")
    _count("pg_resample", R, P, mode)
    return (idx, lml) if final else (idx, ws_out, lml)


# ---------------------------------------------------------------- K10, K11

# dtype codes of the row kernels' plans (csrc/row_words.cuh)
_DT = {torch.bool: 0, torch.int8: 1, torch.uint8: 2, torch.int16: 3,
       torch.int32: 4, torch.int64: 5, torch.float32: 6, torch.float64: 7}
K10_MODES = ("obs", "latent")
# the words of K10's plan (csrc/row_delta.cu): a header (from word
# K10_LANES each chain lane's first entry + 1, a byte a lane), the tier's
# room of node records and of counter records, then the chains' records;
# a column's length and dtype share one word (length << 4 | dtype)
K10_HEAD, K10_LANES, K10_NODE, K10_COUNTER = 14, 10, 6, 4
# the plan's parameter blocks, by the tier (word 7) that names each:
# (fk-tree nodes, hops a chain, chains). A class's fk-tree nodes read
# each other's flips and its chains run beside them in one launch, so a
# model past tier 0 takes tier 1 rather than a split. A block's size
# costs a launch nothing (PERF.md section 3), so no smaller tier is kept
# for the classes the paths sweep row by row
K10_TIERS = ((24, 6, 32), (64, 16, 48))


def k10_words(tier: int) -> int:
    nodes, hops, props = K10_TIERS[tier]
    return K10_HEAD + (K10_NODE + K10_COUNTER) * nodes + \
        (10 + 2 * hops) * props


K10_WORDS = k10_words(0)
# the words of K11's plan (csrc/row_write.cu): a header (writes, groups),
# the groups' slot, first mask and second mask pointers and packed words
# (length << 12 | second mask's dtype << 8 | first mask's << 4 | slot's),
# then the writes' destinations, sources (0 for True) and packed words
# (next write into the same column + 1 << 16 | group << 8 | source's
# dtype << 4 | destination's), each field an array of its own
K11_MAX_WRITES = K11_MAX_GROUPS = 64
K11_HEAD = 2
K11_G_SLOT, K11_G_MA, K11_G_MB, K11_G_PK = (K11_HEAD + K11_MAX_GROUPS * i
                                            for i in range(4))
K11_W_DST, K11_W_SRC, K11_W_PK = (K11_HEAD + 4 * K11_MAX_GROUPS
                                  + K11_MAX_WRITES * i for i in range(3))
K11_WORDS = K11_W_PK + K11_MAX_WRITES
# bytes of kernel parameters a launch may pass on Hopper with CUDA >= 12.1
PARAM_MAX = 32764
# the largest block with the slot, sign and save / old pointers
K10_PARAM_BYTES = 8 * k10_words(len(K10_TIERS) - 1) + 32
K11_PARAM_BYTES = 8 * K11_WORDS


class RowCarry:
    """The carry of one segment of a one-row loop of class cid, which the
    loop owns (smc.own_carry): its arenas and relational state `rel`, the
    observed columns `obs` and the segment's hop histograms `hops`, updated
    in place by K10 (row_delta) and K11 (row_write). On the card each
    plan's argument words are bound to these leaves at its first launch
    from the carry and reused by every later row: no leaf may be replaced
    while the carry lives (the loops only write into them)."""

    def __init__(self, cm, cid, arenas, rel=None, obs=None, hops=None):
        self.cm, self.cid = cm, cid
        self.arenas, self.rel, self.obs = arenas, rel, obs
        self.hops = list(hops or ())
        self.k10 = {}   # (mode, hop) -> the plan's bound words
        self.k11 = {}   # a row's structure -> its bound plan
        #                 (row_write_plan)


def _leaf(g, car: RowCarry):
    """The tensor a plan's pointer word names: ("a", class, vid) an arena
    column, ("alive", class) an arena's alive, ("r", class, key) a
    relational leaf, ("p", class, vid, 0 or 1) a prop's code or count,
    ("o", class, vid, 0 or 1) an observed column's codes or state, ("h", i,
    0 or 1) hop entry i's count or code histogram."""
    k = g[0]
    if k == "a":
        return car.arenas[g[1]]["values"][g[2]]
    if k == "alive":
        return car.arenas[g[1]]["alive"]
    if k == "r":
        return car.rel[g[1]][g[2]]
    if k == "p":
        return car.rel[g[1]]["prop"][g[2]][g[3]]
    if k == "o":
        return car.obs[g[1]][g[2]][g[3]]
    return car.hops[g[1]][1][g[2]]


def k10_tier(nodes: int, chains: int, hops: int, cid=None) -> int:
    """The first of K10's parameter blocks (K10_TIERS) that holds a
    plan of `nodes` fk-tree nodes and `chains` propagated-observation
    chains (or hop entries) of at most `hops` hops; raises, naming the
    model's feature, where none does."""
    for tier, (n, h, p) in enumerate(K10_TIERS):
        if nodes <= n and chains <= p and hops <= h:
            return tier
    n, h, p = K10_TIERS[-1]
    raise ValueError(
        f"row_delta: class {cid!r} reaches {nodes} classes through its fk "
        f"tree and has {chains} propagated-observation chains of up to "
        f"{hops} hops; K10 takes at most {n} fk-tree nodes and {p} chains "
        f"of {h} hops")


def k10_schedule(nodes: list) -> None:
    """Phase A's and B's schedule of K10's tree (csrc/row_delta.cu), in
    place on row_delta_plan's nodes (DFS order): each node's depth (the
    level at which it reads its fk value, 1 at a root), prev and next (the
    previous and next node of its target class, -1 where none) and round
    (phase B's: after its parent's and its class's previous node's)."""
    last: dict = {}
    for i, nd in enumerate(nodes):
        p = nd["parent"]
        nd["depth"] = 1 + (nodes[p]["depth"] if p >= 0 else 0)
        nd["prev"], nd["next"] = last.get(nd["tc"], -1), -1
        if nd["prev"] >= 0:
            nodes[nd["prev"]]["next"] = i
        last[nd["tc"]] = i
        nd["round"] = 1 + max(nodes[p]["round"] if p >= 0 else 0,
                              nodes[nd["prev"]]["round"] if nd["prev"] >= 0
                              else 0)


def row_delta_plan(cm, cid, mode: str, hop: bool = False) -> dict:
    """K10's plan for one row of class cid, built on the host once and
    cached on cm:
      nodes: refresh._fk_delta's recursion flattened in its DFS order, each
        dict(tc = the target class, col = the (class, fk vid) column read
        for t, parent = the parent node or -1, root = the index of a root's
        fk among cid's fk vertices, else -1);
      props: in obs mode, the class's propagated-observation chains
        (refresh.propagated_obs_specs: dict(ov, chain, target = (tc, tv),
        lane)); with hop (latent mode), the hop histogram entries
        (dict(fkv, root, suffix, target, hist = the entry's index in
        refresh.hop_histograms' list, lane)); entries of one target share
        a lane (0-31 of the kernel's second warp), in order, and the list
        holds each lane's entries together;
      nodes also carry k10_schedule's depth, prev, next and round;
      counters: (target class, the mask of its nodes) for each target
        class, whose total and nrows the kernel adds to once;
      words: the static words of the kernel's argument (the counters'
        records written at binding, _k10_words), and slots: for each
        pointer word, (leaf, its word, the word that takes its dtype or
        -1, the bit at which the dtype goes in that word, or None where
        that word is the leaf's column word, length << 4 | dtype, the
        dtype it must have or None, the length it must have or None)."""
    cache = cm.__dict__.setdefault("_row_plans", {})
    key = ("k10", cid, mode, bool(hop))
    if key in cache:
        return cache[key]
    from .engine.refresh import propagated_obs_specs

    if mode not in K10_MODES:
        raise ValueError(f"row_delta: mode {mode!r} is not one of {K10_MODES}")
    lay = cm.layouts[cid]
    if lay.observed != (mode == "obs") or (hop and mode != "latent"):
        raise ValueError(f"row_delta: mode {mode!r} (hop {hop}) does not fit "
                         f"class {cid!r}")
    nodes = []

    def walk(tc, col, parent, root):
        i = len(nodes)
        nodes.append(dict(tc=tc, col=col, parent=parent, root=root))
        for fkv2 in cm.layouts[tc].fk_vertices:
            walk(cm.node(tc, fkv2).target_class, (tc, fkv2), i, -1)

    for r, fkv in enumerate(lay.fk_vertices):
        walk(cm.node(cid, fkv).target_class, (cid, fkv), -1, r)
    entries = []
    if mode == "obs":
        entries = [dict(ov=ov, chain=chain, target=tgt)
                   for (src, ov, chain, tgt) in propagated_obs_specs(cm)
                   if src == cid]
    elif hop:
        for (src, ov, chain, tgt) in propagated_obs_specs(cm):
            for k, (hop_cid, fkv) in enumerate(chain):
                if hop_cid == cid:
                    entries.append(dict(fkv=fkv, suffix=chain[k + 1:],
                                        root=lay.fk_vertices.index(fkv),
                                        target=tgt, hist=len(entries)))
    groups: dict = {}
    for e in entries:
        e["lane"] = groups.setdefault(e["target"], len(groups)) % 32
    entries.sort(key=lambda e: e["lane"])
    hops_of = [e["chain"] if "chain" in e else e["suffix"] for e in entries]
    tier = k10_tier(len(nodes), len(entries),
                    max(map(len, hops_of), default=0), cid)
    max_nodes, max_hops, _p = K10_TIERS[tier]
    k10_schedule(nodes)
    prop_w, props0 = 10 + 2 * max_hops, \
        K10_HEAD + (K10_NODE + K10_COUNTER) * max_nodes
    words = [0] * (props0 + prop_w * len(entries))
    slots = []
    words[0] = {"obs": 0, "latent": 1}[mode] + (1 if hop else 0)
    words[1], words[2], words[3] = len(nodes), len(entries), lay.capacity
    words[7] = tier
    words[8] = max((nd["depth"] for nd in nodes), default=0)
    words[9] = max((nd["round"] for nd in nodes), default=0)
    slots.append((("alive", cid) if mode == "obs" else ("r", cid, "alive"),
                  4, 5, None, torch.bool, lay.capacity))
    counters: dict = {}
    for i, nd in enumerate(nodes):
        b = K10_HEAD + K10_NODE * i
        cap = cm.layouts[nd["tc"]].capacity
        words[b + 4] = cap
        words[b + 5] = (nd["depth"] | nd["round"] << 8
                        | (nd["parent"] + 1) << 16 | (nd["root"] + 1) << 24
                        | (nd["prev"] + 1) << 32 | (nd["next"] + 1) << 40)
        slots += [(("a",) + nd["col"], b, b + 1, None, None, None),
                  (("r", nd["tc"], "refcount"), b + 2, -1, None, torch.int32,
                   cap),
                  (("r", nd["tc"], "alive"), b + 3, -1, None, torch.bool,
                   cap)]
        counters[nd["tc"]] = counters.get(nd["tc"], 0) | 1 << i
    last: dict = {}
    for j, e in enumerate(entries):   # each lane's entries, linked
        if e["lane"] in last:
            words[props0 + prop_w * last[e["lane"]] + 3] |= (j + 1) << 32
        else:
            words[K10_LANES + e["lane"] // 8] |= (j + 1) << 8 * (e["lane"]
                                                                % 8)
        last[e["lane"]] = j
    for j, (e, chain) in enumerate(zip(entries, hops_of)):
        b = props0 + prop_w * j
        tc, tv = e["target"]
        cap_t = cm.layouts[tc].capacity
        words[b + 2] = cap_t
        words[b + 3] |= e["lane"] << 8 | e.get("root", 0) << 16 | \
            len(chain) << 24
        slots += [(("p", tc, tv, 0), b, b + 3, 0, None, cap_t),
                  (("p", tc, tv, 1), b + 1, b + 3, 4, None, cap_t)]
        if "chain" in e:
            slots += [(("o", cid, e["ov"], 0), b + 4, b + 5, None, None,
                       None),
                      (("o", cid, e["ov"], 1), b + 6, b + 7, None, None,
                       None)]
        else:
            slots += [(("h", e["hist"], 0), b + 4, b + 5, None, None, None),
                      (("h", e["hist"], 1), b + 6, b + 7, None, None, None),
                      (("a", cid, e["fkv"]), b + 8, b + 9, None, None,
                       None)]
        for h, col in enumerate(chain):
            hb = b + 10 + 2 * h
            slots.append((("a",) + col, hb, hb + 1, None, None, None))
    plan = dict(cid=cid, mode=mode, hop=bool(hop), nodes=nodes,
                props=entries, words=words, slots=slots, tier=tier,
                counters=list(counters.items()),
                n_roots=len(lay.fk_vertices))
    cache[key] = plan
    return plan


def _k10_words(plan: dict, car: RowCarry, card: bool = True):
    """The plan's words with the carry's pointers, as a ctypes array, every
    leaf checked (on the card, or with card=False on the CPU, whose
    addresses a CPU reading of the plan follows). Classes whose total and
    nrows are the same two tensors share one counter record."""
    words = list(plan["words"])
    for g, pw, dw, shift, dtype, n in plan["slots"]:
        t = _leaf(g, car)
        _k10_leaf(t, g, card, dtype, n)
        words[pw] = t.data_ptr()
        if dw >= 0 and shift is None:
            words[dw] = t.numel() << 4 | _DT[t.dtype]
        elif dw >= 0:
            words[dw] |= _DT[t.dtype] << shift
    base = K10_HEAD + K10_NODE * K10_TIERS[plan["tier"]][0]
    owner: dict = {}
    for tc, mask in plan["counters"]:
        tot, nr = car.rel[tc]["total"], car.rel[tc]["nrows"]
        for k, t in (("total", tot), ("nrows", nr)):
            _k10_leaf(t, ("r", tc, k), card, None, 1)
        pair = (tot.data_ptr(), nr.data_ptr())
        if pair not in owner and not {p for q in owner for p in q} & \
                set(pair):
            b = base + K10_COUNTER * len(owner)
            owner[pair] = b
            words[b:b + 3] = [*pair, _DT[tot.dtype] | _DT[nr.dtype] << 4]
        elif pair not in owner:
            raise ValueError(f"row_delta: class {tc!r}'s total and nrows "
                             f"share one tensor with another class's")
        b = owner[pair]
        m = (words[b + 3] & (1 << 64) - 1) | mask
        words[b + 3] = m - (1 << 64) if m >= 1 << 63 else m
    words[6] = len(owner)
    return (ctypes.c_int64 * len(words))(*words)


def _k10_leaf(t, g, card: bool, dtype, n) -> None:
    if t.is_cuda != card or t.dim() > 1 or not t.is_contiguous() or \
            t.dtype not in _DT or (dtype is not None and t.dtype != dtype) \
            or (n is not None and t.numel() != n):
        raise ValueError(f"row_delta: leaf {g} is {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _into_rel(rel: dict, new: dict) -> None:
    """Copy every leaf of `new` that is not rel's own tensor into rel's."""
    for c, r in new.items():
        o = rel[c]
        for k in ("refcount", "alive", "total", "nrows"):
            if r[k] is not o[k]:
                o[k].copy_(r[k])
        for tv, pair in r["prop"].items():
            for x, y in zip(o["prop"][tv], pair):
                if x is not y:
                    x.copy_(y)


def row_delta_plain(car: RowCarry, slot, sign: int, mode: str = "obs",
                    save_fk=None, old_fk=None) -> None:
    """K10's plain version, with its in-place contract: the carry's rel ±
    one row `slot` (a one-element index tensor) of its class, its leaves
    updated in place. mode "obs": refresh.row_delta; "latent":
    refresh.latent_row_delta, then, on +1 where the carry has hop
    histograms, refresh.hop_move from the old fk values `old_fk` [the
    class's fk vertices]. `save_fk` receives the row's fk values before
    the delta."""
    from .engine import refresh as rf

    cm, cid, arenas = car.cm, car.cid, car.arenas
    s = slot.reshape(()).long()
    fkvs = cm.layouts[cid].fk_vertices
    if save_fk is not None and fkvs:
        save_fk[:len(fkvs)] = torch.stack(
            [take(arenas[cid]["values"][v], s) for v in fkvs]).long()
    if mode == "obs":
        new = rf.row_delta(cm, car.rel, arenas, car.obs, cid, s, sign)
    elif mode == "latent":
        new = rf.latent_row_delta(cm, car.rel, arenas, cid, s, sign)
        if sign == 1 and car.hops:
            new = rf.hop_move(cm, new, arenas, cid, s,
                              {v: old_fk[i] for i, v in enumerate(fkvs)},
                              car.hops)
    else:
        raise ValueError(f"row_delta: mode {mode!r} is not one of {K10_MODES}")
    _into_rel(car.rel, new)


def _need_index(t: torch.Tensor, name: str) -> None:
    if not t.is_cuda or t.numel() != 1 or t.dtype not in _DT:
        raise ValueError(f"{name}: expected a one-element index on the card, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def row_delta(car: RowCarry, slot, sign: int, mode: str = "obs",
              save_fk=None, old_fk=None) -> None:
    """K10: row_delta_plain's in-place delta in one launch, the row's slot
    read on the card (an int64 one-element tensor, so the host never waits
    for it), the hop entries moved on a latent +1 where the carry has
    them. On CPU tensors the plain version; on CUDA ones the kernel or an
    error. Counted in LAUNCH_CENSUS by ("class mode[ hop] sign", r1, the
    plan's fk nodes)."""
    if not _route(slot, "row_delta"):
        return row_delta_plain(car, slot, sign, mode, save_fk, old_fk)
    if sign not in (1, -1):
        raise ValueError(f"row_delta: sign {sign} is not +1 or -1")
    hop = mode == "latent" and sign == 1 and bool(car.hops)
    plan = row_delta_plan(car.cm, car.cid, mode, hop)
    if hop and old_fk is None:
        raise ValueError("row_delta: hop entries move from old_fk")
    _need_index(slot, "row_delta slot")
    if slot.dtype != torch.int64:
        raise ValueError("row_delta: the slot must be int64")
    for name, t in (("save_fk", save_fk), ("old_fk", old_fk)):
        if t is not None and (not t.is_cuda or t.dtype != torch.int64 or
                              not t.is_contiguous() or
                              t.numel() < plan["n_roots"]):
            raise ValueError(f"row_delta: {name} must be int64 [>= "
                             f"{plan['n_roots']}] on the card")
    if plan["tier"] == 1:   # the larger block
        _split("row_delta")
    arr = car.k10.get((mode, hop))
    if arr is None:
        if hop and len(car.hops) != len(plan["props"]):
            raise ValueError("row_delta: hop entries do not fit the plan")
        arr = car.k10[(mode, hop)] = _k10_words(plan, car)
    rc = _fn("row_delta")(arr, len(arr), _ptr(slot), int(sign),
                          _ptr(save_fk), _ptr(old_fk), _stream(slot))
    _check(rc, "row_delta")
    _count("row_delta", 1, len(plan["nodes"]),
           f"{car.cid} {mode}{' hop' if hop else ''} {sign:+d}")


def row_write_plain(car: RowCarry, slot, env2: dict, births, accept=None,
                    mark_alive: bool = False) -> None:
    """K11's plain version, with its in-place contract: smc.apply_row's
    writes of one row (values [1]) into the carry's arenas' own leaves;
    `accept` None means True."""
    from .engine.smc import apply_row

    new = apply_row(car.cm, car.cid, car.arenas, slot, env2, births,
                    True if accept is None else accept, mark_alive)
    for c, a in new.items():
        o = car.arenas[c]
        for v, x in a["values"].items():
            if x is not o["values"][v]:
                o["values"][v].copy_(x)
        if a["alive"] is not o["alive"]:
            o["alive"].copy_(a["alive"])


def row_write_order(car: RowCarry, env2: dict, births,
                    mark_alive: bool) -> list:
    """apply_row's writes in its order, the one place that order is kept:
    (index group, destination column, source vertex or None for True),
    group 0 the row's values, 1 its alive bit, 2 + i birth i's values
    (row_write_groups)."""
    cid = car.cid
    vals = car.arenas[cid]["values"]
    out = [(0, vals[v], v) for v in car.cm.layouts[cid].store if v in env2]
    if mark_alive:
        out.append((1, car.arenas[cid]["alive"], None))
    for i, b in enumerate(births):
        bvals = car.arenas[b.target_class]["values"]
        out += [(2 + i, bvals[tv], tv) for tv in b.values if tv in bvals]
    return out


def row_write_groups(slot, env2: dict, births, accept) -> tuple:
    """row_write_order's groups' (slot, mask or None, second mask or None)
    and the maps their source vertices are read from."""
    idx = [(slot, accept, None), (slot, None, None)] + [
        (b.slot, accept, b.is_new) for b in births]
    return idx, [env2, None] + [b.values for b in births]


def row_write_writes(car: RowCarry, slot, env2: dict, births, accept,
                     mark_alive: bool) -> list:
    """apply_row's writes in its order: (destination column, value or None
    for True, slot, mask or None, second mask or None)."""
    idx, src = row_write_groups(slot, env2, births, accept)
    return [(dst, None if v is None else src[g][v]) + idx[g]
            for g, dst, v in row_write_order(car, env2, births, mark_alive)]


def row_write_chunks(n: int) -> list:
    """K11's launches for a row of n writes: the (first, end) write ranges
    of each, in order, at most K11_MAX_WRITES a launch. Launches queue in
    order on one stream, so the writes still apply in list order, and a
    write's value, slot and masks are inputs no write changes: the split
    writes what one launch would."""
    return [(i, min(n, i + K11_MAX_WRITES))
            for i in range(0, max(n, 1), K11_MAX_WRITES)]


def row_write_plan(car: RowCarry, env2: dict, births, mark_alive: bool,
                   card: bool = True) -> dict:
    """K11's plan for a row of this structure (env2's vertices, the births'
    classes and vertices, mark_alive), bound to the carry's columns:
    row_write_order's writes, each in its index group (a launch group a
    group and column length), cut into row_write_chunks' launches. Each
    launch's words hold the destinations, each write's group, destination
    dtype and link to the next write of the launch into the same column;
    the groups' (launch group, group, length word), the writes' packed
    words and their (group, source vertex) stay beside them for
    row_write_fill. With `card`, columns off the card raise."""
    order = row_write_order(car, env2, births, mark_alive)
    dsts = [(g, dst) for g, dst, _v in order]
    for _g, dst in dsts:
        if (card and not dst.is_cuda) or dst.dim() != 1 or \
                not dst.is_contiguous() or dst.dtype not in _DT:
            raise ValueError(f"row_write: column {dst.dtype} "
                             f"{tuple(dst.shape)} on {dst.device}")
    chunks = []
    for lo, hi in row_write_chunks(len(dsts)):
        part = dsts[lo:hi]
        groups: dict = {}
        for g, dst in part:
            groups.setdefault((g, dst.numel()), len(groups))
        words = (ctypes.c_int64 * K11_WORDS)()
        words[0], words[1] = len(part), len(groups)
        pks, later = [0] * len(part), {}
        for j in range(len(part) - 1, -1, -1):
            g, dst = part[j]
            p = dst.data_ptr()
            words[K11_W_DST + j] = p
            pks[j] = later.get(p, 0) << 16 | \
                groups[(g, dst.numel())] << 8 | _DT[dst.dtype]
            later[p] = j + 1
        chunks.append(dict(lo=lo, words=words, pk=pks, groups=[
            (j, g, n << 12) for (g, n), j in groups.items()]))
    return dict(src=[(g, v) for g, _dst, v in order], chunks=chunks)


def _k11_in(t, name: str, card: bool) -> tuple:
    """(pointer, dtype code) of a one-element input of K11, (0, 0) for
    None."""
    if t is None:
        return 0, 0
    if card:
        _need_index(t, f"row_write {name}")
    elif t.numel() != 1 or t.dtype not in _DT:
        raise ValueError(f"row_write {name}: {t.dtype} {tuple(t.shape)}")
    return t.data_ptr(), _DT[t.dtype]


def row_write_fill(plan: dict, slot, env2: dict, births, accept,
                   card: bool = True) -> list:
    """A row's value, slot and mask pointers and their dtypes written into
    row_write_plan's words (`accept` a one-element tensor or None for
    True); returns each launch's words, in order."""
    gin, vals = row_write_groups(slot, env2, births, accept)
    srcs = [None if v is None else vals[g][v] for g, v in plan["src"]]
    out = []
    for c in plan["chunks"]:
        words, lo = c["words"], c["lo"]
        for j, g, lw in c["groups"]:
            s, ma, mb = gin[g]
            ps, ds = _k11_in(s, "slot", card)
            pa, da = _k11_in(ma, "mask", card)
            pb, db = _k11_in(mb, "mask", card)
            words[K11_G_SLOT + j] = ps
            words[K11_G_MA + j], words[K11_G_MB + j] = pa, pb
            words[K11_G_PK + j] = lw | db << 8 | da << 4 | ds
        for j, pk in enumerate(c["pk"]):
            p, d = _k11_in(srcs[lo + j], "value", card)
            words[K11_W_SRC + j], words[K11_W_PK + j] = p, pk | d << 4
        out.append(words)
    return out


def row_write(car: RowCarry, slot, env2: dict, births, accept=None,
              mark_alive: bool = False) -> None:
    """K11: row_write_plain's writes in place, every index and mask read
    on the card, in one launch a row_write_chunks range (one for a row of
    up to K11_MAX_WRITES writes). The plan of a row of one structure (its
    value vertices, births, mask) is bound to the carry's columns once
    (row_write_plan); each row sets only its groups' slot and mask
    pointers and its values' (row_write_fill). On CPU tensors the plain
    version; on CUDA ones the kernel or an error. Counted in LAUNCH_CENSUS
    by (class, r1, births), once a launch."""
    if not _route(slot, "row_write"):
        return row_write_plain(car, slot, env2, births, accept, mark_alive)
    if isinstance(accept, bool):
        accept = None if accept else torch.zeros((1,), dtype=torch.bool,
                                                 device=slot.device)
    key = (bool(mark_alive), accept is None, tuple(env2),
           tuple((b.target_class, tuple(b.values)) for b in births))
    plan = car.k11.get(key)
    if plan is None:
        plan = car.k11[key] = row_write_plan(car, env2, births, mark_alive)
    launches = row_write_fill(plan, slot, env2, births, accept)
    if len(launches) > 1:
        _split("row_write")
    for words in launches:
        rc = _fn("row_write")(words, K11_WORDS, _stream(slot))
        _check(rc, "row_write")
        _count("row_write", 1, len(births), car.cid)


# ---------------------------------------------------------------- K12, K13

_K12_MAX_DIMS = 8   # enumeration axes of a record (csrc/score_rows.cuh)
NINF = float(NEG_INF)
_INDEX_DT = (torch.int8, torch.int16, torch.int32, torch.int64)

Level = collections.namedtuple("Level", "prog operands rank label")
Level.__doc__ = """A one-row level handed unsummed to its only reader, K12 or
K13 (BlockTracer._level_sum at B = 1): its postfix program
(level_program), operands (level_dense, level_eq, level_sel,
level_gather) and rank, aligned as level_sum takes them; `label` names
the K20 launches of its earlier stages where level_stages cuts it."""


def level_value(x):
    """A child as the score kernels' plain versions take it: a tensor as
    it is, a Level summed by level_sum_split_plain (level_sum_plain through
    level_stages' cuts: bit-equal to K20's launches of it)."""
    if isinstance(x, Level):
        return level_sum_split_plain(x.prog, x.operands, x.rank)
    return x


def as_level(x, rank: int) -> Level:
    """A child as the score kernels take it on the card: a Level as it is;
    a tensor (a constant 0, or a level K20 summed first) a one-step level
    reading it (PUSH 0 of one dense term: the same value)."""
    if isinstance(x, Level):
        return x
    return Level([(LEVEL_PUSH, 0)], [level_dense(x)], rank, None)


def score_spread(R: int) -> bool:
    """Whether a score kernel gives each slot of its child level a thread
    of its own (the "slots" path of fk_score_plan): at one row. A thread
    that takes several slots evaluates their levels one after another,
    each a chain of dependent loads through the program's walk, so the
    loads of its slots do not overlap as the plain loads of K1's loop do.
    On an H100 80GB HBM3 at 700.00 W (chip_smoke.py's K12/K13 census
    shapes timed on both geometries, PERF.md §6), at one row the slots
    path won at every shape longer than a warp (a constant child over 222
    options 0.0029 against 0.0056 device ms on K1's warp plan, a one-term
    level over 7,735 0.0050 against 0.0159 on its block plan, the
    11-gather level over 512 slots 0.0158 against 0.1352) and tied up to
    32 (0.0027-0.0035); over 4,096 rows of 2 options K1's warp plan held
    (0.0070 against 0.0073). No census shape has a level with a gather
    over more than one row, so none is measured there."""
    return R == 1


def _score_plan(R: int, K: int, mode: str, spread: bool, path) -> dict:
    if path is None and spread:
        path = "slots"
    if path != "slots":
        p = enum_logsumexp_plan(R, K, mode, path)
        if p["path"] == "split":
            p = enum_logsumexp_plan(R, K, mode, path="block")
        return p
    if R > _GRID_Y_MAX:
        raise ValueError(f"score kernels: R = {R} rows exceed the slots "
                         f"path's grid")
    threads = min(SCORE_MAX_THREADS, 32 * max(1, -(-K // 32)))
    cluster = min(SCORE_MAX_CLUSTER, -(-K // threads))
    return dict(path="slots", threads=threads, rows=1, cluster=cluster,
                grid=(cluster, R))


def fk_score_plan(R: int, K: int, spread: bool = False, path=None) -> dict:
    """K12's launch for R rows of K slots, dict(path, threads, rows,
    cluster, grid). Without `spread` (score_spread false): K1's plan at
    (R, K) in fk mode (a warp a row up to 512 slots, else a block a row
    of up to 16 warps; where K1 splits a row over a cluster, its block
    path). With it: "slots", a thread a slot in a block of up to
    SCORE_MAX_THREADS, past that a cluster of up to SCORE_MAX_CLUSTER such
    blocks a row (grid (cluster, R)), the threads looping past 8,192
    slots. `path` forces one of SCORE_PATHS (kernel_bench)."""
    return _score_plan(int(R), int(K), "fk", spread, path)


def choice_score_plan(R: int, V: int, spread: bool = False,
                      path=None) -> dict:
    """K13's launch for R rows of V options: as fk_score_plan, K1's plan
    in choice mode without `spread`."""
    return _score_plan(int(R), int(V), "choice", spread, path)


def score_fusion(levels) -> dict:
    """How a score kernel takes its child levels (K13: [children]; K12:
    [ch_e, ch_n]; Levels or tensors): dict(stages: each level's K20
    launches before the score kernel, 0 where level_stages does not cut
    it, else all its stages but the last, whose sum the kernel takes in;
    n_first: K12's ch_n summed by K20 first, all its stages, where the two
    levels' words do not fit K12's largest parameter block with the head;
    words: the plan's word count; split: any K20 launch before the
    kernel). Each such call is counted in SPLITS under the score kernel;
    none on the six paths."""
    head = K13_HEAD if len(levels) == 1 else K12_HEAD
    stages, last = [], []
    for x in levels:
        if isinstance(x, Level):
            cut = level_stages(x.prog, x.operands)
            p, srcs = cut[-1]
            refs = sum(_refs_of(x.operands[i]) if k == "o" else 1
                       for k, i in srcs)
            stages.append(len(cut) - 1)
            last.append(K20_HEAD + K20_REF * refs + K20_OP * len(srcs)
                        + len(p))
        else:
            stages.append(0)
            last.append(K20_HEAD + K20_REF + K20_OP + 1)
    n_first = len(levels) == 2 and head + sum(last) > K12_WORDS
    if n_first:
        stages[1] = len(level_stages(levels[1].prog, levels[1].operands))
        last[1] = K20_HEAD + K20_REF + K20_OP + 1
    return dict(stages=stages, n_first=n_first, words=head + sum(last),
                split=any(stages) or n_first)


def _fuse_prepare(x, rank: int, whole: bool = False) -> Level:
    """A child ready for the score kernel on the card: a tensor as a
    one-step level; a level level_stages cuts, its earlier stages summed by
    K20 (level_sum, at B = 1) and its last stage taking their sums as
    dense terms, the rest of level_sum_split_plain's order; with `whole`
    all of it summed by K20 first."""
    if not isinstance(x, Level):
        return as_level(x, rank)
    if whole:
        return as_level(_level_sum_stages(x, len(level_stages(
            x.prog, x.operands)))[-1], rank)
    cut = level_stages(x.prog, x.operands)
    if len(cut) == 1:
        return x
    outs = _level_sum_stages(x, len(cut) - 1)
    p, srcs = cut[-1]
    return Level(p, [x.operands[i] if k == "o" else level_dense(outs[i])
                     for k, i in srcs], x.rank, x.label)


def _level_sum_stages(lv: Level, n: int) -> list:
    """The sums of level_stages' first n stages of lv, each a K20 launch."""
    outs = []
    for p, srcs in level_stages(lv.prog, lv.operands)[:n]:
        ops_ = [lv.operands[i] if k == "o" else level_dense(outs[i])
                for k, i in srcs]
        outs.append(level_sum(p, ops_, lv.rank, B=1, label=lv.label))
    return outs


def _level_positions(operands, base: int, src: int) -> list:
    """[(word, pointer source)] of a level's plan at word `base`: each
    operand's tensor references, then a gather's matrix, in _level_key's
    pointer order from source `src`."""
    pos, r = [], 0
    n_refs = sum(_refs_of(o) for o in operands)
    for i, o in enumerate(operands):
        nr = _refs_of(o)
        pos += [(base + K20_HEAD + K20_REF * (r + j), src + j)
                for j in range(nr)]
        r += nr
        src += nr
        if o["kind"] == "gather":
            pos.append((base + K20_HEAD + K20_REF * n_refs + K20_OP * i + 4,
                        src))
            src += 1
    return pos


def _tsig(t):
    """A tensor argument's structure in a plan cache key."""
    if not torch.is_tensor(t):
        return t
    return (t.dtype, tuple(t.shape), t.stride(), t.get_device())


def _score_mode(cls, R: int, levels) -> str:
    """K12's or K13's census mode: "cls R", then each child level's own
    output shape and operand kinds (level_kinds; K12's ch_e after "e=",
    ch_n after "n=")."""
    tags = ("",) if len(levels) == 1 else ("e=", "n=")
    return " ".join([f"{cls} {R}"] + [
        f"{t}{'x'.join(map(str, level_shape(lv.operands, lv.rank)))} "
        f"{level_kinds(lv.operands)}" for t, lv in zip(tags, levels)])


def fk_score_plain(refcount, alive, total, nrows, strength, discount,
                   children, new_children, full):
    """K12's plain version, the tracer's own arithmetic for one row
    (BlockTracer.py_logprobs, score_fk's adds and enum_logsumexp_plain):
    existing = log(max(refcount - d, 1e-30)) - log(total + s) where the
    slot is alive and referenced, else NEG_INF; new = log(d nrows + s) -
    log(total + s); children [.., K] and new_children [..] broadcast to
    `full` (the enumeration rows, batch axis first) added, each a tensor
    or a Level (summed first by level_value: K20's plain version). s and
    d: device scalars or the class's constants. Returns (record [R, K +
    1], logZ [R]): K21's plain version without a compaction, then K1's."""
    return enum_logsumexp_plain(*py_prior_plain(
        refcount, alive, total, nrows, strength, discount, None,
        level_value(children), level_value(new_children), full))


def fk_score_words(refcount, alive, total, nrows, strength, discount,
                   ch_e: Level, ch_n: Level, full, rec, logz, plan: dict,
                   card: bool = True) -> list:
    """K12's plan (csrc/fk_score.cu): the head (the leaves' and counts'
    pointers and dtype codes, strength and discount as device pointers or
    float bits, the outputs, R, the geometry, the instantiation, where
    ch_n's words start), then ch_e's level words over [full..., K] and
    ch_n's over [full] (level_plan, fused). Refuses what the kernel does
    not take, and, with `card`, tensors off the card."""
    full, R = _score_rows(full)
    K = int(refcount.shape[-1])
    refcount, alive = refcount.reshape(-1), alive.reshape(-1)
    for t, name, dt in ((refcount, "refcount", torch.int32),
                        (alive, "alive", torch.bool)):
        if t.dtype != dt or not t.is_contiguous() or t.numel() != K or \
                (card and not t.is_cuda):
            raise ValueError(f"fk_score: {name} is {t.dtype} "
                             f"{tuple(t.shape)} (expected a contiguous {dt}"
                             f" [{K}] on the card)")
    if K < 1:
        raise ValueError("fk_score: no slot")
    h = [0] * K12_HEAD
    h[0:3] = [refcount.data_ptr(), alive.data_ptr(), K]
    for j, (name, t) in enumerate((("total", total), ("nrows", nrows))):
        if t.numel() != 1 or t.dtype not in (torch.int32, torch.int64,
                                             torch.float32) or \
                (card and not t.is_cuda):
            raise ValueError(f"fk_score: {name} must be one int or float "
                             f"element on the card")
        h[3 + 2 * j: 5 + 2 * j] = [t.data_ptr(), _DT[t.dtype]]
    for j, (name, v) in enumerate((("strength", strength),
                                   ("discount", discount))):
        if torch.is_tensor(v):
            if v.numel() != 1 or v.dtype != torch.float32 or \
                    (card and not v.is_cuda):
                raise ValueError(f"fk_score: {name} must be one float32 "
                                 f"element on the card")
            h[7 + 2 * j] = v.data_ptr()
        else:
            h[8 + 2 * j] = _f32_bits(v)
    we, _s = level_plan(ch_e.prog, ch_e.operands, ch_e.rank, card,
                        shape=full + (K,), fused=True)
    wn, _s = level_plan(ch_n.prog, ch_n.operands, ch_n.rank, card,
                        shape=full, fused=True)
    if K12_HEAD + len(we) + len(wn) > K12_WORDS:
        raise ValueError(f"fk_score: {K12_HEAD + len(we) + len(wn)} words "
                         f"(at most {K12_WORDS}; score_fusion sums ch_n "
                         f"first)")
    h[11:19] = [rec.data_ptr(), logz.data_ptr(), R,
                SCORE_PATHS.index(plan["path"]),
                32 if plan["path"] == "warp" else plan["threads"],
                plan["cluster"], max(we[_K20_KERNEL], wn[_K20_KERNEL]),
                K12_HEAD + len(we)]
    return h + we + wn


def _child_key(x) -> tuple:
    """(key, pointers) of a score kernel's child as it is handed in: a
    Level's _level_key at one row, or a tensor's structure and pointer (a
    one-step dense level, as_level: the same pointer)."""
    if isinstance(x, Level):
        return _level_key(x.prog, x.operands, x.rank, 1, x.label)
    return ("tensor", _tsig(x)), [x.data_ptr()]


def _fused_children(levels, ranks, fus: dict, ptrs: list, name: str):
    """The children as the score kernel takes them and their pointers:
    as handed in (as_level) where score_fusion cuts nothing; else the
    split counted, the K20 launches of score_fusion's stages made
    (_fuse_prepare), and the pointers of what they leave."""
    if not fus["split"]:
        return [as_level(x, r) for x, r in zip(levels, ranks)], ptrs
    _split(name)
    whole = [False, fus["n_first"]]
    lvs = [_fuse_prepare(x, r, w) for x, r, w in zip(levels, ranks, whole)]
    return lvs, [_level_key(lv.prog, lv.operands, lv.rank, 1, None)[1]
                 for lv in lvs]


def fk_score(refcount, alive, total, nrows, strength, discount, children,
             new_children, full, cls=None):
    """K12: fk_score_plain in one launch for one row, the child levels
    summed in it: refcount [K] int32 and alive [K] bool (or [1, K]), total
    and nrows one element (int32, int64 or float32), strength and
    discount device float32 scalars or Python numbers (words), children
    [.., K] and new_children [..]: Levels (evaluated in the launch, their
    tensors read in place) or float32 tensors (a one-step level). Returns
    (record [R, K + 1], logZ [R]). score_fusion's K20 launches first where
    a level is cut or ch_n does not fit (counted in SPLITS). The plan,
    with score_fusion's decision, is built once a structure of the call
    as handed in (_K12_PLANS) and each call writes its pointers into it.
    On CPU tensors the plain version; on CUDA ones the kernel or an
    error. Counted in LAUNCH_CENSUS by ("cls R e=shape kinds n=shape
    kinds", r1, K), `cls` the target class; its fields in
    CENSUS_FIELDS."""
    if not _route(refcount, "fk_score"):
        return fk_score_plain(refcount, alive, total, nrows, strength,
                              discount, children, new_children, full)
    return _fk_score(refcount, alive, total, nrows, strength, discount,
                     children, new_children, full, cls)


def _fk_score(refcount, alive, total, nrows, strength, discount, children,
              new_children, full, cls=None, path=None):
    """fk_score's launch on the card; `path` forces one of SCORE_PATHS
    (kernel_bench and chip_smoke check and time the other geometry): such
    a plan is built for the call and not kept."""
    full, R = _score_rows(full)
    ke, pe = _child_key(children)
    kn, pn = _child_key(new_children)
    key = (cls, full, _tsig(refcount), _tsig(alive), _tsig(total),
           _tsig(nrows), _tsig(strength), _tsig(discount), ke, kn)
    dev = refcount.device
    K = int(refcount.shape[-1])
    rec = torch.empty((R, K + 1), dtype=torch.float32, device=dev)
    logz = torch.empty((R,), dtype=torch.float32, device=dev)
    ent = _K12_PLANS.get(key) if path is None else None
    fus = ent[-1] if ent is not None else score_fusion(
        [children, new_children])
    if ent is None or fus["split"]:
        (ch_e, ch_n), (pe, pn) = _fused_children(
            [children, new_children], [len(full) + 1, len(full)], fus,
            [pe, pn], "fk_score")
    if ent is None:
        ent = _k12_entry(refcount, alive, total, nrows, strength, discount,
                         ch_e, ch_n, full, rec, logz, cls, fus, len(pe),
                         path)
        if path is None:
            if len(_K12_PLANS) >= _PLAN_CACHE_MAX:
                _K12_PLANS.clear()
            _K12_PLANS[key] = ent
    arr, addr, n, pos, plan, mode, fields, _fus = ent
    ptrs = [refcount.data_ptr(), alive.data_ptr(), total.data_ptr(),
            nrows.data_ptr(),
            strength.data_ptr() if torch.is_tensor(strength) else 0,
            discount.data_ptr() if torch.is_tensor(discount) else 0,
            rec.data_ptr(), logz.data_ptr()] + pe + pn
    for at, src in pos:
        arr[at] = ptrs[src]
    rc = _fn("fk_score")(addr, n, plan["threads"], plan["rows"],
                         *plan["grid"], _stream(rec))
    _check(rc, "fk_score")
    _count("fk_score", 1, K, mode, fields)
    return rec, logz


def _k12_entry(refcount, alive, total, nrows, strength, discount, ch_e,
               ch_n, full, rec, logz, cls, fus: dict, n_pe: int,
               path) -> tuple:
    """A _K12_PLANS entry: (words as an array.array, its address, its
    length, the pointer positions [(word, source)], the plan, the census
    mode and fields, score_fusion's decision); sources index the call's
    pointers (the head's 8, then ch_e's n_pe, then ch_n's)."""
    R, K = math.prod(full), int(refcount.shape[-1])
    plan = fk_score_plan(R, K, score_spread(R), path)
    words = fk_score_words(refcount, alive, total, nrows, strength,
                           discount, ch_e, ch_n, full, rec, logz, plan)
    pos = [(0, 0), (1, 1), (3, 2), (5, 3), (11, 6), (12, 7)]
    pos += [(7, 4)] if torch.is_tensor(strength) else []
    pos += [(9, 5)] if torch.is_tensor(discount) else []
    pos += _level_positions(ch_e.operands, K12_HEAD, 8)
    pos += _level_positions(ch_n.operands, words[18], 8 + n_pe)
    arr = array.array("q", words)
    fields = dict(R=R, K=K, full=full, sd=torch.is_tensor(strength),
                  counts=(total.dtype, nrows.dtype),
                  level_e=_level_fields(ch_e.prog, ch_e.operands, ch_e.rank,
                                        level_shape(ch_e.operands,
                                                    ch_e.rank)),
                  level_n=_level_fields(ch_n.prog, ch_n.operands, ch_n.rank,
                                        level_shape(ch_n.operands,
                                                    ch_n.rank)))
    return (arr, arr.buffer_info()[0], len(arr), pos, plan,
            _score_mode(cls, R, [ch_e, ch_n]), fields, fus)


def choice_score_plain(enum, children, full, obs_ld=None, obs=None,
                       state=0):
    """K13's plain version, score_choice's own arithmetic for one row:
    where the state is 1 the logits are the observation's delta (obs_ld at
    the option `obs`, NEG_INF elsewhere), otherwise enum [.., V]; the
    children [.., V] (a tensor, or a Level summed first by level_value:
    K20's plain version) added; the record [R, V] and logZ [R] over the
    enumeration rows `full` (enum_logsumexp_plain in choice mode). `state`
    a static code or a per-row tensor aligned like obs; obs None: no
    observation."""
    children = level_value(children)
    V = int(enum.shape[-1])
    dev = enum.device
    full = tuple(full)
    if obs is not None:
        ar = torch.arange(V, device=dev)
        delta = torch.where(ar == obs[..., None], obs_ld[..., None],
                            torch.full((), NINF, device=dev))
        st1 = state == 1 if torch.is_tensor(state) else torch.full(
            (1,) * len(full), state == 1, dtype=torch.bool, device=dev)
        logits = torch.where(st1[..., None], delta, enum)
    else:
        logits = enum
    total = (logits + children).expand(full + (V,))
    return enum_logsumexp_plain(total.reshape(-1, V).contiguous())


def _strided(t: torch.Tensor, shape: tuple, name: str, dtypes,
             card: bool = True) -> list:
    """The strides of t broadcast to `shape` (no copy): 0 on an axis it
    broadcasts over."""
    if t.dtype not in dtypes or (card and not t.is_cuda):
        raise ValueError(f"{name}: {t.dtype} on {t.device} (expected "
                         f"{dtypes} on the card)")
    return list(t.expand(shape).stride())


def _score_rows(full) -> tuple:
    full = tuple(int(n) for n in full)
    if not 1 <= len(full) <= _K12_MAX_DIMS:
        raise ValueError(f"score kernels: {len(full)} row axes (1 to "
                         f"{_K12_MAX_DIMS})")
    return full, math.prod(full)


def choice_score_words(enum, children: Level, full, obs_ld, obs, state,
                       rec, logz, plan: dict, card: bool = True) -> list:
    """K13's plan (csrc/choice_score.cu): the head (enum's, obs_ld's,
    obs's and the state's pointers, obs's dtype code, the static code, V,
    the row axes, the outputs, R, the geometry, the instantiation, enum's
    option stride, the row axes' sizes and each operand's strides over
    them), then the level's words over [full..., V] (level_plan, fused).
    Refuses what the kernel does not take, and, with `card`, tensors off
    the card."""
    full, R = _score_rows(full)
    nd = len(full)
    V = int(enum.shape[-1])
    h = [0] * K13_HEAD
    ens = _strided(enum, full + (V,), "choice_score enum", (torch.float32,),
                   card)
    h[0] = enum.data_ptr()
    h[15] = ens[nd]
    h[16:16 + nd] = list(full)
    h[24:24 + nd] = ens[:nd]
    if obs is not None:
        h[1] = obs_ld.data_ptr()
        h[2], h[3] = obs.data_ptr(), _DT[obs.dtype]
        h[32:32 + nd] = _strided(obs_ld, full, "choice_score obs_ld",
                                 (torch.float32,), card)
        h[40:40 + nd] = _strided(obs, full, "choice_score obs", _INDEX_DT,
                                 card)
    if torch.is_tensor(state):
        h[4] = state.data_ptr()
        h[48:48 + nd] = _strided(state, full, "choice_score state",
                                 (torch.int8,), card)
    else:
        h[5] = int(state)
    lw, _s = level_plan(children.prog, children.operands, children.rank,
                        card, shape=full + (V,), fused=True)
    h[6:15] = [V, nd, rec.data_ptr(), logz.data_ptr(), R,
               SCORE_PATHS.index(plan["path"]),
               32 if plan["path"] == "warp" else plan["threads"],
               plan["cluster"], lw[_K20_KERNEL]]
    return h + lw


def choice_score(enum, children, full, obs_ld=None, obs=None, state=0,
                 cls=None):
    """K13: choice_score_plain in one launch for one row, the child level
    summed in it: enum [.., V] float32, children a Level (evaluated in the
    launch, its tensors read in place) or a float32 tensor [.., V] (a
    one-step level), obs_ld float32 and obs (int8-int64) over the rows,
    state a static code or an int8 tensor over the rows, each read in
    place with its broadcast strides over `full`. Returns (record [R, V],
    logZ [R]). A level level_stages cuts has its earlier stages summed by
    K20 first (counted in SPLITS). The plan, with score_fusion's
    decision, is built once a structure of the call as handed in
    (_K13_PLANS) and each call writes its pointers into it. On CPU
    tensors the plain version; on CUDA ones the kernel or an error.
    Counted in LAUNCH_CENSUS by ("cls R shape kinds", r1, V); its fields
    in CENSUS_FIELDS."""
    if not _route(enum, "choice_score"):
        return choice_score_plain(enum, children, full, obs_ld, obs, state)
    return _choice_score(enum, children, full, obs_ld, obs, state, cls)


def _choice_score(enum, children, full, obs_ld=None, obs=None, state=0,
                  cls=None, path=None):
    """choice_score's launch on the card; `path` as _fk_score's."""
    full, R = _score_rows(full)
    kl, pl = _child_key(children)
    if obs is None:
        obs_ld = None
    key = (cls, full, _tsig(enum), _tsig(obs_ld), _tsig(obs), _tsig(state),
           kl)
    V = int(enum.shape[-1])
    rec = torch.empty((R, V), dtype=torch.float32, device=enum.device)
    logz = torch.empty((R,), dtype=torch.float32, device=enum.device)
    ent = _K13_PLANS.get(key) if path is None else None
    fus = ent[-1] if ent is not None else score_fusion([children])
    if ent is None or fus["split"]:
        (ch,), (pl,) = _fused_children([children], [len(full) + 1], fus,
                                       [pl], "choice_score")
    if ent is None:
        ent = _k13_entry(enum, ch, full, obs_ld, obs, state, rec, logz, cls,
                         fus, path)
        if path is None:
            if len(_K13_PLANS) >= _PLAN_CACHE_MAX:
                _K13_PLANS.clear()
            _K13_PLANS[key] = ent
    arr, addr, n, pos, plan, mode, fields, _fus = ent
    ptrs = [enum.data_ptr(), 0 if obs is None else obs_ld.data_ptr(),
            0 if obs is None else obs.data_ptr(),
            state.data_ptr() if torch.is_tensor(state) else 0,
            rec.data_ptr(), logz.data_ptr()] + pl
    for at, src in pos:
        arr[at] = ptrs[src]
    rc = _fn("choice_score")(addr, n, plan["threads"], plan["rows"],
                             *plan["grid"], _stream(rec))
    _check(rc, "choice_score")
    _count("choice_score", 1, V, mode, fields)
    return rec, logz


def _k13_entry(enum, ch, full, obs_ld, obs, state, rec, logz, cls,
               fus: dict, path) -> tuple:
    """A _K13_PLANS entry, as _k12_entry's; sources index the call's
    pointers (the head's 6, then the level's)."""
    R, V = math.prod(full), int(enum.shape[-1])
    plan = choice_score_plan(R, V, score_spread(R), path)
    words = choice_score_words(enum, ch, full, obs_ld, obs, state, rec,
                               logz, plan)
    pos = [(0, 0), (8, 4), (9, 5)]
    pos += [(1, 1), (2, 2)] if obs is not None else []
    pos += [(4, 3)] if torch.is_tensor(state) else []
    pos += _level_positions(ch.operands, K13_HEAD, 6)
    arr = array.array("q", words)
    fields = dict(R=R, K=V, full=full,
                  obs=None if obs is None else obs.dtype,
                  state="rows" if torch.is_tensor(state) else int(state),
                  level=_level_fields(ch.prog, ch.operands, ch.rank,
                                      level_shape(ch.operands, ch.rank)))
    return (arr, arr.buffer_info()[0], len(arr), pos, plan,
            _score_mode(cls, R, [ch]), fields, fus)


_K12_PLANS: dict = {}
_K13_PLANS: dict = {}
# K15's entries by call structure (_k15_plan)
_K15_PLANS: dict = {}


# ---------------------------------------------------------------- K14, K15

# K14's plan (csrc/rel_scatter.cu): a header, then each side's fixed-size
# record with its chain of up to K14_MAX_HOPS columns; cascade mode's fk
# records follow the header
K14_MAX_HOPS, K14_MAX_SIDES, K14_MAX_FKS = 4, 2, 8
K14_HEAD, K14_SIDE = 16, 16 + 3 * K14_MAX_HOPS
K14_KINDS = ("refcount", "prop", "delta", "cascade")
_K14_CODE_DT = (torch.int32, torch.int64, torch.float32)
# K14's routes of scatter mode (csrc/rel_scatter.cu): a thread a source, or
# a histogram in each block's shared memory (blocks of K14_HIST_THREADS,
# K14_UNIT sources a thread a round of the grid-stride loop) for a
# refcount-shaped spec: at least K14_HIST_MIN sources and K14_HIST_RATIO a
# target, where the histogram was faster than a thread a source over
# kernel_bench's K14_ROUTE_GRID (PERF.md section 6)
K14_ROUTES = ("thread", "local")
K14_THREADS, K14_HIST_THREADS, K14_UNIT = 256, 1024, 4
K14_SMEM_MAX = SMEM_MAX - 1024   # a histogram block's dynamic shared memory
K14_HIST_MIN, K14_HIST_RATIO = 1 << 15, 16
# K15's plan (csrc/batch_write.cu): a header, then one record a column;
# its launch (batch_write_plan): clusters of up to K15_CLUSTER blocks of
# K15_THREADS (a block for each K15_CLUSTER_ROWS rows), at most one block
# an SM, each cluster owning a share of the call's columns, K15_UNROLL_W
# rows a thread a round of its writes; the parent's scatter-only entry
# (kernel_bench's yardstick) takes a K15_SCATTER_HEAD-word header and
# K15_SCATTER_COL words a column
K15_HEAD, K15_COL, K15_MAX_COLS = 12, 8, 48
K15_THREADS, K15_UNROLL_W, K15_MIN_SHARE = 512, 8, 1 << 13
K15_CLUSTER, K15_CLUSTER_ROWS, K15_MAX_BLOCKS = 8, 1024, 256
K15_SCATTER_HEAD, K15_SCATTER_COL = 8, 6
_SHORT = {torch.bool: "b", torch.int8: "i8", torch.uint8: "u8",
          torch.int16: "i16", torch.int32: "i32", torch.int64: "i64",
          torch.float32: "f32", torch.float64: "f64"}


def scatter_side(hops=(), alive=None, state=None, weight=None, code=None,
                 sign: int = 1, exclude: bool = False) -> dict:
    """One side of a K14 scatter: the fk columns followed from each
    source slot s to its target (none: the target is s), the weight's
    factors at s (alive [bool], state == 1, s != the excluded slot where
    `exclude`, times an integer weight), the code source read at s where
    the weight is > 0, and the sign the weight is added with."""
    return dict(hops=list(hops), alive=alive, state=state, weight=weight,
                code=code, sign=int(sign), exclude=bool(exclude))


def _k14_sig(kind, n, src_len, sides, code, slots, exclude) -> str:
    """K14's LAUNCH_CENSUS mode: the kind, sources, source length, each
    side (sign, factors a = alive, s = state, x = exclusion, w = weight,
    c = code; each hop column's length, q where it is int64), the code's
    dtype and `idx` where the sources are slots."""
    parts = []
    for sd in sides:
        f = "".join(k for k, on in (
            ("a", sd["alive"] is not None), ("s", sd["state"] is not None),
            ("x", sd["exclude"] and exclude is not None),
            ("w", sd["weight"] is not None),
            ("c", sd["code"] is not None and code is not None)) if on)
        hops = ",".join(f"{h.shape[0]}{'q' if h.dtype == torch.int64 else ''}"
                        for h in sd["hops"])
        parts.append(f"{sd['sign']:+d}{f}:{hops}")
    return (f"{kind} n={n} src={src_len} {'/'.join(parts)} "
            f"{_SHORT[code.dtype] if code is not None else '-'}"
            f"{' idx' if slots is not None else ''}")


def rel_scatter_plain(kind: str, cnt, code, sides, n: int, slots=None,
                      exclude=None, src_len=None) -> None:
    """K14's plain version, in place: for each of n sources, its slot s
    (i, or slots[i] clamped into [0, src_len) as take() clamps it), and for
    each side in order, w = its factors at s, t = its fk chain followed
    from s; cnt.at[t].add(sign w, mode="drop") and, where the side and the
    call have a code, code.at[t].max(w > 0 ? code source[s] : 0,
    mode="drop") (utils.scatter_add_drop, scatter_max_drop)."""
    dev = cnt.device
    if slots is None:
        s = torch.arange(n, device=dev)
    else:
        s = slots.long().reshape(-1).clamp(0, src_len - 1)
    for sd in sides:
        m = torch.ones((n,), dtype=torch.bool, device=dev)
        if sd["alive"] is not None:
            m = m & take(sd["alive"], s)
        if sd["state"] is not None:
            m = m & (take(sd["state"], s) == 1)
        if sd["exclude"] and exclude is not None:
            m = m & (s != exclude)
        w = m.to(torch.int32)
        if sd["weight"] is not None:
            w = w * take(sd["weight"], s).to(torch.int32)
        t = s
        for col in sd["hops"]:
            t = take(col, t)
        cnt.copy_(scatter_add_drop(cnt, t, sd["sign"] * w))
        if code is not None and sd["code"] is not None:
            v = torch.where(w > 0, take(sd["code"], s).to(code.dtype),
                            torch.zeros((), dtype=code.dtype, device=dev))
            code.copy_(scatter_max_drop(code, t, v))


def _k14_hist_spec(sides, code, slots) -> bool:
    """Whether the histogram route takes a spec: one side with no state,
    weight or code, one int32 or int64 fk column, no slots."""
    if len(sides) != 1 or slots is not None:
        return False
    sd = sides[0]
    return len(sd["hops"]) == 1 and sd["state"] is None and \
        sd["weight"] is None and (code is None or sd["code"] is None) and \
        sd["hops"][0].dtype in (torch.int32, torch.int64)


def _k14_blocks(route: str, n: int, sms: int = N_SMS) -> int:
    """The blocks of K14's launch of n sources on `route`: a thread a
    source, or min(sms, the blocks n sources fill) histogram blocks."""
    if route == "thread":
        return -(-n // K14_THREADS)
    return max(1, min(sms, -(-n // (K14_HIST_THREADS * K14_UNIT))))


def rel_scatter_plan(n: int, C: int, sides, code, slots=None,
                     sms: int = N_SMS) -> dict:
    """K14's launch of a scatter of n sources into C targets (`sides`:
    scatter_side()s, `code`: the code tensor or None, `slots`: the
    sources' slots or None). The route is "local" (a histogram in each
    block's shared memory, blocks of K14_HIST_THREADS) for a
    refcount-shaped spec (_k14_hist_spec) of at least K14_HIST_MIN
    sources, K14_HIST_RATIO or more a target, whose C counts fit in a
    block's shared memory; else "thread" (a thread a source).
    Returns dict(route, blocks, threads, smem, launches)."""
    local = _k14_hist_spec(sides, code, slots) and \
        4 * C <= K14_SMEM_MAX and n >= K14_HIST_MIN and \
        n >= K14_HIST_RATIO * C
    route = "local" if local else "thread"
    return dict(route=route, blocks=_k14_blocks(route, n, sms),
                threads=K14_HIST_THREADS if local else K14_THREADS,
                smem=4 * C if local else 0, launches=1)


def _k14_vec(t, name: str, n=None, dtypes=None) -> None:
    if not t.is_cuda or t.dim() != 1 or not t.is_contiguous() or \
            t.dtype not in _DT or (dtypes is not None and
                                   t.dtype not in dtypes) or \
            (n is not None and t.shape[0] != n):
        raise ValueError(f"rel_scatter: {name} is {t.dtype} "
                         f"{tuple(t.shape)} on {t.device} (expected a "
                         f"contiguous 1-d tensor on the card"
                         f"{'' if n is None else f' of {n}'}"
                         f"{'' if dtypes is None else f', {dtypes}'})")


def rel_scatter(kind: str, cnt, code, sides, n: int, slots=None,
                exclude=None, src_len=None) -> None:
    """K14: rel_scatter_plain's scatters in one launch, in place on cnt
    (int32 [C]) and code ([C] int32, int64 or float32, or None), which the
    caller owns, with the drop rule inside the kernel. `sides`: one or two
    scatter_side()s (a side's chain of more than K14_MAX_HOPS columns
    first folded by K18, fold_chain, into a column over the sources that
    the call owns); `slots`: int64 [n] source slots, or None for sources
    0..n-1; `exclude`: the excluded source slot, an int or an int64 [1]
    tensor on the card (read there, so the host never waits for it).
    The launch is rel_scatter_plan's.
    On CPU tensors the plain version; on CUDA ones the kernel or an error.
    Counted in LAUNCH_CENSUS by (the spec's signature, r1 or rn, C)."""
    if src_len is None:
        src_len = n
    if not _route(cnt, "rel_scatter"):
        return rel_scatter_plain(kind, cnt, code, sides, n, slots, exclude,
                                 src_len)
    words, keep, run = k14_words(kind, cnt, code, sides, n, slots, exclude,
                                 src_len)
    plan = rel_scatter_plan(n, cnt.shape[0], run, code, slots,
                            sm_count(cnt.device))
    words[13] = K14_ROUTES.index(plan["route"])
    words[15] = plan["blocks"]
    arr = (ctypes.c_int64 * len(words))(*words)
    rc = _fn("rel_scatter")(arr, len(arr), _stream(cnt))
    _check(rc, "rel_scatter")
    _count("rel_scatter", n, cnt.shape[0],
           _k14_sig(kind, n, src_len, run, code, slots, exclude))


def k14_words(kind: str, cnt, code, sides, n: int, slots, exclude,
              src_len: int) -> tuple:
    """rel_scatter's checks and plan words (csrc/rel_scatter.cu) but the
    route (word 13) and its blocks (word 15): (words, the contiguous
    copies and folded columns the launch reads, the sides as launched)."""
    if kind not in K14_KINDS[:3]:
        raise ValueError(f"rel_scatter: kind {kind!r} is not one of "
                         f"{K14_KINDS[:3]}")
    if not 1 <= len(sides) <= K14_MAX_SIDES or n < 0 or src_len < 1:
        raise ValueError(f"rel_scatter: {len(sides)} sides, n {n}, source "
                         f"length {src_len}")
    _k14_vec(cnt, "cnt", dtypes=(torch.int32,))
    C = cnt.shape[0]
    if code is not None:
        _k14_vec(code, "code", C, _K14_CODE_DT)
    words = [0] * (K14_HEAD + K14_SIDE * len(sides))
    words[1], words[4], words[5], words[8] = n, src_len, cnt.data_ptr(), C
    if slots is not None:
        _k14_vec(slots, "slots", n, (torch.int64,))
        words[2], words[3] = slots.data_ptr(), _DT[slots.dtype]
    if code is not None:
        words[6], words[7] = code.data_ptr(), _DT[code.dtype]
    if torch.is_tensor(exclude):
        if not exclude.is_cuda or exclude.dtype != torch.int64 or \
                exclude.numel() != 1:
            raise ValueError("rel_scatter: exclude must be an int64 [1] "
                             "tensor on the card")
        words[9] = exclude.data_ptr()
    elif exclude is not None:
        words[10], words[11] = int(exclude), 1
    words[12] = len(sides)
    keep = []   # contiguous copies stay alive until the launch is queued
    run = []    # the sides as launched (long chains folded)
    for k, sd in enumerate(sides):
        b = K14_HEAD + K14_SIDE * k
        if sd["sign"] not in (1, -1):
            raise ValueError(f"rel_scatter: sign {sd['sign']}")
        if len(sd["hops"]) > K14_MAX_HOPS:   # a long chain in stages (K18)
            _k14_vec(sd["hops"][0], "hop column", src_len, _INDEX_DT)
            first, rest = fold_chain(sd["hops"][0], sd["hops"][1:],
                                     K14_MAX_HOPS - 1, caller="rel_scatter")
            sd = dict(sd, hops=[first] + rest)
            keep.append(first)
        run.append(sd)
        words[b], words[b + 1] = sd["sign"], len(sd["hops"])
        for j, (key, dts) in enumerate((
                ("alive", (torch.bool,)), ("state", _INDEX_DT),
                ("weight", _INDEX_DT), ("code", _DT))):
            t = sd[key]
            if t is None:
                continue
            t = t.contiguous()
            keep.append(t)
            _k14_vec(t, key, src_len, tuple(dts))
            w = (2, 3, 5, 7)[j]
            words[b + w] = t.data_ptr()
            if key != "alive":
                words[b + w + 1] = _DT[t.dtype]
        words[b + 9] = int(sd["exclude"])
        for j, h in enumerate(sd["hops"]):
            _k14_vec(h, "hop column", src_len if j == 0 else None,
                     _INDEX_DT)
            words[b + 16 + 3 * j: b + 19 + 3 * j] = \
                [h.data_ptr(), _DT[h.dtype], h.shape[0]]
    return words, keep, run


def rel_cascade_plain(d, refcount, alive, fks):
    """K14's cascade mode, plain: one latent class's pending refcount
    delta d applied (_cascade's body): returns (refcount + d, its > 0,
    int64 [2] = (sum of d, sum of the alive flips)); each (fk column,
    pending delta of its target class) in `fks` gets the flips scattered
    in place (mode="drop")."""
    rc = refcount + d
    now = rc > 0
    flip = now.to(torch.int32) - alive.to(torch.int32)
    for col, pend in fks:
        pend.copy_(scatter_add_drop(pend, col, flip))
    return rc, now, torch.stack([torch.sum(d), torch.sum(flip)])


def rel_cascade(d, refcount, alive, fks, cls=None):
    """K14 in cascade mode: rel_cascade_plain in one launch a
    cascade_groups range of fk columns (one for up to K14_MAX_FKS),
    refcount and alive written into new tensors (torch.empty), the sums
    into a zeroed int64 [2] by atomics, the flips into each pending delta
    in place. On CPU tensors the plain version; on CUDA ones the kernel or
    an error. Counted in LAUNCH_CENSUS by ("cascade cls fks", r1 or rn,
    C), once a launch."""
    if not _route(d, "rel_cascade"):
        return rel_cascade_plain(d, refcount, alive, fks)
    _k14_vec(d, "d", dtypes=(torch.int32,))
    C = d.shape[0]
    _k14_vec(refcount, "refcount", C, (torch.int32,))
    _k14_vec(alive, "alive", C, (torch.bool,))
    for col, pend in fks:
        _k14_vec(col, "fk column", C, _INDEX_DT)
        _k14_vec(pend, "pending delta", dtypes=(torch.int32,))
    rc = torch.empty_like(refcount)
    now = torch.empty_like(alive)
    acc = torch.zeros((2,), dtype=torch.int64, device=d.device)
    groups = cascade_groups(len(fks))
    if len(groups) > 1:
        _split("rel_cascade")
    for k, (lo, hi) in enumerate(groups):
        # the first launch writes the refcount, alive and sums; the later
        # ones only scatter their group's flips (the same flips: every
        # launch reads d, refcount and alive, which none writes)
        out = [rc.data_ptr(), now.data_ptr(), acc.data_ptr()] if k == 0 \
            else [0, 0, 0]
        words = [1, C, d.data_ptr(), refcount.data_ptr(),
                 alive.data_ptr()] + out + [hi - lo] + [0] * (K14_HEAD - 9)
        for col, pend in fks[lo:hi]:
            words += [col.data_ptr(), _DT[col.dtype], pend.data_ptr(),
                      pend.shape[0]]
        arr = (ctypes.c_int64 * len(words))(*words)
        rc_ = _fn("rel_scatter")(arr, len(arr), _stream(d))
        _check(rc_, "rel_scatter")
        _count("rel_scatter", C, C, f"cascade {cls} fks={hi - lo}")
    return rc, now, acc


def cascade_groups(n: int) -> list:
    """K14's cascade launches for a class with n fk columns: the (first,
    end) fk ranges of each, in order, at most K14_MAX_FKS a launch (one
    launch for a class with none). Integer scatters are order-free, so the
    split adds what one launch would."""
    return [(i, min(n, i + K14_MAX_FKS))
            for i in range(0, max(n, 1), K14_MAX_FKS)]


def batch_write_plain(cols, vals, slots, ok, alive=None) -> tuple:
    """K15's plain version, out of place as smc._apply_batch: (new
    columns, new alive or None), each column cols[c] with vals[c] [B]
    converted to its dtype (torch's .to) at the slots where ok, and alive,
    where given, True there; slots follow mode="drop"
    (utils.index_set_where). The inputs are left as they were."""
    new = [index_set_where(col, slots, v.reshape(-1).to(col.dtype), ok)
           for col, v in zip(cols, vals)]
    return new, (None if alive is None
                 else index_set_where(alive, slots, True, ok))


def batch_write_chunks(n: int) -> list:
    """K15's launches for n destination columns (the alive bit counted as
    one): the (first, end) column ranges of each, in order, at most
    K15_MAX_COLS a launch. Each column is copied and written by exactly
    one launch, from inputs no launch changes, so the split writes what
    one launch would."""
    return [(i, min(n, i + K15_MAX_COLS))
            for i in range(0, max(n, 1), K15_MAX_COLS)]


def batch_write_plan(nbytes: list, sms: int, rows: int = 0) -> dict:
    """K15's launch for columns of `nbytes` bytes each and `rows` rows: the
    columns laid end to end in one byte space, each at a 16-byte boundary
    (`offsets`, `total` the padded end); `clusters` thread-block clusters
    of `cluster` blocks of K15_THREADS, `blocks` in all, at most `sms` (and
    K15_MAX_BLOCKS). Cluster q owns `share` bytes of the space (a multiple
    of 16 x cluster): [q share, (q + 1) share); its block j copies the
    j-th `share` / cluster bytes of it and takes the j-th part of the rows;
    `touches`[q] = (the first, the last) column the share touches ((n, -1)
    for none).
    - A copy that fills half the card at K15_MIN_SHARE bytes a block takes
      clusters of one block, a block an SM (clusters of more blocks, all
      scheduled together, left SMs idle on such a copy).
    - Otherwise each cluster splits its rows over up to K15_CLUSTER
      blocks, a block for each K15_CLUSTER_ROWS rows, so that no block
      reads a large batch alone.
    - Enough clusters that each block's part is at least K15_MIN_SHARE,
      and that each cluster's writes (its rows against each column its
      share touches) come to about one round a column: a cluster a column
      where the columns are small."""
    offsets, o = [], 0
    for n in nbytes:
        offsets.append(o)
        o += -(-n // 16) * 16
    per = K15_THREADS * K15_UNROLL_W
    sms = max(1, min(sms, K15_MAX_BLOCKS))
    cl = 1 if 2 * (o // K15_MIN_SHARE) >= sms else \
        max(1, min(K15_CLUSTER, sms, -(-rows // K15_CLUSTER_ROWS), o // 16))
    want = max(1, min(sms // cl, max(o // (cl * K15_MIN_SHARE),
                                     len(nbytes) * -(-rows // (cl * per)))))
    unit = 16 * cl
    share = max(unit, -(-(-(-o // want)) // unit) * unit)
    clusters = max(1, -(-o // share))
    ends = [off + n for off, n in zip(offsets, nbytes)]
    touches = []
    for q in range(clusters):
        lo, hi = q * share, min((q + 1) * share, o)
        ca = bisect.bisect_right(ends, lo)
        cb = max((c for c in range(bisect.bisect_left(offsets, hi) - 1, -1,
                                   -1) if ends[c] > offsets[c]), default=-1)
        touches.append((ca, cb))
    return dict(offsets=offsets, total=o, share=share, cluster=cl,
                clusters=clusters, blocks=clusters * cl, touches=touches)


def _k15_launches(dsts, vdts, B: int, sms: int) -> list:
    """K15's launches for new columns shaped as `dsts` (the alive bit's
    among them), values of dtypes `vdts` (None: the alive bit's True), B
    rows and `sms` SMs: one (lo, hi, words, plan) a batch_write_chunks
    range of columns, the words an array.array in csrc/batch_write.cu's
    layout with every pointer 0 (_k15_point writes a call's): the header
    [columns, B, slots, ok, share, total, blocks a cluster n, share / n,
    ceil(B / n), rows a thread a round (2 up to 2 x K15_THREADS rows a
    block, else K15_UNROLL_W: a kernel instance each), 0, 0], then each
    column [src, dst, dtype, length, values or 0, values' dtype, byte
    offset, 16-byte aligned], then a word a block: its cluster's first
    column | (its last + 1) << 32."""
    out = []
    for lo, hi in batch_write_chunks(len(dsts)):
        plan = batch_write_plan([d.numel() * d.element_size()
                                 for d in dsts[lo:hi]], sms, B)
        cl = plan["cluster"]
        per = -(-B // cl)
        words = [hi - lo, B, 0, 0, plan["share"], plan["total"], cl,
                 plan["share"] // cl, per,
                 2 if per <= 2 * K15_THREADS else K15_UNROLL_W, 0, 0]
        for dst, vdt, off in zip(dsts[lo:hi], vdts[lo:hi], plan["offsets"]):
            words += [0, 0, _DT[dst.dtype], dst.shape[0], 0,
                      0 if vdt is None else _DT[vdt], off, 0]
        words += [ca | (cb + 1) << 32 for ca, cb in plan["touches"]
                  for _j in range(cl)]
        out.append((lo, hi, array.array("q", words), plan))
    return out


def _k15_point(launches, srcs, dsts, vals, slots, ok) -> None:
    """This call's pointers written into its launches' words: slots and ok,
    and each column's source, destination and values (0 for the alive
    bit), with its 16-byte alignment flag (the kernel's vector copy)."""
    sps = [t.data_ptr() for t in srcs]
    dps = [t.data_ptr() for t in dsts]
    vps = [0 if v is None else v.data_ptr() for v in vals]
    sp, op = slots.data_ptr(), ok.data_ptr()
    for lo, hi, w, _plan in launches:
        end = K15_HEAD + K15_COL * (hi - lo)
        w[2], w[3] = sp, op
        w[K15_HEAD:end:K15_COL] = array.array("q", sps[lo:hi])
        w[K15_HEAD + 1:end:K15_COL] = array.array("q", dps[lo:hi])
        w[K15_HEAD + 4:end:K15_COL] = array.array("q", vps[lo:hi])
        w[K15_HEAD + 7:end:K15_COL] = array.array(
            "q", [int(x % 16 == 0 and y % 16 == 0)
                  for x, y in zip(sps[lo:hi], dps[lo:hi])])


def batch_write_words(srcs, dsts, vals, slots, ok, sms: int) -> list:
    """K15's launches for copying each srcs[c] into dsts[c] and writing
    vals[c] ([B], or None for the alive bit: True) at slots where ok:
    _k15_launches' (lo, hi, words, plan) with this call's pointers
    written. Pointers are the tensors' own, on whatever device they lie
    (the CPU tests read them there)."""
    launches = _k15_launches(dsts, [None if v is None else v.dtype
                                    for v in vals], slots.shape[0], sms)
    _k15_point(launches, srcs, dsts, vals, slots, ok)
    return launches


def _k15_plan(srcs, vals, slots, ok, cls) -> tuple:
    """The _K15_PLANS entry of this call's structure (slots', ok's, each
    column's and each value's dtype, shape, stride and card; the class),
    built and checked by _k15_entry at its first call."""
    try:
        key = (cls, slots.dtype, slots.shape, slots.stride(),
               slots.get_device(), ok.dtype, ok.shape, ok.get_device(),
               tuple((t.dtype, t.shape, t.stride(), t.get_device())
                     for t in srcs),
               tuple(None if v is None else
                     (v.dtype, v.shape, v.stride(), v.get_device())
                     for v in vals))
    except AttributeError:   # (a value that is no tensor: _k15_entry says)
        return _k15_entry(srcs, vals, slots, ok, cls)
    ent = _K15_PLANS.get(key)
    if ent is None:
        ent = _k15_entry(srcs, vals, slots, ok, cls)
        if len(_K15_PLANS) >= _PLAN_CACHE_MAX:
            _K15_PLANS.clear()
        _K15_PLANS[key] = ent
    return ent


def _k15_entry(srcs, vals, slots, ok, cls) -> tuple:
    """A _K15_PLANS entry: (B, the card, the new columns' blocks [(dtype,
    length, the columns, stacked)], the values a call makes contiguous,
    _k15_launches' launches, each launch's census mode): the new columns
    of one dtype and length are the rows of one [columns, length]
    allocation where its rows fall on 16-byte boundaries (stacked), else
    an allocation each. Raises for what the kernel does not take."""
    B = slots.shape[0] if slots.dim() == 1 else -1
    if not slots.is_cuda or slots.dtype != torch.int64 or B < 0 or \
            not slots.is_contiguous():
        raise ValueError(f"batch_write: slots must be int64 [B] on the "
                         f"card, got {slots.dtype} {tuple(slots.shape)}")
    if not ok.is_cuda or ok.dtype != torch.bool or ok.shape != (B,):
        raise ValueError(f"batch_write: ok must be bool [{B}] on the card")
    sig, fix, by_shape = [], [], {}
    for i, (src, v) in enumerate(zip(srcs, vals)):
        if not torch.is_tensor(src) or not src.is_cuda or src.dim() != 1 \
                or not src.is_contiguous() or src.dtype not in _DT:
            raise ValueError(f"batch_write: column "
                             f"{getattr(src, 'dtype', src)} "
                             f"{tuple(getattr(src, 'shape', ()))} on "
                             f"{getattr(src, 'device', None)}")
        if v is not None and (not torch.is_tensor(v) or not v.is_cuda or
                              v.numel() != B or v.dtype not in _DT):
            raise ValueError(f"batch_write: values "
                             f"{getattr(v, 'dtype', v)} "
                             f"{tuple(getattr(v, 'shape', ()))} on "
                             f"{getattr(v, 'device', None)} (expected "
                             f"[{B}] on the card)")
        if v is not None and not v.is_contiguous():
            fix.append(i)
        sig.append("alive" if v is None
                   else f"{_SHORT[src.dtype]}<{_SHORT[v.dtype]}")
        by_shape.setdefault((src.dtype, src.shape[0]), []).append(i)
    blocks = [(dt, n, idx, len(idx) > 1 and
               n * srcs[idx[0]].element_size() % 16 == 0)
              for (dt, n), idx in by_shape.items()]
    launches = _k15_launches(srcs, [None if v is None else v.dtype
                                    for v in vals], B, sm_count(slots.device))
    cap = srcs[0].shape[0] if srcs else 0
    modes = [f"{cls} cap={cap} {','.join(sig[lo:hi])}"
             for lo, hi, _w, _p in launches]
    return B, slots.device, blocks, fix, launches, modes


def batch_write(cols, vals, slots, ok, alive=None, cls=None) -> tuple:
    """K15: batch_write_plain's new columns in one launch a
    batch_write_chunks range (one for up to K15_MAX_COLS columns, the
    alive bit counted as one): every column copied into a new tensor and
    the kept rows' values written there, every index and mask read on the
    card and the drop rule inside the kernel; the caller's columns are not
    written. The new columns of one dtype and length are the rows of one
    allocation where they can be (_k15_entry's blocks). slots int64 [B],
    ok bool [B], vals [B] of any dtype of ops._DT. The plan is cached by
    the call's structure (_K15_PLANS). On CPU tensors the plain version;
    on CUDA ones the kernel or an error. Returns (new columns, new alive
    or None). Counted in LAUNCH_CENSUS by ("cls cap=C dst<src,...[,alive]",
    r1 or rn, B), once a launch; a call with no column launches nothing."""
    if not _route(slots, "batch_write"):
        return batch_write_plain(cols, vals, slots, ok, alive)
    srcs = list(cols) + ([alive] if alive is not None else [])
    vs = list(vals) + ([None] if alive is not None else [])
    B, dev, blocks, fix, launches, modes = _k15_plan(srcs, vs, slots, ok,
                                                     cls)
    if not srcs:
        return [], None
    for i in fix:
        vs[i] = vs[i].reshape(-1).contiguous()
    ok = ok.contiguous()
    dsts = [None] * len(srcs)
    for dt, n, idx, stacked in blocks:
        new = torch.empty((len(idx), n), dtype=dt, device=dev).unbind(0) \
            if stacked else [torch.empty((n,), dtype=dt, device=dev)
                             for _i in idx]
        for i, t in zip(idx, new):
            dsts[i] = t
    _k15_point(launches, srcs, dsts, vs, slots, ok)
    if len(launches) > 1:
        _split("batch_write")
    fn, stream = _fn("batch_write"), _stream(slots)
    for (_lo, _hi, words, _plan), mode in zip(launches, modes):
        _check(fn(words.buffer_info()[0], len(words), stream),
               "batch_write")
        _count("batch_write", B, B, mode)
    if alive is None:
        return dsts, None
    return dsts[:-1], dsts[-1]


# ---------------------------------------------------------------- K16-K19

# the plans' word counts and limits (csrc/fk_sample.cu, choice_sample.cu,
# row_gather.cu, branch_select.cu)
# ancestor axes of a record the sample kernels take: a record has at most
# K20_MAX_DIMS axes, the rows and the drawn axis among them; each axis's
# words (stride, size, pointer, dtype) sit at the end of a K16/K17 plan,
# from word K16_X / K17_X
_MAX_ANC, _ANC_WORDS = 7, 4
K16_X, K17_X = 29, 17
K16_WORDS = K16_X + _ANC_WORDS * _MAX_ANC
K17_WORDS = K17_X + _ANC_WORDS * _MAX_ANC
K17_MODES = ("draw", "retained", "pick")
# K18's plan (csrc/row_gather.cu): a header (the slot tensor's count,
# rank, pointer, dtype, contiguity, sizes and strides; the counts of nodes
# and chains; the class), the class's node slots for the group's
# hop-column tree (a node's column, dtype, length and parent: 0 the slot, k
# node k - 1) and its chain slots (a chain's node, the leaf's pointer and
# length, the output's pointer, the element size). The classes, (nodes,
# chains) each, are the kernel's instantiations: the smallest that holds a
# launch takes it. A chain follows at most K18_MAX_HOPS hops, longer ones
# fold first
K18_MAX_DIMS, K18_MAX_HOPS = 8, 4
K18_CLASSES = ((2, 4), (4, 8), (8, 16))
K18_MAX_NODES, K18_MAX_CHAINS = K18_CLASSES[-1]
K18_HEAD, K18_NODE, K18_CHAIN = 24, 4, 5
K18_WORDS = K18_HEAD + K18_NODE * K18_MAX_NODES + K18_CHAIN * K18_MAX_CHAINS
# K19's plan (csrc/branch_select.cu): a header (pairs, B, is_new), then
# each pair's new, existing and output pointers and a word of dtypes and
# broadcast bits; one parameter block of K19_MAX_PAIRS pairs (the
# census's plans take 1-25), more pairs go in launches of that many
K19_HEAD, K19_PAIR, K19_MAX_PAIRS = 3, 4, 64


def pick_plain(rec, anc, B: int):
    """rec at each row's ancestor positions (BlockTracer._pick): rec [B or
    1, a_1..a_d, ...] and d index tensors [B] -> [B, ...], each index
    clamped into its axis as JAX's gather clamps it."""
    rec = rec.expand((B,) + tuple(rec.shape[1:]))
    if not anc:
        return rec
    bidx = torch.arange(B, device=rec.device)
    return rec[(bidx,) + tuple(a.long().reshape(-1).clamp(0, rec.shape[1 + i] - 1)
                               for i, a in enumerate(anc))]


def _rec_words(rec, anc, B: int, name: str, tail: int) -> tuple:
    """(rec, words 5-7 of a K16/K17 plan, the ancestor axes' words,
    _ANC_WORDS an axis, zero-padded to _MAX_ANC axes): the record's
    pointer, its ancestor count and row stride, then each axis's stride
    (in elements, of rec expanded to B rows), size, and its ancestor's
    pointer and dtype. `tail` is the number of axes after the ancestor
    axes (1: a row of logits, 0: one value); a row of logits must have
    stride 1 (else the record is made contiguous)."""
    if len(anc) > _MAX_ANC or rec.dim() != 1 + len(anc) + tail:
        raise ValueError(f"{name}: a record of {rec.dim()} axes with "
                         f"{len(anc)} ancestors (at most {_MAX_ANC})")
    if not rec.is_cuda or rec.dtype not in _DT or rec.shape[0] not in (1, B):
        raise ValueError(f"{name}: record {rec.dtype} {tuple(rec.shape)} on "
                         f"{rec.device} (expected [1 or {B}, ...] on the card)")
    if tail and rec.stride(-1) != 1:
        rec = rec.contiguous()
    st = rec.expand((B,) + tuple(rec.shape[1:])).stride()
    axes = [0] * (_ANC_WORDS * _MAX_ANC)
    for d, a in enumerate(anc):
        if not a.is_cuda or a.dtype not in _INDEX_DT or a.numel() != B or \
                not a.reshape(-1).is_contiguous():
            raise ValueError(f"{name}: ancestor {d} is {a.dtype} "
                             f"{tuple(a.shape)} on {a.device} (expected "
                             f"[{B}] integers on the card)")
        if d == 3:
            _split(name)
        axes[_ANC_WORDS * d:_ANC_WORDS * (d + 1)] = [
            st[1 + d], rec.shape[1 + d], a.data_ptr(), _DT[a.dtype]]
    return rec, [rec.data_ptr(), len(anc), st[0]], axes


def _vec_words(t, B: int, name: str, dtypes) -> list:
    """[pointer, stride] of a [B] vector (a pool column may be strided)."""
    if t is None:
        return [0, 0]
    if not t.is_cuda or t.dtype not in dtypes or t.numel() != B or \
            t.dim() > 2:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} (expected [{B}] of {dtypes} on the "
                         f"card)")
    return [t.data_ptr(), t.reshape(-1).stride(0) if B > 1 else 1]


def fk_sample_plain(rec, anc, gate, mask_in, mask_out, u=None, rv=None,
                    rel_alive=None, rel_refcount=None, comp=None,
                    draw=None):
    """K16's plain version, BlockTracer.sample_fk's body before its
    children: the record [B or 1, a_1..a_d, K + 1] picked at the ancestors,
    the draw at u [B] (`draw`, default inv_cdf_sample_plain) or, with rv
    [B] (the stored slots), the retained form; the full-arena guard and
    the first free slot of mask_in ([cap] or [B or 1, cap]); mask_out
    [B, cap] gets mask_in (unless it is mask_in) and each fresh, gated
    row's bit. Returns (int32 [4, B]: final, c_exist, c_exist_slot, slot;
    bool [2, B]: is_new, effective_new)."""
    from .engine.propose import _rtake

    B = int(gate.shape[0])
    cap = int(mask_out.shape[-1])
    logits = pick_plain(rec, anc, B)
    K = int(logits.shape[-1]) - 1
    dead = None
    if rv is not None:
        rv = rv.long().reshape(B)
        live = _rtake(rel_alive, rv[:, None])[:, 0] & \
            (_rtake(rel_refcount, rv[:, None])[:, 0] > 0)
        rpos = take(comp[1], rv).long() if comp is not None else rv
        chosen = torch.where(live, rpos, torch.full_like(rpos, K))
        dead = ~live
    else:
        chosen = (draw or inv_cdf_sample_plain)(
            logits.contiguous(), u.reshape(-1).contiguous()).long()
    is_new = chosen == K
    a2 = mask_in.reshape(-1, cap).expand(B, cap)
    has_free = ~torch.all(a2, dim=-1)
    fallback = torch.argmax(logits[:, :K], dim=-1)
    chosen = torch.where(is_new & ~has_free, fallback, chosen)
    is_new = is_new & has_free
    eff = is_new & gate
    c_exist = torch.clamp(chosen, max=K - 1)
    c_slot = torch.clamp(take(comp[0], c_exist), max=cap - 1) \
        if comp is not None else c_exist
    free = torch.argmin(a2.to(torch.int32), dim=-1)
    slot = torch.where(dead, rv, free) if dead is not None else free
    if mask_out.data_ptr() != mask_in.data_ptr():
        mask_out.copy_(a2)
    ok = eff & (slot >= 0) & (slot < cap)
    bidx = torch.arange(B, device=gate.device)
    s = slot.clamp(0, cap - 1)
    mask_out[bidx, s] = mask_out[bidx, s] | ok
    final = torch.where(is_new, slot, c_slot)
    return (torch.stack([final, c_exist.long(), c_slot.long(), slot])
            .to(torch.int32), torch.stack([is_new, eff]))


def fk_sample(rec, anc, gate, mask_in, mask_out, u=None, rv=None,
              rel_alive=None, rel_refcount=None, comp=None, label=None,
              geometry=None):
    """K16: fk_sample_plain in one launch, a row a warp, a block or a
    cluster (draw_plan of B, K + 1 and cap; `geometry` forces one; the
    draw gives K2's index, csrc/inv_cdf.cuh): rec a
    float32 record [B or 1, a_1..a_d, K + 1] (d <= 7, any strides, the
    last 1) read in place at the int ancestors anc [B]; u float32 [B] (a
    pool column, any stride) for the drawn form, or rv [B] (ints) with
    rel_alive (bool) and rel_refcount (int32), each [cap] or [B or 1, cap],
    for the retained form; comp (idx, inv) int index vectors or None; gate
    bool [B]; mask_in bool [cap] or [B or 1, cap], mask_out a contiguous
    bool [B, cap] the caller owns (mask_in itself: in place). Outputs in
    torch.empty buffers. On CPU tensors the plain version; on CUDA ones
    the kernel or an error. Counted in LAUNCH_CENSUS by (`label` form
    mask B=.. cap=..[ comp] d=.., r1 or rn, K + 1), mask shared (mask_in
    [cap] or [1, cap]), own ([B, cap]) or inplace; its fields in
    CENSUS_FIELDS."""
    if not _route(gate, "fk_sample"):
        return fk_sample_plain(rec, anc, gate, mask_in, mask_out, u, rv,
                               rel_alive, rel_refcount, comp)
    B = int(gate.shape[0])
    if gate.dtype != torch.bool or gate.dim() != 1 or \
            not gate.is_contiguous():
        raise ValueError("fk_sample: gate must be a contiguous bool [B]")
    if rec.dtype != torch.float32:
        raise ValueError(f"fk_sample: the record is {rec.dtype}, not float32")
    rec, rw, rx = _rec_words(rec, anc, B, "fk_sample", 1)
    K1 = int(rec.shape[-1])
    if K1 < 2:
        raise ValueError("fk_sample: a record of K + 1 >= 2 entries")
    cap = int(mask_out.shape[-1])
    if mask_out.dtype != torch.bool or mask_out.shape != (B, cap) or \
            not mask_out.is_contiguous() or not mask_out.is_cuda:
        raise ValueError(f"fk_sample: mask_out must be a contiguous bool "
                         f"[{B}, {cap}] on the card")

    def rows(t, name, dtype):
        """[pointer, row stride] of a [cap] or [B or 1, cap] leaf."""
        if not t.is_cuda or t.dtype != dtype or t.shape[-1] != cap or \
                t.dim() > 2 or (t.dim() == 2 and t.shape[0] not in (1, B)) \
                or not t.is_contiguous():
            raise ValueError(f"fk_sample: {name} is {t.dtype} "
                             f"{tuple(t.shape)} (expected contiguous "
                             f"{dtype} [cap] or [B or 1, {cap}])")
        return [t.data_ptr(), cap if t.dim() == 2 and t.shape[0] == B
                and B > 1 else 0]

    mi = rows(mask_in, "mask_in", torch.bool)
    if mi[0] == mask_out.data_ptr():
        if mi[1] != cap and B > 1:
            raise ValueError("fk_sample: in place needs mask_in [B, cap]")
        mask = "inplace"
    else:
        mask = "shared" if mask_in.dim() == 1 or mask_in.shape[0] == 1 \
            else "own"
    plan = _draw_plan(B, K1 if rv is None else 0, cap, geometry)
    words = [B, K1, cap, plan["tile"],
             DRAW_GEOMETRIES.index(plan["geometry"])] + rw
    if rv is None:
        if u is None:
            raise ValueError("fk_sample: the drawn form needs u")
        words += _vec_words(u, B, "fk_sample u", (torch.float32,)) + [0, 0]
        words += [0, 0, 0, 0]
        form = "drawn"
    else:
        rv = rv.reshape(-1).contiguous()
        words += [0, 0] + [_vec_words(rv, B, "fk_sample rv", _INDEX_DT)[0],
                           _DT[rv.dtype]]
        words += rows(rel_alive, "rel_alive", torch.bool) + \
            rows(rel_refcount, "rel_refcount", torch.int32)
        form = "retained"
    if comp is not None:
        idx, inv = comp[0], comp[1]
        for t, name in ((idx, "comp idx"), (inv, "comp inv")):
            if not t.is_cuda or t.dtype not in _INDEX_DT or t.dim() != 1 \
                    or not t.is_contiguous():
                raise ValueError(f"fk_sample: {name} must be a contiguous "
                                 f"int vector on the card")
        words += [idx.data_ptr(), _DT[idx.dtype], idx.shape[0],
                  inv.data_ptr(), _DT[inv.dtype], inv.shape[0]]
    else:
        words += [0] * 6
    ints = torch.empty((4, B), dtype=torch.int32, device=gate.device)
    flags = torch.empty((2, B), dtype=torch.bool, device=gate.device)
    words += [gate.data_ptr()] + mi + [mask_out.data_ptr(), ints.data_ptr(),
                                       flags.data_ptr(), plan["cluster"]]
    assert len(words) == K16_X, len(words)
    words += rx
    arr = (ctypes.c_int64 * K16_WORDS)(*words)
    rc = _fn("fk_sample")(arr, K16_WORDS, _stream(gate))
    _check(rc, "fk_sample")
    f = dict(form=form, mask=mask, B=B, cap=cap, comp=comp is not None,
             d=len(anc))
    _count("fk_sample", B, K1,
           f"{label} {form} {mask} B={B} cap={cap}"
           f"{' comp' if comp is not None else ''} d={len(anc)}", f)
    return ints, flags


def choice_sample_plain(rec, anc, B: int, u=None, rv=None, dummy=None,
                        mode: str = "draw", draw=None):
    """K17's plain version, BlockTracer.sample_choice's step: the record
    picked at the ancestors (pick_plain), then in draw mode the draw at u
    (`draw`, default inv_cdf_sample_plain) and in retained mode rv, or
    `dummy` where the choice has one and the logit at rv is <= NEG_INF /
    2, each int32 [B]; in pick mode the picked value itself, [B] of the
    record's dtype."""
    r = pick_plain(rec, anc, B)
    if mode == "pick":
        return r
    if mode == "retained":
        rv = rv.long().reshape(B)
        if dummy is None:
            chosen = rv
        else:
            from .utils import bgather
            valid = bgather(r, rv[:, None])[:, 0] > NINF / 2
            chosen = torch.where(valid, rv, torch.full_like(rv, dummy))
    elif mode == "draw":
        chosen = (draw or inv_cdf_sample_plain)(r.contiguous(),
                                                u.reshape(-1).contiguous())
    else:
        raise ValueError(f"choice_sample: mode {mode!r} is not one of "
                         f"{K17_MODES}")
    return chosen.to(torch.int32)


def choice_sample(rec, anc, B: int, u=None, rv=None, dummy=None,
                  mode: str = "draw", label=None, geometry=None):
    """K17: choice_sample_plain in one launch. Draw mode: rec a float32
    record [B or 1, a_1..a_d, V] (d <= 7, the last stride 1) read in place
    at the int ancestors anc [B], u float32 [B] (any stride), in the
    geometry draw_plan(B, V) gives (`geometry` forces one), K2's index
    (csrc/inv_cdf.cuh); retained
    mode: rv [B] ints, a thread a row; pick mode: rec [B or 1, a_1..a_d]
    of any dtype, a thread a row copying the picked value. Output int32
    [B] (pick: the record's dtype) from torch.empty. On CPU tensors the
    plain version; on CUDA ones the kernel or an error. Counted in
    LAUNCH_CENSUS by (`label` mode dtype B=.. d=.., r1 or rn, V; pick:
    1)."""
    if not _route(rec, "choice_sample"):
        return choice_sample_plain(rec, anc, B, u, rv, dummy, mode)
    if mode not in K17_MODES:
        raise ValueError(f"choice_sample: mode {mode!r} is not one of "
                         f"{K17_MODES}")
    pick = mode == "pick"
    if not pick and rec.dtype != torch.float32:
        raise ValueError(f"choice_sample: the record is {rec.dtype}, not "
                         f"float32")
    rec, rw, rx = _rec_words(rec, anc, B, "choice_sample", 0 if pick else 1)
    V = 1 if pick else int(rec.shape[-1])
    plan = _draw_plan(B, V, 0, geometry) if mode == "draw" else \
        dict(tile=0, geometry="warp", cluster=1)
    words = [B, V, K17_MODES.index(mode), plan["tile"],
             DRAW_GEOMETRIES.index(plan["geometry"])] + rw
    if mode == "draw":
        words += _vec_words(u, B, "choice_sample u", (torch.float32,))
    else:
        words += [0, 0]
    if mode == "retained":
        rv = rv.reshape(-1).contiguous()
        words += [_vec_words(rv, B, "choice_sample rv", _INDEX_DT)[0],
                  _DT[rv.dtype]]
    else:
        words += [0, 0]
    words += [0 if dummy is None else int(dummy), int(dummy is not None)]
    out = torch.empty((B,), dtype=rec.dtype if pick else torch.int32,
                      device=rec.device)
    words += [out.data_ptr(), out.element_size(), plan["cluster"]]
    assert len(words) == K17_X, len(words)
    words += rx
    arr = (ctypes.c_int64 * K17_WORDS)(*words)
    rc = _fn("choice_sample")(arr, K17_WORDS, _stream(rec))
    _check(rc, "choice_sample")
    _count("choice_sample", B, V,
           f"{label} {mode} {_SHORT[rec.dtype]} B={B} d={len(anc)}",
           dict(form=mode, dtype=rec.dtype, B=B, d=len(anc)))
    return out


# K17's group mode (csrc/choice_sample.cu): a header (members, B, the
# pool's pointer and strides, the output's pointer), then each member's
# record pointer and row stride, V, pool column, geometry, tile and
# cluster size; at most K17_GROUP_MAX members a launch
K17_GROUP_MAX, K17_GROUP_HEAD, K17_GROUP_MEMBER = 64, 6, 7


def group_chunks(n: int) -> list:
    """A group of n members as launches of at most K17_GROUP_MAX: [(lo,
    hi), ...], as even as they go."""
    k = max(1, -(-n // K17_GROUP_MAX))
    cuts = [n * i // k for i in range(k + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def choice_sample_group_plain(recs, pool, cols, draw=None):
    """K17's group mode, plain: member m's draw over its record recs[m]
    [B or 1, V_m] at the pool column pool[:, cols[m]] (`draw`, default
    inv_cdf_sample_plain), int32 [n, B]."""
    B = int(pool.shape[0])
    return torch.stack([choice_sample_plain(r, (), B, u=pool[:, c],
                                            draw=draw)
                        for r, c in zip(recs, cols)])


def choice_sample_group_words(recs, pool, cols, out, geometry=None) -> list:
    """K17's group plan for `out` [members, B] (int32): [(lo, hi, words),
    ...] a launch of group_chunks, each launch's header (members, B, the
    pool's pointer and strides, the pointer of out[lo]) and its members'
    words (record pointer, row stride (0: one row for every b), V, pool
    column, geometry, tile, cluster), every member in draw_plan(B, V)'s
    geometry (`geometry` forces one). Raises for a record or a column the
    kernel does not take; a record whose last stride is not 1 is made
    contiguous, and the returned plan holds it (keep it until the
    launch)."""
    if pool.dtype != torch.float32 or pool.dim() != 2 or \
            len(recs) != len(cols) or not recs:
        raise ValueError(f"choice_sample_group: a float32 [B, n] pool and "
                         f"one column a record, got {pool.dtype} "
                         f"{tuple(pool.shape)}, {len(recs)} records, "
                         f"{len(cols)} columns")
    B, n_cols = int(pool.shape[0]), int(pool.shape[1])
    members = []
    for r, c in zip(recs, cols):
        if r.device != pool.device or r.dtype != torch.float32 or \
                r.dim() != 2 or r.shape[0] not in (1, B) or \
                not 0 <= int(c) < n_cols:
            raise ValueError(f"choice_sample_group: record {r.dtype} "
                             f"{tuple(r.shape)} on {r.device} at column "
                             f"{c} (expected float32 [1 or {B}, V] on "
                             f"{pool.device}, a column of the pool's "
                             f"{n_cols})")
        if r.stride(-1) != 1:
            r = r.contiguous()
        V = int(r.shape[1])
        plan = _draw_plan(B, V, 0, geometry)
        members.append((r, [r.data_ptr(), r.stride(0) if r.shape[0] == B
                            and B > 1 else 0, V, int(c),
                            DRAW_GEOMETRIES.index(plan["geometry"]),
                            plan["tile"], plan["cluster"]]))
    launches = []
    for lo, hi in group_chunks(len(members)):
        words = [hi - lo, B, pool.data_ptr(), pool.stride(0),
                 pool.stride(1), out.data_ptr() + lo * B * 4]
        for _r, mw in members[lo:hi]:
            words += mw
        launches.append((lo, hi, words, [r for r, _w in members[lo:hi]]))
    return launches


def choice_sample_group(recs, pool, cols, label=None, geometry=None):
    """K17's group mode: the draws of several draw-mode choices whose
    records have no ancestor axis (propose.draw_groups) in one launch a
    K17_GROUP_MAX members (group_chunks; more than one launch counted in
    SPLITS): recs float32 [B or 1, V_m] each (the last stride 1), pool
    float32 [B, n] (any strides), cols the pool column of each member;
    each member drawn in the geometry draw_plan(B, V_m) gives
    (`geometry` forces one for all), K2's index
    (choice_sample_group_words). Output int32 [members, B] from
    torch.empty. On CPU tensors the plain version; on CUDA ones the
    kernel or an error. Each launch counted in LAUNCH_CENSUS under
    choice_sample by (`label` group n=.. B=.. V=V_1,.., r1 or rn, the
    sum of its V_m), its fields (form "group", B, Vs, each record's rows)
    in CENSUS_FIELDS."""
    if not _route(pool, "choice_sample_group"):
        return choice_sample_group_plain(recs, pool, cols)
    out = torch.empty((len(recs), int(pool.shape[0])), dtype=torch.int32,
                      device=pool.device)
    launches = choice_sample_group_words(recs, pool, cols, out, geometry)
    if len(launches) > 1:
        _split("choice_sample_group")
    fn = _fn("choice_sample_group")
    for _lo, _hi, words, kept in launches:
        arr = (ctypes.c_int64 * len(words))(*words)
        rc = fn(arr, len(words), _stream(pool))
        _check(rc, "choice_sample_group")
        B = words[1]
        Vs = tuple(words[K17_GROUP_HEAD + K17_GROUP_MEMBER * i + 2]
                   for i in range(words[0]))
        _count("choice_sample", B, sum(Vs),
               f"{label} group n={words[0]} B={B} V="
               f"{','.join(map(str, Vs))}",
               dict(form="group", B=B, Vs=Vs,
                    rows=tuple(int(r.shape[0]) for r in kept)))
    return out


def row_gather_plain(slot, hops, leaf):
    """K18's plain version, row_value's gathers: t = slot, then t =
    take(col, t) for each hop column, then take(leaf, t) (every index
    clamped into its column)."""
    t = slot
    for col in hops:
        t = take(col, t)
    return take(leaf, t)


def _chain_spec(chains) -> tuple:
    """(columns, spec) of a group of chains [(hops, leaf)]: the distinct
    column tensors in order of first use (by identity) and each chain as
    (hop column indices, leaf column index) into them."""
    cols, seen, spec = [], {}, []
    for hops, leaf in chains:
        ids = []
        for c in (*hops, leaf):
            j = seen.get(id(c))
            if j is None:
                j = seen[id(c)] = len(cols)
                cols.append(c)
            ids.append(j)
        spec.append((tuple(ids[:-1]), ids[-1]))
    return cols, tuple(spec)


@functools.lru_cache(maxsize=1024)
def row_gather_plan(spec: tuple) -> tuple:
    """K18's launches for a group of chains from one slot tensor, `spec`
    each chain's (hop column ids, leaf column id) (_chain_spec): ((nodes,
    leaves), ...), a launch each, in order. nodes ((column id, parent),
    ...) is the hop-column tree the kernel walks, node j's parent 0 (the
    slot) or k (node k - 1, an earlier one): chains that start with the
    same hops share their nodes; leaves ((chain, node, leaf column id),
    ...). A launch holds at most K18_MAX_NODES nodes and K18_MAX_CHAINS
    chains; the next chain that would pass either starts a new launch.
    Raises for a chain of more than K18_MAX_HOPS hops (the caller folds
    it first)."""
    out, nodes, leaves, index = [], [], [], {}
    for g, (hops, leaf) in enumerate(spec):
        if len(hops) > K18_MAX_HOPS:
            raise ValueError(f"row_gather_plan: a chain of {len(hops)} hops "
                             f"(at most {K18_MAX_HOPS})")
        new = sum(hops[:k] not in index for k in range(1, len(hops) + 1))
        if len(leaves) == K18_MAX_CHAINS or \
                len(nodes) + new > K18_MAX_NODES:
            out.append((tuple(nodes), tuple(leaves)))
            nodes, leaves, index = [], [], {}
        parent = 0
        for k in range(1, len(hops) + 1):
            if hops[:k] not in index:
                nodes.append((hops[k - 1], parent))
                index[hops[:k]] = len(nodes)
            parent = index[hops[:k]]
        leaves.append((g, parent, leaf))
    if leaves:
        out.append((tuple(nodes), tuple(leaves)))
    return tuple(out)


def row_gather_group_plain(slot, chains) -> list:
    """K18's plain version over a group of chains [(hops, leaf)] from one
    slot tensor, as the kernel walks it: each node of row_gather_plan's
    hop-column tree taken once from its parent's indices, each chain's
    leaf taken at its node (chains of more than K18_MAX_HOPS hops by
    row_gather_plain). Chain by chain, row_gather_plain's values."""
    out = [None] * len(chains)
    short = [g for g, (hops, _l) in enumerate(chains)
             if len(hops) <= K18_MAX_HOPS]
    for g, (hops, leaf) in enumerate(chains):
        if len(hops) > K18_MAX_HOPS:
            out[g] = row_gather_plain(slot, hops, leaf)
    cols, spec = _chain_spec([chains[g] for g in short])
    for nodes, leaves in row_gather_plan(spec):
        t = [slot]
        for col, parent in nodes:
            t.append(take(cols[col], t[parent]))
        for g, node, leaf in leaves:
            out[short[g]] = take(cols[leaf], t[node])
    return out


def chain_folds(n: int, most: int) -> list:
    """How a chain of n gathers (t = col[t] for each column in turn, from
    the running indices t) is cut for a kernel that follows at most `most`
    of them: the (first, end) column ranges that K18 launches fold into
    the running indices first, in order, each at most K18_MAX_HOPS + 1
    columns (K18's hops and its leaf); the kernel follows the columns from
    the last end on. [] where n <= most. Every gather clamps its index
    into its column, in a fold as in the kernel, so the folded chain
    reaches the same targets."""
    if most < 1:
        raise ValueError(f"chain_folds: a kernel that follows {most} columns")
    out, lo = [], 0
    while n - lo > most:
        hi = lo + min(K18_MAX_HOPS + 1, n - lo - most)
        out.append((lo, hi))
        lo = hi
    return out


def fold_chain(start, cols, most: int, label=None,
               caller: str = "row_gather") -> tuple:
    """(start', cols'): the chain of gathers `cols` from the indices
    `start` (a tensor), its first columns folded by chain_folds into
    start' through K18 (row_gather, into buffers of start's shape that the
    call owns), so that cols' holds at most `most`; start' reaches the
    same targets through cols' as start does through cols."""
    cols, lo = list(cols), 0
    folds = chain_folds(len(cols), most)
    if folds and start.device.type == "cuda":
        _split(caller)
    for lo, hi in folds:
        start = row_gather(start, cols[lo:hi - 1], cols[hi - 1], label=label)
        lo = hi
    return start, cols[lo:]


def row_gather(slot, hops, leaf, label=None):
    """K18 for one chain: row_gather_plain in one launch (row_gather_group's
    kernel with a group of one): slot an int tensor of any shape and
    strides (up to 8 axes where it is not contiguous), hops contiguous int
    columns, leaf a contiguous column of any dtype of _DT; returns slot's
    shape in the leaf's dtype (torch.empty). A chain of more than
    K18_MAX_HOPS hops runs in stages (fold_chain): each earlier launch
    follows K18_MAX_HOPS hops and the next column as its leaf into a
    buffer of slot's shape. On CPU tensors the plain version; on CUDA ones
    the kernel or an error. Counted in LAUNCH_CENSUS by ("label
    dtype:length,..." of each hop column and the leaf, r1 or rn, the slot
    count), once a launch."""
    if not leaf.is_cuda and not _route(leaf, "row_gather"):
        return row_gather_plain(slot, hops, leaf)
    if not isinstance(slot, torch.Tensor):
        slot = torch.as_tensor(slot, device=leaf.device)
    if len(hops) > K18_MAX_HOPS:
        slot, rest = fold_chain(slot, list(hops) + [leaf], K18_MAX_HOPS + 1,
                                label)
        hops, leaf = rest[:-1], rest[-1]
    return _k18_launch(slot, [*hops, leaf], _single_spec(len(hops)),
                       label)[0]


@functools.lru_cache(maxsize=None)
def _single_spec(hops: int) -> tuple:
    """_chain_spec's spec of one chain of `hops` hop columns and a leaf,
    each its own column."""
    return ((tuple(range(hops)), hops),)


def row_gather_group(slot, chains, label=None) -> list:
    """K18 over a group of chains [(hops, leaf)] from one slot tensor (a
    foreign key's copy-mode vertices, a Compute leaf's arguments): the
    chains of row_gather_plan's launches, one launch for up to
    K18_MAX_CHAINS chains over at most K18_MAX_NODES distinct hop prefixes,
    each hop column loaded once a slot; a chain of more than K18_MAX_HOPS
    hops by its own row_gather (folded). Returns each chain's values, of
    slot's shape in its leaf's dtype, in order. On CPU tensors the plain
    version (row_gather_group_plain); on CUDA ones the kernel or an error.
    Counted in LAUNCH_CENSUS by ("label chain;chain;...", r1 or rn, the
    slot count), each chain as row_gather's ("dtype:length,..."), once a
    launch."""
    out, short = [None] * len(chains), []
    for g, (hops, leaf) in enumerate(chains):
        if len(hops) > K18_MAX_HOPS:
            out[g] = row_gather(slot, hops, leaf, label=label)
        else:
            short.append(g)
    if short:
        sub = [chains[g] for g in short]
        if _route(sub[0][1], "row_gather"):
            if not isinstance(slot, torch.Tensor):
                slot = torch.as_tensor(slot, device=sub[0][1].device)
            vals = _k18_launch(slot, *_chain_spec(sub), label)
        else:
            vals = row_gather_group_plain(slot, sub)
        for g, v in zip(short, vals):
            out[g] = v
    return out


# K18's and K20's launch plans by the call's structure (dtypes, shapes,
# strides, labels; not the pointers, which a call patches in): a batched
# driver replaces the columns it writes out of place, so the pointers
# change from batch to batch where the structure does not
_PLAN_CACHE_MAX = 4096
_K18_PLANS: dict = {}


def _k18_launch(slot, cols, spec, label) -> list:
    """K18's launches for a group of chains of at most K18_MAX_HOPS hops on
    the card, `cols` and `spec` as _chain_spec gives them: the plans from
    _K18_PLANS (built and checked by _k18_entry at the structure's first
    call), each call writing only the slot's, columns' and outputs'
    pointers into the prebuilt words."""
    if slot.dim() > K18_MAX_DIMS and not slot.is_contiguous():
        slot = slot.contiguous()
    key = (label, spec, slot.dtype, slot.shape, slot.stride(),
           slot.get_device(),
           tuple((c.dtype, c.shape, c.stride(), c.get_device())
                 for c in cols))
    ent = _K18_PLANS.get(key)
    if ent is None:
        ent = _k18_entry(slot, cols, spec, label)
        if len(_K18_PLANS) >= _PLAN_CACHE_MAX:
            _K18_PLANS.clear()
        _K18_PLANS[key] = ent
    shape, dev, N, outputs, launches = ent
    if len(launches) > 1:   # a group past one launch's class
        _split("row_gather")
    outs = [None] * len(spec)
    for dt, idx, size, strides in outputs:
        if len(idx) == 1:
            outs[idx[0]] = torch.empty(shape, dtype=dt, device=dev)
            continue
        # one buffer for the chains of one dtype, each output 16-byte
        # aligned in it
        views = torch.empty(size, dtype=dt, device=dev).as_strided(
            (len(idx),) + shape, strides).unbind(0)
        for g, v in zip(idx, views):
            outs[g] = v
    cp = [c.data_ptr() for c in cols]
    op = [o.data_ptr() for o in outs]
    sp, stream, fn = slot.data_ptr(), _stream(slot), _fn("row_gather")
    for words, addr, n, cpos, opos, mode, fields in launches:
        words[2] = sp
        for pos, j in cpos:
            words[pos] = cp[j]
        for pos, g in opos:
            words[pos] = op[g]
        _check(fn(addr, n, stream), "row_gather")
        _count("row_gather", N, N, mode, fields)
    return outs


def row_gather_words(slot, cols, nodes, leaves) -> tuple:
    """One K18 launch's plan: (words, column pointer positions [(word,
    column)], output pointer positions [(word, chain)]): the header, the
    smallest K18_CLASSES class's node slots and chain slots that hold the
    launch (the unused ones 0), every pointer 0; `cols` as _chain_spec
    gives them, `nodes` and `leaves` one launch of row_gather_plan."""
    cls = next(i for i, (n, c) in enumerate(K18_CLASSES)
               if len(nodes) <= n and len(leaves) <= c)
    most_nodes, most_chains = K18_CLASSES[cls]
    contig = slot.is_contiguous()
    words = [slot.numel(), slot.dim(), 0, _DT[slot.dtype], int(contig)]
    words += list(slot.shape) + [1] * (K18_MAX_DIMS - slot.dim())
    words += list(slot.stride()) + [0] * (K18_MAX_DIMS - slot.dim())
    words += [len(nodes), len(leaves), cls]
    cpos, opos = [], []
    for col, parent in nodes:
        c = cols[col]
        cpos.append((len(words), col))
        words += [0, _DT[c.dtype], int(c.shape[0]), parent]
    words += [0] * (K18_HEAD + K18_NODE * most_nodes - len(words))
    for g, node, lc in leaves:
        c = cols[lc]
        cpos.append((len(words) + 1, lc))
        opos.append((len(words) + 3, g))
        words += [node, 0, int(c.shape[0]), 0, c.element_size()]
    words += [0] * (K18_HEAD + K18_NODE * most_nodes
                    + K18_CHAIN * most_chains - len(words))
    return words, cpos, opos


def _k18_entry(slot, cols, spec, label) -> tuple:
    """A _K18_PLANS entry: (slot's shape, device, slot count, the outputs
    [(dtype, the chains of that dtype, their buffer's elements, the
    strides of its [chains, *shape] view)], [(words as an array.array, its
    address, its length, column and output pointer positions, census
    mode, census fields)] a launch); raises for what the kernel does not
    take."""
    if not slot.is_cuda or slot.dtype not in _INDEX_DT + (torch.uint8,):
        raise ValueError(f"row_gather: slots {slot.dtype} on {slot.device} "
                         f"(expected integers on the card)")
    hop_cols = {j for hops, _l in spec for j in hops}
    for j, c in enumerate(cols):
        name = "hop column" if j in hop_cols else "leaf"
        if not c.is_cuda or c.dim() != 1 or not c.is_contiguous() or \
                c.dtype not in _DT or c.shape[0] < 1 or \
                (name != "leaf" and c.dtype not in _INDEX_DT):
            raise ValueError(f"row_gather: {name} {c.dtype} "
                             f"{tuple(c.shape)} on {c.device}")
    N = slot.numel()
    launches = []
    for nodes, leaves in row_gather_plan(spec):
        words, cpos, opos = row_gather_words(slot, cols, nodes, leaves)
        words = array.array("q", words)
        local: dict = {}
        chains = []
        for g, _node, _lc in leaves:
            hops, leaf = spec[g]
            chains.append((tuple(local.setdefault(j, len(local))
                                 for j in hops),
                           local.setdefault(leaf, len(local))))
        fields = dict(cols=[(cols[j].dtype, int(cols[j].shape[0]))
                            for j in local], chains=chains)
        mode = f"{label} " + ";".join(
            ",".join(f"{_SHORT[cols[j].dtype]}:{cols[j].shape[0]}"
                     for j in spec[g][0] + (spec[g][1],))
            for g, _node, _lc in leaves)
        launches.append((words, words.buffer_info()[0], len(words), cpos,
                         opos, mode, fields))
    by_dtype: dict = {}
    for g, (_hops, leaf) in enumerate(spec):
        key = cols[leaf].dtype if N else g   # (an empty group: one each)
        by_dtype.setdefault(key, []).append(g)
    inner = [math.prod(slot.shape[d + 1:]) for d in range(slot.dim())]
    outputs = []
    for idx in by_dtype.values():
        c = cols[spec[idx[0]][1]]
        pad = -(-N * c.element_size() // 16) * 16 // c.element_size()
        outputs.append((c.dtype, idx, pad * len(idx), (pad, *inner)))
    return tuple(slot.shape), slot.device, N, outputs, launches


def branch_select_plain(is_new, pairs) -> list:
    """K19's plain version, sample_fk's select over its subtree:
    torch.where(is_new, new, existing.to(new's dtype)) for each (new,
    existing) pair."""
    return [torch.where(is_new, nv, ev.to(nv.dtype)) for nv, ev in pairs]


# K19's launch plans by the call's structure (is_new's and each value's
# dtype, shape, stride and device; not the pointers, which a call writes
# into the prebuilt words)
_K19_PLANS: dict = {}


def _k19_plan(is_new, pairs) -> tuple:
    """The _K19_PLANS entry of this call's structure, built and checked by
    _k19_entry at its first call."""
    try:
        key = (is_new.dtype, is_new.shape, is_new.stride(),
               is_new.get_device(),
               tuple((nv.dtype, nv.shape, nv.stride(), nv.is_cuda, ev.dtype,
                      ev.shape, ev.stride(), ev.is_cuda)
                     for nv, ev in pairs))
    except AttributeError:   # (a value that is no tensor: _k19_entry says)
        return _k19_entry(is_new, pairs)
    ent = _K19_PLANS.get(key)
    if ent is None:
        ent = _k19_entry(is_new, pairs)
        if len(_K19_PLANS) >= _PLAN_CACHE_MAX:
            _K19_PLANS.clear()
        _K19_PLANS[key] = ent
    return ent


def _k19_entry(is_new, pairs) -> tuple:
    """A _K19_PLANS entry: (B, device, the bytes of the call's one output
    allocation, its views [(dtype, byte offset, bytes, the pairs of that
    dtype)], each output's byte offset, the values (2 j + side) a call
    makes contiguous, [(words as an array.array, its address, its length,
    the first pair, census mode, census fields, pairs)] a launch): the
    outputs of one dtype are the rows of one [pairs, B] block, each block
    on a 16-byte boundary, so each output is aligned to its dtype. Raises
    for what the kernel does not take."""
    B = int(is_new.shape[0]) if is_new.dim() == 1 else -1
    if B < 0 or is_new.dtype != torch.bool or not is_new.is_contiguous():
        raise ValueError(f"branch_select: is_new must be a contiguous bool "
                         f"[B], got {is_new.dtype} {tuple(is_new.shape)}")
    card = is_new.is_cuda
    flags, contig, sig, dts = [], [], [], []
    for j, pair in enumerate(pairs):
        bits = 0
        for side, t in enumerate(pair):
            if not torch.is_tensor(t) or t.is_cuda != card or \
                    t.dtype not in _DT or t.numel() not in (1, B) or \
                    t.dim() > 1:
                raise ValueError(
                    f"branch_select: a value {getattr(t, 'dtype', t)} "
                    f"{tuple(getattr(t, 'shape', ()))} (expected [{B}] "
                    f"or one element on {is_new.device})")
            one = t.numel() == 1 or t.stride(0) == 0
            if not one and t.stride(0) != 1:
                contig.append(2 * j + side)
            bits |= _DT[t.dtype] << (4 * side) | int(one) << (8 + side)
        flags.append(bits)
        sig.append(f"{_SHORT[pair[0].dtype]}<{_SHORT[pair[1].dtype]}")
        dts.append((pair[0].dtype, pair[1].dtype))
    by_dtype: dict = {}
    for j, (nv, _ev) in enumerate(pairs):
        by_dtype.setdefault(nv.dtype, []).append(j)
    views, offs, size = [], [0] * len(pairs), 0
    for dt, idx in by_dtype.items():
        esize = torch.empty((), dtype=dt).element_size()
        views.append((dt, size, B * esize * len(idx), idx))
        for i, j in enumerate(idx):
            offs[j] = size + i * B * esize
        size += -(-B * esize * len(idx) // 16) * 16
    launches = []
    for j0 in range(0, len(pairs), K19_MAX_PAIRS):
        n = min(K19_MAX_PAIRS, len(pairs) - j0)
        words = [n, B, 0]
        for j in range(j0, j0 + n):
            words += [0, 0, 0, flags[j]]
        words = array.array("q", words)
        launches.append((words, words.buffer_info()[0], len(words), j0,
                         f"B={B} {','.join(sig[j0:j0 + n])}",
                         dict(B=B, pairs=dts[j0:j0 + n]), n))
    return B, is_new.device, size, views, offs, tuple(contig), launches


def _k19_bind(ent: tuple, is_new, pairs) -> tuple:
    """(the call's outputs, views of one allocation as the entry lays them
    out; the values the words point at, which the caller keeps until the
    launch), with this call's pointers written into the entry's words."""
    B, dev, size, views, offs, contig, launches = ent
    if contig:
        vals = [t for pair in pairs for t in pair]
        for i in contig:
            vals[i] = vals[i].contiguous()
        pairs = list(zip(vals[::2], vals[1::2]))
    if len(views) == 1:   # one dtype: the rows of one [pairs, B] tensor
        buf = torch.empty((len(pairs), B), dtype=views[0][0], device=dev)
        outs = list(buf.unbind(0))
    else:
        buf = torch.empty((size,), dtype=torch.uint8, device=dev)
        outs = [None] * len(pairs)
        for dt, off, n_bytes, idx in views:
            for j, v in zip(idx, buf.narrow(0, off, n_bytes).view(dt)
                            .view(len(idx), B).unbind(0)):
                outs[j] = v
    base = buf.data_ptr()
    nps = [nv.data_ptr() for nv, _ev in pairs]
    eps = [ev.data_ptr() for _nv, ev in pairs]
    for words, _a, _n, j0, _m, _f, n in launches:
        words[2] = is_new.data_ptr()
        words[K19_HEAD::K19_PAIR] = array.array("q", nps[j0:j0 + n])
        words[K19_HEAD + 1::K19_PAIR] = array.array("q", eps[j0:j0 + n])
        words[K19_HEAD + 2::K19_PAIR] = array.array(
            "q", [base + o for o in offs[j0:j0 + n]])
    return outs, pairs


def branch_select(is_new, pairs) -> list:
    """K19: branch_select_plain in one launch for up to K19_MAX_PAIRS pairs
    (more: a launch each K19_MAX_PAIRS): is_new a contiguous bool [B], each
    value a tensor of B or 1 elements (at most one axis) of any dtype of
    _DT; each output a [B] tensor of the new value's dtype, all of a
    call's outputs views of one allocation. The plan is cached by the
    call's structure (_K19_PLANS). On CPU tensors the plain version; on
    CUDA ones the kernel or an error. Counted in LAUNCH_CENSUS by ("B=..
    new<existing,...", r1 or rn, the pairs)."""
    if not _route(is_new, "branch_select"):
        return branch_select_plain(is_new, pairs)
    ent = _k19_plan(is_new, pairs)
    outs, _vals = _k19_bind(ent, is_new, pairs)
    fn, stream, B = _fn("branch_select"), _stream(is_new), ent[0]
    for words, addr, n_words, _j0, mode, fields, n in ent[6]:
        _check(fn(addr, n_words, stream), "branch_select")
        _count("branch_select", B, n, mode, fields)
    return outs


# ---------------------------------------------------------------- K20, K21

# K20's program (csrc/level_sum.cu): a postfix sum over a stack of floats,
# one (opcode, argument) pair a step: ZERO pushes 0, PUSH i pushes operand
# i, ADD pops b and a and pushes a + b, ADDOP i adds operand i to the top
LEVEL_ZERO, LEVEL_PUSH, LEVEL_ADD, LEVEL_ADDOP = range(4)
K20_KINDS = ("dense", "eq", "sel", "gather")
# the plan's word counts and limits: a header, the tensor references
# (pointer, dtype, strides over the output's merged axes), the operands
# (kind, three references, two arguments) and the program
K20_MAX_DIMS = 8
K20_HEAD, K20_REF, K20_OP = 32, 2 + K20_MAX_DIMS, 6
K20_MAX_REFS, K20_MAX_OPS, K20_MAX_PROG, K20_MAX_STACK = 128, 64, 384, 32
K20_WORDS = (K20_HEAD + K20_REF * K20_MAX_REFS + K20_OP * K20_MAX_OPS
             + K20_MAX_PROG)
# the header's words (csrc/level_sum.cu): the element count, the merged
# rank and sizes, the output's pointer, the counts, the threads a row of
# the innermost axis, the rows, the threads, the divisor word of the
# threads a row and of each outer axis, the instantiation
K20_OUT = 2 + K20_MAX_DIMS
_K20_KERNEL = K20_OUT + 8 + K20_MAX_DIMS - 1
# the instantiations, (stack depth, 32-bit indices, elements a thread takes
# along the innermost axis), by the header's last word: a program no
# deeper than 2, 4 or 8 keeps its stack in registers, the last takes the
# rest and 64-bit indices. A level of at least K20_WIDE elements takes 8
# elements a thread where its stack is at most 4 deep, else 4 (fewer
# threads walk the program, 16-byte loads and stores: rents' [256, 4,096,
# 2] level); a smaller one 1 (a one-row level's gathers wait on dependent
# loads, so more threads wait together: on an H100, [1, 512] with 11
# gathers took 0.0206 device ms at 4 elements a thread against 0.0144 a
# thread an element, PERF.md)
K20_KERNELS = ((2, True, 1), (4, True, 1), (8, True, 1), (2, True, 8),
               (4, True, 8), (8, True, 4), (K20_MAX_STACK, False, 4))
K20_WIDE = 1 << 16
# a level fused into K12 or K13 (csrc/level_eval.cuh inside csrc/fk_score.cu
# and choice_score.cu): an element a thread, its instantiations (stack
# depth, 32-bit indices) by the score kernel's head's kernel word
SCORE_KERNELS = ((2, True), (4, True), (8, True), (K20_MAX_STACK, False))
# the score kernels' geometries (fk_score_plan): K1's warp and block paths,
# or a thread a slot over a block or a cluster of blocks a row
SCORE_PATHS = ("warp", "block", "slots")
SCORE_MAX_THREADS = 1024
SCORE_MAX_CLUSTER = 8    # the portable cluster size
# the heads' words (csrc/fk_score.cu, choice_score.cu; the levels' words
# follow) and the plans' largest parameter blocks: K13's head and one
# level; K12's head and two levels in at most PARAM_MAX bytes
K12_HEAD, K13_HEAD = 32, 64
K12_WORDS = PARAM_MAX // 8
K13_WORDS = K13_HEAD + K20_WORDS
assert 8 * K20_WORDS <= PARAM_MAX
K21_WORDS = 64
# K21's plan (csrc/py_prior.cu): the vector word (K21_ROUTE: which loads
# and stores move as 16-byte vectors: refcount and alive at slot k with no
# compaction, the children contiguous along k, exist's rows, idx), the row
# kernel's threads a row (K21_ROW_LOG: log2, at most the block's
# K21_THREADS) and the kernel (K21_UNIT: the candidates a thread takes at
# a time, 4 in the row kernel, 1 in the flat one)
K21_ROUTE, K21_ROW_LOG, K21_UNIT = 50, 51, 52
K21_LEAF_VEC, K21_CH_VEC, K21_EXIST_VEC, K21_IDX_VEC = 1, 2, 4, 8
K21_THREADS = 256


def level_dense(x) -> dict:
    """A level operand (a): a float32 tensor added as it is (a child's
    logZ, an external's term, an observation's log-density)."""
    return dict(kind="dense", x=x)


def level_eq(val, obs, state, is_float: bool) -> dict:
    """A level operand (b), copy mode's equality term: where state == 1,
    0 if val equals obs (exactly, or |val - obs| <= 1e-6 max(1, |obs|)
    where `is_float`), else NEG_INF; 0 elsewhere. `state` a static code
    or a tensor."""
    return dict(kind="eq", val=val, obs=obs, state=state,
                float=bool(is_float))


def level_sel(obs_ld, miss, state) -> dict:
    """A level operand (c), a non-enumerable observed choice's term:
    state == 1 ? obs_ld : (state == 2 ? miss : 0), `state` a static code or
    a tensor."""
    return dict(kind="sel", obs_ld=obs_ld, miss=miss, state=state)


def level_gather(M, obs, word, shape) -> dict:
    """A level operand (d), a deferred AddTypos column M[obs, word], each
    code clamped into [0, V) (K3's gather), over `shape` (the frame's
    enumeration rows, (B,) + axes: the shape of K3's output)."""
    return dict(kind="gather", M=M, obs=obs, word=word, shape=tuple(shape))


def level_program(code) -> list:
    """A level's postfix code with each PUSH i directly followed by ADD
    folded into ADDOP i (the same sum: a + b rounds as b + a), and each
    ZERO, ZERO, ADD into ZERO (+0 + +0 is +0): the same bits, a shallower
    stack."""
    out = []
    for op in code:
        if op[0] == LEVEL_ADD and out and out[-1][0] == LEVEL_PUSH:
            out[-1] = (LEVEL_ADDOP, out[-1][1])
        elif op[0] == LEVEL_ADD and len(out) > 1 and \
                out[-1][0] == out[-2][0] == LEVEL_ZERO:
            out.pop()
        else:
            out.append(op)
    return out


def level_stack(prog) -> int:
    """The most values the program holds at once; raises where it does
    not leave exactly one."""
    n = top = 0
    for op, _a in prog:
        if op == LEVEL_ZERO or op == LEVEL_PUSH:
            n += 1
            top = max(top, n)
        elif op == LEVEL_ADD:
            n -= 1
        if n < 1:
            raise ValueError("level_sum: the program pops an empty stack")
    if n != 1:
        raise ValueError(f"level_sum: the program leaves {n} values")
    return top


def _level_tensors(o: dict) -> list:
    """(name, tensor) of an operand's tensor references, in the kernel's
    reference order."""
    k = o["kind"]
    names = {"dense": ("x",), "eq": ("val", "obs", "state"),
             "sel": ("obs_ld", "miss", "state"),
             "gather": ("obs", "word")}[k]
    return [(n, o[n]) for n in names if torch.is_tensor(o.get(n))]


def _aligned(shape, rank: int, what: str) -> tuple:
    shape = tuple(shape)
    if len(shape) > rank:
        raise ValueError(f"level_sum: {what} of rank {len(shape)} in a "
                         f"level of rank {rank}")
    return (1,) * (rank - len(shape)) + shape


def _grow(out: list, shape, rank: int, what: str) -> None:
    """Broadcast the running output shape `out` with `shape`, aligned to
    the right at `rank` axes as torch aligns it; raises where the two do
    not broadcast."""
    for i, n in enumerate(_aligned(shape, rank, what)):
        if n != 1 and n != out[i]:
            if out[i] != 1:
                raise ValueError(f"level_sum: {what} of {tuple(shape)} in "
                                 f"a level of {tuple(out)}")
            out[i] = n


def level_shape(operands, rank: int) -> tuple:
    """The level's output shape: the broadcast of (1,) * rank and every
    operand's shape (a gather's declared shape, else its tensors'), each
    aligned to the right as torch broadcasts: the shape of the eager sum."""
    out = [1] * rank
    for o in operands:
        if o["kind"] == "gather":
            _grow(out, o["shape"], rank, "a gather")
        for n, t in _level_tensors(o):
            _grow(out, t.shape, rank, n)
    return tuple(out)


def _state_is(state, code: int, dev):
    if torch.is_tensor(state):
        return state == code
    return torch.full((), state == code, dtype=torch.bool, device=dev)


def _level_value(o: dict, dev):
    """An operand's value, by the tracer's own torch ops."""
    k = o["kind"]
    zero = torch.zeros((), device=dev)
    if k == "dense":
        return o["x"]
    if k == "eq":
        val, ov = o["val"], o["obs"]
        if o["float"]:
            eq = torch.abs(val - ov) <= 1e-6 * torch.clamp(torch.abs(ov),
                                                            min=1.0)
        else:
            eq = val == ov
        return torch.where(_state_is(o["state"], 1, dev),
                           torch.where(eq, zero, NINF), zero)
    if k == "sel":
        return torch.where(_state_is(o["state"], 1, dev), o["obs_ld"],
                           torch.where(_state_is(o["state"], 2, dev),
                                       o["miss"], zero))
    M = o["M"]
    V = M.shape[0]
    g = M[o["obs"].long().clamp(0, V - 1), o["word"].long().clamp(0, V - 1)]
    return g.expand(o["shape"])


def level_sum_plain(prog, operands, rank: int):
    """K20's plain version: the program evaluated with torch ops, each
    operand by the tracer's own expression (the eager where chains and
    gathers), each step one torch add: the parent's nested eager sum,
    bit for bit. Returns a tensor of level_shape(operands, rank)."""
    dev = _level_device(operands)
    stack = []
    for op, a in prog:
        if op == LEVEL_ZERO:
            stack.append(torch.zeros((1,) * rank, device=dev))
        elif op == LEVEL_PUSH:
            stack.append(_level_value(operands[a], dev))
        elif op == LEVEL_ADD:
            b = stack.pop()
            stack[-1] = stack[-1] + b
        elif op == LEVEL_ADDOP:
            stack[-1] = stack[-1] + _level_value(operands[a], dev)
        else:
            raise ValueError(f"level_sum: opcode {op}")
    if len(stack) != 1:
        raise ValueError(f"level_sum: the program leaves {len(stack)} values")
    out = stack[0]
    shape = level_shape(operands, rank)
    if _aligned(out.shape, rank, "the sum") != shape:
        raise ValueError(f"level_sum: sum of shape {tuple(out.shape)}, "
                         f"operands of {shape}")
    return out.reshape(shape)


def _refs_of(o: dict) -> int:
    return len(_level_tensors(o))


@functools.lru_cache(maxsize=256)
def _level_cuts(prog: tuple, refs: tuple) -> tuple:
    """level_stages' cuts for a program over operands of refs[i] tensor
    references each: ((stage program, stage operands), ...), a stage's
    operands ("o", i) an operand of the level or ("s", k) stage k's
    output, the last stage the level's sum."""
    prog, srcs, stages = list(prog), [("o", i) for i in range(len(refs))], []

    def nref(src):
        return refs[src[1]] if src[0] == "o" else 1

    def fits(p, used):
        return (len(p) <= K20_MAX_PROG and len(used) <= K20_MAX_OPS
                and sum(nref(srcs[i]) for i in used) <= K20_MAX_REFS)

    def stage(p):
        used = sorted({a for op, a in p if op in (LEVEL_PUSH, LEVEL_ADDOP)})
        at = {i: k for k, i in enumerate(used)}
        return (tuple((op, at.get(a, 0) if op in (LEVEL_PUSH, LEVEL_ADDOP)
                       else 0) for op, a in p),
                tuple(srcs[i] for i in used))

    if fits(prog, range(len(refs))) and level_stack(prog) <= K20_MAX_STACK:
        return ((tuple(prog), tuple(srcs)),)   # one launch, as it is
    while True:
        used = {a for op, a in prog if op in (LEVEL_PUSH, LEVEL_ADDOP)}
        if fits(prog, used) and level_stack(prog) <= K20_MAX_STACK:
            return tuple(stages) + (stage(prog),)
        # the longest subexpression (a run of steps that leaves one value
        # on the values below it) that fits one launch on its own
        best, depth = None, 0
        for i, (op, _a) in enumerate(prog):
            if op in (LEVEL_ZERO, LEVEL_PUSH):
                cur = top = depth
                seen, nr = set(), 0
                for e in range(i, min(len(prog), i + K20_MAX_PROG)):
                    o, a = prog[e]
                    cur += 1 if o in (LEVEL_ZERO, LEVEL_PUSH) else \
                        (-1 if o == LEVEL_ADD else 0)
                    if cur <= depth:
                        break
                    top = max(top, cur)
                    if o in (LEVEL_PUSH, LEVEL_ADDOP) and a not in seen:
                        seen.add(a)
                        nr += nref(srcs[a])
                    if top - depth > K20_MAX_STACK or \
                            len(seen) > K20_MAX_OPS or nr > K20_MAX_REFS:
                        break
                    if cur == depth + 1 and e > i and \
                            (best is None or e + 1 - i > best[1] - best[0]):
                        best = (i, e + 1)
            depth += 1 if op in (LEVEL_ZERO, LEVEL_PUSH) else \
                (-1 if op == LEVEL_ADD else 0)
        if best is None:
            raise ValueError("level_sum: the level has no part that fits "
                             "one launch")
        i, e = best
        stages.append(stage(prog[i:e]))
        srcs.append(("s", len(stages) - 1))
        prog[i:e] = [(LEVEL_PUSH, len(srcs) - 1)]


def level_stages(prog, operands) -> list:
    """K20's launches for a level: [(program, operands)], each within one
    launch's limits (K20_MAX_PROG steps, K20_MAX_OPS operands,
    K20_MAX_REFS tensor references, a stack of K20_MAX_STACK), in order; a
    stage's operand ("o", i) is the level's operand i and ("s", k) the
    output of stage k, added as a dense term. One stage where the level
    fits one launch. A longer level is cut at its longest subexpression
    that fits (a run of steps that leaves one value above the values
    below it), which a launch sums into a buffer the next stage pushes in
    its place, again until the rest fits: every element's additions keep
    the level's order, one rounding a step, so the sum is bit-equal to
    one launch's (or the eager expression's)."""
    return [(list(p), list(o)) for p, o in
            _level_cuts(tuple(map(tuple, prog)),
                        tuple(_refs_of(o) for o in operands))]


def level_sum_split_plain(prog, operands, rank: int):
    """level_sum_plain through level_stages' cuts: each stage's sum by
    level_sum_plain, pushed as a dense term into the next (the split
    evaluation, bit-equal to level_sum_plain)."""
    outs = []
    for p, srcs in level_stages(prog, operands):
        ops_ = [operands[i] if k == "o" else level_dense(outs[i])
                for k, i in srcs]
        outs.append(level_sum_plain(p, ops_, rank))
    return outs[-1]


def _level_device(operands):
    for o in operands:
        for _n, t in _level_tensors(o):
            return t.device
    raise ValueError("level_sum: no operand tensor to take a device from")


def level_kinds(operands) -> str:
    """K20's census word for its operand kinds: the count of each kind
    present, as "a2b1d3" (a dense, b eq, c sel, d gather; the zero counts
    left out, "-" for none)."""
    n = [0] * len(K20_KINDS)
    for o in operands:
        n[K20_KINDS.index(o["kind"])] += 1
    return "".join(f"{'abcd'[i]}{c}" for i, c in enumerate(n) if c) or "-"


def _level_fields(prog, operands, rank: int, shape) -> dict:
    """The fields kernel_bench rebuilds a K20 census shape's seeded inputs
    from: the program, the output shape and each operand's kind, static
    code, float flag, matrix size and references' (name, aligned shape,
    dtype)."""
    ops_ = []
    for o in operands:
        refs = [(n, _aligned(t.shape, rank, n), t.dtype)
                for n, t in _level_tensors(o)]
        ops_.append(dict(
            kind=o["kind"], refs=refs,
            state=None if torch.is_tensor(o.get("state")) else o.get("state"),
            float=o.get("float", False),
            V=int(o["M"].shape[0]) if o["kind"] == "gather" else 0,
            shape=o.get("shape")))
    return dict(prog=tuple(prog), rank=rank, shape=tuple(shape), ops=ops_)


def level_plan(prog, operands, rank: int, card: bool = True, shape=None,
               fused: bool = False) -> tuple:
    """K20's plan for the level and its output shape: (words, shape). The
    words, packed: the header (output size, rank, sizes, the output's
    pointer at K20_OUT, 0 until the caller allocates the output, counts),
    each tensor reference's (pointer, dtype code, strides over the
    output), each operand's (kind, references, static code or matrix,
    flag or V), the program's (opcode << 32 | argument). Refuses what the
    kernel does not take: dtypes, rank, counts, a program that does not
    leave one value or nests deeper than K20_MAX_STACK, and, with `card`,
    tensors off the card. `shape`: the output the program is evaluated
    over, a shape the level broadcasts to (a fused level: the record's
    [full..., K]), else the level's own. `fused`: a level K12 or K13 runs
    in its own launch (csrc/level_eval.cuh), an element a thread, its
    instantiation word one of SCORE_KERNELS."""
    prog = list(prog)
    if not 1 <= rank <= K20_MAX_DIMS:
        raise ValueError(f"level_sum: rank {rank} (1 to {K20_MAX_DIMS})")
    if len(prog) > K20_MAX_PROG or len(operands) > K20_MAX_OPS:
        raise ValueError(f"level_sum: {len(prog)} steps and "
                         f"{len(operands)} operands (at most "
                         f"{K20_MAX_PROG} and {K20_MAX_OPS})")
    if level_stack(prog) > K20_MAX_STACK:
        raise ValueError(f"level_sum: the program nests deeper than "
                         f"{K20_MAX_STACK}")
    for op, a in prog:
        if op in (LEVEL_PUSH, LEVEL_ADDOP) and not 0 <= a < len(operands):
            raise ValueError(f"level_sum: operand {a} of {len(operands)}")
    # the output shape, grown reference by reference (from the target's)
    out = [1] * rank if shape is None else list(_aligned(shape, rank,
                                                         "the output"))
    refs: list = []
    pad = [0] * (K20_MAX_DIMS - rank)

    def ref(t, name, dtypes):
        if not torch.is_tensor(t) or (card and not t.is_cuda) or \
                t.dtype not in dtypes:
            raise ValueError(
                f"level_sum: {name} is {getattr(t, 'dtype', type(t))} on "
                f"{getattr(t, 'device', None)} (expected {dtypes}"
                f"{' on the card' if card else ''})")
        _grow(out, t.shape, rank, name)
        # its strides over the output: 0 on an axis it broadcasts over
        lead = rank - t.dim()
        refs.extend([t.data_ptr(), _DT[t.dtype]] + [0] * lead
                    + [0 if n == 1 else x for n, x in zip(t.shape,
                                                          t.stride())]
                    + pad)
        return len(refs) // K20_REF - 1

    ints = _INDEX_DT + (torch.bool, torch.uint8)
    opw = []
    for o in operands:
        k = o["kind"]
        if k == "dense":
            w = [0, ref(o["x"], "a dense term", (torch.float32,)), -1, -1,
                 0, 0]
        elif k == "eq":
            st = o["state"]
            vdt = (torch.float32,) + ints
            r0 = ref(o["val"], "an equality's value", vdt)
            r1 = ref(o["obs"], "an equality's observation", vdt)
            r2 = ref(st, "a state", ints) if torch.is_tensor(st) else -1
            fl = 1 if o["float"] else (
                2 if o["val"].is_floating_point()
                or o["obs"].is_floating_point() else 0)
            w = [1, r0, r1, r2, 0 if torch.is_tensor(st) else int(st), fl]
        elif k == "sel":
            st = o["state"]
            r0 = ref(o["obs_ld"], "an observation's log-density",
                     (torch.float32,))
            r1 = ref(o["miss"], "a missing log-density", (torch.float32,))
            r2 = ref(st, "a state", ints) if torch.is_tensor(st) else -1
            w = [2, r0, r1, r2, 0 if torch.is_tensor(st) else int(st), 0]
        elif k == "gather":
            M = o["M"]
            if not ((M.is_cuda or not card) and M.dtype == torch.float32
                    and M.dim() == 2 and M.shape[0] == M.shape[1]
                    and M.is_contiguous()):
                raise ValueError("level_sum: a gather's matrix must be a "
                                 "contiguous square float32 on the card")
            _grow(out, o["shape"], rank, "a gather")
            w = [3, ref(o["obs"], "a gather's code", _INDEX_DT),
                 ref(o["word"], "a gather's word", _INDEX_DT), -1,
                 M.data_ptr(), int(M.shape[0])]
        else:
            raise ValueError(f"level_sum: operand kind {k!r} is not one of "
                             f"{K20_KINDS}")
        opw += w
    if shape is not None and tuple(out) != tuple(shape):
        raise ValueError(f"level_sum: a level of {tuple(out)} does not "
                         f"broadcast to {tuple(shape)}")
    shape = tuple(out)
    n_refs = len(refs) // K20_REF
    if n_refs > K20_MAX_REFS:
        raise ValueError(f"level_sum: {n_refs} tensors (at most "
                         f"{K20_MAX_REFS})")
    sizes, strides = level_axes(shape, [refs[K20_REF * r + 2:
                                              K20_REF * r + 2 + rank]
                                         for r in range(n_refs)])
    N, m = math.prod(shape), len(sizes)
    rows = N // sizes[-1] if N else 0
    narrow = max([N, rows * sizes[-1]] + [sum((n - 1) * x for n, x in
                                              zip(sizes, st))
                                          for st in strides]) < 2 ** 31
    depth = level_stack(prog)
    if fused:
        kernel = next(i for i, (d, nar) in enumerate(SCORE_KERNELS)
                      if depth <= d and (not nar or narrow))
        elems = 1
    else:
        elems = (8 if depth <= 4 else 4) if N >= K20_WIDE else 1
        kernel = next(i for i, (d, nar, e) in enumerate(K20_KERNELS)
                      if depth <= d and (not nar or narrow and e == elems))
        elems = K20_KERNELS[kernel][2]
    tpr = -(-sizes[-1] // elems)
    words = [N, m] + sizes + [1] * (K20_MAX_DIMS - m) + \
        [0, n_refs, len(operands), len(prog), tpr, rows, rows * tpr,
         _divider(tpr)] + [_divider(n) for n in sizes[:-1]] + \
        [0] * (K20_MAX_DIMS - m) + [kernel]
    words += [0] * (K20_HEAD - len(words))
    for r, st in enumerate(strides):
        refs[K20_REF * r + 2:K20_REF * (r + 1)] = st + [0] * (K20_MAX_DIMS - m)
    return words + refs + opw + [(op << 32) | a for op, a in prog], shape


def level_axes(shape, strides) -> tuple:
    """(sizes, strides): the output's axes merged for K20, the size-1 axes
    dropped and each axis folded into the one outside it where every
    reference walks the two as one (its outer stride = inner stride x
    inner size; the output is contiguous), so the innermost axis is as
    long as the references allow; `strides` each reference's strides over
    `shape`, returned over the merged axes. One axis of 1 where the
    output is one element."""
    axes = [d for d, n in enumerate(shape) if n != 1]
    if not axes:
        return [1], [[0] for _ in strides]
    sizes = [shape[axes[0]]]
    out = [[st[axes[0]]] for st in strides]
    for d in axes[1:]:
        n = shape[d]
        if all(o[-1] == st[d] * n for o, st in zip(out, strides)):
            sizes[-1] *= n
            for o, st in zip(out, strides):
                o[-1] = st[d]
        else:
            sizes.append(n)
            for o, st in zip(out, strides):
                o.append(st[d])
    return sizes, out


def _divider(d: int) -> int:
    """The word csrc/level_sum.cu divides an n < 2^31 by d with: magic |
    shift << 32, n / d = (umulhi(n, magic) + n) >> shift (PyTorch's
    IntDivider)."""
    d = max(d, 1)   # (an empty level's words: no thread divides)
    shift = (d - 1).bit_length()
    return (((1 << 32) * ((1 << shift) - d)) // d + 1) | (shift << 32)


def level_sum(prog, operands, rank: int, B: int = 1, label=None):
    """K20: a level's terms summed in one launch, 1, 4 or 8 consecutive
    output elements a thread (K20_KERNELS; a level past one launch's
    limits in level_stages' launches, each stage's sum in a buffer the
    call owns): `prog` the postfix program (level_program) over `operands`
    (level_dense, level_eq, level_sel, level_gather; each tensor read in
    place with its broadcast strides over the output, aligned to the right
    at `rank` axes), the output a float32 torch.empty buffer of
    level_shape(operands, rank). Dense terms and the log-densities are
    float32, codes and values any dtype of _DT, states integers, each
    gather's matrix a contiguous float32 [V, V]. The plan is built once a
    structure (_K20_PLANS: the program, each operand's kind, static code
    and flag, every tensor's dtype, shape and strides, the label and B) and
    each call writes only the tensors' and the outputs' pointers into it.
    On CPU tensors the plain version; on CUDA ones the kernel or an error.
    Counted in LAUNCH_CENSUS by ("label d=depth B=.. out=shape kinds", r1
    or rn by B, the output size); its fields in CENSUS_FIELDS."""
    key, ptrs = _level_key(prog, operands, rank, B, label)
    ent = _K20_PLANS.get(key)
    if ent is None:
        dev = _level_device(operands)
        if dev.type == "cpu":
            return level_sum_plain(prog, operands, rank)
        if dev.type != "cuda":
            raise RuntimeError(f"level_sum: no kernel for device {dev}")
        ent = _k20_entry(prog, operands, rank, B, label)
        if len(_K20_PLANS) >= _PLAN_CACHE_MAX:
            _K20_PLANS.clear()
        _K20_PLANS[key] = ent
    dev, stages = ent
    if len(stages) > 1:
        _split("level_sum")
    outs, fn = [], _fn("level_sum")
    for words, addr, n, pos, shape, N, mode, fields in stages:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        for at, src in pos:
            words[at] = ptrs[src] if src >= 0 else outs[~src].data_ptr()
        words[K20_OUT] = out.data_ptr()
        _check(fn(addr, n, _stream(out)), "level_sum")
        _count("level_sum", B, N, mode, fields)
        outs.append(out)
    return outs[-1]


# an operand's tensor references by kind, in the plan's order
# (_level_tensors)
_LEVEL_REFS = {"dense": ("x",), "eq": ("val", "obs", "state"),
               "sel": ("obs_ld", "miss", "state"), "gather": ("obs", "word")}
_K20_PLANS: dict = {}


def _level_key(prog, operands, rank: int, B: int, label) -> tuple:
    """(key, pointers): a K20 call's structure (the program, rank, B,
    label, each operand's kind, static states and flag, and every tensor's
    dtype, shape, strides and device index, -1 on the CPU) and its
    tensors' pointers in the plan's order (each operand's references, then
    a gather's matrix). A CPU level's key names no entry: it takes the
    plain version."""
    sig, ptrs = [], []
    for o in operands:
        k = o["kind"]
        row = [k]
        for n in _LEVEL_REFS.get(k, ()):
            t = o[n]
            if isinstance(t, torch.Tensor):
                row.append((t.dtype, t.shape, t.stride(), t.get_device()))
                ptrs.append(t.data_ptr())
            else:
                row.append(t)
        if k == "eq":
            row.append(o["float"])
        elif k == "gather":
            M = o["M"]
            row += [(M.dtype, M.shape, M.stride(), M.get_device()),
                    o["shape"]]
            ptrs.append(M.data_ptr())
        sig.append(tuple(row))
    return (label, B, rank, tuple(prog), tuple(sig)), ptrs


def _k20_entry(prog, operands, rank: int, B: int, label,
               card: bool = True) -> tuple:
    """A _K20_PLANS entry: (device, [(words as an array.array, its address,
    its length, the pointer positions [(word, source)], the output shape,
    its size, census mode, census fields)] a stage of level_stages), a
    source >= 0 the call's pointer (_level_key's order) and ~k stage k's
    output; raises for what the kernel does not take (level_plan)."""
    dev = _level_device(operands)
    first, n = [], 0   # each operand's first pointer
    for o in operands:
        first.append(n)
        n += len(_level_tensors(o)) + (o["kind"] == "gather")
    stages, shapes = [], []
    for p, srcs in level_stages(prog, operands):
        ops_, pos, r = [], [], 0
        for k, i in srcs:
            if k == "o":
                o = operands[i]
                ops_.append(o)
                nr = len(_level_tensors(o))
                pos += [(K20_HEAD + K20_REF * (r + j), first[i] + j)
                        for j in range(nr)]
                r += nr
            else:   # an earlier stage's sum, a dense term
                ops_.append(level_dense(torch.empty(shapes[i], device=dev)))
                pos.append((K20_HEAD + K20_REF * r, ~i))
                r += 1
        words, shape = level_plan(p, ops_, rank, card=card)
        for j, (k, i) in enumerate(srcs):
            if k == "o" and operands[i]["kind"] == "gather":
                pos.append((K20_HEAD + K20_REF * r + K20_OP * j + 4,
                            first[i] + len(_level_tensors(operands[i]))))
        words = array.array("q", words)
        mode = (f"{label} d={rank - 1} B={B} "
                f"out={'x'.join(map(str, shape))} {level_kinds(ops_)}")
        stages.append((words, words.buffer_info()[0], len(words), pos,
                       shape, math.prod(shape), mode,
                       _level_fields(p, ops_, rank, shape)))
        shapes.append(shape)
    return dev, stages


def level_words(prog, operands, rank: int, B: int = 1, label=None,
                card: bool = True) -> list:
    """Each stage's K20 words as a call takes them from _K20_PLANS, with
    these operands' pointers written in (the outputs' 0): a call of a
    cached structure patches exactly these words, which equal a fresh
    level_plan's."""
    key, ptrs = _level_key(prog, operands, rank, B, label)
    key = (card,) + key
    ent = _K20_PLANS.get(key)
    if ent is None:
        ent = _K20_PLANS[key] = _k20_entry(prog, operands, rank, B, label,
                                           card=card)
    out = []
    for words, _addr, _n, pos, *_rest in ent[1]:
        w = list(words)
        for at, src in pos:
            w[at] = ptrs[src] if src >= 0 else 0
        w[K20_OUT] = 0
        out.append(w)
    return out


def py_logprobs_plain(refcount, alive, total, nrows, s, d):
    """The Pitman-Yor prior over a class's slots and a fresh row
    (trace.jl:53-61, block_proposal.jl:86-96), s and d float32 tensors:
    existing [cap] (or [B, cap] with per-row leaves), new [] (or [B])."""
    logden = torch.log(total.to(torch.float32) + s)
    cnt = refcount.to(torch.float32)
    live = alive & (refcount > 0)
    ld = logden[..., None] if logden.dim() else logden
    existing = torch.where(live, torch.log(torch.clamp(cnt - d, min=1e-30))
                           - ld, torch.full_like(cnt, NINF))
    new = torch.log(d * nrows.to(torch.float32) + s) - logden
    return existing, new


def py_prior_plain(refcount, alive, total, nrows, strength, discount, comp,
                   children, new_children, full):
    """K21's plain version, the batched score_fk's own arithmetic
    (BlockTracer.py_logprobs, the compaction's select and the adds): the
    Pitman-Yor prior of every candidate slot, log(max(refcount - d,
    1e-30)) - log(total + s) where alive and referenced, else NEG_INF,
    through the compaction `comp` = (idx [Kc], nc) where given (pads past
    nc NEG_INF), plus the children [.., K]; the fresh row's log(d nrows +
    s) - log(total + s) plus new_children [..]. Leaves [cap] or per row
    [B, cap] (total and nrows then [B]); s and d device scalars or
    numbers. Returns K1's inputs (exist [R, K], new [R]) over the
    enumeration rows `full`."""
    from .engine.propose import _rtake

    dev = children.device
    full = tuple(full)
    depth = len(full) - 1
    s, d = (v if torch.is_tensor(v) else torch.tensor(float(v), device=dev)
            for v in (strength, discount))
    existing, new = py_logprobs_plain(refcount, alive, total, nrows, s, d)
    cap = int(refcount.shape[-1])
    if comp is not None:
        idx, nc = comp
        K = int(idx.shape[0])
        pos = torch.arange(K, device=dev)
        slot_ids = torch.clamp(idx, max=cap - 1)
        existing = torch.where(pos < nc, _rtake(existing, slot_ids[None, :]),
                               torch.full((), NINF, device=dev))
    else:
        K = cap
    exist = existing.reshape((-1,) + (1,) * depth + (K,)) + children
    new = new.reshape(-1)
    new = new.reshape((new.shape[0],) + (1,) * depth) + new_children
    return (exist.expand(full + (K,)).reshape(-1, K).contiguous(),
            new.expand(full).reshape(-1).contiguous())


def _f32_bits(x: float) -> int:
    import struct
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


def py_prior_words(refcount, alive, total, nrows, strength, discount,
                   comp, children, new_children, full, exist, new,
                   card: bool = True) -> list:
    """K21's plan (csrc/py_prior.cu's word indices) for writing exist
    [R, K] and new [R] (contiguous float32), with its vector route
    (K21_ROUTE: which loads and stores the addresses let move as 16-byte
    vectors), its kernel (K21_UNIT: 4, the row kernel, where that gives
    each of exist's card's SMs a block of K21_THREADS, else 1, the flat
    one: a short call waits on one thread's chain of loads and logs) and
    the row kernel's threads a row (K21_ROW_LOG); refuses what the kernel
    does not take, and, with `card`, tensors off the card."""
    def on(t):
        return t.is_cuda or not card

    full, R = _score_rows(full)
    B = full[0]
    cap = int(refcount.shape[-1])
    for t, name, dt in ((refcount, "refcount", torch.int32),
                        (alive, "alive", torch.bool)):
        if not on(t) or t.dtype != dt or t.shape[-1] != cap or \
                t.dim() > 2 or (t.dim() == 2 and t.shape[0] not in (1, B)) \
                or not t.is_contiguous():
            raise ValueError(f"py_prior: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device} (expected a "
                             f"contiguous {dt} [cap] or [B or 1, cap] on "
                             f"the card)")
    per_row = refcount.dim() == 2 and refcount.shape[0] == B and B > 1
    if per_row != (alive.dim() == 2 and alive.shape[0] == B and B > 1):
        raise ValueError("py_prior: refcount and alive must both be per "
                         "row or both shared")
    words = [0] * K21_WORDS
    words[0:4] = [refcount.data_ptr(), alive.data_ptr(),
                  cap if per_row else 0, cap]
    for j, (t, name) in enumerate(((total, "total"), (nrows, "nrows"))):
        if not on(t) or t.dtype not in (torch.int32, torch.int64,
                                            torch.float32) or \
                t.numel() not in (1, B) or t.dim() > 1:
            raise ValueError(f"py_prior: {name} must be one int or float "
                             f"element, or [B], on the card")
        words[4 + 3 * j: 7 + 3 * j] = [t.data_ptr(), _DT[t.dtype],
                                       1 if t.numel() > 1 else 0]
    for j, (v, name) in enumerate(((strength, "strength"),
                                   (discount, "discount"))):
        if torch.is_tensor(v):
            if v.numel() != 1 or v.dtype != torch.float32 or not on(v):
                raise ValueError(f"py_prior: {name} must be one float32 "
                                 f"element on the card")
            words[10 + 2 * j] = v.data_ptr()
        else:
            words[11 + 2 * j] = _f32_bits(v)
    if comp is not None:
        idx, nc = comp
        for t, name in ((idx, "comp idx"), (nc, "comp nc")):
            if not torch.is_tensor(t) or not on(t) or \
                    t.dtype not in _INDEX_DT:
                raise ValueError(f"py_prior: {name} must be an int tensor "
                                 f"on the card")
        if idx.dim() != 1 or not idx.is_contiguous() or nc.numel() != 1:
            raise ValueError("py_prior: comp must be (idx [Kc] contiguous, "
                             "nc one element)")
        K = int(idx.shape[0])
        words[14:18] = [idx.data_ptr(), _DT[idx.dtype], nc.data_ptr(),
                        _DT[nc.dtype]]
    else:
        K = cap
    if K < 1:
        raise ValueError("py_prior: no candidate slot")
    chs = _strided(children, full + (K,), "py_prior children",
                   (torch.float32,), card)
    ncs = _strided(new_children, full, "py_prior new_children",
                   (torch.float32,), card)
    for t, n in ((exist, R * K), (new, R)):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.numel() != n:
            raise ValueError("py_prior: the outputs must be contiguous "
                             "float32 [R, K] and [R]")
    nd = len(full)
    if R >= 1 << 31 or max(full) >= 1 << 32:
        raise ValueError(f"py_prior: {R} rows over {full} (the kernel "
                         f"takes fewer than 2^31 rows, axes below 2^32)")
    words[18:24] = [children.data_ptr(), new_children.data_ptr(),
                    exist.data_ptr(), new.data_ptr(), R, K]
    words[24] = nd
    words[25:25 + nd] = list(full)
    words[33:33 + nd] = list(chs)[:nd]
    words[41] = chs[nd]
    words[42:42 + nd] = list(ncs)[:nd]
    # the route: a vector where every row's address along k is 16-byte
    # aligned (4-byte for alive's four bytes)
    route = 0
    if comp is None and refcount.data_ptr() % 16 == 0 and \
            alive.data_ptr() % 4 == 0 and words[2] % 4 == 0:
        route |= K21_LEAF_VEC
    if chs[nd] == 1 and children.data_ptr() % 16 == 0 and all(
            st % 4 == 0 for n, st in zip(full, chs) if n > 1):
        route |= K21_CH_VEC
    if K % 4 == 0 and exist.data_ptr() % 16 == 0:
        route |= K21_EXIST_VEC
    if comp is not None and comp[0].dtype in (torch.int32, torch.int64) \
            and comp[0].data_ptr() % 16 == 0:
        route |= K21_IDX_VEC
    # the kernel by the call's size; the row kernel's threads a row:
    # enough for its units of four, up to the block
    spread = sm_count(exist.device) * K21_THREADS
    words[K21_ROUTE] = route
    words[K21_UNIT] = 4 if R * -(-K // 4) >= spread else 1
    words[K21_ROW_LOG] = min(K21_THREADS.bit_length() - 1,
                             (-(-K // 4) - 1).bit_length())
    return words


def py_prior(refcount, alive, total, nrows, strength, discount, comp,
             children, new_children, full, cls=None):
    """K21: py_prior_plain in one launch (py_prior_words' kernel: a row a
    group of threads four candidates at a time, or a thread an entry),
    into K1's two inputs: refcount int32 and alive
    bool [cap] or [B or 1, cap] (contiguous), total and nrows one element
    or [B] (int32, int64 or float32), strength and discount device float32
    scalars or numbers, comp None or (idx int [Kc] contiguous, nc an int
    scalar on the card), children [.., K] and new_children [..] float32
    read in place with their broadcast strides over `full` (<= 8 axes, the
    batch axis first). Returns (exist [R, K], new [R]) float32 in torch.empty
    buffers. On CPU tensors the plain version; on CUDA ones the kernel or
    an error. Counted in LAUNCH_CENSUS by ("cls full=.. cap=..[ comp][
    rows][ ch=shared or bcast]", r1 or rn, K): the children vary over the
    rows unless ch= says they are one row's (shared) or one value
    (bcast); its fields in CENSUS_FIELDS."""
    if not _route(children, "py_prior"):
        return py_prior_plain(refcount, alive, total, nrows, strength,
                              discount, comp, children, new_children, full)
    full, R = _score_rows(full)
    K = int(comp[0].shape[0]) if comp is not None else \
        int(refcount.shape[-1])
    exist = torch.empty((R, K), dtype=torch.float32, device=children.device)
    new = torch.empty((R,), dtype=torch.float32, device=children.device)
    words = py_prior_words(refcount, alive, total, nrows, strength,
                           discount, comp, children, new_children, full,
                           exist, new)
    arr = (ctypes.c_int64 * K21_WORDS)(*words)
    rc = _fn("py_prior")(arr, K21_WORDS, _stream(children))
    _check(rc, "py_prior")
    B, cap, per_row = full[0], int(refcount.shape[-1]), words[2] != 0
    ch = "bcast" if words[41] == 0 else (
        "rows" if any(words[33:33 + len(full)]) else "shared")
    mode = (f"{cls} full={'x'.join(map(str, full))} cap={cap}"
            f"{' comp' if comp is not None else ''}"
            f"{' rows' if per_row else ''}"
            f"{'' if ch == 'rows' else ' ch=' + ch}")
    _count("py_prior", B, K, mode,
           dict(B=B, full=full, cap=cap, comp=comp is not None,
                per_row=per_row, sd=torch.is_tensor(strength),
                counts=(total.dtype, nrows.dtype), ch=ch))
    return exist, new


# ---------------------------------------------------------------- K22, K23

# the Philox stream and the gamma draw (csrc/gamma.cuh): streams of the
# counter's last word, the rounds a gamma draw may take, the modes of a
# K22 descriptor and the plans' word counts and limits (csrc/gamma_draw.cu,
# py_resample.cu)
GAMMA_ROUNDS = 16
GAMMA_STREAM, PY_GAMMA_STREAM, PY_UNIFORM_STREAM = 0, 1, 2
K22_MODES = ("gamma", "dirichlet_log", "beta")
K22_HEAD, K22_DESC, K22_MAX_DESC = 8, 16, 64
# K22's geometry (csrc/gamma_draw.cu): a row a block of the launch's widest
# P = _pow2(width) threads (32 to K22_THREADS; P / K22_THREADS elements a
# thread past that); a launch takes K22_MAX_DESC descriptors and
# K22_MAX_ROWS rows, listed in its plan at word K22_ROWS_AT (PERF.md
# section 6: a group of lanes a row measured no faster)
K22_MAX_ROWS, K22_THREADS = 2048, 256
K22_ROWS_AT = K22_HEAD + K22_DESC * K22_MAX_DESC
K23_HEAD, K23_CLASS, K23_MAX_CLASSES = 4, 12, 64
# K23's geometry (csrc/py_resample.cu): one block a class up to
# K23_MAX_THREADS slots, past that a cluster of up to K23_CLUSTER blocks
# (16, non-portable; 8 the portable size) of K23_MIN_THREADS to
# K23_MAX_THREADS, then up to K23_MAX_SLOTS slots a thread in registers;
# past that a thread's slots in rounds of K23_MAX_SLOTS, at most
# K23_MAX_ROUNDS slots a thread (the rounds' bases in shared memory: a
# class of up to 16 x 1,024 x 8,192 slots) (PERF.md section 6: the A/B of
# these sizes)
K23_MAX_THREADS, K23_MAX_CLUSTER, K23_MAX_SLOTS = 1024, 16, 16
K23_CLUSTER, K23_MIN_THREADS, K23_MAX_ROUNDS = 16, 256, 8192
_M32 = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi


def draw_seed(gen: torch.Generator, device) -> torch.Tensor:
    """One 64-bit seed of the Philox stream, an int64 [1] drawn from `gen`
    on `device` (no host sync; a registered generator's draw can be
    captured)."""
    return torch.randint(0, 2 ** 63 - 1, (1,), generator=gen,
                         device=device, dtype=torch.int64)


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m, a an int64 tensor of 32-bit values
    and m a 32-bit constant, from 16-bit halves so nothing overflows."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    mid = a_lo * m_hi + a_hi * m_lo
    lo = a_lo * m_lo + ((mid & 0xFFFF) << 16)
    return (a_hi * m_hi + (mid >> 16) + (lo >> 32)) & _M32, lo & _M32


def philox_plain(c0, c1, c2, c3, k0, k1) -> tuple:
    """Philox4x32-10 (csrc/gamma.cuh's philox) of counters (c0..c3) under
    key (k0, k1), every word a 32-bit value in an int64 tensor."""
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _M32
            k1 = (k1 + 0xBB67AE85) & _M32
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _unit(x):
    """gamma.cuh's unit: a word's top 24 bits times 2^-24, in [0, 1)."""
    return (x >> 8).to(torch.float32) * 2.0 ** -24


def _open_unit(x):
    """gamma.cuh's open_unit: (2 (top 23 bits) + 1) 2^-24, in (0, 1)."""
    return (((x >> 9) << 1) | 1).to(torch.float32) * 2.0 ** -24


def _stream_draw(seed, elem, rounds, stream: int) -> tuple:
    """The Philox blocks of elements `elem` (int64 [N]) at rounds
    `rounds` (int64 [R, 1] or a number) of `stream`, under the seed
    (int64 [1]): four int64 tensors of 32-bit words."""
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    c2 = torch.as_tensor(rounds, device=elem.device).expand(
        torch.broadcast_shapes(torch.as_tensor(rounds).shape, elem.shape))
    e = elem.expand(c2.shape)
    return philox_plain(e & _M32, e >> 32, c2, torch.full_like(e, stream),
                        k0, k1)


def gamma_trials(alpha, elem, seed, stream: int = GAMMA_STREAM) -> tuple:
    """Every one of the GAMMA_ROUNDS Marsaglia-Tsang rounds of csrc/
    gamma.cuh's draw_gamma at once, in torch ops: (d [N], d v [R, N],
    accepted [R, N], boost uniforms [R, N]) for float32 alpha [N] at
    elements `elem` (int64 [N]) of `stream` under the seed (int64 [1])."""
    alpha = alpha.to(torch.float32).reshape(-1)
    a = torch.where(alpha < 1.0, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    rounds = torch.arange(GAMMA_ROUNDS, device=alpha.device)[:, None]
    w0, w1, w2, w3 = _stream_draw(seed, elem.reshape(1, -1), rounds, stream)
    x = torch.sqrt(-2.0 * torch.log(_open_unit(w0))) * \
        torch.cos(_TWO_PI * _unit(w1))
    t = 1.0 + c * x
    v = t * t * t
    logv = torch.log(torch.where(v > 0, v, torch.ones_like(v)))
    rhs = 0.5 * x * x + d - d * v + d * logv
    ok = (v > 0) & (torch.log(_open_unit(w2)) < rhs)
    return d, d * v, ok, _open_unit(w3)


def gamma_plain(alpha, elem, seed, stream: int = GAMMA_STREAM):
    """csrc/gamma.cuh's draw_gamma in torch ops, bit for bit on the card:
    Gamma(alpha, 1) of float32 alpha [N], element `elem` (int64 [N]) of
    `stream` under the seed (int64 [1]), Marsaglia-Tsang with the alpha <
    1 boost, every round drawn at once (gamma_trials) and the first that
    accepts kept (none: d, with the last round's boost uniform)."""
    alpha = alpha.to(torch.float32).reshape(-1)
    d, dv, ok, ub = gamma_trials(alpha, elem, seed, stream)
    first = ok.to(torch.int8).argmax(0, keepdim=True)
    hit = ok.any(0)
    out = torch.where(hit, dv.gather(0, first)[0], d)
    ub = torch.where(hit, ub.gather(0, first)[0], ub[-1])
    return torch.where(alpha < 1.0, out * torch.pow(ub, 1.0 / alpha), out)


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def tree_sum_plain(x):
    """The kernels' fixed-order sum along the last axis: x padded with
    zeros to the next power of two P, then x[:h] + x[h:2h] for h = P / 2,
    ..., 1 (K22's row sums, K23's scores)."""
    P = _pow2(x.shape[-1])
    if P > x.shape[-1]:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (P - x.shape[-1],))],
                      -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def gamma_desc(mode: str, base, rows: int, width: int, counts=None) -> dict:
    """One K22 descriptor: `rows` rows of `width` Gamma(alpha) draws,
    alpha[i, j] = base[j] (base float32 [width], or [1] for every j) +
    counts[i, j] (an int32 or int64 [rows, width] tensor, any strides, or
    None), then by mode: "gamma" the draws [rows, width];
    "dirichlet_log" log(g / its row's tree sum) [rows, width] (Dirichlet
    rows); "beta" g[:, 0] / (g[:, 0] + g[:, 1]) [rows] (width 2)."""
    if mode not in K22_MODES:
        raise ValueError(f"gamma_draw: mode {mode!r} is not one of "
                         f"{K22_MODES}")
    if counts is not None and counts.dim() == 1:
        counts = counts.reshape(1, -1)
    return dict(mode=mode, base=base, rows=int(rows), width=int(width),
                counts=counts)


def gamma_out_shape(dc) -> tuple:
    return (dc["rows"],) if dc["mode"] == "beta" else \
        (dc["rows"], dc["width"])


def _desc_alpha(dc):
    base = dc["base"].to(torch.float32).reshape(-1)
    alpha = base.expand(dc["rows"], dc["width"]) if base.numel() == 1 else \
        base[None, :].expand(dc["rows"], dc["width"])
    if dc["counts"] is not None:
        alpha = alpha + dc["counts"].to(torch.float32)
    return alpha


def gamma_draw_plain(descs, seed, outs=None) -> list:
    """K22's plain version: every descriptor's draws on the one stream of
    `seed` (int64 [1]; a descriptor's element (i, j) is the counter's
    element (the earlier descriptors' elements) + i width + j), its row
    sums by tree_sum_plain; returns each descriptor's output (written into
    outs[k] where given)."""
    res, elem0 = [], 0
    for k, dc in enumerate(descs):
        R, W = dc["rows"], dc["width"]
        alpha = _desc_alpha(dc)
        elem = torch.arange(elem0, elem0 + R * W, device=alpha.device)
        g = gamma_plain(alpha.reshape(-1), elem, seed).reshape(R, W)
        elem0 += R * W
        if dc["mode"] == "gamma":
            out = g
        else:
            s = tree_sum_plain(g)
            out = torch.log(g / s[:, None]) if dc["mode"] == "dirichlet_log" \
                else g[:, 0] / s
        if outs is not None and outs[k] is not None:
            outs[k].copy_(out)
            out = outs[k]
        res.append(out)
    return res


def gamma_draw_mode(descs) -> str:
    """K22's LAUNCH_CENSUS mode: the descriptors, elements and widest
    row of a call."""
    return (f"descs={len(descs)} elems="
            f"{sum(d['rows'] * d['width'] for d in descs)} "
            f"width={max(d['width'] for d in descs)}")


def gamma_draw_plan(shapes) -> list:
    """K22's launches for descriptors of these (mode, rows, width): each
    dict(parts, rows, threads). A part is (descriptor, first row, rows,
    E), E = max(1, P / threads) elements a thread (P = _pow2(width));
    `rows` lists the launch's rows (part, row in the part), a block each;
    threads: the launch's widest P, 32 to K22_THREADS. A descriptor's
    rows are cut into parts where a launch fills (K22_MAX_DESC parts,
    K22_MAX_ROWS rows)."""
    launches, cur = [], None

    def flush():
        if cur is None or not cur["parts"]:
            return
        T = min(K22_THREADS, max([32] + [
            _pow2(shapes[k][2]) for k, _r, _n, _e in cur["parts"]]))
        cur["parts"] = [(k, r, n, max(1, _pow2(shapes[k][2]) // T))
                        for k, r, n, _e in cur["parts"]]
        cur["threads"] = T
        launches.append(cur)

    for k, (mode, rows, width) in enumerate(shapes):
        if mode not in K22_MODES or rows < 0 or width < 1 or \
                (mode == "beta" and width != 2):
            raise ValueError(f"gamma_draw: {rows} rows of {width} ({mode})")
        r = 0
        while r < rows:
            room = 0 if cur is None else K22_MAX_ROWS - len(cur["rows"])
            if room <= 0 or len(cur["parts"]) == K22_MAX_DESC:
                flush()
                cur = dict(parts=[], rows=[])
                continue
            take = min(rows - r, room)
            cur["rows"] += [(len(cur["parts"]), i) for i in range(take)]
            cur["parts"].append((k, r, take, 0))
            r += take
    flush()
    return launches


def gamma_draw_words(descs, launch: dict) -> tuple:
    """One K22 launch's plan (gamma_draw_plan's `launch` over `descs`):
    (words, pointer positions [(word, "seed" / "base" / "cnt" / "out",
    descriptor, byte offset)]), every pointer 0: the header, a descriptor
    a part (its counts, output and first element moved to the part's
    first row), the unused descriptors 0, then the row table, int32
    entries part + 64 row, two a word."""
    words = [len(launch["parts"]), 0, len(launch["rows"]),
             launch["threads"], 0, 0, 0, 0]
    pos = [(1, "seed", None, 0)]
    elem0, e = [], 0
    for dc in descs:
        elem0.append(e)
        e += dc["rows"] * dc["width"]
    for k, r0, rows, E in launch["parts"]:
        dc = descs[k]
        W, cnt = dc["width"], dc["counts"]
        at = len(words)
        cw = [0, 0, 0, 0]
        if cnt is not None:
            cw = [0, _DT[cnt.dtype], cnt.stride(0), cnt.stride(1)]
            pos.append((at + 7, "cnt", k,
                        r0 * cnt.stride(0) * cnt.element_size()))
        ors = 1 if dc["mode"] == "beta" else W
        pos += [(at + 5, "base", k, 0), (at + 11, "out", k, 4 * r0 * ors)]
        words += [K22_MODES.index(dc["mode"]), rows, W, _pow2(W), E, 0,
                  0 if dc["base"].numel() == 1 else 1] + cw + \
            [0, ors, elem0[k] + r0 * W, 0, 0]
    words += [0] * (K22_ROWS_AT - len(words))
    ents = [p + 64 * i for p, i in launch["rows"]]
    if len(ents) % 2:
        ents.append(0)
    words += [ents[i] | (ents[i + 1] << 32) for i in range(0, len(ents), 2)]
    return words, pos


_K22_PLANS: dict = {}


def _k22_key(dc, out) -> tuple:
    b, c = dc["base"], dc["counts"]
    return (dc["mode"], dc["rows"], dc["width"], b.dtype, b.shape,
            b.get_device(), b.is_contiguous(),
            None if c is None else (c.dtype, c.shape, c.stride(),
                                    c.get_device()),
            None if out is None else (out.dtype, out.shape, out.get_device(),
                                      out.is_contiguous()))


def _k22_check(descs, outs) -> None:
    """Raises for descriptors or outputs that K22 does not take."""
    for k, dc in enumerate(descs):
        R, W = dc["rows"], dc["width"]
        if R < 0 or W < 1 or (dc["mode"] == "beta" and W != 2):
            raise ValueError(f"gamma_draw: {R} rows of {W} ({dc['mode']})")
        base = dc["base"]
        if not base.is_cuda or base.dtype != torch.float32 or \
                not base.is_contiguous() or base.numel() not in (1, W):
            raise ValueError(f"gamma_draw: base {base.dtype} "
                             f"{tuple(base.shape)} on {base.device}")
        cnt = dc["counts"]
        if cnt is not None and (
                not cnt.is_cuda or cnt.dtype not in (torch.int32, torch.int64)
                or tuple(cnt.shape) != (R, W)):
            raise ValueError(f"gamma_draw: counts {cnt.dtype} "
                             f"{tuple(cnt.shape)} (expected int [{R}, "
                             f"{W}] on the card)")
        out = outs[k] if outs is not None else None
        shape = gamma_out_shape(dc)
        if out is not None and (
                not out.is_cuda or out.dtype != torch.float32 or
                tuple(out.shape) != shape or not out.is_contiguous()):
            raise ValueError(f"gamma_draw: output {out.dtype} "
                             f"{tuple(out.shape)} (expected float32 {shape})")


def _k22_entry(descs, outs) -> tuple:
    """A _K22_PLANS entry for descriptors of this structure (checked by
    _k22_check): (the outputs' buffer elements, [(offset, shape, strides)]
    of each output the caller does not pass, else None), [(words as an
    array.array, its address, its length, pointer positions, rows,
    elements, census mode, census fields)] a launch)."""
    layout, total = [], 0
    for k, dc in enumerate(descs):
        if outs is not None and outs[k] is not None:
            layout.append(None)
            continue
        shape = gamma_out_shape(dc)
        layout.append((total, shape, (shape[-1], 1)[-len(shape):]))
        total += math.prod(shape)
    launches = []
    for launch in gamma_draw_plan(
            [(d["mode"], d["rows"], d["width"]) for d in descs]):
        words, pos = gamma_draw_words(descs, launch)
        arr = array.array("q", words)
        sub = [dict(descs[k], rows=n) for k, _r0, n, _e in launch["parts"]]
        launches.append((arr, arr.buffer_info()[0], len(arr), pos,
                         sum(d["rows"] for d in sub),
                         sum(d["rows"] * d["width"] for d in sub),
                         gamma_draw_mode(sub),
                         dict(descs=[(d["mode"], d["rows"], d["width"],
                                      d["counts"] is not None)
                                     for d in sub])))
    return total, layout, launches


def gamma_draw(descs, seed, outs=None) -> list:
    """K22: gamma_draw_plain's draws in one launch (gamma_draw_plan: a
    block a row; another launch past K22_MAX_DESC descriptors or
    K22_MAX_ROWS rows), the
    seed read on the card. Outputs in views of one torch.empty buffer, or
    in outs[k] (a contiguous float32 tensor of the output's shape: a
    parameter leaf, written in place). The plan is built once for a call
    structure (_K22_PLANS: modes, rows, widths, the tensors' kinds); a call
    writes only its pointers into it. On CPU tensors the plain version; on
    CUDA ones the kernel or an error. Counted in LAUNCH_CENSUS by
    (gamma_draw_mode, r1 or rn by the rows, the elements)."""
    if not descs:
        return []
    if not _route(seed, "gamma_draw"):
        return gamma_draw_plain(descs, seed, outs)
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError("gamma_draw: the seed must be an int64 [1] on the "
                         "card")
    key = (seed.get_device(), tuple(
        _k22_key(dc, None if outs is None else outs[k])
        for k, dc in enumerate(descs)))
    ent = _K22_PLANS.get(key)
    if ent is None:
        _k22_check(descs, outs)
        ent = _k22_entry(descs, outs)
        if len(_K22_PLANS) >= _PLAN_CACHE_MAX:
            _K22_PLANS.clear()
        _K22_PLANS[key] = ent
    return _k22_run(descs, seed, outs, ent, True)


def _k22_run(descs, seed, outs, ent, count: bool) -> list:
    """A _K22_PLANS entry's launches for these descriptors (_k22_fill),
    counted where `count`; returns the outputs."""
    res, launches = _k22_fill(descs, seed, outs, ent)
    fn, stream = _fn("gamma_draw"), _stream(seed)
    for _words, addr, n, _pos, rows, elems, mode, fields in launches:
        _check(fn(addr, n, stream), "gamma_draw")
        if count:
            _count("gamma_draw", rows, elems, mode, fields)
    return res


def _k22_fill(descs, seed, outs, ent) -> tuple:
    """The outputs of a _K22_PLANS entry's call (views of one new buffer
    where outs does not give them; one output its own tensor), and its
    launches with this call's pointers written into their words."""
    total, layout, launches = ent
    new = [lay for lay in layout if lay is not None]
    if len(new) == 1:
        buf = torch.empty(new[0][1], dtype=torch.float32, device=seed.device)
    elif new:
        buf = torch.empty((total,), dtype=torch.float32, device=seed.device)
    res = []
    for k, lay in enumerate(layout):
        if lay is None:
            res.append(outs[k])
        elif len(new) == 1:
            res.append(buf)
        else:
            res.append(buf.as_strided(lay[1], lay[2], lay[0]))
    ptr = {"seed": seed.data_ptr()}
    for k, dc in enumerate(descs):
        ptr["base", k] = dc["base"].data_ptr()
        ptr["out", k] = res[k].data_ptr()
        if dc["counts"] is not None:
            ptr["cnt", k] = dc["counts"].data_ptr()
    for words, _addr, _n, pos, *_rest in launches:
        for at, what, k, off in pos:
            words[at] = (ptr[what] if k is None else ptr[what, k]) + off
    return res, launches


def py_class(refcount, alive, strength, discount) -> dict:
    """One K23 class: its reference counts (int32 [cap]), relational alive
    bits (bool [cap]) and Pitman-Yor (strength, discount) (float32
    scalars)."""
    return dict(refcount=refcount, alive=alive, strength=strength,
                discount=discount)


def py_score_plain(nb, jn, szf, on, s, d):
    """K23's score(s, d) from the scans (n_before, j, sizes as float32
    [cap], on the counted slots): every slot's term by the kernel's
    ops, summed by tree_sum_plain."""
    zero = torch.zeros((), device=szf.device)
    tn = torch.log(torch.clamp(jn * d + s, min=1e-30)) - torch.log(nb + s)
    inner = (torch.lgamma(torch.clamp(szf - d, min=1e-30))
             - torch.lgamma(1.0 - d)) \
        - (torch.lgamma(nb + szf + s) - torch.lgamma(nb + 1.0 + s))
    inner = torch.where(szf > 1, inner, zero)
    return tree_sum_plain(torch.where(on, tn + inner, zero))


def py_resample_plain(classes, seed, outs=None, scores=None) -> list:
    """K23's plain version, pclean_tpu's resample_py for every class on
    the stream of `seed` (int64 [1]; class k draws its Gamma(1, 1) at
    element k of stream PY_GAMMA_STREAM and u0, u1, u2 from element k of
    PY_UNIFORM_STREAM): the scans as integer cumsums, the scores by
    py_score_plain, the two accepts. Returns [(s1, d1)] (written into
    outs[k] where given). `scores`: a list that receives each class's
    dict(old, new, new2, alpha, log_u0, log_u2, acc, acc2)."""
    res = []
    for k, c in enumerate(classes):
        rc, al = c["refcount"], c["alive"]
        dev = rc.device
        on = al & (rc > 0)
        sz = torch.where(on, rc.long(), torch.zeros((), dtype=torch.long,
                                                    device=dev))
        nb = (torch.cumsum(sz, 0) - sz).to(torch.float32)
        jn = torch.cumsum(on.long(), 0).to(torch.float32)
        szf = sz.to(torch.float32)
        s0 = c["strength"].to(torch.float32).reshape(())
        d0 = c["discount"].to(torch.float32).reshape(())
        elem = torch.full((1,), k, dtype=torch.int64, device=dev)
        sp = gamma_plain(torch.ones((1,), device=dev), elem, seed,
                         PY_GAMMA_STREAM).reshape(())
        w = _stream_draw(seed, elem, 0, PY_UNIFORM_STREAM)
        u0, u1, u2 = (_unit(x).reshape(()) for x in w[:3])
        old = py_score_plain(nb, jn, szf, on, s0, d0)
        new = py_score_plain(nb, jn, szf, on, sp, d0)
        alpha = new + (-s0) - old - (-sp)
        acc = torch.log(u0) < alpha
        s1 = torch.where(acc, sp, s0)
        cur = torch.where(acc, new, old)
        new2 = py_score_plain(nb, jn, szf, on, s1, u1)
        acc2 = torch.log(u2) < (new2 - cur)
        d1 = torch.where(acc2, u1, d0)
        if scores is not None:
            scores.append(dict(old=old, new=new, new2=new2, alpha=alpha,
                               log_u0=torch.log(u0), log_u2=torch.log(u2),
                               cur=cur, acc=acc, acc2=acc2, s_prop=sp,
                               d_prop=u1))
        if outs is not None and outs[k] is not None:
            outs[k][0].copy_(s1)
            outs[k][1].copy_(d1)
            s1, d1 = outs[k]
        res.append((s1, d1))
    return res


def py_resample_plan(caps) -> list:
    """K23's launches for classes of capacities `caps`: a launch a
    K23_MAX_CLASSES of them in order, each sized for its largest class
    (P, the next power of two): one block of T = max(P, 32) threads a
    class where P <= K23_MAX_THREADS, else clusters of CL = min(
    K23_CLUSTER, P / T) blocks of T = min(1,024, max(K23_MIN_THREADS, P /
    K23_CLUSTER)), and P / (CL T) slots a thread (in registers up to
    K23_MAX_SLOTS, in rounds of it past that; at most K23_MAX_ROUNDS, or
    ValueError). Each launch a dict(lo, hi: its classes, threads,
    cluster, slots: its most slots a thread, per_class: each class's
    slots a thread, blocks)."""
    out = []
    for lo in range(0, len(caps), K23_MAX_CLASSES):
        chunk = [int(c) for c in caps[lo:lo + K23_MAX_CLASSES]]
        P = _pow2(max(chunk))
        if P <= K23_MAX_THREADS:
            T, CL = max(32, P), 1
        else:
            T = min(K23_MAX_THREADS, max(K23_MIN_THREADS, P // K23_CLUSTER))
            CL = min(K23_CLUSTER, P // T)
        per = [_pow2(c) // min(_pow2(c), CL * T) for c in chunk]
        if max(per) > K23_MAX_ROUNDS:
            raise ValueError(f"py_resample: a class of {max(chunk)} slots "
                             f"is past {K23_MAX_ROUNDS} slots a thread of "
                             f"{CL} blocks of {T}")
        out.append(dict(lo=lo, hi=lo + len(chunk), threads=T, cluster=CL,
                        slots=max(per), per_class=per,
                        blocks=len(chunk) * CL))
    return out


def py_resample(classes, seed, outs=None) -> list:
    """K23: py_resample_plain in the launches of py_resample_plan (one for
    up to K23_MAX_CLASSES classes), every slot in registers (in rounds
    past K23_MAX_SLOTS a thread), the seed read on the card; (s1, d1)
    written into outs[k] = (strength, discount)
    where given (the parameter leaves themselves: in place), else into
    torch.empty scalars. On CPU tensors the plain version; on CUDA ones
    the kernel or an error. Counted in LAUNCH_CENSUS by ("classes=..
    cap=<largest>", r1 or rn by the classes, the largest cap)."""
    if not classes:
        return []
    if not _route(seed, "py_resample"):
        return py_resample_plain(classes, seed, outs)
    recs, res = k23_classes(classes, seed, outs)
    for pl in py_resample_plan([r[2] for r in recs]):
        chunk = recs[pl["lo"]:pl["hi"]]
        words = [len(chunk), seed.data_ptr(), pl["threads"], pl["cluster"]]
        for r in chunk:
            words += r
        arr = (ctypes.c_int64 * len(words))(*words)
        rc_ = _fn("py_resample")(arr, len(arr), _stream(seed))
        _check(rc_, "py_resample")
        cap = max(r[2] for r in chunk)
        _count("py_resample", len(chunk), cap,
               f"classes={len(chunk)} cap={cap}",
               dict(caps=[r[2] for r in chunk]))
    return res


def k23_classes(classes, seed, outs=None) -> tuple:
    """py_resample's checks and each class's plan words
    (csrc/py_resample.cu): (the classes' words, each class's (s1, d1)
    outputs)."""
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError("py_resample: the seed must be an int64 [1] on the "
                         "card")
    dev = seed.device
    recs, res = [], []
    for k, c in enumerate(classes):
        rc, al = c["refcount"], c["alive"]
        cap = int(rc.shape[0]) if rc.dim() == 1 else -1
        if cap < 1 or not rc.is_cuda or rc.dtype != torch.int32 or \
                not rc.is_contiguous() or al.dtype != torch.bool or \
                tuple(al.shape) != (cap,) or not al.is_contiguous():
            raise ValueError(f"py_resample: refcount {rc.dtype} "
                             f"{tuple(rc.shape)} and alive {al.dtype} "
                             f"{tuple(al.shape)} (expected int32 and bool "
                             f"[cap] on the card)")
        sd = [c["strength"], c["discount"]]
        if outs is not None and outs[k] is not None:
            o = list(outs[k])
        else:
            o = [torch.empty((), dtype=torch.float32, device=dev)
                 for _ in range(2)]
        for t in sd + o:
            if not torch.is_tensor(t) or not t.is_cuda or \
                    t.dtype != torch.float32 or t.numel() != 1:
                raise ValueError("py_resample: strength and discount must "
                                 "be float32 scalars on the card")
        recs.append([rc.data_ptr(), al.data_ptr(), cap, _pow2(cap),
                     sd[0].data_ptr(), sd[1].data_ptr(), o[0].data_ptr(),
                     o[1].data_ptr(), k, 0, 0, 0])
        res.append(tuple(o))
    return recs, res
