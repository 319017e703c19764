"""The port's hand-written CUDA kernels: build, bind, plain versions, counts.

Six kernels carry the block enumeration of the port's paths (sources
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
                       from those statistics (propose.py _ext_gauss_term);
  K6 maybe_swap_ext  — a MaybeSwap external summed over each row's
                       referrers for every option of its enumerated value
                       (propose.py _ext_terms' dense path, the flights
                       Flight time block).

Each has a plain PyTorch version here. A wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches its kernel or
raises. `LAUNCHES` counts kernel launches (plain calls are not counted);
`LAUNCHES_BY_SHAPE` splits the same launches into those over one row
("r1", the sequential loops) and over more ("rn", the batched phases);
`LAUNCH_CENSUS` splits K1's and K2's further by mode and row length.
Each kernel takes a launch plan (path and geometry: threads, tiles,
cluster, shared memory, grid) from a function of its shapes alone,
`enum_logsumexp_plan`, `inv_cdf_plan`, `obs_gather_plan`,
`gauss_suffstats_plan`, `gauss_ext_term_plan` and `maybe_swap_ext_plan`;
the C entry points launch
the plan they are given, so the plan the CPU tests check is the one
launched.

Build: one `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared` per
source, all started together, into pclean_tpu_torch/_build/ (listed in
.gitignore) at first use, skipped where the library is newer than its
sources; the libraries have a plain C interface and are loaded with
ctypes. Nothing is built or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
import time

import torch

from .utils import logsumexp

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
_SOURCES = {
    "enum_logsumexp": "enum_logsumexp.cu",
    "inv_cdf_sample": "inv_cdf_sample.cu",
    "obs_gather_sum": "obs_gather_sum.cu",
    "gauss_suffstats": "gauss_suffstats.cu",
    "gauss_ext_term": "gauss_ext_term.cu",
    "maybe_swap_ext": "maybe_swap_ext.cu",
}
LAUNCHES = {name: 0 for name in _SOURCES}
LAUNCHES_BY_SHAPE = {name: {"r1": 0, "rn": 0} for name in _SOURCES}
# K1's and K2's launches by (mode, "r1" or "rn", K): K1's mode is "fk" or
# "choice", K2's is None; K is the row length the kernel was given
LAUNCH_CENSUS = {"enum_logsumexp": {}, "inv_cdf_sample": {}}
SMEM_MAX = 232448  # shared memory one block may use on an H100 (227 KB)
N_SMS = 132        # streaming multiprocessors of an H100 SXM
_GRID_Y_MAX = 65535
_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCHES_BY_SHAPE[k] = {"r1": 0, "rn": 0}
    for census in LAUNCH_CENSUS.values():
        census.clear()


def _count(name: str, rows: int, K=None, mode=None) -> None:
    shape = "r1" if rows == 1 else "rn"
    LAUNCHES[name] += 1
    LAUNCHES_BY_SHAPE[name][shape] += 1
    if name in LAUNCH_CENSUS:
        key = (mode, shape, K)
        LAUNCH_CENSUS[name][key] = LAUNCH_CENSUS[name].get(key, 0) + 1


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
    srcs = [os.path.join(_HERE, "csrc", _SOURCES[name]),
            os.path.join(_HERE, "csrc", "common.cuh")]
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
        if len(_libs) == len(_SOURCES) and not force:
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
            "gauss_ext_term": [P, I64, P, I64, I32, P, P, P, P, P, P, I64,
                               F32, P, I64, I64, I32, I64, P],
            "maybe_swap_ext": [P, P, P, P, P, P, P, I64, P, P, I64, P, I64,
                               P, I64, I64, I32, I64, I64, P],
        }
        for name in _SOURCES:
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
            fn = getattr(lib, f"pclean_{name}")
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes[name]
            _libs[name] = fn
        return time.time() - t0


def _fn(name):
    if name not in _libs:
        build_kernels()
    return _libs[name]


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


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
        _count("obs_gather_sum", B)
    return out


# ---------------------------------------------------------------- K4

_K45_THREADS = 256


def gauss_suffstats_plan(R: int) -> dict:
    """K4's launch over R referrers: one thread a referrer, dict(threads,
    grid)."""
    return dict(threads=_K45_THREADS, grid=max(1, -(-int(R) // _K45_THREADS)))


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


def gauss_ext_term_plan(B: int, A: int) -> dict:
    """K5's launch over B rows of A options: one thread an output, dict(
    threads, grid)."""
    return dict(threads=_K45_THREADS,
                grid=max(1, -(-int(B) * int(A) // _K45_THREADS)))


def gauss_ext_term_parts(values, tbl, idx, slot, n, sz, szz):
    """The three sums of the closed form, [B, A] each: sum_c szz[s_b, c],
    sum_c mu sz[s_b, c] and sum_c mu^2 n[s_b, c] with mu = values[tbl[idx,
    c]] (gathers clamped)."""
    s = slot.long().clamp(0, n.shape[0] - 1)
    rows = tbl[idx.long().clamp(0, tbl.shape[0] - 1)]             # [B, A, C]
    mu = values[rows.long().clamp(0, values.shape[0] - 1)]
    a_szz = szz[s].sum(-1)[:, None].expand(idx.shape)
    a_sz = (mu * sz[s][:, None, :]).sum(-1)
    a_n = (mu * mu * n[s][:, None, :]).sum(-1)
    return a_szz, a_sz, a_n


def gauss_ext_term_plain(values, tbl, idx, slot, n, sz, szz, pre0,
                         coef: float):
    """coef * (sum szz - 2 sum mu sz + sum mu^2 n) + pre0[slot] -> [B, A],
    the formula of pclean_tpu.engine.propose._ext_gauss_term."""
    a_szz, a_sz, a_n = gauss_ext_term_parts(values, tbl, idx, slot, n, sz,
                                            szz)
    s = slot.long().clamp(0, n.shape[0] - 1)
    return coef * (a_szz - 2.0 * a_sz + a_n) + pre0[s][:, None]


def gauss_ext_term(values, tbl, idx, slot, n, sz, szz, pre0, coef: float):
    """K5. values [I] f32, tbl [E, C] int32, idx [B, A] int32, slot [B]
    int32, n, sz, szz [cap, C] f32, pre0 [cap] f32, coef = -1/(2 std^2) ->
    [B, A] f32, as gauss_ext_term_plain."""
    if not _route(idx, "gauss_ext_term"):
        return gauss_ext_term_plain(values, tbl, idx, slot, n, sz, szz, pre0,
                                    coef)
    values = values.contiguous()
    tbl = tbl.to(torch.int32).contiguous()
    idx = idx.to(torch.int32).contiguous()
    slot = slot.to(torch.int32).contiguous()
    n, sz, szz, pre0 = (x.contiguous() for x in (n, sz, szz, pre0))
    _need(values, torch.float32, "gauss_ext_term values", 1)
    _need(tbl, torch.int32, "gauss_ext_term tbl", 2)
    _need(idx, torch.int32, "gauss_ext_term idx", 2)
    _need(slot, torch.int32, "gauss_ext_term slot", 1)
    for x, nm in ((n, "n"), (sz, "sz"), (szz, "szz")):
        _need(x, torch.float32, f"gauss_ext_term {nm}", 2)
    _need(pre0, torch.float32, "gauss_ext_term pre0", 1)
    B, A = idx.shape
    cap, C = n.shape
    if not (slot.shape[0] == B and tbl.shape[1] == C
            and sz.shape == n.shape == szz.shape and pre0.shape[0] == cap):
        raise ValueError("gauss_ext_term: shapes do not agree")
    if not all(x.is_cuda for x in (values, tbl, slot, n, sz, szz, pre0)):
        raise ValueError("gauss_ext_term: every input must be on the card")
    plan = gauss_ext_term_plan(B, A)
    out = torch.empty((B, A), dtype=torch.float32, device=idx.device)
    rc = _fn("gauss_ext_term")(
        _ptr(values), values.shape[0], _ptr(tbl), tbl.shape[0], C, _ptr(idx),
        _ptr(slot), _ptr(n), _ptr(sz), _ptr(szz), _ptr(pre0), cap,
        float(coef), _ptr(out), B, A, plan["threads"], plan["grid"],
        _stream(idx))
    _check(rc, "gauss_ext_term")
    _count("gauss_ext_term", B)
    return out


# ---------------------------------------------------------------- K6

_K6_THREADS = 512
_K6_OPTIONS = _K6_THREADS * 8  # options a block owns (8 a thread)


def maybe_swap_ext_plan(B: int, V: int) -> dict:
    """K6's launch for B rows of V options: one 512-thread block a row and
    group of up to 4,096 options, dict(threads, grid=(B, groups))."""
    B, V = int(B), int(V)
    if B < 0 or V < 1:
        raise ValueError(f"maybe_swap_ext: B = {B}, V = {V} out of range")
    groups = -(-V // _K6_OPTIONS)
    if groups > _GRID_Y_MAX:
        raise ValueError(f"maybe_swap_ext: V = {V} options exceed the grid")
    return dict(threads=_K6_THREADS, grid=(B, groups))


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
    plan = maybe_swap_ext_plan(B, V)
    out = torch.empty((B, V), dtype=torch.float32, device=obs.device)
    rc = _fn("maybe_swap_ext")(
        _ptr(t), _ptr(alive), _ptr(slot), _ptr(cnt), _ptr(obs), _ptr(st),
        _ptr(p), p.shape[0], _ptr(lc), _ptr(lens), L, _ptr(member), V,
        _ptr(out), B, N, plan["threads"], *plan["grid"], _stream(obs))
    _check(rc, "maybe_swap_ext")
    _count("maybe_swap_ext", B)
    return out
