"""The port's hand-written CUDA kernels: build, bind, plain versions, counts.

Three kernels carry the block enumeration of the batched MH path (sources in
pclean_tpu_torch/csrc/, each with a header note on the JAX computation it
replaces, its bound on the H100 and its design):

  K1 enum_logsumexp  — record [R, K+1] = [exist, new] and logZ [R] in one
                       pass (propose.py score_fk / score_choice logsumexp);
  K2 inv_cdf_sample  — inverse-CDF categorical draw per row
                       (propose.py _inv_cdf_from_u);
  K3 obs_gather_sum  — out[b, k] = sum_c M_c[obs[b, c], word[c, k]], the
                       AddTypos observed-column score (propose.py
                       _matmul_obs_term/_mm_flush and the eager gather).

Each has a plain PyTorch version here. A wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches its kernel or
raises. `LAUNCHES` counts kernel launches (plain calls are not counted).

Build: one `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared` per
source, all started together, into pclean_tpu_torch/_build/ (listed in
.gitignore) at first use, skipped where the library is newer than its
sources; the libraries have a plain C interface and are loaded with
ctypes. Nothing is built or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
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
}
LAUNCHES = {name: 0 for name in _SOURCES}
_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def build_kernels() -> float:
    """Compile every kernel whose library is missing or older than its
    sources (one nvcc per source, in parallel) and load the libraries;
    returns the wall seconds the build took. Raises with the compiler's
    output if any build fails. Each process compiles into a file of its own
    and renames it into place, so processes sharing a checkout never load a
    half-written library."""
    with _lock:
        if len(_libs) == len(_SOURCES):
            return 0.0
        t0 = time.time()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, src in _SOURCES.items():
            out = os.path.join(BUILD_DIR, f"lib{name}.so")
            if not _stale(name, out):
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
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        for name in _SOURCES:
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
            fn = getattr(lib, f"pclean_{name}")
            fn.restype = ctypes.c_int
            if name == "enum_logsumexp":
                fn.argtypes = [P, P, P, P, I64, I64, P]
            elif name == "inv_cdf_sample":
                fn.argtypes = [P, P, P, I64, I64, P]
            else:
                fn.argtypes = [ctypes.POINTER(I64),
                               ctypes.POINTER(ctypes.c_int32), P, P, P, I64,
                               I64, ctypes.c_int, P]
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


def enum_logsumexp(exist: torch.Tensor, new=None):
    """K1. exist [R, K] f32, new [R] f32 or None -> (record, logZ [R])."""
    if not _route(exist, "enum_logsumexp"):
        return enum_logsumexp_plain(exist, new)
    exist = exist.contiguous()
    _need(exist, torch.float32, "enum_logsumexp exist", 2)
    R, K = exist.shape
    logz = torch.empty((R,), dtype=torch.float32, device=exist.device)
    if new is None:
        rec = exist
        rc = _fn("enum_logsumexp")(_ptr(exist), None, None, _ptr(logz), R, K,
                                   _stream(exist))
    else:
        new = new.contiguous()
        _need(new, torch.float32, "enum_logsumexp new", 1)
        if new.shape[0] != R:
            raise ValueError("enum_logsumexp: new must have one entry per row")
        rec = torch.empty((R, K + 1), dtype=torch.float32,
                          device=exist.device)
        rc = _fn("enum_logsumexp")(_ptr(exist), _ptr(new), _ptr(rec),
                                   _ptr(logz), R, K, _stream(exist))
    _check(rc, "enum_logsumexp")
    LAUNCHES["enum_logsumexp"] += 1
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
    idx = torch.empty((R,), dtype=torch.int32, device=logits.device)
    rc = _fn("inv_cdf_sample")(_ptr(logits), _ptr(u), _ptr(idx), R, K,
                               _stream(logits))
    _check(rc, "inv_cdf_sample")
    LAUNCHES["inv_cdf_sample"] += 1
    return idx


# ---------------------------------------------------------------- K3

_MAX_COLS = 8
_MAX_ROWS = 65535 * 4  # grid.y * rows per block


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
    group of 8 and add the groups."""
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
    if B > _MAX_ROWS:
        raise ValueError(f"obs_gather_sum: at most {_MAX_ROWS} rows")
    out = None
    for c0 in range(0, C, _MAX_COLS):
        cs = slice(c0, min(C, c0 + _MAX_COLS))
        part_mats = mats[cs]
        n = len(part_mats)
        ptrs = (ctypes.c_int64 * n)(*[m.data_ptr() for m in part_mats])
        sizes = (ctypes.c_int32 * n)(*[m.shape[0] for m in part_mats])
        o = obs[:, cs].contiguous()
        w = word[cs].contiguous()
        part = torch.empty((B, K), dtype=torch.float32, device=obs.device)
        rc = _fn("obs_gather_sum")(ptrs, sizes, _ptr(o), _ptr(w),
                                   _ptr(part), B, K, n, _stream(obs))
        _check(rc, "obs_gather_sum")
        LAUNCHES["obs_gather_sum"] += 1
        out = part if out is None else out + part
    return out
