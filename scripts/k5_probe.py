"""K5 gauss_ext_term design probe on one card: device ms of the committed
kernel beside builds of it patched at run time, on seeded inputs of the
rents County block's form (kernel_bench.k5_seeded).

    python scripts/k5_probe.py [--out DIR]

Builds (each the committed source, csrc/gauss_ext_term.cu, with one patch,
compiled with the port's nvcc flags into pclean_tpu_torch/_build/k5_probe/):
  final         the committed kernel, at 1, 2, 4 and 8 warps a block;
  per_lane      every C through the per-lane loop (a lane loads its own
                row's C words and values: the flat staged loads of C <= 8
                switched off);
  staged_rounds C > 8 in staged rounds of 8 groups (32 rows x 8 words
                loaded flat a round) in place of the per-lane loop;
  store_only    no loads: each output written from the launch's constants
                (what the launch and store cost);
  round1        the slot and coordinates loaded and folded, then stored
                (what the first round of loads adds).
The builds that compute the term are checked against the plain version
(kernel_bench.check_k5) before they are timed; store_only and round1
compute something else and are only timed. Prints one line a (build,
warps, shape) with two timings (CUDA graphs, kernel_bench.graph_ms) and
writes them to DIR/k5_probe.json.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from pclean_tpu_torch import kernel_bench as kb  # noqa: E402
from pclean_tpu_torch import ops  # noqa: E402

SHAPES = (("[256, 51] C 5", 256, 51, 5), ("[1, 51] C 5", 1, 51, 5),
          ("[256, 51] C 1", 256, 51, 1), ("[256, 51] C 17", 256, 51, 17),
          ("[4096, 51] C 5", 4096, 51, 5), ("[4096, 51] C 17", 4096, 51, 17))

_GENERIC = """  } else {
    // each lane its own option's C groups"""
_STAGED_ROUNDS = """  } else {
    const int C = p.C;
    const int64_t sr = s * C;
    s_row[lane] = row;
    __syncwarp();
    float* rstage = reinterpret_cast<float*>(smem + (blockDim.x >> 5) * 32) +
                    warp * 32 * 9;
    for (int c0 = 0; c0 < C; c0 += 8) {
      const int cw = min(8, C - c0);
      int32_t t[8];
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int f = i * 32 + lane, r = f / cw;
        t[i] = i < cw ? __ldg(p.tbl + s_row[r] * C + c0 + (f - r * cw)) : 0;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = i < cw ? __ldg(p.values + clamp64(t[i], p.I)) : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int f = i * 32 + lane, r = f / cw;
        if (i < cw) rstage[r * 9 + f - r * cw] = v[i];
      }
      __syncwarp();
      for (int j = 0; j < cw; ++j) {
        const float mu = rstage[lane * 9 + j];
        a_szz += __ldg(p.szz + sr + c0 + j);
        a_sz += mu * __ldg(p.sz + sr + c0 + j);
        a_n += mu * mu * __ldg(p.n + sr + c0 + j);
      }
      __syncwarp();
    }
  }
  if (false) {
    // the per-lane loop, unused here"""
_SMEM = "      kC > 0 ? (size_t)(threads / 32) * (32 * 8 + 32 * (kC | 1) * 4) : 0;"


def _patched(src: str, build: str) -> str:
    """The committed source with `build`'s patch (exactly one match each)."""
    def sub(old, new):
        if src.count(old) != 1:
            raise RuntimeError(f"k5_probe {build}: patch does not match")
        return src.replace(old, new)

    head = src.index("  // round 1: the slot and the coordinates")
    tail = src.index("  if (live)\n    p.out[")
    if build == "per_lane":
        return sub("  if constexpr (kC > 0) {", "  if constexpr (kC < 0) {")
    if build == "staged_rounds":
        src = sub(_GENERIC, _STAGED_ROUNDS)
        return src.replace(_SMEM, "      (size_t)(threads / 32) * "
                           "(32 * 8 + 32 * ((kC > 0 ? kC : 8) | 1) * 4);")
    if build == "store_only":
        return (src[:head] + "  const float a_szz = 0.0f, a_sz = 0.0f, "
                "a_n = 0.0f, pre = 0.0f;\n" + src[tail:])
    if build == "round1":
        mid = src.index("  const int64_t s = clamp64(s_raw, p.cap);")
        return (src[:mid] + "  const float a_szz = (float)row, a_sz = "
                "(float)s_raw, a_n = 0.0f, pre = 0.0f;\n" + src[tail:])
    return src


def build(name: str, out_dir: str):
    """ctypes entry of the `name` build (the committed one for "final")."""
    if name == "final":
        return ops._fn("gauss_ext_term")
    csrc = os.path.join(os.path.dirname(ops.__file__), "csrc")
    with open(os.path.join(csrc, "gauss_ext_term.cu")) as f:
        src = _patched(f.read(), name)
    cu = os.path.join(out_dir, f"{name}.cu")
    lib = os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([ops._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", csrc, "-o", lib, cu], check=True, timeout=600)
    fn = ctypes.CDLL(lib).pclean_gauss_ext_term
    fn.restype = ctypes.c_int
    fn.argtypes = ops._fn("gauss_ext_term").argtypes
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_probe: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    ops.build_kernels()
    out_dir = os.path.join(ops.BUILD_DIR, "k5_probe")
    os.makedirs(out_dir, exist_ok=True)
    builds = {n: build(n, out_dir) for n in ("final", "per_lane",
                                            "staged_rounds", "store_only",
                                            "round1")}
    runs = [("final", w) for w in (1, 2, 4, 8)] + [
        (n, ops._K5_WARPS) for n in builds if n != "final"]
    res = {}
    default = ops._K5_WARPS
    try:
        for label, B, A, C in SHAPES:
            k5 = kb.k5_seeded(dev, B, A, C)
            for name, warps in runs:
                ops._libs["gauss_ext_term"] = builds[name]
                ops._K5_WARPS = warps
                if name not in ("store_only", "round1"):
                    kb.check_k5(ops, k5)
                times = [kb.graph_ms(lambda: ops.gauss_ext_term(**k5))
                         for _ in range(2)]
                key = f"{name} warps {warps} {label}"
                res[key] = times
                print(f"{key}: device ms " + " ".join(f"{t:.5f}"
                                                      for t in times),
                      flush=True)
    finally:
        ops._libs["gauss_ext_term"] = builds["final"]
        ops._K5_WARPS = default
    floor = kb.launch_floor_ms()
    print(f"launch floor (one PyTorch op on one element): {floor:.5f} ms")
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "k5_probe.json"), "w") as f:
            json.dump(dict(card=torch.cuda.get_device_name(0), times=res,
                           launch_floor_ms=floor), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
