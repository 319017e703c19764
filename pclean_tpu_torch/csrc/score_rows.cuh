// The one-row score kernels' shared pieces (K12 fk_score, K13
// choice_score): strided operands over the enumeration rows, the running
// (max, sum) pair of a logsumexp and its merge within a row's threads.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace score_rows {

constexpr int kMaxDims = 8;  // enumeration axes a record may have

// The R rows of a record are the row-major product of `nd` axes; an
// operand is read at sum_i coord_i * stride_i (stride 0 on an axis it
// broadcasts over), then at its option-axis stride (a kernel argument of
// its own) along the option axis.
struct Axes {
  int nd;
  int64_t size[kMaxDims];
};

struct Strides {
  int64_t s[kMaxDims];
};

// Row 0 (every one-row record) is offset 0 with no division; other rows
// walk the axes unrolled over kMaxDims, so that every axis is read at a
// constant index of the kernel's parameters and none is copied to local
// memory.
__device__ __forceinline__ int64_t offset(const Axes& ax, const Strides& st,
                                          int64_t r) {
  if (r == 0) return 0;
  int64_t off = 0;
#pragma unroll
  for (int i = kMaxDims - 1; i >= 0; --i) {
    if (i < ax.nd && r != 0) {
      const int64_t n = ax.size[i];
      off += (r % n) * st.s[i];
      r /= n;
    }
  }
  return off;
}

// A scalar of dtype code `dt` (ops._DT: 1 int8, 3 int16, 4 int32, 5
// int64, 6 float32) as a float, rounded to nearest as torch's
// .to(float32) rounds.
__device__ __forceinline__ float load_f32(const void* p, int dt, int64_t i) {
  switch (dt) {
    case 1: return (float)static_cast<const int8_t*>(p)[i];
    case 3: return (float)static_cast<const int16_t*>(p)[i];
    case 4: return (float)static_cast<const int32_t*>(p)[i];
    case 5: return (float)static_cast<const int64_t*>(p)[i];
    default: return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ int64_t load_i64(const void* p, int dt,
                                            int64_t i) {
  switch (dt) {
    case 1: return static_cast<const int8_t*>(p)[i];
    case 3: return static_cast<const int16_t*>(p)[i];
    case 4: return static_cast<const int32_t*>(p)[i];
    default: return static_cast<const int64_t*>(p)[i];
  }
}

// The running pair of a logsumexp: m the largest value seen, floored at
// NEG_INF (finite, so an all-NEG_INF stretch rescales by exp(0) and never
// by exp(-inf + inf)), s the sum of exp(x - m).
__device__ __forceinline__ void add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.0f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// Thread 0 of a row's `tpr` threads ends with the row's pair: tpr = 32
// (a warp a row, no barrier) or the whole block (a block a row; every
// thread of the block must call it). `sh` holds 64 floats.
__device__ __forceinline__ void reduce(float& m, float& s, int tpr,
                                       float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  if (tpr == 32) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh[warp] = m;
    sh[32 + warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const bool have = lane < (int)(blockDim.x >> 5);
    m = have ? sh[lane] : PCLEAN_NEG_INF;
    s = have ? sh[32 + lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      merge(m, s, m2, s2);
    }
  }
}

// logZ with pclean_tpu.utils.logsumexp's finite NEG_INF rules (K1's).
__device__ __forceinline__ float finish(float m, float s) {
  const bool keep = isfinite(m) || (m > PCLEAN_NEG_INF / 2.0f);
  return keep ? logf(s) + m : PCLEAN_NEG_INF;
}

}  // namespace score_rows
