// K20 level_sum: one enumeration level's additive terms, summed in one
// launch.
//
// Replaces, in pclean_tpu/engine/propose.py, the score pass's
// accumulation between two logsumexps: BlockTracer.score_plan's running
// sum (propose.py:383-387), the copy-mode equality term (:424-442), the
// non-enumerable branch's observed term (:471-499) and, at one row, the
// deferred AddTypos columns that _mm_flush adds at the level's end
// (:360-375), which XLA fuses into a few fusions per level inside the
// lax.scan body. The tracer (pclean_tpu_torch/engine/propose.py) writes
// the level as a postfix program over operands:
//   (a) dense    x[i]                              (float32)
//   (b) eq       st[i] == 1 ? (val[i] == obs[i] ? 0 : NEG_INF) : 0, the
//                FLOAT test |val - obs| <= 1e-6 max(1, |obs|)
//   (c) sel      st[i] == 1 ? obs_ld[i] : (st[i] == 2 ? miss[i] : 0)
//   (d) gather   M[clamp(obs[i]), clamp(word[i])]      (K3's gather)
// each read at its broadcast strides over the output [B, *axes] (0 on an
// axis it does not vary along), a state a tensor or a static code. The
// program's steps: ZERO pushes 0, PUSH i pushes operand i, ADD pops b, a
// and pushes a + b, ADDOP i adds operand i to the top.
//
// Bits: each output element is evaluated in the order of the parent's
// eager expression (total = 0; total += term + score_plan(rest), nested;
// then each frame depth's K3 sum, from 0 in column order), one rounding a
// step (__fadd_rn, and __fsub_rn / __fmul_rn in the FLOAT test, so that
// nothing contracts into a fused multiply-add): the output is bit-equal to
// the plain version's, which is that eager expression.
//
// Bound on the H100 (3.35 TB/s): bytes. Each reference's distinct
// elements read once, the gathered matrix entries once, the output [N]
// float32 written once. At one row a level is a few hundred outputs and a
// few KB: a launch floor of work, so the kernel is one pass with no
// second launch.
//
// Design: a thread an output element, 256 threads a block; the element's
// coordinates once, each reference's offset from them. The plan (output
// shape, references, operands, program: ops.level_sum's words, packed) is
// passed by value, in the smallest of three parameter blocks that holds
// it, so a launch reads no table from device memory, needs no
// host-to-device copy and can be captured in a CUDA graph. The stack is a
// per-thread array of K20_MAX_STACK floats.

#include <cuda_runtime.h>

#include "row_words.cuh"

#define K20_MAX_DIMS 8
#define K20_HEAD 16
#define K20_REF (2 + K20_MAX_DIMS)
#define K20_OP 6
#define K20_MAX_REFS 128
#define K20_MAX_OPS 64
#define K20_MAX_PROG 384
#define K20_MAX_STACK 32
#define K20_WORDS \
  (K20_HEAD + K20_REF * K20_MAX_REFS + K20_OP * K20_MAX_OPS + K20_MAX_PROG)
// the parameter blocks a plan is passed in, in words (2, 8 and 16.5 KB)
#define K20_TIER0 256
#define K20_TIER1 1024
#define K20_THREADS 256
#define K20_NEG_INF (-1e30f)

namespace {

// A plan's words: the header, then n_refs references, n_ops operands and
// the program, packed; the struct's size is the smallest of K20_TIER0,
// K20_TIER1 and K20_WORDS that holds them, so a small level passes a small
// parameter block.
template <int W>
struct K20Plan {
  int64_t w[W];
};

// Word indices of the header (ops.level_sum).
enum { kN = 0, kRank, kSizes, kOut = kSizes + K20_MAX_DIMS, kRefs, kOps,
       kProg };
enum { kZero = 0, kPush, kAdd, kAddOp };
enum { kDense = 0, kEq, kSel, kGather };

__device__ __forceinline__ const int64_t* ref_of(const int64_t* w, int r) {
  return w + K20_HEAD + K20_REF * r;
}

__device__ __forceinline__ int64_t offset(const int64_t* rf, int rank,
                                          const int64_t* coord) {
  int64_t off = 0;
#pragma unroll
  for (int d = 0; d < K20_MAX_DIMS; ++d)
    if (d < rank) off += coord[d] * rf[2 + d];
  return off;
}

__device__ __forceinline__ float ld_f32(const int64_t* rf, int rank,
                                        const int64_t* coord) {
  return reinterpret_cast<const float*>(rf[0])[offset(rf, rank, coord)];
}

__device__ __forceinline__ int64_t ld_int(const int64_t* rf, int rank,
                                          const int64_t* coord) {
  return pclean_ld_i(rf[0], rf[1], offset(rf, rank, coord));
}

// A value as torch's float32 promotion reads it (an integer rounded to
// nearest, a float32 as it is).
__device__ __forceinline__ float ld_as_f32(const int64_t* rf, int rank,
                                           const int64_t* coord) {
  const int64_t off = offset(rf, rank, coord);
  if (rf[1] == PCLEAN_DT_F32) return reinterpret_cast<const float*>(rf[0])[off];
  return (float)pclean_ld_i(rf[0], rf[1], off);
}

__device__ __forceinline__ int state_of(const int64_t* w, const int64_t* o,
                                        int rank, const int64_t* coord) {
  return o[3] >= 0 ? (int)ld_int(ref_of(w, (int)o[3]), rank, coord)
                   : (int)o[4];
}

// Operand o (its K20_OP words) at the thread's element.
__device__ float operand(const int64_t* w, const int64_t* o, int rank,
                         const int64_t* coord) {
  switch ((int)o[0]) {
    case kDense:
      return ld_f32(ref_of(w, (int)o[1]), rank, coord);
    case kEq: {
      if (state_of(w, o, rank, coord) != 1) return 0.0f;
      const int64_t* rv = ref_of(w, (int)o[1]);
      const int64_t* ro = ref_of(w, (int)o[2]);
      bool eq;
      if (o[5] == 1) {  // FLOAT: |val - obs| <= 1e-6 * clamp(|obs|, min=1)
        const float v = ld_as_f32(rv, rank, coord);
        const float ov = ld_as_f32(ro, rank, coord);
        const float a = fabsf(ov);
        const float c = a < 1.0f ? 1.0f : a;  // NaN stays NaN, as clamp
        eq = fabsf(__fsub_rn(v, ov)) <= __fmul_rn(1e-6f, c);
      } else if (o[5] == 2) {  // a float against an integer: float32
        eq = ld_as_f32(rv, rank, coord) == ld_as_f32(ro, rank, coord);
      } else {
        eq = ld_int(rv, rank, coord) == ld_int(ro, rank, coord);
      }
      return eq ? 0.0f : K20_NEG_INF;
    }
    case kSel: {
      const int st = state_of(w, o, rank, coord);
      if (st == 1) return ld_f32(ref_of(w, (int)o[1]), rank, coord);
      if (st == 2) return ld_f32(ref_of(w, (int)o[2]), rank, coord);
      return 0.0f;
    }
    default: {  // kGather
      const int64_t V = o[5];
      const int64_t a =
          pclean_clamp(ld_int(ref_of(w, (int)o[1]), rank, coord), V);
      const int64_t b =
          pclean_clamp(ld_int(ref_of(w, (int)o[2]), rank, coord), V);
      return __ldg(reinterpret_cast<const float*>(o[4]) + a * V + b);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(K20_THREADS)
    level_sum_kernel(const __grid_constant__ K20Plan<W> p) {
  const int64_t* w = p.w;
  const int64_t idx = (int64_t)blockIdx.x * K20_THREADS + threadIdx.x;
  if (idx >= w[kN]) return;
  const int rank = (int)w[kRank];
  int64_t coord[K20_MAX_DIMS];
  int64_t r = idx;
#pragma unroll
  for (int d = K20_MAX_DIMS - 1; d >= 0; --d) {
    coord[d] = 0;
    if (d < rank) {
      const int64_t n = w[kSizes + d];
      coord[d] = r % n;
      r /= n;
    }
  }
  const int64_t* ops = w + K20_HEAD + K20_REF * w[kRefs];
  const int64_t* prog = ops + K20_OP * w[kOps];
  float stack[K20_MAX_STACK];
  int top = -1;
  const int n_prog = (int)w[kProg];
  for (int s = 0; s < n_prog; ++s) {
    const int op = (int)(prog[s] >> 32);
    const int arg = (int)(prog[s] & 0xffffffff);
    switch (op) {
      case kZero:
        stack[++top] = 0.0f;
        break;
      case kPush:
        stack[++top] = operand(w, ops + K20_OP * arg, rank, coord);
        break;
      case kAdd: {
        const float b = stack[top--];
        stack[top] = __fadd_rn(stack[top], b);
        break;
      }
      default:  // kAddOp
        stack[top] =
            __fadd_rn(stack[top], operand(w, ops + K20_OP * arg, rank, coord));
    }
  }
  reinterpret_cast<float*>(w[kOut])[idx] = stack[0];
}

template <int W>
int launch(const int64_t* words, int n_words, int64_t N,
           cudaStream_t stream) {
  K20Plan<W> p;
  for (int i = 0; i < W; ++i) p.w[i] = i < n_words ? words[i] : 0;
  const int64_t blocks = (N + K20_THREADS - 1) / K20_THREADS;
  level_sum_kernel<W><<<(unsigned)blocks, K20_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// words: the plan (ops.level_sum's words, packed: at most K20_WORDS).
// Returns cudaErrorInvalidValue for a plan it does not take (a program
// that does not leave one value, nests deeper than K20_MAX_STACK, or names
// an operand or reference it does not have), else cudaGetLastError()
// after the launch.
extern "C" int pclean_level_sum(const int64_t* words, int n_words,
                                void* stream) {
  if (n_words < K20_HEAD || n_words > K20_WORDS)
    return (int)cudaErrorInvalidValue;
  const int64_t* w = words;
  const int64_t N = w[kN], rank = w[kRank], n_refs = w[kRefs];
  const int64_t n_ops = w[kOps], n_prog = w[kProg];
  if (N < 0 || rank < 1 || rank > K20_MAX_DIMS || n_refs < 0 ||
      n_refs > K20_MAX_REFS || n_ops < 0 || n_ops > K20_MAX_OPS ||
      n_prog < 1 || n_prog > K20_MAX_PROG || (N > 0 && w[kOut] == 0) ||
      K20_HEAD + K20_REF * n_refs + K20_OP * n_ops + n_prog != n_words)
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < n_refs; ++r)
    if (w[K20_HEAD + K20_REF * r] == 0) return (int)cudaErrorInvalidValue;
  const int64_t* ops = w + K20_HEAD + K20_REF * n_refs;
  const int64_t* prog = ops + K20_OP * n_ops;
  for (int i = 0; i < n_ops; ++i) {
    const int64_t* o = ops + K20_OP * i;
    if (o[0] < kDense || o[0] > kGather) return (int)cudaErrorInvalidValue;
    const int nref = o[0] == kDense ? 1 : (o[0] == kGather ? 2 : 3);
    for (int j = 1; j <= nref; ++j)
      if (o[j] >= n_refs || (o[j] < 0 && !(j == 3 && o[0] != kGather)))
        return (int)cudaErrorInvalidValue;
    if (o[0] == kGather && (o[4] == 0 || o[5] < 1))
      return (int)cudaErrorInvalidValue;
  }
  int depth = 0;
  for (int s = 0; s < n_prog; ++s) {
    const int64_t op = prog[s] >> 32, arg = prog[s] & 0xffffffff;
    if (op == kZero || op == kPush) ++depth;
    else if (op == kAdd) --depth;
    else if (op != kAddOp) return (int)cudaErrorInvalidValue;
    if ((op == kPush || op == kAddOp) && arg >= n_ops)
      return (int)cudaErrorInvalidValue;
    if (depth < 1 || depth > K20_MAX_STACK) return (int)cudaErrorInvalidValue;
  }
  if (depth != 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_words <= K20_TIER0) return launch<K20_TIER0>(words, n_words, N, s);
  if (n_words <= K20_TIER1) return launch<K20_TIER1>(words, n_words, N, s);
  return launch<K20_WORDS>(words, n_words, N, s);
}
