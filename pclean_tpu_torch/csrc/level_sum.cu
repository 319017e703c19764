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
// Design: the host (ops.level_plan) merges the output's axes that every
// reference walks as one (dropping size-1 axes), so the innermost axis is
// long where the data allow it; each thread takes 1, 4 or 8 consecutive
// elements along it, each reference's offset computed once from the
// thread's coordinates and its innermost stride applied as a step. The
// coordinates split once, by magic-number divisors the host computes, in
// 32-bit arithmetic wherever the output and every reference's extent fit
// in it (a 64-bit instantiation with plain division takes the rest). The
// value stack lives in registers: the host knows the program's depth
// (ops.level_stack) and picks an instantiation of depth 2, 4 or 8 whose
// pushes and pops shift registers by compile-time indices; deeper
// programs take a local-memory stack. The plan (output shape, references,
// operands, program: ops.level_plan's words, packed) is passed by value,
// in the smallest of three parameter blocks that holds it, so a launch
// reads no table from device memory, needs no host-to-device copy and can
// be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_words.cuh"

#define K20_MAX_DIMS 8
#define K20_HEAD 32
#define K20_REF (2 + K20_MAX_DIMS)
#define K20_OP 6
#define K20_MAX_REFS 128
#define K20_MAX_OPS 64
#define K20_MAX_PROG 384
#define K20_MAX_STACK 32
#define K20_WORDS \
  (K20_HEAD + K20_REF * K20_MAX_REFS + K20_OP * K20_MAX_OPS + K20_MAX_PROG)
// the parameter blocks a plan is passed in, in words (2, 8 and 16.6 KB)
#define K20_TIER0 256
#define K20_TIER1 1024
#define K20_THREADS 256
// elements a thread takes along the innermost axis (ops.K20_KERNELS): a
// level of at least ops.K20_WIDE elements 8 where its stack is at most 4
// deep, else 4 (float4 loads and stores); a smaller one 1 (a one-row
// level's gathers wait on dependent loads: more threads wait together)
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

// Word indices of the header (ops.level_plan): the element count, the
// merged rank and sizes, the output's pointer, the counts, the threads a
// row of the innermost axis, the rows and threads, the divisor words
// (magic | shift << 32) of the threads a row and of each outer axis, the
// instantiation (K20_KERNELS).
enum { kN = 0, kRank, kSizes, kOut = kSizes + K20_MAX_DIMS, kRefs, kOps,
       kProg, kTpr, kRows, kThreads, kDivTpr,
       kDivs, kKernel = kDivs + K20_MAX_DIMS - 1 };
enum { kZero = 0, kPush, kAdd, kAddOp };
enum { kDense = 0, kEq, kSel, kGather };

// n / d for n < 2^31 by the divisor's word (PyTorch's IntDivider).
__device__ __forceinline__ uint32_t divide(uint32_t n, int64_t dw) {
  const uint32_t t = __umulhi(n, (uint32_t)(dw & 0xffffffff));
  return (t + n) >> (uint32_t)(dw >> 32);
}

// The thread's place: its elements' coordinates on the outer axes, the
// first element's position along the innermost axis, the valid count.
template <typename I>
struct Place {
  I coord[K20_MAX_DIMS - 1];
  I c0;
  int nval;
  int rank;
};

// A reference at the thread's elements: its pointer and dtype, its
// offset at the first element (from the coordinates) and its step along
// the innermost axis.
template <typename I>
struct Ref {
  int64_t p, dt;
  I off, step;
};

template <typename I>
__device__ __forceinline__ Ref<I> ref_at(const int64_t* w, int64_t r,
                                         const Place<I>& pl) {
  const int64_t* rf = w + K20_HEAD + K20_REF * r;
  Ref<I> x;
  x.p = rf[0];
  x.dt = rf[1];
  I off = 0;
#pragma unroll
  for (int d = 0; d < K20_MAX_DIMS - 1; ++d)
    if (d < pl.rank - 1) off += pl.coord[d] * (I)rf[2 + d];
  x.step = (I)rf[2 + pl.rank - 1];
  x.off = off + pl.c0 * x.step;
  return x;
}

// Element j as an integer, and as torch's float32 promotion reads it (an
// integer rounded to nearest, a float32 as it is).
template <typename I>
__device__ __forceinline__ int64_t ld_i(const Ref<I>& x, int j) {
  return pclean_ld_i(x.p, x.dt, (int64_t)(x.off + j * x.step));
}

template <typename I>
__device__ __forceinline__ float ld_f(const Ref<I>& x, int j) {
  const int64_t i = (int64_t)(x.off + j * x.step);
  if (x.dt == PCLEAN_DT_F32) return reinterpret_cast<const float*>(x.p)[i];
  return (float)pclean_ld_i(x.p, x.dt, i);
}

// Operand o (its K20_OP words) at the thread's elements, each element's
// loads as the eager expression needs them (an equality's values only
// where its state is 1).
template <int E, typename I>
__device__ __forceinline__ void operand(const int64_t* w, const int64_t* o,
                                        const Place<I>& pl, float (&v)[E]) {
  const int kind = (int)o[0];
  const Ref<I> a = ref_at(w, o[1], pl);
  if (kind == kDense) {
    const float* x = reinterpret_cast<const float*>(a.p) + a.off;
    if constexpr (E % 4 == 0) {
      if (a.dt == PCLEAN_DT_F32 && a.step == 1 && pl.nval == E &&
          (reinterpret_cast<uintptr_t>(x) & 15) == 0) {   // 16-byte loads
#pragma unroll
        for (int k = 0; k < E; k += 4) {
          const float4 q = *reinterpret_cast<const float4*>(x + k);
          v[k] = q.x;
          v[k + 1] = q.y;
          v[k + 2] = q.z;
          v[k + 3] = q.w;
        }
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j)
      v[j] = j < pl.nval ? ld_f(a, j) : 0.0f;
    return;
  }
  const Ref<I> b = ref_at(w, o[2], pl);
  if (kind == kGather) {
    const int64_t V = o[5];
    const float* M = reinterpret_cast<const float*>(o[4]);
#pragma unroll
    for (int j = 0; j < E; ++j)
      v[j] = j < pl.nval ? __ldg(M + pclean_clamp(ld_i(a, j), V) * V +
                                 pclean_clamp(ld_i(b, j), V))
                         : 0.0f;
    return;
  }
  // kEq and kSel: the state a tensor or the static code
  const bool per_el = o[3] >= 0;
  const Ref<I> s = ref_at(w, per_el ? o[3] : o[1], pl);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    v[j] = 0.0f;
    if (j >= pl.nval) continue;
    const int64_t st = per_el ? ld_i(s, j) : o[4];
    if (kind == kSel) {
      if (st == 1) v[j] = ld_f(a, j);
      else if (st == 2) v[j] = ld_f(b, j);
      continue;
    }
    if (st != 1) continue;
    bool eq;
    if (o[5] == 0) {   // two integers
      eq = ld_i(a, j) == ld_i(b, j);
    } else {
      const float x = ld_f(a, j), y = ld_f(b, j);
      if (o[5] == 1) {   // FLOAT: |val - obs| <= 1e-6 * clamp(|obs|, 1)
        const float m = fabsf(y);
        const float c = m < 1.0f ? 1.0f : m;   // NaN stays NaN, as clamp
        eq = fabsf(__fsub_rn(x, y)) <= __fmul_rn(1e-6f, c);
      } else {   // a float against an integer: float32
        eq = x == y;
      }
    }
    v[j] = eq ? 0.0f : K20_NEG_INF;
  }
}

// The value stack of E elements, D registers deep (the host
// guarantees the depth): each step writes the slot at the top by a switch
// on it, a branch every thread of the warp takes alike (the program is
// the same for all), so a push, a pop or an add costs the same at any
// depth and every slot keeps a compile-time index; or (D = 0) a local
// array of K20_MAX_STACK.
#define K20_CASES(F) F(0) F(1) F(2) F(3) F(4) F(5) F(6) F(7)
template <int D, int E>
struct Stack {
  static_assert(D <= 8, "K20_CASES names 8 slots");
  float s[D][E];
  int t = -1;
  __device__ __forceinline__ void push(const float (&x)[E]) {
    switch (++t) {
#define K20_PUSH(m)                                                  \
  case m:                                                            \
    if (m < D) {                                                     \
      _Pragma("unroll") for (int j = 0; j < E; ++j)          \
          s[m < D ? m : 0][j] = x[j];                                \
    }                                                                \
    break;
      K20_CASES(K20_PUSH)
#undef K20_PUSH
    }
  }
  __device__ __forceinline__ void add() {
    switch (t--) {
#define K20_ADD(m)                                                    \
  case m:                                                             \
    if (m >= 1 && m < D) {                                            \
      _Pragma("unroll") for (int j = 0; j < E; ++j)           \
          s[m >= 1 && m < D ? m - 1 : 0][j] =                         \
              __fadd_rn(s[m >= 1 && m < D ? m - 1 : 0][j],            \
                        s[m < D ? m : 0][j]);                         \
    }                                                                 \
    break;
      K20_CASES(K20_ADD)
#undef K20_ADD
    }
  }
  __device__ __forceinline__ void addop(const float (&x)[E]) {
    switch (t) {
#define K20_ADDOP(m)                                                  \
  case m:                                                             \
    if (m < D) {                                                      \
      _Pragma("unroll") for (int j = 0; j < E; ++j)           \
          s[m < D ? m : 0][j] = __fadd_rn(s[m < D ? m : 0][j], x[j]); \
    }                                                                 \
    break;
      K20_CASES(K20_ADDOP)
#undef K20_ADDOP
    }
  }
  __device__ __forceinline__ float top(int j) const { return s[0][j]; }
};

template <int E>
struct Stack<0, E> {
  float s[K20_MAX_STACK][E];
  int t = -1;
  __device__ __forceinline__ void push(const float (&x)[E]) {
    ++t;
#pragma unroll
    for (int j = 0; j < E; ++j) s[t][j] = x[j];
  }
  __device__ __forceinline__ void add() {
#pragma unroll
    for (int j = 0; j < E; ++j)
      s[t - 1][j] = __fadd_rn(s[t - 1][j], s[t][j]);
    --t;
  }
  __device__ __forceinline__ void addop(const float (&x)[E]) {
#pragma unroll
    for (int j = 0; j < E; ++j) s[t][j] = __fadd_rn(s[t][j], x[j]);
  }
  __device__ __forceinline__ float top(int j) const { return s[0][j]; }
};

// NARROW: 32-bit indices and the host's divisors; else 64-bit and plain
// division.
template <int W, int D, bool NARROW, int E>
__global__ void __launch_bounds__(K20_THREADS)
    level_sum_kernel(const __grid_constant__ K20Plan<W> p) {
  using I = typename std::conditional<NARROW, uint32_t, int64_t>::type;
  const int64_t* w = p.w;
  const I t = (I)blockIdx.x * K20_THREADS + threadIdx.x;
  if ((int64_t)t >= w[kThreads]) return;
  Place<I> pl;
  pl.rank = (int)w[kRank];
  const I tpr = (I)w[kTpr];
  const I inner = (I)w[kSizes + pl.rank - 1];
  I row = NARROW ? (I)divide((uint32_t)t, w[kDivTpr]) : t / tpr;
  pl.c0 = (t - row * tpr) * E;
  const I base = row * inner + pl.c0;
  const I left = inner - pl.c0;
  pl.nval = left < (I)E ? (int)left : E;
#pragma unroll
  for (int d = K20_MAX_DIMS - 2; d >= 0; --d) {
    pl.coord[d] = 0;
    if (d < pl.rank - 1) {
      if (d == 0) {
        pl.coord[0] = row;
      } else {
        const I n = (I)w[kSizes + d];
        const I q = NARROW ? (I)divide((uint32_t)row, w[kDivs + d]) : row / n;
        pl.coord[d] = row - q * n;
        row = q;
      }
    }
  }
  const int64_t* ops = w + K20_HEAD + K20_REF * w[kRefs];
  const int64_t* prog = ops + K20_OP * w[kOps];
  const int n_prog = (int)w[kProg];
  Stack<D, E> st;
  float v[E];
  for (int s = 0; s < n_prog; ++s) {
    const int64_t ins = prog[s];
    const int op = (int)(ins >> 32);
    if (op == kAdd) {
      st.add();
      continue;
    }
    if (op == kZero) {
#pragma unroll
      for (int j = 0; j < E; ++j) v[j] = 0.0f;
    } else {
      operand(w, ops + K20_OP * (ins & 0xffffffff), pl, v);
    }
    if (op == kAddOp) st.addop(v);
    else st.push(v);
  }
  float* out = reinterpret_cast<float*>(w[kOut]) + base;
  if constexpr (E % 4 == 0) {
    if (pl.nval == E && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < E; k += 4)
        *reinterpret_cast<float4*>(out + k) = make_float4(
            st.top(k), st.top(k + 1), st.top(k + 2), st.top(k + 3));
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j)
    if (j < pl.nval) out[j] = st.top(j);
}

template <int W, int D, bool NARROW, int E>
int launch(const int64_t* words, int n_words, int64_t threads,
           cudaStream_t stream) {
  K20Plan<W> p;
  for (int i = 0; i < W; ++i) p.w[i] = i < n_words ? words[i] : 0;
  const int64_t blocks = (threads + K20_THREADS - 1) / K20_THREADS;
  level_sum_kernel<W, D, NARROW, E>
      <<<(unsigned)blocks, K20_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int W>
int launch_tier(const int64_t* words, int n_words, int64_t threads,
                int kernel, cudaStream_t s) {
  switch (kernel) {
    case 0: return launch<W, 2, true, 1>(words, n_words, threads, s);
    case 1: return launch<W, 4, true, 1>(words, n_words, threads, s);
    case 2: return launch<W, 8, true, 1>(words, n_words, threads, s);
    case 3: return launch<W, 2, true, 8>(words, n_words, threads, s);
    case 4: return launch<W, 4, true, 8>(words, n_words, threads, s);
    case 5: return launch<W, 8, true, 4>(words, n_words, threads, s);
    default: return launch<W, 0, false, 4>(words, n_words, threads, s);
  }
}

// The stack depth each instantiation holds and the elements a thread it
// takes (ops.K20_KERNELS).
__host__ int kernel_depth(int kernel) {
  static const int depth[7] = {2, 4, 8, 2, 4, 8, K20_MAX_STACK};
  return depth[kernel];
}

__host__ int kernel_elems(int kernel) {
  static const int elems[7] = {1, 1, 1, 8, 8, 4, 4};
  return elems[kernel];
}

}  // namespace

// words: the plan (ops.level_plan's words, packed: at most K20_WORDS).
// Returns cudaErrorInvalidValue for a plan it does not take (a program
// that does not leave one value, nests deeper than its instantiation
// holds, or names an operand or reference it does not have; a header
// whose counts disagree), else cudaGetLastError() after the launch.
extern "C" int pclean_level_sum(const int64_t* words, int n_words,
                                void* stream) {
  if (n_words < K20_HEAD || n_words > K20_WORDS)
    return (int)cudaErrorInvalidValue;
  const int64_t* w = words;
  const int64_t N = w[kN], rank = w[kRank], n_refs = w[kRefs];
  const int64_t n_ops = w[kOps], n_prog = w[kProg], kernel = w[kKernel];
  if (N < 0 || rank < 1 || rank > K20_MAX_DIMS || n_refs < 0 ||
      n_refs > K20_MAX_REFS || n_ops < 0 || n_ops > K20_MAX_OPS ||
      n_prog < 1 || n_prog > K20_MAX_PROG || (N > 0 && w[kOut] == 0) ||
      kernel < 0 || kernel > 6 ||
      K20_HEAD + K20_REF * n_refs + K20_OP * n_ops + n_prog != n_words)
    return (int)cudaErrorInvalidValue;
  if (N > 0) {
    int64_t size = 1;
    for (int d = 0; d < rank; ++d) {
      if (w[kSizes + d] < 1) return (int)cudaErrorInvalidValue;
      size *= w[kSizes + d];
    }
    const int64_t inner = w[kSizes + rank - 1];
    const int E = kernel_elems((int)kernel);
    if (size != N || w[kTpr] != (inner + E - 1) / E ||
        w[kRows] != N / inner || w[kThreads] != w[kRows] * w[kTpr] ||
        (kernel < 6 && w[kThreads] >= ((int64_t)1 << 31)))
      return (int)cudaErrorInvalidValue;
  }
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
  const int most = kernel_depth((int)kernel);
  int depth = 0;
  for (int s = 0; s < n_prog; ++s) {
    const int64_t op = prog[s] >> 32, arg = prog[s] & 0xffffffff;
    if (op == kZero || op == kPush) ++depth;
    else if (op == kAdd) --depth;
    else if (op != kAddOp) return (int)cudaErrorInvalidValue;
    if ((op == kPush || op == kAddOp) && arg >= n_ops)
      return (int)cudaErrorInvalidValue;
    if (depth < 1 || depth > most) return (int)cudaErrorInvalidValue;
  }
  if (depth != 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t threads = w[kThreads];
  if (n_words <= K20_TIER0)
    return launch_tier<K20_TIER0>(words, n_words, threads, (int)kernel, s);
  if (n_words <= K20_TIER1)
    return launch_tier<K20_TIER1>(words, n_words, threads, (int)kernel, s);
  return launch_tier<K20_WORDS>(words, n_words, threads, (int)kernel, s);
}
