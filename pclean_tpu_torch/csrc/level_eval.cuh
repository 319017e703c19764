// A level's postfix sum program, evaluated at an element: the code K20
// level_sum launches on its own and K12 fk_score and K13 choice_score
// run inside their launches (a one-row level fused into the score kernel
// that is its only reader).
//
// A level (ops.level_plan's words) is a header, tensor references
// (pointer, dtype, strides over the level's merged output axes), operands
// over them and a program:
//   (a) dense    x[i]                              (float32)
//   (b) eq       st[i] == 1 ? (val[i] == obs[i] ? 0 : NEG_INF) : 0, the
//                FLOAT test |val - obs| <= 1e-6 max(1, |obs|)
//   (c) sel      st[i] == 1 ? obs_ld[i] : (st[i] == 2 ? miss[i] : 0)
//   (d) gather   M[clamp(obs[i]), clamp(word[i])]      (K3's gather)
// each read at its broadcast strides (0 on an axis it does not vary
// along), a state a tensor or a static code. The program's steps: ZERO
// pushes 0, PUSH i pushes operand i, ADD pops b, a and pushes a + b,
// ADDOP i adds operand i to the top. Each step rounds once (__fadd_rn,
// and __fsub_rn / __fmul_rn in the FLOAT test, so that nothing contracts
// into a fused multiply-add): an element's value is bit-equal to the
// eager expression the program was written from.
//
// An element is found from its row-major index over the output by the
// plan's merged sizes and their magic-number divisors (32-bit where the
// plan says the indices fit, else 64-bit with plain division); the value
// stack lives in registers, D deep, each slot at a compile-time index
// (D = 0: a local array of K20_MAX_STACK).
#pragma once

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
#define K20_NEG_INF (-1e30f)

namespace level_eval {

// Word indices of the header (ops.level_plan): the element count, the
// merged rank and sizes, the output's pointer (0 in a fused level), the
// counts, the threads a row of the innermost axis, the rows and threads,
// the divisor words (magic | shift << 32) of the threads a row and of
// each outer axis, the instantiation (ops.K20_KERNELS).
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

// The place of the E consecutive elements a thread t takes along the
// innermost axis (the header's threads a row and divisors), and the
// first one's row-major index `base`. With E = 1, t is the element's own
// index over the output.
template <bool NARROW, int E, typename I>
__device__ __forceinline__ Place<I> place(const int64_t* w, I t, I& base) {
  Place<I> pl;
  pl.rank = (int)w[kRank];
  const I tpr = (I)w[kTpr];
  const I inner = (I)w[kSizes + pl.rank - 1];
  I row = NARROW ? (I)divide((uint32_t)t, w[kDivTpr]) : t / tpr;
  pl.c0 = (t - row * tpr) * E;
  base = row * inner + pl.c0;
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
  return pl;
}

// The program run at the place's elements; the value is st.top(j).
template <int D, int E, typename I>
__device__ __forceinline__ void eval(const int64_t* w, const Place<I>& pl,
                                     Stack<D, E>& st) {
  const int64_t* ops = w + K20_HEAD + K20_REF * w[kRefs];
  const int64_t* prog = ops + K20_OP * w[kOps];
  const int n_prog = (int)w[kProg];
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
}

// The level's one value at element n (E = 1) of a fused level.
template <int D, bool NARROW>
__device__ __forceinline__ float at(const int64_t* w, int64_t n) {
  using I = typename std::conditional<NARROW, uint32_t, int64_t>::type;
  I base;
  const Place<I> pl = place<NARROW, 1, I>(w, (I)n, base);
  Stack<D, 1> st;
  eval<D, 1, I>(w, pl, st);
  return st.top(0);
}

// The words of a level as a launch takes them, checked on the host:
// their count, the header's (the element count, sizes, threads a row for
// E elements a thread, rows and threads; 32-bit threads where `narrow`),
// every reference's pointer, every operand's kind and references, the
// program's operands and a depth of 1 to `most` that leaves one value;
// with `need_out` the output's pointer. Returns cudaErrorInvalidValue for
// a plan it does not take, else cudaSuccess.
__host__ inline int check(const int64_t* w, int64_t n_words, int E,
                          int most, bool narrow, bool need_out) {
  if (n_words < K20_HEAD || n_words > K20_WORDS)
    return (int)cudaErrorInvalidValue;
  const int64_t N = w[kN], rank = w[kRank], n_refs = w[kRefs];
  const int64_t n_ops = w[kOps], n_prog = w[kProg];
  if (N < 0 || rank < 1 || rank > K20_MAX_DIMS || n_refs < 0 ||
      n_refs > K20_MAX_REFS || n_ops < 0 || n_ops > K20_MAX_OPS ||
      n_prog < 1 || n_prog > K20_MAX_PROG ||
      (need_out && N > 0 && w[kOut] == 0) ||
      K20_HEAD + K20_REF * n_refs + K20_OP * n_ops + n_prog != n_words)
    return (int)cudaErrorInvalidValue;
  if (N > 0) {
    int64_t size = 1;
    for (int d = 0; d < rank; ++d) {
      if (w[kSizes + d] < 1) return (int)cudaErrorInvalidValue;
      size *= w[kSizes + d];
    }
    const int64_t inner = w[kSizes + rank - 1];
    if (size != N || w[kTpr] != (inner + E - 1) / E ||
        w[kRows] != N / inner || w[kThreads] != w[kRows] * w[kTpr] ||
        (narrow && w[kThreads] >= ((int64_t)1 << 31)))
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
  return depth == 1 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

}  // namespace level_eval
