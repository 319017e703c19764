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
// be captured in a CUDA graph. The operands' loads, the place of an
// element and the program's walk live in csrc/level_eval.cuh, which K12
// fk_score and K13 choice_score include to sum a one-row child level in
// their own launches.


#include "level_eval.cuh"

// the parameter blocks a plan is passed in, in words (2, 8 and 16.6 KB)
#define K20_TIER0 256
#define K20_TIER1 1024
#define K20_THREADS 256
// elements a thread takes along the innermost axis (ops.K20_KERNELS): a
// level of at least ops.K20_WIDE elements 8 where its stack is at most 4
// deep, else 4 (float4 loads and stores); a smaller one 1 (a one-row
// level's gathers wait on dependent loads: more threads wait together)

namespace {

using namespace level_eval;

// A plan's words: the header, then n_refs references, n_ops operands and
// the program, packed; the struct's size is the smallest of K20_TIER0,
// K20_TIER1 and K20_WORDS that holds them, so a small level passes a small
// parameter block.
template <int W>
struct K20Plan {
  int64_t w[W];
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
  I base;
  const Place<I> pl = place<NARROW, E, I>(w, t, base);
  Stack<D, E> st;
  eval<D, E, I>(w, pl, st);
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
// whose counts disagree: level_eval::check), else cudaGetLastError()
// after the launch.
extern "C" int pclean_level_sum(const int64_t* words, int n_words,
                                void* stream) {
  if (n_words < K20_HEAD || n_words > K20_WORDS)
    return (int)cudaErrorInvalidValue;
  const int64_t kernel = words[kKernel];
  if (kernel < 0 || kernel > 6) return (int)cudaErrorInvalidValue;
  const int rc = check(words, n_words, kernel_elems((int)kernel),
                       kernel_depth((int)kernel), kernel < 6, true);
  if (rc != (int)cudaSuccess) return rc;
  if (words[kN] == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t threads = words[kThreads];
  if (n_words <= K20_TIER0)
    return launch_tier<K20_TIER0>(words, n_words, threads, (int)kernel, s);
  if (n_words <= K20_TIER1)
    return launch_tier<K20_TIER1>(words, n_words, threads, (int)kernel, s);
  return launch_tier<K20_WORDS>(words, n_words, threads, (int)kernel, s);
}
