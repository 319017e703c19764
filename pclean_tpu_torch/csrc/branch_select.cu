// K19 branch_select: a foreign key's existing/fresh branch select over
// every vertex of its subtree, in one launch.
//
// Replaces pclean_tpu/engine/propose.py BlockTracer.sample_fk's select
// after its two branches (propose.py:1093-1097): for each pair j of the
// subtree's (fresh value, existing value) and each row b,
//   out_j[b] = is_new[b] ? new_j[b] : existing_j[b] converted to new_j's
//   dtype (torch's .to: a float truncates toward zero into an integer, a
//   bool is v != 0),
// where a value of one element is broadcast over the B rows.
//
// Bound on the H100 (3.35 TB/s): bytes, each pair's two values and the
// is_new bits read and its output written once: a few KB at B = 4,096;
// at one row the launch and one round trip to memory are all there is.
//
// Design: the plan (ops.branch_select's words: each pair's three
// pointers and one word of dtypes and broadcast bits) is passed by value
// in one parameter block of K19_MAX_PAIRS pairs (a plan past 64 pairs
// goes in launches of 64; a block's size costs a launch nothing, PERF.md
// section 3, and a block reads only its own pair's words). A block takes a tile of one pair's rows, blockIdx.y the pair (one block a
// pair at one row), so no thread divides and every read of the plan is
// the same word across the block's threads: a lane a pair would read as
// many words of the plan in one instruction as there are pairs, and such
// reads go one after another. Each thread loads is_new, the new value and
// the existing value together, as raw bits of their widths, before it
// selects: one round of loads, then one store.

#include <cuda_runtime.h>

#include "row_words.cuh"

#define K19_HEAD 3
#define K19_PAIR 4
#define K19_MAX_PAIRS 64
#define K19_THREADS 256

namespace {

struct K19Plan {
  int64_t w[K19_HEAD + K19_PAIR * K19_MAX_PAIRS];
};

// Bits of p[i] for an element of dtype dt, zero-extended.
__device__ __forceinline__ uint64_t ld_bits(int64_t p, int dt, int64_t i) {
  switch (pclean_dt_size(dt)) {
    case 1:
      return reinterpret_cast<const uint8_t*>(p)[i];
    case 2:
      return reinterpret_cast<const uint16_t*>(p)[i];
    case 4:
      return reinterpret_cast<const uint32_t*>(p)[i];
    default:
      return reinterpret_cast<const uint64_t*>(p)[i];
  }
}

__device__ __forceinline__ void st_bits(int64_t p, int dt, int64_t i,
                                        uint64_t v) {
  switch (pclean_dt_size(dt)) {
    case 1:
      reinterpret_cast<uint8_t*>(p)[i] = (uint8_t)v;
      break;
    case 2:
      reinterpret_cast<uint16_t*>(p)[i] = (uint16_t)v;
      break;
    case 4:
      reinterpret_cast<uint32_t*>(p)[i] = (uint32_t)v;
      break;
    default:
      reinterpret_cast<uint64_t*>(p)[i] = v;
  }
}

// The bits of an element of dtype from (bits v) converted to dtype to.
__device__ __forceinline__ uint64_t convert(uint64_t v, int from, int to) {
  if (from == to) return v;
  int64_t i = 0;
  double f = 0.0;
  bool is_f = true;
  switch (from) {
    case PCLEAN_DT_BOOL:
    case PCLEAN_DT_U8:
      i = (uint8_t)v, is_f = false;
      break;
    case PCLEAN_DT_I8:
      i = (int8_t)v, is_f = false;
      break;
    case PCLEAN_DT_I16:
      i = (int16_t)v, is_f = false;
      break;
    case PCLEAN_DT_I32:
      i = (int32_t)v, is_f = false;
      break;
    case PCLEAN_DT_I64:
      i = (int64_t)v, is_f = false;
      break;
    case PCLEAN_DT_F32:
      f = __uint_as_float((uint32_t)v);
      break;
    default:
      f = __longlong_as_double((long long)v);
  }
  if (to == PCLEAN_DT_F32)
    return __float_as_uint(is_f ? (float)f : (float)i);
  if (to == PCLEAN_DT_F64)
    return (uint64_t)__double_as_longlong(is_f ? f : (double)i);
  if (to == PCLEAN_DT_BOOL) return is_f ? f != 0.0 : i != 0;
  return (uint64_t)(is_f ? (int64_t)f : i);   // narrowed by st_bits
}

__global__ void __launch_bounds__(K19_THREADS)
    branch_select_kernel(const __grid_constant__ K19Plan p) {
  const int64_t* w = p.w;
  const int j = blockIdx.y, b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (int)w[1]) return;
  // [new, existing, out, dtypes and broadcast bits]
  const int64_t* q = w + K19_HEAD + K19_PAIR * j;
  const int bits = (int)q[3];
  const int ndt = bits & 15, edt = (bits >> 4) & 15;
  const uint8_t fresh = reinterpret_cast<const uint8_t*>(w[2])[b];
  const uint64_t nv = ld_bits(q[0], ndt, (bits >> 8) & 1 ? 0 : b);
  const uint64_t ev = ld_bits(q[1], edt, (bits >> 9) & 1 ? 0 : b);
  st_bits(q[2], ndt, b, fresh ? nv : convert(ev, edt, ndt));
}

}  // namespace

// words: the plan (ops.branch_select's words): [pairs (at most
// K19_MAX_PAIRS), B, is_new (bool [B])], then each pair [new, existing,
// out ([B] of new's dtype), new's dtype | existing's dtype << 4 | new
// broadcast << 8 | existing broadcast << 9] (a broadcast value has one
// element). Returns cudaErrorInvalidValue for a plan it does not take,
// else cudaGetLastError() after the launch.
extern "C" int pclean_branch_select(const int64_t* words, int n_words,
                                    void* stream) {
  if (n_words < K19_HEAD || words[0] < 0 || words[0] > K19_MAX_PAIRS ||
      words[1] < 0 || words[1] > 2147483647 || words[2] == 0 ||
      n_words != K19_HEAD + K19_PAIR * words[0])
    return (int)cudaErrorInvalidValue;
  for (int64_t j = 0; j < words[0]; ++j) {
    const int64_t* q = words + K19_HEAD + K19_PAIR * j;
    if (q[0] == 0 || q[1] == 0 || q[2] == 0 || (q[3] & 15) > 7 ||
        ((q[3] >> 4) & 15) > 7 || (q[3] >> 10) != 0)
      return (int)cudaErrorInvalidValue;
  }
  if (words[0] == 0 || words[1] == 0) return (int)cudaSuccess;
  K19Plan p;
  for (int i = 0; i < n_words; ++i) p.w[i] = words[i];
  const int64_t B = words[1];
  const int64_t t = B < K19_THREADS ? (B + 31) / 32 * 32 : K19_THREADS;
  const dim3 grid((unsigned)((B + t - 1) / t), (unsigned)words[0]);
  branch_select_kernel<<<grid, (unsigned)t, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
