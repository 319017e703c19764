// K18 row_gather: a vertex's stored value at any number of rows, through
// its foreign-key chain, in one launch.
//
// Replaces the gathers of pclean_tpu/engine/propose.py row_value
// (propose.py:1410-1443) on a SubmodelNode chain ending in a Choice or
// ForeignKey leaf, or on such a leaf alone: for each slot s of a tensor
// of any shape and strides,
//   t = s; for each hop column h: t = h[clamp(t, len h)];
//   out = leaf[clamp(t, len leaf)]
// every index clamped into its column as take() and JAX's gathers clamp
// it. The output has the slot tensor's shape (contiguous) and the leaf's
// own dtype; its bytes are copied.
//
// Bound on the H100 (3.35 TB/s): bytes, a slot, an entry of each hop
// column and of the leaf read and one value written a slot: at 1,000,000
// slots of one hop into an int32 column, 16 MB, ~5 us; the loads of one
// slot depend on each other, so a short chain waits one load a hop.
//
// Design: a thread a slot, 256 threads a block; the slot's offset from
// its index by the tensor's sizes and strides (up to 8 axes) where it is
// not contiguous. The plan (ops.row_gather's words: pointers, dtypes,
// lengths, the slot tensor's shape) is passed by value.

#include <cuda_runtime.h>

#include "row_words.cuh"

#define K18_MAX_DIMS 8
#define K18_MAX_HOPS 4
#define K18_WORDS (24 + 3 * K18_MAX_HOPS + 5)
#define K18_THREADS 256

namespace {

struct K18Plan {
  int64_t w[K18_WORDS];
};

// Word indices of the plan (ops.row_gather).
enum {
  kN = 0, kDims, kSlot, kSlotDt, kContig, kSizes = 5,
  kStrides = 5 + K18_MAX_DIMS, kHops = 5 + 2 * K18_MAX_DIMS,
  kHop0 = kHops + 1, kLeaf = kHop0 + 3 * K18_MAX_HOPS, kLeafDt, kLeafN,
  kOut, kEsize
};

__global__ void __launch_bounds__(K18_THREADS)
    row_gather_kernel(const __grid_constant__ K18Plan p) {
  const int64_t* w = p.w;
  const int64_t i = (int64_t)blockIdx.x * K18_THREADS + threadIdx.x;
  if (i >= w[kN]) return;
  int64_t off = i;
  if (!w[kContig]) {
    off = 0;
    int64_t r = i;
    for (int d = (int)w[kDims] - 1; d >= 0; --d) {
      const int64_t n = w[kSizes + d];
      off += (r % n) * w[kStrides + d];
      r /= n;
    }
  }
  int64_t t = pclean_ld_i(w[kSlot], w[kSlotDt], off);
  for (int h = 0; h < w[kHops]; ++h) {
    const int64_t* c = w + kHop0 + 3 * h;
    t = pclean_ld_i(c[0], c[1], pclean_clamp(t, c[2]));
  }
  t = pclean_clamp(t, w[kLeafN]);
  const int64_t es = w[kEsize];
  const uint8_t* src = reinterpret_cast<const uint8_t*>(w[kLeaf]) + t * es;
  uint8_t* dst = reinterpret_cast<uint8_t*>(w[kOut]) + i * es;
  switch (es) {
    case 1: *dst = *src; break;
    case 2: *reinterpret_cast<uint16_t*>(dst) =
                *reinterpret_cast<const uint16_t*>(src); break;
    case 4: *reinterpret_cast<uint32_t*>(dst) =
                *reinterpret_cast<const uint32_t*>(src); break;
    default: *reinterpret_cast<uint64_t*>(dst) =
                 *reinterpret_cast<const uint64_t*>(src);
  }
}

}  // namespace

// words: the plan (ops.row_gather's words, K18_WORDS of them). Returns
// cudaErrorInvalidValue for a plan it does not take, else
// cudaGetLastError() after the launch.
extern "C" int pclean_row_gather(const int64_t* words, int n_words,
                                 void* stream) {
  if (n_words != K18_WORDS) return (int)cudaErrorInvalidValue;
  K18Plan p;
  for (int i = 0; i < K18_WORDS; ++i) p.w[i] = words[i];
  const int64_t N = p.w[kN], es = p.w[kEsize];
  if (N < 0 || p.w[kDims] < 0 || p.w[kDims] > K18_MAX_DIMS ||
      p.w[kHops] < 0 || p.w[kHops] > K18_MAX_HOPS || p.w[kLeafN] < 1 ||
      (es != 1 && es != 2 && es != 4 && es != 8) ||
      (N > 0 && (p.w[kSlot] == 0 || p.w[kLeaf] == 0 || p.w[kOut] == 0)))
    return (int)cudaErrorInvalidValue;
  for (int h = 0; h < p.w[kHops]; ++h)
    if (p.w[kHop0 + 3 * h] == 0 || p.w[kHop0 + 3 * h + 2] < 1)
      return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int64_t blocks = (N + K18_THREADS - 1) / K18_THREADS;
  row_gather_kernel<<<(unsigned)blocks, K18_THREADS, 0,
                      (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
