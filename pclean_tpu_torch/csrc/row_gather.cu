// K18 row_gather: a group of fk-chain gathers from one slot tensor, in one
// launch.
//
// Replaces the gathers of pclean_tpu/engine/propose.py row_value
// (propose.py:1410-1443) on a SubmodelNode chain ending in a Choice or
// ForeignKey leaf, or on such a leaf alone, and the copy-mode reads of one
// foreign key, which the JAX tracer takes one vertex at a time at the same
// slots inside one lax.scan body and XLA fuses (score_step, propose.py:
// 424-442; sample_step, :971-977): for each slot s of a tensor of any
// shape and strides, and each chain g of the group,
//   t = s; for each hop column h of g: t = h[clamp(t, len h)];
//   out_g = leaf_g[clamp(t, len leaf_g)]
// every index clamped into its column as take() and JAX's gathers clamp
// it. Each output has the slot tensor's shape (contiguous) and its leaf's
// own dtype; its bytes are copied.
//
// Bound on the H100 (3.35 TB/s): bytes, a slot, an entry of each distinct
// hop column and of each leaf read and one value written a chain and slot:
// at 1,000,000 slots of one int32 leaf, 12 MB, ~3.6 us; at one slot a
// launch floor. The loads of one chain depend on each other, so a short
// chain waits one load a hop.
//
// Design: a thread a slot, 256 threads a block. The group's hop columns
// form a tree over the slot (the plan's nodes: a column and its parent
// node, node 0 the slot), so chains that start with the same hops load
// them once; the tree is walked once a slot in registers, each node's
// index selected from the earlier ones by an unrolled compare (no local
// array). Every chain's leaf entry is loaded before any output is stored,
// so the loads of one slot overlap, and chain g's output is written at the
// slot's position: a warp's stores to one output are consecutive. Three
// instantiations by the group's size (2 nodes and 4 chains, 4 and 8, 8 and
// 16): each reads its nodes and chains at fixed words of its parameter
// block, so no plan word waits on another, and a small group holds few
// registers (a thread a slot wants many threads in flight). The plan
// (ops.row_gather_words: pointers, dtypes, lengths, the slot tensor's
// shape, the tree, the chains) is passed by value, so a launch can be
// captured in a CUDA graph.

#include <cuda_runtime.h>

#include "row_words.cuh"

#define K18_MAX_DIMS 8
#define K18_HEAD 24
#define K18_NODE 4
#define K18_CHAIN 5
#define K18_THREADS 256
// a class's words: the header, n nodes, c chains (ops.K18_CLASSES)
#define K18_CLASS_WORDS(n, c) (K18_HEAD + K18_NODE * (n) + K18_CHAIN * (c))

namespace {

template <int N, int C>
struct K18Plan {
  int64_t w[K18_CLASS_WORDS(N, C)];
};

// Word indices of the header (ops.row_gather_words); a node is (column,
// dtype, length, parent node), a chain (node, leaf, leaf length, output,
// element size).
enum {
  kN = 0, kDims, kSlot, kSlotDt, kContig, kSizes = 5,
  kStrides = 5 + K18_MAX_DIMS, kNodes = 5 + 2 * K18_MAX_DIMS, kChains,
  kClass
};

// t[k] for a k the plan gives, by an unrolled select over the register
// array (a dynamic index would put t in local memory).
template <int N>
__device__ __forceinline__ int64_t pick(const int64_t (&t)[N + 1],
                                        int64_t k) {
  int64_t v = t[0];
#pragma unroll
  for (int m = 1; m <= N; ++m)
    if (m == k) v = t[m];
  return v;
}

__device__ __forceinline__ uint64_t ld_bits(int64_t p, int64_t es,
                                            int64_t i) {
  switch (es) {
    case 1: return reinterpret_cast<const uint8_t*>(p)[i];
    case 2: return reinterpret_cast<const uint16_t*>(p)[i];
    case 4: return reinterpret_cast<const uint32_t*>(p)[i];
    default: return reinterpret_cast<const uint64_t*>(p)[i];
  }
}

__device__ __forceinline__ void st_bits(int64_t p, int64_t es, int64_t i,
                                        uint64_t v) {
  switch (es) {
    case 1: reinterpret_cast<uint8_t*>(p)[i] = (uint8_t)v; break;
    case 2: reinterpret_cast<uint16_t*>(p)[i] = (uint16_t)v; break;
    case 4: reinterpret_cast<uint32_t*>(p)[i] = (uint32_t)v; break;
    default: reinterpret_cast<uint64_t*>(p)[i] = v;
  }
}

template <int N, int C>
__global__ void __launch_bounds__(K18_THREADS)
    row_gather_kernel(const __grid_constant__ K18Plan<N, C> p) {
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
  const int n_nodes = (int)w[kNodes], n_chains = (int)w[kChains];
  int64_t t[N + 1];
  t[0] = pclean_ld_i(w[kSlot], w[kSlotDt], off);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    t[j + 1] = 0;
    if (j < n_nodes) {
      const int64_t* c = w + K18_HEAD + K18_NODE * j;
      t[j + 1] =
          pclean_ld_i(c[0], c[1], pclean_clamp(pick<N>(t, c[3]), c[2]));
    }
  }
  uint64_t v[C];
#pragma unroll
  for (int g = 0; g < C; ++g) {
    v[g] = 0;
    if (g < n_chains) {
      const int64_t* c = w + K18_HEAD + K18_NODE * N + K18_CHAIN * g;
      v[g] = ld_bits(c[1], c[4], pclean_clamp(pick<N>(t, c[0]), c[2]));
    }
  }
#pragma unroll
  for (int g = 0; g < C; ++g)
    if (g < n_chains) {
      const int64_t* c = w + K18_HEAD + K18_NODE * N + K18_CHAIN * g;
      st_bits(c[3], c[4], i, v[g]);
    }
}

template <int N, int C>
int launch(const int64_t* words, int64_t n_words, cudaStream_t stream) {
  if (n_words != K18_CLASS_WORDS(N, C)) return (int)cudaErrorInvalidValue;
  K18Plan<N, C> p;
  for (int i = 0; i < K18_CLASS_WORDS(N, C); ++i) p.w[i] = words[i];
  const int64_t blocks = (p.w[kN] + K18_THREADS - 1) / K18_THREADS;
  row_gather_kernel<N, C><<<(unsigned)blocks, K18_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// words: the plan (ops.row_gather_words: the header, the class's node
// slots, its chain slots). Returns cudaErrorInvalidValue for a plan it
// does not take (a class it does not have or words of another length, a
// node whose parent is not an earlier node, a chain at a node it does not
// have, an element size other than 1, 2, 4 or 8, a null pointer, a count
// past its class), else cudaGetLastError() after the launch.
extern "C" int pclean_row_gather(const int64_t* words, int n_words,
                                 void* stream) {
  static const int kMaxNodes[3] = {2, 4, 8}, kMaxChains[3] = {4, 8, 16};
  if (n_words < K18_HEAD) return (int)cudaErrorInvalidValue;
  const int64_t* w = words;
  const int64_t N = w[kN], n_nodes = w[kNodes], n_chains = w[kChains];
  const int64_t cls = w[kClass];
  if (cls < 0 || cls > 2) return (int)cudaErrorInvalidValue;
  const int most_nodes = kMaxNodes[cls], most_chains = kMaxChains[cls];
  if (N < 0 || w[kDims] < 0 || w[kDims] > K18_MAX_DIMS || n_nodes < 0 ||
      n_nodes > most_nodes || n_chains < 1 || n_chains > most_chains ||
      n_words != K18_CLASS_WORDS(most_nodes, most_chains) ||
      (N > 0 && w[kSlot] == 0))
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < w[kDims]; ++d)
    if (w[kSizes + d] < 1) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < n_nodes; ++j) {
    const int64_t* c = w + K18_HEAD + K18_NODE * j;
    if (c[0] == 0 || c[2] < 1 || c[3] < 0 || c[3] > j)
      return (int)cudaErrorInvalidValue;
  }
  for (int g = 0; g < n_chains; ++g) {
    const int64_t* c = w + K18_HEAD + K18_NODE * most_nodes + K18_CHAIN * g;
    const int64_t es = c[4];
    if (c[0] < 0 || c[0] > n_nodes || c[2] < 1 ||
        (es != 1 && es != 2 && es != 4 && es != 8) ||
        (N > 0 && (c[1] == 0 || c[3] == 0)))
      return (int)cudaErrorInvalidValue;
  }
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (cls == 0) return launch<2, 4>(words, n_words, s);
  if (cls == 1) return launch<4, 8>(words, n_words, s);
  return launch<8, 16>(words, n_words, s);
}
