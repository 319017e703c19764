// K17 choice_sample: one choice's sample step for every row of a block
// proposal, in one launch: a draw, a retained value, or a recorded pick.
//
// Replaces pclean_tpu/engine/propose.py BlockTracer.sample_choice
// (propose.py:981-1019), with _inv_cdf_from_u (:1153-1172) and the record
// pick at the ancestor positions (rec[anc] under vmap): for row b, with
// r = rec[b, anc_0[b], .., anc_{d-1}[b]] (each index clamped into its
// axis, as JAX's gather clamps),
//   draw mode:     out[b] = the draw over the V logits r at u[b]
//                  (inv_cdf.cuh, K2's own draw);
//   retained mode: out[b] = rv[b], or the dummy code where the choice has
//                  one and r[clamp(rv[b])] <= NEG_INF / 2 (a retained value
//                  outside the enumerated support);
//   pick mode:     out[b] = r, the one recorded value of the row (a
//                  statically observed value or a score-pass prior draw),
//                  copied in its own dtype.
// Draw and retained modes write int32.
//
// Bound on the H100 (3.35 TB/s): bytes. Draw mode reads a row's V logits
// and writes 4 bytes (B = 4,096, V = 5,125: 84 MB, ~25 us); the other
// modes move a few bytes a row, so the launch itself dominates.
//
// Design: draw mode is K2's geometry, one block of 512 threads a row
// (inv_cdf.cuh's draw_row); retained and pick modes are a thread a row,
// 256 threads a block. The plan (ops.choice_sample's words: pointers,
// strides, dtypes) is passed by value.

#include "inv_cdf.cuh"
#include "row_words.cuh"

#define K17_THREADS 256

namespace {

using namespace pclean_draw;

// Word indices of the plan (ops.choice_sample); from kAxes, each ancestor
// axis's stride, size, pointer and dtype (ops._rec_words).
enum {
  kB = 0, kV, kMode, kTile, kSmem, kRec, kNd, kRecB, kU, kUStride, kRv,
  kRvDt, kDummy, kHasDummy, kOut, kEsize, kAxes
};

#define K17_MAX_ANC 7
#define K17_WORDS (kAxes + 4 * K17_MAX_ANC)

struct K17Plan {
  int64_t w[K17_WORDS];
};

// The element offset of row b's record entry (its first logit).
__device__ __forceinline__ int64_t rec_offset(const int64_t* w, int64_t b) {
  return pclean_rec_offset(w + kAxes, w[kNd], w[kRecB], b);
}

__global__ void __launch_bounds__(kThreads)
    choice_draw_kernel(const __grid_constant__ K17Plan p) {
  extern __shared__ float4 buf4[];
  __shared__ float shf[33];
  __shared__ u64 shs[kWarps + 1];
  const int64_t* w = p.w;
  const int64_t b = blockIdx.x;
  const float* x = reinterpret_cast<const float*>(w[kRec]) + rec_offset(w, b);
  const float u = reinterpret_cast<const float*>(w[kU])[b * w[kUStride]];
  draw_row(x, w[kV], w[kTile], u, buf4, shf, shs,
           reinterpret_cast<int32_t*>(w[kOut]) + b);
}

__global__ void __launch_bounds__(K17_THREADS)
    choice_row_kernel(const __grid_constant__ K17Plan p) {
  const int64_t* w = p.w;
  const int64_t b = (int64_t)blockIdx.x * K17_THREADS + threadIdx.x;
  if (b >= w[kB]) return;
  const int64_t off = rec_offset(w, b);
  if (w[kMode] == 2) {   // pick: the recorded value's bytes
    const int64_t es = w[kEsize];
    const uint8_t* src = reinterpret_cast<const uint8_t*>(w[kRec]) + off * es;
    uint8_t* dst = reinterpret_cast<uint8_t*>(w[kOut]) + b * es;
    switch (es) {
      case 1: *dst = *src; break;
      case 2: *reinterpret_cast<uint16_t*>(dst) =
                  *reinterpret_cast<const uint16_t*>(src); break;
      case 4: *reinterpret_cast<uint32_t*>(dst) =
                  *reinterpret_cast<const uint32_t*>(src); break;
      default: *reinterpret_cast<uint64_t*>(dst) =
                   *reinterpret_cast<const uint64_t*>(src);
    }
    return;
  }
  const int64_t rv = pclean_ld_i(w[kRv], w[kRvDt], b);
  int64_t chosen = rv;
  if (w[kHasDummy]) {
    const float* x = reinterpret_cast<const float*>(w[kRec]) + off;
    if (!(x[pclean_clamp(rv, w[kV])] > PCLEAN_NEG_INF / 2)) chosen = w[kDummy];
  }
  reinterpret_cast<int32_t*>(w[kOut])[b] = (int32_t)chosen;
}

}  // namespace

// words: the plan (ops.choice_sample's words, K17_WORDS of them); mode 0
// draw, 1 retained, 2 pick. Returns cudaErrorInvalidValue for a plan it
// does not take, the error of raising the shared-memory limit where the
// card refuses the draw's smem, else cudaGetLastError() after the launch.
extern "C" int pclean_choice_sample(const int64_t* words, int n_words,
                                    void* stream) {
  if (n_words != K17_WORDS) return (int)cudaErrorInvalidValue;
  K17Plan p;
  for (int i = 0; i < K17_WORDS; ++i) p.w[i] = words[i];
  const int64_t B = p.w[kB], mode = p.w[kMode];
  if (B < 0 || mode < 0 || mode > 2 || p.w[kV] < 1 || p.w[kNd] < 0 ||
      p.w[kNd] > K17_MAX_ANC || p.w[kRec] == 0 || p.w[kOut] == 0 ||
      (mode == 0 && p.w[kU] == 0) || (mode == 1 && p.w[kRv] == 0) ||
      (mode == 2 && p.w[kEsize] != 1 && p.w[kEsize] != 2 &&
       p.w[kEsize] != 4 && p.w[kEsize] != 8))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (mode == 0) {
    const int smem = (int)p.w[kSmem];
    if (!plan_ok(p.w[kV], p.w[kTile], smem)) return (int)cudaErrorInvalidValue;
    static int smem_limit = 48 * 1024;
    const cudaError_t e = smem_attr(choice_draw_kernel, smem, &smem_limit);
    if (e != cudaSuccess) return (int)e;
    choice_draw_kernel<<<(unsigned)B, kThreads, smem, (cudaStream_t)stream>>>(
        p);
  } else {
    const unsigned blocks = (unsigned)((B + K17_THREADS - 1) / K17_THREADS);
    choice_row_kernel<<<blocks, K17_THREADS, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
