// K2 inv_cdf_sample: one categorical draw per row by inverse CDF.
//
// Replaces pclean_tpu/engine/propose.py _inv_cdf_from_u (propose.py:
// 1153-1172), the draw behind BlockTracer.sample_fk and sample_choice
// (which K16 fk_sample and K17 choice_sample now make themselves, with
// this same draw) and the MaybeSwap prior draw. The draw, its exact
// fixed-point prefix sums, the (0, total] threshold and the streamed form
// for rows longer than shared memory live in inv_cdf.cuh, shared with K16
// and K17.
//
// Bound on the H100 (3.35 TB/s): bytes. R rows of K logits and R uniforms
// are read once and R int32 indices written: (R*K*4 + R*4 + R*4) / 3.35e12 s.
//
// Design: one block of 512 threads per row, inv_cdf.cuh's draw_row.

#include "inv_cdf.cuh"

namespace {

using namespace pclean_draw;

__global__ void __launch_bounds__(kThreads)
inv_cdf_sample_kernel(const float* __restrict__ logits,
                      const float* __restrict__ u, int32_t* __restrict__ idx,
                      int64_t K, int64_t tile) {
  extern __shared__ float4 buf4[];
  __shared__ float shf[33];
  __shared__ u64 shs[kWarps + 1];
  const int64_t row = blockIdx.x;
  draw_row(logits + row * K, K, tile, u[row], buf4, shf, shs, idx + row);
}

}  // namespace

// logits [R, K] f32, u [R] f32 in [0, 1), idx [R] int32; contiguous.
// One block a row. The plan (ops.inv_cdf_plan): tile >= K reads the row
// once into shared memory (smem = (K + 4) * 4 bytes); a shorter tile, a
// multiple of 4, streams the row (smem = (tile + 4) * 4). Returns
// cudaErrorInvalidValue for a plan it does not take, the error of raising
// the shared-memory limit where the card refuses smem, else
// cudaGetLastError() after the launch.
extern "C" int pclean_inv_cdf_sample(const float* logits, const float* u,
                                     int32_t* idx, int64_t R, int64_t K,
                                     int64_t tile, int smem, void* stream) {
  if (!plan_ok(K, tile, smem)) return (int)cudaErrorInvalidValue;
  static int smem_limit = 48 * 1024;
  const cudaError_t e = smem_attr(inv_cdf_sample_kernel, smem, &smem_limit);
  if (e != cudaSuccess) return (int)e;
  if (R > 0) {
    inv_cdf_sample_kernel<<<(unsigned)R, kThreads, smem,
                            (cudaStream_t)stream>>>(logits, u, idx, K, tile);
  }
  return (int)cudaGetLastError();
}
