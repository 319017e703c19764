// K4 gauss_suffstats: the per-(slot, group) Gaussian sufficient statistics
// of a latent class's referrers, for the closed-form Gaussian external,
//   n[t_r, c_r] += 1, sz[t_r, c_r] += z_r, szz[t_r, c_r] += z_r^2,
//   pre0[t_r] += const - ld_r      over the referrers r with w_r set.
//
// Replaces the four scatters of referrer_histograms' gauss_stats in
// pclean_tpu/engine/propose.py:1348-1356 (`.at[t, rv].add(..., mode=
// "drop")`). t_r is the slot the referrer's fk chain leads to, c_r its
// group (the one per-referrer argument of the mean's key table, the room
// type in the rents model), w_r "alive and observed", z_r = backward(y_r)
// and ld_r = log|deriv(z_r)| (computed by torch before the launch: they run
// the model's Transformation callables). A referrer whose t or c lies
// outside [0, cap) x [0, C) is dropped from n, sz and szz, and one whose t
// lies outside [0, cap) from pre0 too, as mode="drop" drops.
//
// Bound on the H100 (3.35 TB/s): bytes, and at the rents workload's size
// (50,000 referrers, cap 4,096, C 5) far below the launch floor: each
// referrer's 17 bytes read once and the 3 * cap * C + cap outputs written
// once, about 1.1 MB, 0.33 us. It runs once per sweep segment.
//
// Design: one thread per referrer, atomicAdd into the outputs, which the
// wrapper zeroes first (one buffer, one memset). n is a count below 2^24,
// so exact in f32 whatever the order; sz, szz and pre0 are f32 sums whose
// order the atomics leave open, so they agree with the plain version to
// rtol 1e-5 of the sum of |terms| of each cell. A slot with many referrers
// serialises their atomics on its cells; at 20,000 referrers in one slot
// that is the kernel's worst case, still one pass.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gauss_suffstats_kernel(const int32_t* __restrict__ t,
                       const int32_t* __restrict__ rv,
                       const uint8_t* __restrict__ w,
                       const float* __restrict__ z,
                       const float* __restrict__ ld, float cst,
                       float* __restrict__ n, float* __restrict__ sz,
                       float* __restrict__ szz, float* __restrict__ pre0,
                       int64_t R, int64_t cap, int C) {
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= R || !w[r]) return;
  const int32_t s = t[r];
  if (s < 0 || s >= cap) return;
  atomicAdd(pre0 + s, cst - ld[r]);
  const int32_t g = rv[r];
  if (g < 0 || g >= C) return;
  const float zr = z[r];
  const int64_t cell = (int64_t)s * C + g;
  atomicAdd(n + cell, 1.0f);
  atomicAdd(sz + cell, zr);
  atomicAdd(szz + cell, zr * zr);
}

}  // namespace

// t, rv [R] int32, w [R] bool (one byte), z, ld [R] f32 on the device,
// contiguous; n, sz, szz [cap, C] and pre0 [cap] f32, zeroed by the caller.
// The plan (ops.gauss_suffstats_plan) is launched as given: `threads`
// threads (256) a block, `grid` blocks covering R. Returns
// cudaErrorInvalidValue for a plan that does not, else cudaGetLastError()
// after the launch.
extern "C" int pclean_gauss_suffstats(const int32_t* t, const int32_t* rv,
                                      const uint8_t* w, const float* z,
                                      const float* ld, float cst, float* n,
                                      float* sz, float* szz, float* pre0,
                                      int64_t R, int64_t cap, int C,
                                      int threads, int64_t grid,
                                      void* stream) {
  if (C < 1 || cap < 1) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  if (threads != kThreads || grid * kThreads < R)
    return (int)cudaErrorInvalidValue;
  gauss_suffstats_kernel<<<(unsigned)grid, kThreads, 0,
                           (cudaStream_t)stream>>>(t, rv, w, z, ld, cst, n,
                                                   sz, szz, pre0, R, cap, C);
  return (int)cudaGetLastError();
}
