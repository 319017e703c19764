// K1 enum_logsumexp: the block-enumeration record and its log-normalizer.
//
// Replaces, in pclean_tpu/engine/propose.py, the concat + logsumexp of
// BlockTracer.score_fk (propose.py:559-564: logits = [exist, new], kept as
// the record the sample pass draws from, logZ = logsumexp(logits)) and the
// per-value logsumexp of BlockTracer.score_choice (propose.py:517-519,
// record mode off: the caller keeps its own logits).
//
// Bound on the H100 (3.35 TB/s): bytes. A row of K existing-candidate
// logits is read once and K+1 record entries plus one logZ are written, so
// for R rows the floor is (R*K*4 + R*4 + R*(K+1)*4 + R*4) / 3.35e12 s; the
// exp per entry is far below the card's arithmetic rate.
//
// Design: one block per row. Pass 1 reads the row, copies it into the
// record and takes the max (block reduction); pass 2 re-reads the row (the
// row is at most ~45 KB, so it comes from L2) and sums exp(x - m) (block
// reduction). The finite NEG_INF rules of pclean_tpu.utils.logsumexp are
// kept exactly: the max is floored at NEG_INF, so an all-NEG_INF row gives
// log(K+1) + NEG_INF (= NEG_INF in f32), never NaN.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
enum_logsumexp_kernel(const float* __restrict__ exist,
                      const float* __restrict__ fresh,
                      float* __restrict__ record,
                      float* __restrict__ logz, int64_t K) {
  __shared__ float sh[33];
  const int64_t row = blockIdx.x;
  const float* x = exist + row * K;
  float* rec = record != nullptr ? record + row * (K + 1) : nullptr;

  float m = -INFINITY;
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) {
    const float v = x[k];
    if (rec != nullptr) rec[k] = v;
    m = fmaxf(m, v);
  }
  float nv = 0.0f;
  if (fresh != nullptr) {
    nv = fresh[row];
    m = fmaxf(m, nv);
    if (threadIdx.x == 0 && rec != nullptr) rec[K] = nv;
  }
  m = pclean_block_max(m, sh);
  m = fmaxf(m, PCLEAN_NEG_INF);

  float s = 0.0f;
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) s += expf(x[k] - m);
  if (fresh != nullptr && threadIdx.x == 0) s += expf(nv - m);
  s = pclean_block_sum(s, sh);

  if (threadIdx.x == 0) {
    const float out = logf(s) + m;
    const bool keep = isfinite(m) || (m > PCLEAN_NEG_INF / 2.0f);
    logz[row] = keep ? out : PCLEAN_NEG_INF;
  }
}

}  // namespace

// exist [R, K] f32, fresh [R] f32 or null, record [R, K+1] f32 or null
// (null exactly when fresh is null), logz [R] f32. All contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int pclean_enum_logsumexp(const float* exist, const float* fresh,
                                     float* record, float* logz, int64_t R,
                                     int64_t K, void* stream) {
  if (R > 0) {
    enum_logsumexp_kernel<<<(unsigned)R, kThreads, 0,
                            (cudaStream_t)stream>>>(exist, fresh, record,
                                                    logz, K);
  }
  return (int)cudaGetLastError();
}
