// K3 obs_gather_sum: the observed-column score of an fk candidate axis,
//   out[b, k] = sum_c M_c[obs[b, c], word[c, k]].
//
// Replaces the AddTypos observed-column terms of pclean_tpu/engine/
// propose.py: BlockTracer.score_choice's eager gather (propose.py:463-465,
// _AddTyposK.obs_logdensity at kernels.py:298-300) and its one-hot
// contraction _matmul_obs_term + _mm_flush (propose.py:296-375), which
// summed a sibling group of columns as concat(onehot(obs)) @ concat(T).
// The gather never builds the one-hot or the [V_c, K] score tables.
//
// Bound on the H100 (3.35 TB/s): bytes. The output [B, K] f32 is written
// once, word [C, K] and obs [B, C] int32 read once, and of each M_c only
// the rows the batch observes are needed: (B*K*4 + C*K*4 + B*C*4 +
// sum_c distinct(obs[:, c]) * V_c * 4) / 3.35e12 s.
//
// Two paths in one source; ops.obs_gather_plan picks one, its candidate
// tile and its grid from (B, K, [V_c]) and passes them to the entry point,
// which launches that grid.
//
// Staged path (batches): a block owns one row and a range of kt candidates.
// It first copies the row's observed M rows, M_c[obs[b, c], :] for every
// column, into shared memory (cp.async, neighbouring threads on
// neighbouring addresses; the rows of an odd V are not 16-byte aligned, so
// the copies are 4 bytes a thread), then walks its candidates four to a
// thread: each column's word codes are read as one int4, the 4
// accumulators live in registers, every M entry is a shared-memory read,
// and the four sums go out as one float4. The scattered device-memory
// gathers of the direct path (one 32-byte sector per 4-byte entry) become
// one coalesced read of each observed row per block. Four 512-thread
// blocks share an SM (registers capped at 32 a thread by the launch
// bounds), so one block's copies overlap the others' arithmetic; on an
// H100 at the scaled workload's V that beat tiles of 2, 4 and 8 rows a
// block that reuse each word code across rows (PERF.md). Staged rows up to
// the card's per-block shared memory are taken (the plan bounds them);
// above 48 KB the launch raises the kernel's dynamic shared-memory limit
// first.
//
// Direct path (one or a few rows, or rows too long to stage): a block owns
// 256 consecutive candidates and 4 rows; each thread keeps its candidate's
// word codes in registers and gathers M_c[obs[b, c], w_c] from device
// memory (the row of one b stays in L1/L2 for the block).
//
// Both paths sum the columns in order c = 0..C-1 from 0 (or from `out`
// when `accumulate` is set, for the groups after the first eight columns),
// the order of the plain version, so the two agree bit for bit. Matrix
// pointers, sizes and staged-row offsets come by value in one kernel
// argument, and the column loops unroll to kMaxCols with a guard on C, so
// no per-column array is indexed at run time (no local memory). Codes are
// clamped into [0, V_c), as the JAX package's gathers clamp.

#include "common.cuh"

namespace {

constexpr int kMaxCols = 8;
constexpr int kStagedThreads = 512;
constexpr int kStagedBlocksPerSM = 4;  // 2,048 threads: <= 32 registers each
constexpr int kDirectThreads = 256;
constexpr int kDirectRows = 4;
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in

struct Mats {
  const float* M[kMaxCols];
  int32_t V[kMaxCols];
};

struct StagedMats {
  const float* M[kMaxCols];
  int32_t V[kMaxCols];
  int32_t off[kMaxCols];  // column c's offset in a staged row, in floats
};

__device__ __forceinline__ int32_t clamp_code(int32_t x, int32_t V) {
  return x < 0 ? 0 : (x >= V ? V - 1 : x);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__global__ void __launch_bounds__(kStagedThreads, kStagedBlocksPerSM)
obs_gather_staged(const StagedMats mats, const int32_t* __restrict__ obs,
                  const int32_t* __restrict__ word, float* __restrict__ out,
                  int64_t B, int64_t K, int C, int64_t kt, int accumulate,
                  int vec) {
  extern __shared__ float4 staged4[];
  float* staged = reinterpret_cast<float*>(staged4);  // one row of sum(V_c)
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  if (b >= B) return;

#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < C) {
      const int32_t V = mats.V[c];
      const int32_t o = clamp_code(obs[b * C + c], V);
      const float* src = mats.M[c] + (int64_t)o * V;
      float* dst = staged + mats.off[c];
      for (int i = tid; i < V; i += kStagedThreads) cp_async4(dst + i, src + i);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int64_t k_lo = (int64_t)blockIdx.y * kt;
  const int64_t k_hi = k_lo + kt < K ? k_lo + kt : K;
  float* row = out + b * K;
  for (int64_t k = k_lo + 4 * tid; k < k_hi; k += 4 * kStagedThreads) {
    float acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = (accumulate && k + j < k_hi) ? row[k + j] : 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < C) {
        const int32_t V = mats.V[c];
        int32_t w[4];
        if (vec) {
          const int4 w4 = __ldg(reinterpret_cast<const int4*>(
              word + (int64_t)c * K + k));
          w[0] = w4.x; w[1] = w4.y; w[2] = w4.z; w[3] = w4.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[j] = k + j < k_hi ? word[(int64_t)c * K + k + j] : 0;
        }
        const float* sc = staged + mats.off[c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += sc[clamp_code(w[j], V)];
      }
    }
    if (vec) {
      *reinterpret_cast<float4*>(row + k) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < k_hi) row[k + j] = acc[j];
    }
  }
}

template <bool ACC>
__global__ void __launch_bounds__(kDirectThreads)
obs_gather_direct(const Mats mats, const int32_t* __restrict__ obs,
                  const int32_t* __restrict__ word, float* __restrict__ out,
                  int64_t B, int64_t K, int C) {
  const int64_t k = (int64_t)blockIdx.x * kDirectThreads + threadIdx.x;
  if (k >= K) return;
  int32_t w[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < C) w[c] = clamp_code(word[(int64_t)c * K + k], mats.V[c]);
  }
  const int64_t b0 = (int64_t)blockIdx.y * kDirectRows;
  for (int r = 0; r < kDirectRows; ++r) {
    const int64_t b = b0 + r;
    if (b >= B) break;
    float acc = ACC ? out[b * K + k] : 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < C) {
        const int32_t V = mats.V[c];
        const int32_t o = clamp_code(obs[b * C + c], V);
        acc += __ldg(mats.M[c] + (int64_t)o * V + w[c]);
      }
    }
    out[b * K + k] = acc;
  }
}

}  // namespace

// mats [C] host array of device pointers to f32 [V_c, V_c] matrices, vsize
// [C] host int32 array; obs [B, C] int32, word [C, K] int32, out [B, K] f32
// on the device, contiguous; 1 <= C <= 8. accumulate: add into `out`
// instead of starting from 0. The plan (ops.obs_gather_plan) is launched as
// given: path 0 = direct (kt 256, smem 0, grid (candidate tiles of 256,
// row groups of 4)), path 1 = staged (kt a multiple of 4, smem =
// sum(V_c) * 4, grid (B rows, candidate tiles of kt)). Returns
// cudaErrorInvalidValue for a plan that does not cover [B, K] with these
// tiles, the error of raising the shared-memory limit where the card
// refuses smem, else cudaGetLastError() after the launch.
extern "C" int pclean_obs_gather_sum(const int64_t* mats,
                                     const int32_t* vsize,
                                     const int32_t* obs, const int32_t* word,
                                     float* out, int64_t B, int64_t K, int C,
                                     int accumulate, int path, int64_t kt,
                                     int smem, int64_t grid_x, int64_t grid_y,
                                     void* stream) {
  if (C < 1 || C > kMaxCols) return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  if (path == 0) {
    if (kt != kDirectThreads || smem != 0 || grid_x * kt < K ||
        grid_y * kDirectRows < B)
      return (int)cudaErrorInvalidValue;
    Mats m = {};
    for (int c = 0; c < C; ++c) {
      m.M[c] = reinterpret_cast<const float*>(mats[c]);
      m.V[c] = vsize[c];
    }
    if (accumulate)
      obs_gather_direct<true><<<grid, kDirectThreads, 0, s>>>(m, obs, word,
                                                              out, B, K, C);
    else
      obs_gather_direct<false><<<grid, kDirectThreads, 0, s>>>(m, obs, word,
                                                               out, B, K, C);
    return (int)cudaGetLastError();
  }
  StagedMats m = {};
  int64_t row_floats = 0;
  for (int c = 0; c < C; ++c) {
    m.M[c] = reinterpret_cast<const float*>(mats[c]);
    m.V[c] = vsize[c];
    m.off[c] = (int32_t)row_floats;
    row_floats += vsize[c];
  }
  if (path != 1 || kt <= 0 || kt % 4 != 0 || (int64_t)smem != row_floats * 4
      || grid_x < B || grid_y * kt < K)
    return (int)cudaErrorInvalidValue;
  static int smem_limit = kDefaultSmem;  // a property of the function
  if (smem > smem_limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        obs_gather_staged, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_limit = smem;
  }
  const int vec = K % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(word) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  obs_gather_staged<<<grid, kStagedThreads, smem, s>>>(
      m, obs, word, out, B, K, C, kt, accumulate, vec);
  return (int)cudaGetLastError();
}
