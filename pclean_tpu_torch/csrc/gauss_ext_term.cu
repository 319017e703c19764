// K5 gauss_ext_term: the closed-form Gaussian external of a latent block,
// from the env coordinates to the term,
//   row[b, a]   = sum_i clamp(e_i[b, a], 0, n_i - 1) * stride_i,
//   mu[b, a, c] = values[tbl[row[b, a], c]],
//   out[b, a]   = coef * (sum_c szz[s_b, c] - 2 sum_c mu * sz[s_b, c]
//                         + sum_c mu^2 * n[s_b, c]) + pre0[s_b],
// with s_b the swept slot of row b, coef = -1 / (2 std^2), e_i the i-th
// env coordinate (the enumerated state and the row's own county key in
// the rents model) broadcast over the output [B, option axes...], n_i its
// axis of the key table and stride_i that axis' row-major stride; C is the
// referrer group axis (room types).
//
// Replaces the whole of BlockTracer._ext_gauss_term's device work in
// pclean_tpu/engine/propose.py:850-872, which XLA fused into one pass:
// the key-table row of each (row, option), the gather of the indexed Mean
// values through it (values[tbl[env_idx]], an [axes..., C] tensor a row)
// and the three C-length reductions. The port's first form left the row
// index to about ten torch launches before its kernel.
//
// Bound on the H100 (3.35 TB/s): bytes, far below the launch floor at the
// rents County block's [256 rows, 51 states, C = 5]: out (52 KB), the
// coordinates' own elements (51 states and 256 county keys), the table
// rows and values the batch touches (at most 256 * 51 rows of 20 bytes and
// as many values) and the B slots' statistics. What bounds it in practice
// is latency: three dependent rounds of loads (coordinates, table row,
// values) and the launch.
//
// Design: one warp owns a row b and 32 of its options (a lane each;
// ceil(A / 32) warps a row, two warps a block, so that the rents batch
// gives the card 256 blocks). Round 1: every lane loads the row's slot and
// its option's coordinates, read through their strides as the caller's
// broadcast views give them (stride 0 on a broadcast axis: nothing is
// materialised), and folds them into its table row. For C <= 8 (a
// template parameter, so every load of a round issues before any of the
// next): round 2, lanes c < C load the slot's n, sz and szz of group c
// while the warp loads its 32 rows' C table words flat over (option,
// group), 32 neighbouring words a load (a lane a row would touch 32 rows
// a load); round 3, the values the same way, neighbouring where the
// table's entries run on (the rents table's row r holds r C .. r C + C -
// 1), staged in shared memory by option; then the statistics go round
// the warp by shuffle, so no option reloads them. Larger C takes a plain
// loop, each lane its own option's groups, the statistics broadcast over
// the warp: staging rounds of 8 groups was slower at 256 rows and faster
// at 4,096 (PERF.md §6, scripts/k5_probe.py). Every gather clamps into range as the
// JAX package's gathers clamp. The three sums run in order c = 0..C-1
// from 0 in every lane and launch, so two launches give the same bits;
// the plain version's reductions may run in another order, and the result
// subtracts sums of order n * z^2, so the two agree to 2^-20 of |coef| *
// (|sum szz| + 2 |sum mu sz| + |sum mu^2 n|) plus 1e-5, not bit for bit.

#include "common.cuh"

namespace {

constexpr int kMaxAxes = 4;      // env coordinates the kernel folds
constexpr int kRank = 4;         // the output's axes: B and up to 3 more
constexpr int kMaxFixedC = 8;    // C a template parameter up to here
constexpr int kMaxThreads = 256;

struct Coord {
  const void* p;
  int64_t stride[kRank];  // element strides over the output's axes
  int64_t n;              // the key table axis: clamp bound ...
  int64_t row;            // ... and row-major stride
  int is64;
};

struct Args {
  Coord coord[kMaxAxes];
  int naxes;
  int32_t dim[kRank];     // dim[0] = B; dim[1..3] the option axes, padded
                          // with 1 in front
  int32_t A, chunks;      // options a row, warps a row
  const float* values;
  int64_t I;
  const int32_t* tbl;
  int C;
  const void* slot;
  int slot64;
  const float* n;
  const float* sz;
  const float* szz;
  const float* pre0;
  int64_t cap;
  float coef;
  float* out;
};

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x >= hi ? hi - 1 : x);
}

__device__ __forceinline__ int64_t load_int(const void* p, int64_t i,
                                            int is64) {
  return is64 ? (int64_t)__ldg(reinterpret_cast<const long long*>(p) + i)
              : (int64_t)__ldg(reinterpret_cast<const int32_t*>(p) + i);
}

template <int kC>
__global__ void __launch_bounds__(kMaxThreads)
gauss_ext_term_kernel(const Args p) {
  // a warp's stage: 32 table rows, and for C <= 8 the values of its 32
  // options x C groups, rows padded to an odd kP floats so that lane l's
  // reads of option l fall in distinct banks
  constexpr int kP = kC | 1;
  extern __shared__ int64_t smem[];   // 32 rows and 32 x kP floats a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t* s_row = smem + warp * 32;
  float* stage = reinterpret_cast<float*>(smem + (blockDim.x >> 5) * 32) +
                 warp * 32 * kP;
  const int32_t w = (int32_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (w >= p.dim[0] * p.chunks) return;  // whole warps only
  const int32_t b = w / p.chunks;
  const int32_t a = (w - b * p.chunks) * 32 + lane;
  const bool live = a < p.A;
  // an idle lane (past the row's last option) follows option A - 1, so
  // that every lane takes part in the loads and shuffles; it stores
  // nothing
  const int32_t ac = live ? a : p.A - 1;
  const int32_t i3 = ac % p.dim[3], r3 = ac / p.dim[3];
  const int32_t i2 = r3 % p.dim[2], i1 = r3 / p.dim[2];

  // round 1: the slot and the coordinates
  const int64_t s_raw = load_int(p.slot, b, p.slot64);
  int64_t e[kMaxAxes];
#pragma unroll
  for (int k = 0; k < kMaxAxes; ++k) {
    e[k] = 0;
    if (k < p.naxes) {
      const Coord& c = p.coord[k];
      e[k] = load_int(c.p,
                      b * c.stride[0] + i1 * c.stride[1] + i2 * c.stride[2] +
                          i3 * c.stride[3],
                      c.is64);
    }
  }
  int64_t row = 0;
#pragma unroll
  for (int k = 0; k < kMaxAxes; ++k)
    if (k < p.naxes) row += clamp64(e[k], p.coord[k].n) * p.coord[k].row;
  const int64_t s = clamp64(s_raw, p.cap);
  const float pre = __ldg(p.pre0 + s);

  float a_szz = 0.0f, a_sz = 0.0f, a_n = 0.0f;
  if constexpr (kC > 0) {
    s_row[lane] = row;
    __syncwarp();
    // round 2: the slot's statistics, group `lane` in lane `lane`, and the
    // table words flat over (option, group): load i of a lane takes word
    // f = 32 i + lane, group f % C of option f / C, so neighbouring lanes
    // read neighbouring words of a row instead of 32 rows a load
    float st_n = 0.0f, st_sz = 0.0f, st_szz = 0.0f;
    if (lane < kC) {
      st_n = __ldg(p.n + s * kC + lane);
      st_sz = __ldg(p.sz + s * kC + lane);
      st_szz = __ldg(p.szz + s * kC + lane);
    }
    int32_t t[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int f = i * 32 + lane, r = f / kC;
      t[i] = __ldg(p.tbl + s_row[r] * kC + (f - r * kC));
    }
    // round 3: the values (neighbouring where the table's entries run
    // on, as the rents table's do), staged by option
    float v[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i)
      v[i] = __ldg(p.values + clamp64(t[i], p.I));
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int f = i * 32 + lane, r = f / kC;
      stage[r * kP + f - r * kC] = v[i];
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float mu = stage[lane * kP + c];
      const float nc = __shfl_sync(0xffffffffu, st_n, c);
      const float szc = __shfl_sync(0xffffffffu, st_sz, c);
      const float szzc = __shfl_sync(0xffffffffu, st_szz, c);
      a_szz += szzc;
      a_sz += mu * szc;
      a_n += mu * mu * nc;
    }
  } else {
    // each lane its own option's C groups (the statistics broadcast over
    // the warp)
    const int C = p.C;
    const int32_t* trow = p.tbl + row * C;
    const int64_t sr = s * C;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float mu = __ldg(p.values + clamp64(__ldg(trow + c), p.I));
      a_szz += __ldg(p.szz + sr + c);
      a_sz += mu * __ldg(p.sz + sr + c);
      a_n += mu * mu * __ldg(p.n + sr + c);
    }
  }
  if (live)
    p.out[(int64_t)b * p.A + a] = p.coef * (a_szz - 2.0f * a_sz + a_n) + pre;
}

template <int kC>
void launch(const Args& a, int threads, int64_t grid, cudaStream_t stream) {
  const size_t smem =
      kC > 0 ? (size_t)(threads / 32) * (32 * 8 + 32 * (kC | 1) * 4) : 0;
  gauss_ext_term_kernel<kC><<<(unsigned)grid, threads, smem, stream>>>(a);
}

}  // namespace

// The output [dims[0], dims[1], dims[2], dims[3]] f32 (the caller's shape
// padded with 1 after B), contiguous; values [I] f32, tbl [E, C] int32,
// slot [B] int32 (slot64 0) or int64 (1), n, sz, szz [cap, C] f32, pre0
// [cap] f32, on the device and contiguous. Coordinate k is read at
// coord_ptr[k] with its int64 meta[7 k .. 7 k + 6]: is64 (int64 elements,
// else int32), n_k, the row-major stride of its table axis, and its
// element strides over the four output axes (0 on broadcast axes). The
// plan (ops.gauss_ext_term_plan) is launched as given: `threads` threads
// a block (a multiple of 32, at most 256), `grid` blocks covering B *
// ceil(A / 32) warps, the kernel instantiated for C (fixed_c = C) where
// C <= 8, else the generic loop (fixed_c = 0). Returns
// cudaErrorInvalidValue for a plan or shape it does not take, else
// cudaGetLastError() after the launch.
extern "C" int pclean_gauss_ext_term(
    int naxes, const int64_t* coord_ptr, const int64_t* meta,
    const int64_t* dims, const float* values, int64_t I, const int32_t* tbl,
    int64_t E, int C, const void* slot, int slot64, const float* n,
    const float* sz, const float* szz, const float* pre0, int64_t cap,
    float coef, float* out, int threads, int64_t grid, int fixed_c,
    void* stream) {
  if (naxes < 0 || naxes > kMaxAxes || I < 1 || E < 1 || C < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  int64_t A = 1;
  for (int d = 0; d < kRank; ++d) {
    if (dims[d] < 0 || dims[d] > INT32_MAX) return (int)cudaErrorInvalidValue;
    if (d > 0) A *= dims[d];
  }
  if (dims[0] == 0 || A == 0) return (int)cudaGetLastError();
  if (A > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t chunks = (A + 31) / 32;
  if (dims[0] * chunks > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      grid * (threads / 32) < dims[0] * chunks || grid > INT32_MAX ||
      fixed_c != (C <= kMaxFixedC ? C : 0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.naxes = naxes;
  int64_t rows = 1;
  for (int k = 0; k < kMaxAxes; ++k) {
    Coord& c = a.coord[k];
    c.p = nullptr;
    c.is64 = 0;
    c.n = 1;
    c.row = 0;
    for (int d = 0; d < kRank; ++d) c.stride[d] = 0;
    if (k >= naxes) continue;
    const int64_t* m = meta + 7 * k;
    c.p = reinterpret_cast<const void*>(coord_ptr[k]);
    c.is64 = (int)m[0];
    c.n = m[1];
    c.row = m[2];
    for (int d = 0; d < kRank; ++d) c.stride[d] = m[3 + d];
    if (c.n < 1 || c.row < 0) return (int)cudaErrorInvalidValue;
    rows *= c.n;
  }
  if (rows != E) return (int)cudaErrorInvalidValue;
  for (int d = 0; d < kRank; ++d) a.dim[d] = (int32_t)dims[d];
  a.A = (int32_t)A;
  a.chunks = (int32_t)chunks;
  a.values = values;
  a.I = I;
  a.tbl = tbl;
  a.C = C;
  a.slot = slot;
  a.slot64 = slot64;
  a.n = n;
  a.sz = sz;
  a.szz = szz;
  a.pre0 = pre0;
  a.cap = cap;
  a.coef = coef;
  a.out = out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (fixed_c) {
    case 1: launch<1>(a, threads, grid, st); break;
    case 2: launch<2>(a, threads, grid, st); break;
    case 3: launch<3>(a, threads, grid, st); break;
    case 4: launch<4>(a, threads, grid, st); break;
    case 5: launch<5>(a, threads, grid, st); break;
    case 6: launch<6>(a, threads, grid, st); break;
    case 7: launch<7>(a, threads, grid, st); break;
    case 8: launch<8>(a, threads, grid, st); break;
    default: launch<0>(a, threads, grid, st); break;
  }
  return (int)cudaGetLastError();
}
