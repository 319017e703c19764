// K23 py_resample: the Pitman-Yor hyperparameter MH of every latent class
// of one parameter resample, in one launch, a block a class.
//
// Replaces pclean_tpu/engine/gibbs_params.py resample_py (:174-197) with
// its three pitman_yor_score evaluations (:152-171), which XLA fuses into
// the scan body as cumsums, lgammas and sums. For one class, from its
// reference counts and alive bits [cap] (a slot counts where alive and
// refcount > 0) and (s0, d0):
//   n_before[i] = the counts of the counted slots before i, j[i] = the
//   counted slots up to i (1-based), both integer scans, so exact;
//   score(s, d) = sum over counted i of
//       log(max(j d + s, 1e-30)) - log(n_before + s)
//     + [size > 1] ((lgamma(max(size - d, 1e-30)) - lgamma(1 - d))
//                   - (lgamma(n_before + size + s) - lgamma(n_before + 1 + s)))
//   summed in a fixed tree order (the slots padded with zeros to P, the
//   next power of two, then t[i] += t[i + h] for h = P / 2, ..., 1);
//   s_prop ~ Gamma(1, 1) by gamma.cuh (stream 1, the class's element);
//   u0, u1, u2 uniforms in [0, 1) from one Philox block (stream 2);
//   old = score(s0, d0), new = score(s_prop, d0) in one pass;
//   accept s_prop where log u0 < ((new + (-s0)) - old) - (-s_prop);
//   new2 = score(s1, d_prop = u1); accept d_prop where log u2 < new2 - cur;
//   (s1, d1) written to the output leaves (the parameter leaves
//   themselves where the caller resamples in place).
// ops.py_resample_plain repeats every step with torch ops (one rounding a
// step, the same tree), so the two are bit-equal on the card.
//
// Bound on the H100: operations where a class has thousands of counted
// slots (the three scores need five logf a counted slot and six lgammaf
// more a slot of size > 1; kernel_bench.k23_bounds counts their
// instructions), else the launch floor; the bytes are 5 a slot, read
// once.
//
// Design (ops.py_resample_plan): a class spread over a thread-block
// cluster, a slot a thread: one block of T = P threads where P <= 1,024,
// else a cluster of CL <= 16 blocks of at least 256 threads (at most
// 1,024), several slots a thread only past CL x 1,024 slots: up to 16 in
// registers, past that in rounds of 16 (below). A launch's
// clusters are sized for its largest class; a class of P slots takes W =
// min(P, CL) of its cluster's blocks, and the others still join every
// cluster barrier. Block b holds slots b + W u, the block index in the
// low bits of the slot index, so that the tree's levels across blocks are
// its last ones, on one value a block; thread t holds the slots of rows u
// = t + Tk m (m < S), in registers from the loads to the sums, never in
// device memory:
//   * the draws (s_prop by gamma.cuh on thread 0; u0, u1, u2 and
//     lgammaf(1 - u1) on the last warp's lane 0) while the loads are in
//     flight, broadcast through shared memory;
//   * the scans: thread t reads its rows' W slots (row u: slots W u to
//     W u + W - 1), so every block scans the rows' totals by itself
//     (warp shuffles, one warp over the warps' totals) and a slot's count
//     before it is the rows before its row plus the blocks before b in
//     its row: no block waits for another's scan;
//   * the three scores in one pass: score 3 is taken at both strengths
//     move 1 may leave, s0 and s_prop, so it needs no broadcast of move
//     1's outcome and shares every lgamma of scores 1 and 2 but
//     lgammaf(max(sz - u1, 1e-30)): four sums, each the plain version's
//     operations on the plain version's operands;
//   * the sums in tree_sum_plain's order, four floats a level: the levels
//     over m in registers, the levels over t inside the block (shared
//     memory, then __shfl_down_sync in the last five), then, after one
//     cluster barrier, the W column sums folded by one warp of block 0
//     from distributed shared memory;
//   * block 0's thread 0 makes both accepts, move 2's score at the
//     strength move 1 left.
// A class of more than 16 slots a thread (more than 262,144 slots; no
// workload has one) takes them in rounds of 16, its S slots a thread
// split as m = r + R g (R = S / 16 rounds r of 16 slots g): a first pass
// over the rows in order keeps each slot row's count base in shared
// memory (12 bytes a row of the thread's, so at most K23_MAX_ROUNDS); the
// second takes the rounds r in bit-reversed order, each scanned and
// scored as above and its 16 slots summed in registers, and folds the
// rounds' sums on a stack a level at a time: in bit-reversed order
// tree_sum_plain's levels over r pair neighbours, so the stack adds them
// in its order.
// So the kernel is bit-equal to the plain version. The classes'
// descriptors are passed by value, up to K23_MAX_CLASSES a launch.

#include <cooperative_groups.h>

#include "gamma.cuh"

namespace cg = cooperative_groups;

#define K23_HEAD 4
#define K23_CLASS 12
#define K23_MAX_CLASSES 64
#define K23_WORDS (K23_HEAD + K23_CLASS * K23_MAX_CLASSES)
#define K23_MAX_THREADS 1024
#define K23_MAX_CLUSTER 16
#define K23_MAX_SLOTS 16
#define K23_MAX_ROUNDS 8192
#define K23_LONG_SMEM (K23_MAX_ROUNDS * 12)

namespace {

struct K23Plan {
  int64_t w[K23_WORDS];
};

enum { hN = 0, hSeed, hThreads, hCluster };
enum { cRc = 0, cAlive, cCap, cPow2, cS0, cD0, cS1, cD1, cElem };

struct Shared {
  long long wn[K23_MAX_SLOTS][32];   // warps' row totals, then prefixes
  int wk[K23_MAX_SLOTS][32];
  float4 x[2][K23_MAX_THREADS];      // the sums' levels inside the block
  float4 col;                        // this block's column sum
  float draw[5];                     // s_prop, u0, u1, u2, lgammaf(1 - u1)
};

__device__ __forceinline__ float clamp30(float x) {
  return x < 1e-30f ? 1e-30f : x;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 shfl_down4(float4 v, int h) {
  return make_float4(__shfl_down_sync(0xffffffffu, v.x, h),
                     __shfl_down_sync(0xffffffffu, v.y, h),
                     __shfl_down_sync(0xffffffffu, v.z, h),
                     __shfl_down_sync(0xffffffffu, v.w, h));
}

// The block's tree over its first n threads' v (n a power of two <= the
// block), tree_sum_plain's order (thread t + h into thread t, h = n / 2
// down to 1): thread 0 returns it. Every thread of the block calls it.
__device__ __forceinline__ float4 block_tree(float4 v, int n, Shared& sh) {
  const int tid = threadIdx.x;
  int buf = 0;
  for (int h = n / 2; h >= 32; h >>= 1) {   // through shared memory
    sh.x[buf][tid] = v;
    __syncthreads();
    if (tid < h) v = add4(v, sh.x[buf][tid + h]);
    buf ^= 1;
  }
  for (int h = (n < 32 ? n : 32) / 2; h >= 1; h >>= 1)   // a warp
    v = add4(v, shfl_down4(v, h));
  return v;
}

// One slot's terms of the three scores in one pass: x score(s0, d0), y
// score(sp, d0), z score(s0, dp) and w score(sp, dp), the third score at
// either strength move 1 may leave (lg0 = lgammaf(1 - d0), lgp =
// lgammaf(1 - dp)). term() of the port's first kernel, every operation
// and operand as there, the subterms the scores share computed once:
// logf(nb + s) and the lgamma pair at s for both d, lgammaf(max(sz - d,
// 1e-30)) for both s.
__device__ __forceinline__ float4 terms(float nb, float jf, float sz, float s0,
                                        float sp, float d0, float dp,
                                        float lg0, float lgp) {
  if (!(sz > 0.0f)) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float j0 = __fmul_rn(jf, d0), jp = __fmul_rn(jf, dp);
  const float l0 = logf(__fadd_rn(nb, s0)), lp = logf(__fadd_rn(nb, sp));
  const float ta = __fsub_rn(logf(clamp30(__fadd_rn(j0, s0))), l0);
  const float tb = __fsub_rn(logf(clamp30(__fadd_rn(j0, sp))), lp);
  const float tc = __fsub_rn(logf(clamp30(__fadd_rn(jp, s0))), l0);
  const float td = __fsub_rn(logf(clamp30(__fadd_rn(jp, sp))), lp);
  float ia = 0.0f, ib = 0.0f, ic = 0.0f, id = 0.0f;
  if (sz > 1.0f) {
    const float a0 = __fsub_rn(lgammaf(clamp30(__fsub_rn(sz, d0))), lg0);
    const float ap = __fsub_rn(lgammaf(clamp30(__fsub_rn(sz, dp))), lgp);
    const float n1 = __fadd_rn(nb, 1.0f), ns = __fadd_rn(nb, sz);
    const float g0 = __fsub_rn(lgammaf(__fadd_rn(ns, s0)),
                               lgammaf(__fadd_rn(n1, s0)));
    const float gp = __fsub_rn(lgammaf(__fadd_rn(ns, sp)),
                               lgammaf(__fadd_rn(n1, sp)));
    ia = __fsub_rn(a0, g0);
    ib = __fsub_rn(a0, gp);
    ic = __fsub_rn(ap, g0);
    id = __fsub_rn(ap, gp);
  }
  return make_float4(__fadd_rn(ta, ia), __fadd_rn(tb, ib), __fadd_rn(tc, ic),
                     __fadd_rn(td, id));
}

// The class's draws into sh.draw: s_prop by thread 0, the uniforms and
// lgammaf(1 - d_prop) by lane 0 of the last warp.
__device__ __forceinline__ void draws(const int64_t* h, const int64_t* c,
                                      int nw, Shared& sh) {
  const uint64_t seed =
      (uint64_t)reinterpret_cast<const int64_t*>(h[hSeed])[0];
  if (threadIdx.x == 0)
    sh.draw[0] = pclean_gamma::draw_gamma(1.0f, seed, c[cElem], 1);
  if (threadIdx.x == ((nw - 1) << 5)) {
    const pclean_gamma::Block u = pclean_gamma::draw(seed, c[cElem], 0, 2);
    sh.draw[1] = pclean_gamma::unit(u.x);
    sh.draw[2] = pclean_gamma::unit(u.y);
    sh.draw[3] = pclean_gamma::unit(u.z);
    sh.draw[4] = lgammaf(__fsub_rn(1.0f, sh.draw[2]));
  }
}

// One row's counts (its W slots from `row`, block b's slot among them):
// the row's counted slots' sizes and number (rn, rk), those of the slots
// before b (bn, bk), and b's own size (sz); zeros where `in` is false.
__device__ __forceinline__ void load_row(const int32_t* rc,
                                         const uint8_t* alive, int64_t cap,
                                         int W, int b, int64_t row, bool in,
                                         long long& rn, int& rk,
                                         long long& bn, int& bk, int& sz) {
  int r[K23_MAX_CLUSTER];
  uint8_t a[K23_MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < K23_MAX_CLUSTER; ++q) {
    const bool on = in && q < W && row + q < cap;
    r[q] = on ? rc[row + q] : 0;
    a[q] = on ? alive[row + q] : 0;
  }
  rn = bn = 0;
  rk = bk = sz = 0;
#pragma unroll
  for (int q = 0; q < K23_MAX_CLUSTER; ++q) {
    const bool on = a[q] && r[q] > 0;
    const int n = on ? r[q] : 0;
    rn += n;
    rk += on;
    if (q < b) {
      bn += n;
      bk += on;
    }
    if (q == b) sz = n;
  }
}

// The thread's sum of a class of S > kS slots a thread, in rounds of kS
// (the header's last paragraph): slot row u = t + Tk m, m = r + R g.
// Every thread of the block calls it; thread t returns its sum in
// tree_sum_plain's order over its m.
template <int kS>
__device__ __noinline__ float4 long_sum(
    const int32_t* rc, const uint8_t* alive, int64_t cap, int W, int b,
    int Tk, int S, bool mine, int nw, float s0, float sp, float d0, float dp,
    float lg0, float lgp, Shared& sh) {
  extern __shared__ long long k23_bases[];   // K23_LONG_SMEM bytes
  long long* base_n = k23_bases;
  int* base_k = reinterpret_cast<int*>(base_n + K23_MAX_ROUNDS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // pass 1: the rows' counts before each round m, in order
  long long run_n = 0;
  int run_k = 0;
  for (int m0 = 0; m0 < S; m0 += kS) {
#pragma unroll
    for (int g = 0; g < kS; ++g) {
      long long rn, bn;
      int rk, bk, sz;
      const int64_t u = tid + (int64_t)Tk * (m0 + g);
      load_row(rc, alive, cap, W, b, (int64_t)W * u, mine, rn, rk, bn, bk,
               sz);
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) {
        rn += __shfl_xor_sync(0xffffffffu, rn, o);
        rk += __shfl_xor_sync(0xffffffffu, rk, o);
      }
      if (lane == 0) {
        sh.wn[g][warp] = rn;
        sh.wk[g][warp] = rk;
      }
    }
    __syncthreads();
    if (warp == 0) {
      for (int g = 0; g < kS; ++g) {
        long long x = lane < nw ? sh.wn[g][lane] : 0;
        int y = lane < nw ? sh.wk[g][lane] : 0;
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1) {
          x += __shfl_xor_sync(0xffffffffu, x, o);
          y += __shfl_xor_sync(0xffffffffu, y, o);
        }
        if (lane == 0) {
          base_n[m0 + g] = run_n;
          base_k[m0 + g] = run_k;
        }
        run_n += x;
        run_k += y;
      }
    }
    __syncthreads();
  }
  // pass 2: the rounds r in bit-reversed order, each round's kS slots
  // scanned, scored and summed, then folded on the stack
  const int R = S / kS;
  const int lr = 31 - __clz(R);
  float4 stk[10];   // log2(K23_MAX_ROUNDS / 16) + 1 levels
  for (int j = 0; j < R; ++j) {
    const int r = (int)(__brev((unsigned)j) >> (32 - lr));
    long long rn[kS], bn[kS];
    int rk[kS], bk[kS], sz[kS];
#pragma unroll
    for (int g = 0; g < kS; ++g)
      load_row(rc, alive, cap, W, b,
               (int64_t)W * (tid + (int64_t)Tk * (r + R * g)), mine, rn[g],
               rk[g], bn[g], bk[g], sz[g]);
#pragma unroll
    for (int g = 0; g < kS; ++g) {
      long long x = rn[g];
      int y = rk[g];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long xo = __shfl_up_sync(0xffffffffu, x, o);
        const int yo = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= o) {
          x += xo;
          y += yo;
        }
      }
      rn[g] = x - rn[g];
      rk[g] = y - rk[g];
      if (lane == 31) {
        sh.wn[g][warp] = x;
        sh.wk[g][warp] = y;
      }
    }
    __syncthreads();
    if (warp == 0) {   // each round's warps' prefixes on its base
      for (int g = 0; g < kS; ++g) {
        const long long x0 = lane < nw ? sh.wn[g][lane] : 0;
        const int y0 = lane < nw ? sh.wk[g][lane] : 0;
        long long x = x0;
        int y = y0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const long long xo = __shfl_up_sync(0xffffffffu, x, o);
          const int yo = __shfl_up_sync(0xffffffffu, y, o);
          if (lane >= o) {
            x += xo;
            y += yo;
          }
        }
        if (lane < nw) {
          sh.wn[g][lane] = base_n[r + R * g] + x - x0;
          sh.wk[g][lane] = base_k[r + R * g] + y - y0;
        }
      }
    }
    __syncthreads();
    float4 v[kS];
#pragma unroll
    for (int g = 0; g < kS; ++g) {
      const long long nb = sh.wn[g][warp] + rn[g] + bn[g];
      const int jn = sh.wk[g][warp] + rk[g] + bk[g] + (sz[g] > 0);
      v[g] = mine ? terms((float)nb, (float)jn, (float)sz[g], s0, sp, d0, dp,
                          lg0, lgp)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int w = kS / 2; w >= 1; w >>= 1)
#pragma unroll
      for (int g = 0; g < w; ++g) v[g] = add4(v[g], v[g + w]);
    // the stack: round j's sum, then each finished pair of neighbours
    float4 val = v[0];
    int lvl = 0;
    for (unsigned jj = (unsigned)j; jj & 1u; jj >>= 1, ++lvl)
      val = add4(stk[lvl], val);
    stk[lvl] = val;
    __syncthreads();   // sh.wn is the next round's
  }
  return stk[lr];
}

template <int kS, bool kLong>
__global__ void __launch_bounds__(K23_MAX_THREADS)
    py_resample_kernel(const __grid_constant__ K23Plan plan) {
  __shared__ Shared sh;
  cg::cluster_group cl = cg::this_cluster();
  const int64_t* h = plan.w;
  const int T = (int)h[hThreads], CL = (int)h[hCluster];
  const int b = (int)(blockIdx.x % CL), tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = (T + 31) >> 5;
  const int64_t* c = h + K23_HEAD + K23_CLASS * (blockIdx.x / CL);
  const int32_t* rc = reinterpret_cast<const int32_t*>(c[cRc]);
  const uint8_t* alive = reinterpret_cast<const uint8_t*>(c[cAlive]);
  const int64_t cap = c[cCap], P = c[cPow2];
  // the class's layout: W blocks hold slots, block b the slots b + W u;
  // row u (its W slots) is thread t's for u = t + Tk m, m < S
  const int W = (int)(P < CL ? P : CL);
  const int64_t U = P / W;
  const int Tk = (int)(U < T ? U : T);
  const int S = (int)(U / Tk);
  const bool mine = b < W && tid < Tk;
  const float s0 = *reinterpret_cast<const float*>(c[cS0]);
  const float d0 = *reinterpret_cast<const float*>(c[cD0]);
  float4 acc;
  if (kLong && S > kS) {   // a class of more than kS slots a thread
    draws(h, c, nw, sh);
    const float lg0 = lgammaf(__fsub_rn(1.0f, d0));
    __syncthreads();
    acc = long_sum<kS>(rc, alive, cap, W, b, Tk, S, mine, nw, s0,
                       sh.draw[0], d0, sh.draw[2], lg0, sh.draw[4], sh);
  } else {
    // every load first: each row's W slots, the parameters, the seed
    long long rn[kS], bn[kS];
    int rk[kS], bk[kS], sz[kS];
#pragma unroll
    for (int m = 0; m < kS; ++m) {
      const int64_t row = (int64_t)W * (tid + (int64_t)Tk * m);
      rn[m] = bn[m] = 0;
      rk[m] = bk[m] = sz[m] = 0;
      if (W == 1) {   // a block a class: the row is the slot
        const bool in = m < S && mine && row < cap;
        const int r = in ? rc[row] : 0;
        const bool on = in && alive[row] && r > 0;
        rn[m] = sz[m] = on ? r : 0;
        rk[m] = on;
        continue;
      }
      int r[K23_MAX_CLUSTER];
      uint8_t a[K23_MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < K23_MAX_CLUSTER; ++q) {
        const bool in = m < S && mine && q < W && row + q < cap;
        r[q] = in ? rc[row + q] : 0;
        a[q] = in ? alive[row + q] : 0;
      }
#pragma unroll
      for (int q = 0; q < K23_MAX_CLUSTER; ++q) {
        const bool on = a[q] && r[q] > 0;
        const int n = on ? r[q] : 0;
        rn[m] += n;
        rk[m] += on;
        if (q < b) {
          bn[m] += n;
          bk[m] += on;
        }
        if (q == b) sz[m] = n;
      }
    }
    // the draws, while the loads are in flight
    draws(h, c, nw, sh);
    const float lg0 = lgammaf(__fsub_rn(1.0f, d0));

    // the scan over the rows, in every block alike: a warp-shuffle scan of
    // each round m of rows, the warps' totals scanned by one warp, the
    // rounds in order; integer sums, so exact
#pragma unroll
    for (int m = 0; m < kS; ++m) {
      long long x = rn[m];
      int y = rk[m];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long xo = __shfl_up_sync(0xffffffffu, x, o);
        const int yo = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= o) {
          x += xo;
          y += yo;
        }
      }
      rn[m] = x - rn[m];   // the rows of this round before row u in its warp
      rk[m] = y - rk[m];
      if (lane == 31) {
        sh.wn[m][warp] = x;
        sh.wk[m][warp] = y;
      }
    }
    __syncthreads();
    if (warp == 0) {   // each round's warps' prefixes, then the rounds'
      long long base_n = 0;
      int base_k = 0;
      for (int m = 0; m < S; ++m) {
        const long long x0 = lane < nw ? sh.wn[m][lane] : 0;
        const int y0 = lane < nw ? sh.wk[m][lane] : 0;
        long long x = x0;
        int y = y0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const long long xo = __shfl_up_sync(0xffffffffu, x, o);
          const int yo = __shfl_up_sync(0xffffffffu, y, o);
          if (lane >= o) {
            x += xo;
            y += yo;
          }
        }
        if (lane < nw) {
          sh.wn[m][lane] = base_n + x - x0;
          sh.wk[m][lane] = base_k + y - y0;
        }
        base_n += __shfl_sync(0xffffffffu, x, 31);
        base_k += __shfl_sync(0xffffffffu, y, 31);
      }
    }
    __syncthreads();
    const float sp = sh.draw[0], dp = sh.draw[2], lgp = sh.draw[4];

    // the three scores of this thread's slots in one pass
    float4 v[kS];
#pragma unroll
    for (int m = 0; m < kS; ++m) {
      const int mm = m < S ? m : 0;
      // before the slot: the earlier rows, then the blocks before b in
      // its row
      const long long nb = sh.wn[mm][warp] + rn[m] + bn[m];
      const int jn = sh.wk[mm][warp] + rk[m] + bk[m] + (sz[m] > 0);
      v[m] = m < S && mine
                 ? terms((float)nb, (float)jn, (float)sz[m], s0, sp, d0, dp,
                         lg0, lgp)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    // the sums in tree_sum_plain's order: slot b + W (t + Tk m) pairs with
    // the slot h further on: the levels h >= W Tk in registers (m), then W
    // <= h < W Tk inside the block (t), then h < W across blocks (b)
#pragma unroll
    for (int w = kS / 2; w >= 1; w >>= 1)
#pragma unroll
      for (int m = 0; m < w; ++m)
        if (w < S) v[m] = add4(v[m], v[m + w]);
    acc = v[0];
  }
  const float sp = sh.draw[0], u0 = sh.draw[1], dp = sh.draw[2],
              u2 = sh.draw[3];
  const float4 col = block_tree(acc, Tk, sh);
  float4 tot = col;
  if (CL > 1) {
    if (tid == 0) sh.col = col;
    cl.sync();   // every block's column sum is readable
    if (b == 0 && warp == 0) {
      tot = lane < W ? *cl.map_shared_rank(&sh.col, (unsigned)lane)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int hh = W / 2; hh >= 1; hh >>= 1)
        tot = add4(tot, shfl_down4(tot, hh));
    }
  }
  if (b == 0 && tid == 0) {
    // move 1: s_prop at d0 against s0; move 2: d_prop at the strength
    // move 1 left (score 3 at s0 or at s_prop)
    const float old = tot.x, nw2 = tot.y;
    const float alpha = __fsub_rn(__fsub_rn(__fadd_rn(nw2, -s0), old), -sp);
    const bool acc = logf(u0) < alpha;
    const float s1 = acc ? sp : s0, cur = acc ? nw2 : old;
    const float new2 = acc ? tot.w : tot.z;
    const bool acc2 = logf(u2) < __fsub_rn(new2, cur);
    *reinterpret_cast<float*>(c[cS1]) = s1;
    *reinterpret_cast<float*>(c[cD1]) = acc2 ? dp : d0;
  }
  if (CL > 1) cl.sync();   // no block leaves while block 0 reads its sum
}

template <int kS, bool kLong>
cudaError_t launch(const K23Plan& plan, int64_t classes, int T, int CL,
                   cudaStream_t st) {
  static bool ready = false;
  if (!ready && (CL > 8 || kLong)) {
    cudaError_t e = cudaSuccess;
    if (kLong)   // the rounds' bases (long_sum)
      e = cudaFuncSetAttribute(py_resample_kernel<kS, kLong>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               K23_LONG_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(py_resample_kernel<kS, kLong>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const size_t smem = kLong ? K23_LONG_SMEM : 0;
  if (CL == 1) {
    py_resample_kernel<kS, kLong><<<(unsigned)classes, T, smem, st>>>(plan);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(classes * CL), 1, 1);
  cfg.blockDim = dim3((unsigned)T, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, py_resample_kernel<kS, kLong>, plan);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// words: the plan (ops.py_resample's words, sized by ops.py_resample_plan):
// [classes, seed (int64 [1] on the card), threads a block T (a power of
// two, 32-1,024), cluster size (1-16)], then each class [refcount (int32
// [cap]), alive (bool [cap]), cap, P, strength in, discount in, strength
// out, discount out (float32 scalars; out may be in), the class's element
// of the stream, 0, 0, 0]. Each class's P / min(P, cluster x T) slots a
// thread must be at most K23_MAX_ROUNDS. Returns cudaErrorInvalidValue for
// a plan it does not take, else the launch's error or cudaGetLastError()
// after it.
extern "C" int pclean_py_resample(const int64_t* words, int n_words,
                                  void* stream) {
  if (n_words < K23_HEAD || n_words > K23_WORDS || words[hN] < 0 ||
      words[hN] > K23_MAX_CLASSES ||
      n_words < K23_HEAD + K23_CLASS * words[hN] || words[hSeed] == 0)
    return (int)cudaErrorInvalidValue;
  const int64_t T = words[hThreads], CL = words[hCluster];
  if (T < 32 || T > K23_MAX_THREADS || (T & (T - 1)) != 0 || CL < 1 ||
      CL > K23_MAX_CLUSTER || (CL & (CL - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  int64_t S = 1;
  for (int k = 0; k < words[hN]; ++k) {
    const int64_t* c = words + K23_HEAD + K23_CLASS * k;
    const int64_t P = c[cPow2];
    if (c[cRc] == 0 || c[cAlive] == 0 || c[cCap] < 1 || P < c[cCap] ||
        (P & (P - 1)) != 0 || c[cS0] == 0 || c[cD0] == 0 || c[cS1] == 0 ||
        c[cD1] == 0)
      return (int)cudaErrorInvalidValue;
    const int64_t G = P < CL * T ? P : CL * T;
    if (P / G > S) S = P / G;
  }
  if (S > K23_MAX_ROUNDS) return (int)cudaErrorInvalidValue;
  K23Plan plan;
  for (int i = 0; i < K23_WORDS; ++i) plan.w[i] = i < n_words ? words[i] : 0;
  if (words[hN] == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t n = words[hN];
  cudaError_t e;
  switch (S) {
    case 1: e = launch<1, false>(plan, n, (int)T, (int)CL, st); break;
    case 2: e = launch<2, false>(plan, n, (int)T, (int)CL, st); break;
    case 4: e = launch<4, false>(plan, n, (int)T, (int)CL, st); break;
    case 8: e = launch<8, false>(plan, n, (int)T, (int)CL, st); break;
    case 16: e = launch<16, false>(plan, n, (int)T, (int)CL, st); break;
    default: e = launch<16, true>(plan, n, (int)T, (int)CL, st); break;
  }
  return (int)e;
}
