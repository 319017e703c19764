// The port's counter-based random stream and its Gamma(alpha, 1) draw,
// shared by K22 gamma_draw and K23 py_resample, so both draw a gamma by
// the same code (ops.gamma_draw_plain and ops.py_resample_plain repeat it
// in torch ops, bit for bit on the card).
//
// Stream: Philox4x32-10 (Salmon, Moraes, Dror and Shaw, SC'11, with
// Random123's multipliers and key bumps), keyed by one 64-bit seed that
// the caller draws from its torch.Generator into a card buffer, so no
// draw waits for the host and a launch can be captured. The counter is
// (element low, element high, round, stream): each element of a call has
// its own counter, whatever launch or thread draws it.
//
// Gamma(alpha, 1): Marsaglia and Tsang (2000) with the alpha < 1 boost,
// as pclean_tpu_torch's earlier utils.sample_gamma wrote it; replaces
// jax.random.gamma in pclean_tpu/dists/params.py (via jax.random.dirichlet
// and jax.random.beta) and pclean_tpu/engine/gibbs_params.py:188. Round r
// of an element draws one Philox block: a normal x by Box-Muller from its
// first two words, the acceptance uniform from its third, the boost
// uniform from its fourth. The first round that accepts gives d v (times
// u^(1 / alpha) where boosted); the loop is bounded at PCLEAN_GAMMA_ROUNDS
// rounds (each accepts with probability >= 0.95 at a >= 1, so all 16 fail
// with probability below 1e-20), after which the element takes d, the
// last round's boost uniform, so the plain version's bounded vectorised
// loop gives the same value by definition.
//
// Bits: every step rounds once (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn: nothing contracts into a fused multiply-add) and
// logf, cosf and powf are CUDA's libdevice functions, compiled without
// fast math, as torch's CUDA log, cos and pow call them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PCLEAN_GAMMA_ROUNDS 16

namespace pclean_gamma {

struct Block {
  uint32_t x, y, z, w;
};

// Philox4x32-10 of counter c under key (k0, k1).
__device__ __forceinline__ Block philox(Block c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = Block{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

__device__ __forceinline__ Block draw(uint64_t seed, uint64_t elem,
                                      uint32_t round, uint32_t stream) {
  return philox(Block{(uint32_t)elem, (uint32_t)(elem >> 32), round, stream},
                (uint32_t)seed, (uint32_t)(seed >> 32));
}

// A word as a uniform in [0, 1): its top 24 bits times 2^-24 (exact).
__device__ __forceinline__ float unit(uint32_t x) {
  return (float)(x >> 8) * 5.9604644775390625e-08f;
}

// A word as a uniform in (0, 1): 2 (its top 23 bits) + 1 times 2^-24
// (exact), for a log.
__device__ __forceinline__ float open_unit(uint32_t x) {
  return (float)(((x >> 9) << 1) | 1u) * 5.9604644775390625e-08f;
}

// Gamma(alpha, 1) of element `elem` of stream `stream` under `seed`.
__device__ __forceinline__ float draw_gamma(float alpha, uint64_t seed,
                                            uint64_t elem, uint32_t stream) {
  const bool boost = alpha < 1.0f;
  const float a = boost ? __fadd_rn(alpha, 1.0f) : alpha;
  const float d = __fsub_rn(a, 1.0f / 3.0f);
  const float c = __fdiv_rn(1.0f, __fsqrt_rn(__fmul_rn(9.0f, d)));
  float out = d, ub = 0.5f;
  for (uint32_t r = 0; r < PCLEAN_GAMMA_ROUNDS; ++r) {
    const Block b = draw(seed, elem, r, stream);
    ub = open_unit(b.w);
    const float rad = __fsqrt_rn(__fmul_rn(-2.0f, logf(open_unit(b.x))));
    const float x =
        __fmul_rn(rad, cosf(__fmul_rn(6.28318530717958647692f, unit(b.y))));
    const float t = __fadd_rn(1.0f, __fmul_rn(c, x));
    const float v = __fmul_rn(__fmul_rn(t, t), t);
    if (!(v > 0.0f)) continue;
    const float rhs = __fadd_rn(
        __fsub_rn(__fadd_rn(__fmul_rn(__fmul_rn(0.5f, x), x), d),
                  __fmul_rn(d, v)),
        __fmul_rn(d, logf(v)));
    if (logf(open_unit(b.z)) < rhs) {
      out = __fmul_rn(d, v);
      break;
    }
  }
  if (boost) out = __fmul_rn(out, powf(ub, __fdiv_rn(1.0f, alpha)));
  return out;
}

}  // namespace pclean_gamma
