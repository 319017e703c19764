// Typed loads and stores through the 64-bit words of a K10 / K11 plan.
//
// A plan is an array of int64 words passed by value as one kernel
// argument (a struct of up to 32 KB on Hopper with CUDA >= 12.1): device
// pointers, lengths and dtype codes side by side, so no table lives in
// device memory and no host-to-device copy precedes a launch. The dtype
// codes are ops._DT's.
#pragma once

#include <stdint.h>

#define PCLEAN_DT_BOOL 0
#define PCLEAN_DT_I8 1
#define PCLEAN_DT_U8 2
#define PCLEAN_DT_I16 3
#define PCLEAN_DT_I32 4
#define PCLEAN_DT_I64 5
#define PCLEAN_DT_F32 6
#define PCLEAN_DT_F64 7

__device__ __forceinline__ bool pclean_dt_float(int64_t dt) {
  return dt == PCLEAN_DT_F32 || dt == PCLEAN_DT_F64;
}

// Bytes of one element of dtype dt.
__device__ __forceinline__ int pclean_dt_size(int64_t dt) {
  return dt <= PCLEAN_DT_U8 ? 1
         : dt == PCLEAN_DT_I16 ? 2
         : (dt == PCLEAN_DT_I32 || dt == PCLEAN_DT_F32) ? 4 : 8;
}

// p[i] as an integer (a float truncates toward zero, as torch's .to does).
__device__ __forceinline__ int64_t pclean_ld_i(int64_t p, int64_t dt,
                                               int64_t i) {
  switch (dt) {
    case PCLEAN_DT_BOOL:
    case PCLEAN_DT_U8:
      return reinterpret_cast<const uint8_t*>(p)[i];
    case PCLEAN_DT_I8:
      return reinterpret_cast<const int8_t*>(p)[i];
    case PCLEAN_DT_I16:
      return reinterpret_cast<const int16_t*>(p)[i];
    case PCLEAN_DT_I32:
      return reinterpret_cast<const int32_t*>(p)[i];
    case PCLEAN_DT_I64:
      return reinterpret_cast<const int64_t*>(p)[i];
    case PCLEAN_DT_F32:
      return (int64_t)reinterpret_cast<const float*>(p)[i];
    default:
      return (int64_t)reinterpret_cast<const double*>(p)[i];
  }
}

__device__ __forceinline__ double pclean_ld_f(int64_t p, int64_t dt,
                                              int64_t i) {
  if (dt == PCLEAN_DT_F32) return reinterpret_cast<const float*>(p)[i];
  if (dt == PCLEAN_DT_F64) return reinterpret_cast<const double*>(p)[i];
  return (double)pclean_ld_i(p, dt, i);
}

// The bits of p[0], sz bytes of it (1, 2, 4 or 8; 0 loads nothing), in one
// predicated load: no branch on the dtype, so the lanes of a warp issue
// their loads together whatever their dtypes (K11). pclean_bits_i and
// pclean_bits_f decode them as pclean_ld_i and pclean_ld_f decode p[i].
__device__ __forceinline__ uint64_t pclean_ld_bits(int64_t p, int sz) {
  uint32_t v1 = 0, v2 = 0, v4 = 0;
  uint64_t v8 = 0;
  asm volatile(
      "{\n\t"
      ".reg .pred q1, q2, q4, q8;\n\t"
      "setp.eq.s32 q1, %4, 1;\n\t"
      "setp.eq.s32 q2, %4, 2;\n\t"
      "setp.eq.s32 q4, %4, 4;\n\t"
      "setp.eq.s32 q8, %4, 8;\n\t"
      "@q1 ld.global.u8 %0, [%5];\n\t"
      "@q2 ld.global.u16 %1, [%5];\n\t"
      "@q4 ld.global.u32 %2, [%5];\n\t"
      "@q8 ld.global.u64 %3, [%5];\n\t"
      "}"
      : "+r"(v1), "+r"(v2), "+r"(v4), "+l"(v8)
      : "r"(sz), "l"(p));
  return sz == 8 ? v8 : sz == 4 ? (uint64_t)v4
                                : (sz == 2 ? (uint64_t)v2 : (uint64_t)v1);
}

// pclean_ld_bits' element of dtype dt as an integer (pclean_ld_i's
// result: a float truncates toward zero).
__device__ __forceinline__ int64_t pclean_bits_i(uint64_t v, int64_t dt) {
  switch (dt) {
    case PCLEAN_DT_I8:
      return (int8_t)v;
    case PCLEAN_DT_I16:
      return (int16_t)v;
    case PCLEAN_DT_I32:
      return (int32_t)v;
    case PCLEAN_DT_F32:
      return (int64_t)__int_as_float((int)(uint32_t)v);
    case PCLEAN_DT_F64:
      return (int64_t)__longlong_as_double((long long)v);
    default:   // bool, uint8 (zero-extended), int64
      return (int64_t)v;
  }
}

// ... and as a double (pclean_ld_f's result).
__device__ __forceinline__ double pclean_bits_f(uint64_t v, int64_t dt) {
  if (dt == PCLEAN_DT_F32) return __int_as_float((int)(uint32_t)v);
  if (dt == PCLEAN_DT_F64) return __longlong_as_double((long long)v);
  return (double)pclean_bits_i(v, dt);
}

// p[i] = v for an integer v (narrowed as a C cast; bool keeps v != 0).
__device__ __forceinline__ void pclean_st_i(int64_t p, int64_t dt, int64_t i,
                                            int64_t v) {
  switch (dt) {
    case PCLEAN_DT_BOOL:
      reinterpret_cast<uint8_t*>(p)[i] = v != 0;
      break;
    case PCLEAN_DT_U8:
      reinterpret_cast<uint8_t*>(p)[i] = (uint8_t)v;
      break;
    case PCLEAN_DT_I8:
      reinterpret_cast<int8_t*>(p)[i] = (int8_t)v;
      break;
    case PCLEAN_DT_I16:
      reinterpret_cast<int16_t*>(p)[i] = (int16_t)v;
      break;
    case PCLEAN_DT_I32:
      reinterpret_cast<int32_t*>(p)[i] = (int32_t)v;
      break;
    case PCLEAN_DT_I64:
      reinterpret_cast<int64_t*>(p)[i] = v;
      break;
    case PCLEAN_DT_F32:
      reinterpret_cast<float*>(p)[i] = (float)v;
      break;
    default:
      reinterpret_cast<double*>(p)[i] = (double)v;
  }
}

// take()'s clamp of an index into [0, n).
__device__ __forceinline__ int64_t pclean_clamp(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// The element offset of row b's entry in a record picked at ancestor
// positions (K16, K17): b * row_stride + sum over the nd axes of
// clamp(anc_d[b], size_d) * stride_d, axis d's words at
// axes[4 d .. 4 d + 3] (stride, size, pointer, dtype; ops._rec_words).
__device__ __forceinline__ int64_t pclean_rec_offset(const int64_t* axes,
                                                     int64_t nd,
                                                     int64_t row_stride,
                                                     int64_t b) {
  int64_t off = b * row_stride;
  for (int64_t d = 0; d < nd; ++d) {
    const int64_t* ax = axes + 4 * d;
    off += pclean_clamp(pclean_ld_i(ax[2], ax[3], b), ax[1]) * ax[0];
  }
  return off;
}
