// The quantized KV-cache kinds' values, widened exactly (shared by B3's
// producers and B7). fp8 is e4m3 (the JAX package's float8_e4m3fn); int4
// is packed two per byte along d, element 2i in the low nibble and 2i + 1
// in the high one, two's complement (ops/kv_cache.py pack_int4).
#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

// two e4m3 values (the low byte first) -> float2, by sm_89+'s conversion
// to f16x2: every e4m3 value (3 mantissa bits, exponents -9..8 with the
// subnormals) is an f16 value, so both steps are exact; the quantizer
// leaves no NaN
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t x) {
  uint32_t h;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h) : "h"((unsigned short)x));
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

// eight int4 values (the nibbles of w, element 0 lowest) -> eight s8
// bytes: elements 0-3 in lo, 4-7 in hi. The nibbles are spread to bytes
// (lo nibbles of bytes 0-3 are elements 0, 2, 4, 6; hi nibbles 1, 3, 5, 7)
// and sign-extended byte-wise: (n ^ 8) - 8 mod 256
__device__ __forceinline__ void s4x8_to_s8(uint32_t w, uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t l = w & 0x0f0f0f0fu, h = (w >> 4) & 0x0f0f0f0fu;
  lo = __vsub4(__byte_perm(l, h, 0x5140) ^ 0x08080808u, 0x08080808u);
  hi = __vsub4(__byte_perm(l, h, 0x7362) ^ 0x08080808u, 0x08080808u);
}

// four int4 values (the nibbles of the low 16 bits of w) -> four s8 bytes
__device__ __forceinline__ uint32_t s4x4_to_s8(uint32_t w) {
  uint32_t lo, hi;
  s4x8_to_s8(w & 0xffffu, lo, hi);
  return lo;
}
