// The int8 code of one value, clip(rint(v / s), -127, 127), exactly as an
// IEEE division rounded half to even gives it, for the per-row and
// per-group int8 quantizers on their hot paths (K5's q in
// decode_mainloop.cuh, K12n's and K12g's rows in fused_act.cu), for Hopper
// (sm_90a); pack_bytes also packs K4's code tables (int4_w4a8.cu).
//
// __fdiv_rn costs about a dozen instructions a value, and its slow path (a
// zero dividend, as the padded head rows of K5's warps hold) a subroutine
// call. Here v times r = __frcp_rn(s) is within 2^-22 |v / s| of the IEEE
// quotient (two roundings of 2^-24 each against the quotient's one), so the
// two round to the same integer unless v r lies within 2^-20 |v r| of a
// half-integer; there, rarely, the quotient is taken by __fdiv_rn. The
// rounding is clip(y) + 1.5 * 2^23, which rounds half to even as rintf does
// and leaves the integer's two's complement in the low byte of its bits
// (no FRND, no F2I). Needs |v / s| < 2^21, as every quantizer's amax / 127
// scale gives.

#pragma once

#include <math.h>
#include <stdint.h>

namespace {

// The int8 code of v / s in the low byte of the returned word (its other
// bytes are not 0); r = __frcp_rn(s).
__device__ __forceinline__ uint32_t quant_byte(float v, float s, float r) {
  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
  float y = __fmul_rn(v, r);
  const float n = __fsub_rn(__fadd_rn(y, kMagic), kMagic);  // rint(y)
  if (fabsf(fabsf(__fsub_rn(y, n)) - 0.5f) <= __fmul_rn(fabsf(y), 0x1p-20f)) y = __fdiv_rn(v, s);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, -127.f), 127.f), kMagic));
}

// quant_byte for a value of the row or group its scale was taken from: with
// |v| <= amax and s = max(amax, 1e-8) / 127, |v r| < 127 (1 + 2^-21), so no
// clip is needed, y + 1.5 * 2^23 already holds the code, and the margin of
// the half-integer test can be the constant 2^-13 >= |v r| 2^-20: four
// instructions fewer (K12g's rows).
__device__ __forceinline__ uint32_t quant_byte_in_row(float v, float s, float r) {
  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
  const float y = __fmul_rn(v, r);
  const float t = __fadd_rn(y, kMagic);
  if (fabsf(fabsf(__fsub_rn(y, __fsub_rn(t, kMagic))) - 0.5f) <= 0x1p-13f)
    return __float_as_uint(__fadd_rn(__fdiv_rn(v, s), kMagic));
  return __float_as_uint(t);
}

// Four codes, bytes 0-3 of the word from a, b, c, d (quant_byte's words).
__device__ __forceinline__ uint32_t pack_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u), 0x5410u);
}

}  // namespace
