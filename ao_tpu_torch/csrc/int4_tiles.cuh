// Device code shared by the int4 kernels over the magic layouts: K1's and
// K3's decode paths (int4_matmul.cu, int4_w4a8.cu) and the MoE grouped
// kernels K13 (grouped_matmul.cu: its w4a8 form runs K3's arithmetic over
// the rows of one expert at a time).
//
// Both decode paths swap the operands' roles: the weight tile is the A
// operand of an mma.sync (16 columns of N as the rows of an m16 tile) and
// x^T the B operand (the batch rows as the columns of an n8 tile), so at
// M = 8 no half of an m16 tile is spent on rows of x that do not exist. A
// warp owns 32 columns, col = nb + 4*gid .. + 3 for its lane's group gid, in
// two m16 tiles: tile p holds in its rows 0..7 the columns nb + 4*gid + 2p
// and in rows 8..15 the columns nb + 4*gid + 2p + 1, so the thread's
// 16-byte word loads (columns col .. col + 3) are its A fragments. C
// fragment e of tile p is column col + 2p + (e >> 1), batch row
// 2*tig + (e & 1) (+ 8nt).
//
// The layouts are described in the sources that include this header and in
// ao_tpu_torch/quantization/qarrays/int4.py.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kOnes = 0x3F803F80u;   // bf16x2 (1.0, 1.0)
constexpr uint32_t kLoNib = 0x0F0F0F0Fu;  // the low nibble of four bytes
constexpr uint32_t kOnes8 = 0x01010101u;  // four int8 ones

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Plane j of a magic word as bf16x2 (q_low, q_high), q = u - 8, exact.
__device__ __forceinline__ uint32_t plane_q(uint32_t w, int j) {
  uint32_t v = ((w >> (4 * j)) & 0x000F000Fu) | 0x43004300u;  // 128 + u
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hsub2(h, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Plane h (0 = A, 1 = B) of a magic8 word: four int8 values 0..15.
__device__ __forceinline__ uint32_t plane8(uint32_t w, int h) {
  return (h ? (w >> 4) : w) & kLoNib;
}

__device__ __forceinline__ float pair_sum(uint32_t a) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&a);
  return __low2float(h) + __high2float(h);
}

__device__ __forceinline__ uint32_t ld_x2(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t ld_4(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ int4 ld_16(const void* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// b2 in f32 from its bf16 transport, or from the tinygemm zero point:
// bf16(zp + 8s), where 8s is exact, so one fused rounding is the reference's
// f32 add before its bf16 cast.
__device__ __forceinline__ float bias_of(float s, __nv_bfloat16 b, int raw_zp) {
  const float v = __bfloat162float(b);
  return raw_zp ? __bfloat162float(__float2bfloat16_rn(__fmaf_rn(8.f, s, v))) : v;
}

// K1's decode arithmetic (g = 16*KS, NT n8 tiles of batch rows) over the
// runs [r_begin, r_end) of KR k16 steps each (8 KR word rows, all four
// planes; KS / KR runs a super-group) of one (K/8, N) magic word matrix and
// its (K/g, N) s and b2: for each group's part in a run, acc += s * (x_G .
// q_G) on the tensor cores, then acc += sum(x_G) * b2, in f32. At KR = KS
// a run is a super-group (K1 but at small N). x holds M valid
// rows (row r at x + r*K); the rest of the n8 tiles reads zeros. Threads of
// a warp call it together (it shuffles).
template <int KS, int NT, int KR = KS>
__device__ __forceinline__ void magic_gemv_accumulate(
    float (&acc)[2][NT][4], const __nv_bfloat16* __restrict__ x, int M, int K, int N,
    const int32_t* __restrict__ word, const __nv_bfloat16* __restrict__ s,
    const __nv_bfloat16* __restrict__ b2, int r_begin, int r_end, int col, int raw_zp) {
  constexpr int G = 16 * KS, RPS = KS / KR;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  for (int r = r_begin; r < r_end; ++r) {
    const int t = r / RPS, ks0 = r % RPS * KR;
    const int32_t* wbase = word + ((size_t)t * (G / 2) + 8 * ks0) * N + col;
    int4 w[2 * KR];
    uint2 sv[4], bv[4];
#pragma unroll
    for (int ks = 0; ks < KR; ++ks) {
      w[2 * ks] = ld_16(wbase + (size_t)(8 * ks + tig) * N);
      w[2 * ks + 1] = ld_16(wbase + (size_t)(8 * ks + 4 + tig) * N);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t qoff = (size_t)(4 * t + j) * N + col;
      sv[j] = __ldg(reinterpret_cast<const uint2*>(s + qoff));
      bv[j] = __ldg(reinterpret_cast<const uint2*>(b2 + qoff));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float tmp[2][NT][4], xs[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        xs[nt] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[0][nt][e] = tmp[1][nt][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KR; ++ks) {
        const int k0 = (4 * t + j) * G + 16 * (ks0 + ks) + 2 * tig;
        uint32_t b[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int row = gid + 8 * nt;
          b[nt][0] = row < M ? ld_x2(x + (size_t)row * K + k0) : 0u;
          b[nt][1] = row < M ? ld_x2(x + (size_t)row * K + k0 + 8) : 0u;
          xs[nt] += pair_sum(b[nt][0]) + pair_sum(b[nt][1]);
        }
        const int4& w0 = w[2 * ks];
        const int4& w1 = w[2 * ks + 1];
        const uint32_t a0[4] = {plane_q(w0.x, j), plane_q(w0.y, j), plane_q(w1.x, j),
                                plane_q(w1.y, j)};
        const uint32_t a1[4] = {plane_q(w0.z, j), plane_q(w0.w, j), plane_q(w1.z, j),
                                plane_q(w1.w, j)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_16816(tmp[0][nt], a0, b[nt][0], b[nt][1]);
          mma_16816(tmp[1][nt], a1, b[nt][0], b[nt][1]);
        }
      }
      // Fold the group's part. Row sums of x: complete them over the quad, then
      // fetch rows 2*tig and 2*tig + 1 from their quads.
      const __nv_bfloat16* sh = reinterpret_cast<const __nv_bfloat16*>(&sv[j]);
      const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(&bv[j]);
      float sc[4], bc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[e] = __bfloat162float(sh[e]);
        bc[e] = bias_of(sc[e], bh[e], raw_zp);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float v = xs[nt];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const float xr[2] = {__shfl_sync(0xffffffffu, v, 8 * tig),
                             __shfl_sync(0xffffffffu, v, 8 * tig + 4)};
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 2 * p + (e >> 1);
            acc[p][nt][e] = fmaf(xr[e & 1], bc[c], fmaf(sc[c], tmp[p][nt][e], acc[p][nt][e]));
          }
      }
    }
  }
}

// K3's decode arithmetic (g = 32*KS, NT n8 tiles of batch rows) over the
// group pairs [t_begin, t_end) of one (K/8, N) magic8 word matrix and its
// (K/g, N) s and b: for each group G, acc += s * dot_i32(x_G, u_G) + b *
// sum(x_G), in f32 after the exact int32 dots. x holds M valid int8 rows
// (row r at x + r*K); the rest of the n8 tiles reads zeros. The row sums of
// x come from one more mma against an A of ones, in the same places as the
// products.
template <int KS, int NT>
__device__ __forceinline__ void w4a8_gemv_accumulate(
    float (&acc)[2][NT][4], const int8_t* __restrict__ x, int M, int K, int N,
    const int32_t* __restrict__ word, const __nv_bfloat16* __restrict__ s,
    const __nv_bfloat16* __restrict__ b, int t_begin, int t_end, int col) {
  constexpr int G = 32 * KS, WR = G / 4;  // word rows per group pair
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t ones[4] = {kOnes8, kOnes8, kOnes8, kOnes8};
  for (int t = t_begin; t < t_end; ++t) {
    const int32_t* wbase = word + (size_t)t * WR * N + col;
    int4 w[2 * KS];
    uint2 sv[2], bv[2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      w[2 * ks] = ld_16(wbase + (size_t)(8 * ks + tig) * N);
      w[2 * ks + 1] = ld_16(wbase + (size_t)(8 * ks + 4 + tig) * N);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t qoff = (size_t)(2 * t + h) * N + col;
      sv[h] = __ldg(reinterpret_cast<const uint2*>(s + qoff));
      bv[h] = __ldg(reinterpret_cast<const uint2*>(b + qoff));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int tmp[2][NT][4], xs[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[0][nt][e] = tmp[1][nt][e] = xs[nt][e] = 0;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int k0 = (2 * t + h) * G + 32 * ks + 4 * tig;
        const int4& w0 = w[2 * ks];
        const int4& w1 = w[2 * ks + 1];
        const uint32_t a0[4] = {plane8(w0.x, h), plane8(w0.y, h), plane8(w1.x, h),
                                plane8(w1.y, h)};
        const uint32_t a1[4] = {plane8(w0.z, h), plane8(w0.w, h), plane8(w1.z, h),
                                plane8(w1.w, h)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int r = 8 * nt + gid;
          const uint32_t b0 = r < M ? ld_4(x + (size_t)r * K + k0) : 0u;
          const uint32_t b1 = r < M ? ld_4(x + (size_t)r * K + k0 + 16) : 0u;
          mma_16832(tmp[0][nt], a0, b0, b1);
          mma_16832(tmp[1][nt], a1, b0, b1);
          mma_16832(xs[nt], ones, b0, b1);
        }
      }
      // Fold the group; xs holds the row sums of x over the group in the
      // same places as the products (every row of the ones tile is alike).
      const __nv_bfloat16* sh = reinterpret_cast<const __nv_bfloat16*>(&sv[h]);
      const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(&bv[h]);
      float sc[4], bc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[c] = __bfloat162float(sh[c]);
        bc[c] = __bfloat162float(bh[c]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 2 * p + (e >> 1);
            acc[p][nt][e] = fmaf((float)xs[nt][e & 1], bc[c],
                                 fmaf(sc[c], (float)tmp[p][nt][e], acc[p][nt][e]));
          }
    }
  }
}

}  // namespace
