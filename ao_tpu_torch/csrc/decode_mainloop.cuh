// The single-query decode attention mainloop of K2, K2v, K5, K6 and K7
// (decode_attention.cu) and K9 (paged_attention.cu), for Hopper (sm_90a).
//
// For each batch row b and kv head, the G = H / Hkv <= 8 query heads of its
// group share one stream of K and V rows (positions t < T):
//
//   s[h, t] = (q[h] . K[t]) * sm_scale (* ks[t]) in f32, masked by the Op
//             (K5: q quantized to int8, f32(qi[h] . K[t]) * ks[t] * (qs *
//             sm_scale));
//   out[h]  = sum_t bf16(p[h, t] (* vs[t])) V[t] / max(sum_t p[h, t], 1e-30),
//
// f32 (B, H, D), with p = exp(s - m) against a running max m, rounded to
// bf16 before p . V as the TPU kernels round it. An Op says where a row's
// bytes live (K2, K2v: the dense (B, T, Hkv, D) cache; K9: a page of the
// pool, looked up in the block table), how many positions a stream walks,
// the mask, and how stored bytes become bf16 (bytes_to_bf16 below).
//
// What bounds it on the H100: the K and V bytes of the positions walked
// against 3.35 TB/s; 4 G flops a loaded element are far below the ridge.
// The design keeps bytes in flight and the instruction count low:
//
// * Grid (S, Hkv, B): the S CTAs of a stream (S = 1, 2, 4 or 8) form one
//   thread-block cluster along x and walk S contiguous ranges of tiles of
//   16 WARPS positions (WARPS = 4 or 8; ``tiles`` each), stopping at the
//   Op's walk end.
// * Each warp takes the 16-position slab ``warp`` of every tile of its CTA
//   and is its own pipeline: a ring of NS slabs in shared memory filled by
//   16-byte cp.async copies (commit groups, no CTA barrier), NS - 1 slabs
//   in flight while it computes one. Rows at or past the walk end are
//   zero-filled (src-size 0): never read from device memory. The Op's row
//   lookup for the next slab is loaded one slab ahead (K9's block table).
//   Quantized rows land as raw bytes with their f32 scales and become bf16
//   in a per-warp slab (Op::to_bf16); bf16 rows land in it directly. Rows
//   are 256 bytes, their 16-byte chunks XOR-swizzled by row, so ldmatrix
//   reads them without bank conflicts.
// * Math, per slab: mma.sync m16n8k16 (bf16 in, f32 accumulate) with the
//   group's query heads as the rows of A (G <= 8 of 16: the upper 8 are 0),
//   q held in registers as A fragments; q . K^T takes K by ldmatrix; an
//   online softmax in f32 (scale, k scale, mask, running max and sum); p
//   rounded to bf16 (after * v scale) stays in registers as the A operand
//   of p . V, FlashAttention-2 style, with V by ldmatrix.trans.
// * Direct Ops (Op::kDirect: K5's int8 rows, K6's e4m3 rows, K7's int4
//   "ch4" rows) skip the bf16 slab and its round trip (stores, __syncwarp,
//   ldmatrix) on each slab's dependent chain: every lane loads raw bytes
//   from the ring and converts them in registers straight into its mma B
//   fragments.
//   - K: lane (g, t) of a warp takes position 8j + g of n8 tile j and the
//     32 contiguous channels [32 t, 32 t + 32) of its row (32 bytes int8 or
//     e4m3, 16 ch4). A lane's k slots of the 8 k16 steps are permuted onto
//     those channels (direct_k_frag below), and q's A fragments are built
//     through the same permutation once, before the loop (direct_q_frag;
//     for ch4 after the first copies are issued), so q . K is unchanged.
//   - K5's int8 K rows are not converted at all: after the first copies
//     each warp quantizes the group's q to int8 (direct_q_int8: one xor-
//     shuffle max, the IEEE quotients' codes by quant_round.cuh, the same
//     bits in every warp), and the
//     scores are exact integer dots, mma.sync m16n8k32 s8 with the k slots
//     4t .. 4t + 3 and 16 + 4t .. 19 + 4t of k32 step kk on channels 32 t +
//     8 kk + [0, 8): A's words are the lane's q words 2 kk and 2 kk + 1, B's
//     its raw K words 2 kk and 2 kk + 1. A score is f32(dot) * ks[t] * (qs *
//     sm_scale), the reference's order.
//   - V: as B of p . V a lane needs one channel of the two positions 2t,
//     2t + 1 (and 2t + 8, 2t + 9): it loads the 16 channels [16 g, 16 g +
//     16) of those four rows and joins the bytes (nibbles) of two rows with
//     one __byte_perm before each bf16x2 conversion. Column n of n8 tile nn
//     is then channel 16 n + nn, restored when the warp stores its partials.
//   - The raw stage is swizzled in 16-byte chunks within 128-byte lines
//     (direct_raw_off), so that every one of these loads is free of bank
//     conflicts, and so are the warps' partial stores and the merge's reads
//     (direct_part_col). A direct Op's ring is built at three stages, which
//     timed best at the main paths' shapes.
//   - The merge's weights of the warps are computed once a CTA, not by
//     every thread.
// * Merge: the warps' (m, l, acc) through shared memory in warp order; then
//   the CTAs of a cluster: rank f finishes output columns [f D / S, (f + 1)
//   D / S), every rank storing its m, l and those columns into rank f's
//   shared memory (distributed shared memory) and rank f summing them in
//   rank order, so the output is the same bit for bit from run to run. A
//   warp or rank that walked no position has m = -inf and weight exactly 0.
//   The barrier discipline is cluster_sum.cuh's: a relaxed arrive at start,
//   a wait before the first store into a peer, one arrive / wait pair
//   before the sums. No workspace in device memory, no second kernel.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_sum.cuh"
#include "quant_round.cuh"

namespace {
namespace dm {

constexpr int kD = 128;         // head dim
constexpr int kGMax = 8;        // query heads per kv head
constexpr int kSlab = 16;       // positions a warp takes at a time: one k16 step of p . V
constexpr int kMaxSplit = 8;    // CTAs of a stream: a portable cluster
constexpr int kRowB = 2 * kD;   // bytes of a bf16 row
constexpr int kMaxSmem = 232448;  // shared memory a block can have on the H100 (227 KB)
constexpr int kWarpsMax = 8;      // warps a CTA (128-row tiles)
constexpr float kNeg = -0.7f * 3.4028234663852886e38f;  // the TPU kernels' mask value

// What a launch reads and writes; the Op reads its own fields.
struct Params {
  const __nv_bfloat16* q;  // (B, H, D)
  const uint8_t* k;        // the Op's K rows
  const uint8_t* v;        // the Op's V rows
  const float* k_scale;    // quantized rows: one f32 scale a row (the Op's layout)
  const float* v_scale;
  const int* table;        // K9: (B, max_pages) page ids
  const int* lengths;      // (B,)
  float* out;              // (B, H, D) f32
  int T;                   // positions of a stream
  int H, Hkv;
  int page_size, max_pages;
  int tiles;               // tiles a CTA walks
  float sm_scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d0, d1 += (rows 0-7 of A) . B for one m16n8k16 step: A's fragments a0
// (k 0-7) and a2 (k 8-15) of the lane's row, its rows 8-15 zero, whose
// results (d2, d3) are dropped.
__device__ __forceinline__ void mma_rows8(float& d0, float& d1, uint32_t a0, uint32_t a2,
                                          uint32_t b0, uint32_t b1) {
  const uint32_t z = 0u;
  float x2, x3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %10, %11};\n"
      : "+f"(d0), "+f"(d1), "=f"(x2), "=f"(x3)
      : "r"(a0), "r"(z), "r"(a2), "r"(z), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f));
}

// d0, d1 += (rows 0-7 of A) . B for one m16n8k32 step over int8, exact in
// int32: A's words a0 (k slots 4t .. 4t + 3 of the lane's row) and a2 (16 +
// 4t .. 19 + 4t), its rows 8-15 zero, whose results (d2, d3) are dropped.
__device__ __forceinline__ void mma_rows8_s8(int& d0, int& d1, uint32_t a0, uint32_t a2,
                                             uint32_t b0, uint32_t b1) {
  const uint32_t z = 0u;
  int x2, x3;
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %10, %11};\n"
      : "+r"(d0), "+r"(d1), "=r"(x2), "=r"(x3)
      : "r"(a0), "r"(z), "r"(a2), "r"(z), "r"(b0), "r"(b1), "r"(0), "r"(0));
}

// e^x as 2^(x log2 e): MUFU.EX2 (-inf gives 0)
__device__ __forceinline__ float exp_f32(float x) { return exp2f(x * 1.4426950408889634f); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf162(uint32_t x) {
  return *reinterpret_cast<__nv_bfloat162*>(&x);
}

// The stored values an Op converts (its to_bf16): one-byte kinds, and int4
// "ch4" words (8 channel nibbles u at bits [4o, 4o + 4), value u - 8).
enum Byte { kInt8 = 0, kE4M3 = 1, kE5M2 = 2, kCh4 = 3 };

// int8 bytes 0 and 2 of x -> bf16x2 (bytes 1 and 3 ignored), exact: see
// bytes_to_bf16.
__device__ __forceinline__ uint32_t int8x2(uint32_t x) {
  return bf162_bits(__hsub2(bits_bf162((x & 0x007F007Fu) | 0x43004300u),
                            bits_bf162((x & 0x00800080u) | 0x43004300u)));
}

// e4m3 bytes 0 and 2 of x -> bf16x2 (bytes 1 and 3 ignored), exact: see
// bytes_to_bf16.
__device__ __forceinline__ uint32_t e4m3x2(uint32_t x) {
  const uint32_t e = ((x << 4) & 0x07F007F0u) | ((x << 8) & 0x80008000u);
  return bf162_bits(__hmul2(bits_bf162(e), bits_bf162(0x7B807B80u)));
}

// A ch4 word w (or two rows' halves joined by __byte_perm) -> bf16x2 of its
// nibbles j and j + 4, exact: (w >> 4j) & 0x000F000F | 0x43004300 is bf16x2
// 128 + u, less 136 (the int4 weight kernels' bit trick).
__device__ __forceinline__ uint32_t ch4_pair(uint32_t w, int j) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  return bf162_bits(__hsub2(bits_bf162(((w >> (4 * j)) & 0x000F000Fu) | 0x43004300u), bias));
}

// 16 stored bytes of one ch4 row (four words of 8 channels) -> four chunks
// o of 8 bf16 values in channel order (K9 "int4"'s slab).
__device__ __forceinline__ void ch4_to_bf16(int4 raw, uint4 (&o)[4]) {
  const uint32_t w[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z, (uint32_t)raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 q[4];  // q[j] = (channel j, channel j + 4) of word i
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = bits_bf162(ch4_pair(w[i], j));
    o[i].x = bf162_bits(__lows2bfloat162(q[0], q[1]));
    o[i].y = bf162_bits(__lows2bfloat162(q[2], q[3]));
    o[i].z = bf162_bits(__highs2bfloat162(q[0], q[1]));
    o[i].w = bf162_bits(__highs2bfloat162(q[2], q[3]));
  }
}

// 16 stored bytes of one row -> two chunks o of 8 bf16 values each; exact,
// in integer and bf16x2 operations (a type conversion runs at a quarter of
// their rate). Two bytes x of a word go to the two 16-bit halves of a pair
// at a time:
//   int8: bf16 (0x4300 | x & 0x7F) - bf16 (0x4300 | x & 0x80), that is
//         (128 + (x & 0x7F)) - (x < 0 ? 256 : 128);
//   e4m3: bf16 ((x & 0x80) << 8 | (x & 0x7F) << 4) * 2^120: the byte's
//         exponent and mantissa in bf16's, off by the bias difference
//         127 - 7, subnormals and 0 included (the NaN codes become finite);
//   e5m2: bf16 ((x & 0x80) << 8 | (x & 0x7F) << 5) * 2^112, the same with
//         the bias difference 127 - 15 (the exponent-31 codes, inf and NaN,
//         become finite).
// Rows at or past a stream's walk end are never loaded, and the caches'
// quantizers write none of the codes that become finite below it.
template <int KIND>
__device__ __forceinline__ void bytes_to_bf16(int4 raw, uint4 (&o)[2]) {
  const uint32_t w[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z, (uint32_t)raw.w};
  uint32_t v[8];  // bf16x2 of bytes (2k, 2k + 1)
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    // bytes 2k and 2k + 1 of the chunk into the two halves of x
    const uint32_t x = __byte_perm(w[k >> 1], 0u, (k & 1) ? 0x4342u : 0x4140u);
    if constexpr (KIND == kInt8) {
      v[k] = int8x2(x);
    } else if constexpr (KIND == kE4M3) {
      v[k] = e4m3x2(x);
    } else {
      const uint32_t e = ((x << 5) & 0x0FE00FE0u) | ((x << 8) & 0x80008000u);
      v[k] = bf162_bits(__hmul2(bits_bf162(e), bits_bf162(0x77807780u)));
    }
  }
  o[0] = make_uint4(v[0], v[1], v[2], v[3]);
  o[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// Byte offset of 16-byte chunk c (values 8c .. 8c + 7) of row r in a bf16
// slab (16 rows of 256 bytes).
__device__ __forceinline__ int swz(int r, int c) { return r * kRowB + ((c ^ (r & 7)) << 4); }

// Whether Op is K5's: a direct Op over int8 rows, whose q is quantized to
// int8 and whose scores are integer dots.
template <class Op>
__host__ __device__ constexpr bool direct_int8() {
  if constexpr (Op::kDirect) return Op::kKind == kInt8;
  else return false;
}

// Direct Ops: byte offset of 16-byte chunk c of row r in a raw K or V block
// of 16 rows of RB bytes (128: int8, e4m3; 64: ch4). A 128-byte line (one
// int8 or e4m3 row, two ch4 rows) keeps its chunk i at i ^ (line & 7)
// (128-byte rows) or i ^ 2 (line & 3) (ch4), so that each phase of the fragment loads below reads
// every bank once.
template <int RB>
__device__ __forceinline__ int direct_raw_off(int r, int c) {
  if constexpr (RB == 128) {
    return r * 128 + ((c ^ (r & 7)) << 4);
  } else {
    const int line = r >> 1;
    return line * 128 + (((4 * (r & 1) + c) ^ (2 * (line & 3))) << 4);
  }
}

// Direct Ops: q's A fragment word h (k slots 2t, 2t + 1 of k16 step kk, or
// 2t + 8, 2t + 9) from the lane's words qw = channels [32 t, 32 t + 32) of
// its head row, through the permutation of direct_k_frag: e4m3 channels
// 32 t + 4 kk + 2 h + {0, 1}; ch4 channels c and c + 4, c = 32 t + 8 (kk /
// 2) + 2 (kk % 2) + h.
template <int KIND>
__device__ __forceinline__ uint32_t direct_q_frag(const uint32_t (&qw)[16], int kk, int h) {
  if constexpr (KIND == kE4M3) {
    return qw[2 * kk + h];
  } else {
    const int w = 4 * (kk >> 1) + (kk & 1);
    return __byte_perm(qw[w], qw[w + 2], h ? 0x7632u : 0x5410u);
  }
}

// K5: the group's q quantized to int8 by each warp, as the reference does
// it (qs = max(max |q|, 1e-8) / 127 over its G heads x D channels, qi =
// clip(rint(q / qs), +-127), the IEEE quotients' codes by quant_byte:
// every warp of the cluster gets the same bits). Lane (g, t) holds channels [32 t, 32 t + 32) of head
// row g in qw (rows g >= G hold zeros); qa[kk] gets qi's words 2 kk and 2 kk
// + 1 (channels 32 t + 8 kk + [0, 8)), the A fragment of k32 step kk.
// Returns qs.
__device__ __forceinline__ float direct_q_int8(const uint32_t (&qw)[16],
                                               uint32_t (&qa)[kD / 16][2]) {
  float v[32], amax = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 f = __bfloat1622float2(bits_bf162(qw[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
    amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float qs = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f), r = __frcp_rn(qs);
#pragma unroll
  for (int w = 0; w < 8; ++w)
    qa[w >> 1][w & 1] = pack_bytes(quant_byte(v[4 * w], qs, r), quant_byte(v[4 * w + 1], qs, r),
                                   quant_byte(v[4 * w + 2], qs, r), quant_byte(v[4 * w + 3], qs, r));
  return qs;
}

// Direct Ops: q . K^T's B fragments (b0, b1) of k16 step kk from the raw
// words w of the lane's 32 channels of one K row: e4m3 word kk, its bytes
// (0, 1) and (2, 3); ch4 word kk / 2, its nibbles (j, j + 4) and (j + 1,
// j + 5), j = 2 (kk % 2).
template <int KIND>
__device__ __forceinline__ void direct_k_frag(const uint32_t* w, int kk, uint32_t& b0,
                                              uint32_t& b1) {
  if constexpr (KIND == kE4M3) {
    b0 = e4m3x2(__byte_perm(w[kk], 0u, 0x4140u));
    b1 = e4m3x2(__byte_perm(w[kk], 0u, 0x4342u));
  } else {
    b0 = ch4_pair(w[kk >> 1], 2 * (kk & 1));
    b1 = ch4_pair(w[kk >> 1], 2 * (kk & 1) + 1);
  }
}

// Direct Ops: p . V's B fragment word of n8 tile nn from the raw words a
// and b of the lane's 16 channels [16 g, 16 g + 16) of two V rows: channel
// 16 g + nn of both, a's in the low half.
template <int KIND>
__device__ __forceinline__ uint32_t direct_v_frag(const uint32_t* a, const uint32_t* b, int nn) {
  if constexpr (KIND == kE4M3) {
    const uint32_t k = nn & 3;
    return e4m3x2(__byte_perm(a[nn >> 2], b[nn >> 2], ((4u + k) << 8) | k));
  } else if constexpr (KIND == kInt8) {
    const uint32_t k = nn & 3;
    return int8x2(__byte_perm(a[nn >> 2], b[nn >> 2], ((4u + k) << 8) | k));
  } else {
    return ch4_pair(__byte_perm(a[nn >> 3], b[nn >> 3], (nn & 4) ? 0x7632u : 0x5410u), nn & 3);
  }
}

// Direct V: the column of a warp's partial where channel d of head row g
// is kept, rotated by 8 (d / 32) + g within its block of 32, so that the
// 32 lanes of each partial store (channels 32 t + 16 e + nn of rows g) and
// of each merge read hit 32 banks.
__device__ __forceinline__ int direct_part_col(int g, int d) {
  return (d & ~31) | ((d + 8 * (d >> 5) + g) & 31);
}

// Shared memory: a region a warp (its ring, then for quantized rows its
// bf16 slab of K and V, none for a direct Op), then the cluster merge's
// receive area.
template <class Op, int NS>
struct Layout {
  // a stage: the K rows, the V rows and (quantized) their 16 + 16 scales
  static constexpr int kStage = 2 * kSlab * Op::kRowBytes + (Op::kQuant ? 2 * kSlab * 4 : 0);
  static constexpr int kSlabBytes = Op::kQuant && !Op::kDirect ? 2 * kSlab * kRowB : 0;
  static constexpr int kWarp = NS * kStage + kSlabBytes;
  // [ranks][heads][D / S] columns, then m and l [ranks][heads]
  static constexpr int kRecvFloats = kGMax * kD + 2 * kMaxSplit * kGMax;
  static constexpr int kPartFloats = kGMax * kD + 2 * kGMax;  // a warp's (acc, m, l)
  static_assert(kStage % 128 == 0 && kWarp % 128 == 0, "128-byte aligned regions");
  static_assert((kPartFloats + (kWarpsMax + 2) * kGMax) * 4 <= kWarp,
                "a warp's partials, and warp 0's merge weights, fit its region");
  static constexpr int smem(int warps) { return warps * kWarp + kRecvFloats * 4; }
};

// Issue one slab's copies (rows start .. start + 15 of the stream, those
// below ``end`` read, the rest zero-filled) into the stage at ``stage``.
template <class Op>
__device__ __forceinline__ void issue_slab(const Params& p, uint32_t stage, int b, int kvh,
                                           int start, int end, const typename Op::Cursor& cur,
                                           int lane) {
  constexpr int RB = Op::kRowBytes, kChunks = RB / 16, kRowsPass = 32 / kChunks;
  const int c = lane % kChunks, r0 = lane / kChunks;
#pragma unroll
  for (int i = 0; i < kSlab / kRowsPass; ++i) {
    const int r = r0 + i * kRowsPass;
    const bool ok = start + r < end;
    const size_t off = ok ? Op::row_offset(p, cur, b, kvh, start, r) + c * 16 : 0;
    const uint32_t dst = Op::kDirect  ? stage + direct_raw_off<RB>(r, c)
                         : Op::kQuant ? stage + r * RB + c * 16
                                      : stage + swz(r, c);
    cp_async16(dst, p.k + off, ok);
    cp_async16(dst + kSlab * RB, p.v + off, ok);
  }
  if constexpr (Op::kQuant) {
    const int r = lane & (kSlab - 1);
    const bool ok = start + r < end;
    const size_t si = ok ? Op::scale_index(p, cur, b, kvh, start, r) : 0;
    cp_async4(stage + 2 * kSlab * RB + lane * 4, (lane < kSlab ? p.k_scale : p.v_scale) + si, ok);
  }
}

// Raw quantized rows of a stage -> the warp's bf16 slab (K then V), each
// 16 stored bytes through Op::to_bf16; a lane's raw chunks are all loaded
// before the first is converted.
template <class Op>
__device__ __forceinline__ void convert_slab(const uint8_t* raw, uint8_t* slab, int lane) {
  constexpr int RB = Op::kRowBytes, kChunks = RB / 16, kOut = kRowB / RB;
  int4 x[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) x[j] = *reinterpret_cast<const int4*>(raw + (lane + 32 * j) * 16);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int i = lane + 32 * j;  // raw chunk: tensor, row, chunk
    const int tens = i / (kSlab * kChunks), r = (i / kChunks) % kSlab, c = i % kChunks;
    uint4 o[kOut];
    Op::to_bf16(x[j], o);
    uint8_t* dst = slab + tens * kSlab * kRowB;
#pragma unroll
    for (int e = 0; e < kOut; ++e) *reinterpret_cast<uint4*>(dst + swz(r, c * kOut + e)) = o[e];
  }
}

// Direct Ops: the slab's q . K^T, s[kk % 2][n8 tile][column] (the two
// chains of the bf16 path; K5's k32 steps in int32), K's B fragments
// converted from the raw rows (K5's taken as they are): lane (g, t) loads
// the 32 channels [32 t, 32 t + 32) of position 8 j + g of each n8 tile j.
template <class Op, class Acc>
__device__ __forceinline__ void direct_scores(const uint8_t* kraw, const uint32_t (&qa)[kD / 16][2],
                                              Acc (&s)[2][2][2], int g, int t) {
  constexpr int RB = Op::kRowBytes, kKC = 2 * RB / kD;  // 16-byte chunks of 32 channels
  uint32_t w[2][4 * kKC];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int h = 0; h < kKC; ++h) {
      const uint4 x =
          *reinterpret_cast<const uint4*>(kraw + direct_raw_off<RB>(8 * j + g, kKC * t + h));
      w[j][4 * h] = x.x;
      w[j][4 * h + 1] = x.y;
      w[j][4 * h + 2] = x.z;
      w[j][4 * h + 3] = x.w;
    }
  }
  if constexpr (direct_int8<Op>()) {
#pragma unroll
    for (int kk = 0; kk < kD / 32; ++kk) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_rows8_s8(s[kk & 1][j][0], s[kk & 1][j][1], qa[kk][0], qa[kk][1], w[j][2 * kk],
                     w[j][2 * kk + 1]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b0, b1;
        direct_k_frag<Op::kKind>(w[j], kk, b0, b1);
        mma_rows8(s[kk & 1][j][0], s[kk & 1][j][1], qa[kk][0], qa[kk][1], b0, b1);
      }
    }
  }
}

// Direct Ops' V: lane (g, t) loads the 16 channels [16 g, 16 g + 16) of rows 2t,
// 2t + 1, 2t + 8 and 2t + 9 of the slab (the k rows of its b0 and b1).
template <class Op>
__device__ __forceinline__ void direct_load_v(const uint8_t* vraw,
                                              uint32_t (&w)[4][4 * Op::kRowBytes / kD], int g,
                                              int t) {
  constexpr int RB = Op::kRowBytes;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int r = 2 * t + (o & 1) + 8 * (o >> 1);
    if constexpr (RB == 128) {
      const uint4 x = *reinterpret_cast<const uint4*>(vraw + direct_raw_off<RB>(r, g));
      w[o][0] = x.x;
      w[o][1] = x.y;
      w[o][2] = x.z;
      w[o][3] = x.w;
    } else {
      const uint2 x =
          *reinterpret_cast<const uint2*>(vraw + direct_raw_off<RB>(r, g >> 1) + 8 * (g & 1));
      w[o][0] = x.x;
      w[o][1] = x.y;
    }
  }
}

template <class Op, int WARPS, int NS>
__global__ void __launch_bounds__(32 * WARPS) decode_attn_kernel(const Params p) {
  using Lay = Layout<Op, NS>;
  constexpr int kThreads = 32 * WARPS, kRows = kSlab * WARPS;
  extern __shared__ __align__(128) uint8_t smem[];
  const int rank = blockIdx.x, S = gridDim.x, kvh = blockIdx.y, b = blockIdx.z;
  if (S > 1) cluster_started();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = p.H / p.Hkv;
  const int L = p.lengths[b];
  const int end = Op::walk_end(L, p.T);
  const int t0 = rank * p.tiles * kRows;
  const int stop = min(t0 + p.tiles * kRows, end);
  const int first = t0 + warp * kSlab;  // the warp's first slab; then every kRows
  const int n = first < stop ? (stop - first + kRows - 1) / kRows : 0;

  uint8_t* region = smem + warp * Lay::kWarp;
  const uint32_t ring = smem_u32(region);
  const int grp = lane >> 2, tq = 2 * (lane & 3);  // the lane's head row, its column pair

  // q: the group's heads as rows 0-7 of A, k-steps of 16 channels (a
  // direct Op's lane loads its 32 channels qw here, its fragments are
  // assembled below, after the first copies are issued)
  uint32_t qa[kD / 16][2], qw[16];
  {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        p.q + ((size_t)b * p.H + kvh * G + min(grp, G - 1)) * kD);
    if constexpr (Op::kDirect) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 x = grp < G ? reinterpret_cast<const uint4*>(qr)[4 * (lane & 3) + i]
                                : make_uint4(0u, 0u, 0u, 0u);
        qw[4 * i] = x.x;
        qw[4 * i + 1] = x.y;
        qw[4 * i + 2] = x.z;
        qw[4 * i + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        qa[kk][0] = grp < G ? qr[8 * kk + tq / 2] : 0u;
        qa[kk][1] = grp < G ? qr[8 * kk + 4 + tq / 2] : 0u;
      }
    }
  }

  float acc[kD / 8][2];
#pragma unroll
  for (int nn = 0; nn < kD / 8; ++nn) acc[nn][0] = acc[nn][1] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  // the lookups of the first NS slabs, which need no length: positions
  // clamped below T, a slab past the walk's end never issued
  typename Op::Cursor cur[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) cur[i] = Op::look(p, b, min(first + i * kRows, p.T - 1));
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n) issue_slab<Op>(p, ring + i * Lay::kStage, b, kvh, first + i * kRows, end, cur[i],
                              lane);
    cp_async_commit();
  }
  typename Op::Cursor next = cur[NS - 1];
  float cq = 0.f;  // K5: qs * sm_scale
  if constexpr (Op::kDirect) {
    // q's fragments through direct_k_frag's permutation, after the copies:
    // ch4's byte permutes and K5's quantize would otherwise hold the first
    // copy until q landed (e4m3's words are its fragments: they wait for q
    // at the first mma)
    if constexpr (Op::kKind != kE4M3) {
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(qw[i]));
    }
    if constexpr (direct_int8<Op>()) {
      cq = __fmul_rn(direct_q_int8(qw, qa), p.sm_scale);
    } else {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        qa[kk][0] = direct_q_frag<Op::kKind>(qw, kk, 0);
        qa[kk][1] = direct_q_frag<Op::kKind>(qw, kk, 1);
      }
    }
  }

  const int kr = ((lane >> 4) << 3) + (lane & 7), kc = (lane >> 3) & 1;  // ldmatrix rows of K
  const int vr = (((lane >> 3) & 1) << 3) + (lane & 7), vc = lane >> 4;  // and of V (trans)
  for (int i = 0; i < n; ++i) {
    cp_async_wait<NS - 2>();  // this lane's copies of slab i landed
    __syncwarp();             // and every lane's; slab i - 1 is free
    {
      const int j = i + NS - 1;
      if (j < n) issue_slab<Op>(p, ring + (j % NS) * Lay::kStage, b, kvh, first + j * kRows, end,
                                next, lane);
      cp_async_commit();
      if (j + 1 < n) next = Op::look(p, b, first + (j + 1) * kRows);
    }
    const int start = first + i * kRows;
    const uint8_t* stage = region + (i % NS) * Lay::kStage;
    uint32_t slab = ring + (i % NS) * Lay::kStage;
    if constexpr (Op::kQuant && !Op::kDirect) {
      convert_slab<Op>(stage, region + NS * Lay::kStage, lane);
      __syncwarp();
      slab = ring + NS * Lay::kStage;
    }
    // a direct Op's V: its raw words, loaded beside the q . K chain
    uint32_t vw[4][4 * Op::kRowBytes / kD];
    if constexpr (Op::kDirect) direct_load_v<Op>(stage + kSlab * Op::kRowBytes, vw, grp, lane & 3);

    // q . K^T in two independent chains of k-steps (even, odd), summed
    float s[2][2][2] = {};  // [chain][n8 tile][column]
    int si[2][2][2] = {};   // K5's, in int32
    if constexpr (direct_int8<Op>()) {
      direct_scores<Op>(stage, qa, si, grp, lane & 3);
    } else if constexpr (Op::kDirect) {
      direct_scores<Op>(stage, qa, s, grp, lane & 3);
    } else {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, slab + swz(kr, 2 * kk + kc));
        float(&c)[2][2] = s[kk & 1];
        mma_rows8(c[0][0], c[0][1], qa[kk][0], qa[kk][1], r[0], r[1]);
        mma_rows8(c[1][0], c[1][1], qa[kk][0], qa[kk][1], r[2], r[3]);
      }
    }
    const float* ksc = reinterpret_cast<const float*>(stage + 2 * kSlab * Op::kRowBytes);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e >> 1) * 8 + tq + (e & 1);
      float v;
      if constexpr (direct_int8<Op>()) {  // the exact dot, * ks, * (qs sm_scale)
        v = __fmul_rn(__fmul_rn((float)(si[0][e >> 1][e & 1] + si[1][e >> 1][e & 1]), ksc[r]),
                      cq);
      } else {
        v = (s[0][e >> 1][e & 1] + s[1][e >> 1][e & 1]) * p.sm_scale;
        if constexpr (Op::kQuant) v *= ksc[r];
      }
      x[e] = Op::mask(v, start + r, L, p.T);
    }
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);  // finite: a slab starts below T
    const float alpha = exp_f32(m_run - m_new);
    m_run = m_new;
    float pr[4], psum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pr[e] = exp_f32(x[e] - m_new);
      psum += pr[e];
    }
    l_run = l_run * alpha + psum;
#pragma unroll
    for (int nn = 0; nn < kD / 8; ++nn) {
      acc[nn][0] *= alpha;
      acc[nn][1] *= alpha;
    }
    if constexpr (Op::kQuant) {
      const float* vsc = ksc + kSlab;
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[e] *= vsc[(e >> 1) * 8 + tq + (e & 1)];
    }
    const uint32_t pa0 = pack_bf16(pr[0], pr[1]), pa2 = pack_bf16(pr[2], pr[3]);
    if constexpr (Op::kDirect) {  // column n of n8 tile nn: channel 16 n + nn
#pragma unroll
      for (int nn = 0; nn < kD / 8; ++nn)
        mma_rows8(acc[nn][0], acc[nn][1], pa0, pa2, direct_v_frag<Op::kKind>(vw[0], vw[1], nn),
                  direct_v_frag<Op::kKind>(vw[2], vw[3], nn));
    } else {
#pragma unroll
      for (int np = 0; np < kD / 16; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, slab + kSlab * kRowB + swz(vr, 2 * np + vc));
        mma_rows8(acc[2 * np][0], acc[2 * np][1], pa0, pa2, r[0], r[1]);
        mma_rows8(acc[2 * np + 1][0], acc[2 * np + 1][1], pa0, pa2, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  __syncwarp();

  // the warp's (acc, m, l) into its own region, then the CTA's merge
  {
    float* part = reinterpret_cast<float*>(region);
#pragma unroll
    for (int nn = 0; nn < kD / 8; ++nn) {
      if constexpr (Op::kDirect) {  // back to channel order, columns rotated
        part[grp * kD + direct_part_col(grp, 16 * tq + nn)] = acc[nn][0];
        part[grp * kD + direct_part_col(grp, 16 * (tq + 1) + nn)] = acc[nn][1];
      } else {
        *reinterpret_cast<float2*>(part + grp * kD + 8 * nn + tq) =
            make_float2(acc[nn][0], acc[nn][1]);
      }
    }
    if ((lane & 3) == 0) {
      part[kGMax * kD + grp] = m_run;
      part[kGMax * kD + kGMax + grp] = l_run;
    }
  }
  __syncthreads();
  auto part_of = [&](int w) { return reinterpret_cast<const float*>(smem + w * Lay::kWarp); };
  float mc[kGMax], lc[kGMax], wt[WARPS][kGMax];
  // a direct Op's weights once a CTA: thread g computes head g's into warp
  // 0's region past its partial ([WARPS][kGMax] weights, then m and l),
  // which every thread reads back; every thread computes them otherwise
  float* shw = reinterpret_cast<float*>(smem) + Lay::kPartFloats;
  if constexpr (Op::kDirect) {
    if (tid < kGMax) {
      float m = -INFINITY, l = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) m = fmaxf(m, part_of(w)[kGMax * kD + tid]);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float mw = part_of(w)[kGMax * kD + tid];
        const float x = mw == -INFINITY ? 0.f : exp_f32(mw - m);
        shw[w * kGMax + tid] = x;
        l = fmaf(x, part_of(w)[kGMax * kD + kGMax + tid], l);
      }
      shw[WARPS * kGMax + tid] = m;
      shw[(WARPS + 1) * kGMax + tid] = l;
    }
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if constexpr (Op::kDirect) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) wt[w][g] = shw[w * kGMax + g];
      mc[g] = shw[WARPS * kGMax + g];
      lc[g] = shw[(WARPS + 1) * kGMax + g];
    } else {
      float m = -INFINITY, l = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) m = fmaxf(m, part_of(w)[kGMax * kD + g]);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float mw = part_of(w)[kGMax * kD + g];
        wt[w][g] = mw == -INFINITY ? 0.f : exp_f32(mw - m);
        l = fmaf(wt[w][g], part_of(w)[kGMax * kD + kGMax + g], l);
      }
      mc[g] = m;
      lc[g] = l;
    }
  }
  float* recv = reinterpret_cast<float*>(smem + WARPS * Lay::kWarp);
  const int per = kD / S;  // columns each rank finishes
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (S > 1) cluster_wait();  // every peer runs: its shared memory may be written
  for (int d = tid; d < kD; d += kThreads) {
    const int f = d / per, dl = d - f * per;
    float* dst = S > 1 ? cluster.map_shared_rank(recv, f) : nullptr;
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g >= G) break;
      float a = 0.f;
      const int col = Op::kDirect ? direct_part_col(g, d) : d;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a = fmaf(wt[w][g], part_of(w)[g * kD + col], a);
      if (S == 1)
        p.out[((size_t)b * p.H + kvh * G + g) * kD + d] = a / fmaxf(lc[g], 1e-30f);
      else
        dst[(rank * kGMax + g) * per + dl] = a;
    }
  }
  if (S == 1) return;
  if (tid < S) {  // this rank's m and l into rank tid
    float* dst = cluster.map_shared_rank(recv + kGMax * kD, tid);
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      dst[rank * kGMax + g] = mc[g];
      dst[kMaxSplit * kGMax + rank * kGMax + g] = lc[g];
    }
  }
  cluster_arrive_release();
  cluster_wait();
  const float* rm = recv + kGMax * kD;
  const float* rl = rm + kMaxSplit * kGMax;
  for (int i = tid; i < G * per; i += kThreads) {
    const int g = i / per, dl = i - g * per;
    float m = -INFINITY;
    for (int q = 0; q < S; ++q) m = fmaxf(m, rm[q * kGMax + g]);
    float l = 0.f, a = 0.f;
    for (int q = 0; q < S; ++q) {
      const float mq = rm[q * kGMax + g];
      const float w = mq == -INFINITY ? 0.f : exp_f32(mq - m);
      l = fmaf(w, rl[q * kGMax + g], l);
      a = fmaf(w, recv[(q * kGMax + g) * per + dl], a);
    }
    p.out[((size_t)b * p.H + kvh * G + g) * kD + rank * per + dl] = a / fmaxf(l, 1e-30f);
  }
}

template <class Op, int WARPS, int NS>
cudaError_t launch_one(const Params& p, int S, int B, cudaStream_t st) {
  auto* kern = decode_attn_kernel<Op, WARPS, NS>;
  const int smem = Layout<Op, NS>::smem(WARPS);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, p.Hkv, B);
  cfg.blockDim = dim3(32 * WARPS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;  // one CTA a stream: a plain launch
  err = cudaLaunchKernelEx(&cfg, kern, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class Op, int WARPS>
cudaError_t launch_rows(const Params& p, int S, int B, int stages, cudaStream_t st) {
  // only the rings whose shared memory a block can have are built
  if constexpr (Layout<Op, 3>::smem(WARPS) <= kMaxSmem)
    if (stages == 3) return launch_one<Op, WARPS, 3>(p, S, B, st);
  // a direct Op is built at the three stages its plans take
  if constexpr (!Op::kDirect && Layout<Op, 4>::smem(WARPS) <= kMaxSmem)
    if (stages == 4) return launch_one<Op, WARPS, 4>(p, S, B, st);
  return cudaErrorInvalidValue;
}

// One launch at S CTAs a stream, ``rows`` positions a tile (64 or 128: four
// or eight warps) and ``stages`` slabs a warp's ring (3 or 4 as far as the
// shared memory goes, 3 for a direct Op); anything else is refused.
template <class Op>
cudaError_t launch(const Params& p, int S, int B, int rows, int stages, cudaStream_t st) {
  if ((S != 1 && S != 2 && S != 4 && S != 8) || p.tiles < 1 || p.H % p.Hkv ||
      p.H / p.Hkv > kGMax)
    return cudaErrorInvalidValue;
  if (rows == 128) return launch_rows<Op, 8>(p, S, B, stages, st);
  if (rows == 64) return launch_rows<Op, 4>(p, S, B, stages, st);
  return cudaErrorInvalidValue;
}

}  // namespace dm
}  // namespace
