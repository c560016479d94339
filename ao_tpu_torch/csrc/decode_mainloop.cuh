// The single-query decode attention mainloop of K2 and K2v
// (decode_attention.cu) and K9 (paged_attention.cu), for Hopper (sm_90a).
//
// For each batch row b and kv head, the G = H / Hkv <= 8 query heads of its
// group share one stream of K and V rows (positions t < T):
//
//   s[h, t] = (q[h] . K[t]) * sm_scale (* ks[t]) in f32, masked by the Op;
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

namespace {
namespace dm {

constexpr int kD = 128;         // head dim
constexpr int kGMax = 8;        // query heads per kv head
constexpr int kSlab = 16;       // positions a warp takes at a time: one k16 step of p . V
constexpr int kMaxSplit = 8;    // CTAs of a stream: a portable cluster
constexpr int kRowB = 2 * kD;   // bytes of a bf16 row
constexpr int kMaxSmem = 232448;  // shared memory a block can have on the H100 (227 KB)
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

// The one-byte stored values an Op converts (its to_bf16).
enum Byte { kInt8 = 0, kE4M3 = 1, kE5M2 = 2 };

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
      v[k] = bf162_bits(__hsub2(bits_bf162((x & 0x007F007Fu) | 0x43004300u),
                                bits_bf162((x & 0x00800080u) | 0x43004300u)));
    } else if constexpr (KIND == kE4M3) {
      const uint32_t e = ((x << 4) & 0x07F007F0u) | ((x << 8) & 0x80008000u);
      v[k] = bf162_bits(__hmul2(bits_bf162(e), bits_bf162(0x7B807B80u)));
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

// Shared memory: a region a warp (its ring, then for quantized rows its
// bf16 slab), then the cluster merge's receive area.
template <class Op, int NS>
struct Layout {
  // a stage: the K rows, the V rows and (quantized) their 16 + 16 scales
  static constexpr int kStage = 2 * kSlab * Op::kRowBytes + (Op::kQuant ? 2 * kSlab * 4 : 0);
  static constexpr int kWarp = NS * kStage + (Op::kQuant ? 2 * kSlab * kRowB : 0);
  // [ranks][heads][D / S] columns, then m and l [ranks][heads]
  static constexpr int kRecvFloats = kGMax * kD + 2 * kMaxSplit * kGMax;
  static constexpr int kPartFloats = kGMax * kD + 2 * kGMax;  // a warp's (acc, m, l)
  static_assert(kStage % 128 == 0 && kWarp % 128 == 0, "128-byte aligned regions");
  static_assert(kPartFloats * 4 <= kWarp, "a warp's partials fit its region");
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
    const uint32_t dst = Op::kQuant ? stage + r * RB + c * 16 : stage + swz(r, c);
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

  // q: the group's heads as rows 0-7 of A, k-steps of 16 channels
  uint32_t qa[kD / 16][2];
  {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        p.q + ((size_t)b * p.H + kvh * G + min(grp, G - 1)) * kD);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      qa[kk][0] = grp < G ? qr[8 * kk + tq / 2] : 0u;
      qa[kk][1] = grp < G ? qr[8 * kk + 4 + tq / 2] : 0u;
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
    if constexpr (Op::kQuant) {
      convert_slab<Op>(stage, region + NS * Lay::kStage, lane);
      __syncwarp();
      slab = ring + NS * Lay::kStage;
    }

    // q . K^T in two independent chains of k-steps (even, odd), summed
    float s[2][2][2] = {};  // [chain][n8 tile][column]
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, slab + swz(kr, 2 * kk + kc));
      float(&c)[2][2] = s[kk & 1];
      mma_rows8(c[0][0], c[0][1], qa[kk][0], qa[kk][1], r[0], r[1]);
      mma_rows8(c[1][0], c[1][1], qa[kk][0], qa[kk][1], r[2], r[3]);
    }
    const float* ksc = reinterpret_cast<const float*>(stage + 2 * kSlab * Op::kRowBytes);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e >> 1) * 8 + tq + (e & 1);
      float v = (s[0][e >> 1][e & 1] + s[1][e >> 1][e & 1]) * p.sm_scale;
      if constexpr (Op::kQuant) v *= ksc[r];
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
#pragma unroll
    for (int np = 0; np < kD / 16; ++np) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, slab + kSlab * kRowB + swz(vr, 2 * np + vc));
      mma_rows8(acc[2 * np][0], acc[2 * np][1], pa0, pa2, r[0], r[1]);
      mma_rows8(acc[2 * np + 1][0], acc[2 * np + 1][1], pa0, pa2, r[2], r[3]);
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
    for (int nn = 0; nn < kD / 8; ++nn)
      *reinterpret_cast<float2*>(part + grp * kD + 8 * nn + tq) = make_float2(acc[nn][0], acc[nn][1]);
    if ((lane & 3) == 0) {
      part[kGMax * kD + grp] = m_run;
      part[kGMax * kD + kGMax + grp] = l_run;
    }
  }
  __syncthreads();
  auto part_of = [&](int w) { return reinterpret_cast<const float*>(smem + w * Lay::kWarp); };
  float mc[kGMax], lc[kGMax], wt[WARPS][kGMax];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
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
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a = fmaf(wt[w][g], part_of(w)[g * kD + d], a);
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
  if constexpr (Layout<Op, 4>::smem(WARPS) <= kMaxSmem)
    if (stages == 4) return launch_one<Op, WARPS, 4>(p, S, B, st);
  return cudaErrorInvalidValue;
}

// One launch at S CTAs a stream, ``rows`` positions a tile (64 or 128: four
// or eight warps) and ``stages`` slabs a warp's ring (3 or 4, as far as the
// shared memory goes); anything else is refused.
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
