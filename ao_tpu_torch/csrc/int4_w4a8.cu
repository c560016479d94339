// W4A8 over the two-plane "magic8" int32 layout, for Hopper (sm_90a): the
// decode GEMM (K3) and the prefill requantization to per-channel int8 (K4).
//
// Layout (ao_tpu_torch/quantization/qarrays/int4.py): the groups come in
// pairs; plane A holds the even group of a pair, plane B the odd one. Word
// row r of pair t (r = t*g/4 + i) holds in byte b the nibbles u of in-group
// row 4i + b: plane A's in the low nibble, plane B's in the high one. So
// word & 0x0F0F0F0F is four consecutive K rows of one column of plane A as
// int8 0..15, and (word >> 4) & 0x0F0F0F0F the same rows of plane B.
//
// ---------------------------------------------------------------------------
// K3: int4_w4a8_gemv_kernel replaces ao_tpu/ops/pallas/int4_matmul.py::
// _w4a8_kernel (launched by _int4_w4a8_impl, public entry
// int4_w4a8_matmul_pallas):
//
//   y[m, n] = sx[m] * sum_G ( s[G, n] * dot_i32(x[m, G], u[G, n])
//                             + b[G, n] * sum_k x[m, k in G] ),
//
// x int8 per-token symmetric with f32 scale sx, w = u*s + b per group (s and
// b in bf16, the reference wrapper's transport), f32 out. The i32 dot of a
// group is exact (|u| <= 15, |x| <= 128, g <= 128).
//
// The planes map onto the s8 tensor cores with no shuffles: one 32-bit
// plane register is four consecutive K rows of one column, which is what an
// A-fragment register of mma.sync m16n8k32.s8 holds (row groupID, columns
// 4*tig .. 4*tig + 3). The weights are the A operand (16 N-columns of an m16
// tile) and x^T the B operand (8 batch rows of an n8 tile), as in K1
// (int4_matmul.cu), so at M = 8 no half of an m16 tile is spent on rows of
// x that do not exist. The row sums of x over a group come from one more mma
// against an A of ones.
//
// What bounds it on the H100 at decode (M = 8): the weight stream, 0.5 B per
// weight plus 4 B of s and b per g weights, against 3.35 TB/s; the int8
// operations are ~0.5 % of the tensor cores' time at that rate. In
// practice the latency of a warp's chain of group pairs: each costs a
// word load from HBM and its products, about 1.2-1.8 us a pair at the small
// shapes on the H100, so K is split until each warp holds one to four
// pairs. A warp owns 32 columns and loads them with one 16-byte load per
// word row and thread (with more than one pair, the next pair's words in
// flight while it multiplies this one's). A launch is one kernel: a CTA is
// one warp of columns by up to 8 warps along K, summed in shared memory,
// and the CTAs of a split along grid.z form a thread-block cluster of up to
// 8, summed through distributed shared memory in rank order
// (cluster_sum.cuh), then scaled by sx and stored; no f32 workspace, no
// second pass. The first version wrote every split's partials to device
// memory and summed them in a second kernel: two launches and an
// allocation a linear. int4_matmul.w4a8_plan picks the warps along K and
// the cluster (measured: about 16 warps an SM, up to 4 along K in a CTA).
// Larger M runs 32 batch rows per CTA along grid.y and re-reads the weights
// from L2 for each such tile.

// ---------------------------------------------------------------------------
// K4: int4_magic8_requant_kernel replaces ao_tpu/ops/pallas/int4_matmul.py::
// _requant_kernel (launched by _requant_impl, public entry
// int4_magic8_requant_int8_pallas):
//
//   q8[k, n] = clip(round_half_even(u[k, n] * a[G, n] + b[G, n]), -127, 127),
//
// a = scale / s8 and b = bias / s8 per group (f32, formed by the wrapper),
// the multiply and the add rounded separately (__fmul_rn, __fadd_rn: no FMA
// contraction), so the kernel equals its plain version bit for bit. The
// output feeds torch._int_mm as its B operand, which cuBLAS takes as the
// "TN" int8 GEMM when B is column-major: the kernel writes q8 transposed,
// (N, K) row-major, and the wrapper returns the (K, N) view of it.
//
// What bounds it: bytes, 0.5 B read and 1 B written per weight (plus 8 B of
// a and b per g weights), against 3.35 TB/s. The first design spent about
// 10 instructions a weight on the f32 arithmetic (a multiply, an add, a
// rounding, a clamp and a pack per nibble): at 4096 x 14336 about 20 us of
// issue beside a 27.4 us bytes bound, so it reached 53-66 % of the bound.
//
// This design looks the codes up. A (group, column) has only 16 codes, one
// for each u = 0..15, computed once with the same two roundings
// (code_table) and kept as four registers of packed bytes. A magic8 word's
// four low nibbles are four consecutive K rows of plane A's group in one
// column, its four high nibbles plane B's, so each half maps to its four
// output bytes through one table: a prmt over the low eight entries and one
// over the high eight, the nibbles' low three bits as selectors, then a
// byte select on bit 3 (decode_word): about 17 instructions for 8 weights.
// A thread takes 4 columns (one 16-byte load a word row) by 8 word rows of
// one group pair, so each table serves 32 weights.
//
// An item is 256 K rows (32 word rows: whole group pairs) by 64 columns,
// decoded by a CTA of 64 threads (16 columns of four by 4 runs of 8 word
// rows) into a shared-memory tile of each column's 256 bytes along K
// (16-byte chunks swizzled by the column's group of four, so neither the
// decode's 16-byte stores nor the copy-out's loads conflict), then written
// out with 16-byte stores, 16 threads a column's 256 bytes. N % 64 == 0, so
// every tile is whole. One item a CTA: at 80 registers and 16 KB a CTA, a
// dozen CTAs an SM overlap one another's loads and stores. Persistent CTAs,
// each loading the next item's words while it decoded and stored the
// current one (two tiles, 168 registers), were 5-12 % slower at each of the
// W4A8 prefill's large shapes on the H100, and items of 128 columns level or
// slower (PERF.md); int4_matmul.requant_plan counts the CTAs.

#include <math.h>

#include "cluster_sum.cuh"
#include "int4_tiles.cuh"
#include "quant_round.cuh"

namespace {

// K3's group pairs [t_begin, t_end) of one (K/8, N) magic8 word matrix
// and its (K/g, N) s and b, over NT n8 tiles of M valid int8 rows at x: for
// each group G, acc += s * dot_i32(x_G, u_G) + b * sum(x_G) in f32, the row
// sums from one more mma against an A of ones (w4a8_gemv_accumulate's
// arithmetic); with PF, pair t + 1's words and qparams are loaded before
// pair t's products (without it a warp of one pair holds half the
// registers).
template <int KS, int NT, bool PF>
__device__ __forceinline__ void w4a8_pairs_accumulate(
    float (&acc)[2][NT][4], const int8_t* __restrict__ x, int M, int K, int N,
    const int32_t* __restrict__ word, const __nv_bfloat16* __restrict__ s,
    const __nv_bfloat16* __restrict__ b, int t_begin, int t_end, int col) {
  constexpr int G = 32 * KS, WR = G / 4;  // word rows per group pair
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t ones[4] = {kOnes8, kOnes8, kOnes8, kOnes8};
  struct Pair {
    int4 w[2 * KS];
    uint2 sv[2], bv[2];
  };
  auto load = [&](int t, Pair& pr) {
    const int32_t* wbase = word + (size_t)t * WR * N + col;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      pr.w[2 * ks] = ld_16(wbase + (size_t)(8 * ks + tig) * N);
      pr.w[2 * ks + 1] = ld_16(wbase + (size_t)(8 * ks + 4 + tig) * N);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t qoff = (size_t)(2 * t + h) * N + col;
      pr.sv[h] = __ldg(reinterpret_cast<const uint2*>(s + qoff));
      pr.bv[h] = __ldg(reinterpret_cast<const uint2*>(b + qoff));
    }
  };
  auto multiply = [&](int t, const Pair& pr) {
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
        const int4& w0 = pr.w[2 * ks];
        const int4& w1 = pr.w[2 * ks + 1];
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
      const __nv_bfloat16* sh = reinterpret_cast<const __nv_bfloat16*>(&pr.sv[h]);
      const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(&pr.bv[h]);
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
  };
  Pair pa;
  if constexpr (!PF) {
    for (int t = t_begin; t < t_end; ++t) {
      load(t, pa);
      multiply(t, pa);
    }
  } else {
    Pair pb;
    if (t_begin < t_end) load(t_begin, pa);
    for (int t = t_begin; t < t_end; t += 2) {
      if (t + 1 < t_end) load(t + 1, pb);
      multiply(t, pa);
      if (t + 1 < t_end) {
        if (t + 2 < t_end) load(t + 2, pa);
        multiply(t + 1, pb);
      }
    }
  }
}

// K3 (M rows of x, g = 32*KS, NT n8 tiles of batch rows a CTA): grid
// (N / 32, ceil(M / (8 NT)), splits) in clusters of (1, 1, splits), 32 WK
// threads (WK = 1 above 16 rows): CTA x owns the columns 32 x .. + 31, its
// warp w K slice z WK + w, group pairs [slice spp, (slice + 1) spp). The
// CTA's WK slices are summed in shared memory in slice order, then the
// cluster's splits (cluster_sum) in rank order, then scaled by sx.
template <int KS, int NT, bool PF>
__global__ void __launch_bounds__(256)
    int4_w4a8_gemv_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                          const int32_t* __restrict__ word, const __nv_bfloat16* __restrict__ s,
                          const __nv_bfloat16* __restrict__ b, float* __restrict__ out, int M,
                          int K, int N, int spp) {
  constexpr int G = 32 * KS, NV = 8 * NT;
  __shared__ float part[(NV + 7) * 32];             // the splits' partials (cluster_sum)
  __shared__ float red[NT <= 2 ? 7 * NV * 32 : 1];  // the CTA's K slices' partials
  if (gridDim.z > 1) cluster_started();
  const int wk = blockDim.x >> 5, wk_i = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int col = blockIdx.x * 32 + 4 * gid;
  const int m0 = blockIdx.y * 8 * NT;
  const int t0 = (blockIdx.z * wk + wk_i) * spp, t1 = min(t0 + spp, K / (2 * G));
  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;
  w4a8_pairs_accumulate<KS, NT, PF>(acc, x + (size_t)m0 * K, M - m0, K, N, word, s, b, t0, t1,
                                    col);

  float v[NV];  // value (p NT + nt) 4 + e
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[(p * NT + nt) * 4 + e] = acc[p][nt][e];
  if constexpr (NT <= 2) {
    if (wk > 1) {  // the CTA's slices 1 .. WK - 1 into slice 0's warp, in order
      if (wk_i > 0) {
#pragma unroll
        for (int i = 0; i < NV; ++i) red[((wk_i - 1) * NV + i) * 32 + lane] = v[i];
      }
      __syncthreads();
      if (wk_i == 0) {
        for (int q = 1; q < wk; ++q) {
#pragma unroll
          for (int i = 0; i < NV; ++i) v[i] += red[((q - 1) * NV + i) * 32 + lane];
        }
      }
    }
  }
  auto store = [&](int i, float sum) {
    const int e = i & 3, nt = (i >> 2) % NT, p = (i >> 2) / NT;
    const int r = m0 + 2 * tig + (e & 1) + 8 * nt;
    if (r < M) out[(size_t)r * N + col + 2 * p + (e >> 1)] = sum * sx[r];
  };
  if (gridDim.z > 1) {
    cluster_sum(v, part, lane, 32, wk_i == 0, store);
    return;
  }
  if (wk_i != 0) return;
  // the thread's outputs: batch rows m0 + 2*tig + hh (+ 8nt), columns col .. col + 3
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = m0 + 2 * tig + hh + 8 * nt;
      if (r >= M) continue;
      const float sr = sx[r];
      *reinterpret_cast<float4*>(out + (size_t)r * N + col) =
          make_float4(v[nt * 4 + hh] * sr, v[nt * 4 + 2 + hh] * sr,
                      v[(NT + nt) * 4 + hh] * sr, v[(NT + nt) * 4 + 2 + hh] * sr);
    }
}

template <int KS, int NT>
cudaError_t launch_rows(const int8_t* x, const float* sx, const int32_t* word,
                        const __nv_bfloat16* s, const __nv_bfloat16* b, float* out, int M, int K,
                        int N, int wk, int splits, int spp, cudaStream_t st) {
  const dim3 grid(N / 32, (M + 8 * NT - 1) / (8 * NT), splits);
  if (spp > 1)
    return launch_cluster(int4_w4a8_gemv_kernel<KS, NT, true>, grid, 32 * wk, st, x, sx, word, s,
                          b, out, M, K, N, spp);
  return launch_cluster(int4_w4a8_gemv_kernel<KS, NT, false>, grid, 32 * wk, st, x, sx, word, s,
                        b, out, M, K, N, spp);
}

template <int KS>
cudaError_t launch_gemv(const int8_t* x, const float* sx, const int32_t* word,
                        const __nv_bfloat16* s, const __nv_bfloat16* b, float* out, int M, int K,
                        int N, int wk, int splits, int spp, cudaStream_t st) {
  const int pairs = K / (64 * KS), slices = splits * wk;
  if ((wk != 1 && wk != 2 && wk != 4 && wk != 8) || (M > 16 && wk > 1)) return cudaErrorInvalidValue;
  // every CTA along K has pairs (a warp of the last may have none)
  if (N % 32 || splits < 1 || splits > 8 || spp < 1 || (slices - wk) * spp >= pairs ||
      slices * spp < pairs)
    return cudaErrorInvalidValue;
  if (M <= 8) return launch_rows<KS, 1>(x, sx, word, s, b, out, M, K, N, wk, splits, spp, st);
  if (M <= 16) return launch_rows<KS, 2>(x, sx, word, s, b, out, M, K, N, wk, splits, spp, st);
  return launch_rows<KS, 4>(x, sx, word, s, b, out, M, K, N, wk, splits, spp, st);
}

// prmt.b32 in its default mode: byte n of the result is byte s[4n+2:4n] of
// {b, a}, or that byte's sign bit over all eight bits where s[4n+3] is set.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// K4's 16 codes of one (group, column): code u = clip(rint(__fadd_rn(
// __fmul_rn(u, a), b)), -127, 127) in byte u % 4 of t[u / 4]. Clipping to
// +-127 before the rounding (clip(v) + 1.5 * 2^23, quant_round.cuh) gives
// the same integer as clipping after it, since +-127 are integers.
__device__ __forceinline__ void code_table(float a, float b, uint32_t (&t)[4]) {
  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
  uint32_t e[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const float v = __fadd_rn(__fmul_rn((float)u, a), b);
    e[u] = __float_as_uint(__fadd_rn(fminf(fmaxf(v, -127.f), 127.f), kMagic));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = pack_bytes(e[4 * j], e[4 * j + 1], e[4 * j + 2], e[4 * j + 3]);
}

// The eight codes of one magic8 word w through its column's tables: plane A's
// (the low nibbles, group 2t) into qa, plane B's (the high nibbles, group
// 2t + 1) into qb, byte b for in-group row 4i + b. With bytes 1 and 2 of w
// swapped, x | (x >> 12) of x = (the plane's nibbles) & 7 in each byte holds
// nibble b's low three bits in bits 4b .. 4b + 2: the selectors of both
// lookups; the sign-replicating prmt turns each nibble's bit 3 into a byte
// mask that picks the high eight entries' lookup.
__device__ __forceinline__ void decode_word(uint32_t w, const uint32_t (&ta)[4],
                                            const uint32_t (&tb)[4], uint32_t& qa, uint32_t& qb) {
  const uint32_t ws = __byte_perm(w, 0u, 0x3120u);
  const uint32_t xa = ws & 0x07070707u, xb = (ws >> 4) & 0x07070707u;
  const uint32_t sa = xa | (xa >> 12), sb = xb | (xb >> 12);
  const uint32_t ma = prmt(w << 4, 0u, 0xBA98u), mb = prmt(w, 0u, 0xBA98u);
  const uint32_t la = __byte_perm(ta[0], ta[1], sa), ha = __byte_perm(ta[2], ta[3], sa);
  const uint32_t lb = __byte_perm(tb[0], tb[1], sb), hb = __byte_perm(tb[2], tb[3], sb);
  qa = (ha & ma) | (la & ~ma);
  qb = (hb & mb) | (lb & ~mb);
}

constexpr int kRqSlab = 256;  // K rows of a K4 item: 32 word rows, whole group pairs
constexpr int kRqCols = 64;   // columns of a K4 item, one thread each

// K4: one item a CTA of 64 threads, item blockIdx.x: slab s = item % slabs
// (K rows 256 s .. + 255), column tile item / slabs (64 columns). Thread
// (run ch, group cg) = (tid / 16, tid % 16) decodes word rows 32 s + 8 ch
// .. + 7 (one group pair t, in-pair rows i0 .. i0 + 7) of columns n0 .. n0
// + 3, n0 = 64 tile + 4 cg: plane A's 32 bytes of each column at K rows 2 t
// g + 4 i0 .., plane B's g further, into a shared tile of 64 columns by 16
// chunks of 16 bytes, chunk c of column n at slot c ^ ((n / 4) & 7); after
// one barrier thread tid copies out chunk tid % 16 of columns tid / 16 + 4 j.
template <int G>
__global__ void __launch_bounds__(kRqCols)
    int4_magic8_requant_kernel(const int32_t* __restrict__ word, const float* __restrict__ a,
                               const float* __restrict__ b, int8_t* __restrict__ out, int K,
                               int N) {
  constexpr int WR = G / 4, COLS = kRqCols, CG = COLS / 4, CHUNKS = kRqSlab / 16;
  __shared__ uint4 tile[COLS * CHUNKS];
  const int tid = threadIdx.x, cg = tid % CG, ch = tid / CG;
  const int slabs = K / kRqSlab, s = blockIdx.x % slabs, n_tile = blockIdx.x / slabs * COLS;
  const int n0 = n_tile + 4 * cg, r0 = 32 * s + 8 * ch, t = r0 / WR;
  int4 w[8];  // word rows r0 .. r0 + 7, columns n0 .. n0 + 3
  float4 av[2], bv[2];  // a and b of groups 2t and 2t + 1, columns n0 .. n0 + 3
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = ld_16(word + (size_t)(r0 + j) * N + n0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    av[h] = __ldg(reinterpret_cast<const float4*>(a + (size_t)(2 * t + h) * N + n0));
    bv[h] = __ldg(reinterpret_cast<const float4*>(b + (size_t)(2 * t + h) * N + n0));
  }
  const int ca = (2 * t * G + 4 * (r0 % WR) - kRqSlab * s) / 16;  // plane A's first chunk
  const int sw = cg & 7;
#pragma unroll
  for (int ci = 0; ci < 4; ++ci) {
    uint32_t ta[4], tb[4];
    code_table((&av[0].x)[ci], (&bv[0].x)[ci], ta);
    code_table((&av[1].x)[ci], (&bv[1].x)[ci], tb);
    uint32_t qa[8], qb[8];  // planes A's and B's codes, four K rows a word
#pragma unroll
    for (int j = 0; j < 8; ++j) decode_word((uint32_t)(&w[j].x)[ci], ta, tb, qa[j], qb[j]);
    uint4* col = tile + (4 * cg + ci) * CHUNKS;
    col[ca ^ sw] = make_uint4(qa[0], qa[1], qa[2], qa[3]);
    col[(ca + 1) ^ sw] = make_uint4(qa[4], qa[5], qa[6], qa[7]);
    col[(ca + G / 16) ^ sw] = make_uint4(qb[0], qb[1], qb[2], qb[3]);
    col[(ca + G / 16 + 1) ^ sw] = make_uint4(qb[4], qb[5], qb[6], qb[7]);
  }
  __syncthreads();
  const int c = tid % CHUNKS;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int nl = tid / CHUNKS + j * (COLS / CHUNKS), n = n_tile + nl;
    *reinterpret_cast<uint4*>(out + (size_t)n * K + (size_t)kRqSlab * s + 16 * c) =
        tile[nl * CHUNKS + (c ^ ((nl >> 2) & 7))];
  }
}

template <int G>
cudaError_t launch_requant(const int32_t* word, const float* a, const float* b, int8_t* out, int K,
                           int N, cudaStream_t st) {
  const int items = K / kRqSlab * (N / kRqCols);
  int4_magic8_requant_kernel<G><<<items, kRqCols, 0, st>>>(word, a, b, out, K, N);
  return cudaGetLastError();
}

}  // namespace

// K3. x (M, K) int8; sx (M,) f32; word (K/8, N) int32 magic8; s, b (K/g, N)
// bf16; out (M, N) f32. A CTA of 32 columns and wk warps along K (1, 2, 4 or
// 8; 1 above 16 rows), ``splits`` CTAs (at most 8) along K in one cluster,
// ``spp`` group pairs a warp. Needs g in {32, 64, 128}, N % 32 == 0,
// K % (2g) == 0 and 16-byte aligned rows; the Python wrapper checks them.
// Returns the launch's CUDA error.
extern "C" int ao_int4_w4a8(const void* x_, const void* sx_, const void* word_, const void* s_,
                            const void* b_, void* out_, int M, int K, int N, int G, int wk,
                            int splits, int spp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(x_);
  const auto* sx = static_cast<const float*>(sx_);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* s = static_cast<const __nv_bfloat16*>(s_);
  const auto* b = static_cast<const __nv_bfloat16*>(b_);
  auto* out = static_cast<float*>(out_);
  if (M < 1 || K % (2 * G)) return (int)cudaErrorInvalidValue;
  switch (G) {
    case 32: return (int)launch_gemv<1>(x, sx, word, s, b, out, M, K, N, wk, splits, spp, st);
    case 64: return (int)launch_gemv<2>(x, sx, word, s, b, out, M, K, N, wk, splits, spp, st);
    case 128: return (int)launch_gemv<4>(x, sx, word, s, b, out, M, K, N, wk, splits, spp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4. word (K/8, N) int32 magic8; a, b (K/g, N) f32; out (N, K) int8 (the
// transpose of q8). Items of 256 K rows x 64 columns, one a CTA. Needs g in
// {32, 64, 128}, N % 64 == 0, K % 256 == 0 and 16-byte aligned operands;
// the Python wrapper checks them. Returns the launch's CUDA error.
extern "C" int ao_int4_magic8_requant(const void* word_, const void* a_, const void* b_, void* out_,
                                      int K, int N, int G, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* a = static_cast<const float*>(a_);
  const auto* b = static_cast<const float*>(b_);
  auto* out = static_cast<int8_t*>(out_);
  if (K % kRqSlab || N % kRqCols) return (int)cudaErrorInvalidValue;
  switch (G) {
    case 32: return (int)launch_requant<32>(word, a, b, out, K, N, st);
    case 64: return (int)launch_requant<64>(word, a, b, out, K, N, st);
    case 128: return (int)launch_requant<128>(word, a, b, out, K, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
