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
// a and b per g weights), against 3.35 TB/s. A block decodes 32 word rows
// (256 K rows) of 64 columns, reads them coalesced along N, transposes them
// through shared memory (rows padded to 65 words: no bank conflicts on
// either side) and writes 4-byte words coalesced along K.

#include <math.h>

#include "cluster_sum.cuh"
#include "int4_tiles.cuh"

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

// K4: grid (N/64, K/256), 256 threads. Word rows r0 = 32*blockIdx.y .. + 31
// are whole group pairs (g divides 128), so they hold K rows
// 256*blockIdx.y .. + 255: local pair lt = lr / WR, in-pair word row
// i = lr % WR, plane A rows 2*lt*g + 4i .. + 3, plane B rows (2*lt+1)*g + 4i .. + 3.
template <int G>
__global__ void __launch_bounds__(256)
    int4_magic8_requant_kernel(const int32_t* __restrict__ word, const float* __restrict__ a,
                               const float* __restrict__ b, int8_t* __restrict__ out, int K,
                               int N) {
  constexpr int WR = G / 4;
  __shared__ uint32_t tile[64][65];  // [column][4-byte word of the 256 K rows], padded
  const int tx = threadIdx.x & 63, ty = threadIdx.x >> 6;
  const int n = blockIdx.x * 64 + tx;
  const int r0 = blockIdx.y * 32;
  const int pair0 = r0 / WR;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int lr = ty + 4 * j;
    const uint32_t w = (uint32_t)__ldg(word + (size_t)(r0 + lr) * N + n);
    const int lt = lr / WR, i = lr % WR;
    const size_t ga = (size_t)(2 * (pair0 + lt)) * N + n;  // plane A's group; plane B's is next
    const float aa = __ldg(a + ga), ba = __ldg(b + ga);
    const float ab = __ldg(a + ga + N), bb = __ldg(b + ga + N);
    uint32_t qa = 0, qb = 0;
#pragma unroll
    for (int byte = 0; byte < 4; ++byte) {
      const float ua = (float)((w >> (8 * byte)) & 0xFu);
      const float ub = (float)((w >> (8 * byte + 4)) & 0xFu);
      const float va = fminf(fmaxf(rintf(__fadd_rn(__fmul_rn(ua, aa), ba)), -127.f), 127.f);
      const float vb = fminf(fmaxf(rintf(__fadd_rn(__fmul_rn(ub, ab), bb)), -127.f), 127.f);
      qa |= ((uint32_t)(int)va & 0xFFu) << (8 * byte);
      qb |= ((uint32_t)(int)vb & 0xFFu) << (8 * byte);
    }
    tile[tx][lt * (G / 2) + i] = qa;
    tile[tx][lt * (G / 2) + WR + i] = qb;
  }
  __syncthreads();
  uint32_t* out32 = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int idx = threadIdx.x + 256 * j;  // 64 rows (columns n) x 64 words
    const int row = idx >> 6, wi = idx & 63;
    out32[((size_t)(blockIdx.x * 64 + row) * K + (size_t)blockIdx.y * 256) / 4 + wi] = tile[row][wi];
  }
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
// transpose of q8). Needs g in {32, 64, 128}, N % 64 == 0, K % 256 == 0;
// the Python wrapper checks them.
extern "C" int ao_int4_magic8_requant(const void* word_, const void* a_, const void* b_, void* out_,
                                      int K, int N, int G, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* a = static_cast<const float*>(a_);
  const auto* b = static_cast<const float*>(b_);
  auto* out = static_cast<int8_t*>(out_);
  dim3 grid(N / 64, K / 256);
  switch (G) {
    case 32: int4_magic8_requant_kernel<32><<<grid, 256, 0, st>>>(word, a, b, out, K, N); break;
    case 64: int4_magic8_requant_kernel<64><<<grid, 256, 0, st>>>(word, a, b, out, K, N); break;
    case 128: int4_magic8_requant_kernel<128><<<grid, 256, 0, st>>>(word, a, b, out, K, N); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
