// MoE grouped int4 matmuls for Hopper (sm_90a): K13 in its two forms.
//
// Replaces the TPU kernels of ao_tpu/ops/pallas/grouped_matmul.py:
//  * the magic form: _grouped_magic_kernel (launched by
//    _int4_grouped_magic_impl, public entry int4_grouped_magic_pallas),
//
//      out[t] = x[t] @ deq(W[e(t)]),  per group G in f32: s*(x_G . q_G) + sum(x_G)*b2,
//
//    x (T, K) bf16, W an (E, K/8, N) int32 stack in the "magic" layout,
//    q = u - 8, s and b2 = b + 8s in bf16 (E, K/g, N); bf16 out. For bf16
//    tinygemm qparams the kernels take the scale and zero point as they are
//    and form b2 = bf16(zp + 8s) themselves, as K1 does.
//  * int4_grouped_w4a8_kernel: _grouped_w4a8_kernel (launched by
//    _int4_grouped_w4a8_impl, public entry int4_grouped_w4a8_pallas): the
//    same over an (E, K/8, N) "magic8" stack with int8 per-token symmetric
//    activations, per group s*dot_i32(x_G, u_G) + sum(x_G)*b (b not
//    shifted), times sx[t]; f32 out.
//
// e(t) is the expert owning row t: the rows come sorted by expert, expert e
// owning rows [off[e], off[e] + gs[e]) with off the exclusive prefix sum of
// the group sizes gs (E,), which the kernels read on the device, so nothing
// about the routing goes through the host. The rows must cover [0, T)
// (sum(gs) == T, what moe dispatch gives).
//
// The TPU kernel sums E masked dense products, sum_e 1[e(t) = e] * x[t] @
// deq(W_e), over a (M tiles, N tiles, E) grid with an f32 accumulator that
// lives across the sequential expert axis: E*T*K*N MACs, free while the MXU
// idles at decode, which is why the reference takes it only up to 256 rows.
// On Hopper blocks run in parallel and nothing carries between them, so
// every form here follows the sorted rows instead and multiplies only each
// expert's own rows: T*K*N MACs in all. Every output row belongs to
// one expert, so each output element is written once: no atomics, no f32
// accumulator across experts. An expert that owns no row costs nothing (its
// contribution was an exact zero) and its weights are not read.
//
// What bounds it on the H100: the weight stream of the experts that own a
// row, 0.5 B per weight plus 4 B of s and b2 per g weights, against
// 3.35 TB/s, at decode; the tensor-core operations, 2 T K N against 989
// TFLOP/s, once the experts' rows number in the hundreds (Mixtral's 2048-row
// prefill: 243 us of operations against 97 us of bytes).
//
// The magic form in two kernels:
//  * decode (T <= 16: 8 tokens x top-2): block (n tile of 128, expert e, K
//    split z) runs K1's decode arithmetic on the swapped mma.sync (the
//    weights the A operand, x^T in n8 tiles of the expert's rows) over its
//    run of super-groups, with three changes that cut the instructions a
//    weight costs, the bound being instruction issue and not bytes (K13's
//    w4a8 form, one logic op a fragment register, reaches 76-88 % of the
//    same bound): the n8 tiles are taken from the expert's own rows, not
//    from T (top-2 picks distinct experts, so at T = 16 no expert owns more
//    than 8 rows); the weights go to the tensor cores as 128 + u, one logic
//    op a register, exact in bf16, the offset folded into the bias in f32
//    (acc += s * tmp' + xsum * (b2 - 136 s)); and the row sums of x come
//    from one more mma against an A of ones, in the accumulators' places, in
//    place of pair sums and shuffles. A K split (grid.z, a cluster of up to
//    8 CTAs) is summed in the same launch through distributed shared memory
//    (cluster_sum.cuh).
//  * row tiles (T > 16): the shared wgmma mainloop (mixed_gemm.cuh) with
//    K1's fold Op (magic_op.cuh, plane_q.cuh), as K1's prefill: the weight
//    the register A operand, decoded once per CTA, an expert's rows of x the
//    shared-memory B operand, each group's k16 steps into tmp and folded
//    into acc in f32. CTA (j, n tile) finds its (expert, row tile) from a
//    prefix over gs read on the device (row_tile): j walks the experts'
//    tiles of BM rows in expert order, and the grid's row-tile count is the
//    host's upper bound T / BM + E, whose surplus CTAs exit at once. x rows
//    past the expert's last are zero-filled, stores stop at it. j is the
//    fastest grid index, so the row tiles of one (expert, n tile) run next to
//    each other and its weight tile comes from HBM once, then from L2. A
//    pre-pass writes the row sums of x per group in tile order (the fold
//    reads a tile's sums 16-byte aligned).
//
// The w4a8 form: block (n tile of 128, expert e) runs K3's decode
// arithmetic (the planes as A fragments of mma.sync m16n8k32.s8, exact
// int32 dots, the row sums of x from an mma against ones: the function
// w4a8_gemv_accumulate of int4_tiles.cuh) over the expert's rows, in chunks
// of 8 NT rows; at or below 256 rows only (moe/grouped.py).

#include "cluster_sum.cuh"
#include "int4_tiles.cuh"
#include "plane_q.cuh"

namespace {

// Rows [lo, hi) of expert e: lo is the sum of the group sizes before e.
__device__ __forceinline__ int2 expert_rows(const int32_t* __restrict__ gs, int e, int T) {
  int lo = 0;
  for (int i = 0; i < e; ++i) lo += __ldg(gs + i);
  return make_int2(min(lo, T), min(lo + __ldg(gs + e), T));
}

// Row tile j of a launch: the j-th tile of BM rows in expert order, each
// expert's from its first row on. Its expert e, first row m0 and the
// expert's end hi; e = -1 past the last tile (a surplus CTA).
struct RowTile {
  int e, m0, hi;
};

__device__ __forceinline__ RowTile row_tile(const int32_t* __restrict__ gs, int E, int T, int j,
                                            int bm) {
  int lo = 0;
  for (int e = 0; e < E; ++e) {
    const int n = max(0, min(__ldg(gs + e), T - lo));
    const int tiles = (n + bm - 1) / bm;
    if (j < tiles) return {e, lo + j * bm, lo + n};
    j -= tiles;
    lo += n;
  }
  return {-1, 0, 0};
}

// Plane j of a magic word as bf16x2 (128 + u_low, 128 + u_high): exact, one
// logic op (and a shift for j > 0).
__device__ __forceinline__ uint32_t plane_u(uint32_t w, int j) {
  return ((w >> (4 * j)) & 0x000F000Fu) | 0x43004300u;
}

// K13's decode arithmetic (g = 16*KS, NT n8 tiles of the expert's m rows at
// x) over the super-groups [t_begin, t_end) of one expert's (K/8, N) words
// and (K/g, N) s and b2: per group, tmp' = x_G . (128 + u_G) and xsum =
// sum(x_G) on the tensor cores, then acc += s * tmp' + xsum * (b2 - 136 s)
// in f32 (= s * (x_G . q_G) + xsum * b2, q = u - 8). Threads of a warp call
// it together.
template <int KS, int NT>
__device__ __forceinline__ void magic_rows_accumulate(
    float (&acc)[2][NT][4], const __nv_bfloat16* __restrict__ x, int m, int K, int N,
    const int32_t* __restrict__ word, const __nv_bfloat16* __restrict__ s,
    const __nv_bfloat16* __restrict__ b2, int t_begin, int t_end, int col, int raw_zp) {
  constexpr int G = 16 * KS;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};
  for (int t = t_begin; t < t_end; ++t) {
    const int32_t* wbase = word + (size_t)t * (G / 2) * N + col;
    int4 w[2 * KS];
    uint2 sv[4], bv[4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
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
      float tmp[2][NT][4], xs[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[0][nt][e] = tmp[1][nt][e] = xs[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int k0 = (4 * t + j) * G + 16 * ks + 2 * tig;
        uint32_t b[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int row = gid + 8 * nt;
          b[nt][0] = row < m ? ld_x2(x + (size_t)row * K + k0) : 0u;
          b[nt][1] = row < m ? ld_x2(x + (size_t)row * K + k0 + 8) : 0u;
        }
        const int4& w0 = w[2 * ks];
        const int4& w1 = w[2 * ks + 1];
        const uint32_t a0[4] = {plane_u(w0.x, j), plane_u(w0.y, j), plane_u(w1.x, j),
                                plane_u(w1.y, j)};
        const uint32_t a1[4] = {plane_u(w0.z, j), plane_u(w0.w, j), plane_u(w1.z, j),
                                plane_u(w1.w, j)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_16816(tmp[0][nt], a0, b[nt][0], b[nt][1]);
          mma_16816(tmp[1][nt], a1, b[nt][0], b[nt][1]);
          mma_16816(xs[nt], ones, b[nt][0], b[nt][1]);
        }
      }
      // Fold the group: C fragment e of every tile holds batch row 2 tig +
      // (e & 1), and so does xs (every row of the ones tile is alike).
      const __nv_bfloat16* sh = reinterpret_cast<const __nv_bfloat16*>(&sv[j]);
      const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(&bv[j]);
      float sc[4], bc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[c] = __bfloat162float(sh[c]);
        bc[c] = fmaf(-136.f, sc[c], bias_of(sc[c], bh[c], raw_zp));
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 2 * p + (e >> 1);
            acc[p][nt][e] = fmaf(xs[nt][e & 1], bc[c], fmaf(sc[c], tmp[p][nt][e], acc[p][nt][e]));
          }
    }
  }
}

// The decode block's work at NT n8 tiles: its K split's super-groups, then
// its outputs, straight (one split) or summed over the cluster's splits.
// out points at the expert's first row.
template <int KS, int NT>
__device__ __forceinline__ void magic_rows(const __nv_bfloat16* __restrict__ x,
                                           const int32_t* __restrict__ word,
                                           const __nv_bfloat16* __restrict__ s,
                                           const __nv_bfloat16* __restrict__ b2,
                                           __nv_bfloat16* __restrict__ out, int m, int K, int N,
                                           int per, int raw_zp, float* part) {
  constexpr int G = 16 * KS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int col = (blockIdx.x * 4 + warp) * 32 + 4 * gid;
  const int t0 = blockIdx.z * per, t1 = min(t0 + per, K / (4 * G));
  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;
  magic_rows_accumulate<KS, NT>(acc, x, m, K, N, word, s, b2, t0, t1, col, raw_zp);
  if (gridDim.z == 1) {
    // the thread's outputs: rows 2*tig + h (+ 8nt), columns col .. col + 3
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * tig + h + 8 * nt;
        if (r >= m) continue;
        *reinterpret_cast<uint2*>(out + (size_t)r * N + col) =
            make_uint2(pack_bf16x2(acc[0][nt][h], acc[0][nt][2 + h]),
                       pack_bf16x2(acc[1][nt][h], acc[1][nt][2 + h]));
      }
    return;
  }
  float v[8 * NT];  // value (p NT + nt) 4 + e
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[(p * NT + nt) * 4 + e] = acc[p][nt][e];
  cluster_sum(v, part, threadIdx.x, blockDim.x, true, [&](int i, float sum) {
    const int e = i & 3, nt = (i >> 2) % NT, p = (i >> 2) / NT;
    const int r = 2 * tig + (e & 1) + 8 * nt;
    if (r < m) out[(size_t)r * N + col + 2 * p + (e >> 1)] = __float2bfloat16(sum);
  });
}

// The magic form's decode: grid (N/128, E, splits) in clusters of (1, 1,
// splits), 128 threads; split z takes super-groups [z per, (z + 1) per).
// The expert owns m <= 16 rows (T <= 16): one n8 tile of them up to 8. At
// most 168 registers a thread, three blocks an SM (unbounded, ptxas took
// 175 at g = 128 and the card held two: 17-19 % slower at Mixtral's
// widths; at 128 registers it spills 448 bytes).
template <int KS>
__global__ void __launch_bounds__(128, 3)
    int4_grouped_magic_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                                   const int32_t* __restrict__ word,
                                   const __nv_bfloat16* __restrict__ s,
                                   const __nv_bfloat16* __restrict__ b2,
                                   const int32_t* __restrict__ gs,
                                   __nv_bfloat16* __restrict__ out, int T, int K, int N, int per,
                                   int raw_zp) {
  __shared__ float part[(16 + 7) * 128];  // a K split's partials (cluster_sum)
  const int e = blockIdx.y;
  const int2 rows = expert_rows(gs, e, T);
  if (rows.x >= rows.y) return;  // no row: nothing read; the cluster shares e
  if (gridDim.z > 1) cluster_started();
  const size_t ng = K / (16 * KS);
  word += (size_t)e * (K / 8) * N;
  s += (size_t)e * ng * N;
  b2 += (size_t)e * ng * N;
  x += (size_t)rows.x * K;
  out += (size_t)rows.x * N;
  const int m = rows.y - rows.x;
  if (m <= 8)
    magic_rows<KS, 1>(x, word, s, b2, out, m, K, N, per, raw_zp, part);
  else
    magic_rows<KS, 2>(x, word, s, b2, out, m, K, N, per, raw_zp, part);
}

// The row tiles' pre-pass: xs[G'][v] = the f32 sum of x over group G' of the
// row at place v = j BM + r of the tiles (row m0 + r of tile j; zero past
// its expert's rows), for the tiles that exist. A warp takes 256 values of
// a row (blockIdx.y: which 256); each lane sums 8, and the g / 8 lanes of a
// group combine by shuffles. grid (tiles BM / 4, ceil(K / 256)), 128 threads.
template <int KS>
__global__ void __launch_bounds__(128)
    grouped_xsum_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ gs,
                        float* __restrict__ xs, int E, int T, int K, int bm, int mp) {
  constexpr int G = 16 * KS, LG = G / 8;
  const int v = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int k = blockIdx.y * 256 + 8 * lane;
  const RowTile rt = row_tile(gs, E, T, v / bm, bm);
  if (rt.e < 0) return;  // warp-uniform: no tile reads these sums
  const int m = rt.m0 + v % bm;
  float sum = 0.f;
  if (m < rt.hi && k < K) {
    const int4 c = ld_16(x + (size_t)m * K + k);
    const uint32_t u[4] = {(uint32_t)c.x, (uint32_t)c.y, (uint32_t)c.z, (uint32_t)c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += pair_sum(u[i]);
  }
#pragma unroll
  for (int o = 1; o < LG; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane % LG == 0 && k < K) xs[(size_t)(k / G) * mp + v] = sum;
}

// The magic form's row tiles: grid (T / BM + E, N / 128), 256 threads. CTA
// (j, n tile) runs the mainloop over its row tile of one expert (rows m0 ..
// min(m0 + BM, hi) - 1 of x and out, the expert's words, s and b2); its x
// sums are tile j's in the pre-pass's order.
template <class Op, int BM>
__global__ void __launch_bounds__(256, (mg::Tile<Op, BM, 128>::kMinBlocks))
    int4_grouped_magic_rows_kernel(mg::Problem pb, typename Op::Args args,
                                   const int32_t* __restrict__ gs, int E, size_t wstride,
                                   size_t qstride) {
  const RowTile rt = row_tile(gs, E, pb.M, blockIdx.x, BM);
  if (rt.e < 0) return;  // a surplus CTA: nothing read
  args.word += rt.e * wstride;
  args.q.s += rt.e * qstride;
  args.q.b2 += rt.e * qstride;
  pb.M = rt.hi;
  mg::mainloop<Op, BM, 128>(pb, args, rt.m0, blockIdx.x * BM, blockIdx.y * 128, 0);
}

// grid (N/128, E), 128 threads, as the magic form's decode.
template <int KS, int NT>
__global__ void __launch_bounds__(128)
    int4_grouped_w4a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                             const int32_t* __restrict__ word, const __nv_bfloat16* __restrict__ s,
                             const __nv_bfloat16* __restrict__ b, const int32_t* __restrict__ gs,
                             float* __restrict__ out, int T, int K, int N) {
  constexpr int G = 32 * KS;
  const int e = blockIdx.y;
  const int2 rows = expert_rows(gs, e, T);
  if (rows.x >= rows.y) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int col = (blockIdx.x * 4 + warp) * 32 + 4 * gid;
  const size_t ng = K / G;
  word += (size_t)e * (K / 8) * N;
  s += (size_t)e * ng * N;
  b += (size_t)e * ng * N;
  for (int r0 = rows.x; r0 < rows.y; r0 += 8 * NT) {
    const int m = rows.y - r0;
    float acc[2][NT][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][nt][i] = 0.f;
    w4a8_gemv_accumulate<KS, NT>(acc, x + (size_t)r0 * K, m, K, N, word, s, b, 0,
                                 K / (2 * G), col);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * tig + h + 8 * nt;
        if (r >= m) continue;
        const float sr = sx[r0 + r];
        *reinterpret_cast<float4*>(out + (size_t)(r0 + r) * N + col) =
            make_float4(acc[0][nt][h] * sr, acc[0][nt][2 + h] * sr, acc[1][nt][h] * sr,
                        acc[1][nt][2 + h] * sr);
      }
  }
}

template <class Op, int BM>
cudaError_t launch_rows_tile(const mg::Problem& pb, const typename Op::Args& args,
                             const int32_t* gs, int E, int tiles, size_t wstride, size_t qstride,
                             cudaStream_t st) {
  constexpr int smem = mg::Tile<Op, BM, 128>::L::kSmem;
  auto kern = int4_grouped_magic_rows_kernel<Op, BM>;
  // dynamic shared memory above 48 KB needs the opt-in (per device: every call)
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(tiles, pb.N / 128), 256, smem, st>>>(pb, args, gs, E, wstride, qstride);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_magic(const __nv_bfloat16* x, const int32_t* word, const __nv_bfloat16* s,
                         const __nv_bfloat16* b2, const int32_t* gs, __nv_bfloat16* out,
                         float* xs, int T, int K, int N, int E, int raw_zp, int bm, int splits,
                         int per, cudaStream_t st) {
  constexpr int G = 16 * KS;
  if (bm == 0) {  // decode
    const int nsg = K / (4 * G);
    if (T > 16 || splits < 1 || splits > 8 || per < 1 || (splits - 1) * per >= nsg ||
        splits * per < nsg)
      return cudaErrorInvalidValue;
    return launch_cluster(int4_grouped_magic_gemv_kernel<KS>, dim3(N / 128, E, splits), 128, st,
                          x, word, s, b2, gs, out, T, K, N, per, raw_zp);
  }
  if (xs == nullptr || (bm != 64 && bm != 128)) return cudaErrorInvalidValue;
  const int tiles = T / bm + E, mp = tiles * bm;
  grouped_xsum_kernel<KS><<<dim3(mp / 4, (K + 255) / 256), 128, 0, st>>>(x, gs, xs, E, T, K, bm,
                                                                          mp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using Op = mg::MagicOp<PlaneQ, G>;
  const mg::Problem pb{x, out, nullptr, T, K, N, K / mg::kBK, K / mg::kBK};
  const typename Op::Args args{word, {s, b2, xs, mp, raw_zp}};
  const size_t wstride = (size_t)(K / 8) * N, qstride = (size_t)(K / G) * N;
  if (bm == 64) return launch_rows_tile<Op, 64>(pb, args, gs, E, tiles, wstride, qstride, st);
  return launch_rows_tile<Op, 128>(pb, args, gs, E, tiles, wstride, qstride, st);
}

template <int KS>
cudaError_t launch_w4a8(const int8_t* x, const float* sx, const int32_t* word,
                        const __nv_bfloat16* s, const __nv_bfloat16* b, const int32_t* gs,
                        float* out, int T, int K, int N, int E, cudaStream_t st) {
  const dim3 grid(N / 128, E);
  if (T <= 8)
    int4_grouped_w4a8_kernel<KS, 1><<<grid, 128, 0, st>>>(x, sx, word, s, b, gs, out, T, K, N);
  else if (T <= 16)
    int4_grouped_w4a8_kernel<KS, 2><<<grid, 128, 0, st>>>(x, sx, word, s, b, gs, out, T, K, N);
  else
    int4_grouped_w4a8_kernel<KS, 4><<<grid, 128, 0, st>>>(x, sx, word, s, b, gs, out, T, K, N);
  return cudaGetLastError();
}

}  // namespace

// Magic form. x (T, K) bf16; word (E, K/8, N) int32; s, b2 (E, K/g, N) bf16
// (with raw_zp != 0, b2 holds the tinygemm zero point and the kernels form
// bf16(zp + 8s)); gs (E,) int32 group sizes; out (T, N) bf16. bm 0: the
// decode kernel (T <= 16), its K split in ``splits`` clusters' ranks of
// ``per`` super-groups (4g K values) each; bm 64 or 128: the row tiles of bm
// rows, xs (K/g, (T / bm + E) bm) f32 scratch for the row sums of x. Needs
// g in {16, 32, 64, 128}, N % 128 == 0, K % (4g) == 0 and 16-byte aligned
// rows; the Python wrapper checks them. Returns the launches' CUDA error.
extern "C" int ao_int4_grouped_magic(const void* x_, const void* word_, const void* s_,
                                     const void* b2_, const void* gs_, void* out_, void* xs_,
                                     int T, int K, int N, int E, int G, int raw_zp, int bm,
                                     int splits, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* s = static_cast<const __nv_bfloat16*>(s_);
  const auto* b2 = static_cast<const __nv_bfloat16*>(b2_);
  const auto* gs = static_cast<const int32_t*>(gs_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  auto* xs = static_cast<float*>(xs_);
  if (T < 1 || N % 128 || K % (4 * G)) return (int)cudaErrorInvalidValue;
  switch (G) {
    case 16:
      return (int)launch_magic<1>(x, word, s, b2, gs, out, xs, T, K, N, E, raw_zp, bm, splits,
                                  per, st);
    case 32:
      return (int)launch_magic<2>(x, word, s, b2, gs, out, xs, T, K, N, E, raw_zp, bm, splits,
                                  per, st);
    case 64:
      return (int)launch_magic<4>(x, word, s, b2, gs, out, xs, T, K, N, E, raw_zp, bm, splits,
                                  per, st);
    case 128:
      return (int)launch_magic<8>(x, word, s, b2, gs, out, xs, T, K, N, E, raw_zp, bm, splits,
                                  per, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// W4A8 form. x (T, K) int8; sx (T,) f32; word (E, K/8, N) int32 magic8;
// s, b (E, K/g, N) bf16; gs (E,) int32; out (T, N) f32, scaled by sx. Needs
// g in {32, 64, 128}, N % 128 == 0, K % (2g) == 0 and 16-byte aligned rows;
// the Python wrapper checks them. Returns cudaGetLastError() after the launch.
extern "C" int ao_int4_grouped_w4a8(const void* x_, const void* sx_, const void* word_,
                                    const void* s_, const void* b_, const void* gs_, void* out_,
                                    int T, int K, int N, int E, int G, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(x_);
  const auto* sx = static_cast<const float*>(sx_);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* s = static_cast<const __nv_bfloat16*>(s_);
  const auto* b = static_cast<const __nv_bfloat16*>(b_);
  const auto* gs = static_cast<const int32_t*>(gs_);
  auto* out = static_cast<float*>(out_);
  switch (G) {
    case 32: return (int)launch_w4a8<1>(x, sx, word, s, b, gs, out, T, K, N, E, st);
    case 64: return (int)launch_w4a8<2>(x, sx, word, s, b, gs, out, T, K, N, E, st);
    case 128: return (int)launch_w4a8<4>(x, sx, word, s, b, gs, out, T, K, N, E, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
