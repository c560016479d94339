// MoE grouped int4 matmuls for Hopper (sm_90a): K13 in its two forms.
//
// Replaces the TPU kernels of ao_tpu/ops/pallas/grouped_matmul.py:
//  * int4_grouped_magic_kernel: _grouped_magic_kernel (launched by
//    _int4_grouped_magic_impl, public entry int4_grouped_magic_pallas),
//
//      out[t] = x[t] @ deq(W[e(t)]),  per group G in f32: s*(x_G . q_G) + sum(x_G)*b2,
//
//    x (T, K) bf16, W an (E, K/8, N) int32 stack in the "magic" layout,
//    q = u - 8, s and b2 = b + 8s in bf16 (E, K/g, N); bf16 out. For bf16
//    tinygemm qparams the kernel takes the scale and zero point as they are
//    and forms b2 = bf16(zp + 8s) itself, as K1 does.
//  * int4_grouped_w4a8_kernel: _grouped_w4a8_kernel (launched by
//    _int4_grouped_w4a8_impl, public entry int4_grouped_w4a8_pallas): the
//    same over an (E, K/8, N) "magic8" stack with int8 per-token symmetric
//    activations, per group s*dot_i32(x_G, u_G) + sum(x_G)*b (b not
//    shifted), times sx[t]; f32 out.
//
// e(t) is the expert owning row t: the rows come sorted by expert, expert e
// owning rows [off[e], off[e] + gs[e]) with off the exclusive prefix sum of
// the group sizes gs (E,), which the kernel reads on the device, so nothing
// about the routing goes through the host. The rows must cover [0, T)
// (sum(gs) == T, what moe dispatch gives).
//
// The TPU kernel sums E masked dense products, sum_e 1[e(t) = e] * x[t] @
// deq(W_e), over a (M tiles, N tiles, E) grid with an f32 accumulator that
// lives across the sequential expert axis: E*T*K*N MACs, free while the MXU
// idles at decode. On Hopper blocks run in parallel and nothing carries
// between them, so the design follows the sorted rows instead: block
// (n tile, e) reads expert e's words and scales for its 128 columns and
// multiplies only expert e's rows, in chunks of 8*NT rows (NT n8 tiles of
// batch rows, 8 rows at T <= 8, 16 at T <= 16, 32 above). A block whose
// expert owns no row exits at once, without reading its weights (its
// contribution was an exact zero). Every output row belongs to one expert,
// so each output element is written once: no atomics, no f32 accumulator
// across experts.
//
// Each chunk runs the decode arithmetic of K1 (magic: the swapped mma.sync
// m16n8k16 with the weights as the A operand and x^T as B in n8 row tiles,
// exact nibble decode, group scales in f32 after each group's products) or
// of K3 (magic8: the planes as A fragments of mma.sync m16n8k32.s8, exact
// int32 dots, the row sums of x from an mma against ones): the functions
// magic_gemv_accumulate and w4a8_gemv_accumulate of int4_tiles.cuh, which
// K1 and K3 run too.
//
// What bounds it on the H100: the weight stream of the experts that own a
// row, 0.5 B per weight plus 4 B of s and b2 per g weights, against
// 3.35 TB/s. At Mixtral-8x7B's decode (T = 8 tokens x top-2 = 16 rows,
// E = 8, 4096 x 14336) that is 249.6 MB, 74.5 us a call; at the engine's
// 128-token bucket (T = 256) the 30 GFLOP of products take 30.4 us at
// 989 TFLOP/s, so the call stays bound by bytes. The grid is (N/128) x E
// blocks of 4 warps: 896 for w_gate / w_up and 256 for w_down at E = 8, at
// least two blocks per SM of the 132, each warp with all its 16-byte word
// loads of a super-group (8 KB a warp at g = 128) in flight before it uses
// any. That is the bytes in flight K1 reaches only by splitting K over its
// 8-112 blocks, so K13 does not split K: no partial sums, no second pass.
// An expert with more rows than a chunk re-reads its weights once per
// chunk (from L2 where they are still there). No wgmma or TMA yet.

#include "int4_tiles.cuh"

namespace {

// Rows [lo, hi) of expert e: lo is the sum of the group sizes before e.
__device__ __forceinline__ int2 expert_rows(const int32_t* __restrict__ gs, int e, int T) {
  int lo = 0;
  for (int i = 0; i < e; ++i) lo += __ldg(gs + i);
  return make_int2(min(lo, T), min(lo + __ldg(gs + e), T));
}

// grid (N/128, E), 128 threads; warp w of block (bx, e) owns the columns
// (4*bx + w)*32 .. + 31 of expert e's rows.
template <int KS, int NT>
__global__ void __launch_bounds__(128)
    int4_grouped_magic_kernel(const __nv_bfloat16* __restrict__ x,
                              const int32_t* __restrict__ word, const __nv_bfloat16* __restrict__ s,
                              const __nv_bfloat16* __restrict__ b2,
                              const int32_t* __restrict__ gs, __nv_bfloat16* __restrict__ out,
                              int T, int K, int N, int raw_zp) {
  constexpr int G = 16 * KS;
  const int e = blockIdx.y;
  const int2 rows = expert_rows(gs, e, T);
  if (rows.x >= rows.y) return;  // no row: the block reads nothing
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int col = (blockIdx.x * 4 + warp) * 32 + 4 * gid;
  const size_t ng = K / G;
  word += (size_t)e * (K / 8) * N;
  s += (size_t)e * ng * N;
  b2 += (size_t)e * ng * N;
  for (int r0 = rows.x; r0 < rows.y; r0 += 8 * NT) {
    const int m = rows.y - r0;  // the chunk takes the first 8*NT of them
    float acc[2][NT][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][nt][i] = 0.f;
    magic_gemv_accumulate<KS, NT>(acc, x + (size_t)r0 * K, m, K, N, word, s, b2, 0,
                                  K / (4 * G), col, raw_zp);
    // the thread's outputs: rows r0 + 2*tig + h (+ 8nt), columns col .. col + 3
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * tig + h + 8 * nt;
        if (r >= m) continue;
        *reinterpret_cast<uint2*>(out + (size_t)(r0 + r) * N + col) =
            make_uint2(pack_bf16x2(acc[0][nt][h], acc[0][nt][2 + h]),
                       pack_bf16x2(acc[1][nt][h], acc[1][nt][2 + h]));
      }
  }
}

// grid (N/128, E), 128 threads, as the magic form.
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

template <int KS>
cudaError_t launch_magic(const __nv_bfloat16* x, const int32_t* word, const __nv_bfloat16* s,
                         const __nv_bfloat16* b2, const int32_t* gs, __nv_bfloat16* out, int T,
                         int K, int N, int E, int raw_zp, cudaStream_t st) {
  const dim3 grid(N / 128, E);
  if (T <= 8)
    int4_grouped_magic_kernel<KS, 1><<<grid, 128, 0, st>>>(x, word, s, b2, gs, out, T, K, N, raw_zp);
  else if (T <= 16)
    int4_grouped_magic_kernel<KS, 2><<<grid, 128, 0, st>>>(x, word, s, b2, gs, out, T, K, N, raw_zp);
  else
    int4_grouped_magic_kernel<KS, 4><<<grid, 128, 0, st>>>(x, word, s, b2, gs, out, T, K, N, raw_zp);
  return cudaGetLastError();
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
// (with raw_zp != 0, b2 holds the tinygemm zero point and the kernel forms
// bf16(zp + 8s)); gs (E,) int32 group sizes; out (T, N) bf16. Needs g in
// {16, 32, 64, 128}, N % 128 == 0, K % (4g) == 0 and 16-byte aligned rows;
// the Python wrapper checks them. Returns cudaGetLastError() after the launch.
extern "C" int ao_int4_grouped_magic(const void* x_, const void* word_, const void* s_,
                                     const void* b2_, const void* gs_, void* out_, int T, int K,
                                     int N, int E, int G, int raw_zp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* s = static_cast<const __nv_bfloat16*>(s_);
  const auto* b2 = static_cast<const __nv_bfloat16*>(b2_);
  const auto* gs = static_cast<const int32_t*>(gs_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  switch (G) {
    case 16: return (int)launch_magic<1>(x, word, s, b2, gs, out, T, K, N, E, raw_zp, st);
    case 32: return (int)launch_magic<2>(x, word, s, b2, gs, out, T, K, N, E, raw_zp, st);
    case 64: return (int)launch_magic<4>(x, word, s, b2, gs, out, T, K, N, E, raw_zp, st);
    case 128: return (int)launch_magic<8>(x, word, s, b2, gs, out, T, K, N, E, raw_zp, st);
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
