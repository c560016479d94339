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
// operations are ~0.5 % of the tensor cores' time at that rate. As in K1,
// a warp owns 32 columns and loads them with one 16-byte load per word row
// and thread; a thread issues all the word loads of a group pair before it
// uses any; and the grid splits K by whole group pairs (grid.z) into f32
// partials kept in L2, which a second pass sums and scales by sx, so that
// wk/wv (N = 1024, 8 blocks) fill 132 SMs. Larger M runs 32 batch rows per
// block along grid.y and re-reads the weights from L2 for each such tile.
// No wgmma or TMA yet.
//
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

#include "int4_tiles.cuh"

namespace {

// K3 (M rows of x, g = 32*KS, NT n8 tiles of batch rows per block): the
// swapped operands and the warp's 32 columns of int4_tiles.cuh, its
// w4a8_gemv_accumulate over the block's rows and split. grid (N/128,
// ceil(M/(8*NT)), splits), 128 threads. Split z covers group pairs
// [z*spp, (z+1)*spp).
template <int KS, int NT>
__global__ void __launch_bounds__(128)
    int4_w4a8_gemv_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                          const int32_t* __restrict__ word, const __nv_bfloat16* __restrict__ s,
                          const __nv_bfloat16* __restrict__ b, float* __restrict__ out,
                          float* __restrict__ ws, int M, int K, int N, int spp) {
  constexpr int G = 32 * KS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = (blockIdx.x * 4 + warp) * 32;
  const int col = nb + 4 * gid;
  const int m0 = blockIdx.y * 8 * NT;
  const int npairs = K / (2 * G);
  const int t_end = min((int)(blockIdx.z + 1) * spp, npairs);
  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;
  w4a8_gemv_accumulate<KS, NT>(acc, x + (size_t)m0 * K, M - m0, K, N, word, s, b,
                               blockIdx.z * spp, t_end, col);

  // the thread's outputs: batch rows m0 + 2*tig + hh (+ 8nt), columns col .. col + 3
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = m0 + 2 * tig + hh + 8 * nt;
      if (r >= M) continue;
      float4 v = make_float4(acc[0][nt][hh], acc[0][nt][2 + hh], acc[1][nt][hh], acc[1][nt][2 + hh]);
      const size_t off = (size_t)r * N + col;
      if (ws == nullptr) {
        const float sr = sx[r];
        v.x *= sr;
        v.y *= sr;
        v.z *= sr;
        v.w *= sr;
        *reinterpret_cast<float4*>(out + off) = v;
      } else {
        *reinterpret_cast<float4*>(ws + (size_t)blockIdx.z * M * N + off) = v;
      }
    }
}

// Second pass of a split-K launch: out = sx[m] * (sum over splits of ws).
__global__ void int4_w4a8_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ sx,
                                        float* __restrict__ out, int N, size_t mn, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * mn + i];
  out[i] = acc * sx[i / N];
}

template <int KS>
cudaError_t launch_gemv(const int8_t* x, const float* sx, const int32_t* word,
                        const __nv_bfloat16* s, const __nv_bfloat16* b, float* out, float* ws, int M,
                        int K, int N, int splits, int spp, cudaStream_t st) {
  if (M <= 8) {
    dim3 grid(N / 128, 1, splits);
    int4_w4a8_gemv_kernel<KS, 1><<<grid, 128, 0, st>>>(x, sx, word, s, b, out, ws, M, K, N, spp);
  } else if (M <= 16) {
    dim3 grid(N / 128, 1, splits);
    int4_w4a8_gemv_kernel<KS, 2><<<grid, 128, 0, st>>>(x, sx, word, s, b, out, ws, M, K, N, spp);
  } else {
    dim3 grid(N / 128, (M + 31) / 32, splits);
    int4_w4a8_gemv_kernel<KS, 4><<<grid, 128, 0, st>>>(x, sx, word, s, b, out, ws, M, K, N, spp);
  }
  return cudaGetLastError();
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
// bf16; out (M, N) f32; ws (splits, M, N) f32 when splits > 1. Needs
// g in {32, 64, 128}, N % 128 == 0, K % (2g) == 0 and 16-byte aligned
// rows; the Python wrapper checks them. Returns cudaGetLastError() after
// the launches.
extern "C" int ao_int4_w4a8(const void* x_, const void* sx_, const void* word_, const void* s_,
                            const void* b_, void* out_, void* ws_, int M, int K, int N, int G,
                            int splits, int spp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(x_);
  const auto* sx = static_cast<const float*>(sx_);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* s = static_cast<const __nv_bfloat16*>(s_);
  const auto* b = static_cast<const __nv_bfloat16*>(b_);
  auto* out = static_cast<float*>(out_);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  cudaError_t err;
  switch (G) {
    case 32: err = launch_gemv<1>(x, sx, word, s, b, out, ws, M, K, N, splits, spp, st); break;
    case 64: err = launch_gemv<2>(x, sx, word, s, b, out, ws, M, K, N, splits, spp, st); break;
    case 128: err = launch_gemv<4>(x, sx, word, s, b, out, ws, M, K, N, splits, spp, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  const size_t mn = (size_t)M * N;
  int4_w4a8_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, sx, out, N, mn,
                                                                       splits);
  return (int)cudaGetLastError();
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
