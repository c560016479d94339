// Int8 weight-only matmul with a per-column scale, for Hopper (sm_90a): K10.
//
// Replaces the TPU kernel ao_tpu/ops/pallas/int8_matmul.py::_kernel
// (launched by _int8_wo_matmul_impl, public entry int8_wo_matmul_pallas):
//
//   y[m, n] = bf16( s[n] * sum_k x[m, k] * q[k, n] ),
//
// x bf16 (M, K), q int8 (K, N) symmetric per output column, s f32; every
// product is exact (bf16 x int8 -> bf16 exactly, f32 sums on the tensor
// cores), and the scale commutes out of the sum into the epilogue, as in the
// TPU kernel.
//
// Layout: the weight is stored column-major (Int8Array keeps qdata so), i.e.
// as wt (N, K) row-major: each column's K values are contiguous. That is the
// "col" operand of mma.sync m16n8k16 (B as K x N with K contiguous), and
// with operands swapped (weights as A, rows = N) the "row" operand too.
//
// K order inside a 64-wide window: a thread loads 16 consecutive K values
// (16 bytes of int8, or 32 bytes of bf16 x) at offset 16*tig, and uses them
// in four k16 steps j = 0..3, taking the four values 16*tig + 4j .. + 3 as
// the fragment's logical columns 2*tig, 2*tig + 1, 2*tig + 8, 2*tig + 9. A
// dot product is a sum over k, so one permutation of K applied to both
// operands leaves it unchanged, and every load is a whole 16-byte vector.
//
// int8 -> bf16: w ^ 0x80 in the low byte of the f32 2^23 (one byte_perm)
// is 2^23 + 128 + v exactly; subtracting 2^23 + 128 leaves v, and one
// cvt.rn.bf16x2.f32 packs two of them exactly.
//
// What bounds it on the H100, and the two kernels:
//  * decode (M <= 16, int8_wo_gemv_kernel): the weight stream, 1 B per
//    weight, against 3.35 TB/s. The weights are the A operand (16 columns of
//    N as the rows of an m16 tile) and x^T the B operand (batch rows as the
//    columns of an n8 tile), so at M = 8 no half of an m16 tile is spent on
//    rows of x that do not exist. A warp owns 32 columns; per 128-wide K
//    unit each thread issues its eight 16-byte weight loads before it uses
//    any (4 KB a warp in flight). The grid splits K by whole units (grid.z)
//    into f32 partials that stay in the 50 MB L2, and a second pass sums
//    them, scales and rounds, so that wk/wv (N = 1024, 8 blocks of 128
//    columns) fill 132 SMs.
//  * prefill (M > 16, int8_wo_gemm_kernel): tensor-core operations. A block
//    computes 64 rows x 128 columns, each warp 64 x 32 (4 m16 x 4 n8 tiles),
//    so each converted weight fragment feeds four mma.sync. The x tile of a
//    64-wide K chunk is staged in shared memory by cp.async, the next
//    chunk's while the current one is used; the weights are read from
//    device memory (L2 for the other row blocks). No wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnit = 128;  // K values per split unit (the wrapper's unit)
constexpr int kChunk = 64;  // K values per staged x chunk (prefill)
constexpr int kLd = kChunk + 8;  // x tile row, bf16, padded by 16 bytes

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// bytes 2*half and 2*half + 1 of w (signed int8) as bf16x2, exactly
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t w, int half) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + 2 * half));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541u + 2 * half));
  return pack_bf16x2(f0 - 8388736.f, f1 - 8388736.f);
}

__device__ __forceinline__ int4 ld_16(const void* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ uint32_t word(const int4& v, int j) {
  return j == 0 ? (uint32_t)v.x : j == 1 ? (uint32_t)v.y : j == 2 ? (uint32_t)v.z : (uint32_t)v.w;
}

// 16 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Decode kernel (M <= 16, NT = ceil(M/8) n8 tiles of batch rows). grid
// (N/128, 1, splits), 128 threads; warp w owns columns nb = (4*blockIdx.x +
// w)*32 .. + 31 in two m16 tiles: tile p holds columns nb + 16p + gid (rows
// 0..7 of the tile) and nb + 16p + gid + 8 (rows 8..15). Split z covers K
// units [z*ups, (z+1)*ups).
template <int NT>
__global__ void __launch_bounds__(128)
    int8_wo_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wt,
                        const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                        float* __restrict__ ws, int M, int K, int N, int ups) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = (blockIdx.x * 4 + warp) * 32;
  const int units = K / kUnit;
  const int u_end = min((int)(blockIdx.z + 1) * ups, units);

  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;

  for (int u = blockIdx.z * ups; u < u_end; ++u) {
    const int k0 = u * kUnit + 16 * tig;
    int4 w[2][2][2];  // [tile p][row r: gid, gid + 8][window h]
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          w[p][r][h] = ld_16(wt + (size_t)(nb + 16 * p + gid + 8 * r) * K + k0 + 64 * h);
    int4 xv[NT][2][2];  // [nt][window h][16-byte half c]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = gid + 8 * nt;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          xv[nt][h][c] = r < M ? ld_16(x + (size_t)r * K + k0 + 64 * h + 8 * c)
                               : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t w0 = word(w[p][0][h], j), w1 = word(w[p][1][h], j);
          const uint32_t a[4] = {i8x2_bf16x2(w0, 0), i8x2_bf16x2(w1, 0), i8x2_bf16x2(w0, 1),
                                 i8x2_bf16x2(w1, 1)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int4& xc = xv[nt][h][j >> 1];
            const uint32_t b0 = (j & 1) ? (uint32_t)xc.z : (uint32_t)xc.x;
            const uint32_t b1 = (j & 1) ? (uint32_t)xc.w : (uint32_t)xc.y;
            mma_16816(acc[p][nt], a, b0, b1);
          }
        }
      }
  }

  // C fragment e of tile p: column nb + 16p + gid + 8*(e >> 1), batch row
  // 8nt + 2*tig + (e & 1)
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = nb + 16 * p + gid + 8 * (e >> 1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = 8 * nt + 2 * tig + (e & 1);
        if (r >= M) continue;
        const size_t off = (size_t)r * N + n;
        if (ws == nullptr)
          out[off] = __float2bfloat16(acc[p][nt][e] * s[n]);
        else
          ws[(size_t)blockIdx.z * M * N + off] = acc[p][nt][e];
      }
    }
}

// Prefill kernel (M > 16): grid (N/128, ceil(M/64)), 128 threads. Warp w owns
// columns nb = (4*blockIdx.x + w)*32 .. + 31 (n8 tile i: columns nb + 8i ..
// + 7, B column gid) of rows m0 .. m0 + 63 (m16 tile mt: rows m0 + 16mt ..).
// Shared memory: two x chunks of 64 rows x 64 K (bf16, rows padded to kLd).
__global__ void __launch_bounds__(128)
    int8_wo_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wt,
                        const float* __restrict__ s, __nv_bfloat16* __restrict__ out, int M,
                        int K, int N) {
  constexpr int MT = 4;
  __shared__ __align__(16) __nv_bfloat16 xtile[2][64][kLd];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = (blockIdx.x * 4 + warp) * 32;
  const int m0 = blockIdx.y * 64;
  const int nchunks = K / kChunk;

  auto load_tile = [&](int buf, int c) {
    for (int i = threadIdx.x; i < 64 * (kChunk / 8); i += 128) {
      const int r = i / (kChunk / 8), cc = i % (kChunk / 8);
      const bool valid = m0 + r < M;
      const __nv_bfloat16* src = valid ? x + (size_t)(m0 + r) * K + c * kChunk + cc * 8 : x;
      cp_async16(&xtile[buf][r][cc * 8], src, valid);
    }
    cp_async_commit();
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;

  load_tile(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    int4 w[4];  // n8 tile i: column nb + 8i + gid, K values c*64 + 16*tig .. + 15
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = ld_16(wt + (size_t)(nb + 8 * i + gid) * K + c * kChunk + 16 * tig);
    if (c + 1 < nchunks) {
      load_tile((c + 1) & 1, c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t wj = word(w[i], j);
        b[i][0] = i8x2_bf16x2(wj, 0);
        b[i][1] = i8x2_bf16x2(wj, 1);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // rows gid and gid + 8 of the tile, K values 16*tig + 4j .. + 3
        const uint2 lo = *reinterpret_cast<const uint2*>(
            &xtile[c & 1][mt * 16 + gid][16 * tig + 4 * j]);
        const uint2 hi = *reinterpret_cast<const uint2*>(
            &xtile[c & 1][mt * 16 + gid + 8][16 * tig + 4 * j]);
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_16816(acc[mt][i], a, b[i][0], b[i][1]);
      }
    }
    __syncthreads();  // the next iteration's load overwrites this tile
  }

  // C fragment of n8 tile i: columns nb + 8i + 2*tig (c0, c2) and + 1 (c1,
  // c3), rows gid (c0, c1) and gid + 8 (c2, c3)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = nb + 8 * i + 2 * tig;
    const float s0 = s[n], s1 = s[n + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + mt * 16 + gid + 8 * half;
        if (r >= M) continue;
        *reinterpret_cast<uint32_t*>(out + (size_t)r * N + n) =
            pack_bf16x2(acc[mt][i][2 * half] * s0, acc[mt][i][2 * half + 1] * s1);
      }
  }
}

// Second pass of a split-K launch: out = bf16(s[n] * sum over splits of ws).
__global__ void int8_wo_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ s,
                                      __nv_bfloat16* __restrict__ out, int N, size_t mn,
                                      int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * mn + i];
  out[i] = __float2bfloat16(acc * s[i % N]);
}

}  // namespace

// x (M, K) bf16; wt (N, K) int8 (the column-major (K, N) weight); s (N) f32;
// out (M, N) bf16; ws (splits, M, N) f32 when splits > 1 (decode only), ups
// 128-wide K units per split. Needs K % 128 == 0, N % 128 == 0 and 16-byte
// aligned rows; the Python wrapper checks them. Returns cudaGetLastError()
// after the launches.
extern "C" int ao_int8_wo(const void* x_, const void* wt_, const void* s_, void* out_, void* ws_,
                          int M, int K, int N, int splits, int ups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  const auto* wt = static_cast<const int8_t*>(wt_);
  const auto* s = static_cast<const float*>(s_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  if (K % kUnit || N % 128 || M < 1) return (int)cudaErrorInvalidValue;
  if (M > 16) {
    dim3 grid(N / 128, (M + 63) / 64);
    int8_wo_gemm_kernel<<<grid, 128, 0, st>>>(x, wt, s, out, M, K, N);
    return (int)cudaGetLastError();
  }
  dim3 grid(N / 128, 1, splits);
  if (M <= 8)
    int8_wo_gemv_kernel<1><<<grid, 128, 0, st>>>(x, wt, s, out, ws, M, K, N, ups);
  else
    int8_wo_gemv_kernel<2><<<grid, 128, 0, st>>>(x, wt, s, out, ws, M, K, N, ups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  const size_t mn = (size_t)M * N;
  int8_wo_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, s, out, N, mn, splits);
  return (int)cudaGetLastError();
}
