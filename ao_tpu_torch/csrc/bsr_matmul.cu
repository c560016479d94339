// Block-sparse (BSR) weight times a dense activation, for Hopper (sm_90a): K18.
//
// Replaces the TPU kernel ao_tpu/ops/pallas/bsr_matmul.py::_kernel (launched
// by _impl, public entry bsr_matmul_pallas):
//
//   y (M, N) bf16 = x (M, K) bf16 @ W (K, N),
//
// W in BSR form (BlockSparseArray): nnz blocks of b x b bf16 values, block i
// at block row row_indices[i] (along K) and block column col_indices[i]
// (along N), sorted by (col, row). Only the live blocks are read.
//
// Design. The TPU kernel runs its grid in order and keeps an output tile in
// VMEM across the contiguous run of its column's blocks, adding each block's
// product into a bf16 tile. Here blocks run in parallel: one CTA per (64-row
// M tile, output column block) finds its column's run [lo, hi) by a binary
// search in the sorted col_indices, so no atomics and no extra device pass;
// the result is deterministic. Per block it copies the x tile (64 x b, the
// columns of block row row_indices[i]) and the b x b value block into shared
// memory with cp.async, the next block's while the current one is used
// (two stages), and multiplies with mma.sync m16n8k16 (bf16 in, f32
// accumulators): ldmatrix for the row-major x tile, ldmatrix.trans for the
// row-major (K, N) value block. It rounds to bf16 once, at the end (the TPU
// kernel rounds once per block). A column without blocks writes zeros.
// Four warps, 2 x 2 over the 64 x b output tile; b in {32, 64, 128}.
//
// What bounds it on the H100 (the reference's own cost model): bytes
// nnz*b*b*2 + M*K*2 + M*N*2 at 3.35 TB/s against operations 2*M*b*b*nnz at
// 989 TFLOP/s; at ViT-L's MLP (M = 3152, b = 64, 10 % of the blocks) the
// bytes, most of them the output's. Each CTA re-reads its x tile for every
// block of its column, so x is read about nnz*b/K times over (from L2); no
// wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;        // rows of x per CTA
constexpr int kThreads = 128;  // four warps, 2 x 2 over the output tile

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// first index i in [0, n) with a[i] >= v (a sorted ascending), else n
__device__ __forceinline__ int first_at_least(const int* __restrict__ a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int B>
__host__ __device__ constexpr int stage_elems() {
  return (kTM + B) * (B + 8);  // x tile and value block, rows padded by 16 bytes
}

// grid (ceil(M/64), N/B), 128 threads, dynamic shared memory
// 2 * stage_elems<B>() bf16. Warp w owns output rows 32*(w >> 1) .. + 31 of
// the tile (two m16 tiles) and columns (B/2)*(w & 1) .. + B/2 - 1 (B/16 n8
// tiles) of the column block.
template <int B>
__global__ void __launch_bounds__(kThreads)
    bsr_matmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ vals,
                      const int* __restrict__ rows, const int* __restrict__ cols,
                      __nv_bfloat16* __restrict__ out, int M, int K, int N, int nnz) {
  constexpr int LD = B + 8;      // shared row, bf16
  constexpr int CH = B / 8;      // 16-byte chunks per row
  constexpr int NT = B / 16;     // n8 tiles per warp
  constexpr int XS = kTM * LD;   // x tile, elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int m0 = blockIdx.x * kTM, c = blockIdx.y;
  const int lo = first_at_least(cols, nnz, c), hi = first_at_least(cols, nnz, c + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * (B / 2);
  // ldmatrix: lane supplies line (lane & 7) of 8x8 matrix lane >> 3; matrix
  // j covers rows (k for the values) 8*(j & 1) .. and columns 8*(j >> 1) ..
  const int ld_row = (lane & 7) + 8 * ((lane >> 3) & 1), ld_col = 8 * (lane >> 4);

  auto load = [&](int stage, int i) {
    __nv_bfloat16* xs = smem + stage * stage_elems<B>();
    __nv_bfloat16* vs = xs + XS;
    const int kb = __ldg(rows + i) * B;
    for (int t = threadIdx.x; t < kTM * CH; t += kThreads) {
      const int r = t / CH, cc = t % CH;
      const bool valid = m0 + r < M;
      const __nv_bfloat16* src = valid ? x + (size_t)(m0 + r) * K + kb + cc * 8 : x;
      cp_async16(xs + r * LD + cc * 8, src, valid);
    }
    const __nv_bfloat16* vb = vals + (size_t)i * B * B;
    for (int t = threadIdx.x; t < B * CH; t += kThreads) {
      const int r = t / CH, cc = t % CH;
      cp_async16(vs + r * LD + cc * 8, vb + r * B + cc * 8, true);
    }
    cp_async_commit();
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  if (lo < hi) load(0, lo);
  for (int i = lo; i < hi; ++i) {
    const int s = (i - lo) & 1;
    if (i + 1 < hi) {
      load(s ^ 1, i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* xs = smem + s * stage_elems<B>();
    const __nv_bfloat16* vs = xs + XS;
#pragma unroll
    for (int kk = 0; kk < B; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], xs + (wm + 16 * mt + ld_row) * LD + kk + ld_col);
      uint32_t b[NT][2];
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, vs + (kk + ld_row) * LD + wn + 16 * p + ld_col);
        b[2 * p][0] = r4[0];
        b[2 * p][1] = r4[1];
        b[2 * p + 1][0] = r4[2];
        b[2 * p + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_16816(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  // C fragment of (mt, nt): rows gid (c0, c1) and gid + 8 (c2, c3), columns
  // 2*tig and 2*tig + 1 of the n8 tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + 16 * mt + gid + 8 * h;
        if (r >= M) continue;
        const int n = c * B + wn + 8 * nt + 2 * tig;
        *reinterpret_cast<uint32_t*>(out + (size_t)r * N + n) =
            pack_bf16x2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

template <int B>
int launch(const __nv_bfloat16* x, const __nv_bfloat16* vals, const int* rows, const int* cols,
           __nv_bfloat16* out, int M, int K, int N, int nnz, cudaStream_t st) {
  const int smem = 2 * stage_elems<B>() * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(bsr_matmul_kernel<B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + kTM - 1) / kTM, N / B);
  bsr_matmul_kernel<B><<<grid, kThreads, smem, st>>>(x, vals, rows, cols, out, M, K, N, nnz);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16; vals (nnz, b, b) bf16; rows, cols (nnz) int32, sorted by
// (col, row); out (M, N) bf16. Needs b in {32, 64, 128}, K % b == 0,
// N % b == 0, N / b <= 65535 and 16-byte aligned operands; the Python
// wrapper checks them. Returns cudaGetLastError() after the launch.
extern "C" int ao_bsr_matmul(const void* x_, const void* vals_, const void* rows_,
                             const void* cols_, void* out_, int M, int K, int N, int nnz, int b,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  const auto* vals = static_cast<const __nv_bfloat16*>(vals_);
  const auto* rows = static_cast<const int*>(rows_);
  const auto* cols = static_cast<const int*>(cols_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  if (M < 1 || K % b || N % b || N / b > 65535) return (int)cudaErrorInvalidValue;
  switch (b) {
    case 32:
      return launch<32>(x, vals, rows, cols, out, M, K, N, nnz, st);
    case 64:
      return launch<64>(x, vals, rows, cols, out, M, K, N, nnz, st);
    case 128:
      return launch<128>(x, vals, rows, cols, out, M, K, N, nnz, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
