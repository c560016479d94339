// Blockwise-scaled fp8 matmul (DeepSeek-style 1 x 128 activation and
// 128 x 128 weight scales), for Hopper (sm_90a): K17.
//
// Replaces the TPU kernel ao_tpu/ops/pallas/fp8_matmul.py::_kernel
// (launched by _impl, public entry fp8_blockwise_matmul_pallas):
//
//   y[m, n] = bf16( sum_kb ( sum_{k in kb} qx[m, k] * qw[k, n] )
//                          * sx[m, kb] * sw[kb, n / 128] ),
//
// qx e4m3 (M, K), qw e4m3 (K, N), sx f32 (M, K/128), sw f32 (K/128, N/128).
// Each 128-wide k-block's partial product is a fresh f32 sum on the fp8
// tensor cores (mma.sync m16n8k32 e4m3, exact products), which is then
// scaled by the two block scales and added into the running f32 sum: the
// DeepSeek promotion, so no sum ever mixes two blocks' scales. The scales
// are read by index; the TPU kernel's one-hot selection of a scale column
// (:46-52) and its pre-expanded weight scales (:77) exist only because its
// tiles could not be sliced by a dynamic index.
//
// Layout: the weight is stored column-major (Float8Array keeps qdata so),
// i.e. as wt (N, K) row-major, so qx and the weight both hold K
// contiguously, as the "row" and "col" operands of the mma (or, swapped,
// the weight as A and qx^T as B). Inside a 64-wide K window a thread loads
// 16 consecutive values at offset 16*tig and uses them in two k32 steps j:
// values 16*tig + 8j .. + 3 as the fragment's logical columns 4*tig .. + 3,
// and 16*tig + 8j + 4 .. + 7 as columns 16 + 4*tig .. + 3. The same
// permutation of K on both operands leaves each block's sum unchanged.
//
// What bounds it on the H100, and the two kernels:
//  * decode (M <= 16, fp8_block_gemv_kernel): the weight stream, 1 B per
//    weight plus 4 B per 128 x 128 block, against 3.35 TB/s. Operands are
//    swapped as in the int8 and int4 kernels (weights as A, 16 columns of N
//    per m16 tile; qx^T as B, batch rows as the columns of an n8 tile), a
//    warp owns 32 columns, and a thread issues its eight 16-byte weight
//    loads of a k-block before it uses any. The grid splits K by whole
//    k-blocks (grid.z) into f32 partials kept in L2; a second pass sums and
//    rounds them, so that N = 1024 (8 blocks of 128 columns) fills 132 SMs.
//  * prefill (M > 16, fp8_block_gemm_kernel): fp8 tensor-core operations
//    (1979 TFLOP/s dense). A block computes 32 rows x 128 columns, each warp
//    32 x 32 (2 m16 x 4 n8 tiles), and keeps a fresh partial and the
//    running sum per tile; the qx tile of each k-block is staged in shared
//    memory by cp.async, the next block's while the current one is used.
//    No wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 128;       // k-block, and the weight's n-block
constexpr int kLd = kBlk + 16;  // staged qx row, bytes, padded by 16

__device__ __forceinline__ void mma_e4m3(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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

// Decode kernel (M <= 16, NT = ceil(M/8)). grid (N/128, 1, splits), 128
// threads; warp w owns columns nb = (4*blockIdx.x + w)*32 .. + 31 in two
// m16 tiles (tile p: columns nb + 16p + gid and + 8), all in n-block
// blockIdx.x of sw. Split z covers k-blocks [z*bps, (z+1)*bps).
template <int NT>
__global__ void __launch_bounds__(128)
    fp8_block_gemv_kernel(const uint8_t* __restrict__ qx, const float* __restrict__ sx,
                          const uint8_t* __restrict__ wt, const float* __restrict__ sw,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M, int K,
                          int N, int bps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = (blockIdx.x * 4 + warp) * 32;
  const int nkb = K / kBlk, nnb = N / kBlk;
  const int kb_end = min((int)(blockIdx.z + 1) * bps, nkb);

  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;

  for (int kb = blockIdx.z * bps; kb < kb_end; ++kb) {
    const int k0 = kb * kBlk + 16 * tig;
    int4 w[2][2][2];  // [tile p][row r: gid, gid + 8][window h]
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          w[p][r][h] = ld_16(wt + (size_t)(nb + 16 * p + gid + 8 * r) * K + k0 + 64 * h);
    int4 xv[NT][2];
    float sxr[NT][2];  // sx of batch rows 8nt + 2*tig and + 1 (the C columns)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = gid + 8 * nt;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xv[nt][h] = r < M ? ld_16(qx + (size_t)r * K + k0 + 64 * h) : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rc = 8 * nt + 2 * tig + e;
        sxr[nt][e] = rc < M ? sx[(size_t)rc * nkb + kb] : 0.f;
      }
    }
    const float swv = sw[(size_t)kb * nnb + blockIdx.x];
    float part[2][NT][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[p][nt][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t a[4] = {word(w[p][0][h], 2 * j), word(w[p][1][h], 2 * j),
                                 word(w[p][0][h], 2 * j + 1), word(w[p][1][h], 2 * j + 1)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_e4m3(part[p][nt], a, word(xv[nt][h], 2 * j), word(xv[nt][h], 2 * j + 1));
        }
      }
    // promotion: C fragment e is column (n) row gid + 8*(e >> 1) of the
    // tile, batch row 8nt + 2*tig + (e & 1)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[p][nt][e] += part[p][nt][e] * sxr[nt][e & 1] * swv;
  }

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
          out[off] = __float2bfloat16(acc[p][nt][e]);
        else
          ws[(size_t)blockIdx.z * M * N + off] = acc[p][nt][e];
      }
    }
}

// Prefill kernel (M > 16): grid (N/128, ceil(M/32)), 128 threads. Warp w owns
// columns nb = (4*blockIdx.x + w)*32 .. + 31 (n8 tile i: columns nb + 8i ..,
// B column gid) of rows m0 .. m0 + 31 (m16 tile mt). Shared memory: two qx
// k-blocks of 32 rows x 128 bytes (rows padded to kLd).
__global__ void __launch_bounds__(128)
    fp8_block_gemm_kernel(const uint8_t* __restrict__ qx, const float* __restrict__ sx,
                          const uint8_t* __restrict__ wt, const float* __restrict__ sw,
                          __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  constexpr int MT = 2, BM = 16 * MT;
  __shared__ __align__(16) uint8_t xtile[2][BM][kLd];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = (blockIdx.x * 4 + warp) * 32;
  const int m0 = blockIdx.y * BM;
  const int nkb = K / kBlk, nnb = N / kBlk;

  auto load_tile = [&](int buf, int kb) {
    for (int i = threadIdx.x; i < BM * (kBlk / 16); i += 128) {
      const int r = i / (kBlk / 16), cc = i % (kBlk / 16);
      const bool valid = m0 + r < M;
      const uint8_t* src = valid ? qx + (size_t)(m0 + r) * K + kb * kBlk + cc * 16 : qx;
      cp_async16(&xtile[buf][r][cc * 16], src, valid);
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
  for (int kb = 0; kb < nkb; ++kb) {
    int4 w[4][2];  // n8 tile i: column nb + 8i + gid; window h
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w[i][h] = ld_16(wt + (size_t)(nb + 8 * i + gid) * K + kb * kBlk + 64 * h + 16 * tig);
    float sxr[MT][2];  // rows m0 + 16mt + gid and + 8
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + 16 * mt + gid + 8 * half;
        sxr[mt][half] = r < M ? sx[(size_t)r * nkb + kb] : 0.f;
      }
    const float swv = sw[(size_t)kb * nnb + blockIdx.x];
    if (kb + 1 < nkb) {
      load_tile((kb + 1) & 1, kb + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float part[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][i][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // rows gid and gid + 8, K values 64h + 16*tig + 8j .. + 7
          const uint2 lo = *reinterpret_cast<const uint2*>(
              &xtile[kb & 1][mt * 16 + gid][64 * h + 16 * tig + 8 * j]);
          const uint2 hi = *reinterpret_cast<const uint2*>(
              &xtile[kb & 1][mt * 16 + gid + 8][64 * h + 16 * tig + 8 * j]);
          const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_e4m3(part[mt][i], a, word(w[i][h], 2 * j), word(w[i][h], 2 * j + 1));
        }
    // promotion: C fragment e of (mt, i) is row gid + 8*(e >> 1)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][i][e] += part[mt][i][e] * sxr[mt][e >> 1] * swv;
    __syncthreads();  // the next iteration's load overwrites this tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = nb + 8 * i + 2 * tig;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + mt * 16 + gid + 8 * half;
        if (r >= M) continue;
        *reinterpret_cast<uint32_t*>(out + (size_t)r * N + n) =
            pack_bf16x2(acc[mt][i][2 * half], acc[mt][i][2 * half + 1]);
      }
  }
}

// Second pass of a split-K launch: out = bf16(sum over splits of ws).
__global__ void fp8_block_reduce_kernel(const float* __restrict__ ws,
                                        __nv_bfloat16* __restrict__ out, size_t mn, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * mn + i];
  out[i] = __float2bfloat16(acc);
}

}  // namespace

// qx (M, K) e4m3; sx (M, K/128) f32; wt (N, K) e4m3 (the column-major (K, N)
// weight); sw (K/128, N/128) f32; out (M, N) bf16; ws (splits, M, N) f32
// when splits > 1 (decode only), bps k-blocks per split. Needs K % 128 == 0,
// N % 128 == 0 and 16-byte aligned rows; the Python wrapper checks them.
// Returns cudaGetLastError() after the launches.
extern "C" int ao_fp8_blockwise(const void* qx_, const void* sx_, const void* wt_,
                                const void* sw_, void* out_, void* ws_, int M, int K, int N,
                                int splits, int bps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qx = static_cast<const uint8_t*>(qx_);
  const auto* sx = static_cast<const float*>(sx_);
  const auto* wt = static_cast<const uint8_t*>(wt_);
  const auto* sw = static_cast<const float*>(sw_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  if (K % kBlk || N % kBlk || M < 1) return (int)cudaErrorInvalidValue;
  if (M > 16) {
    dim3 grid(N / 128, (M + 31) / 32);
    fp8_block_gemm_kernel<<<grid, 128, 0, st>>>(qx, sx, wt, sw, out, M, K, N);
    return (int)cudaGetLastError();
  }
  dim3 grid(N / 128, 1, splits);
  if (M <= 8)
    fp8_block_gemv_kernel<1><<<grid, 128, 0, st>>>(qx, sx, wt, sw, out, ws, M, K, N, bps);
  else
    fp8_block_gemv_kernel<2><<<grid, 128, 0, st>>>(qx, sx, wt, sw, out, ws, M, K, N, bps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  const size_t mn = (size_t)M * N;
  fp8_block_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, out, mn, splits);
  return (int)cudaGetLastError();
}
