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
// tensor cores (exact products), which is then scaled by the two block
// scales and added into the running f32 sum: the DeepSeek promotion, so no
// sum ever mixes two blocks' scales. The scales are read by index; the TPU
// kernel's one-hot selection of a scale column (:46-52) and its
// pre-expanded weight scales (:77) exist only because its tiles could not
// be sliced by a dynamic index.
//
// Layout: the weight is stored column-major (Float8Array keeps qdata so),
// i.e. as wt (N, K) row-major, so qx and the weight both hold K
// contiguously: both K-major, as fp8 wgmma asks of both its operands.
//
// What bounds it on the H100, and the two kernels:
//  * decode (M <= 16, fp8_block_gemv_kernel): the weight stream, 1 B per
//    weight plus 4 B per 128 x 128 block, against 3.35 TB/s. Operands are
//    swapped as in the int8 and int4 kernels (weights as A, 16 columns of N
//    per m16 tile of mma.sync m16n8k32 e4m3; qx^T as B, batch rows as the
//    columns of an n8 tile), a warp owns 32 columns, and a thread starts its
//    eight 16-byte weight loads of a k-block before it uses any. Inside a
//    64-wide K window a thread loads 16 consecutive values at offset 16*tig
//    and uses them in two k32 steps j: values 16*tig + 8j .. + 3 as the
//    fragment's logical columns 4*tig .. + 3, and 16*tig + 8j + 4 .. + 7 as
//    columns 16 + 4*tig .. + 3 (the same permutation of K on both operands
//    leaves each block's sum unchanged). The grid splits K by whole k-blocks
//    (grid.z) into f32 partials kept in L2; a second pass sums and rounds
//    them, so that N = 1024 (8 blocks of 128 columns) fills 132 SMs.
//  * prefill (M > 16, fp8_block_tma_kernel): fp8 tensor-core operations,
//    2 M K N against 1979 TFLOP/s dense. A tile is 128 rows of qx by BN =
//    128 (or 64) weight columns, one n-block of sw, walked in k-blocks
//    through a ring of shared-memory stages (tma_ring.cuh), one k-block a
//    stage: the (128 x 128 B) qx tile and the (BN x 128 B) weight tile,
//    each one TMA box with the 128-byte swizzle (one swizzled row is one
//    k-block), beside the stage's 128 sx values and its sw scalar. One
//    persistent CTA an SM walks its tiles row tile first, so the CTAs at
//    work at once share weight tiles, and its next tile's stages stream in
//    while its consumers store the last. Warps 8-11 are the producer
//    warpgroup (40 registers a thread): warp 8 waits for a slot to be free,
//    its lanes cp.async the stage's scales (each lane four rows of sx,
//    strided by K/128 in device memory; lane 0 the sw value), and lane 0
//    starts the two tensor copies. Warpgroups 0 and 1 are the consumers
//    (232 registers a thread), 64 rows of qx each: a stage is four wgmma
//    m64nBNk32 e4m3 x e4m3, both operands from shared memory (descriptors
//    advanced by 32 bytes a step), into a fresh f32 set tmp (scale-d 0 on
//    the first); after wgmma.wait each warp frees the slot and folds acc +=
//    tmp * (sx[row, kb] * sw[kb, nb]), one FMA an accumulator (acc and tmp,
//    64 registers each at BN = 128). A warpgroup's tensor-core queue
//    empties once a stage for its fold; the other warpgroup's wgmma run
//    meanwhile. (A second tmp set, to start the next stage before the fold,
//    made ptxas serialize every wgmma, C7514, and ran 11-20 % slower.) What
//    bounds it: the ring's L2 traffic, 32 KB a stage for 4.2 MFLOP, 6.8-8.1
//    TB/s at the measured times; the fold's FMAs cost 0-24 % (PERF.md).
//    Rows past M are zeros from TMA and are not stored. The tiles and a
//    split of K (f32 partials summed by the second pass) come from
//    fp8_matmul.pick_tiles. The first version (mma.sync m16n8k32, 32 x 128
//    tiles, the weight read from device memory by each warp, qx through a
//    two-slot cp.async buffer) took 2.8-5.1x the time of bf16 cuBLAS on
//    the dequantized operands at M = 1024 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

constexpr int kBlk = 128;         // k-block, and the weight's n-block
constexpr int kBM = 128;          // qx rows of a prefill CTA: two consumer warpgroups of 64
constexpr int kThreads = 384;     // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

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

// D (64 x 64 f32, registers) = A (64 x 32 e4m3, shared memory, K-major) * B
// (64 x 32 e4m3, shared memory, K-major) + (scale_d ? D : 0); 32 accumulators a
// thread.
__device__ __forceinline__ void wgmma_e4m3_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128 f32, registers) = A (64 x 32 e4m3, shared memory, K-major) * B
// (128 x 32 e4m3, shared memory, K-major) + (scale_d ? D : 0); 64 accumulators a
// thread.
__device__ __forceinline__ void wgmma_e4m3_n128(float (&d)[64], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_e4m3(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (BN == 128)
    wgmma_e4m3_n128(d, da, db, scale_d);
  else
    wgmma_e4m3_n64(d, da, db, scale_d);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator accesses across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The wgmma descriptor of a K-major tile of 128-byte rows under the
// 128-byte swizzle, 8-row atoms 1024-aligned: start address >> 4, leading
// byte offset unused (1), 1024 bytes between 8-row atoms, layout type 1.
// Adding 2 advances it by 32 bytes, one k32 step of e4m3.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = tma::smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// A prefill CTA's shared memory: ST stages of the qx tile (kBM rows) and
// the weight tile (BN rows), 128 bytes a row, 1024-aligned; then ST scale
// rows of kBM + 4 floats (sx of the tile's rows, then sw); then the full and
// empty barriers; 1024 bytes to align the base.
template <int BN>
struct TmaTile {
  static constexpr int kX = kBM * kBlk;
  static constexpr int kSlot = kX + BN * kBlk;
  static constexpr int kScaleRow = kBM + 4;
  static constexpr int kStageBytes = kSlot + 4 * kScaleRow + 2 * 8;
  static constexpr int kBudget = 227 * 1024 - 1024;
  static constexpr int kStages = kBudget / kStageBytes < 8 ? kBudget / kStageBytes : 8;
  static constexpr int kSmem = 1024 + kStages * kStageBytes;
  static_assert(kStages >= 3, "the ring needs three stages");
};

// One CTA an SM (grid: min(tiles, SMs)), 384 threads, each CTA walking the
// tiles blockIdx.x, + gridDim.x, ...: tile t is row tile t % mt, column
// tile (t / mt) % nt, split t / (mt nt), so the CTAs at work at once share
// their weight tiles, each read from device memory about once (x, 4 MB at M
// = 1024 and K = 4096, stays in L2), and a CTA's next tile streams in while
// its consumers store the last. Split z takes k-blocks [z per, min((z + 1)
// per, K / 128)). The producer and the consumers walk the same stages in
// the same order: stage i of the CTA in slot i % ST. full[s] counts 33
// arrivals (the producer warp's 32 cp.async arrivals and lane 0's
// expect_tx) and the two boxes' bytes; empty[s] the 8 consumer warps.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    fp8_block_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap, const float* __restrict__ sx,
                         const float* __restrict__ sw, __nv_bfloat16* __restrict__ out,
                         float* __restrict__ ws, int M, int K, int N, int per, int splits) {
  using T = TmaTile<BN>;
  constexpr int ST = T::kStages;
  extern __shared__ uint8_t smem_dyn[];
  uint8_t* ring = smem_dyn + ((1024 - (tma::smem_u32(smem_dyn) & 1023)) & 1023);
  float* scales = reinterpret_cast<float*>(ring + ST * T::kSlot);
  uint64_t* full = reinterpret_cast<uint64_t*>(scales + ST * T::kScaleRow);
  uint64_t* empty = full + ST;

  const int nkb = K / kBlk, nnb = N / kBlk;
  const int mt = (M + kBM - 1) / kBM, nt = N / BN;
  const int tiles = mt * nt * splits;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  // tile t's first row m0, first column n0, first k-block kb0 and k-blocks
  auto tile = [&](int t, int& m0, int& n0, int& kb0) {
    m0 = t % mt * kBM;
    n0 = t / mt % nt * BN;
    kb0 = t / (mt * nt) * per;
    return min(per, nkb - kb0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      tma::mbar_init(full + s, 33);
      tma::mbar_init(empty + s, 8);
    }
    tma::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    tma::regs_dec<kProducerRegs>();
    if (threadIdx.x < 256 + 32) {  // warp 8: the producer
      if (lane == 0) {
        tma::prefetch_map(&xmap);
        tma::prefetch_map(&wmap);
      }
      int slot = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0, kb0;
        const int count = tile(t, m0, n0, kb0);
        const float* swp = sw + (size_t)kb0 * nnb + n0 / kBlk;
        for (int i = 0; i < count; ++i) {
          const int kb = kb0 + i;
          tma::mbar_wait(empty + slot, phase ^ 1);
          float* sc = scales + slot * T::kScaleRow;
#pragma unroll
          for (int j = 0; j < kBM / 32; ++j) {
            const int r = m0 + lane + 32 * j;
            tma::cp_async4(sc + lane + 32 * j, sx + (size_t)(r < M ? r : 0) * nkb + kb, r < M);
          }
          if (lane == 0) tma::cp_async4(sc + kBM, swp + (size_t)i * nnb, true);
          tma::mbar_arrive_cp_async(full + slot);
          if (lane == 0) {
            uint8_t* dst = ring + slot * T::kSlot;
            tma::mbar_arrive_expect_tx(full + slot, T::kSlot);
            tma::load_2d(dst, &xmap, full + slot, kb * kBlk, m0);
            tma::load_2d(dst + T::kX, &wmap, full + slot, kb * kBlk, n0);
          }
          if (++slot == ST) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
      tma::cp_async_wait_all();
    }
  } else {
    tma::regs_inc<kConsumerRegs>();
    // tmp[4i + 2h + e]: local row `row` + 8h of the tile, column 8i + 2
    // (lane % 4) + e
    const int row = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    float acc[BN / 2], tmp[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) tmp[j] = 0.f;
    int slot = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0, kb0;
      const int count = tile(t, m0, n0, kb0);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
      for (int i = 0; i < count; ++i) {
        tma::mbar_wait(full + slot, phase);
        const float* sc = scales + slot * T::kScaleRow;
        const float swv = sc[kBM];
        const float f0 = sc[row] * swv, f1 = sc[row + 8] * swv;
        const uint8_t* src = ring + slot * T::kSlot;
        const uint64_t da = sw128_desc(src + wg * 64 * kBlk), db = sw128_desc(src + T::kX);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlk / 32; ++kk)
          wgmma_e4m3<BN>(tmp, da + 2 * kk, db + 2 * kk, kk > 0);
        wgmma_commit();
        wgmma_wait0();
        fence_acc(tmp);
        if (lane == 0) tma::mbar_arrive(empty + slot);
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[j] = fmaf(tmp[j], (j & 2) ? f1 : f0, acc[j]);
        if (++slot == ST) {
          slot = 0;
          phase ^= 1;
        }
      }

      float* wsz = ws == nullptr ? nullptr : ws + (size_t)(t / (mt * nt)) * M * N;
      const int col = n0 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + row + 8 * h;
          if (r >= M) continue;
          const size_t off = (size_t)r * N + col + 8 * i;
          const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
          if (wsz != nullptr)
            *reinterpret_cast<float2*>(wsz + off) = make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(out + off) = pack_bf16x2(v0, v1);
        }
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

// The prefill launch: the two tensor maps, then the kernel. A map that
// cannot be encoded returns libcuda's CUresult in *map_err.
template <int BN>
cudaError_t launch_tma(const uint8_t* qx, const float* sx, const uint8_t* wt, const float* sw,
                       __nv_bfloat16* out, float* ws, int M, int K, int N, int splits, int per,
                       cudaStream_t st, int* map_err) {
  using T = TmaTile<BN>;
  CUtensorMap xmap, wmap;
  CUresult r = tma::encode_rows_sw128(&xmap, qx, M, K, kBM);
  if (r == CUDA_SUCCESS) r = tma::encode_rows_sw128(&wmap, wt, N, K, BN);
  if (r != CUDA_SUCCESS) {
    *map_err = (int)r;
    return cudaErrorInvalidValue;
  }
  auto kern = fp8_block_tma_kernel<BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kBM - 1) / kBM * (N / BN) * splits;
  kern<<<tiles < sms ? tiles : sms, kThreads, T::kSmem, st>>>(xmap, wmap, sx, sw, out, ws, M, K,
                                                              N, per, splits);
  return cudaGetLastError();
}

}  // namespace

// qx (M, K) e4m3; sx (M, K/128) f32; wt (N, K) e4m3 (the column-major (K, N)
// weight); sw (K/128, N/128) f32; out (M, N) bf16. Tiles from
// fp8_matmul.pick_tiles: bm 16 the decode kernel (M <= 16, bn 128), else
// the prefill kernel's (128, bn), bn 128 or 64; per k-blocks a split, ws
// (splits, M, N) f32 when splits > 1. Needs K % 128 == 0, N % 128 == 0 and
// 16-byte aligned rows; the Python wrapper checks them. Returns
// cudaGetLastError() after the launches, or minus libcuda's CUresult if
// a tensor map could not be encoded (no kernel is launched then).
extern "C" int ao_fp8_blockwise(const void* qx_, const void* sx_, const void* wt_,
                                const void* sw_, void* out_, void* ws_, int M, int K, int N,
                                int bm, int bn, int splits, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qx = static_cast<const uint8_t*>(qx_);
  const auto* sx = static_cast<const float*>(sx_);
  const auto* wt = static_cast<const uint8_t*>(wt_);
  const auto* sw = static_cast<const float*>(sw_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  const int nkb = K / kBlk;
  if (K % kBlk || N % kBlk || M < 1 || per < 1 || splits < 1 || (splits - 1) * per >= nkb ||
      splits * per < nkb || (splits > 1 && ws_ == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bm == 16) {  // the decode kernel
    if (M > 16 || bn != 128) return (int)cudaErrorInvalidValue;
    dim3 grid(N / 128, 1, splits);
    if (M <= 8)
      fp8_block_gemv_kernel<1><<<grid, 128, 0, st>>>(qx, sx, wt, sw, out, ws, M, K, N, per);
    else
      fp8_block_gemv_kernel<2><<<grid, 128, 0, st>>>(qx, sx, wt, sw, out, ws, M, K, N, per);
    err = cudaGetLastError();
  } else if (bm == kBM && (bn == 128 || bn == 64)) {  // the prefill kernel
    int map_err = 0;
    err = bn == 128 ? launch_tma<128>(qx, sx, wt, sw, out, ws, M, K, N, splits, per, st, &map_err)
                    : launch_tma<64>(qx, sx, wt, sw, out, ws, M, K, N, splits, per, st, &map_err);
    if (map_err != 0) return -map_err;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  const size_t mn = (size_t)M * N;
  fp8_block_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, out, mn, splits);
  return (int)cudaGetLastError();
}
