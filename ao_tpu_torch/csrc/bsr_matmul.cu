// Block-sparse (BSR) weight times a dense activation, for Hopper (sm_90a): K18.
//
// Replaces the TPU kernel ao_tpu/ops/pallas/bsr_matmul.py::_kernel (launched
// by _impl, public entry bsr_matmul_pallas):
//
//   y (M, N) bf16 = x (M, K) bf16 @ W (K, N),
//
// W in BSR form (BlockSparseArray): nnz blocks of b x b bf16 values, block i
// at block row row_indices[i] (along K) and block column col_indices[i]
// (along N), sorted by (col, row). Only the live blocks are read; each
// column's block products are summed in f32 and rounded to bf16 once; a
// column of padding blocks comes out 0. No atomics: the bits are the same
// from run to run.
//
// What bounds it on the H100: bytes nnz b^2 2 + M K 2 + M N 2 against 3.35
// TB/s (most of them the output at ViT-L's MLP, M = 3152, b = 64, 10 % of
// the blocks), or operations 2 M b^2 nnz against 989 TFLOP/s (b = 128 with
// half the blocks, or every block). The design (the TMA ring of
// tma_ring.cuh, as K17's prefill):
//
// * Work items are (128-row tile of x, output column block c), columns
//   outer, so that the CTAs at work at once share a column's value blocks
//   in L2 (x stays in L2 across columns). A column's blocks are the run
//   [colptr[c], colptr[c + 1]) of an (N/b + 1) prefix that the wrapper
//   builds on the device once per weight: two loads, no search, before the
//   first copy. Persistent CTAs walk items blockIdx.x, + gridDim.x, ...:
//   two an SM at b <= 64, one at b = 128 (bsr_matmul.launch_plan).
// * Where the items are too few to fill the card and the runs are long
//   (two blocks a rank or more), the S CTAs of a cluster (S = 2 or 4) take
//   one item and split its run: rank r the blocks [lo + r per, lo + (r + 1)
//   per). After the mainloop every rank but 0 stores its f32 partials into
//   rank 0's ring (distributed shared memory, between two cluster
//   barriers) and rank 0 adds them in rank order.
// * Warp 8 is the producer: per block it waits for a free stage and starts
//   the TMA copies of the x box (the tile's rows, the b columns of block
//   row row_indices[i]; rows past M land as zeros and are never read) and
//   of the value block (a 3-D map over values (nnz, b, b)), both in boxes
//   of 128-byte rows under the 128-byte swizzle (b = 64, 128; b = 32: 64-byte
//   rows, the 64-byte swizzle). A stage's full barrier completes on its
//   bytes; its empty barrier on the 8 consumer warps.
// * Consumer warpgroups 0 and 1 (64 rows each) issue wgmma m64n{b}k16, f32
//   accumulators: x (A) K-major, the value block (B) row-major (K, N), read
//   as an MN-major B with the transpose flag (as attn_mainloop.cuh reads V),
//   no transposed copy. A stage's wgmma group stays in flight while the
//   next stage's is issued; the stage is freed when the group retires.
// * Epilogue: each warpgroup rounds its 64 x b tile to bf16 into its own
//   swizzled shared-memory tile and one thread stores it by TMA (rows past
//   M clipped), so the store runs under the next item's mainloop.
// The first version (a CTA per (64-row tile, column), two binary searches
// over col_indices, a two-stage cp.async ring into mma.sync, scattered
// 4-byte stores) took 3.9x cuBLAS on a dense weight (PERF.md).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "cluster_sum.cuh"
#include "tma_ring.cuh"

namespace {

constexpr int kBM = 128;         // rows of an item: two consumer warpgroups of 64
constexpr int kThreads = 288;    // consumer warpgroups 0 and 1, producer warp 8
constexpr int kMaxSplitAny = 4;  // CTAs of a cluster that split a column's run
constexpr int kSmemMax = 232448;  // shared memory a block can have (227 KB)

// Shared memory of a CTA at block size B, 1024-aligned: ST stages of the x
// box(es) (128 rows) and the value block; the two warpgroups' output tiles;
// the full and empty barriers. At b <= 64 two CTAs share an SM (one's
// epilogue under the other's mainloop: 12 % less time at ViT-L's w1 than one
// CTA with 8 stages), at b = 128 one.
template <int B>
struct Tile {
  static constexpr int kCtasPerSM = B <= 64 ? 2 : 1;
  static constexpr bool kSw128 = B >= 64;        // else the 64-byte swizzle
  static constexpr int kBoxCols = kSw128 ? 64 : 32;
  static constexpr int kRowBytes = 2 * kBoxCols;  // a swizzled box row
  static constexpr int kBoxes = B / kBoxCols;     // boxes across b columns
  static constexpr int kXBox = kBM * kRowBytes;
  static constexpr int kVBox = B * kRowBytes;
  static constexpr int kX = kBoxes * kXBox;
  static constexpr int kStage = kX + kBoxes * kVBox;
  static constexpr int kOutWG = kBoxes * 64 * kRowBytes;
  static constexpr int kOut = 2 * kOutWG;
  static constexpr int kFixed = 1024 + kOut + 2 * 8 * 8;
  // an SM's 228 KB, less 1 KB each CTA keeps, shared by kCtasPerSM CTAs
  static constexpr int kBudget = kCtasPerSM == 1 ? kSmemMax : (233472 - 2048) / 2;
  static constexpr int kFit = (kBudget - kFixed) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kSmem = 1024 + kStages * kStage + kOut + 2 * 8 * kStages;
  static constexpr int kRecv = 256 * (B / 2) * 4;  // a rank's partials, 256 threads
  // the CTAs a cluster may split a run over: the peers' partials fit the ring
  static constexpr int kMaxSplit =
      (kMaxSplitAny - 1) * kRecv <= kStages * kStage ? kMaxSplitAny : 2;
  static_assert(kStages >= 3, "the ring needs three stages");
  static_assert((kMaxSplit - 1) * kRecv <= kStages * kStage, "the partials fit the ring");
};

// D (64 x 32 f32) = A (64 x 16, shared memory, K-major) B (16 x 32, shared
// memory, MN-major: the transpose flag) + (scale_d ? D : 0); 16 accumulators a
// thread.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64 f32) = A (64 x 16, shared memory, K-major) B (16 x 64, shared
// memory, MN-major: the transpose flag) + (scale_d ? D : 0); 32 accumulators a
// thread.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128 f32) = A (64 x 16, shared memory, K-major) B (16 x 128, shared
// memory, MN-major: the transpose flag) + (scale_d ? D : 0); 64 accumulators a
// thread.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int B>
__device__ __forceinline__ void mma(float (&d)[B / 2], uint64_t da, uint64_t db) {
  if constexpr (B == 128)
    wgmma_n128(d, da, db, 1);
  else if constexpr (B == 64)
    wgmma_n64(d, da, db, 1);
  else
    wgmma_n32(d, da, db, 1);
}

// Keeps the compiler from moving accumulator accesses across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptors of a swizzled tile, 8-row atoms aligned (1024 bytes for the
// 128-byte swizzle, layout type 1; 512 for the 64-byte one, type 2): start
// address >> 4; the stride between 8-row atoms (8 rows of kRowBytes) in the
// stride field. x (A) is K-major: a k16 step inside a row adds 32 bytes (2).
// The value block (B) is MN-major: its rows are k, its 64 (or 32) columns a
// box row; the leading field holds the stride between boxes along N (b = 128:
// two boxes), and a k16 step adds 16 rows.
template <int B>
__device__ __forceinline__ uint64_t desc_a(const void* tile) {
  using T = Tile<B>;
  const uint64_t addr = tma::smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(8 * T::kRowBytes / 16) << 32) |
         ((T::kSw128 ? 1ull : 2ull) << 62);
}
template <int B>
__device__ __forceinline__ uint64_t desc_b(const void* tile) {
  using T = Tile<B>;
  const uint64_t addr = tma::smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(T::kVBox / 16) << 16) |
         ((uint64_t)(8 * T::kRowBytes / 16) << 32) | ((T::kSw128 ? 1ull : 2ull) << 62);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(tma::smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read0() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// A warpgroup's 64 x B tile (acc[4i + 2h + e]: row 16 (warp % 4) + lane / 4
// + 8h, column 8i + 2 (lane % 4) + e) rounded to bf16 into its swizzled
// tile `o` and stored by TMA at (column n0, row m0); rows past M are
// clipped by the map. Thread 0 of the warpgroup (tid 0) issues the store
// and, before the tile is written again, waits until it has been read.
template <int B>
__device__ __forceinline__ void store_tile(const float (&acc)[B / 2], uint8_t* o,
                                           const CUtensorMap* omap, int n0, int m0, int tid,
                                           int wg) {
  using T = Tile<B>;
  constexpr int kChunks = T::kBoxCols / 8;  // 16-byte chunks of a box row
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  if (tid == 0) bulk_wait_read0();
  wg_barrier(wg);
#pragma unroll
  for (int i = 0; i < B / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * (tid >> 5) + gid + 8 * h, c = i % kChunks;
      const int sw = T::kSw128 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
      uint8_t* dst = o + (i / kChunks) * 64 * T::kRowBytes + r * T::kRowBytes + sw * 16 + 4 * tig;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  fence_proxy_async();
  wg_barrier(wg);
  if (tid == 0) {
#pragma unroll
    for (int bx = 0; bx < T::kBoxes; ++bx)
      store_2d(omap, o + bx * 64 * T::kRowBytes, n0 + bx * T::kBoxCols, m0);
    bulk_commit();
  }
}

// grid: `ctas` CTAs, clusters of S along x (S = 1: none); 288 threads.
// Item t: column c = t / mt, rows m0 = (t % mt) 128. Cluster q (CTAs q S ..
// q S + S - 1) walks items q, q + gridDim.x / S, ...; at S > 1 the launch
// gives each cluster exactly one item. The producer and the consumers walk
// the same blocks in the same order: stage j of the CTA in slot j % ST.
template <int B>
__global__ void __launch_bounds__(kThreads, Tile<B>::kCtasPerSM)
    bsr_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap, const int* __restrict__ rows,
                   const int* __restrict__ colptr, int M, int mt, int items, int xrows, int S) {
  using T = Tile<B>;
  constexpr int ST = T::kStages;
  extern __shared__ uint8_t smem_dyn[];
  uint8_t* ring = smem_dyn + ((1024 - (tma::smem_u32(smem_dyn) & 1023)) & 1023);
  uint8_t* outs = ring + ST * T::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + T::kOut);
  uint64_t* empty = full + ST;
  const int rank = blockIdx.x % S, cid = blockIdx.x / S, ncl = gridDim.x / S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // item t: its first row, its column, and this rank's blocks [a, e)
  auto part = [&](int t, int& m0, int& c, int& a, int& e) {
    c = t / mt;
    m0 = (t - c * mt) * kBM;
    const int lo = __ldg(colptr + c), hi = __ldg(colptr + c + 1);
    const int per = (hi - lo + S - 1) / S;
    a = min(lo + rank * per, hi);
    e = min(a + per, hi);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      tma::mbar_init(full + s, 1);
      tma::mbar_init(empty + s, 8);
    }
    tma::mbar_init_fence();
  }
  __syncthreads();

  float acc[B / 2];
  if (warp == 8) {  // the producer
    if (lane == 0) {
      tma::prefetch_map(&xmap);
      tma::prefetch_map(&vmap);
      const uint32_t bytes = T::kBoxes * (xrows * T::kRowBytes + T::kVBox);
      int slot = 0;
      uint32_t phase = 0;
      for (int t = cid; t < items; t += ncl) {
        int m0, c, a, e;
        part(t, m0, c, a, e);
        for (int i = a; i < e; ++i) {
          const int k0 = __ldg(rows + i) * B;
          tma::mbar_wait(empty + slot, phase ^ 1);
          uint8_t* st = ring + slot * T::kStage;
          tma::mbar_arrive_expect_tx(full + slot, bytes);
#pragma unroll
          for (int bx = 0; bx < T::kBoxes; ++bx) {
            tma::load_2d(st + bx * T::kXBox, &xmap, full + slot, k0 + bx * T::kBoxCols, m0);
            tma::load_3d(st + T::kX + bx * T::kVBox, &vmap, full + slot, bx * T::kBoxCols, 0, i);
          }
          if (++slot == ST) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    __syncwarp();
  } else {  // consumer warpgroup wg: rows m0 + 64 wg ..
    const int wg = warp >> 2, tid = threadIdx.x & 127;
    int slot = 0;
    uint32_t phase = 0;
    for (int t = cid; t < items; t += ncl) {
      int m0, c, a, e;
      part(t, m0, c, a, e);
      const bool active = m0 + 64 * wg < M;
#pragma unroll
      for (int j = 0; j < B / 2; ++j) acc[j] = 0.f;
      int prev = -1;
      for (int i = a; i < e; ++i) {
        tma::mbar_wait(full + slot, phase);
        if (active) {
          const uint8_t* st = ring + slot * T::kStage;
          const uint64_t da = desc_a<B>(st + wg * 64 * T::kRowBytes), db = desc_b<B>(st + T::kX);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < B / 16; ++kk) {
            constexpr int kSteps = T::kBoxCols / 16;  // k16 steps a box row
            const uint64_t ka = (kk / kSteps) * (T::kXBox / 16) + 2 * (kk % kSteps);
            mma<B>(acc, da + ka, db + kk * T::kRowBytes);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's group has retired
        }
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) tma::mbar_arrive(empty + prev);
        }
        prev = slot;
        if (++slot == ST) {
          slot = 0;
          phase ^= 1;
        }
      }
      if (active) wgmma_wait<0>();
      fence_acc(acc);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) tma::mbar_arrive(empty + prev);
      }
      if (S == 1 && active) store_tile<B>(acc, outs + wg * T::kOutWG, &omap, c * B, m0 + 64 * wg,
                                          tid, wg);
    }
  }

  if (S > 1) {  // one item a cluster: rank 0 adds the ranks' partials in rank order
    namespace cg = cooperative_groups;
    int m0, c, a, e;
    part(cid, m0, c, a, e);
    const int wg = warp >> 2;
    const bool active = warp < 8 && m0 + 64 * wg < M;
    float* recv = reinterpret_cast<float*>(ring);  // every stage consumed: the ring is free
    cluster_arrive_release();
    cluster_wait();
    if (rank != 0 && active) {
      float* dst = cg::this_cluster().map_shared_rank(recv, 0);
#pragma unroll
      for (int j = 0; j < B / 2; ++j) dst[((rank - 1) * (B / 2) + j) * 256 + threadIdx.x] = acc[j];
    }
    cluster_arrive_release();
    cluster_wait();
    if (rank == 0 && active) {
      for (int q = 1; q < S; ++q)
#pragma unroll
        for (int j = 0; j < B / 2; ++j) acc[j] += recv[((q - 1) * (B / 2) + j) * 256 + threadIdx.x];
      store_tile<B>(acc, outs + wg * T::kOutWG, &omap, c * B, m0 + 64 * wg, threadIdx.x & 127, wg);
    }
  }
  // the output has left shared memory before the CTA does
  if (warp < 8 && (threadIdx.x & 127) == 0) bulk_wait_read0();
}

// A bf16 tensor map: dims / strides (bytes, dims 1..) / box, innermost
// first, with the 128-byte swizzle (box rows of 64 values) or the 64-byte
// one (32 values).
CUresult encode_bf16(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box, bool sw128) {
  const tma::EncodeTiled fn = tma::encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int B>
CUresult encode_values(CUtensorMap* map, const void* vals, int nnz) {
  using T = Tile<B>;
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)B, (cuuint64_t)nnz};
  const cuuint64_t strides[2] = {(cuuint64_t)B * 2, (cuuint64_t)B * B * 2};
  const cuuint32_t box[3] = {(cuuint32_t)T::kBoxCols, (cuuint32_t)B, 1};
  return encode_bf16(map, vals, 3, dims, strides, box, T::kSw128);
}

template <int B>
int launch(const void* x, const CUtensorMap& vmap, const int* rows, const int* colptr, void* out,
           int M, int K, int N, int splits, int ctas, cudaStream_t st) {
  using T = Tile<B>;
  const int xrows = M <= 64 ? 64 : kBM;  // one warpgroup's rows: its box alone
  CUtensorMap xmap, omap;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M}, xs[1] = {(cuuint64_t)K * 2};
  const cuuint64_t od[2] = {(cuuint64_t)N, (cuuint64_t)M}, os[1] = {(cuuint64_t)N * 2};
  const cuuint32_t xb[2] = {(cuuint32_t)T::kBoxCols, (cuuint32_t)xrows};
  const cuuint32_t ob[2] = {(cuuint32_t)T::kBoxCols, 64};
  CUresult r = encode_bf16(&xmap, x, 2, xd, xs, xb, T::kSw128);
  if (r == CUDA_SUCCESS) r = encode_bf16(&omap, out, 2, od, os, ob, T::kSw128);
  if (r != CUDA_SUCCESS) return -(int)r;
  const int mt = (M + kBM - 1) / kBM, items = mt * (N / B);
  if ((splits != 1 && splits != 2 && splits != 4) || splits > T::kMaxSplit || ctas < 1 ||
      ctas % splits ||
      (splits > 1 ? ctas != items * splits : ctas > items))
    return (int)cudaErrorInvalidValue;
  auto kern = bsr_tma_kernel<B>;
  static uint64_t attr_set = 0;  // the devices whose kernel has its shared memory size
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(attr_set >> dev & 1)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_set |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, xmap, vmap, omap, rows, colptr, M, mt, items, xrows,
                           splits);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// the CTAs a cluster may split a run over at block size b (0: not built)
extern "C" int ao_bsr_matmul_max_split(int b) {
  return b == 32    ? Tile<32>::kMaxSplit
         : b == 64  ? Tile<64>::kMaxSplit
         : b == 128 ? Tile<128>::kMaxSplit
                    : 0;
}
extern "C" int ao_bsr_matmul_tile_rows(void) { return kBM; }
extern "C" int ao_bsr_matmul_map_bytes(void) { return (int)sizeof(CUtensorMap); }

// The tensor map of a weight's values (nnz, b, b) bf16 (16-byte aligned)
// into map (ao_bsr_matmul_map_bytes() bytes), encoded once per weight and
// passed to every ao_bsr_matmul call. Returns 0, cudaErrorInvalidValue for
// a b the kernel is not built for, or minus libcuda's CUresult.
extern "C" int ao_bsr_values_map(void* map, const void* vals, int nnz, int b) {
  CUtensorMap m;
  CUresult r;
  switch (b) {
    case 32: r = encode_values<32>(&m, vals, nnz); break;
    case 64: r = encode_values<64>(&m, vals, nnz); break;
    case 128: r = encode_values<128>(&m, vals, nnz); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (r != CUDA_SUCCESS) return -(int)r;
  memcpy(map, &m, sizeof(m));
  return 0;
}

// x (M, K) bf16; vmap the values' map (ao_bsr_values_map); rows (nnz)
// int32, the blocks' block rows, sorted by (col, row); colptr (N/b + 1)
// int32, column c's blocks [colptr[c], colptr[c + 1]); out (M, N) bf16.
// The plan of bsr_matmul.launch_plan: `splits` CTAs a cluster (1, 2 or 4;
// above 1, ctas == items * splits), `ctas` CTAs. Needs b in {32, 64, 128},
// K % b == 0, N % b == 0 and 16-byte aligned operands; the Python wrapper
// checks them. Returns cudaGetLastError() after the launch, or minus
// libcuda's CUresult if a map could not be encoded (no kernel is launched
// then).
extern "C" int ao_bsr_matmul(const void* x, const void* vmap_, const void* rows_,
                             const void* colptr_, void* out, int M, int K, int N, int b,
                             int splits, int ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* rows = static_cast<const int*>(rows_);
  const auto* colptr = static_cast<const int*>(colptr_);
  CUtensorMap vmap;
  memcpy(&vmap, vmap_, sizeof(vmap));
  if (M < 1 || K % b || N % b) return (int)cudaErrorInvalidValue;
  switch (b) {
    case 32: return launch<32>(x, vmap, rows, colptr, out, M, K, N, splits, ctas, st);
    case 64: return launch<64>(x, vmap, rows, colptr, out, M, K, N, splits, ctas, st);
    case 128: return launch<128>(x, vmap, rows, colptr, out, M, K, N, splits, ctas, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
