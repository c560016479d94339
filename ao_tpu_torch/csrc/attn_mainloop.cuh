// A streamed attention mainloop for Hopper (sm_90a), shared by K8 (the
// causal flash prefill, flash_attention.cu) and K16 (windowed attention with
// the decomposed rel-pos bias, window_attention.cu). Both are one algorithm:
// for each query row, s = q . k^T over key tiles of kBK, a score modifier, an
// online softmax with f32 statistics, and o += bf16(p) . v. Only the score
// modifier differs: it is the template parameter Policy (K8: the causal mask;
// K16: the bias), as mixed_gemm.cuh's Op is the weight decode.
//
// Layout. q, k, v and the output are (B, S, H, D) bf16 with the rows of a
// batch row (K16: a window) strided by H * D: K8's q and its (B, Sk, Hkv, D)
// cache, K16's (G, T, nh, hd) q, k, v. Each is read through a 3-D tensor map
// (H * D, rows, B) in boxes of 64 rows x 64 values (128 bytes, the 128-byte
// swizzle), so a box that runs past the last key row is zero-filled by the
// TMA unit and never reads the next batch row's or window's keys (with a
// flat 2-D map it would, and 0 x a NaN there is a NaN in p . v). K8's causal
// maps cover min(Sq, Sk) cache rows: the rows past Sq, which a prefill has
// not written, are never read.
//
// A CTA owns NWG x 64 query rows of one (batch row, head): consumer
// warpgroup w its rows 64w .. 64w + 63, warp 4 NWG the producer. The CTAs
// run heaviest query tile first (a causal tile's work grows with its row),
// then batch rows, heads fastest, so that the query heads sharing a kv head
// run together and find its tiles in L2. The producer's lane 0 loads the
// CTA's q tiles once (one barrier) and then streams the key tiles the CTA
// needs (causally, up to its last row) through a ring of ST stages, each a
// k tile and a v tile with a full barrier each and one empty barrier
// (tma_ring.cuh). A consumer warpgroup, per key tile:
//  * s = q . k^T: D / 16 wgmma m64n64k16, q (A) and k (B) both from shared
//    memory, K-major (d contiguous: no transpose);
//  * the Policy turns s into scores; keys past the last row get -inf;
//  * the online softmax in the log2 domain: the row max m, p = 2^(s c - m c)
//    by one FFMA and ex2 (c: the Policy's factor, K8's sm_scale * log2(e),
//    K16's log2(e)), f32 row sums, o and l rescaled by 2^((m_old - m) c);
//  * o += p . v: the f32 scores packed in place to bf16 as wgmma's register
//    A fragments (the m64nNk16 accumulator of two n8 columns is the A
//    fragment of one k16 step), v (B) from shared memory with the
//    transpose flag (keys x d, d contiguous: MN-major), D / 64 wgmma
//    m64n64k16 a k16 step;
//  * each warp frees the stage once its wgmma retired.
// A warpgroup whose own rows need fewer key tiles than the CTA's (causal)
// still waits for and frees each later stage. The epilogue divides by the
// row sums and stores bf16 rows below S from registers.
//
// A Policy supplies kSmemPerWG (bytes of shared memory a consumer warpgroup
// gets, 16-byte aligned), Args (its kernel argument) and Thread, built by
// each consumer thread before the loop: Thread(args, pb, b, h, q0w, lrow,
// tig, smem, tid) (q0w: the warpgroup's first row; lrow: the thread's first
// row within it, the other lrow + 8; smem: the warpgroup's area, filled here
// by its 128 threads (tid) before a barrier of the warpgroup), exp2_scale()
// (c above) and score(s, tile, k0, tig) (the 32 accumulators of key tile
// `tile` at key k0 into scores: s[4n + 2h + e] is row lrow + 8h, key k0 +
// 8n + 2 tig + e).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace attn {

constexpr int kBK = 64;                // keys per tile
constexpr int kRowsWG = 64;            // query rows of a consumer warpgroup
constexpr int kBoxBytes = 64 * 128;    // a box: 64 rows of 64 bf16 values
constexpr float kLog2e = 1.4426950408889634f;

// The problem every Policy shares (see the header).
struct Problem {
  __nv_bfloat16* out;  // (B, S, H * D)
  int B, S, H, Hkv;    // batch rows or windows, query rows, query heads, kv heads
  int kv_len;          // key rows the maps cover
  int causal;          // top-left causal: row i sees keys 0 .. i
  int n_qt;            // query tiles of NWG x 64 rows
};

// Key tiles that rows r0 .. r0 + rows - 1 (clipped to S) need.
__device__ __forceinline__ int key_tiles(const Problem& pb, int r0, int rows) {
  const int last = min(r0 + rows, pb.S) - 1;
  const int end = pb.causal ? min(pb.kv_len, last + 1) : pb.kv_len;
  return (end + kBK - 1) / kBK;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a K-major tile of 128-byte rows under the 128-byte
// swizzle, 8-row atoms 1024-aligned: start address >> 4, leading byte
// offset unused (1), 1024 bytes between 8-row atoms, layout type 1. Adding
// 2 advances it by 32 bytes, one k16 step of bf16.
__device__ __forceinline__ uint64_t desc_k(const void* tile) {
  const uint64_t addr = tma::smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// The descriptor of an MN-major tile (v: rows are keys, the K of p . v, each
// 64 d values in one 128-byte swizzled row), 8-key atoms of 1024 bytes. A
// wgmma of N = 64 reads one atom's width in N, so only the stride between
// 8-key groups (1024 bytes) is used; both offset fields hold it.
__device__ __forceinline__ uint64_t desc_mn(const void* tile) {
  const uint64_t addr = tma::smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

// D (64 x 64 f32) = A (64 x 16, shared memory) B^T (64 x 16, shared memory),
// both K-major, + (scale_d ? D : 0).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64 f32) += A (64 x 16, registers: a fragment of four bf16x2) B
// (16 x 64, shared memory, MN-major: the transpose flag).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A CTA's shared memory, 1024-aligned: NWG q tiles, then ST stages of a k
// tile and a v tile (a tile: D / 64 boxes), then each consumer warpgroup's
// Policy area, then the barriers (q, full k, full v, empty).
template <int D, int NWG, int ST, class Policy>
struct Layout {
  static constexpr int kTile = D / 64 * kBoxBytes;
  static constexpr int kRing = NWG * kTile;
  static constexpr int kPolicy = kRing + ST * 2 * kTile;
  static constexpr int kBars = kPolicy + NWG * Policy::kSmemPerWG;
  static constexpr int kSmem = 1024 + kBars + (1 + 3 * ST) * 8;
  static constexpr int kThreads = NWG * 128 + 32;
  static_assert(D % 64 == 0 && Policy::kSmemPerWG % 16 == 0, "tiles of 64-value boxes");
};

template <int D, int NWG, int ST, int MINB, class Policy>
__global__ void __launch_bounds__(NWG * 128 + 32, MINB)
    attn_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const Problem pb,
                const typename Policy::Args args) {
  using L = Layout<D, NWG, ST, Policy>;
  constexpr int kHalves = D / 64;
  extern __shared__ uint8_t smem_dyn[];
  uint8_t* sm = smem_dyn + ((1024 - (tma::smem_u32(smem_dyn) & 1023)) & 1023);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* fullk = qbar + 1;
  uint64_t* fullv = fullk + ST;
  uint64_t* empty = fullv + ST;

  // the CTA's query tile (heaviest first), batch row and head (fastest)
  const int h = blockIdx.x % pb.H;
  const int rest = blockIdx.x / pb.H;
  const int b = rest % pb.B;
  const int q0 = (pb.n_qt - 1 - rest / pb.B) * (NWG * kRowsWG);
  const int kvh = h / (pb.H / pb.Hkv);
  const int n_tiles = key_tiles(pb, q0, NWG * kRowsWG);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    tma::mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      tma::mbar_init(fullk + s, 1);
      tma::mbar_init(fullv + s, 1);
      tma::mbar_init(empty + s, 4 * NWG);
    }
    tma::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer
    if (lane == 0) {
      tma::prefetch_map(&qmap);
      tma::prefetch_map(&kmap);
      tma::prefetch_map(&vmap);
      tma::mbar_arrive_expect_tx(qbar, NWG * L::kTile);
      for (int w = 0; w < NWG; ++w)
        for (int c = 0; c < kHalves; ++c)
          tma::load_3d(sm + w * L::kTile + c * kBoxBytes, &qmap, qbar, h * D + 64 * c,
                       q0 + w * kRowsWG, b);
      int slot = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        tma::mbar_wait(empty + slot, phase ^ 1);
        uint8_t* kt = sm + L::kRing + slot * 2 * L::kTile;
        tma::mbar_arrive_expect_tx(fullk + slot, L::kTile);
        for (int c = 0; c < kHalves; ++c)
          tma::load_3d(kt + c * kBoxBytes, &kmap, fullk + slot, kvh * D + 64 * c, i * kBK, b);
        tma::mbar_arrive_expect_tx(fullv + slot, L::kTile);
        for (int c = 0; c < kHalves; ++c)
          tma::load_3d(kt + L::kTile + c * kBoxBytes, &vmap, fullv + slot, kvh * D + 64 * c,
                       i * kBK, b);
        if (++slot == ST) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup
  const int wg = warp >> 2, tid = threadIdx.x & 127;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0w = q0 + wg * kRowsWG;
  const int lrow = 16 * (warp & 3) + gid;
  const int my_tiles = q0w < pb.S ? key_tiles(pb, q0w, kRowsWG) : 0;
  typename Policy::Thread pol(args, pb, b, h, q0w, lrow, tig,
                              sm + L::kPolicy + wg * Policy::kSmemPerWG, tid);
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  const float c = pol.exp2_scale();

  float o[kHalves][32];
#pragma unroll
  for (int nb = 0; nb < kHalves; ++nb)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[nb][j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const uint8_t* qt = sm + wg * L::kTile;
  tma::mbar_wait(qbar, 0);

  int slot = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const uint8_t* kt = sm + L::kRing + slot * 2 * L::kTile;
    const uint8_t* vt = kt + L::kTile;
    if (i < my_tiles) {
      tma::mbar_wait(fullk + slot, phase);
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc_k(qt + (kk >> 2) * kBoxBytes) + 2 * (kk & 3),
                 desc_k(kt + (kk >> 2) * kBoxBytes) + 2 * (kk & 3), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_acc(s);

      const int k0 = i * kBK;
      pol.score(s, i, k0, tig);
      if (k0 + kBK > pb.kv_len) {  // keys past the last row: no key at all
#pragma unroll
        for (int j = 0; j < 32; ++j)
          if (k0 + 8 * (j >> 2) + 2 * tig + (j & 1) >= pb.kv_len) s[j] = -INFINITY;
      }
      // every tile a warpgroup runs holds a key at or below each of its
      // rows, so the maxima are finite and alpha is 0 on the first tile
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j & 2)
          mx1 = fmaxf(mx1, s[j]);
        else
          mx0 = fmaxf(mx0, s[j]);
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float a0 = ex2((m0 - mx0) * c), a1 = ex2((m1 - mx1) * c);
      m0 = mx0;
      m1 = mx1;
      const float mc0 = mx0 * c, mc1 = mx1 * c;
      float rs0 = 0.f, rs1 = 0.f;
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const float p00 = ex2(fmaf(s[4 * n], c, -mc0)), p01 = ex2(fmaf(s[4 * n + 1], c, -mc0));
        const float p10 = ex2(fmaf(s[4 * n + 2], c, -mc1)), p11 = ex2(fmaf(s[4 * n + 3], c, -mc1));
        rs0 += p00 + p01;
        rs1 += p10 + p11;
        pa[n >> 1][(n & 1) * 2] = pack_bf16x2(p00, p01);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(p10, p11);
      }
      l0 = a0 * l0 + rs0;  // this thread's share; the quad's are summed at the end
      l1 = a1 * l1 + rs1;
#pragma unroll
      for (int nb = 0; nb < kHalves; ++nb)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[nb][j] *= (j & 2) ? a1 : a0;

      tma::mbar_wait(fullv + slot, phase);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
#pragma unroll
        for (int nb = 0; nb < kHalves; ++nb)
          wgmma_rs_t(o[nb], pa[j], desc_mn(vt + nb * kBoxBytes + j * 16 * 128));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int nb = 0; nb < kHalves; ++nb) fence_acc(o[nb]);
    } else {  // past this warpgroup's rows: free the stage once it has landed
      tma::mbar_wait(fullk + slot, phase);
      tma::mbar_wait(fullv + slot, phase);
    }
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(empty + slot);
    if (++slot == ST) {
      slot = 0;
      phase ^= 1;
    }
  }
  if (my_tiles == 0) return;

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  // each row's largest score adds 2^0 = 1 to its sum, so l >= 1
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const size_t row_stride = (size_t)pb.H * D;
  __nv_bfloat16* ob = pb.out + (size_t)b * pb.S * row_stride + (size_t)h * D + 2 * tig;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0w + lrow + 8 * hh;
    if (r >= pb.S) continue;
    const float inv = hh ? inv1 : inv0;
    __nv_bfloat16* orow = ob + (size_t)r * row_stride;
#pragma unroll
    for (int nb = 0; nb < kHalves; ++nb)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 64 * nb + 8 * n) =
            pack_bf16x2(o[nb][4 * n + 2 * hh] * inv, o[nb][4 * n + 2 * hh + 1] * inv);
  }
}

// Encodes the three maps and launches the kernel: q (B, S, H, D); k, v (B,
// Sk, Hkv, D), read up to pb.kv_len rows. Returns cudaGetLastError() after
// the launch, or minus libcuda's CUresult if a map could not be encoded (no
// kernel is launched then).
template <int D, int NWG, int ST, int MINB, class Policy>
int launch(const void* q, const void* k, const void* v, int Sk, const Problem& pb,
           const typename Policy::Args& args, cudaStream_t st) {
  using L = Layout<D, NWG, ST, Policy>;
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qrow = (uint64_t)pb.H * D * 2, kvrow = (uint64_t)pb.Hkv * D * 2;
  CUresult r = tma::encode_bf16_3d_sw128(&qmap, q, (uint64_t)pb.H * D, pb.S, pb.B, qrow,
                                         qrow * pb.S, kRowsWG);
  if (r == CUDA_SUCCESS)
    r = tma::encode_bf16_3d_sw128(&kmap, k, (uint64_t)pb.Hkv * D, pb.kv_len, pb.B, kvrow,
                                  kvrow * Sk, kBK);
  if (r == CUDA_SUCCESS)
    r = tma::encode_bf16_3d_sw128(&vmap, v, (uint64_t)pb.Hkv * D, pb.kv_len, pb.B, kvrow,
                                  kvrow * Sk, kBK);
  if (r != CUDA_SUCCESS) return -(int)r;
  auto kern = attn_kernel<D, NWG, ST, MINB, Policy>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<pb.n_qt * pb.H * pb.B, L::kThreads, L::kSmem, st>>>(qmap, kmap, vmap, pb, args);
  return (int)cudaGetLastError();
}

}  // namespace attn
