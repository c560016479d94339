// fp4 (e2m1) weight-only matmul, MXFP4 and NVFP4, for Hopper (sm_90a): K14.
//
// Replaces the TPU kernels ao_tpu/ops/pallas/fp4_matmul.py::_mx_kernel and
// ::_nv_kernel (launched by _run, public entries mxfp4_wo_matmul_pallas and
// nvfp4_wo_matmul_pallas):
//
//   MXFP4: y[m, n] = bf16( sum_k x[m, k] * c[k, n] * 2^(e[k/32, n] - 127) )
//   NVFP4: y[m, n] = bf16( pts * bf16( sum_k x[m, k] * c[k, n] * s[k/16, n] ) )
//
// c the e2m1 value of the weight's code, e the e8m0 byte of its 32-row block,
// s the e4m3 scale of its 16-row block, pts the f32 per-tensor scale (the
// reference path multiplies the kernel's bf16 output by it in f32, then casts
// to the activation's bf16). x bf16 (M, K); f32 sums.
//
// Exact decoding. Hopper has no fp4 tensor cores, so each weight is decoded
// to bf16 and the product runs on the bf16 tensor cores. The block scale is
// folded into the decoded weight: an e2m1 value has at most 2 significant
// bits, an e4m3 scale at most 4 and an e8m0 scale is a power of two, so
// value * scale is exact in f32 and in bf16, whose exponent range is f32's
// (down to its subnormals). Every byte decodes exactly: e8m0 byte 0 is
// 2^-127 (an f32 subnormal; nvcc keeps denormals without -ftz), 255 is
// exp2(128) = inf as in the reference's dequantize; a subnormal e4m3 byte is
// m * 2^-9, its NaN bytes NaN. The zero codes decode to an exact +-0. (The
// TPU kernel builds e4m3 scales as normal numbers, (1 + m/8) 2^-7 for a
// subnormal byte, and kills zero codes through the v5e MXU's flush of bf16
// denormals; Hopper's tensor cores keep bf16 denormals, so neither is
// copied: this kernel computes what dequantize() computes.)
//
// Layout: the "fp4 magic" words (K/8, N) int32 (quantization/qarrays/fp4.py):
// plane j holds logical rows [jK/4, (j+1)K/4), word row r holds plane rows 2r
// and 2r + 1 at bits 4j and 16 + 4j, with the em field's 0 and 1 swapped
// (stored em 0 is 0.5, stored em 1 is zero). A word's plane j is thus two
// consecutive K rows of one column: one register of an mma.sync m16n8k16
// fragment, as in K1's int4 magic layout (this is that layout with one
// super-group of four groups of K/4 rows). A "unit" is 32 word rows: 64
// logical rows of each plane, four k16 steps; K % 256 == 0.
//
// What bounds it on the H100, and the two kernels:
//  * decode (M <= 16, fp4_gemv_kernel): the weight stream, 0.5 B per weight
//    plus the scales (1/32 B per weight for MX, 1/8 B for NV's pair-words)
//    against 3.35 TB/s, and the decode's integer work (about eight
//    instructions per weight). K1's structure: the weights are the A operand
//    (16 columns of N as the rows of an m16 tile), x^T the B operand, each
//    warp owns 32 columns, each thread issues a unit's eight 16-byte word
//    loads and its scale loads before it uses any, and the grid splits K by
//    whole units (grid.z) into f32 partials summed by a second pass.
//  * prefill (M > 16, fp4_gemm_kernel): tensor-core operations. K1's tile:
//    a block computes 64 rows x 128 columns, each warp 64 x 32; the x tile of
//    a (unit, plane) step, 64 rows x 64 K, is staged in shared memory by
//    cp.async, the next step's while the current one is used, and read by
//    ldmatrix; every decoded B fragment feeds four mma.sync. No wgmma or TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMx = 0, kNv = 1;
constexpr int kUnitWords = 32;   // word rows per unit
constexpr int kStep = 64;        // logical K per (unit, plane) step
constexpr int kLd = kStep + 8;   // x tile row, bf16, padded by 16 bytes

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

__device__ __forceinline__ int4 ld_16(const void* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ uint32_t ld_x2(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t elem(const int4& v, int i) {
  return i == 0 ? (uint32_t)v.x : i == 1 ? (uint32_t)v.y : i == 2 ? (uint32_t)v.z : (uint32_t)v.w;
}

// The e2m1 value of a stored nibble (em field 0 and 1 swapped): sign bit 3;
// stored em 1 is +-0; otherwise (1 + m/2) 2^(e-1) has the bf16 bits
// (em << 6) + 0x3F00 (stored em 0: 0x3F00 = 0.5).
__device__ __forceinline__ float e2m1_value(uint32_t c) {
  const uint32_t em = c & 7u;
  const uint32_t mag = em == 1u ? 0u : ((em << 6) + 0x3F00u) << 16;
  return __uint_as_float(mag | ((c & 8u) << 28));
}

// e8m0 byte -> 2^(b - 127): the f32 exponent field, 2^-127 (subnormal) for 0
__device__ __forceinline__ float e8m0_value(uint32_t b) {
  return b ? __uint_as_float(b << 23) : __uint_as_float(0x00400000u);
}

// e4m3fn byte -> its value: normals 2^(e-7) (1 + m/8), subnormals m 2^-9,
// NaN at 0x7F and 0xFF
__device__ __forceinline__ float e4m3_value(uint32_t b) {
  const uint32_t e = (b >> 3) & 15u, m = b & 7u;
  float v;
  if ((b & 0x7Fu) == 0x7Fu)
    v = __uint_as_float(0x7FC00000u);
  else if (e == 0u)
    v = (float)m * 0.001953125f;
  else
    v = __uint_as_float(((e + 120u) << 23) | (m << 20));
  return (b & 0x80u) ? -v : v;
}

// The raw scale entry covering logical row kk (a multiple of 16) for the four
// columns col .. col + 3: MX, the four e8m0 bytes of row kk/32 in one word;
// NV, the four pair-words of row kk/32 (block kk/16 in byte (kk/16) & 1).
template <int KIND>
struct Scales;

template <>
struct Scales<kMx> {
  uint32_t v;
  __device__ __forceinline__ void load(const void* scale, int kk, int col, int N) {
    v = __ldg(reinterpret_cast<const unsigned int*>(static_cast<const uint8_t*>(scale) +
                                                    (size_t)(kk >> 5) * N + col));
  }
  __device__ __forceinline__ float get(int i, int) const { return e8m0_value((v >> (8 * i)) & 0xFFu); }
};

template <>
struct Scales<kNv> {
  int4 v;
  __device__ __forceinline__ void load(const void* scale, int kk, int col, int N) {
    v = ld_16(static_cast<const int32_t*>(scale) + (size_t)(kk >> 5) * N + col);
  }
  // sel: (kk >> 4) & 1, the block of the pair
  __device__ __forceinline__ float get(int i, int sel) const {
    return e4m3_value((elem(v, i) >> (16 * sel)) & 0xFFu);
  }
};

// Plane j of a magic word, times the column's block scale, as bf16x2 (row
// 2r in the low half, 2r + 1 in the high half), exactly.
__device__ __forceinline__ uint32_t plane_scaled(uint32_t w, int j, float s) {
  const uint32_t t = w >> (4 * j);
  return pack_bf16x2(e2m1_value(t & 15u) * s, e2m1_value((t >> 16) & 15u) * s);
}

// The NVFP4 epilogue: the reference's bf16 output times pts in f32, in bf16.
template <int KIND>
__device__ __forceinline__ float finish(float acc, const float* pts) {
  if (KIND == kNv && pts != nullptr)
    return __bfloat162float(__float2bfloat16_rn(acc)) * __ldg(pts);
  return acc;
}

// Decode kernel (M <= 16, NT = ceil(M/8)). grid (N/128, 1, splits), 128
// threads; warp w owns columns nb = (4*blockIdx.x + w)*32 .. + 31; the thread
// loads columns col = nb + 4*gid .. + 3, in two m16 tiles: tile p holds in its
// rows 0..7 column col + 2p and in rows 8..15 column col + 2p + 1. Split z
// covers units [z*ups, (z+1)*ups).
template <int KIND, int NT>
__global__ void __launch_bounds__(128)
    fp4_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ word,
                    const void* __restrict__ scale, const float* __restrict__ pts,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M, int K, int N,
                    int ups) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = (blockIdx.x * 4 + warp) * 32;
  const int col = nb + 4 * gid;
  const int kq = K / 4;
  const int units = K / (4 * kStep);
  const int u_end = min((int)(blockIdx.z + 1) * ups, units);

  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;

  for (int u = blockIdx.z * ups; u < u_end; ++u) {
    // the unit's words: chunk c (16 rows of each plane) is word rows
    // 32u + 8c .. + 7; the thread's rows 8c + tig (K rows 2tig, 2tig + 1 of
    // the k16 step) and 8c + 4 + tig (rows 2tig + 8, 2tig + 9)
    int4 w[4][2];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int32_t* wr = word + (size_t)(kUnitWords * u + 8 * c + tig) * N + col;
      w[c][0] = ld_16(wr);
      w[c][1] = ld_16(wr + (size_t)4 * N);
    }
    Scales<KIND> sv[4][2];  // [plane j][chunk pair c/2]: rows kk/32 of the unit
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) sv[j][h].load(scale, j * kq + kStep * u + 32 * h, col, N);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k0 = j * kq + kStep * u + 16 * c + 2 * tig;
        uint32_t b[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int r = gid + 8 * nt;
          b[nt][0] = r < M ? ld_x2(x + (size_t)r * K + k0) : 0u;
          b[nt][1] = r < M ? ld_x2(x + (size_t)r * K + k0 + 8) : 0u;
        }
        const Scales<KIND>& s = sv[j][c >> 1];
        const int sel = c & 1;
        const float s0 = s.get(0, sel), s1 = s.get(1, sel), s2 = s.get(2, sel),
                    s3 = s.get(3, sel);
        const int4& w0 = w[c][0];
        const int4& w1 = w[c][1];
        const uint32_t a0[4] = {plane_scaled(w0.x, j, s0), plane_scaled(w0.y, j, s1),
                                plane_scaled(w1.x, j, s0), plane_scaled(w1.y, j, s1)};
        const uint32_t a1[4] = {plane_scaled(w0.z, j, s2), plane_scaled(w0.w, j, s3),
                                plane_scaled(w1.z, j, s2), plane_scaled(w1.w, j, s3)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_16816(acc[0][nt], a0, b[nt][0], b[nt][1]);
          mma_16816(acc[1][nt], a1, b[nt][0], b[nt][1]);
        }
      }
  }

  // C fragment e of tile p: column col + 2p + (e >> 1), batch row
  // 2*tig + (e & 1) (+ 8nt); the thread's outputs: rows 2*tig + h, columns
  // col .. col + 3
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * tig + h + 8 * nt;
      if (r >= M) continue;
      const float v[4] = {acc[0][nt][h], acc[0][nt][2 + h], acc[1][nt][h], acc[1][nt][2 + h]};
      const size_t off = (size_t)r * N + col;
      if (ws == nullptr) {
        *reinterpret_cast<uint2*>(out + off) =
            make_uint2(pack_bf16x2(finish<KIND>(v[0], pts), finish<KIND>(v[1], pts)),
                       pack_bf16x2(finish<KIND>(v[2], pts), finish<KIND>(v[3], pts)));
      } else {
        *reinterpret_cast<float4*>(ws + (size_t)blockIdx.z * M * N + off) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
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

// The A fragment of an m16 x k16 bf16 tile: lane l gives the address of row
// (l & 15), columns 8*(l >> 4) .. + 7.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* smem) {
  const unsigned p = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(p));
}

// Prefill kernel (M > 16): grid (N/128, ceil(M/64)), 128 threads. Warp w owns
// columns nb = (4*blockIdx.x + w)*32 .. + 31 of rows m0 .. m0 + 63; its
// 16-byte word load covers columns nb + 4*gid .. + 3, element i being column
// gid of n8 tile i (tile i holds the columns {nb + 4c + i}). Step s is unit
// s / 4, plane s % 4: x columns j*K/4 + 64u .. + 63.
template <int KIND>
__global__ void __launch_bounds__(128)
    fp4_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ word,
                    const void* __restrict__ scale, const float* __restrict__ pts,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  constexpr int MT = 4;
  __shared__ __align__(16) __nv_bfloat16 xtile[2][64][kLd];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = (blockIdx.x * 4 + warp) * 32;
  const int col = nb + 4 * gid;
  const int m0 = blockIdx.y * 64;
  const int kq = K / 4;
  const int steps = 4 * (K / (4 * kStep));

  auto load_tile = [&](int buf, int s) {
    const int kbase = (s & 3) * kq + kStep * (s >> 2);
    for (int i = threadIdx.x; i < 64 * (kStep / 8); i += 128) {
      const int r = i / (kStep / 8), cc = i % (kStep / 8);
      const bool valid = m0 + r < M;
      const __nv_bfloat16* src = valid ? x + (size_t)(m0 + r) * K + kbase + cc * 8 : x;
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
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load_tile((s + 1) & 1, s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int u = s >> 2, j = s & 3;
    Scales<KIND> sv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) sv[h].load(scale, j * kq + kStep * u + 32 * h, col, N);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int32_t* wr = word + (size_t)(kUnitWords * u + 8 * c + tig) * N + col;
      const int4 w0 = ld_16(wr);
      const int4 w1 = ld_16(wr + (size_t)4 * N);
      const Scales<KIND>& sc = sv[c >> 1];
      uint32_t b0[4], b1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float si = sc.get(i, c & 1);
        b0[i] = plane_scaled(elem(w0, i), j, si);
        b1[i] = plane_scaled(elem(w1, i), j, si);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, &xtile[s & 1][mt * 16 + (lane & 15)][c * 16 + 8 * (lane >> 4)]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_16816(acc[mt][i], a, b0[i], b1[i]);
      }
    }
    __syncthreads();  // the next iteration's load overwrites this tile
  }

  // C fragment of n8 tile i: columns nb + 8*tig + i (c0, c2) and
  // nb + 8*tig + 4 + i (c1, c3), rows gid (c0, c1) and gid + 8 (c2, c3)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + mt * 16 + gid + 8 * half;
      if (r >= M) continue;
      float v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = finish<KIND>(acc[mt][i][2 * half], pts);
        v[4 + i] = finish<KIND>(acc[mt][i][2 * half + 1], pts);
      }
      int4 o;
      o.x = (int)pack_bf16x2(v[0], v[1]);
      o.y = (int)pack_bf16x2(v[2], v[3]);
      o.z = (int)pack_bf16x2(v[4], v[5]);
      o.w = (int)pack_bf16x2(v[6], v[7]);
      *reinterpret_cast<int4*>(out + (size_t)r * N + nb + 8 * tig) = o;
    }
}

// Second pass of a split-K launch: out = bf16(finish(sum over splits of ws)).
template <int KIND>
__global__ void fp4_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ pts,
                                  __nv_bfloat16* __restrict__ out, size_t mn, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * mn + i];
  out[i] = __float2bfloat16(finish<KIND>(acc, pts));
}

template <int KIND>
cudaError_t launch(const __nv_bfloat16* x, const int32_t* word, const void* scale,
                   const float* pts, __nv_bfloat16* out, float* ws, int M, int K, int N,
                   int splits, int ups, cudaStream_t st) {
  if (M > 16) {
    dim3 grid(N / 128, (M + 63) / 64);
    fp4_gemm_kernel<KIND><<<grid, 128, 0, st>>>(x, word, scale, pts, out, M, K, N);
    return cudaGetLastError();
  }
  dim3 grid(N / 128, 1, splits);
  if (M <= 8)
    fp4_gemv_kernel<KIND, 1><<<grid, 128, 0, st>>>(x, word, scale, pts, out, ws, M, K, N, ups);
  else
    fp4_gemv_kernel<KIND, 2><<<grid, 128, 0, st>>>(x, word, scale, pts, out, ws, M, K, N, ups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return err;
  const size_t mn = (size_t)M * N;
  fp4_reduce_kernel<KIND><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, pts, out, mn, splits);
  return cudaGetLastError();
}

}  // namespace

// K per unit (4 planes x 64 rows) and N per block; the wrapper checks its
// shapes against them at load.
extern "C" int ao_fp4_k_unit() { return 4 * kStep; }
extern "C" int ao_fp4_n_block() { return 128; }

// kind 0 MXFP4 (scale: e8m0 bytes (K/32, N) uint8, pts unused), 1 NVFP4
// (scale: e4m3 pair-words (K/32, N) int32, pts an f32 scalar or null).
// x (M, K) bf16; word (K/8, N) int32; out (M, N) bf16; ws (splits, M, N) f32
// when splits > 1 (decode only), ups units per split. Needs K % 256 == 0,
// N % 128 == 0 and 16-byte aligned rows; the Python wrapper checks them.
// Returns cudaGetLastError() after the launches.
extern "C" int ao_fp4_wo(int kind, const void* x_, const void* word_, const void* scale,
                         const void* pts_, void* out_, void* ws_, int M, int K, int N, int splits,
                         int ups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* pts = static_cast<const float*>(pts_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  if (K % (4 * kStep) || N % 128 || M < 1) return (int)cudaErrorInvalidValue;
  if (kind == kMx) return (int)launch<kMx>(x, word, scale, nullptr, out, ws, M, K, N, splits, ups, st);
  if (kind == kNv) return (int)launch<kNv>(x, word, scale, pts, out, ws, M, K, N, splits, ups, st);
  return (int)cudaErrorInvalidValue;
}
