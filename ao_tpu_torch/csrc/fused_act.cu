// Producer-side per-token int8 quantization, for Hopper (sm_90a): K12s (the
// gated-MLP activation, first below), K12g (tanh-GELU) and K12n (LayerNorm
// with a modulation), each with its note.
//
// K12s replaces the TPU kernel ao_tpu/ops/pallas/fused_act.py::
// _silu_mul_quant_kernel (launched by _silu_mul_quant_impl, public entry
// silu_mul_quant_pallas). For each row of a and b (D values):
//
//   y      = act(a) * b in f32, act = silu (x * sigmoid(x)) or tanh-GELU;
//   scale  = max(max_k |y_k|, 1e-8) / 127;
//   q      = clip(round_half_even(y / scale), -127, 127) as int8.
//
// The high-precision gate never goes to device memory: the kernel reads a
// and b once and writes q and one f32 scale per row.
//
// What bounds it on the H100: bytes, 2 * 2 B read and 1 B written per value
// (bf16 inputs), against 3.35 TB/s; the arithmetic (one expf and a few
// multiplies per value) is far below the card's rate. One block of 256
// threads takes one row: 16-byte loads of eight values, y kept in dynamic
// shared memory (4*D bytes, 56 KB at D = 14336) while a block reduction finds
// the row's amax, then a second pass over shared memory writes eight int8
// values per 8-byte store. expf and IEEE division, as the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quant_round.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const int4 raw = __ldg(reinterpret_cast<const int4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

template <int GELU>
__device__ __forceinline__ float gate(float x) {
  if (GELU) {
    // jax.nn.gelu(x, approximate=True)
    const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
    return x * (0.5f * (1.f + tanhf(inner)));
  }
  return x * (1.f / (1.f + expf(-x)));  // x * sigmoid(x)
}

// grid (rows), 256 threads, dynamic shared memory 4*D bytes. D % 8 == 0.
template <typename T, int GELU>
__global__ void __launch_bounds__(kThreads)
    silu_mul_quant_kernel(const T* __restrict__ a, const T* __restrict__ b, int8_t* __restrict__ q,
                          float* __restrict__ scale, int D) {
  extern __shared__ float ys[];
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* ar = a + row * D;
  const T* br = b + row * D;
  const int nchunk = D / 8;
  float amax = 0.f;
  for (int c = threadIdx.x; c < nchunk; c += kThreads) {
    float av[8], bv[8];
    load8(ar + 8 * c, av);
    load8(br + 8 * c, bv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = gate<GELU>(av[i]) * bv[i];
      ys[8 * c + i] = y;
      amax = fmaxf(amax, fabsf(y));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float sc = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);

  int8_t* qr = q + row * D;
  for (int c = threadIdx.x; c < nchunk; c += kThreads) {
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = fminf(fmaxf(rintf(__fdiv_rn(ys[8 * c + i], sc)), -127.f), 127.f);
      packed[i >> 2] |= ((uint32_t)(int)v & 0xFFu) << (8 * (i & 3));
    }
    *reinterpret_cast<uint2*>(qr + 8 * c) = make_uint2(packed[0], packed[1]);
  }
  if (threadIdx.x == 0) scale[row] = sc;
}

template <typename T, int GELU>
cudaError_t launch(const void* a, const void* b, void* q, void* scale, int rows, int D,
                   cudaStream_t st) {
  const size_t smem = (size_t)D * sizeof(float);
  auto* kern = silu_mul_quant_kernel<T, GELU>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<rows, kThreads, smem, st>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                     static_cast<int8_t*>(q), static_cast<float*>(scale), D);
  return cudaGetLastError();
}

}  // namespace

// a, b (rows, D) bf16 (is_f32 == 0) or f32; q (rows, D) int8; scale (rows,)
// f32. act 0 = silu, 1 = tanh-GELU. Needs D % 128 == 0, 4*D bytes of shared
// memory (D <= 57344) and 16-byte aligned rows; the Python wrapper checks
// them. Returns cudaGetLastError() after the launch.
extern "C" int ao_silu_mul_quant(const void* a, const void* b, void* q, void* scale, int rows,
                                 int D, int act, int is_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_f32)
    err = act ? launch<float, 1>(a, b, q, scale, rows, D, st)
              : launch<float, 0>(a, b, q, scale, rows, D, st);
  else
    err = act ? launch<__nv_bfloat16, 1>(a, b, q, scale, rows, D, st)
              : launch<__nv_bfloat16, 0>(a, b, q, scale, rows, D, st);
  return (int)err;
}

// ---------------------------------------------------------------------------
// K12g and K12n.
//
// K12g replaces ao_tpu/ops/pallas/fused_act.py::_gelu_quant_kernel (public
// entry gelu_quant_pallas): y = tanh-GELU(x) in f32 per row, then the row
// quantize above. K12n replaces _ln_mod_quant_kernel (public entry
// norm_modulate_quant_pallas): for row t of batch row b,
//
//   mu = mean(x); var = mean((x - mu)^2); y = (x - mu) * rsqrt(var + eps);
//   y = y * (1 + smod[b]) + shift[b]; then the row quantize,
//
// all in f32 (rsqrt as 1 / sqrt, each step one IEEE rounding, as the plain
// version). The modulation rows are read with a batch stride, 0 when one
// row serves every batch row (SAM's LayerNorm affine), so no broadcast is
// materialized. Bytes bound both, as K12s: 2 B read (bf16) and 1 B written
// per value. K12n above 2048 values a row, and K12g above 3072, take one
// block of 256 threads per row, which keeps the row in f32 in dynamic shared
// memory (4*D bytes) across the reductions (two for K12n's moments, one
// amax). K12n up to 2048 values (SAM-B's 768, SAM-L's 1024, SAM-H's 1280,
// DiT-XL's 1152) takes one warp a row instead, eight rows a CTA: lane l
// holds chunks l, l + 32, .. of 8 values (C of them, the last predicated
// where D / 8 is not a multiple of 32) in f32 registers from 16-byte loads,
// and each reduction (the sum, the squared deviations from the mean, the
// amax) is the lane's sum in chunk order, then one xor-shuffle tree: no
// shared memory, no barrier, the same IEEE steps in the same order
// otherwise; the codes are the IEEE quotients' (quant_round.cuh).
//
// K12g up to 3072 values a row (SAM-B's MLP width) takes 4 warps a row, 1-3
// chunks of 8 values a lane by D, eight warps a CTA: every 16-byte load of
// the row is issued before the first GELU, the 4 warps' maxima meet in
// shared memory after one barrier. The block kernel it
// replaces there was bound by issue, not bytes (116 / 97.7 us at SAM-B's
// windowed / global rows against bounds of 53.9 / 45.1): per value a precise
// tanhf, an IEEE division, a shared-memory store and load, two barriers a
// row. The warps kernel keeps the tanhf of the plain version (PyTorch's
// tanh-GELU on the card takes the same f32 steps) and takes the codes from
// the reciprocal without a clip (quant_byte_in_row). Measured on the H100
// (PERF.md): one warp a row, 12 chunks a lane, 138 registers, 12 warps an
// SM, was slower than the block kernel (174 / 149 us: each lane's 96 values
// ran one after another through tanhf's and the codes' branches, which 3
// warps a scheduler could not hide); four warps a row in CTAs of 4, 8 and 16
// warps took 91 / 77, 86 / 73 and 94 / 80 us, and persistent CTAs loading
// the next rows while computing these 105 / 87. The GELU by the identity
// 0.5 x (1 + tanh(u)) = x / (1 + exp(-2u)) with the fast exponential and
// reciprocal ran faster but left codes and scales far off the plain
// version's where 1 + tanh(u) cancels (x below about -3), so it is not
// built.

namespace {

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red may still be read by a previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) t += red[w];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) t = fmaxf(t, red[w]);
  return t;
}

// q = clip(round_half_even(y / scale), -127, 127) for a row held in ys.
__device__ __forceinline__ void quant_row(const float* ys, float amax, int8_t* qr, float* scale,
                                          int D) {
  const float sc = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  for (int c = threadIdx.x; c < D / 8; c += kThreads) {
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = fminf(fmaxf(rintf(__fdiv_rn(ys[8 * c + i], sc)), -127.f), 127.f);
      packed[i >> 2] |= ((uint32_t)(int)v & 0xFFu) << (8 * (i & 3));
    }
    *reinterpret_cast<uint2*>(qr + 8 * c) = make_uint2(packed[0], packed[1]);
  }
  if (threadIdx.x == 0) *scale = sc;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// grid (rows), 256 threads, dynamic shared memory 4*D bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gelu_quant_kernel(const T* __restrict__ y, int8_t* __restrict__ q, float* __restrict__ scale,
                      int D) {
  extern __shared__ float ys[];
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  float amax = 0.f;
  for (int c = threadIdx.x; c < D / 8; c += kThreads) {
    float v[8];
    load8(y + row * D + 8 * c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float g = gate<1>(v[i]);
      ys[8 * c + i] = g;
      amax = fmaxf(amax, fabsf(g));
    }
  }
  amax = block_max(amax, red);
  quant_row(ys, amax, q + row * D, scale + row, D);
}

// grid (B * T rows), 256 threads, dynamic shared memory 4*D bytes; the
// modulation row of row r is shift / smod + (r / T) * mod_stride.
template <typename T, typename M>
__global__ void __launch_bounds__(kThreads)
    norm_modulate_quant_kernel(const T* __restrict__ h, const M* __restrict__ shift,
                               const M* __restrict__ smod, int mod_stride, int8_t* __restrict__ q,
                               float* __restrict__ scale, int T_, int D, float eps) {
  extern __shared__ float ys[];
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const M* sh = shift + (size_t)(row / T_) * mod_stride;
  const M* sm = smod + (size_t)(row / T_) * mod_stride;
  float sum = 0.f;
  for (int c = threadIdx.x; c < D / 8; c += kThreads) {
    float v[8];
    load8(h + row * D + 8 * c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ys[8 * c + i] = v[i];
      sum += v[i];
    }
  }
  const float mu = __fdiv_rn(block_sum(sum, red), (float)D);
  float sq = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float d = ys[i] - mu;
    sq = __fmaf_rn(d, d, sq);
  }
  const float var = __fdiv_rn(block_sum(sq, red), (float)D);
  const float rs = __fdiv_rn(1.f, __fsqrt_rn(var + eps));
  float amax = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float yn = __fmul_rn(__fsub_rn(ys[i], mu), rs);
    const float v = __fadd_rn(__fmul_rn(yn, __fadd_rn(1.f, to_f32(sm[i]))), to_f32(sh[i]));
    ys[i] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = block_max(amax, red);
  quant_row(ys, amax, q + row * D, scale + row, D);
}

constexpr int kNormWarps = 8;       // rows a CTA of the warp kernel
constexpr int kNormWarpChunks = 8;  // at most 8 chunks of 8 values a lane: D <= 2048

// grid (ceil(rows / kNormWarps)), kNormWarps warps; warp w of CTA i takes
// row i kNormWarps + w, its lane l chunks l + 32 c (c < C) of 8 values; the
// modulation row of row r is shift / smod + (r / T) * mod_stride, read in
// 16-byte loads (16-byte aligned rows).
template <typename T, typename M, int C>
__global__ void __launch_bounds__(32 * kNormWarps)
    norm_modulate_quant_warp_kernel(const T* __restrict__ h, const M* __restrict__ shift,
                                    const M* __restrict__ smod, int mod_stride,
                                    int8_t* __restrict__ q, float* __restrict__ scale, int rows,
                                    int T_, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kNormWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nchunk = D / 8;
  const T* hr = h + (size_t)row * D;
  float v[C][8];
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (lane + 32 * c < nchunk) load8(hr + 8 * (lane + 32 * c), v[c]);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (lane + 32 * c < nchunk)
#pragma unroll
      for (int i = 0; i < 8; ++i) sum = __fadd_rn(sum, v[c][i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
  const float mu = __fdiv_rn(sum, (float)D);
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (lane + 32 * c < nchunk)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = __fsub_rn(v[c][i], mu);
        sq = __fmaf_rn(d, d, sq);
      }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, o));
  const float var = __fdiv_rn(sq, (float)D);
  const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  const M* sh = shift + (size_t)(row / T_) * mod_stride;
  const M* sm = smod + (size_t)(row / T_) * mod_stride;
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = lane + 32 * c;
    if (k < nchunk) {
      float a[8], b[8];
      load8(sm + 8 * k, a);
      load8(sh + 8 * k, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float yn = __fmul_rn(__fsub_rn(v[c][i], mu), rs);
        v[c][i] = __fadd_rn(__fmul_rn(yn, __fadd_rn(1.f, a[i])), b[i]);
        amax = fmaxf(amax, fabsf(v[c][i]));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f), r = __frcp_rn(sc);
  int8_t* qr = q + (size_t)row * D;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = lane + 32 * c;
    if (k < nchunk) {
      uint32_t b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i] = quant_byte(v[c][i], sc, r);
      *reinterpret_cast<uint2*>(qr + 8 * k) =
          make_uint2(pack_bytes(b[0], b[1], b[2], b[3]), pack_bytes(b[4], b[5], b[6], b[7]));
    }
  }
  if (lane == 0) scale[row] = sc;
}

constexpr int kGeluWarps = 8;  // warps a CTA of K12g's warps kernel: 2 rows of 4 warps
constexpr int kGeluRowWarps = 4;  // warps a row
constexpr int kGeluChunks = 3;  // at most 3 chunks of 8 values a lane: D <= 3072

// gate<1>'s tanh-GELU, its 0.5 (1 + tanh) as one FMA: the same value, since
// halving commutes with the rounding
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return x * __fmaf_rn(0.5f, tanhf(inner), 0.5f);
}

// grid (ceil(rows / 2)), kGeluWarps warps; warp i of CTA b is warp w = i % 4
// of row 2 b + i / 4, and its lane l takes chunks 32 (4 c + w) + l (c < C)
// of 8 values, all loaded before the first GELU; the row's 4 warp maxima
// meet in shared memory after one barrier.
template <typename T, int C>
__global__ void __launch_bounds__(32 * kGeluWarps)
    gelu_quant_warps_kernel(const T* __restrict__ y, int8_t* __restrict__ q,
                            float* __restrict__ scale, int rows, int D) {
  constexpr int W = kGeluRowWarps;
  __shared__ float red[kGeluWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, w = warp % W;
  const int row = blockIdx.x * (kGeluWarps / W) + warp / W;
  const bool live = row < rows;  // a dead row's warps still meet at the barrier
  const int nchunk = D / 8;
  const T* yr = y + (size_t)row * D;
  float v[C][8];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = 32 * (W * c + w) + lane;
    if (live && k < nchunk) load8(yr + 8 * k, v[c]);
  }
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (live && 32 * (W * c + w) + lane < nchunk)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[c][i] = gelu_tanh(v[c][i]);
        amax = fmaxf(amax, fabsf(v[c][i]));
      }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < W; ++j) amax = fmaxf(amax, red[warp - w + j]);
  if (!live) return;
  const float sc = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f), r = __frcp_rn(sc);
  int8_t* qr = q + (size_t)row * D;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = 32 * (W * c + w) + lane;
    if (k < nchunk) {
      uint32_t b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i] = quant_byte_in_row(v[c][i], sc, r);
      *reinterpret_cast<uint2*>(qr + 8 * k) =
          make_uint2(pack_bytes(b[0], b[1], b[2], b[3]), pack_bytes(b[4], b[5], b[6], b[7]));
    }
  }
  if (w == 0 && lane == 0) scale[row] = sc;
}

template <typename K>
cudaError_t set_smem(K* kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int C>
cudaError_t launch_gelu_warps(const void* y, void* q, void* scale, int rows, int D,
                              cudaStream_t st) {
  constexpr int W = kGeluRowWarps;
  if constexpr (C < kGeluChunks) {
    if ((D / 8 + 32 * W - 1) / (32 * W) > C)
      return launch_gelu_warps<T, C + 1>(y, q, scale, rows, D, st);
  }
  if ((D / 8 + 32 * W - 1) / (32 * W) != C) return cudaErrorInvalidValue;  // above 3072
  const int per = kGeluWarps / W, grid = (rows + per - 1) / per;
  gelu_quant_warps_kernel<T, C><<<grid, 32 * kGeluWarps, 0, st>>>(
      static_cast<const T*>(y), static_cast<int8_t*>(q), static_cast<float*>(scale), rows, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gelu(const void* y, void* q, void* scale, int rows, int D, int warps,
                        cudaStream_t st) {
  if (warps) return launch_gelu_warps<T, 1>(y, q, scale, rows, D, st);
  const size_t smem = (size_t)D * sizeof(float);
  auto* kern = gelu_quant_kernel<T>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<rows, kThreads, smem, st>>>(static_cast<const T*>(y), static_cast<int8_t*>(q),
                                     static_cast<float*>(scale), D);
  return cudaGetLastError();
}

template <typename T, typename M, int C>
cudaError_t launch_norm_warp(const void* h, const void* shift, const void* smod, int mod_stride,
                             void* q, void* scale, int rows, int T_, int D, float eps,
                             cudaStream_t st) {
  if constexpr (C < kNormWarpChunks) {
    if ((D / 8 + 31) / 32 > C)
      return launch_norm_warp<T, M, C + 1>(h, shift, smod, mod_stride, q, scale, rows, T_, D, eps,
                                           st);
  }
  if ((D / 8 + 31) / 32 != C) return cudaErrorInvalidValue;  // above 2048 values a row
  const int grid = (rows + kNormWarps - 1) / kNormWarps;
  norm_modulate_quant_warp_kernel<T, M, C><<<grid, 32 * kNormWarps, 0, st>>>(
      static_cast<const T*>(h), static_cast<const M*>(shift), static_cast<const M*>(smod),
      mod_stride, static_cast<int8_t*>(q), static_cast<float*>(scale), rows, T_, D, eps);
  return cudaGetLastError();
}

template <typename T, typename M>
cudaError_t launch_norm(const void* h, const void* shift, const void* smod, int mod_stride,
                        void* q, void* scale, int rows, int T_, int D, float eps, int warp,
                        cudaStream_t st) {
  if (warp)
    return launch_norm_warp<T, M, 1>(h, shift, smod, mod_stride, q, scale, rows, T_, D, eps, st);
  const size_t smem = (size_t)D * sizeof(float);
  auto* kern = norm_modulate_quant_kernel<T, M>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<rows, kThreads, smem, st>>>(static_cast<const T*>(h), static_cast<const M*>(shift),
                                     static_cast<const M*>(smod), mod_stride,
                                     static_cast<int8_t*>(q), static_cast<float*>(scale), T_, D,
                                     eps);
  return cudaGetLastError();
}

}  // namespace

// y (rows, D) bf16 (is_f32 == 0) or f32; q (rows, D) int8; scale (rows,) f32.
// warps 1: 4 warps a row (D <= 3072), 0: one block a row. Needs D % 128 ==
// 0, 4*D bytes of shared memory for the block kernel and 16-byte aligned
// rows; the Python wrapper checks them. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a warps launch above 3072 values).
extern "C" int ao_gelu_quant(const void* y, void* q, void* scale, int rows, int D, int is_f32,
                             int warps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f32 ? launch_gelu<float>(y, q, scale, rows, D, warps, st)
                      : launch_gelu<__nv_bfloat16>(y, q, scale, rows, D, warps, st));
}

// h (B*T, D) bf16 or f32 (h_f32); shift, smod rows of D values, bf16 or f32
// (mod_f32), batch row b's at b * mod_stride; q (B*T, D) int8; scale (B*T,)
// f32. warp 1: one warp a row (D <= 2048, 16-byte aligned modulation rows),
// 0: one block a row. The same needs as ao_gelu_quant. Returns
// cudaGetLastError() (cudaErrorInvalidValue for a warp launch above 2048).
extern "C" int ao_norm_modulate_quant(const void* h, const void* shift, const void* smod,
                                      int mod_stride, void* q, void* scale, int rows, int T,
                                      int D, float eps, int h_f32, int mod_f32, int warp,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (h_f32)
    err = mod_f32 ? launch_norm<float, float>(h, shift, smod, mod_stride, q, scale, rows, T, D,
                                              eps, warp, st)
                  : launch_norm<float, __nv_bfloat16>(h, shift, smod, mod_stride, q, scale, rows,
                                                      T, D, eps, warp, st);
  else
    err = mod_f32 ? launch_norm<__nv_bfloat16, float>(h, shift, smod, mod_stride, q, scale, rows,
                                                      T, D, eps, warp, st)
                  : launch_norm<__nv_bfloat16, __nv_bfloat16>(h, shift, smod, mod_stride, q,
                                                              scale, rows, T, D, eps, warp, st);
  return (int)err;
}
