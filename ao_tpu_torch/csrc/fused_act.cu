// Gated-MLP activation with per-token int8 quantization in the producer, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel ao_tpu/ops/pallas/fused_act.py::
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
