// Single-query decode attention over quantized (B, T, Hkv, *) KV caches with
// one f32 scale per (batch row, kv head, position), for Hopper (sm_90a).
// One kernel template, three kernels (ao_tpu_torch/serving/kvcache.py), in
// their first design (K2v, the same function over int8 and e5m2 caches with
// bf16 q, runs on the decode mainloop: decode_attention.cu):
//
//   K5, mode kI8: int8 "tokens" cache, the reference's "i8" semantics.
//       Replaces ao_tpu/ops/pallas/decode_attention.py::_kt_kernel in mode
//       "i8" (launched by _kt_impl). q is quantized per (batch row, kv head)
//       group of G heads: qs = max(max |q|, 1e-8) / 127, qi =
//       clip(rint(q / qs), +-127); s = f32(dot_i32(qi, K[t])) * ks[t] *
//       (qs * sm_scale).
//   K6, mode kF8: fp8 e4m3 "tokens" cache. Replaces _f8_kernel (launched by
//       _f8_impl) and the fp8 form of _tok_kernel "vec8": s = dot_f32(q,
//       K[t]) * sm_scale * ks[t], K converted exactly to bf16 in hardware
//       (the TPU kernel spliced bytes and folded 2^60 / 2^120 into the
//       scales because v5e has no fp8 convert; none of that is needed here).
//   K7, mode kI4: int4 "ch4" cache, words of 8 channel nibbles u at bits
//       [4o, 4o+4), value u - 8. Replaces _ck4_kernel (launched by _ck4_impl)
//       and _int4_kernel (_int4_impl), the same function over the
//       reference's other int4 layouts: s = dot_f32(q, u - 8) * sm_scale *
//       ks[t]. (w >> 4j) & 0x000F000F | 0x43004300 is bf16x2 128 + u of
//       channels j and j + 4, as in the int4 weight kernel (int4_matmul.cu);
//       subtracting 136 in bf16 is exact.
//
// In all of them, with q in bf16 and the mask at lengths[b]:
//   p = exp(s - max), pv = bf16(p * vs[t]), out = sum_t pv * V[t] /
//   max(sum_t p, 1e-30) in f32, V converted exactly to bf16.
//
// What bounds them on the H100: the K and V bytes of the valid positions
// (1 B per value for int8 and fp8, half a byte for int4, plus two f32
// scales per position and kv head) against 3.35 TB/s; the arithmetic is 4 *
// G operations per cache value, far below the ridge. The structure is K2's
// first design (before the decode mainloop): grid (T/64, Hkv, B), each
// block owns 64 positions
// of one kv head, stages their K and V rows in shared memory with 16-byte
// coalesced loads (converted to bf16 on the way in, except K5's int8 K),
// writes its unnormalised output with its max and sum, and a second pass
// combines the splits; splits wholly at or past lengths[b] (lengths >= 1)
// return at once, and inside the last one the rows at or past lengths[b]
// and their scales are not loaded (a stored byte there, such as an fp8 NaN,
// never reaches the output). K5's scores are mma.sync.m16n8k32.s8 with the
// K rows as the A operand (16 positions x 32 channels, row-major as stored)
// and qi^T as B (G <= 8 heads padded to n = 8), the operand swap of K1 and
// K3; the other kernels' scores and every p.V are f32 FMAs, as in K2.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;     // head dim
constexpr int kChunk = 64;  // positions per block
constexpr int kGMax = 8;    // query heads per kv head
constexpr int kThreads = 128;
constexpr int kPad = 8;     // bf16 row padding: 16-byte reads stay bank-conflict free
constexpr int kRow8 = kD + 16;  // int8 row stride (bytes): fragment reads conflict free
constexpr float kNeg = -0.7f * 3.4028234663852886e38f;  // decode_attention.py:52

enum Mode { kI8 = 0, kF8 = 1, kI4 = 2 };

__device__ __forceinline__ void mma_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf162(uint32_t x) {
  return *reinterpret_cast<__nv_bfloat162*>(&x);
}

template <__nv_fp8_interpretation_t KIND>
__device__ __forceinline__ __nv_bfloat16 fp8_to_bf16(uint8_t x) {
  // fp8 -> half -> float -> bf16: each step exact for every e4m3
  const __half h(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(x), KIND));
  return __float2bfloat16_rn(__half2float(h));
}

// 16 stored bytes of one row -> bf16 values at dst: 16 values for int8 and
// fp8, 32 for int4 (four words of 8 channels each).
template <int MODE>
__device__ __forceinline__ void to_bf16(int4 raw, __nv_bfloat16* dst) {
  if constexpr (MODE == kI4) {
    const uint32_t w[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z, (uint32_t)raw.w};
    const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 p[4];  // p[j] = (channel j, channel j + 4) of word i
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[j] = __hsub2(bits_bf162(((w[i] >> (4 * j)) & 0x000F000Fu) | 0x43004300u), bias);
      uint4 o;
      o.x = bf162_bits(__lows2bfloat162(p[0], p[1]));
      o.y = bf162_bits(__lows2bfloat162(p[2], p[3]));
      o.z = bf162_bits(__highs2bfloat162(p[0], p[1]));
      o.w = bf162_bits(__highs2bfloat162(p[2], p[3]));
      *reinterpret_cast<uint4*>(dst + 8 * i) = o;
    }
  } else {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    __align__(16) __nv_bfloat16 v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e)
      v[e] = MODE == kF8 ? fp8_to_bf16<__NV_E4M3>(b[e])
                         : __float2bfloat16_rn((float)static_cast<int8_t>(b[e]));
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&v[0]);
    *reinterpret_cast<uint4*>(dst + 8) = *reinterpret_cast<const uint4*>(&v[8]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    quant_split_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
                       const float* __restrict__ kscale, const uint8_t* __restrict__ v,
                       const float* __restrict__ vscale, const int* __restrict__ lengths,
                       float* __restrict__ o_part, float* __restrict__ m_part,
                       float* __restrict__ l_part, int T, int H, int Hkv, int nsplit,
                       float sm_scale) {
  constexpr int kRowBytes = MODE == kI4 ? kD / 2 : kD;  // stored bytes of one row
  constexpr int kVals = MODE == kI4 ? 32 : 16;          // values per 16 stored bytes
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int L = lengths[b];
  const int t0 = sp * kChunk;
  if (L >= 1 && t0 >= L) return;
  const int tn = min(kChunk, T - t0);
  const int tl = L >= 1 ? min(tn, L - t0) : tn;  // rows to load: none at or past L

  // K as bf16 (K6, K7) or, for K5, the same bytes as int8 rows of kRow8
  __shared__ __align__(16) __nv_bfloat16 ks[kChunk][kD + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kChunk][kD + kPad];
  __shared__ __align__(16) int8_t q8[kGMax][kRow8];
  __shared__ float qs[kGMax][kD];
  __shared__ float ps[kGMax][kChunk];
  __shared__ float ksc[kChunk], vsc[kChunk];
  __shared__ float red[kThreads / 32];
  int8_t(*k8)[kRow8] = reinterpret_cast<int8_t(*)[kRow8]>(&ks[0][0]);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  float amax = 0.f;
  for (int i = tid; i < G * kD; i += kThreads) {
    const int gi = i / kD, d = i % kD;
    const float f = __bfloat162float(q[((size_t)b * H + kvh * G + gi) * kD + d]);
    qs[gi][d] = f;
    amax = fmaxf(amax, fabsf(f));
  }
  const size_t srow = ((size_t)b * Hkv + kvh) * T + t0;
  for (int r = tid; r < kChunk; r += kThreads) {
    ksc[r] = r < tl ? kscale[srow + r] : 0.f;
    vsc[r] = r < tl ? vscale[srow + r] : 0.f;
  }
  const size_t row_stride = (size_t)Hkv * kRowBytes;
  const size_t base = ((size_t)b * T + t0) * row_stride + (size_t)kvh * kRowBytes;
  for (int i = tid; i < kChunk * (kRowBytes / 16); i += kThreads) {
    const int r = i / (kRowBytes / 16), c = i % (kRowBytes / 16);
    int4 kr = make_int4(0, 0, 0, 0), vr = make_int4(0, 0, 0, 0);
    if (r < tl) {
      kr = __ldg(reinterpret_cast<const int4*>(k + base + r * row_stride + c * 16));
      vr = __ldg(reinterpret_cast<const int4*>(v + base + r * row_stride + c * 16));
    }
    if constexpr (MODE == kI8)
      *reinterpret_cast<int4*>(&k8[r][c * 16]) = kr;
    else
      to_bf16<MODE>(kr, &ks[r][c * kVals]);
    to_bf16<MODE>(vr, &vs[r][c * kVals]);
  }

  float cq = 0.f;  // K5: qs * sm_scale of this (batch row, kv head)
  if constexpr (MODE == kI8) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) red[warp] = amax;
    __syncthreads();  // also publishes qs
    amax = red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, red[w]);
    const float qscale = fmaxf(amax, 1e-8f) / 127.f;
    cq = qscale * sm_scale;
    for (int i = tid; i < kGMax * kD; i += kThreads) {
      const int gi = i / kD, d = i % kD;
      q8[gi][d] = gi < G ? (int8_t)fminf(fmaxf(rintf(qs[gi][d] / qscale), -127.f), 127.f) : 0;
    }
  }
  __syncthreads();

  if constexpr (MODE == kI8) {
    // warp w: positions 16w .. 16w + 15 as the m16 tile, the 8 q columns as n
    const int gid = lane >> 2, tig = lane & 3;
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kk = 0; kk < kD / 32; ++kk) {
      const int8_t* pa = &k8[16 * warp + gid][32 * kk + 4 * tig];
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(pa),
                             *reinterpret_cast<const uint32_t*>(pa + 8 * kRow8),
                             *reinterpret_cast<const uint32_t*>(pa + 16),
                             *reinterpret_cast<const uint32_t*>(pa + 8 * kRow8 + 16)};
      const int8_t* pb = &q8[gid][32 * kk + 4 * tig];
      mma_16832(acc, a, *reinterpret_cast<const uint32_t*>(pb),
                *reinterpret_cast<const uint32_t*>(pb + 16));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + gid + (e >= 2 ? 8 : 0), gi = 2 * tig + (e & 1);
      if (gi >= G) continue;
      float sc = (float)acc[e] * ksc[r] * cq;
      if (t0 + r >= L) sc = kNeg;
      if (r >= tn) sc = -INFINITY;  // past the end of the cache: no position at all
      ps[gi][r] = sc;
    }
  } else {
    // one (head, position) pair per thread and pass
    for (int i = tid; i < G * kChunk; i += kThreads) {
      const int gi = i / kChunk, r = i % kChunk;
      float acc = 0.f;
#pragma unroll 4
      for (int c = 0; c < kD / 8; ++c) {
        const int4 kk = *reinterpret_cast<const int4*>(&ks[r][c * 8]);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          acc = fmaf(qs[gi][c * 8 + 2 * e], f.x, acc);
          acc = fmaf(qs[gi][c * 8 + 2 * e + 1], f.y, acc);
        }
      }
      float sc = acc * sm_scale * ksc[r];
      if (t0 + r >= L) sc = kNeg;
      if (r >= tn) sc = -INFINITY;
      ps[gi][r] = sc;
    }
  }
  __syncthreads();

  // per-head max and sum of p over this block's positions; bf16(p * vs)
  // overwrites s
  for (int gi = warp; gi < G; gi += kThreads / 32) {
    float mx = -INFINITY;
    for (int r = lane; r < kChunk; r += 32) mx = fmaxf(mx, ps[gi][r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int r = lane; r < kChunk; r += 32) {
      const float p = expf(ps[gi][r] - mx);
      ps[gi][r] = __bfloat162float(__float2bfloat16_rn(p * vsc[r]));
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const size_t idx = (((size_t)b * Hkv + kvh) * nsplit + sp) * G + gi;
      m_part[idx] = mx;
      l_part[idx] = sum;
    }
  }
  __syncthreads();

  // unnormalised pv . V: four dims of one head per thread and pass
  for (int i = tid; i < G * (kD / 4); i += kThreads) {
    const int gi = i / (kD / 4), d4 = i % (kD / 4);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < tn; ++r) {
      const float p = ps[gi][r];
      const uint2 raw = *reinterpret_cast<const uint2*>(&vs[r][4 * d4]);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      acc.x = fmaf(p, lo.x, acc.x);
      acc.y = fmaf(p, lo.y, acc.y);
      acc.z = fmaf(p, hi.x, acc.z);
      acc.w = fmaf(p, hi.y, acc.w);
    }
    const size_t idx = (((size_t)b * Hkv + kvh) * nsplit + sp) * G + gi;
    *reinterpret_cast<float4*>(o_part + idx * kD + 4 * d4) = acc;
  }
}

// grid (H, B), kD threads: merge the splits of one query head (K2's combine).
__global__ void __launch_bounds__(kD)
    quant_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                         const float* __restrict__ l_part, const int* __restrict__ lengths,
                         float* __restrict__ out, int H, int Hkv, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int G = H / Hkv;
  const int kvh = h / G, gi = h % G;
  const int L = lengths[b];
  const int nvalid = L >= 1 ? min((L + kChunk - 1) / kChunk, nsplit) : nsplit;
  const size_t base = ((size_t)b * Hkv + kvh) * nsplit;
  float mx = -INFINITY;
  for (int sp = 0; sp < nvalid; ++sp) mx = fmaxf(mx, m_part[(base + sp) * G + gi]);
  float lsum = 0.f, acc = 0.f;
  for (int sp = 0; sp < nvalid; ++sp) {
    const size_t idx = (base + sp) * G + gi;
    const float w = expf(m_part[idx] - mx);
    lsum = fmaf(w, l_part[idx], lsum);
    acc = fmaf(w, o_part[idx * kD + d], acc);
  }
  out[((size_t)b * H + h) * kD + d] = acc / fmaxf(lsum, 1e-30f);
}

}  // namespace

extern "C" int ao_decode_attention_quant_chunk(void) { return kChunk; }
extern "C" int ao_decode_attention_quant_max_group(void) { return kGMax; }
extern "C" int ao_decode_attention_quant_head_dim(void) { return kD; }

// mode 0 (K5, int8), 1 (K6, fp8 e4m3), 2 (K7, int4 "ch4"). q (B, H, D)
// bf16; k, v (B, T, Hkv, D) int8 / e4m3 or (B, T, Hkv, D/8) int32; ks, vs
// (B, Hkv, T) f32; lengths (B,) int32; out (B, H, D) f32; o_part
// (B, Hkv, nsplit, G, D), m_part and l_part (B, Hkv, nsplit, G) f32 with
// nsplit = ceil(T / chunk). Needs D == 128 and H / Hkv <= 8, 16-byte aligned
// caches; the Python wrapper checks them. Returns cudaGetLastError().
extern "C" int ao_decode_attention_quant(int mode, const void* q, const void* k, const void* ks,
                                         const void* v, const void* vs, const void* lengths,
                                         void* out, void* o_part, void* m_part, void* l_part,
                                         int B, int H, int Hkv, int T, int nsplit, float sm_scale,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const dim3 grid1(nsplit, Hkv, B);
  auto* kern = mode == kI8   ? quant_split_kernel<kI8>
               : mode == kF8 ? quant_split_kernel<kF8>
               : mode == kI4 ? quant_split_kernel<kI4>
                             : nullptr;
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  kern<<<grid1, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k),
      static_cast<const float*>(ks), static_cast<const uint8_t*>(v),
      static_cast<const float*>(vs), len, static_cast<float*>(o_part),
      static_cast<float*>(m_part), static_cast<float*>(l_part), T, H, Hkv, nsplit, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2(H, B);
  quant_combine_kernel<<<grid2, kD, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), len, static_cast<float*>(out), H, Hkv, nsplit);
  return (int)cudaGetLastError();
}
