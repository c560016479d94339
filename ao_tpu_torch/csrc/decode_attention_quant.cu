// Single-query decode attention over an int8 (B, T, Hkv, D) "tokens" KV
// cache with one f32 scale per (batch row, kv head, position), for Hopper
// (sm_90a), in its first design: K5, the reference's "i8" semantics
// (ao_tpu_torch/serving/kvcache.py). Replaces
// ao_tpu/ops/pallas/decode_attention.py::_kt_kernel in mode "i8" (launched
// by _kt_impl). q is quantized per (batch row, kv head) group of G heads:
// qs = max(max |q|, 1e-8) / 127, qi = clip(rint(q / qs), +-127);
//
//   s = f32(dot_i32(qi, K[t])) * ks[t] * (qs * sm_scale), masked at
//   lengths[b]; p = exp(s - max), pv = bf16(p * vs[t]), out = sum_t pv *
//   V[t] / max(sum_t p, 1e-30) in f32, V converted exactly to bf16.
//
// The same function over fp8 e4m3 (K6) and int4 "ch4" (K7) caches, and over
// int8 and e5m2 caches with bf16 q (K2v), runs on the decode mainloop
// (decode_attention.cu, decode_mainloop.cuh): one launch, no workspace. K5
// keeps this file until its own redesign (int8 q and integer dots there).
//
// What bounds it on the H100: the K and V bytes of the valid positions (1 B
// per value plus two f32 scales per position and kv head) against 3.35
// TB/s; the arithmetic is 4 * G operations per cache value, far below the
// ridge. The structure is K2's first design (before the decode mainloop):
// grid (T/64, Hkv, B), each block owns 64 positions of one kv head, stages
// their K and V rows in shared memory with 16-byte coalesced loads (V
// converted to bf16 on the way in), writes its unnormalised output with its
// max and sum, and a second pass combines the splits; splits wholly at or
// past lengths[b] (lengths >= 1) return at once, and inside the last one the
// rows at or past lengths[b] and their scales are not loaded. The scores are
// mma.sync.m16n8k32.s8 with the K rows as the A operand (16 positions x 32
// channels, row-major as stored) and qi^T as B (G <= 8 heads padded to n =
// 8), the operand swap of K1 and K3; p . V is f32 FMAs, as in K2's first
// design.

#include <cuda_bf16.h>
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

__device__ __forceinline__ void mma_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 stored int8 bytes of one row -> 16 bf16 values at dst, exact.
__device__ __forceinline__ void to_bf16(int4 raw, __nv_bfloat16* dst) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
  __align__(16) __nv_bfloat16 v[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = __float2bfloat16_rn((float)static_cast<int8_t>(b[e]));
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&v[0]);
  *reinterpret_cast<uint4*>(dst + 8) = *reinterpret_cast<const uint4*>(&v[8]);
}

__global__ void __launch_bounds__(kThreads)
    quant_split_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
                       const float* __restrict__ kscale, const uint8_t* __restrict__ v,
                       const float* __restrict__ vscale, const int* __restrict__ lengths,
                       float* __restrict__ o_part, float* __restrict__ m_part,
                       float* __restrict__ l_part, int T, int H, int Hkv, int nsplit,
                       float sm_scale) {
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int L = lengths[b];
  const int t0 = sp * kChunk;
  if (L >= 1 && t0 >= L) return;
  const int tn = min(kChunk, T - t0);
  const int tl = L >= 1 ? min(tn, L - t0) : tn;  // rows to load: none at or past L

  // K as int8 rows of kRow8 bytes in a block the size of V's bf16 tile:
  // the shared-memory footprint, and so the blocks an SM holds, that the
  // kernel's times in PERF.md were taken at
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
  const size_t row_stride = (size_t)Hkv * kD;
  const size_t base = ((size_t)b * T + t0) * row_stride + (size_t)kvh * kD;
  for (int i = tid; i < kChunk * (kD / 16); i += kThreads) {
    const int r = i / (kD / 16), c = i % (kD / 16);
    int4 kr = make_int4(0, 0, 0, 0), vr = make_int4(0, 0, 0, 0);
    if (r < tl) {
      kr = __ldg(reinterpret_cast<const int4*>(k + base + r * row_stride + c * 16));
      vr = __ldg(reinterpret_cast<const int4*>(v + base + r * row_stride + c * 16));
    }
    *reinterpret_cast<int4*>(&k8[r][c * 16]) = kr;
    to_bf16(vr, &vs[r][c * 16]);
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red[warp] = amax;
  __syncthreads();  // also publishes qs
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float qscale = fmaxf(amax, 1e-8f) / 127.f;
  const float cq = qscale * sm_scale;  // of this (batch row, kv head)
  for (int i = tid; i < kGMax * kD; i += kThreads) {
    const int gi = i / kD, d = i % kD;
    q8[gi][d] = gi < G ? (int8_t)fminf(fmaxf(rintf(qs[gi][d] / qscale), -127.f), 127.f) : 0;
  }
  __syncthreads();

  {
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

// K5: q (B, H, D) bf16; k, v (B, T, Hkv, D) int8; ks, vs (B, Hkv, T) f32;
// lengths (B,) int32; out (B, H, D) f32; o_part (B, Hkv, nsplit, G, D),
// m_part and l_part (B, Hkv, nsplit, G) f32 with nsplit = ceil(T / chunk).
// Needs D == 128 and H / Hkv <= 8, 16-byte aligned caches; the Python
// wrapper checks them. Returns cudaGetLastError().
extern "C" int ao_decode_attention_quant(const void* q, const void* k, const void* ks,
                                         const void* v, const void* vs, const void* lengths,
                                         void* out, void* o_part, void* m_part, void* l_part,
                                         int B, int H, int Hkv, int T, int nsplit, float sm_scale,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const dim3 grid1(nsplit, Hkv, B);
  quant_split_kernel<<<grid1, kThreads, 0, st>>>(
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
