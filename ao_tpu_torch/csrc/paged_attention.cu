// Single-query decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel ao_tpu/ops/pallas/paged_attention.py::_make_kernel
// (launched by _impl from paged_decode_attention) in its three modes, one
// template here:
//
//   mode kFP, "fp": bf16 pools (P, page_size, Hkv, D);
//   mode kI8 / kF8, "vec8": int8 or fp8 e4m3 pools (P, page_size, Hkv, D);
//   mode kI4, "int4": int4 pools in the port's "ch4" form (P, page_size, Hkv,
//       D/8) int32, 8 channel nibbles u at bits [4o, 4o + 4) of a word,
//       value u - 8 (ao_tpu_torch/serving/paged.py);
//
// the quantized pools with one f32 scale per cached vector, (P, Hkv,
// page_size). Sequence b's position t lives in page block_table[b, t /
// page_size] at row t % page_size. For each batch row b and kv head, the
// G = H / Hkv query heads of its group share one K/V stream:
//
//   s[h, t] = (q[h] . K[t]) * sm_scale (* ks[t]) in f32, masked to _NEG where
//             t >= lengths[b];
//   out[h]  = sum_t bf16(p[h, t] (* vs[t])) V[t] / max(sum_t p[h, t], 1e-30), f32,
//
// with p = exp(s - max), rounded against the max of its split as the TPU
// kernel rounds it against its running max before p . V. The stored values
// become bf16 exactly on the way into shared memory (int8 by value, e4m3 by
// the hardware's cvt to f16, int4 nibbles by the int4 weight kernels' bf16
// bit trick, (w >> 4j) & 0x000F000F | 0x43004300 = bf16x2 128 + u of
// channels j and j + 4), and the scales fold into each score row and each
// probability column ("scale-commuted, no dequant multiplies", as the TPU
// kernel does).
//
// What bounds it on the H100: the K and V bytes of the valid positions (2 B
// per value for bf16, 1 B for int8 and fp8, half a byte for int4, plus two
// f32 scales per position and kv head) against 3.35 TB/s, as for K2 and
// K5-K7 (decode_attention*.cu), whose structure it keeps. The TPU kernel's
// grid, (B, Hkv), carries one online softmax along a sequence's pages and
// double-buffers their DMAs; that is 64 programs at batch 8, far fewer than
// the card's 132 SMs. Here the positions split (flash-decoding): grid
// (T / 64, Hkv, B) with T = max_pages * page_size, each block owns 64
// positions, reads each position's page id from the block table, stages the
// K and V rows in shared memory with 16-byte loads, and writes its
// unnormalised output with its max and sum; a second pass combines the
// splits of each head. A split at or past lengths[b] returns at once and the
// combine never reads it; inside the last split, rows at or past lengths[b]
// and their scales are neither loaded nor weighted, so a block-table entry
// past a sequence's pages (0, the null page, where idle lanes write) is
// never read as data, and no stored byte there (an e4m3 0x7F is NaN) reaches
// the output. Any page_size works: the page of every row is looked up (the
// TPU kernel needs page_size % 128 for quantized pools, for its lanes).
// lengths <= 0 leaves every position masked and the output 0.

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
constexpr int kPad = 8;     // row padding (bf16): 16-byte reads stay bank-conflict free
constexpr float kNeg = -0.7f * 3.4028234663852886e38f;  // paged_attention.py:34

enum Mode { kFP = 0, kI8 = 1, kF8 = 2, kI4 = 3 };

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf162(uint32_t x) {
  return *reinterpret_cast<__nv_bfloat162*>(&x);
}

// 16 stored bytes of one row -> bf16 values at dst: 8 values for bf16, 16
// for int8 and fp8, 32 for int4 (four words of 8 channels each); exact.
template <int MODE>
__device__ __forceinline__ void to_bf16(int4 raw, __nv_bfloat16* dst) {
  if constexpr (MODE == kFP) {
    *reinterpret_cast<int4*>(dst) = raw;
  } else if constexpr (MODE == kI4) {
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
    for (int e = 0; e < 16; ++e) {
      if constexpr (MODE == kF8) {
        // e4m3 -> f16 in hardware -> f32 -> bf16, each step exact
        const __half h(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(b[e]), __NV_E4M3));
        v[e] = __float2bfloat16_rn(__half2float(h));
      } else {
        v[e] = __float2bfloat16_rn((float)static_cast<int8_t>(b[e]));
      }
    }
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&v[0]);
    *reinterpret_cast<uint4*>(dst + 8) = *reinterpret_cast<const uint4*>(&v[8]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    paged_attn_split_kernel(const __nv_bfloat16* __restrict__ q,
                            const uint8_t* __restrict__ k_pages,
                            const float* __restrict__ k_scale,
                            const uint8_t* __restrict__ v_pages,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ table, const int* __restrict__ lengths,
                            float* __restrict__ o_part, float* __restrict__ m_part,
                            float* __restrict__ l_part, int page_size, int max_pages, int H,
                            int Hkv, int nsplit, float sm_scale) {
  // stored bytes of one row, and values per 16 stored bytes
  constexpr int kRowBytes = MODE == kFP ? 2 * kD : MODE == kI4 ? kD / 2 : kD;
  constexpr int kVals = MODE == kFP ? 8 : MODE == kI4 ? 32 : 16;
  constexpr bool kQuant = MODE != kFP;
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int L = min(lengths[b], max_pages * page_size);
  const int t0 = sp * kChunk;
  if (t0 >= L) return;
  const int tn = min(kChunk, L - t0);  // valid positions of this split

  __shared__ __align__(16) __nv_bfloat16 ks[kChunk][kD + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kChunk][kD + kPad];
  __shared__ float qs[kGMax][kD];
  __shared__ float ps[kGMax][kChunk];
  __shared__ float ksc[kChunk], vsc[kChunk];
  __shared__ int page_row[kChunk];  // pool row of each valid position

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < G * kD; i += kThreads) {
    const int gi = i / kD, d = i % kD;
    qs[gi][d] = __bfloat162float(q[((size_t)b * H + kvh * G + gi) * kD + d]);
  }
  for (int r = tid; r < kChunk; r += kThreads) {
    float kscl = 0.f, vscl = 0.f;
    if (r < tn) {
      const int t = t0 + r;
      const int page = table[(size_t)b * max_pages + t / page_size], off = t % page_size;
      page_row[r] = page * page_size + off;
      if constexpr (kQuant) {
        const size_t si = ((size_t)page * Hkv + kvh) * page_size + off;
        kscl = k_scale[si];
        vscl = v_scale[si];
      }
    }
    ksc[r] = kscl;
    vsc[r] = vscl;
  }
  __syncthreads();

  const size_t row_stride = (size_t)Hkv * kRowBytes;
  for (int i = tid; i < kChunk * (kRowBytes / 16); i += kThreads) {
    const int r = i / (kRowBytes / 16), c = i % (kRowBytes / 16);
    int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
    if (r < tn) {
      const size_t off = (size_t)page_row[r] * row_stride + (size_t)kvh * kRowBytes + c * 16;
      kv = __ldg(reinterpret_cast<const int4*>(k_pages + off));
      vv = __ldg(reinterpret_cast<const int4*>(v_pages + off));
    }
    to_bf16<MODE>(kv, &ks[r][c * kVals]);
    to_bf16<MODE>(vv, &vs[r][c * kVals]);
  }
  __syncthreads();

  // scores: one (head, position) pair per thread and pass
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
    float sc = acc * sm_scale;
    if constexpr (kQuant) sc = sc * ksc[r];
    ps[gi][r] = r < tn ? sc : kNeg;
  }
  __syncthreads();

  // per-head max and sum over this block's positions; bf16(p (* vs))
  // overwrites s
  for (int gi = warp; gi < G; gi += kThreads / 32) {
    float mx = -INFINITY;
    for (int r = lane; r < kChunk; r += 32) mx = fmaxf(mx, ps[gi][r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int r = lane; r < kChunk; r += 32) {
      const float p = expf(ps[gi][r] - mx);
      ps[gi][r] = __bfloat162float(__float2bfloat16(kQuant ? p * vsc[r] : p));
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

  // unnormalised bf16(p) . V over the valid rows: four dims of one head per
  // thread and pass
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

// grid (H, B), kD threads: merge the splits of one query head that lie
// below lengths[b]; none for lengths <= 0, and the output is 0.
__global__ void __launch_bounds__(kD)
    paged_attn_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                              const float* __restrict__ l_part, const int* __restrict__ lengths,
                              float* __restrict__ out, int H, int Hkv, int nsplit, int T) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int G = H / Hkv;
  const int kvh = h / G, gi = h % G;
  const int L = min(lengths[b], T);
  const int nvalid = L >= 1 ? (L + kChunk - 1) / kChunk : 0;
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

extern "C" int ao_paged_attention_chunk(void) { return kChunk; }
extern "C" int ao_paged_attention_max_group(void) { return kGMax; }
extern "C" int ao_paged_attention_head_dim(void) { return kD; }

// mode 0 ("fp", bf16), 1 (int8), 2 (fp8 e4m3), 3 (int4 "ch4"). q (B, H, D)
// bf16; k_pages, v_pages (P, page_size, Hkv, D) bf16 / int8 / e4m3 or
// (P, page_size, Hkv, D/8) int32; k_scale, v_scale (P, Hkv, page_size) f32
// (unread in mode 0); table (B, max_pages) int32 page ids < P; lengths (B,)
// int32; out (B, H, D) f32; o_part (B, Hkv, nsplit, G, D), m_part and
// l_part (B, Hkv, nsplit, G) f32 with nsplit = ceil(max_pages * page_size /
// chunk). Needs D == 128 and H / Hkv <= 8, 16-byte aligned pools; the
// Python wrapper checks them. Returns cudaGetLastError().
extern "C" int ao_paged_attention(int mode, const void* q, const void* k_pages,
                                  const void* k_scale, const void* v_pages, const void* v_scale,
                                  const void* table, const void* lengths, void* out,
                                  void* o_part, void* m_part, void* l_part, int B, int H,
                                  int Hkv, int page_size, int max_pages, int nsplit,
                                  float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  auto* kern = mode == kFP   ? paged_attn_split_kernel<kFP>
               : mode == kI8 ? paged_attn_split_kernel<kI8>
               : mode == kF8 ? paged_attn_split_kernel<kF8>
               : mode == kI4 ? paged_attn_split_kernel<kI4>
                             : nullptr;
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid1(nsplit, Hkv, B);
  kern<<<grid1, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k_pages),
      static_cast<const float*>(k_scale), static_cast<const uint8_t*>(v_pages),
      static_cast<const float*>(v_scale), static_cast<const int*>(table), len,
      static_cast<float*>(o_part), static_cast<float*>(m_part), static_cast<float*>(l_part),
      page_size, max_pages, H, Hkv, nsplit, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2(H, B);
  paged_attn_combine_kernel<<<grid2, kD, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), len, static_cast<float*>(out), H, Hkv, nsplit,
      max_pages * page_size);
  return (int)cudaGetLastError();
}
