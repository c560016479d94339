// Single-query decode attention over a paged bf16 KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel ao_tpu/ops/pallas/paged_attention.py::_make_kernel
// in mode "fp" (launched by _impl from paged_decode_attention). The pools
// are (P, page_size, Hkv, D) bf16; sequence b's position t lives in page
// block_table[b, t / page_size] at row t % page_size. For each batch row b
// and kv head, the G = H / Hkv query heads of its group share one K/V
// stream:
//
//   s[h, t] = (q[h] . K[t]) * sm_scale in f32, masked to _NEG where t >= lengths[b];
//   out[h]  = sum_t bf16(p[h, t]) V[t] / max(sum_t p[h, t], 1e-30), f32,
//
// with p = exp(s - max) and bf16(p) rounded against the max of its split,
// as the TPU kernel rounds it against its running max before p . V.
//
// What bounds it on the H100: the K and V bytes of the valid positions
// against 3.35 TB/s, as for K2 (decode_attention.cu), whose structure it
// keeps. The TPU kernel's grid, (B, Hkv), carries one online softmax along a
// sequence's pages and double-buffers their DMAs; that is 64 programs at
// batch 8, far fewer than the card's 132 SMs. Here the positions split
// (flash-decoding): grid (T / 64, Hkv, B) with T = max_pages * page_size,
// each block owns 64 positions, reads each position's page id from the
// block table, stages the K and V rows in shared memory with 16-byte
// loads, and writes its unnormalised output with its max and sum; a second
// pass combines the splits of each head. A split at or past lengths[b]
// returns at once and the combine never reads it; inside the last split,
// rows at or past lengths[b] are neither loaded nor weighted, so a
// block-table entry past a sequence's pages (0, the null page) is never read
// as data. Any page_size works: the page of every row is looked up.
// lengths <= 0 leaves every position masked and the output 0.

#include <cuda_bf16.h>
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

__global__ void __launch_bounds__(kThreads)
    paged_attn_split_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k_pages,
                            const __nv_bfloat16* __restrict__ v_pages,
                            const int* __restrict__ table, const int* __restrict__ lengths,
                            float* __restrict__ o_part, float* __restrict__ m_part,
                            float* __restrict__ l_part, int page_size, int max_pages, int H,
                            int Hkv, int nsplit, float sm_scale) {
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
  __shared__ int page_row[kChunk];  // pool row of each valid position

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < G * kD; i += kThreads) {
    const int gi = i / kD, d = i % kD;
    qs[gi][d] = __bfloat162float(q[((size_t)b * H + kvh * G + gi) * kD + d]);
  }
  for (int r = tid; r < tn; r += kThreads) {
    const int t = t0 + r;
    page_row[r] = table[(size_t)b * max_pages + t / page_size] * page_size + t % page_size;
  }
  __syncthreads();

  const size_t row_stride = (size_t)Hkv * kD;
  for (int i = tid; i < kChunk * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = i % (kD / 8);
    int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
    if (r < tn) {
      const size_t off = (size_t)page_row[r] * row_stride + (size_t)kvh * kD + c * 8;
      kv = __ldg(reinterpret_cast<const int4*>(k_pages + off));
      vv = __ldg(reinterpret_cast<const int4*>(v_pages + off));
    }
    *reinterpret_cast<int4*>(&ks[r][c * 8]) = kv;
    *reinterpret_cast<int4*>(&vs[r][c * 8]) = vv;
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
    ps[gi][r] = r < tn ? acc * sm_scale : kNeg;
  }
  __syncthreads();

  // per-head max and sum over this block's positions; bf16(p) overwrites s
  for (int gi = warp; gi < G; gi += kThreads / 32) {
    float mx = -INFINITY;
    for (int r = lane; r < kChunk; r += 32) mx = fmaxf(mx, ps[gi][r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int r = lane; r < kChunk; r += 32) {
      const float p = expf(ps[gi][r] - mx);
      ps[gi][r] = __bfloat162float(__float2bfloat16(p));
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

// q (B, H, D) bf16; k_pages, v_pages (P, page_size, Hkv, D) bf16; table
// (B, max_pages) int32 page ids < P; lengths (B,) int32; out (B, H, D) f32;
// o_part (B, Hkv, nsplit, G, D), m_part and l_part (B, Hkv, nsplit, G) f32
// with nsplit = ceil(max_pages * page_size / chunk). Needs D == 128 and
// H / Hkv <= 8; the Python wrapper checks them. Returns cudaGetLastError().
extern "C" int ao_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* table, const void* lengths, void* out,
                                  void* o_part, void* m_part, void* l_part, int B, int H,
                                  int Hkv, int page_size, int max_pages, int nsplit,
                                  float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  dim3 grid1(nsplit, Hkv, B);
  paged_attn_split_kernel<<<grid1, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), static_cast<const int*>(table), len,
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
