// Flash attention for prefill, causal or not, over a bf16 (B, Sk, Hkv, D)
// KV cache with grouped-query heads, for Hopper (sm_90a).
//
// Replaces the TPU kernel ao_tpu/ops/pallas/flash_attention.py::_kernel
// (launched by _flash_impl). For batch row b and query head h, whose kv head
// is h / G (G = H / Hkv):
//
//   s[i, j] = (q[i] . K[j]) * sm_scale in f32; causal: masked to _MASK where
//             j > i (top-left aligned: query row i, counted from 0, sees
//             cache rows 0..i, also when Sq < Sk);
//   out[i]  = sum_j bf16(p[i, j]) V[j] / sum_j p[i, j], p = exp(s - running
//             max), an online softmax with f32 statistics; bf16 out.
//
// q is (B, Sq, H, D) and the output (B, Sq, H, D), the layout the model's
// projections produce and consume, so neither is transposed; K and V are
// read in place from the cache, each kv head's rows once per query tile,
// with no repeat over the G query heads that share them.
//
// What bounds it on the H100: the products, 4 * D flops per (query, key)
// pair that the mask keeps, against 989 TFLOP/s of bf16 tensor cores; the
// bytes (q, K, V, out) are far smaller. The TPU kernel ran 512-row tiles on
// one core's matrix unit in a sequential grid. Here a block of four warps
// owns 64 query rows of one head (grid: Sq/64 tiles x H x B, 256 blocks at
// B = 1, S = 512), walks the 64-key tiles of K and V up to its last row
// (causally, keys past that row are never loaded: zeros stand in for them
// in the last tile, and with Sq < Sk the cache rows past Sq, which a
// prefill has not written, are never read), stages each in shared
// memory with 16-byte coalesced loads, and runs both products on the
// tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate): each warp
// keeps its 16 q rows as A fragments and its 16 x 128 output in registers,
// and turns the score fragments into the A fragments of p.V without a trip
// through shared memory; V's B fragments come from ldmatrix.trans. One
// buffer per tile and no cp.async pipeline yet: a simple first kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;       // head dim
constexpr int kBlockQ = 64;   // query rows per block, 16 per warp
constexpr int kBlockK = 64;   // keys per tile
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // row padding (bf16): fragment loads stay bank-conflict free
constexpr int kRow = kD + kPad;
constexpr float kMask = -0.7f * 3.4028234663852886e38f;  // flash_attention.py:26

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b: A 16x16 row-major, B 16x8 column-major, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory, transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__global__ void __launch_bounds__(kThreads)
    flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                         int Sq, int Sk, int H, int Hkv, float sm_scale, int causal) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQ;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group

  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK][kRow];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK][kRow];

  // this warp's 16 query rows (r0 and r1 = r0 + 8 for this thread) as the
  // A fragments of the eight 16-dim steps of q . K
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const size_t q_stride = (size_t)H * kD;
  const __nv_bfloat16* qp0 = q + ((size_t)b * Sq + min(r0, Sq - 1)) * q_stride + (size_t)h * kD;
  const __nv_bfloat16* qp1 = q + ((size_t)b * Sq + min(r1, Sq - 1)) * q_stride + (size_t)h * kD;
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int d = kk * 16 + 2 * tig;
    qa[kk][0] = r0 < Sq ? ld32(qp0 + d) : 0u;
    qa[kk][1] = r1 < Sq ? ld32(qp1 + d) : 0u;
    qa[kk][2] = r0 < Sq ? ld32(qp0 + d + 8) : 0u;
    qa[kk][3] = r1 < Sq ? ld32(qp1 + d + 8) : 0u;
  }

  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // the keys this block needs: all of them, or (causal) up to its last row
  const int q_last = min(q0 + kBlockQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const size_t kv_stride = (size_t)Hkv * kD;
  const size_t kv_base = (size_t)b * Sk * kv_stride + (size_t)kvh * kD;

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBlockK * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8), c = i % (kD / 8);
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      if (k0 + r < k_end) {  // keys past the block's last row are never read
        const size_t off = kv_base + (size_t)(k0 + r) * kv_stride + c * 8;
        kv = __ldg(reinterpret_cast<const int4*>(k + off));
        vv = __ldg(reinterpret_cast<const int4*>(v + off));
      }
      *reinterpret_cast<int4*>(&ks[r][c * 8]) = kv;
      *reinterpret_cast<int4*>(&vs[r][c * 8]) = vv;
    }
    __syncthreads();

    // s = q . K^T for 16 rows x 64 keys: n-tile n holds keys k0 + 8n .. +7
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        const __nv_bfloat16* kr = &ks[n * 8 + g][kk * 16 + 2 * tig];
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale and mask; this tile's row maxima, merged into the running ones
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + n * 8 + 2 * tig + e;
        float v0 = s[n][e] * sm_scale, v1 = s[n][2 + e] * sm_scale;
        if (col >= Sk) {
          v0 = v1 = -INFINITY;  // past the cache: no key at all
        } else if (causal) {
          if (col > r0) v0 = kMask;
          if (col > r1) v1 = kMask;
        }
        s[n][e] = v0;
        s[n][2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    // every tile holds a key below Sk, so mx is finite and alpha is 0 on the first tile
    const float alpha0 = expf(m0 - mx0), alpha1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // p = exp(s - m): f32 row sums; bf16 p as the A fragments of p . V
    // (the score fragment of n-tiles 2j and 2j + 1 is the A fragment of
    // the 16-key step j)
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t pa[kBlockK / 16][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      const float p00 = expf(s[n][0] - m0), p01 = expf(s[n][1] - m0);
      const float p10 = expf(s[n][2] - m1), p11 = expf(s[n][3] - m1);
      rs0 += p00 + p01;
      rs1 += p10 + p11;
      pa[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p00, p01);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p10, p11);
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, o_);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, o_);
    }
    l0 = alpha0 * l0 + rs0;
    l1 = alpha1 * l1 + rs1;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // o += p . V: ldmatrix.trans gives the B fragments of two 8-dim
    // n-tiles of one 16-key step (matrices: keys +0..7 and +8..15, at
    // dims d0 and d0 + 8)
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
#pragma unroll
      for (int n = 0; n < kD / 8; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &vs[j * 16 + lrow][n * 8 + lcol]);
        mma_bf16(o[n], pa[j], bv[0], bv[1]);
        mma_bf16(o[n + 1], pa[j], bv[2], bv[3]);
      }
    }
  }

  // each row's largest score adds exp(0) = 1 to its sum, so l >= 1
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* op0 = out + ((size_t)b * Sq + min(r0, Sq - 1)) * q_stride + (size_t)h * kD;
  __nv_bfloat16* op1 = out + ((size_t)b * Sq + min(r1, Sq - 1)) * q_stride + (size_t)h * kD;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int d = n * 8 + 2 * tig;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(op0 + d) = pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(op1 + d) = pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace

extern "C" int ao_flash_attention_head_dim(void) { return kD; }
extern "C" int ao_flash_attention_block_k(void) { return kBlockK; }

// q (B, Sq, H, D) bf16; k, v (B, Sk, Hkv, D) bf16; out (B, Sq, H, D) bf16.
// Needs D == 128, H a multiple of Hkv, Sq, Sk >= 1; the Python wrapper
// checks them. Returns cudaGetLastError().
extern "C" int ao_flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                                  int Sq, int Sk, int H, int Hkv, float sm_scale, int causal,
                                  void* stream) {
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_prefill_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq, Sk, H, Hkv,
      sm_scale, causal);
  return (int)cudaGetLastError();
}
