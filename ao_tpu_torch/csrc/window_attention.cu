// Windowed or global attention with the decomposed relative-position bias of
// ViTDet / SAM encoders, for Hopper (sm_90a): K16.
//
// Replaces the TPU kernels ao_tpu/ops/pallas/window_attention.py::
// _kernel_heads and _kernel_single (launched by _impl, public entry
// window_bias_attention). For window (or image) g and head h, over the
// T = side * side tokens of a square grid:
//
//   s[i, j] = (q[i] . k[j]) * scale + rel_h[i, j / side] + rel_w[i, j % side]
//             in f32 (a product, then two adds: each one IEEE rounding);
//   out[i]  = sum_j bf16(p[i, j]) v[j] / sum_j p[i, j], p = exp(s - running
//             max), an online softmax over the T real keys; bf16 out.
//
// q, k, v are (G, T, nh, hd) bf16 and the output (G, T, nh * hd), the
// layouts the projections produce and consume; rel_h and rel_w are the
// decomposed terms (G, nh, T, side) in bf16, computed outside by two small
// einsums, as in the reference.
//
// What bounds it on the H100: at SAM-B's windows (T = 196, hd = 64) the
// bytes of q, k, v, the output and the rel terms against 3.35 TB/s; at its
// global layers (T = 4096) the products, 4 * hd flops per (query, key) pair
// against 989 TFLOP/s of bf16 tensor cores.
//
// Design. The TPU kernel keeps a window's whole (T, T) score tile in VMEM
// and builds the bias with two 0/1 expansion-matrix dots on its matrix unit;
// it refuses side 64 (T = 4096) for lack of VMEM. Here the kernel is K8's
// streamed flash attention: a block of four warps owns 64 query rows of one
// (window, head) (grid: ceil(T / 64) x nh x G), walks the 64-key tiles of k
// and v staged in shared memory, and runs both products on the tensor cores
// with mma.sync m16n8k16 (bf16 in, f32 accumulate), p turned into A
// fragments in registers, v's B fragments from ldmatrix.trans. So any side
// up to kMaxSide runs, global layers included. The bias is indexed per key
// directly: the block's 64 rows of rel_h and rel_w (at most 64 x 64 bf16
// each) sit in shared memory, and score (i, j) adds rel_h[i][j / side] and
// rel_w[i][j % side]. Key columns at or past T (T = 196 is no multiple of
// the tile) get no weight; query rows past T are computed on zeros and not
// stored. One buffer per tile, no cp.async pipeline or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kMaxSide = 64;   // longest grid side (T = 4096)
constexpr int kBlockQ = 64;    // query rows per block, 16 per warp
constexpr int kBlockK = 64;    // keys per tile
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRow = kD + 8;   // row padding (bf16): fragment loads stay bank-conflict free

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
    window_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ rel_h,
                            const __nv_bfloat16* __restrict__ rel_w,
                            __nv_bfloat16* __restrict__ out, int T, int side, int nh,
                            float scale) {
  const int h = blockIdx.y, g = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group

  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK][kRow];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK][kRow];
  __shared__ __nv_bfloat16 rh[kBlockQ][kMaxSide];
  __shared__ __nv_bfloat16 rw[kBlockQ][kMaxSide];

  // the block's rows of the decomposed terms; zeros past T
  const size_t rel_base = ((size_t)g * nh + h) * T * side;
  for (int i = threadIdx.x; i < kBlockQ * side; i += kThreads) {
    const int r = i / side, c = i % side;
    const bool valid = q0 + r < T;
    const size_t off = rel_base + (size_t)(q0 + r) * side + c;
    rh[r][c] = valid ? rel_h[off] : __float2bfloat16(0.f);
    rw[r][c] = valid ? rel_w[off] : __float2bfloat16(0.f);
  }

  // this warp's 16 query rows (r0 and r1 = r0 + 8 for this thread) as the
  // A fragments of the four 16-dim steps of q . k
  const int lr0 = warp * 16 + gid, lr1 = lr0 + 8;  // rows within the block
  const int r0 = q0 + lr0, r1 = q0 + lr1;
  const size_t stride = (size_t)nh * kD;
  const size_t base = (size_t)g * T * stride + (size_t)h * kD;
  const __nv_bfloat16* qp0 = q + base + (size_t)min(r0, T - 1) * stride;
  const __nv_bfloat16* qp1 = q + base + (size_t)min(r1, T - 1) * stride;
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int d = kk * 16 + 2 * tig;
    qa[kk][0] = r0 < T ? ld32(qp0 + d) : 0u;
    qa[kk][1] = r1 < T ? ld32(qp1 + d) : 0u;
    qa[kk][2] = r0 < T ? ld32(qp0 + d + 8) : 0u;
    qa[kk][3] = r1 < T ? ld32(qp1 + d + 8) : 0u;
  }

  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < T; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and, first, rh / rw are written)
    for (int i = threadIdx.x; i < kBlockK * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8), c = i % (kD / 8);
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      if (k0 + r < T) {
        const size_t off = base + (size_t)(k0 + r) * stride + c * 8;
        kv = __ldg(reinterpret_cast<const int4*>(k + off));
        vv = __ldg(reinterpret_cast<const int4*>(v + off));
      }
      *reinterpret_cast<int4*>(&ks[r][c * 8]) = kv;
      *reinterpret_cast<int4*>(&vs[r][c * 8]) = vv;
    }
    __syncthreads();

    // s = q . k^T for 16 rows x 64 keys: n-tile n holds keys k0 + 8n .. +7
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        const __nv_bfloat16* kr = &ks[n * 8 + gid][kk * 16 + 2 * tig];
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale, bias and mask; this tile's row maxima, merged into the running ones
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + n * 8 + 2 * tig + e;
        float v0 = -INFINITY, v1 = -INFINITY;  // past T: no key at all
        if (col < T) {
          const int kh = col / side, kw = col - kh * side;
          v0 = __fadd_rn(__fadd_rn(__fmul_rn(s[n][e], scale), __bfloat162float(rh[lr0][kh])),
                         __bfloat162float(rw[lr0][kw]));
          v1 = __fadd_rn(__fadd_rn(__fmul_rn(s[n][2 + e], scale), __bfloat162float(rh[lr1][kh])),
                         __bfloat162float(rw[lr1][kw]));
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
    // every tile holds a key below T, so mx is finite and alpha is 0 on the first tile
    const float alpha0 = expf(m0 - mx0), alpha1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // p = exp(s - m): f32 row sums; bf16 p as the A fragments of p . v
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

    // o += p . v: ldmatrix.trans gives the B fragments of two 8-dim n-tiles
    // of one 16-key step
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
  __nv_bfloat16* op0 = out + base + (size_t)min(r0, T - 1) * stride;
  __nv_bfloat16* op1 = out + base + (size_t)min(r1, T - 1) * stride;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int d = n * 8 + 2 * tig;
    if (r0 < T) *reinterpret_cast<uint32_t*>(op0 + d) = pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < T) *reinterpret_cast<uint32_t*>(op1 + d) = pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace

extern "C" int ao_window_attention_head_dim(void) { return kD; }
extern "C" int ao_window_attention_max_side(void) { return kMaxSide; }
extern "C" int ao_window_attention_block_k(void) { return kBlockK; }

// q, k, v (G, T, nh, 64) bf16; rel_h, rel_w (G, nh, T, side) bf16; out (G, T,
// nh, 64) bf16. Needs T == side * side, 1 <= side <= kMaxSide; the Python
// wrapper checks them. Returns cudaGetLastError().
extern "C" int ao_window_attention(const void* q, const void* k, const void* v, const void* rel_h,
                                   const void* rel_w, void* out, int G, int T, int side, int nh,
                                   float scale, void* stream) {
  if (side < 1 || side > kMaxSide || T != side * side) return (int)cudaErrorInvalidValue;
  dim3 grid((T + kBlockQ - 1) / kBlockQ, nh, G);
  window_attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(rel_h),
      static_cast<const __nv_bfloat16*>(rel_w), static_cast<__nv_bfloat16*>(out), T, side, nh,
      scale);
  return (int)cudaGetLastError();
}
