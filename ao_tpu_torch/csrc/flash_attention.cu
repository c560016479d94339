// Flash attention for prefill, causal or not, over a bf16 (B, Sk, Hkv, D)
// KV cache with grouped-query heads, for Hopper (sm_90a): K8.
//
// Replaces the TPU kernel ao_tpu/ops/pallas/flash_attention.py::_kernel
// (launched by _flash_impl). For batch row b and query head h, whose kv head
// is h / G (G = H / Hkv):
//
//   s[i, j] = (q[i] . K[j]) * sm_scale in f32; causal: masked where j > i
//             (top-left aligned: query row i, counted from 0, sees cache
//             rows 0..i, also when Sq < Sk);
//   out[i]  = sum_j bf16(p[i, j]) V[j] / sum_j p[i, j], p = exp(s - running
//             max), an online softmax with f32 statistics; bf16 out.
//
// q is (B, Sq, H, D) and the output (B, Sq, H, D), the layout the model's
// projections produce and consume, so neither is transposed; K and V are
// read in place from the cache, with no repeat over the G query heads that
// share them.
//
// What bounds it on the H100: the products, 4 * D flops per (query, key)
// pair that the mask keeps, against 989 TFLOP/s of bf16 tensor cores; the
// bytes (q, K, V, out) are far smaller. The TPU kernel ran 512-row tiles on
// one core's matrix unit in a sequential grid. Here it runs on the shared
// attention mainloop (attn_mainloop.cuh): wgmma from TMA-fed shared memory,
// a producer warp keeping the 64-key tiles of K and V in flight on a ring,
// the scores turned into p . v's register operand in place. The Causal
// policy masks only the tiles that reach past a warp's first row (the
// diagonal); tiles past a query tile's last row are never loaded, and the
// heaviest query tiles start first. A CTA holds 64 query rows (one
// consumer warpgroup, two CTAs an SM: 2-15 % faster than 128 rows at one
// CTA an SM at every shape of the main paths, PERF.md). The first version
// (mma.sync m16n8k16 from registers, K and V loaded by every thread into
// one shared buffer between two barriers) took 2.2-4.9x SDPA's time.

#include "attn_mainloop.cuh"

namespace {

constexpr int kD = 128;  // head dim

struct Causal {
  static constexpr int kSmemPerWG = 0;
  struct Args {
    float sm_scale;
  };
  struct Thread {
    float c;
    int row0, causal;  // the query row of this thread's h = 0 scores
    __device__ Thread(const Args& a, const attn::Problem& pb, int, int, int q0w, int lrow, int,
                      uint8_t*, int)
        : c(a.sm_scale * attn::kLog2e), row0(q0w + lrow), causal(pb.causal) {}
    __device__ float exp2_scale() const { return c; }
    // raw scores: the scale is folded into exp2; a masked key gets -inf (the
    // reference's -0.7 * FLT_MAX gives the same zero weight: every row keeps
    // a key in each tile it runs)
    __device__ void score(float (&s)[32], int, int k0, int tig) const {
      if (!causal || k0 + attn::kBK - 1 <= row0) return;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (k0 + 8 * (j >> 2) + 2 * tig + (j & 1) > row0 + 8 * ((j >> 1) & 1)) s[j] = -INFINITY;
    }
  };
};

}  // namespace

extern "C" int ao_flash_attention_head_dim(void) { return kD; }
extern "C" int ao_flash_attention_block_k(void) { return attn::kBK; }
extern "C" int ao_flash_attention_block_q(void) { return attn::kRowsWG; }

// q (B, Sq, H, D) bf16; k, v (B, Sk, Hkv, D) bf16; out (B, Sq, H, D) bf16.
// kv_len: the cache rows the kernel reads (Sk, or causally min(Sq, Sk)).
// Needs D == 128, H a multiple of Hkv, Sq, Sk >= 1, 16-byte aligned
// tensors; the Python wrapper checks the shapes. Returns cudaGetLastError()
// after the launch, or minus libcuda's CUresult if a tensor map could not
// be encoded (no kernel is launched then).
extern "C" int ao_flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                                  int Sq, int Sk, int H, int Hkv, int kv_len, float sm_scale,
                                  int causal, void* stream) {
  if (B < 1 || Sq < 1 || Hkv < 1 || H % Hkv || kv_len < 1 || kv_len > Sk)
    return (int)cudaErrorInvalidValue;
  const attn::Problem pb{static_cast<__nv_bfloat16*>(out), B, Sq, H, Hkv, kv_len, causal,
                         (Sq + attn::kRowsWG - 1) / attn::kRowsWG};
  // 64 query rows a CTA: one consumer warpgroup, a ring of two stages (80 KB
  // of shared memory), two CTAs an SM
  return attn::launch<kD, 1, 2, 2, Causal>(q, k, v, Sk, pb, {sm_scale},
                                           static_cast<cudaStream_t>(stream));
}
