// Single-query decode attention over a bf16 (B, T, Hkv, D) cache, for Hopper
// (sm_90a): K2.
//
// Replaces the TPU kernel ao_tpu/ops/pallas/decode_attention.py::_tok_kernel
// in mode "fp" (launched by _tok_impl from the tokens branch of
// decode_attention). For each batch row b and kv head, the G = H / Hkv query
// heads of its group share one K/V stream:
//
//   s[h, t] = (q[h] . K[t]) * sm_scale in f32, masked to _NEG where t >= lengths[b];
//   out[h]  = softmax_t(s[h]) . V  in f32, p rounded to bf16 before p . V
//             (ao_tpu/ops/pallas/decode_attention.py:216).
//
// What bounds it on the H100: the K and V bytes of the valid positions (2 *
// 2 * Hkv * D bytes per token and batch row) against 3.35 TB/s. The TPU
// kernel's sequential grid carried one online softmax along T; here the
// shared decode mainloop (decode_mainloop.cuh, whose header gives the
// design) streams the rows through each warp's cp.async ring into
// mma.sync, and the CTAs of a stream merge their softmaxes inside one
// cluster: one launch, no workspace. This Op says where rows live (row t of
// kv head n at ((b T + t) Hkv + n) D) and what a stream walks: positions
// below min(lengths[b], T); with lengths <= 0 every position is masked, as in
// the reference, and the output is the mean of V over all T, so the walk
// then covers all T. Positions at or past T in a last partial tile are no
// positions at all (-inf).

#include "decode_mainloop.cuh"

namespace {

struct Tokens {
  static constexpr int kRowBytes = dm::kRowB;
  static constexpr bool kQuant = false;
  struct Cursor {};
  __device__ static Cursor look(const dm::Params&, int, int) { return {}; }
  __device__ static int walk_end(int L, int T) { return L >= 1 ? min(L, T) : T; }
  __device__ static float mask(float s, int pos, int L, int T) {
    return pos >= T ? -INFINITY : pos >= L ? dm::kNeg : s;
  }
  __device__ static size_t row_offset(const dm::Params& p, const Cursor&, int b, int kvh,
                                      int start, int r) {
    return (((size_t)b * p.T + start + r) * p.Hkv + kvh) * kRowBytes;
  }
};

}  // namespace

extern "C" int ao_decode_attention_slab(void) { return dm::kSlab; }
extern "C" int ao_decode_attention_max_group(void) { return dm::kGMax; }
extern "C" int ao_decode_attention_head_dim(void) { return dm::kD; }
extern "C" int ao_decode_attention_max_split(void) { return dm::kMaxSplit; }

// q (B, H, D) bf16; k, v (B, T, Hkv, D) bf16; lengths (B,) int32; out
// (B, H, D) f32. One launch: ``splits`` CTAs a (b, kv head) stream in one
// cluster (1, 2, 4 or 8), each walking ``tiles`` tiles of ``rows`` positions
// (64, or 128 at 3 stages) with ``stages`` slabs in each warp's ring (3 or
// 4). Needs D == 128 and H / Hkv <= 8; the Python wrapper checks them.
// Returns the CUDA error of the launch (cudaErrorInvalidValue for a plan it
// does not take).
extern "C" int ao_decode_attention(const void* q, const void* k, const void* v, const void* lengths,
                                   void* out, int B, int H, int Hkv, int T, int splits, int tiles,
                                   int rows, int stages, float sm_scale, void* stream) {
  dm::Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const uint8_t*>(k);
  p.v = static_cast<const uint8_t*>(v);
  p.lengths = static_cast<const int*>(lengths);
  p.out = static_cast<float*>(out);
  p.T = T;
  p.H = H;
  p.Hkv = Hkv;
  p.tiles = tiles;
  p.sm_scale = sm_scale;
  return (int)dm::launch<Tokens>(p, splits, B, rows, stages, static_cast<cudaStream_t>(stream));
}
