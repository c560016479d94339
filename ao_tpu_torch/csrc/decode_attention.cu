// Single-query decode attention over a dense (B, T, Hkv, *) cache, for
// Hopper (sm_90a): K2 over bf16 rows; K2v over int8 or fp8 e5m2 rows, K5
// over int8 rows with q quantized to int8, K6 over fp8 e4m3 rows and K7
// over int4 "ch4" rows, each with one f32 scale per (batch row, kv head,
// position).
//
// Replaces the TPU kernels of ao_tpu/ops/pallas/decode_attention.py:
//   K2, _tok_kernel in mode "fp" (launched by _tok_impl from the tokens
//       branch of decode_attention);
//   K2v, _tok_kernel "vec8" over the int8 and e5m2 storage types;
//   K5, _kt_kernel in mode "i8" (launched by _kt_impl): q quantized per
//       (batch row, kv head) group, qs = max(max |q|, 1e-8) / 127, qi =
//       clip(rint(q / qs), +-127), the scores exact int8 dots with the
//       stored K rows, f32(dot) * ks[t] * (qs * sm_scale);
//   K6, _f8_kernel (launched by _f8_impl), with the "cvt" mode of _kt_kernel
//       and the e4m3 form of _tok_kernel "vec8": e4m3 K and V converted
//       exactly (the TPU kernel spliced bytes and folded 2^60 / 2^120 into
//       the scales because v5e has no fp8 convert);
//   K7, _ck4_kernel (_ck4_impl) and _int4_kernel (_int4_impl), the same
//       function over the port's int4 "ch4" words, (B, T, Hkv, D/8) int32
//       of 8 channel nibbles u at bits [4o, 4o + 4), value u - 8.
// For each batch row b and kv head, the G = H / Hkv query heads of its
// group share one K/V stream:
//
//   s[h, t] = (q[h] . K[t]) * sm_scale (* ks[t]) in f32, masked to _NEG where
//             t >= lengths[b];
//   out[h]  = softmax_t(s[h]) . (vs[t] V[t]) in f32, p (* vs[t]) rounded to
//             bf16 before p . V (ao_tpu/ops/pallas/decode_attention.py:216).
//
// What bounds it on the H100: the K and V bytes of the valid positions (2 *
// 2 * Hkv * D bytes per token and batch row for bf16; 2 * Hkv * (D + 4)
// for one-byte rows and scales, 2 * Hkv * (D / 2 + 4) for ch4) against
// 3.35 TB/s. The TPU kernels' sequential grid carried one online softmax
// along T; here the shared decode mainloop (decode_mainloop.cuh, whose
// header gives the design) streams the rows through each warp's cp.async
// ring into mma.sync, with the scales folded into each score and each
// probability, and the CTAs of a stream merge their softmaxes inside one
// cluster: one launch, no workspace. K2v's rows become bf16 exactly in a
// per-warp slab in shared memory (dm::bytes_to_bf16); K6's and K7's go
// from the ring straight into mma fragments (the Direct Op), converted in
// registers by the same exact bit tricks (dm::e4m3x2, dm::ch4_pair); so do
// K5's (V by dm::int8x2; K as stored, against q quantized to int8 in each
// warp, the scores by integer mma.sync). The Op says where rows live (row t of kv head n at ((b T + t) Hkv + n) row
// bytes; the scales at (b Hkv + n) T + t) and what a stream walks:
// positions below min(lengths[b], T); with lengths <= 0 every position is
// masked, as in the reference, and the output is the mean of (vs) V over all
// T, so the walk then covers all T. Positions at or past T in a last
// partial tile are no positions at all (-inf). Rows and scales at or past
// the walk's end are never loaded (a stored fp8 NaN there never reaches the
// output).

#include "decode_mainloop.cuh"

namespace {

// The dense addressing and walk of a (B, T, Hkv, RB-byte row) cache.
template <int RB>
struct Dense {
  static constexpr int kRowBytes = RB;
  struct Cursor {};
  __device__ static Cursor look(const dm::Params&, int, int) { return {}; }
  __device__ static int walk_end(int L, int T) { return L >= 1 ? min(L, T) : T; }
  __device__ static float mask(float s, int pos, int L, int T) {
    return pos >= T ? -INFINITY : pos >= L ? dm::kNeg : s;
  }
  __device__ static size_t row_offset(const dm::Params& p, const Cursor&, int b, int kvh,
                                      int start, int r) {
    return (((size_t)b * p.T + start + r) * p.Hkv + kvh) * RB;
  }
  __device__ static size_t scale_index(const dm::Params& p, const Cursor&, int b, int kvh,
                                       int start, int r) {
    return ((size_t)b * p.Hkv + kvh) * p.T + start + r;
  }
};

// K2 and K2v. KIND: the stored values, bf16 (-1) or a dm::Byte kind (int8,
// e5m2), converted in the bf16 slab
template <int KIND>
struct Tokens : Dense<(KIND >= 0 ? dm::kD : dm::kRowB)> {
  static constexpr bool kQuant = KIND >= 0;
  static constexpr bool kDirect = false;
  __device__ static void to_bf16(int4 raw, uint4 (&o)[2]) { dm::bytes_to_bf16<KIND>(raw, o); }
};

// K6 (KIND dm::kE4M3, 128-byte rows) and K7 (dm::kCh4, 64-byte rows): K and
// V rows converted from the ring straight into mma fragments. K5
// (dm::kInt8, 128-byte rows): V so, K as stored against q quantized to int8
// (dm::direct_int8).
template <int KIND>
struct Direct : Dense<(KIND == dm::kCh4 ? dm::kD / 2 : dm::kD)> {
  static constexpr bool kQuant = true, kDirect = true;
  static constexpr int kKind = KIND;
};

constexpr int kBF16 = -1;

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
  return (int)dm::launch<Tokens<kBF16>>(p, splits, B, rows, stages,
                                             static_cast<cudaStream_t>(stream));
}

// K2v: mode 0 (int8) or 1 (fp8 e5m2); K6: mode 2 (fp8 e4m3); K7: mode 3
// (int4 "ch4"); K5: mode 4 (int8, q quantized to int8). q (B, H, D) bf16;
// k, v (B, T, Hkv, D) int8 / e5m2 / e4m3 or (B, T, Hkv, D/8) int32;
// k_scale, v_scale (B, Hkv, T) f32; lengths (B,) int32; out (B, H, D) f32.
// One launch at a plan as ao_decode_attention's (positions a tile 64 or
// 128; 3 or 4 stages for K2v, 3 for K5, K6 and K7).
// Needs D == 128, H / Hkv <= 8, 16-byte aligned caches and q; the Python
// wrapper sees to them. Returns the CUDA error of the launch.
extern "C" int ao_decode_attention_vec8(int mode, const void* q, const void* k,
                                        const void* k_scale, const void* v, const void* v_scale,
                                        const void* lengths, void* out, int B, int H, int Hkv,
                                        int T, int splits, int tiles, int rows, int stages,
                                        float sm_scale, void* stream) {
  dm::Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const uint8_t*>(k);
  p.v = static_cast<const uint8_t*>(v);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.out = static_cast<float*>(out);
  p.T = T;
  p.H = H;
  p.Hkv = Hkv;
  p.tiles = tiles;
  p.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)dm::launch<Tokens<dm::kInt8>>(p, splits, B, rows, stages, st);
    case 1: return (int)dm::launch<Tokens<dm::kE5M2>>(p, splits, B, rows, stages, st);
    case 2: return (int)dm::launch<Direct<dm::kE4M3>>(p, splits, B, rows, stages, st);
    case 3: return (int)dm::launch<Direct<dm::kCh4>>(p, splits, B, rows, stages, st);
    case 4: return (int)dm::launch<Direct<dm::kInt8>>(p, splits, B, rows, stages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
