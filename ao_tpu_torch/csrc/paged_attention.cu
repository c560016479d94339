// Single-query decode attention over a paged KV pool, for Hopper (sm_90a):
// K9.
//
// Replaces the TPU kernel ao_tpu/ops/pallas/paged_attention.py::_make_kernel
// (launched by _impl from paged_decode_attention) in its three modes, one
// Op here:
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
// with p = exp(s - m) against the running max of the warp that walks t, as
// the TPU kernel rounds it against its running max before p . V. The stored
// values become bf16 exactly in shared memory, by bit operations and one
// bf16x2 operation a pair (Paged::to_bf16; int4 nibbles by the int4 weight
// kernels' bit trick, dm::ch4_to_bf16 on dm::ch4_pair, which K7 shares),
// and the scales fold into each score and each probability
// ("scale-commuted, no dequant multiplies", as the TPU kernel does).
//
// What bounds it on the H100: the K and V bytes of the valid positions (2 B
// per value for bf16, 1 B for int8 and fp8, half a byte for int4, plus two
// f32 scales per position and kv head) against 3.35 TB/s. The TPU kernel's
// grid, (B, Hkv), carries one online softmax along a sequence's pages and
// double-buffers their DMAs. Here the shared decode mainloop
// (decode_mainloop.cuh, whose header gives the design) streams the rows
// through each warp's cp.async ring into mma.sync, and the CTAs of a stream
// merge inside one cluster: one launch, no workspace. This Op looks up the
// (at most two) pages of a warp's 16-row slab one slab ahead; rows at or
// past lengths[b] and their scales are never loaded (zero-filled) and
// weigh 0, so a block-table entry past a sequence's pages (0, the null page,
// where idle lanes write) is never read as data and no stored byte there (an
// e4m3 0x7F is NaN) reaches the output. Any page_size % 8 == 0 works (the
// TPU kernel needs page_size % 128 for quantized pools, for its lanes).
// lengths <= 0 walks nothing and the output is 0.

#include "decode_mainloop.cuh"

namespace {

enum Mode { kFP = 0, kI8 = 1, kF8 = 2, kI4 = 3 };

template <int MODE>
struct Paged {
  static constexpr int kRowBytes = MODE == kFP ? dm::kRowB : MODE == kI4 ? dm::kD / 2 : dm::kD;
  static constexpr bool kQuant = MODE != kFP;
  static constexpr bool kDirect = false;  // converted in the bf16 slab

  // the pages of a slab's rows: rows r with base0 + r < page_size in page
  // p0 at row base0 + r, the others in p1 (16 rows of a slab, pages of
  // page_size % 8 == 0: at most two pages)
  struct Cursor {
    int p0, p1, base0;
  };
  // (entries past a sequence's pages are the null page: read, never used)
  __device__ static Cursor look(const dm::Params& p, int b, int start) {
    const int ps = p.page_size;
    const int* row = p.table + (size_t)b * p.max_pages;
    const int pg = start / ps, last = min(start + dm::kSlab, p.T) - 1;
    return {row[pg], row[last / ps], start - pg * ps};
  }
  __device__ static int walk_end(int L, int T) { return max(min(L, T), 0); }
  __device__ static float mask(float s, int pos, int L, int T) {
    return pos < L && pos < T ? s : dm::kNeg;
  }
  __device__ static size_t pool_row(const dm::Params& p, const Cursor& c, int r, int& off) {
    off = c.base0 + r;
    const int page = off < p.page_size ? c.p0 : c.p1;
    off = off < p.page_size ? off : off - p.page_size;
    return page;
  }
  __device__ static size_t row_offset(const dm::Params& p, const Cursor& c, int, int kvh, int,
                                      int r) {
    int off;
    const size_t page = pool_row(p, c, r, off);
    return ((page * p.page_size + off) * p.Hkv + kvh) * kRowBytes;
  }
  __device__ static size_t scale_index(const dm::Params& p, const Cursor& c, int, int kvh, int,
                                       int r) {
    int off;
    const size_t page = pool_row(p, c, r, off);
    return (page * p.Hkv + kvh) * p.page_size + off;
  }

  // 16 stored bytes of one row of a converted mode -> bf16 chunks o: 2 (16
  // values) for int8 and fp8 (dm::bytes_to_bf16), 4 (32 values: four words
  // of 8 channels each) for int4 (dm::ch4_to_bf16, whose dm::ch4_pair K7
  // shares), exact.
  __device__ static void to_bf16(int4 raw, uint4 (&o)[dm::kRowB / kRowBytes]) {
    if constexpr (MODE == kI4)
      dm::ch4_to_bf16(raw, o);
    else
      dm::bytes_to_bf16<MODE == kI8 ? dm::kInt8 : dm::kE4M3>(raw, o);
  }
};

}  // namespace

extern "C" int ao_paged_attention_slab(void) { return dm::kSlab; }
extern "C" int ao_paged_attention_max_group(void) { return dm::kGMax; }
extern "C" int ao_paged_attention_head_dim(void) { return dm::kD; }
extern "C" int ao_paged_attention_max_split(void) { return dm::kMaxSplit; }

// mode 0 ("fp", bf16), 1 (int8), 2 (fp8 e4m3), 3 (int4 "ch4"). q (B, H, D)
// bf16; k_pages, v_pages (P, page_size, Hkv, D) bf16 / int8 / e4m3 or
// (P, page_size, Hkv, D/8) int32; k_scale, v_scale (P, Hkv, page_size) f32
// (unread in mode 0); table (B, max_pages) int32 page ids < P; lengths (B,)
// int32; out (B, H, D) f32. One launch: ``splits`` CTAs a stream in one
// cluster, each walking ``tiles`` tiles of ``rows`` positions with
// ``stages`` slabs in each warp's ring (see ao_decode_attention). Needs D ==
// 128, H / Hkv <= 8, page_size % 8 == 0 and 16-byte aligned pools; the
// Python wrapper checks them. Returns the CUDA error of the launch.
extern "C" int ao_paged_attention(int mode, const void* q, const void* k_pages,
                                  const void* k_scale, const void* v_pages, const void* v_scale,
                                  const void* table, const void* lengths, void* out, int B, int H,
                                  int Hkv, int page_size, int max_pages, int splits, int tiles,
                                  int rows, int stages, float sm_scale, void* stream) {
  dm::Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const uint8_t*>(k_pages);
  p.v = static_cast<const uint8_t*>(v_pages);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.out = static_cast<float*>(out);
  p.T = max_pages * page_size;
  p.H = H;
  p.Hkv = Hkv;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.tiles = tiles;
  p.sm_scale = sm_scale;
  if (page_size < 8 || page_size % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFP: return (int)dm::launch<Paged<kFP>>(p, splits, B, rows, stages, st);
    case kI8: return (int)dm::launch<Paged<kI8>>(p, splits, B, rows, stages, st);
    case kF8: return (int)dm::launch<Paged<kF8>>(p, splits, B, rows, stages, st);
    case kI4: return (int)dm::launch<Paged<kI4>>(p, splits, B, rows, stages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
