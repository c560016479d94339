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
// against 989 TFLOP/s of bf16 tensor cores, and beside them the exp2 and the
// bias's adds, one each a score on the SM's other pipes.
//
// Design. The TPU kernel keeps a window's whole (T, T) score tile in VMEM
// and builds the bias with two 0/1 expansion-matrix dots on its matrix unit;
// it refuses side 64 (T = 4096) for lack of VMEM. Here the kernel is K8's
// streamed attention, on the shared mainloop (attn_mainloop.cuh): wgmma
// from TMA-fed shared memory, 64-key tiles on a ring, so any side up to
// kMaxSide runs, global layers included. The tensor maps are (nh * hd, T,
// G): a window's last key tile (T = 196 is no multiple of 64) is
// zero-filled, never the next window's keys. A CTA holds 128 query rows of
// one (window, head), two CTAs an SM (64 rows ran as fast at the windows
// and slower at the global layers, where each k / v tile then serves fewer
// rows; 256 rows, four warpgroups at 96 registers, no faster: PERF.md).
// The RelPosBias policy adds the
// bias without a division a score: each consumer warpgroup stages its 64
// rows of rel_h and rel_w in shared memory once; each thread's key columns
// are fixed by the wgmma accumulator layout, so j / side and j % side are
// taken once a column a tile (by a float reciprocal, exact at these sizes).
// At side 64 = the key tile, j / side is the tile and j % side the column:
// rel_h is one value a row a tile, and rel_w's are read as bf16 pairs from
// rows padded to 72 values, so a warp's reads fall on 32 banks (held in
// registers, they made ptxas spill at 96). Query rows past T are computed
// on zeros and not stored. The first
// version (mma.sync m16n8k16 from registers, k and v loaded by every thread
// into one shared buffer between two barriers, a division and two
// shared-memory reads a score) took 2.7-4.2x SDPA's time.

#include "attn_mainloop.cuh"

namespace {

constexpr int kD = 64;        // head dim
constexpr int kMaxSide = 64;  // longest grid side (T = 4096)

template <bool kSide64>
struct RelPosBias {
  static_assert(kMaxSide == attn::kBK, "at side 64 a key tile is one row of the grid");
  // shared memory row of a table: `side` values, or at side 64, 72 (the
  // pad keeps a warp's 32-bit rel_w reads on 32 banks)
  static constexpr int kPadRow = kMaxSide + 8;
  // the warpgroup's 64 rows of rel_h, then of rel_w (bf16)
  static constexpr int kTable = attn::kRowsWG * (kSide64 ? kPadRow : kMaxSide - 1);
  static constexpr int kSmemPerWG = (2 * kTable * 2 + 15) / 16 * 16;
  struct Args {
    const __nv_bfloat16* rel_h;
    const __nv_bfloat16* rel_w;
    int side;
    float scale;
  };
  struct Thread {
    const __nv_bfloat16* rh;  // shared memory: rel_h of this thread's h = 0 row
    const __nv_bfloat16* rw;  // rel_w of it
    int side, step;           // rows h = 0 and h = 1 are `step` values apart
    float scale, inv_side;

    __device__ Thread(const Args& a, const attn::Problem& pb, int b, int h, int q0w, int lrow,
                      int, uint8_t* smem, int tid)
        : side(a.side), scale(a.scale), inv_side(1.f / a.side) {
      auto* sh = reinterpret_cast<__nv_bfloat16*>(smem);
      auto* sw = sh + kTable;
      const int ld = kSide64 ? kPadRow : side;
      const int t = pb.S, n = attn::kRowsWG * side, lim = (t - q0w) * side;
      const size_t base = ((size_t)b * pb.H + h) * t * side + (size_t)q0w * side;
      constexpr int kU = 8;  // loads in flight a thread
      for (int e0 = tid; e0 < n; e0 += 128 * kU) {
        __nv_bfloat16 vh[kU], vw[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {  // zeros past T
          const int e = e0 + 128 * u;
          const bool ok = e < n && e < lim;
          vh[u] = ok ? a.rel_h[base + e] : __float2bfloat16(0.f);
          vw[u] = ok ? a.rel_w[base + e] : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int e = e0 + 128 * u;
          const int dst = kSide64 ? (e >> 6) * kPadRow + (e & 63) : e;
          if (e < n) {
            sh[dst] = vh[u];
            sw[dst] = vw[u];
          }
        }
      }
      rh = sh + lrow * ld;
      rw = sw + lrow * ld;
      step = 8 * ld;
    }
    __device__ float exp2_scale() const { return attn::kLog2e; }

    __device__ void score(float (&s)[32], int tile, int k0, int tig) const {
      if constexpr (kSide64) {  // j / 64 = tile, j % 64 = the column in the tile
        const float h0 = __bfloat162float(rh[tile]), h1 = __bfloat162float(rh[step + tile]);
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const uint32_t w =
                *reinterpret_cast<const uint32_t*>(rw + hh * step + 8 * n8 + 2 * tig);
            float& s0 = s[4 * n8 + 2 * hh];
            float& s1 = s[4 * n8 + 2 * hh + 1];
            s0 = __fadd_rn(__fadd_rn(__fmul_rn(s0, scale), hh ? h1 : h0),
                           __uint_as_float(w << 16));
            s1 = __fadd_rn(__fadd_rn(__fmul_rn(s1, scale), hh ? h1 : h0),
                           __uint_as_float(w & 0xffff0000u));
          }
      } else {
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * n8 + 2 * tig + e;
            const int kh = __float2int_rz(((float)col + 0.5f) * inv_side), kw = col - kh * side;
            float& s0 = s[4 * n8 + e];
            float& s1 = s[4 * n8 + 2 + e];
            s0 = __fadd_rn(__fadd_rn(__fmul_rn(s0, scale), __bfloat162float(rh[kh])),
                           __bfloat162float(rw[kw]));
            s1 = __fadd_rn(__fadd_rn(__fmul_rn(s1, scale), __bfloat162float(rh[step + kh])),
                           __bfloat162float(rw[step + kw]));
          }
      }
    }
  };
};

// 128 query rows a CTA: two consumer warpgroups, a ring of three stages,
// two CTAs an SM
constexpr int kWGs = 2, kStages = 3, kCtasPerSM = 2;

}  // namespace

extern "C" int ao_window_attention_head_dim(void) { return kD; }
extern "C" int ao_window_attention_max_side(void) { return kMaxSide; }
extern "C" int ao_window_attention_block_k(void) { return attn::kBK; }
extern "C" int ao_window_attention_block_q(void) { return kWGs * attn::kRowsWG; }

// q, k, v (G, T, nh, 64) bf16; rel_h, rel_w (G, nh, T, side) bf16; out (G, T,
// nh, 64) bf16. Needs T == side * side, 1 <= side <= kMaxSide, 16-byte
// aligned q, k, v; the Python wrapper checks the shapes. Returns
// cudaGetLastError() after the launch, or minus libcuda's CUresult if a
// tensor map could not be encoded (no kernel is launched then).
extern "C" int ao_window_attention(const void* q, const void* k, const void* v, const void* rel_h,
                                   const void* rel_w, void* out, int G, int T, int side, int nh,
                                   float scale, void* stream) {
  if (side < 1 || side > kMaxSide || T != side * side || G < 1 || nh < 1)
    return (int)cudaErrorInvalidValue;
  const int rows = kWGs * attn::kRowsWG;
  const attn::Problem pb{static_cast<__nv_bfloat16*>(out), G, T, nh, nh, T, 0,
                         (T + rows - 1) / rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* rh = static_cast<const __nv_bfloat16*>(rel_h);
  const auto* rw = static_cast<const __nv_bfloat16*>(rel_w);
  if (side == attn::kBK)
    return attn::launch<kD, kWGs, kStages, kCtasPerSM, RelPosBias<true>>(
        q, k, v, T, pb, {rh, rw, side, scale}, st);
  return attn::launch<kD, kWGs, kStages, kCtasPerSM, RelPosBias<false>>(
      q, k, v, T, pb, {rh, rw, side, scale}, st);
}
