// fp4 (e2m1) weight-only matmul, MXFP4 and NVFP4, for Hopper (sm_90a): K14.
//
// Replaces the TPU kernels ao_tpu/ops/pallas/fp4_matmul.py::_mx_kernel and
// ::_nv_kernel (launched by _run, public entries mxfp4_wo_matmul_pallas and
// nvfp4_wo_matmul_pallas):
//
//   MXFP4: y[m, n] = bf16( sum_k x[m, k] * c[k, n] * 2^(e[k/32, n] - 127) )
//   NVFP4: y[m, n] = bf16( pts * bf16( sum_k x[m, k] * c[k, n] * s[k/16, n] ) )
//
// c the e2m1 value of the weight's code, e the e8m0 byte of its 32-row block,
// s the e4m3 scale of its 16-row block, pts the f32 per-tensor scale (the
// reference path multiplies the kernel's bf16 output by it in f32, then casts
// to the activation's bf16). x bf16 (M, K); f32 sums.
//
// Exact decoding. Hopper has no fp4 tensor cores, so each weight is decoded
// to bf16 and the product runs on the bf16 tensor cores. The block scale is
// folded into the decoded weight: an e2m1 value has at most 2 significant
// bits, an e4m3 scale at most 4 and an e8m0 scale is a power of two, so
// value * scale is exact in bf16, whose exponent range is f32's (down to its
// subnormals). Two weights are decoded at once, as bf16x2 (fp4_pair): the
// stored em field z (0 and 1 swapped, below) gives the bf16 bits
// (z << 6) + 0x3F00 of 0.5, 1, 1.5, 2, 3, 4, 6 with one integer multiply-add,
// a byte permute masks the zero code (stored z = 1) to +-0, the sign bit
// moves to bit 15, and one mul.rn.bf16x2 by the block scale as bf16x2
// (exact) folds it in. Every scale byte decodes exactly, branch-free (an
// NVFP4 pair-word's two at once): e8m0
// byte e is the bf16 bits e << 7, 2^(e - 127), with byte 0 the bf16
// subnormal 2^-127 and 255 exp2(128) = inf as in the reference's
// dequantize; an e4m3 byte's exponent and mantissa bits moved to bf16's
// positions read as 2^-120 times its value, normal or subnormal (so NVFP4's
// codes carry 2^120 in their base, 0x7B00), its NaN bytes NaN. The zero
// codes decode to an exact +-0. (The TPU kernel builds e4m3 scales as normal
// numbers, (1 + m/8) 2^-7 for a subnormal byte, and kills zero codes through
// the v5e MXU's flush of bf16 denormals; Hopper's tensor cores keep bf16
// denormals, so neither is copied: this kernel computes what dequantize()
// computes.) ops/hopper/fp4_matmul.py mirrors these integer steps in
// PyTorch (fp4_decode_mirror), and a CPU test holds the mirror bit for bit
// to the plain decode over every code and every scale byte.
//
// Layout: the "fp4 magic" words (K/8, N) int32 (quantization/qarrays/fp4.py):
// plane j holds logical rows [jK/4, (j+1)K/4), word row r holds plane rows 2r
// and 2r + 1 at bits 4j and 16 + 4j, with the em field's 0 and 1 swapped
// (stored em 0 is 0.5, stored em 1 is zero). A word's plane j is thus two
// consecutive K rows of one column: one bf16x2 of a K-major B tile, or one
// register of an mma.sync m16n8k16 fragment. K % 256 == 0, N % 128 == 0.
//
// What bounds it on the H100, and the two forms:
//  * prefill (M > 16): tensor-core operations, 2 M K N against 989 TFLOP/s,
//    with the decode's integer work on the same SMs. On the shared wgmma
//    mainloop (mixed_gemm.cuh, Fp4Op below): a stage is 8 word rows (64 K
//    values, 16 rows of each plane, so each k16 step of the stage is one
//    plane); its words (BN * 32 bytes) and the four scale rows it needs go to
//    the ring by cp.async beside the x tile, whose four 16-column pieces come
//    from the four planes' K ranges; each thread decodes the four words whose
//    planes are its wgmma A-fragment registers, so each weight is decoded
//    once per CTA, into registers. The tiles (BM, BN) and a split of K come
//    from fp4_matmul.pick_tiles. The first version (mma.sync, each warp
//    decoding its own B fragments: every weight decoded M / 64 times per N
//    tile, synchronous weight loads, 64 CTAs at N = 1024) took 11.9x
//    cuBLAS's time at M = 1024; what bounds this one is the decode's
//    instruction issue beside the tensor cores (PERF.md).
//  * decode (M <= 16): the weight stream, 0.5 B per weight plus the scales
//    (1/32 B per weight for MX, 1/8 B for NV's pair-words) against 3.35
//    TB/s, and the decode's integer work. It runs on K1's and K15's
//    weight-stream decode mainloop (gemv_mainloop.cuh, KS = 0: the fp4-magic
//    words are the int4 magic layout with one super-group, g = K/4) with
//    Fp4Gemv below: a TMA ring of slabs of 32 word rows filled by a producer
//    warp, each stage holding the slab's x and its block-scale rows; the
//    weights the A operand of mma.sync, decoded by fp4_pair and their
//    column's block scale straight into the fragments, every step's mma into
//    acc (no qparams, no fold); the K split summed in a thread-block cluster;
//    one kernel a call, no workspace, its plan from fp4_matmul.gemv_plan.
//    (The earlier decode kernel, K1's old GEMV, issued a unit's loads,
//    consumed them, and only then issued the next unit's; every warp read x
//    from global memory; its K split wrote f32 partials that a second kernel
//    summed.)

#include "gemv_mainloop.cuh"
#include "mixed_gemm.cuh"

namespace {

constexpr int kMx = 0, kNv = 1;
constexpr int kUnitK = 256;  // K per unit: four planes of 64 rows, a decode slab


__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two stored codes, at bits 0..3 and 16..19 of t, as bf16x2 bits of their
// e2m1 values (times 2^120 for NVFP4, whose scales carry 2^-120): sign bit
// 3; stored em z = 1 is +-0; otherwise (z << 6) + base is 0.5 (z = 0), 1,
// 1.5, 2, 3, 4, 6. The low byte of (z ^ 1) + 0x7F has its top bit set
// exactly where z != 1, and prmt's sign-replicate mode (selector nibbles 8
// and 10) spreads that bit over the half.
template <int KIND>
__device__ __forceinline__ uint32_t fp4_pair(uint32_t t) {
  constexpr uint32_t kBase = KIND == kMx ? 0x3F003F00u : 0x7B007B00u;
  const uint32_t z = t & 0x00070007u;
  const uint32_t v = z * 64u + kBase;
  const uint32_t keep = prmt((z ^ 0x00010001u) + 0x007F007Fu, 0u, 0xAA88u);
  return (v & keep) | ((t << 12) & 0x80008000u);
}

// An e8m0 block scale e as bf16x2 bits of 2^(e - 127), the same in both
// halves: the bf16 subnormal 0x0040 for e = 0, inf for 255.
__device__ __forceinline__ uint32_t mx_scale2(uint32_t e) {
  const uint32_t bits = e ? e << 7 : 0x0040u;
  return bits * 0x00010001u;
}

// Both e4m3fn bytes of an NVFP4 pair-word (bits 0..7 and 16..23) as bf16
// bits of their values times 2^-120, one a half: the exponent and mantissa
// fields moved to bf16's positions (a subnormal byte reads as a bf16
// subnormal, exactly), the sign to bit 15, and NaN where the low seven bits
// are all set (bytes 0x7F and 0xFF): m + 1 carries into bit 7 of its byte
// only there, and prmt's sign-replicate mode spreads that bit over the half.
__device__ __forceinline__ uint32_t nv_scale_pair(uint32_t pw) {
  const uint32_t m = pw & 0x007F007Fu;
  const uint32_t nan = prmt(m + 0x00010001u, 0u, 0xAA88u);
  return (m << 4) | ((pw << 8) & 0x80008000u) | (nan & 0x7FC07FC0u);
}

// The decode form's code decode: the four planes of a word (plane j the
// codes at bits 4j and 16 + 4j) as bf16x2 bits of their e2m1 values, as
// fp4_pair gives them, from byte tables. Bytes b and 2 + b of the word hold
// planes 2b and 2b + 1 of its two rows; their em fields, as the selector of
// a prmt over eight bytes, pick each value's low byte (L) and high byte (H),
// both 0 for the zero code (stored em 1); the signs go to H's top bits, and
// two more prmts pair the halves into the planes' registers. 16
// instructions a word, 4 a register (fp4_pair: about 9). tab holds the
// tables (L em 0..3, L em 4..7, H em 0..3, H em 4..7): fp4_table.
template <int KIND>
__host__ __device__ constexpr uint32_t fp4_table(int i) {
  return i == 0 ? 0xC0800000u : i == 1 ? 0xC0804000u
       : i == 2 ? (KIND == kMx ? 0x3F3F003Fu : 0x7B7B007Bu)
                : (KIND == kMx ? 0x40404040u : 0x7C7C7C7Cu);
}

__device__ __forceinline__ void fp4_planes(uint32_t w, const uint4& tab, uint32_t (&pl)[4]) {
  const uint32_t em = w & 0x77777777u, w4 = w << 4;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    // nibbles: plane 2b and 2b + 1 of row 0, then of row 1; each one's
    // sign at the top of byte n of sgn
    const uint32_t sel = prmt(em, 0u, b ? 0x31u : 0x20u);
    const uint32_t sgn = prmt(w4, w, b ? 0x7351u : 0x6240u);
    const uint32_t lo = prmt(tab.x, tab.y, sel);
    const uint32_t hi = prmt(tab.z, tab.w, sel) | (sgn & 0x80808080u);
    pl[2 * b] = prmt(lo, hi, 0x6240u);
    pl[2 * b + 1] = prmt(lo, hi, 0x7351u);
  }
}

// Byte c of v, an e8m0 block scale e, as mx_scale2 gives it: e << 7 in
// both halves, at least the bf16 subnormal 0x0040 (e = 0).
__device__ __forceinline__ uint32_t mx_scale2_byte(uint32_t v, int c) {
  const uint32_t e2 = prmt(v, 0u, 0x4040u | (c << 8) | c) << 7;
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;\n" : "=r"(d) : "r"(e2), "r"(0x00400040u));
  return d;
}

// Half sel of v in both halves.
__device__ __forceinline__ uint32_t half2(uint32_t v, int sel) {
  return prmt(v, 0u, sel ? 0x3232u : 0x1010u);
}

// The NVFP4 epilogue: the reference's bf16 output times pts in f32, in bf16.
template <int KIND>
__device__ __forceinline__ float finish(float acc, const float* pts) {
  if (KIND == kNv && pts != nullptr)
    return __bfloat162float(__float2bfloat16_rn(acc)) * __ldg(pts);
  return acc;
}

// K14's decode form on the weight-stream mainloop (gemv_mainloop.cuh at KS
// = 0). A stage's side rows are the slab's block scales, [4 planes][2 rows]
// [BN] values of kStageQ / 8 bytes: MX e8m0 bytes, NV pair-words (16-row
// blocks 2i and 2i + 1 in bytes 0 and 2). Step k (plane rows 16 k .. 16 k +
// 15 of the slab's 64) takes row k >> 1, and for NV block k & 1 of its
// pair-words. Each register of a fragment is two consecutive K rows of one
// column (fp4_planes), times that column's block scale as bf16x2 (exact).
template <int KIND>
struct Fp4Gemv {
  struct Args {
    const float* pts;  // NV: the per-tensor scale, or null
  };
  static constexpr bool kBias = false, kBlockScales = true;
  static constexpr int kQArrays = 0, kQBytes = 1;
  static constexpr int kStageQ = 8 * (KIND == kMx ? 1 : 4);  // 4 planes x 2 rows a column
  static constexpr int kEs = kStageQ / 8;                     // bytes a scale value
  // Shared: the code tables (loaded into registers once a slab: as
  // immediates, ptxas copied each into a register at every use), then for
  // each warp a row of decoded scales, [4 planes][32 columns] bf16x2.
  __host__ __device__ static int setup_bytes(const Args&) { return 16 + gv::kMaxWarps * 512; }
  __device__ static void setup(const Args&, uint8_t* tabs, int tid, int) {
    if (tid < 4) reinterpret_cast<uint32_t*>(tabs)[tid] = fp4_table<KIND>(tid);
  }
  struct Q {};

  struct Slab {
    const uint8_t* sc;  // the warp's 32 columns in the stage's first scale row
    int row;            // the bytes of a scale row
    uint32_t* dec;      // the warp's decoded row
    int cw;             // the thread's columns: 4 cw .. 4 cw + 3 of the warp's
    uint4 tab;          // the code tables
    uint32_t s2[4][4];  // [plane][column cb + c]: row r's scales (MX bf16x2; NV both blocks)
  };
  __device__ static Slab slab(const Args&, uint8_t* tabs, int, const uint8_t* q, int bn, int cb) {
    uint32_t* dec = reinterpret_cast<uint32_t*>(tabs + 16) + 128 * (threadIdx.x >> 5);
    return {q + (cb & ~31) * kEs, bn * kEs, dec, (cb & 31) >> 2,
            *reinterpret_cast<const uint4*>(tabs), {}};
  }

  // Scale row r of each plane (the 32-row block of steps 2r and 2r + 1),
  // decoded once for both steps, and once for the warp: a quad's four lanes
  // share their columns, so lane l decodes plane l / 8's columns 4 (l % 8)
  // .. + 3 into the warp's row in shared memory, and each thread reads its
  // own back (the two rows of a slab take turns in the one buffer). MX's
  // kernel so takes 111 registers a thread: two CTAs of 9 warps (wn 4, wk
  // 2) no longer fit an SM's sub-partitions, which gemv_plan never picks.
  __device__ static void scale_row(Slab& sl, int r) {
    const int lane = threadIdx.x & 31, j = lane >> 3, c4 = 4 * (lane & 7);
    const uint8_t* src = sl.sc + (2 * j + r) * sl.row + c4 * kEs;
    uint4 d;
    if constexpr (KIND == kMx) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(src);
      d = make_uint4(mx_scale2_byte(v, 0), mx_scale2_byte(v, 1), mx_scale2_byte(v, 2),
                     mx_scale2_byte(v, 3));
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      d = make_uint4(nv_scale_pair(v.x), nv_scale_pair(v.y), nv_scale_pair(v.z),
                     nv_scale_pair(v.w));
    }
    __syncwarp();  // every lane has read the previous row
    *reinterpret_cast<uint4*>(sl.dec + 32 * j + c4) = d;
    __syncwarp();
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint4 t = *reinterpret_cast<const uint4*>(sl.dec + 32 * p + 4 * sl.cw);
      sl.s2[p][0] = t.x, sl.s2[p][1] = t.y, sl.s2[p][2] = t.z, sl.s2[p][3] = t.w;
    }
  }

  // Step k: each word's four planes decoded and scaled (row k >> 1's
  // scales; NV's block k & 1); register e of tile p is word 4p + e of (w0.x,
  // w0.y, w1.x, w1.y, w0.z, w0.w, w1.z, w1.w), column cb + 2p + (e & 1).
  __device__ static void decode(const Slab& sl, int k, const uint4& w0, const uint4& w1,
                                uint32_t (&a)[4][2][4]) {
    uint32_t s2[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s2[j][c] = KIND == kMx ? sl.s2[j][c] : half2(sl.s2[j][c], k & 1);
    const uint32_t words[8] = {w0.x, w0.y, w1.x, w1.y, w0.z, w0.w, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t pl[4];
      fp4_planes(words[i], sl.tab, pl);
      const int p = i >> 2, e = i & 3;
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j][p][e] = mul_bf16x2(pl[j], s2[j][2 * p + (e & 1)]);
    }
  }

  __device__ static float finish(const Args& a, float v) { return ::finish<KIND>(v, a.pts); }
};

// K14's prefill decode for the wgmma mainloop. Stage s is word rows 8s .. 8s + 7:
// rows 16s .. 16s + 15 of each plane j, whose k16 step is the stage's K
// values 16j .. 16j + 15 (x chunks 2j, 2j + 1 from columns jK/4 + 16s ..).
// Its slot holds the words [8][BN + 4] int32 (rows padded by 16 bytes, so
// the four word rows a warp reads at once fall in different banks), then
// the scale rows jK/128 + s/2 of the four planes, [4][BN] e8m0 bytes (MX) or
// pair-words (NV, block s & 1 of the pair).
template <int KIND>
struct Fp4Op {
  struct Args {
    const int32_t* word;
    const void* scale;
    const float* pts;
  };
  static constexpr int kScaleBytes = KIND == kMx ? 1 : 4;

  template <int BN>
  __host__ __device__ static constexpr int raw_bytes() {
    return 8 * (BN + 4) * 4 + 4 * BN * kScaleBytes;
  }

  __device__ static int x_col(const Args&, const mg::Problem& pb, int s, int c, bool& valid) {
    valid = true;
    return (c >> 1) * (pb.K / 4) + 16 * s + 8 * (c & 1);
  }

  template <int BN, int NT>
  __device__ static void load_raw(const Args& a, const mg::Problem& pb, uint8_t* raw, int s,
                                  int n0, int tid) {
    constexpr int WCH = BN / 4;  // 16-byte chunks of a word row
    mg::for_chunks<8 * WCH, NT>(tid, [&](int e) {
      const int r = e / WCH, cc = e % WCH;
      mg::cp_async16(raw + (r * (BN + 4) + 4 * cc) * 4,
                     a.word + (size_t)(8 * s + r) * pb.N + n0 + 4 * cc, true);
    });
    constexpr int SCH = BN * kScaleBytes / 16;  // 16-byte chunks of a scale row
    uint8_t* sc = raw + 8 * (BN + 4) * 4;
    mg::for_chunks<4 * SCH, NT>(tid, [&](int e) {
      const int j = e / SCH, cc = e % SCH;
      const size_t row = (size_t)j * (pb.K / 128) + (s >> 1);
      mg::cp_async16(sc + j * BN * kScaleBytes + 16 * cc,
                     static_cast<const uint8_t*>(a.scale) + (row * pb.N + n0) * kScaleBytes + 16 * cc,
                     true);
    });
  }

  // Plane j of a word is step j's fragment register: column cl (a0, a2) or
  // cl + 8 (a1, a3), word row tig (a0, a1: K rows 2 tig, 2 tig + 1) or
  // tig + 4 (a2, a3: K rows 2 tig + 8, + 9), times its column's block scale.
  template <int BN>
  __device__ static void decode_a(const Args&, const uint8_t* raw, int s, int cl, int lane,
                                  uint32_t (&a)[4][4]) {
    const int tig = lane & 3;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(raw);
    const uint32_t w[4] = {words[tig * (BN + 4) + cl], words[tig * (BN + 4) + cl + 8],
                           words[(tig + 4) * (BN + 4) + cl], words[(tig + 4) * (BN + 4) + cl + 8]};
    const uint8_t* sc = raw + 8 * (BN + 4) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t s0, s1;
      if (KIND == kMx) {
        s0 = mx_scale2(sc[j * BN + cl]);
        s1 = mx_scale2(sc[j * BN + cl + 8]);
      } else {
        const uint32_t* pw = reinterpret_cast<const uint32_t*>(sc) + j * BN;
        s0 = half2(nv_scale_pair(pw[cl]), s & 1);
        s1 = half2(nv_scale_pair(pw[cl + 8]), s & 1);
      }
      a[j][0] = mul_bf16x2(fp4_pair<KIND>(w[0] >> (4 * j)), s0);
      a[j][1] = mul_bf16x2(fp4_pair<KIND>(w[1] >> (4 * j)), s1);
      a[j][2] = mul_bf16x2(fp4_pair<KIND>(w[2] >> (4 * j)), s0);
      a[j][3] = mul_bf16x2(fp4_pair<KIND>(w[3] >> (4 * j)), s1);
    }
  }

  __device__ static float finish(const Args& a, int, float acc) {
    return ::finish<KIND>(acc, a.pts);
  }
};

// Second pass of a split-K launch: out = bf16(finish(sum over splits of ws)).
template <int KIND>
__global__ void fp4_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ pts,
                                  __nv_bfloat16* __restrict__ out, size_t mn, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * mn + i];
  out[i] = __float2bfloat16(finish<KIND>(acc, pts));
}

// The prefill (M > 16) on the wgmma mainloop, per = stages of 64 K values
// per split.
template <int KIND>
cudaError_t launch(const __nv_bfloat16* x, const int32_t* word, const void* scale,
                   const float* pts, __nv_bfloat16* out, float* ws, int M, int K, int N, int bm,
                   int bn, int splits, int per, cudaStream_t st) {
  const mg::Problem pb{x, out, ws, M, K, N, per, K / mg::kBK};
  const cudaError_t err = mg::launch<Fp4Op<KIND>>(pb, {word, scale, pts}, bm, bn, splits, st);
  if (err != cudaSuccess || ws == nullptr) return err;
  const size_t mn = (size_t)M * N;
  fp4_reduce_kernel<KIND><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, pts, out, mn, splits);
  return cudaGetLastError();
}

}  // namespace

// K per unit (4 planes x 64 rows) and the N granule; the wrapper checks its
// shapes against them at load.
extern "C" int ao_fp4_k_unit() { return kUnitK; }
extern "C" int ao_fp4_n_block() { return 128; }

// The prefill (M > 16). kind 0 MXFP4 (scale: e8m0 bytes (K/32, N) uint8,
// pts unused), 1 NVFP4 (scale: e4m3 pair-words (K/32, N) int32, pts an f32
// scalar or null). x (M, K) bf16; word (K/8, N) int32; out (M, N) bf16.
// Tiles from fp4_matmul.pick_tiles: the mainloop's (bm, bn) with per stages
// of 64 K a split; ws (splits, M, N) f32 when splits > 1. Needs K % 256 ==
// 0, N % 128 == 0 and 16-byte aligned rows; the Python wrapper checks them.
// Returns cudaGetLastError() after the launches.
extern "C" int ao_fp4_wo(int kind, const void* x_, const void* word_, const void* scale,
                         const void* pts_, void* out_, void* ws_, int M, int K, int N, int bm,
                         int bn, int splits, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* pts = static_cast<const float*>(pts_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  if (K % kUnitK || N % 128 || M < 1) return (int)cudaErrorInvalidValue;
  if (kind == kMx)
    return (int)launch<kMx>(x, word, scale, nullptr, out, ws, M, K, N, bm, bn, splits, per, st);
  if (kind == kNv)
    return (int)launch<kNv>(x, word, scale, pts, out, ws, M, K, N, bm, bn, splits, per, st);
  return (int)cudaErrorInvalidValue;
}

// The decode (M <= 16), one launch on the weight-stream mainloop, no
// workspace: kind, x, word, scale, pts and out as above; the plan (wn warps
// along N, wk warps along K, cluster CTAs along K, ring stages) from
// fp4_matmul.gemv_plan, checked again here (gv::plan_ok). Returns
// cudaGetLastError() after the launch, or minus libcuda's CUresult for a
// tensor map it refuses.
extern "C" int ao_fp4_wo_gemv(int kind, const void* x, const void* word, const void* scale,
                              const void* pts, void* out, int M, int K, int N, int wn, int wk,
                              int cluster, int stages, void* stream) {
  if (K % kUnitK || N % 128 || cluster < 1) return (int)cudaErrorInvalidValue;
  const int slabs = K / kUnitK;
  const gv::Problem pb{static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(word),
                       static_cast<__nv_bfloat16*>(out), M, K, N, wn, wk, stages,
                       (slabs + cluster - 1) / cluster};
  const void* q[1] = {scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == kMx) return gv::launch<Fp4Gemv<kMx>, 0>(pb, {nullptr}, q, cluster, st);
  if (kind == kNv)
    return gv::launch<Fp4Gemv<kNv>, 0>(pb, {static_cast<const float*>(pts)}, q, cluster, st);
  return (int)cudaErrorInvalidValue;
}
