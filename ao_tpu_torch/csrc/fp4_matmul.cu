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
// What bounds it on the H100, and the two kernels:
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
//  * decode (M <= 16, fp4_gemv_kernel): the weight stream, 0.5 B per weight
//    plus the scales (1/32 B per weight for MX, 1/8 B for NV's pair-words)
//    against 3.35 TB/s, and the decode's integer work. K1's structure: the
//    weights are the A operand (16 columns of N as the rows of an m16 tile),
//    x^T the B operand, each warp owns 32 columns, each thread issues a
//    unit's eight 16-byte word loads and its scale loads before it uses any,
//    and the grid splits K by whole units (grid.z) into f32 partials summed
//    by a second pass. The unit's K order is permuted alike in A and B so
//    that a thread's rows of a plane are 16 consecutive ones: its x comes in
//    two 16-byte loads a plane and row (not eight of 4 bytes), and one block
//    scale a plane and column covers them, decoded once; the weights are
//    decoded two at a time (fp4_pair).

#include "mixed_gemm.cuh"

namespace {

constexpr int kMx = 0, kNv = 1;
constexpr int kUnitWords = 32;  // word rows per decode unit
constexpr int kStep = 64;       // logical K per (unit, plane) step of the decode kernel

using mg::pack_bf16x2;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int4 ld_16(const void* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ uint32_t elem(const int4& v, int i) {
  return i == 0 ? (uint32_t)v.x : i == 1 ? (uint32_t)v.y : i == 2 ? (uint32_t)v.z : (uint32_t)v.w;
}

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

// Half sel of v in both halves.
__device__ __forceinline__ uint32_t half2(uint32_t v, int sel) {
  return prmt(v, 0u, sel ? 0x3232u : 0x1010u);
}

// The raw scale entries covering logical row kk (a multiple of 16) for the
// four columns col .. col + 3: MX, the four e8m0 bytes of row kk/32 in one
// word; NV, the four pair-words of row kk/32 (16-row block 2i + sel in byte
// sel, at bit 16 sel).
template <int KIND>
struct Scales;

template <>
struct Scales<kMx> {
  uint32_t v;
  __device__ __forceinline__ void load(const void* scale, int kk, int col, int N) {
    v = __ldg(reinterpret_cast<const unsigned int*>(static_cast<const uint8_t*>(scale) +
                                                    (size_t)(kk >> 5) * N + col));
  }
  // column i's scale as bf16x2, for either 16-row block of the pair
  __device__ __forceinline__ uint32_t pair(int i) const { return mx_scale2((v >> (8 * i)) & 0xFFu); }
  __device__ __forceinline__ static uint32_t scale2(uint32_t pair, int) { return pair; }
};

template <>
struct Scales<kNv> {
  int4 v;
  __device__ __forceinline__ void load(const void* scale, int kk, int col, int N) {
    v = ld_16(static_cast<const int32_t*>(scale) + (size_t)(kk >> 5) * N + col);
  }
  // column i's two block scales, one a half; scale2 picks block sel
  __device__ __forceinline__ uint32_t pair(int i) const { return nv_scale_pair(elem(v, i)); }
  __device__ __forceinline__ static uint32_t scale2(uint32_t pair, int sel) {
    return half2(pair, sel);
  }
};

// The NVFP4 epilogue: the reference's bf16 output times pts in f32, in bf16.
template <int KIND>
__device__ __forceinline__ float finish(float acc, const float* pts) {
  if (KIND == kNv && pts != nullptr)
    return __bfloat162float(__float2bfloat16_rn(acc)) * __ldg(pts);
  return acc;
}

// Decode kernel (M <= 16, NT = ceil(M/8)). grid (N/128, 1, splits), 128
// threads; warp w owns columns nb = (4*blockIdx.x + w)*32 .. + 31; the thread
// loads columns col = nb + 4*gid .. + 3, in two m16 tiles: tile p holds in its
// rows 0..7 column col + 2p and in rows 8..15 column col + 2p + 1. Split z
// covers units [z*ups, (z+1)*ups).
template <int KIND, int NT>
__global__ void __launch_bounds__(128)
    fp4_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ word,
                    const void* __restrict__ scale, const float* __restrict__ pts,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M, int K, int N,
                    int ups) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = (blockIdx.x * 4 + warp) * 32;
  const int col = nb + 4 * gid;
  const int kq = K / 4;
  const int units = K / (4 * kStep);
  const int u_end = min((int)(blockIdx.z + 1) * ups, units);

  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;

  for (int u = blockIdx.z * ups; u < u_end; ++u) {
    // K order within the unit, the same for A and B: the thread's fragment
    // K pairs (2 tig, 2 tig + 1) and (2 tig + 8, + 9) of k16 step c are the
    // plane's rows 16 tig + 4c, + 1 and 16 tig + 4c + 2, + 3. So over the
    // four steps the thread reads word rows 8 tig .. 8 tig + 7 of the unit
    // (step c: 8 tig + 2c and + 1), one block scale per plane and column
    // (MX block 32 rows, NV 16: both hold rows 16 tig .. + 15), and 32
    // contiguous bytes of each x row per plane.
    int4 w[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      w[r] = ld_16(word + (size_t)(kUnitWords * u + 8 * tig + r) * N + col);
    Scales<KIND> sv[4];  // [plane j]: the row holding rows 16 tig .. of the unit
#pragma unroll
    for (int j = 0; j < 4; ++j) sv[j].load(scale, j * kq + kStep * u + 16 * tig, col, N);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t s2[4];  // column col + i's block scale, decoded once
#pragma unroll
      for (int i = 0; i < 4; ++i) s2[i] = Scales<KIND>::scale2(sv[j].pair(i), tig & 1);
      int4 xv[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = gid + 8 * nt;
        const __nv_bfloat16* xr = x + (size_t)r * K + j * kq + kStep * u + 16 * tig;
        xv[nt][0] = r < M ? ld_16(xr) : make_int4(0, 0, 0, 0);
        xv[nt][1] = r < M ? ld_16(xr + 8) : make_int4(0, 0, 0, 0);
      }
      const int sh = 4 * j;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int4& w0 = w[2 * c];
        const int4& w1 = w[2 * c + 1];
        const uint32_t a0[4] = {mul_bf16x2(fp4_pair<KIND>((uint32_t)w0.x >> sh), s2[0]),
                                mul_bf16x2(fp4_pair<KIND>((uint32_t)w0.y >> sh), s2[1]),
                                mul_bf16x2(fp4_pair<KIND>((uint32_t)w1.x >> sh), s2[0]),
                                mul_bf16x2(fp4_pair<KIND>((uint32_t)w1.y >> sh), s2[1])};
        const uint32_t a1[4] = {mul_bf16x2(fp4_pair<KIND>((uint32_t)w0.z >> sh), s2[2]),
                                mul_bf16x2(fp4_pair<KIND>((uint32_t)w0.w >> sh), s2[3]),
                                mul_bf16x2(fp4_pair<KIND>((uint32_t)w1.z >> sh), s2[2]),
                                mul_bf16x2(fp4_pair<KIND>((uint32_t)w1.w >> sh), s2[3])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int4& xc = xv[nt][c >> 1];
          const uint32_t b0 = (c & 1) ? (uint32_t)xc.z : (uint32_t)xc.x;
          const uint32_t b1 = (c & 1) ? (uint32_t)xc.w : (uint32_t)xc.y;
          mma_16816(acc[0][nt], a0, b0, b1);
          mma_16816(acc[1][nt], a1, b0, b1);
        }
      }
    }
  }

  // C fragment e of tile p: column col + 2p + (e >> 1), batch row
  // 2*tig + (e & 1) (+ 8nt); the thread's outputs: rows 2*tig + h, columns
  // col .. col + 3
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * tig + h + 8 * nt;
      if (r >= M) continue;
      const float v[4] = {acc[0][nt][h], acc[0][nt][2 + h], acc[1][nt][h], acc[1][nt][2 + h]};
      const size_t off = (size_t)r * N + col;
      if (ws == nullptr) {
        *reinterpret_cast<uint2*>(out + off) =
            make_uint2(pack_bf16x2(finish<KIND>(v[0], pts), finish<KIND>(v[1], pts)),
                       pack_bf16x2(finish<KIND>(v[2], pts), finish<KIND>(v[3], pts)));
      } else {
        *reinterpret_cast<float4*>(ws + (size_t)blockIdx.z * M * N + off) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
}

// K14's decode for the shared mainloop. Stage s is word rows 8s .. 8s + 7:
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

template <int KIND>
cudaError_t launch(const __nv_bfloat16* x, const int32_t* word, const void* scale,
                   const float* pts, __nv_bfloat16* out, float* ws, int M, int K, int N, int bm,
                   int bn, int splits, int per, cudaStream_t st) {
  cudaError_t err;
  if (bm == 16) {  // the decode kernel, per = units per split
    if (M > 16 || bn != 128) return cudaErrorInvalidValue;
    dim3 grid(N / 128, 1, splits);
    if (M <= 8)
      fp4_gemv_kernel<KIND, 1><<<grid, 128, 0, st>>>(x, word, scale, pts, out, ws, M, K, N, per);
    else
      fp4_gemv_kernel<KIND, 2><<<grid, 128, 0, st>>>(x, word, scale, pts, out, ws, M, K, N, per);
    err = cudaGetLastError();
  } else {  // the mainloop, per = stages of 64 K values per split
    const mg::Problem pb{x, out, ws, M, K, N, per, K / mg::kBK};
    err = mg::launch<Fp4Op<KIND>>(pb, {word, scale, pts}, bm, bn, splits, st);
  }
  if (err != cudaSuccess || ws == nullptr) return err;
  const size_t mn = (size_t)M * N;
  fp4_reduce_kernel<KIND><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, pts, out, mn, splits);
  return cudaGetLastError();
}

}  // namespace

// K per decode unit (4 planes x 64 rows) and the N granule; the wrapper
// checks its shapes against them at load.
extern "C" int ao_fp4_k_unit() { return 4 * kStep; }
extern "C" int ao_fp4_n_block() { return 128; }

// kind 0 MXFP4 (scale: e8m0 bytes (K/32, N) uint8, pts unused), 1 NVFP4
// (scale: e4m3 pair-words (K/32, N) int32, pts an f32 scalar or null).
// x (M, K) bf16; word (K/8, N) int32; out (M, N) bf16. Tiles from
// fp4_matmul.pick_tiles: bm 16 the decode kernel (M <= 16, bn 128, per units
// of 256 K a split), else the mainloop's (bm, bn) with per stages of 64 K a
// split; ws (splits, M, N) f32 when splits > 1. Needs K % 256 == 0,
// N % 128 == 0 and 16-byte aligned rows; the Python wrapper checks them.
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
  if (K % (4 * kStep) || N % 128 || M < 1) return (int)cudaErrorInvalidValue;
  if (kind == kMx)
    return (int)launch<kMx>(x, word, scale, nullptr, out, ws, M, K, N, bm, bn, splits, per, st);
  if (kind == kNv)
    return (int)launch<kNv>(x, word, scale, pts, out, ws, M, K, N, bm, bn, splits, per, st);
  return (int)cudaErrorInvalidValue;
}
