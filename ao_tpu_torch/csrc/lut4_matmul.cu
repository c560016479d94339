// 16-entry-LUT (codebook) weight-only matmul over the int4 "magic" layout, for
// Hopper (sm_90a): K15.
//
// Replaces the TPU kernel ao_tpu/ops/pallas/lut4_matmul.py::_lut4_kernel
// (launched by _lut4_impl, public entry lut4_wo_magic_pallas):
//
//   y[m, n] = bf16( sum_G s[G, n] * sum_{k in G} x[m, k] * lut_L(G)[u[k, n]] ),
//
// u the 4-bit code of the weight (NF4: an index into the QLoRA codebook),
// lut_L(G) the bf16-rounded 16-entry codebook of group G: one shared (16,)
// table, or (L, 16) tables with table G / groups_per_lut for group G (row
// blocks of K/L rows, a multiple of the group size g); s the f32 per-group
// scaler (K/g, N); x bf16 (M, K); f32 sums. The tables are a device tensor
// read at run time, so a k-means codebook needs no rebuild.
//
// Layout: K1's int4 magic words (K/8, N) over the code nibbles, group g
// (quantization/qarrays/int4.py): word row (g/2)t + r' holds, at bits
// 4j + 16h, logical row (4t + j)g + 2r' + h, so plane j of super-group t is
// group 4t + j and a word's plane j is two consecutive K rows of one column,
// one register of an A fragment.
//
// Decoding: a nibble's value is its table's bf16 entry exactly. (The TPU
// kernel builds the values with an XOR select tree for its vector unit; the
// bf16 entries it selects are the same.) Scalers are applied in f32 after
// each group's products, as K1 applies its group scales: tmp = x_G .
// lut[u_G] on the tensor cores, acc += s * tmp.
//
// What bounds it on the H100, and the two forms (K1's):
//  * decode (M <= 16): the weight stream, 0.5 B per weight plus 4 B of
//    scaler per g weights, against 3.35 TB/s. It runs on K1's weight-stream
//    decode mainloop (gemv_mainloop.cuh) with GemvLut below: the ring of
//    slabs of word rows, x and the scaler rows in shared memory, the
//    codebooks copied into shared memory as bf16 when the CTA starts (a
//    group's 16 entries in 8 banks, so a warp's lookups never conflict),
//    the K split summed in a thread-block cluster; one kernel a call, its
//    plan from int4_matmul.gemv_plan. (The earlier decode kernel was K1's
//    earlier one with table lookups: a run's loads consumed before the next
//    run's were issued, its K split summed by a second kernel.)
//  * prefill (M > 16): tensor-core operations, 2 M K N against 989 TFLOP/s,
//    on the shared wgmma mainloop (mixed_gemm.cuh) with MagicOp
//    (magic_op.cuh) and PlaneLut below: the stage's slot carries each of its
//    groups' scaler row and 16 bf16 table entries (32 bytes: a warp's
//    lookups fall in 8 banks, one word per bank, so none conflict), each
//    thread looks up the two nibbles of each fragment register (two shared
//    loads and a byte permute per two weights) from a unit buffer of 64 word
//    rows loaded once per CTA, and the fold adds s * tmp to acc. Tiles and
//    the split of K as K1's (int4_matmul.pick_tiles_magic). Its lookups
//    cost more issue slots than K1's plane_q (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_mainloop.cuh"
#include "magic_op.cuh"

namespace {

constexpr int kMaxLuts = 256;  // (L, 16) codebooks a CTA holds in shared memory

// the entries of the nibbles at bits 4j and 16 + 4j of a word, as bf16x2
__device__ __forceinline__ uint32_t lut_pair(const uint16_t* tab, uint32_t w, int j) {
  const uint32_t t = w >> (4 * j);
  return (uint32_t)tab[t & 15u] | ((uint32_t)tab[(t >> 16) & 15u] << 16);
}

// prmt.b32 in its default mode: byte n of the result is byte s[4n+2:4n] of
// {b, a}.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// K15's decode on the weight-stream mainloop (gemv_mainloop.cuh): the
// codebook lookup, and per group acc += s * tmp. A folding stage's
// qparams: the scaler rows of its 4 groups, f32.
//
// BYTES (one codebook for every group, NF4's): the codebook becomes a table
// of 256 bf16x2 pairs in shared memory, entry b = (lut[b & 15], lut[b >>
// 4]), so a word byte's two nibbles (groups 2k and 2k + 1 of one K row) come
// from one load, and a word's four planes from four: byte k of the word by
// prmt, its entry, then two prmts pair the two rows' entries into each
// plane's register, 16 instructions a word. The table is held 16 times
// over, entry b of copy c at word 16 b + c, so that lane l, reading copy l %
// 16, meets another lane in its bank only where their bytes' parity agrees
// (a warp's 32 random entries of one 256-word table met in up to 4-5). (L,
// 16) codebooks go by each nibble in its codebook (32 bytes a codebook, two
// 16-bit loads and about 9 instructions a register).
template <bool BYTES>
struct GemvLut {
  struct Args {
    const float* s;
    const __nv_bfloat16* lut;
    int n_luts;
    int gpl;  // groups per codebook (0: one shared codebook)
  };
  static constexpr bool kBias = false, kBlockScales = false;
  static constexpr int kQArrays = 1, kQBytes = 4, kStageQ = 16;  // the scalers in f32
  __host__ __device__ static int setup_bytes(const Args& a) {
    return BYTES ? 16 * 1024 : 32 * a.n_luts;
  }
  __device__ static void setup(const Args& a, uint8_t* tabs, int tid, int threads) {
    const uint16_t* src = reinterpret_cast<const uint16_t*>(a.lut);
    if (BYTES) {  // entry b's 16 copies: words 16 b .. 16 b + 15
      for (int b = tid; b < 256; b += threads) {
        const uint32_t v = src[b & 15] | (uint32_t)src[b >> 4] << 16;
        uint4* dst = reinterpret_cast<uint4*>(tabs) + 4 * b;
        dst[0] = dst[1] = dst[2] = dst[3] = make_uint4(v, v, v, v);
      }
    } else {
      for (int e = tid; e < 16 * a.n_luts; e += threads)
        reinterpret_cast<uint16_t*>(tabs)[e] = src[e];
    }
  }

  struct Q {
    float4 s[4];  // columns cb .. cb + 3 of the four groups
  };
  __device__ static void read_q(const uint8_t* q, int bn, int cb, Q& r) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r.s[j] = *reinterpret_cast<const float4*>(gv::q_at(q, bn, 4, 0, j, cb));
  }

  struct Slab {
    const void* tab[BYTES ? 1 : 4];  // this lane's copy of the pair table, or the codebooks
  };
  __device__ static Slab slab(const Args& a, const uint8_t* tabs, int grp, const uint8_t*, int,
                              int) {
    Slab sl;
    if (BYTES) {
      sl.tab[0] = tabs + 4 * (threadIdx.x % 16);
    } else {
#pragma unroll
      for (int j = 0; j < (BYTES ? 1 : 4); ++j)
        sl.tab[j] = tabs + 32 * (a.gpl == 0 ? 0 : (grp + j) / a.gpl);
    }
    return sl;
  }
  __device__ static void decode(const Slab& sl, int, const uint4& w0, const uint4& w1,
                                uint32_t (&a)[4][2][4]) {
    if constexpr (BYTES) {
      const uint32_t* tab = static_cast<const uint32_t*>(sl.tab[0]);
      const uint32_t words[8] = {w0.x, w0.y, w1.x, w1.y, w0.z, w0.w, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // bytes 0 / 1 hold groups (0, 1) / (2, 3) of row 2r', bytes 2 / 3 of row 2r' + 1
        uint32_t e[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) e[k] = tab[prmt(words[i], 0, 0x4440 + k) * 16];
        uint32_t* out[4] = {&a[0][i >> 2][i & 3], &a[1][i >> 2][i & 3], &a[2][i >> 2][i & 3],
                            &a[3][i >> 2][i & 3]};
        *out[0] = prmt(e[0], e[2], 0x5410);
        *out[1] = prmt(e[0], e[2], 0x7632);
        *out[2] = prmt(e[1], e[3], 0x5410);
        *out[3] = prmt(e[1], e[3], 0x7632);
      }
    } else {
      gv::by_plane(
          [&](uint32_t w, int j) {
            return lut_pair(static_cast<const uint16_t*>(sl.tab[j]), w, j);
          },
          w0, w1, a);
    }
  }

  // C fragment e of tile p: column cb + 2p + (e >> 1)
  template <int NT>
  __device__ static void fold(const Args&, const Q& r, int j, const float (&tmp)[2][NT][4],
                              const float (&)[NT][4], float (&acc)[2][NT][4]) {
    const float sc[4] = {r.s[j].x, r.s[j].y, r.s[j].z, r.s[j].w};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[p][nt][e] = fmaf(sc[2 * p + (e >> 1)], tmp[p][nt][e], acc[p][nt][e]);
  }

  __device__ static float finish(const Args&, float v) { return v; }
};

// K15's decode for MagicOp: the codebook lookup, and the fold acc += s *
// tmp per group. A group's bytes in the slot: its table's 16 bf16 entries,
// then its scaler row, [BN] f32.
struct PlaneLut {
  struct Params {
    const float* s;
    const __nv_bfloat16* lut;
    int gpl;  // groups per table (0: one shared table)
  };

  template <int BN>
  __host__ __device__ static constexpr int group_bytes() {
    return 32 + BN * 4;
  }

  // One 16-byte chunk of a group's bytes a thread (the first 2 + BN / 4
  // threads): the table's two, then the scaler row's.
  template <int BM, int BN, int NT>
  struct Thread {
    static_assert(2 + BN / 4 <= NT, "a chunk a thread");
    const uint8_t* src;
    int stride, dst;
    bool ok, active, table;

    __device__ Thread(const Params& p, const mg::Problem& pb, int, int n0, int tid) {
      active = tid < 2 + BN / 4;
      table = tid < 2;
      dst = 16 * tid;
      if (table) {
        src = reinterpret_cast<const uint8_t*>(p.lut + 8 * tid);
        stride = 0;
        ok = true;
      } else {
        const int col = n0 + 4 * (tid - 2);
        src = reinterpret_cast<const uint8_t*>(p.s + col);
        stride = 4 * pb.N;
        ok = col < pb.N;
      }
    }

    __device__ void load(const Params& p, const mg::Problem&, uint8_t* gb, int grp) const {
      if (!active) return;
      const uint8_t* at =
          table ? src + 32 * (p.gpl == 0 ? 0 : grp / p.gpl) : src + (size_t)grp * stride;
      mg::cp_async16(gb + dst, ok ? at : src, ok);
    }
  };

  // the entries of the nibbles at bits 4j and 16 + 4j, as bf16x2
  __device__ static uint32_t plane(const uint8_t* gb, uint32_t w, int j) {
    const uint16_t* tab = reinterpret_cast<const uint16_t*>(gb);
    const uint32_t t = w >> (4 * j);
    return (uint32_t)tab[t & 15u] | ((uint32_t)tab[(t >> 16) & 15u] << 16);
  }

  // accumulator d[4i + 2h + e]: column cl + 8h
  template <int BM, int BN>
  __device__ static void fold(const Params&, const uint8_t* gb, int cl, int,
                              const float (&tmp)[BM / 2], float (&acc)[BM / 2]) {
    const float* s = reinterpret_cast<const float*>(gb + 32);
    const float sc[2] = {s[cl], s[cl + 8]};
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = fmaf(sc[(i >> 1) & 1], tmp[i], acc[i]);
  }
};

// Second pass of a split-K prefill launch: out = bf16(sum over splits of ws).
__global__ void lut4_reduce_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                                   size_t mn, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * mn + i];
  out[i] = __float2bfloat16(acc);
}

// The compiled group sizes: g = 16 KS
template <class F>
cudaError_t by_group(int G, F&& run) {
  switch (G) {
    case 16: return run(std::integral_constant<int, 1>());
    case 32: return run(std::integral_constant<int, 2>());
    case 64: return run(std::integral_constant<int, 4>());
    case 128: return run(std::integral_constant<int, 8>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The most (L, 16) tables the kernel holds; the wrapper checks it at load.
extern "C" int ao_lut4_max_luts() { return kMaxLuts; }

// The prefill (M > 16). x (M, K) bf16; word (K/8, N) int32 (magic layout
// over the code nibbles, group G); s (K/G, N) f32; lut (n_luts, 16) bf16
// with gpl groups per table (gpl == 0: n_luts == 1, shared); out (M, N)
// bf16; the mainloop's tiles (bm, bn) from lut4_matmul.launch_tiles with
// per stages of 64 K a split (whole units of 8 stages when split), ws
// (splits, M, N) f32 when splits > 1. Needs G in {16, 32, 64, 128}, N % 32
// == 0, K % (4G) == 0 and 16-byte aligned rows; the Python wrapper checks
// them. Returns cudaGetLastError() after the launches.
extern "C" int ao_lut4_wo(const void* x_, const void* word_, const void* s_, const void* lut_,
                          void* out_, void* ws_, int M, int K, int N, int G, int gpl, int bm,
                          int bn, int splits, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  const auto* s = static_cast<const float*>(s_);
  const auto* lut = static_cast<const __nv_bfloat16*>(lut_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  if (M <= 16 || N % 32 || K % (4 * G)) return (int)cudaErrorInvalidValue;
  const mg::Problem pb{x, out, ws, M, K, N, per, K / mg::kBK};
  const cudaError_t err = by_group(G, [&](auto ks) {
    return mg::launch<mg::MagicOp<PlaneLut, 16 * decltype(ks)::value>>(
        pb, {static_cast<const int32_t*>(word_), {s, lut, gpl}}, bm, bn, splits, st);
  });
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  const size_t mn = (size_t)M * N;
  lut4_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, out, mn, splits);
  return (int)cudaGetLastError();
}

// The decode (M <= 16), one launch on the weight-stream mainloop: x, word,
// s, lut, gpl and out as above, 1 <= n_luts <= 256; bytes != 0 the pair
// table of one codebook (n_luts == 1, GemvLut); the plan (wn warps
// along N, wk warps along K, cluster CTAs along K, ring stages) from
// int4_matmul.gemv_plan, checked again here (gv::plan_ok).
// Returns cudaGetLastError() after the launch, or minus libcuda's CUresult
// for a tensor map it refuses.
extern "C" int ao_lut4_wo_gemv(const void* x, const void* word, const void* s, const void* lut,
                               void* out, int M, int K, int N, int G, int n_luts, int gpl,
                               int bytes, int wn, int wk, int cluster, int stages, void* stream) {
  if (n_luts < 1 || n_luts > kMaxLuts || (bytes && n_luts != 1) || N % 32 || G < 16 ||
      K % (4 * G) || cluster < 1)
    return (int)cudaErrorInvalidValue;
  const int slabs = K / (4 * (G < 64 ? G : 64));  // of 8 R K values, R = min(g / 2, 32)
  const gv::Problem pb{static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(word),
                       static_cast<__nv_bfloat16*>(out), M, K, N, wn, wk, stages,
                       (slabs + cluster - 1) / cluster};
  const void* q[1] = {s};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = (int)cudaErrorInvalidValue;
  by_group(G, [&](auto ks) {
    constexpr int KS = decltype(ks)::value;
    if (bytes) {
      const GemvLut<true>::Args args{static_cast<const float*>(s),
                                     static_cast<const __nv_bfloat16*>(lut), n_luts, gpl};
      err = gv::launch<GemvLut<true>, KS>(pb, args, q, cluster, st);
    } else {
      const GemvLut<false>::Args args{static_cast<const float*>(s),
                                      static_cast<const __nv_bfloat16*>(lut), n_luts, gpl};
      err = gv::launch<GemvLut<false>, KS>(pb, args, q, cluster, st);
    }
    return cudaSuccess;
  });
  return err;
}
