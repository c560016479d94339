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
// What bounds it on the H100, and the two kernels (K1's):
//  * decode (M <= 16, lut4_gemv_kernel): the weight stream, 0.5 B per weight
//    plus 4 B of scaler per g weights, against 3.35 TB/s. The tables are
//    copied as f32 into shared memory when the block starts (a warp reads
//    one table, whose 16 entries lie in 16 banks). The weights are the A
//    operand, each warp owns 32 columns, each thread issues all its word
//    loads of a super-group and its scalers before it uses any, and the grid
//    splits K by whole super-groups (grid.z) into f32 partials summed by a
//    second pass, so that N = 1024 fills 132 SMs.
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

#include "magic_op.cuh"

namespace {

constexpr int kMaxLuts = 256;  // (L, 16) tables the decode kernel holds in shared memory, as f32

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld_x2(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ int4 ld_16(const void* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// Plane j of a magic word through a table, as bf16x2 (row 2r' low, 2r' + 1
// high): the entries are bf16 values, so the pack is exact.
__device__ __forceinline__ uint32_t plane_lut(uint32_t w, int j, const float* lut) {
  const uint32_t t = w >> (4 * j);
  return pack_bf16x2(lut[t & 15u], lut[(t >> 16) & 15u]);
}

// The tables as f32 into shared memory (n_luts * 16 entries).
__device__ __forceinline__ void load_luts(float* dst, const __nv_bfloat16* lut, int n_luts) {
  for (int i = threadIdx.x; i < 16 * n_luts; i += blockDim.x) dst[i] = __bfloat162float(lut[i]);
  __syncthreads();
}

// the table of group grp (gpl == 0: one shared table)
__device__ __forceinline__ const float* lut_of(const float* luts, int grp, int gpl) {
  return gpl == 0 ? luts : luts + 16 * (grp / gpl);
}

// Decode kernel (M <= 16, g = 16*KS, NT = ceil(M/8)): K1's. The warp owns 32
// columns, col = nb + 4*gid .. + 3, in two m16 tiles: tile p holds in its rows
// 0..7 the column col + 2p and in rows 8..15 the column col + 2p + 1. grid
// (ceil(N/128), 1, splits), 128 threads; split z covers super-groups
// [z*sps, (z+1)*sps).
template <int KS, int NT>
__global__ void __launch_bounds__(128)
    lut4_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ word,
                     const float* __restrict__ s, const __nv_bfloat16* __restrict__ lut,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M, int K, int N,
                     int n_luts, int gpl, int sps) {
  constexpr int G = 16 * KS;
  extern __shared__ __align__(16) float luts[];
  load_luts(luts, lut, n_luts);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = (blockIdx.x * 4 + warp) * 32;
  if (nb >= N) return;  // warp-uniform, after the block's only barrier
  const int nsuper = K / (4 * G);
  const int t_end = min((int)(blockIdx.z + 1) * sps, nsuper);
  const int col = nb + 4 * gid;

  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;

  for (int t = blockIdx.z * sps; t < t_end; ++t) {
    const int32_t* wbase = word + (size_t)t * (G / 2) * N + col;
    int4 w[2 * KS];
    float4 sv[4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      w[2 * ks] = ld_16(wbase + (size_t)(8 * ks + tig) * N);
      w[2 * ks + 1] = ld_16(wbase + (size_t)(8 * ks + 4 + tig) * N);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sv[j] = __ldg(reinterpret_cast<const float4*>(s + (size_t)(4 * t + j) * N + col));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* tab = lut_of(luts, 4 * t + j, gpl);
      float tmp[2][NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[0][nt][e] = tmp[1][nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int k0 = (4 * t + j) * G + 16 * ks + 2 * tig;
        uint32_t b[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int r = gid + 8 * nt;
          b[nt][0] = r < M ? ld_x2(x + (size_t)r * K + k0) : 0u;
          b[nt][1] = r < M ? ld_x2(x + (size_t)r * K + k0 + 8) : 0u;
        }
        const int4& w0 = w[2 * ks];
        const int4& w1 = w[2 * ks + 1];
        const uint32_t a0[4] = {plane_lut(w0.x, j, tab), plane_lut(w0.y, j, tab),
                                plane_lut(w1.x, j, tab), plane_lut(w1.y, j, tab)};
        const uint32_t a1[4] = {plane_lut(w0.z, j, tab), plane_lut(w0.w, j, tab),
                                plane_lut(w1.z, j, tab), plane_lut(w1.w, j, tab)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_16816(tmp[0][nt], a0, b[nt][0], b[nt][1]);
          mma_16816(tmp[1][nt], a1, b[nt][0], b[nt][1]);
        }
      }
      // fold the group: C fragment e of tile p is column col + 2p + (e >> 1)
      const float sc[4] = {sv[j].x, sv[j].y, sv[j].z, sv[j].w};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[p][nt][e] = fmaf(sc[2 * p + (e >> 1)], tmp[p][nt][e], acc[p][nt][e]);
    }
  }

  // the thread's outputs: batch rows 2*tig + h (+ 8nt), columns col .. col + 3
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * tig + h + 8 * nt;
      if (r >= M) continue;
      const float v[4] = {acc[0][nt][h], acc[0][nt][2 + h], acc[1][nt][h], acc[1][nt][2 + h]};
      const size_t off = (size_t)r * N + col;
      if (ws == nullptr) {
        *reinterpret_cast<uint2*>(out + off) = make_uint2(pack_bf16x2(v[0], v[1]),
                                                          pack_bf16x2(v[2], v[3]));
      } else {
        *reinterpret_cast<float4*>(ws + (size_t)blockIdx.z * M * N + off) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
}

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

// Second pass of a split-K launch: out = bf16(sum over splits of ws).
__global__ void lut4_reduce_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                                   size_t mn, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * mn + i];
  out[i] = __float2bfloat16(acc);
}

template <int KS>
cudaError_t launch(const __nv_bfloat16* x, const int32_t* word, const float* s,
                   const __nv_bfloat16* lut, __nv_bfloat16* out, float* ws, int M, int K, int N,
                   int n_luts, int gpl, int bm, int bn, int splits, int per, cudaStream_t st) {
  if (bm == 16) {  // the decode kernel, per = super-groups a split
    if (M > 16) return cudaErrorInvalidValue;
    const size_t lut_bytes = (size_t)16 * n_luts * sizeof(float);
    dim3 grid((N + 127) / 128, 1, splits);
    if (M <= 8)
      lut4_gemv_kernel<KS, 1><<<grid, 128, lut_bytes, st>>>(x, word, s, lut, out, ws, M, K, N,
                                                            n_luts, gpl, per);
    else
      lut4_gemv_kernel<KS, 2><<<grid, 128, lut_bytes, st>>>(x, word, s, lut, out, ws, M, K, N,
                                                            n_luts, gpl, per);
    return cudaGetLastError();
  }
  // the mainloop, per = stages of 64 K a split
  const mg::Problem pb{x, out, ws, M, K, N, per, K / mg::kBK};
  return mg::launch<mg::MagicOp<PlaneLut, 16 * KS>>(pb, {word, {s, lut, gpl}}, bm, bn, splits, st);
}

}  // namespace

// The most (L, 16) tables the kernel holds; the wrapper checks it at load.
extern "C" int ao_lut4_max_luts() { return kMaxLuts; }

// x (M, K) bf16; word (K/8, N) int32 (magic layout over the code nibbles,
// group G); s (K/G, N) f32; lut (n_luts, 16) bf16 with gpl groups per table
// (gpl == 0: n_luts == 1, shared); out (M, N) bf16; ws (splits, M, N) f32
// when splits > 1. Tiles from lut4_matmul.launch_tiles: bm 16 the decode
// kernel (M <= 16, per super-groups a split), else the mainloop's (bm, bn)
// with per stages of 64 K a split (whole units of 8 stages when split).
// Needs G in {16, 32, 64, 128}, N % 32 == 0, K % (4G) == 0, 1 <= n_luts <=
// 256 and 16-byte aligned rows; the Python wrapper checks them. Returns
// cudaGetLastError() after the launches.
extern "C" int ao_lut4_wo(const void* x_, const void* word_, const void* s_, const void* lut_,
                          void* out_, void* ws_, int M, int K, int N, int G, int n_luts, int gpl,
                          int bm, int bn, int splits, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* s = static_cast<const float*>(s_);
  const auto* lut = static_cast<const __nv_bfloat16*>(lut_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  if (n_luts < 1 || n_luts > kMaxLuts || M < 1 || N % 32 || K % (4 * G))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto ks) {
    return launch<decltype(ks)::value>(x, word, s, lut, out, ws, M, K, N, n_luts, gpl, bm, bn,
                                       splits, per, st);
  };
  cudaError_t err;
  switch (G) {
    case 16: err = run(std::integral_constant<int, 1>()); break;
    case 32: err = run(std::integral_constant<int, 2>()); break;
    case 64: err = run(std::integral_constant<int, 4>()); break;
    case 128: err = run(std::integral_constant<int, 8>()); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  const size_t mn = (size_t)M * N;
  lut4_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, out, mn, splits);
  return (int)cudaGetLastError();
}
