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
// one register of an mma.sync m16n8k16 fragment. K1's addressing is reused
// as it is.
//
// Decoding: the tables are copied as f32 into shared memory when the block
// starts and indexed by nibble; a warp reads one table (the group is uniform)
// whose 16 entries lie in 16 banks, so no read conflicts. The value is the
// bf16 entry exactly. (The TPU kernel builds the values with an XOR select
// tree for its vector unit; the bf16 entries it selects are the same.)
// Scalers are applied in f32 after each group's products, as K1 applies its
// group scales: tmp = x_G . lut[u_G] on the tensor cores, acc += s * tmp
// (four k16 steps per group at NF4's g = 64).
//
// What bounds it on the H100, and the two kernels (K1's):
//  * decode (M <= 16, lut4_gemv_kernel): the weight stream, 0.5 B per weight
//    plus 4 B of scaler per g weights, against 3.35 TB/s. The weights are the
//    A operand, each warp owns 32 columns, each thread issues all its word
//    loads of a super-group and its scalers before it uses any, and the grid
//    splits K by whole super-groups (grid.z) into f32 partials summed by a
//    second pass, so that N = 1024 fills 132 SMs.
//  * prefill (M > 16, lut4_gemm_kernel): tensor-core operations. A block
//    computes 64 rows x 128 columns, each warp 64 x 32; the x tile of a group
//    is staged in shared memory by cp.async, the next group's while the
//    current one is used, and read by ldmatrix; every decoded B fragment
//    feeds four mma.sync. No wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLuts = 256;  // (L, 16) tables held in shared memory, 16 KB as f32

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

// 16 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The A fragment of an m16 x k16 bf16 tile: lane l gives the address of row
// (l & 15), columns 8*(l >> 4) .. + 7.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* smem) {
  const unsigned p = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(p));
}

// Prefill kernel (M > 16, g = 16*KS): K1's. grid (ceil(N/128), ceil(M/64)),
// 128 threads. Warp w owns columns nb = (4*blockIdx.x + w)*32 .. + 31 of rows
// m0 .. m0 + 63; its 16-byte word load covers columns nb + 4*gid .. + 3,
// element i being column gid of n8 tile i. Dynamic shared memory: the tables
// (n_luts x 16 f32), then two x tiles of 64 x (g + 8) bf16.
template <int KS>
__global__ void __launch_bounds__(128)
    lut4_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ word,
                     const float* __restrict__ s, const __nv_bfloat16* __restrict__ lut,
                     __nv_bfloat16* __restrict__ out, int M, int K, int N, int n_luts, int gpl) {
  constexpr int G = 16 * KS, LD = G + 8, MT = 4;
  extern __shared__ __align__(16) float luts[];
  __nv_bfloat16* xtile = reinterpret_cast<__nv_bfloat16*>(luts + 16 * n_luts);  // [2][64][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = (blockIdx.x * 4 + warp) * 32;
  const bool active = nb < N;  // idle warps still load tiles and meet the barriers
  const int m0 = blockIdx.y * 64;
  const int ngroups = K / G;

  auto load_tile = [&](int buf, int grp) {
    for (int c = threadIdx.x; c < 64 * (G / 8); c += 128) {
      const int r = c / (G / 8), cc = c % (G / 8);
      const bool valid = m0 + r < M;
      const __nv_bfloat16* src = valid ? x + (size_t)(m0 + r) * K + grp * G + cc * 8 : x;
      cp_async16(xtile + (buf * 64 + r) * LD + cc * 8, src, valid);
    }
    cp_async_commit();
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;

  load_tile(0, 0);
  load_luts(luts, lut, n_luts);
  for (int grp = 0; grp < ngroups; ++grp) {
    if (grp + 1 < ngroups) {
      load_tile((grp + 1) & 1, grp + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int t = grp >> 2, j = grp & 3;
      const float* tab = lut_of(luts, grp, gpl);
      const __nv_bfloat16* tile = xtile + (grp & 1) * 64 * LD;
      const float* srow = s + (size_t)grp * N + nb + 8 * tig;
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(srow));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(srow + 4));
      const int32_t* wbase = word + (size_t)t * (G / 2) * N + nb + 4 * gid;
      float tmp[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) tmp[mt][i][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int4 w0 = ld_16(wbase + (size_t)(8 * ks + tig) * N);
        const int4 w1 = ld_16(wbase + (size_t)(8 * ks + 4 + tig) * N);
        const uint32_t b0[4] = {plane_lut(w0.x, j, tab), plane_lut(w0.y, j, tab),
                                plane_lut(w0.z, j, tab), plane_lut(w0.w, j, tab)};
        const uint32_t b1[4] = {plane_lut(w1.x, j, tab), plane_lut(w1.y, j, tab),
                                plane_lut(w1.z, j, tab), plane_lut(w1.w, j, tab)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, tile + (mt * 16 + (lane & 15)) * LD + ks * 16 + 8 * (lane >> 4));
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_16816(tmp[mt][i], a, b0[i], b1[i]);
        }
      }
      // fold the group: C fragment of n8 tile i holds columns nb + 8*tig + i
      // (c0, c2) and nb + 8*tig + 4 + i (c1, c3)
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[mt][i][0] = fmaf(sc[i], tmp[mt][i][0], acc[mt][i][0]);
          acc[mt][i][1] = fmaf(sc[4 + i], tmp[mt][i][1], acc[mt][i][1]);
          acc[mt][i][2] = fmaf(sc[i], tmp[mt][i][2], acc[mt][i][2]);
          acc[mt][i][3] = fmaf(sc[4 + i], tmp[mt][i][3], acc[mt][i][3]);
        }
    }
    __syncthreads();  // the next iteration's load overwrites this tile
  }
  if (!active) return;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + mt * 16 + gid + 8 * half;
      if (r >= M) continue;
      float v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = acc[mt][i][2 * half];
        v[4 + i] = acc[mt][i][2 * half + 1];
      }
      int4 o;
      o.x = (int)pack_bf16x2(v[0], v[1]);
      o.y = (int)pack_bf16x2(v[2], v[3]);
      o.z = (int)pack_bf16x2(v[4], v[5]);
      o.w = (int)pack_bf16x2(v[6], v[7]);
      *reinterpret_cast<int4*>(out + (size_t)r * N + nb + 8 * tig) = o;
    }
}

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
                   int n_luts, int gpl, int splits, int sps, cudaStream_t st) {
  const size_t lut_bytes = (size_t)16 * n_luts * sizeof(float);
  if (M <= 16) {
    dim3 grid((N + 127) / 128, 1, splits);
    if (M <= 8)
      lut4_gemv_kernel<KS, 1><<<grid, 128, lut_bytes, st>>>(x, word, s, lut, out, ws, M, K, N,
                                                            n_luts, gpl, sps);
    else
      lut4_gemv_kernel<KS, 2><<<grid, 128, lut_bytes, st>>>(x, word, s, lut, out, ws, M, K, N,
                                                            n_luts, gpl, sps);
    return cudaGetLastError();
  }
  // tables + two x tiles: at most 16 KB + 34 KB
  const size_t smem = lut_bytes + 2 * 64 * (16 * KS + 8) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(lut4_gemm_kernel<KS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((N + 127) / 128, (M + 63) / 64);
  lut4_gemm_kernel<KS><<<grid, 128, smem, st>>>(x, word, s, lut, out, M, K, N, n_luts, gpl);
  return cudaGetLastError();
}

}  // namespace

// The most (L, 16) tables the kernel holds; the wrapper checks it at load.
extern "C" int ao_lut4_max_luts() { return kMaxLuts; }

// x (M, K) bf16; word (K/8, N) int32 (magic layout over the code nibbles,
// group G); s (K/G, N) f32; lut (n_luts, 16) bf16 with gpl groups per table
// (gpl == 0: n_luts == 1, shared); out (M, N) bf16; ws (splits, M, N) f32
// when splits > 1 (decode only). Needs G in {16, 32, 64, 128}, N % 32 == 0,
// K % (4G) == 0, 1 <= n_luts <= 256 and 16-byte aligned rows; the Python
// wrapper checks them. Returns cudaGetLastError() after the launches.
extern "C" int ao_lut4_wo(const void* x_, const void* word_, const void* s_, const void* lut_,
                          void* out_, void* ws_, int M, int K, int N, int G, int n_luts, int gpl,
                          int splits, int sps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* s = static_cast<const float*>(s_);
  const auto* lut = static_cast<const __nv_bfloat16*>(lut_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  if (n_luts < 1 || n_luts > kMaxLuts || M < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (G) {
    case 16: err = launch<1>(x, word, s, lut, out, ws, M, K, N, n_luts, gpl, splits, sps, st); break;
    case 32: err = launch<2>(x, word, s, lut, out, ws, M, K, N, n_luts, gpl, splits, sps, st); break;
    case 64: err = launch<4>(x, word, s, lut, out, ws, M, K, N, n_luts, gpl, splits, sps, st); break;
    case 128: err = launch<8>(x, word, s, lut, out, ws, M, K, N, n_luts, gpl, splits, sps, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  const size_t mn = (size_t)M * N;
  lut4_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, out, mn, splits);
  return (int)cudaGetLastError();
}
