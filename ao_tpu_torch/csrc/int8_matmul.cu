// Int8 weight-only matmul with a per-column scale, for Hopper (sm_90a): K10.
//
// Replaces the TPU kernel ao_tpu/ops/pallas/int8_matmul.py::_kernel
// (launched by _int8_wo_matmul_impl, public entry int8_wo_matmul_pallas):
//
//   y[m, n] = bf16( s[n] * sum_k x[m, k] * q[k, n] ),
//
// x bf16 (M, K), q int8 (K, N) symmetric per output column, s f32; every
// product is exact (bf16 x int8 -> bf16 exactly, f32 sums on the tensor
// cores), and the scale commutes out of the sum into the epilogue, as in the
// TPU kernel.
//
// Layout: the weight is stored column-major (Int8Array keeps qdata so), i.e.
// as wt (N, K) row-major: each column's K values are contiguous, the
// K-major operand of both kernels' tensor-core instructions.
//
// int8 -> bf16: w ^ 0x80 in the low byte of the f32 2^23 (one byte_perm)
// is 2^23 + 128 + v exactly; subtracting 2^23 + 128 leaves v, and one
// cvt.rn.bf16x2.f32 packs two of them exactly.
//
// What bounds it on the H100, and the two kernels:
//  * decode (M <= 16, int8_wo_gemv_kernel): the weight stream, 1 B per
//    weight, against 3.35 TB/s. The weights are the A operand (16 columns of
//    N as the rows of an m16 tile) and x^T the B operand (batch rows as the
//    columns of an n8 tile), so at M = 8 no half of an m16 tile is spent on
//    rows of x that do not exist. A warp owns 32 columns; per 128-wide K
//    unit each thread issues its eight 16-byte weight loads before it uses
//    any (4 KB a warp in flight). The grid splits K by whole units (grid.z)
//    into f32 partials that stay in the 50 MB L2, and a second pass sums
//    them, scales and rounds, so that wk/wv (N = 1024, 8 blocks of 128
//    columns) fill 132 SMs. K order inside a 64-wide window: a thread loads
//    16 consecutive K values (16 bytes of int8, or 32 bytes of bf16 x) at
//    offset 16*tig, and uses them in four k16 steps j, taking the four
//    values 16*tig + 4j .. + 3 as the fragment's logical columns 2*tig,
//    2*tig + 1, 2*tig + 8, 2*tig + 9 (one permutation of K applied to both
//    operands leaves a dot product unchanged).
//  * prefill (M > 16): tensor-core operations, 2 M K N against 989 TFLOP/s,
//    on the shared wgmma mainloop (mixed_gemm.cuh, Int8Op below): a ring of
//    cp.async slots holding each 64-K stage's x tile (wgmma's B operand) and
//    the stage's BN x 64 weight bytes; each thread decodes, once per CTA,
//    the bytes of its wgmma A-fragment registers (three integer, two float
//    and one conversion instruction a bf16x2). x is read in plain K order,
//    so each thread's x offsets are computed once, before the K loop
//    (kXInOrder). The tiles (BM, BN) and a split of K come from
//    int8_matmul.pick_tiles (K14's mainloop tiles). The scale
//    is the Op's finish, which the mainloop gives the output column; a K
//    split writes unscaled f32 partials and the second pass scales their
//    sum. What bounds it: instruction dispatch beside the tensor cores, about
//    240 instructions a warp a stage at (256, 128), the decode half of
//    them, against the tensor cores' 983 cycles: on the H100 the loop
//    without its decode took 20 % less time and without its x copies none
//    less; the x offsets' hoisting then took 15 % off, and dropping the x
//    rows' predicates 3 % (PERF.md).
//    The first version (mma.sync, each warp converting its own weight
//    fragments from device memory, x through a two-slot cp.async buffer)
//    took 3.7-4.4x cuBLAS's time at M = 1024 (PERF.md).

#include "mixed_gemm.cuh"

namespace {

constexpr int kUnit = 128;  // K values per split unit of the decode kernel (the wrapper's unit)

using mg::pack_bf16x2;


__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bytes 2*half and 2*half + 1 of w (signed int8) as bf16x2, exactly
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t w, int half) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + 2 * half));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541u + 2 * half));
  return pack_bf16x2(f0 - 8388736.f, f1 - 8388736.f);
}

__device__ __forceinline__ int4 ld_16(const void* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ uint32_t word(const int4& v, int j) {
  return j == 0 ? (uint32_t)v.x : j == 1 ? (uint32_t)v.y : j == 2 ? (uint32_t)v.z : (uint32_t)v.w;
}

// Decode kernel (M <= 16, NT = ceil(M/8) n8 tiles of batch rows). grid
// (N/128, 1, splits), 128 threads; warp w owns columns nb = (4*blockIdx.x +
// w)*32 .. + 31 in two m16 tiles: tile p holds columns nb + 16p + gid (rows
// 0..7 of the tile) and nb + 16p + gid + 8 (rows 8..15). Split z covers K
// units [z*ups, (z+1)*ups).
template <int NT>
__global__ void __launch_bounds__(128)
    int8_wo_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wt,
                        const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                        float* __restrict__ ws, int M, int K, int N, int ups) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = (blockIdx.x * 4 + warp) * 32;
  const int units = K / kUnit;
  const int u_end = min((int)(blockIdx.z + 1) * ups, units);

  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;

  for (int u = blockIdx.z * ups; u < u_end; ++u) {
    const int k0 = u * kUnit + 16 * tig;
    int4 w[2][2][2];  // [tile p][row r: gid, gid + 8][window h]
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          w[p][r][h] = ld_16(wt + (size_t)(nb + 16 * p + gid + 8 * r) * K + k0 + 64 * h);
    int4 xv[NT][2][2];  // [nt][window h][16-byte half c]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = gid + 8 * nt;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          xv[nt][h][c] = r < M ? ld_16(x + (size_t)r * K + k0 + 64 * h + 8 * c)
                               : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t w0 = word(w[p][0][h], j), w1 = word(w[p][1][h], j);
          const uint32_t a[4] = {i8x2_bf16x2(w0, 0), i8x2_bf16x2(w1, 0), i8x2_bf16x2(w0, 1),
                                 i8x2_bf16x2(w1, 1)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int4& xc = xv[nt][h][j >> 1];
            const uint32_t b0 = (j & 1) ? (uint32_t)xc.z : (uint32_t)xc.x;
            const uint32_t b1 = (j & 1) ? (uint32_t)xc.w : (uint32_t)xc.y;
            mma_16816(acc[p][nt], a, b0, b1);
          }
        }
      }
  }

  // C fragment e of tile p: column nb + 16p + gid + 8*(e >> 1), batch row
  // 8nt + 2*tig + (e & 1)
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = nb + 16 * p + gid + 8 * (e >> 1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = 8 * nt + 2 * tig + (e & 1);
        if (r >= M) continue;
        const size_t off = (size_t)r * N + n;
        if (ws == nullptr)
          out[off] = __float2bfloat16(acc[p][nt][e] * s[n]);
        else
          ws[(size_t)blockIdx.z * M * N + off] = acc[p][nt][e];
      }
    }
}

// K10's decode for the shared mainloop. Stage s is K values 64 s .. 64 s +
// 63 in plain order (kXInOrder: x chunk c is columns 64 s + 8 c .., each
// thread's x offsets computed once, before the K loop). Its slot holds the
// weight's bytes [BN][kRawRow]: row n0 + r of wt, the stage's 64 bytes,
// padded to 80 so that the eight rows a warp reads at once fall in
// different banks. Step kk's fragment takes, of rows cl (a0, a2) and cl + 8
// (a1, a3), the K pairs 16 kk + 2 tig, + 1 (a0, a1) and 16 kk + 8 + 2 tig,
// + 1 (a2, a3): half tig & 1 of words 4 kk + tig / 2 and 4 kk + 2 + tig / 2
// of the row. Threads tig and tig ^ 1 read the same whole 32-bit word (one
// broadcast) and decode one half each. No permutation of K inside a stage
// can give a thread all four bytes of a word: x is staged by 16-byte
// chunks, which keep 8 consecutive K values in their order, and a thread's
// K pairs sit at the same offset 2 tig of eight different 8-value chunks.
struct Int8Op {
  struct Args {
    const int8_t* wt;
    const float* s;
  };
  static constexpr int kRawRow = 80;
  static constexpr bool kXInOrder = true;

  template <int BN>
  __host__ __device__ static constexpr int raw_bytes() {
    return BN * kRawRow;
  }

  template <int BN, int NT>
  __device__ static void load_raw(const Args& a, const mg::Problem& pb, uint8_t* raw, int s,
                                  int n0, int tid) {
    mg::for_chunks<BN * 4, NT>(tid, [&](int e) {
      const int r = e >> 2, cc = e & 3;
      mg::cp_async16(raw + r * kRawRow + 16 * cc,
                     a.wt + (size_t)(n0 + r) * pb.K + mg::kBK * s + 16 * cc, true);
    });
  }

  template <int BN>
  __device__ static void decode_a(const Args&, const uint8_t* raw, int, int cl, int lane,
                                  uint32_t (&a)[4][4]) {
    const int tig = lane & 3, half = tig & 1;
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(raw + cl * kRawRow) + (tig >> 1);
    const uint32_t* r1 = r0 + 8 * kRawRow / 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = i8x2_bf16x2(r0[4 * kk], half);
      a[kk][1] = i8x2_bf16x2(r1[4 * kk], half);
      a[kk][2] = i8x2_bf16x2(r0[4 * kk + 2], half);
      a[kk][3] = i8x2_bf16x2(r1[4 * kk + 2], half);
    }
  }

  // the per-column scale, in f32 before the bf16 rounding
  __device__ static float finish(const Args& a, int n, float acc) { return acc * __ldg(a.s + n); }
};

// Second pass of a split-K launch: out = bf16(s[n] * sum over splits of ws).
__global__ void int8_wo_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ s,
                                      __nv_bfloat16* __restrict__ out, int N, size_t mn,
                                      int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * mn + i];
  out[i] = __float2bfloat16(acc * s[i % N]);
}

}  // namespace

// x (M, K) bf16; wt (N, K) int8 (the column-major (K, N) weight); s (N) f32;
// out (M, N) bf16. Tiles from int8_matmul.pick_tiles: bm 16 the decode
// kernel (M <= 16, bn 128, per 128-wide K units a split), else the
// mainloop's (bm, bn) with per stages of 64 K a split; ws (splits, M, N) f32
// when splits > 1. Needs K % 128 == 0, N % 128 == 0 and 16-byte aligned
// rows; the Python wrapper checks them. Returns cudaGetLastError() after
// the launches.
extern "C" int ao_int8_wo(const void* x_, const void* wt_, const void* s_, void* out_, void* ws_,
                          int M, int K, int N, int bm, int bn, int splits, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  const auto* wt = static_cast<const int8_t*>(wt_);
  const auto* s = static_cast<const float*>(s_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  if (K % kUnit || N % 128 || M < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bm == 16) {  // the decode kernel, per = units per split
    if (M > 16 || bn != 128) return (int)cudaErrorInvalidValue;
    dim3 grid(N / 128, 1, splits);
    if (M <= 8)
      int8_wo_gemv_kernel<1><<<grid, 128, 0, st>>>(x, wt, s, out, ws, M, K, N, per);
    else
      int8_wo_gemv_kernel<2><<<grid, 128, 0, st>>>(x, wt, s, out, ws, M, K, N, per);
    err = cudaGetLastError();
  } else {  // the mainloop, per = stages of 64 K values per split
    if ((size_t)M * K >= (1ull << 32)) return (int)cudaErrorInvalidValue;  // 32-bit x offsets
    const mg::Problem pb{x, out, ws, M, K, N, per, K / mg::kBK};
    err = mg::launch<Int8Op>(pb, {wt, s}, bm, bn, splits, st);
  }
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  const size_t mn = (size_t)M * N;
  int8_wo_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, s, out, N, mn, splits);
  return (int)cudaGetLastError();
}
