// Int4 weight-only matmuls for Hopper (sm_90a): K1 over the "magic" int32
// layout (below, first) and K11 over the uint8 split-half layout (at the end
// of the file, with its own note).
//
// K1 replaces the TPU kernel ao_tpu/ops/pallas/int4_matmul.py::_magic_kernel
// (launched by _int4_wo_magic_impl, public entry int4_wo_magic_pallas).
//
//   y[m, n] = sum_k x[m, k] * (q[k, n] * s[G, n] + b2[G, n]),  G = k / g,
//
// q = u - 8 in [-8, 7], the nibble u from the magic words; f32 sums, bf16 out.
//
// (With b2 = b + 8s, q*s + b2 = u*s + b: the tinygemm float zero point, or
// -(8 + zp)*s for an int zero point. The wrapper sends s and b2 in bf16, as
// the reference wrapper does; for bf16 tinygemm qparams it sends the scale
// and zero point as they are, and the kernel forms b2 = bf16(zp + 8s) itself,
// with the reference's roundings, so no host-side pass runs per call.)
//
// Layout (ao_tpu_torch/quantization/qarrays/int4.py): word row (g/2)t + r'
// holds, at bits 4j + 16h, logical row (4t + j)g + 2r' + h, so plane j of
// super-group t is group 4t + j. ((w >> 4j) & 0x000F000F) | 0x43004300 read
// as bf16x2 is exactly (128 + u) for rows 2r' and 2r' + 1 of that group, and
// one bf16x2 subtract of 136 makes it q = u - 8, exact (plane_q). A pair of
// consecutive K rows of one column is what one register of an A fragment
// holds along K, so a word feeds the tensor cores with no shuffles and
// three integer / bf16x2 ops per two weights.
//
// Group scales are applied in f32 after each group's products, as the TPU
// kernel does: tmp = x_G . q_G on the tensor cores (exact bf16 x small-int
// products, f32 sums), then acc += s * tmp and acc += xsum_G * b2 with the
// row sums of x over the group, in f32. No weight is rounded to bf16(q*s +
// b2): the TPU kernel never makes that rounding.
//
// What bounds it on the H100, and the two kernels:
//  * decode (M <= 16, int4_wo_magic_gemv_kernel): the weight stream, 0.5 B
//    per weight plus 4 B of s and b2 per g weights, against 3.35 TB/s. The
//    card hides the latency of device memory only with enough bytes in
//    flight, and the grid must fill 132 SMs: each warp owns 32 columns, so
//    wk/wv (N = 1024) give only 8 blocks of 4 warps. The kernel splits K as
//    well (grid.z) into runs of word rows, whole super-groups of 4g rows or,
//    where those leave the card short of blocks, runs of 16 word rows with
//    all four planes (each run folds its part of a group), writes f32
//    partials that stay in the 50 MB L2, and a second pass sums them into
//    bf16. Each thread issues all its word loads of a run and the group
//    scales before it uses any, then decodes the four planes from registers.
//    The weights are the A operand of mma.sync (int4_tiles.cuh), so at M = 8
//    no half of an m16 tile is spent on rows of x that do not exist.
//  * prefill (M > 16): tensor-core operations, 2 M K N against 989 TFLOP/s,
//    on the shared wgmma mainloop (mixed_gemm.cuh) with MagicOp
//    (magic_op.cuh) and PlaneQ below: each thread decodes its own A
//    fragments with plane_q from a unit buffer of 64 word rows loaded once
//    per CTA, the group's steps run into tmp, and the fold adds s * tmp and
//    xsum * b2 to acc (two FMAs per accumulator a group). A pre-pass
//    (magic_xsum_kernel) writes the row sums of x per group, (K/g, M) f32,
//    which each stage's slot takes beside the group's s and b2 rows. The
//    tiles (BM, BN) and a split of K in whole units come from
//    int4_matmul.pick_tiles (the tile cache first). A fold needs a second
//    accumulator set and empties the tensor-core queue once a group, which
//    bounds the tiles to 128 x 128 at one CTA an SM (PERF.md).

#include "int4_tiles.cuh"
#include "magic_op.cuh"

namespace {

// Decode kernel (M <= 16, g = 16*KS, NT = ceil(M/8), runs of KR k16 steps):
// the swapped operands and the warp's 32 columns of int4_tiles.cuh. grid
// (ceil(N/128), 1, splits), 128 threads; split z covers runs [z*rps,
// (z+1)*rps).
template <int KS, int KR, int NT>
__global__ void __launch_bounds__(128)
    int4_wo_magic_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ word,
                              const __nv_bfloat16* __restrict__ s,
                              const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                              float* __restrict__ ws, int M, int K, int N, int rps, int raw_zp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = (blockIdx.x * 4 + warp) * 32;
  if (nb >= N) return;  // warp-uniform: the shuffles see full warps
  const int runs = K / (4 * 16 * KS) * (KS / KR);
  const int r_end = min((int)(blockIdx.z + 1) * rps, runs);
  const int col = nb + 4 * gid;

  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;
  magic_gemv_accumulate<KS, NT, KR>(acc, x, M, K, N, word, s, b2, blockIdx.z * rps, r_end, col,
                                    raw_zp);

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

// The prefill pre-pass: xs[G'][m] = the f32 sum of x[m, :] over group G'
// (g = 16*KS), for m < mp (zeros from M on). A warp takes 256 values of a
// row (blockIdx.y: which 256); each lane sums 8, and the g / 8 lanes of a
// group combine by shuffles. grid (ceil(mp / 4), ceil(K / 256)), 128 threads.
template <int KS>
__global__ void __launch_bounds__(128)
    magic_xsum_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ xs, int M, int mp,
                      int K) {
  constexpr int G = 16 * KS, LG = G / 8;
  const int m = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int k = blockIdx.y * 256 + 8 * lane;
  if (m >= mp) return;  // warp-uniform
  float v = 0.f;
  if (m < M && k < K) {
    const int4 c = ld_16(x + (size_t)m * K + k);
    const uint32_t u[4] = {(uint32_t)c.x, (uint32_t)c.y, (uint32_t)c.z, (uint32_t)c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) v += pair_sum(u[i]);
  }
#pragma unroll
  for (int o = 1; o < LG; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane % LG == 0 && k < K) xs[(size_t)(k / G) * mp + m] = v;
}

// K1's decode for MagicOp: plane_q, and the fold acc += s * tmp + xsum * b2
// per group. A group's bytes in the slot: its s and b2 rows, [2][BN] bf16,
// then the x sums of the tile's rows, [kMagicMaxBM] f32.
struct PlaneQ {
  struct Params {
    const __nv_bfloat16* s;
    const __nv_bfloat16* b2;
    const float* xs;  // (K/g, mp) f32 from magic_xsum_kernel
    int mp;
    int raw_zp;
  };

  template <int BN>
  __host__ __device__ static constexpr int group_bytes() {
    return 2 * BN * 2 + mg::kMagicMaxBM * 4;
  }

  // One 16-byte chunk of a group's bytes a thread (the first 2 BN / 8 + BM / 4
  // threads): its source at group 0, its stride a group, its place.
  template <int BM, int BN, int NT>
  struct Thread {
    static constexpr int QC = BN / 8;  // chunks of a bf16 row of BN
    static_assert(2 * QC + BM / 4 <= NT, "a chunk a thread");
    const uint8_t* src;
    int stride, dst;
    bool ok, active;

    __device__ Thread(const Params& p, const mg::Problem& pb, int m0, int n0, int tid) {
      active = tid < 2 * QC + BM / 4;
      if (tid < 2 * QC) {  // s, then b2
        const int col = n0 + 8 * (tid % QC);
        src = reinterpret_cast<const uint8_t*>((tid < QC ? p.s : p.b2) + col);
        stride = 2 * pb.N;
        dst = 2 * (tid / QC * BN + 8 * (tid % QC));
        ok = col < pb.N;
      } else {  // x sums of rows m0 + 4e ..
        const int e = tid - 2 * QC;
        src = reinterpret_cast<const uint8_t*>(p.xs + m0 + 4 * e);
        stride = 4 * p.mp;
        dst = 4 * BN + 16 * e;
        ok = m0 + 4 * e < p.mp;
      }
    }

    __device__ void load(const Params& p, const mg::Problem&, uint8_t* gb, int grp) const {
      if (active) mg::cp_async16(gb + dst, ok ? src + (size_t)grp * stride : src, ok);
    }
  };

  __device__ static uint32_t plane(const uint8_t*, uint32_t w, int j) { return plane_q(w, j); }

  // accumulator d[4i + 2h + e]: column cl + 8h, x row 8i + 2 tig + e
  template <int BM, int BN>
  __device__ static void fold(const Params& p, const uint8_t* gb, int cl, int lane,
                              const float (&tmp)[BM / 2], float (&acc)[BM / 2]) {
    const __nv_bfloat16* s = reinterpret_cast<const __nv_bfloat16*>(gb);
    const float* xs = reinterpret_cast<const float*>(gb + 4 * BN);
    float sc[2], bc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sc[h] = __bfloat162float(s[cl + 8 * h]);
      bc[h] = bias_of(sc[h], s[BN + cl + 8 * h], p.raw_zp);
    }
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const float2 xv = *reinterpret_cast<const float2*>(xs + 8 * i + 2 * (lane & 3));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& d0 = acc[4 * i + 2 * h];
        float& d1 = acc[4 * i + 2 * h + 1];
        d0 = fmaf(xv.x, bc[h], fmaf(sc[h], tmp[4 * i + 2 * h], d0));
        d1 = fmaf(xv.y, bc[h], fmaf(sc[h], tmp[4 * i + 2 * h + 1], d1));
      }
    }
  }
};

// Second pass of a split-K launch: out = bf16(sum over splits of ws).
__global__ void int4_wo_reduce_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                                      size_t mn, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * mn + i];
  out[i] = __float2bfloat16(acc);
}

template <int KS, int KR>
cudaError_t launch_gemv(const __nv_bfloat16* x, const int32_t* word, const __nv_bfloat16* s,
                        const __nv_bfloat16* b2, __nv_bfloat16* out, float* ws, int M, int K,
                        int N, int splits, int rps, int raw_zp, cudaStream_t st) {
  dim3 grid((N + 127) / 128, 1, splits);
  if (M <= 8)
    int4_wo_magic_gemv_kernel<KS, KR, 1><<<grid, 128, 0, st>>>(x, word, s, b2, out, ws, M, K, N,
                                                               rps, raw_zp);
  else
    int4_wo_magic_gemv_kernel<KS, KR, 2><<<grid, 128, 0, st>>>(x, word, s, b2, out, ws, M, K, N,
                                                               rps, raw_zp);
  return cudaGetLastError();
}

// run_rows: word rows a decode run, g/2 (a super-group) or 16 (two k16 steps)
template <int KS>
cudaError_t launch(const __nv_bfloat16* x, const int32_t* word, const __nv_bfloat16* s,
                   const __nv_bfloat16* b2, __nv_bfloat16* out, float* ws, float* xs, int M,
                   int K, int N, int bm, int bn, int splits, int per, int run_rows, int raw_zp,
                   cudaStream_t st) {
  if (bm == 16) {
    if (M > 16) return cudaErrorInvalidValue;
    if (run_rows == 8 * KS)
      return launch_gemv<KS, KS>(x, word, s, b2, out, ws, M, K, N, splits, per, raw_zp, st);
    if constexpr (KS > 2) {
      if (run_rows == 16)
        return launch_gemv<KS, 2>(x, word, s, b2, out, ws, M, K, N, splits, per, raw_zp, st);
    }
    return cudaErrorInvalidValue;
  }
  if (xs == nullptr) return cudaErrorInvalidValue;
  const int mp = (M + 3) / 4 * 4;
  magic_xsum_kernel<KS><<<dim3((mp + 3) / 4, (K + 255) / 256), 128, 0, st>>>(x, xs, M, mp, K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const mg::Problem pb{x, out, ws, M, K, N, per, K / mg::kBK};
  return mg::launch<mg::MagicOp<PlaneQ, 16 * KS>>(pb, {word, {s, b2, xs, mp, raw_zp}}, bm, bn,
                                                  splits, st);
}

}  // namespace

// x (M, K) bf16; word (K/8, N) int32; s, b2 (K/g, N) bf16 (with raw_zp != 0,
// b2 holds the tinygemm zero point and the kernel forms bf16(zp + 8s));
// out (M, N) bf16; ws (splits, M, N) f32 when splits > 1. Tiles from
// int4_matmul.launch_tiles: bm 16 the decode kernel (M <= 16; per runs of
// run_rows word rows a split, run_rows g/2 or 16), else the
// mainloop's (bm, bn) with per stages of 64 K a split (whole units of 8
// stages when split) and xs (K/g, ceil(M/4)*4) f32 scratch for the row sums
// of x. Needs g in {16, 32, 64, 128}, N % 32 == 0, K % (4g) == 0 and 16-byte
// aligned rows; the Python wrapper checks them. Returns cudaGetLastError()
// after the launches.
extern "C" int ao_int4_wo_magic(const void* x_, const void* word_, const void* s_, const void* b2_,
                                void* out_, void* ws_, void* xs_, int M, int K, int N, int G,
                                int bm, int bn, int splits, int per, int run_rows, int raw_zp,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* s = static_cast<const __nv_bfloat16*>(s_);
  const auto* b2 = static_cast<const __nv_bfloat16*>(b2_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  float* xs = static_cast<float*>(xs_);
  if (M < 1 || N % 32 || K % (4 * G)) return (int)cudaErrorInvalidValue;
  auto run = [&](auto ks) {
    return launch<decltype(ks)::value>(x, word, s, b2, out, ws, xs, M, K, N, bm, bn, splits, per,
                                       run_rows, raw_zp, st);
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
  int4_wo_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, out, mn, splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11: int4 weight-only matmul over the uint8 split-half layout.
//
// Replaces the TPU kernels ao_tpu/ops/pallas/int4_matmul.py::_kernel and
// _kernel_twoplane (launched by _int4_wo_matmul_impl, public entry
// int4_wo_matmul_pallas). W is uint8 (K/2, N): within each group of g rows,
// byte j holds row j in its low nibble and row j + g/2 in its high nibble.
// With u the nibble 0..15,
//
//   y[m, n] = sum_k x[m, k] * bf16(u[k, n] * s[G, n] + b[G, n]),  G = k / g,
//
// each weight dequantized in f32 (a multiply, then an add: two roundings, as
// the plain version) and rounded to bf16, as the TPU kernel does; bf16 x
// bf16 products on the tensor cores, f32 sums, bf16 out. s and b come in f32
// (the reference wrapper's normalization: b = zp for a float zero point,
// -(8 + zp) * s for an int one), or, for bf16 tinygemm qparams, as the bf16
// scale and zero point themselves, converted exactly in the kernel.
//
// What bounds it on the H100: at ViT-B's M = 788 the operations (2 M K N
// against 989 TFLOP/s, under a microsecond), so in practice the latency of
// its K / 64 stages, the f32 decode (a multiply, an add and a conversion per
// weight) and how many SMs have work; at small M the weight bytes. The first
// version (one shared buffer, synchronous loads and a decode between two
// barriers per 32 K values, mma.sync, 78 CTAs at N = 768) took 10x
// cuBLAS's time. It now runs on the shared wgmma mainloop (mixed_gemm.cuh,
// HalvesOp below): a stage is 32 byte rows of one group (two groups at g =
// 32), i.e. their low-nibble rows and the high-nibble rows g/2 further on,
// cp.async'd into the ring with the group's scale and zero point rows and
// the matching x columns; each thread decodes the bytes of its wgmma
// A-fragment registers, bf16(u*s + b) in f32, once per CTA; the tiles (BM,
// BN) and a split of K come from int4_matmul.pick_tiles_halves (the tuned
// tile cache first, then a heuristic measured on ViT-B's shapes).

namespace {

// Stage s is byte rows 32s .. 32s + 31, in runs of R = 32 (g/2 % 32 == 0) or
// 16 byte rows of one group each; run r's low-nibble rows are the stage's K
// values 2Rr .. 2Rr + R - 1, its high-nibble rows the next R. A ragged last
// stage (K/2 % 32 == 16) reads zeros past K/2. The slot holds the bytes
// [32][BN + 16] (rows padded by 16 bytes, so the byte rows a warp reads at
// once fall in different banks), then s and b of the groups of byte rows
// 32s and 32s + 16: [s, b][2][BN], f32 or (RAW) bf16.
template <int RAW>
struct HalvesOp {
  struct Args {
    const uint8_t* w;
    const void* s;
    const void* b;
    int G;
  };
  static constexpr int kQBytes = RAW ? 2 : 4;

  template <int BN>
  __host__ __device__ static constexpr int raw_bytes() {
    return 32 * (BN + 16) + 4 * BN * kQBytes;
  }

  __device__ static int run_shift(int gh) { return gh % 32 == 0 ? 5 : 4; }  // log2 R

  __device__ static int x_col(const Args& a, const mg::Problem& pb, int s, int c, bool& valid) {
    const int gh = a.G / 2, rs = run_shift(gh);
    const int run = c >> (rs - 2), cc = c & ((1 << (rs - 2)) - 1);  // R / 4 chunks a run
    const int p = 32 * s + (run << rs);
    valid = p < pb.K / 2;
    const int half = cc >> (rs - 3), off = 8 * (cc & ((1 << (rs - 3)) - 1));
    return (p / gh) * a.G + half * gh + p % gh + off;
  }

  template <int BN, int NT>
  __device__ static void load_raw(const Args& a, const mg::Problem& pb, uint8_t* raw, int s,
                                  int n0, int tid) {
    const int kp = pb.K / 2, gh = a.G / 2;
    constexpr int CH = BN / 16;  // 16-byte chunks of a byte row
    mg::for_chunks<32 * CH, NT>(tid, [&](int e) {
      const int r = e / CH, cc = e % CH;
      const int p = 32 * s + r;
      const bool valid = p < kp;
      mg::cp_async16(raw + r * (BN + 16) + 16 * cc,
                     valid ? a.w + (size_t)p * pb.N + n0 + 16 * cc : a.w, valid);
    });
    constexpr int QCH = BN * kQBytes / 16;  // 16-byte chunks of a qparam row
    uint8_t* q = raw + 32 * (BN + 16);
    mg::for_chunks<4 * QCH, NT>(tid, [&](int e) {
      const int which = e / (2 * QCH), h = (e / QCH) & 1, cc = e % QCH;
      const int p = 32 * s + 16 * h;
      const bool valid = p < kp;
      const uint8_t* src = static_cast<const uint8_t*>(which ? a.b : a.s);
      mg::cp_async16(q + (2 * which + h) * BN * kQBytes + 16 * cc,
                     valid ? src + ((size_t)(p / gh) * pb.N + n0) * kQBytes + 16 * cc : src,
                     valid);
    });
  }

  __device__ static float qparam(const uint8_t* q, int i) {
    if (RAW) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(q)[i]);
    return reinterpret_cast<const float*>(q)[i];
  }

  // u (0..15) -> bf16(u*s + b) with f32's two roundings; u as f32 through
  // the bits of 2^23 + u, exactly.
  __device__ static float dq(uint32_t u, float s, float b) {
    const float uf = __uint_as_float(0x4B000000u | u) - 8388608.f;
    return __fadd_rn(__fmul_rn(uf, s), b);
  }

  // The thread's fragments take, for columns cl and cl + 8, the bytes of
  // rows 8q + 2 tig and 8q + 2 tig + 1 (q = 0..3): pair q's low nibbles are
  // the K values 2 tig, 2 tig + 1 (a0, a1) or 2 tig + 8, + 9 (a2, a3) of a
  // k16 step of low-nibble rows, its high nibbles the same of a step of
  // high-nibble rows. R = 32: steps lo(q0, q1), lo(q2, q3), hi(q0, q1),
  // hi(q2, q3); R = 16: lo(q0, q1), hi(q0, q1), lo(q2, q3), hi(q2, q3).
  template <int BN>
  __device__ static void decode_a(const Args& a, const uint8_t* raw, int, int cl, int lane,
                                  uint32_t (&frag)[4][4]) {
    const int tig = lane & 3;
    const uint8_t* q = raw + 32 * (BN + 16);
    uint32_t lo[4][2], hi[4][2];  // [pair q][column]
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = cl + 8 * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sc = qparam(q + h * BN * kQBytes, n);
        const float bc = qparam(q + (2 + h) * BN * kQBytes, n);
#pragma unroll
        for (int pq = 2 * h; pq < 2 * h + 2; ++pq) {
          const uint8_t* row = raw + (8 * pq + 2 * tig) * (BN + 16) + n;
          const uint32_t u0 = row[0], u1 = row[BN + 16];
          lo[pq][c] = pack_bf16x2(dq(u0 & 15u, sc, bc), dq(u1 & 15u, sc, bc));
          hi[pq][c] = pack_bf16x2(dq(u0 >> 4, sc, bc), dq(u1 >> 4, sc, bc));
        }
      }
    }
    const bool r32 = run_shift(a.G / 2) == 5;  // steps 1 and 2 swap between the two
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      frag[0][c] = lo[0][c];
      frag[0][2 + c] = lo[1][c];
      frag[1][c] = r32 ? lo[2][c] : hi[0][c];
      frag[1][2 + c] = r32 ? lo[3][c] : hi[1][c];
      frag[2][c] = r32 ? hi[0][c] : lo[2][c];
      frag[2][2 + c] = r32 ? hi[1][c] : lo[3][c];
      frag[3][c] = hi[2][c];
      frag[3][2 + c] = hi[3][c];
    }
  }

  __device__ static float finish(const Args&, float acc) { return acc; }
};

}  // namespace

// x (M, K) bf16; w (K/2, N) uint8 split-half; s, b (K/g, N): f32 (raw == 0) or
// the bf16 tinygemm scale and zero point (raw != 0); out (M, N) bf16. Tiles
// (bm, bn) from int4_matmul.pick_tiles_halves, ``per`` stages of 32 byte
// rows a split, ws (splits, M, N) f32 when splits > 1. Needs g % 32 == 0,
// K % g == 0, N % bn == 0 and 16-byte aligned rows; the Python wrapper
// checks them. Returns cudaGetLastError() after the launches.
extern "C" int ao_int4_wo_halves(const void* x, const void* w, const void* s, const void* b,
                                 void* out, void* ws_, int M, int K, int N, int G, int raw,
                                 int bm, int bn, int splits, int per, void* stream) {
  if (G % 32 || K % G || N % 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  auto* op = static_cast<__nv_bfloat16*>(out);
  const mg::Problem pb{static_cast<const __nv_bfloat16*>(x), op, ws, M, K, N, per,
                       (K / 2 + 31) / 32};
  const auto* wp = static_cast<const uint8_t*>(w);
  cudaError_t err = raw ? mg::launch<HalvesOp<1>>(pb, {wp, s, b, G}, bm, bn, splits, st)
                        : mg::launch<HalvesOp<0>>(pb, {wp, s, b, G}, bm, bn, splits, st);
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  const size_t mn = (size_t)M * N;
  int4_wo_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, op, mn, splits);
  return (int)cudaGetLastError();
}
