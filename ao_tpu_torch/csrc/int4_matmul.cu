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
// What bounds it on the H100, and the two forms:
//  * decode (M <= 16): the weight stream, 0.5 B per weight plus 4 B of s and
//    b2 per g weights, against 3.35 TB/s. It runs on the weight-stream
//    decode mainloop (gemv_mainloop.cuh) with GemvQ below: a ring of slabs
//    of word rows, x and the group's s and b2 rows in shared memory, fed by
//    TMA, the x sums taken once a slab for the CTA, plane_q into the A
//    fragments of mma.sync (the weights the A operand, int4_tiles.cuh, so at
//    M = 8 no half of an m16 tile is spent on rows of x that do not exist),
//    the K split summed in a thread-block cluster; one kernel a call, its
//    plan from int4_matmul.gemv_plan. (The earlier decode kernel issued
//    one run's loads, consumed them, and only then issued the next run's;
//    its K split wrote f32 partials that a second kernel summed.)
//  * prefill (M > 16): tensor-core operations, 2 M K N against 989 TFLOP/s,
//    on the shared wgmma mainloop (mixed_gemm.cuh) with MagicOp
//    (magic_op.cuh) and PlaneQ (plane_q.cuh): each thread decodes its own A
//    fragments with plane_q from a unit buffer of 64 word rows loaded once
//    per CTA, the group's steps run into tmp, and the fold adds s * tmp and
//    xsum * b2 to acc (two FMAs per accumulator a group). A pre-pass
//    (magic_xsum_kernel) writes the row sums of x per group, (K/g, M) f32,
//    which each stage's slot takes beside the group's s and b2 rows. The
//    tiles (BM, BN) and a split of K in whole units come from
//    int4_matmul.pick_tiles (the tile cache first). A fold needs a second
//    accumulator set and empties the tensor-core queue once a group, which
//    bounds the tiles to 128 x 128 at one CTA an SM (PERF.md).

#include "gemv_mainloop.cuh"
#include "plane_q.cuh"

namespace {

// K1's decode on the weight-stream mainloop (gemv_mainloop.cuh). Plane j of
// a word is ((w >> 4j) & 0x000F000F) | 0x43004300, one lop3: the bf16x2
// (128 + u) of plane_q before its subtract of 136, exact, so tmp = x_G .
// (128 + u_G) on the tensor cores (every product exact) and the fold adds
// acc += s * tmp, then acc += xsum * (b2 - 136 s), xsum x_G's sum over the
// same k16 steps (the mainloop's mma against ones): the same function as
// x_G . q_G with q = u - 8, 56 of a k16 step's 147 decode instructions
// fewer (PERF.md). A folding stage's
// qparams: the s rows of its 4 groups, then the b2 rows, bf16 (b2 the
// tinygemm zero point when raw_zp).
struct GemvQ {
  struct Args {
    const __nv_bfloat16* s;
    const __nv_bfloat16* b2;
    int raw_zp;
  };
  static constexpr bool kBias = true, kBlockScales = false;
  static constexpr int kQArrays = 2, kQBytes = 2, kStageQ = 16;  // s, b2 in bf16
  __host__ __device__ static int setup_bytes(const Args&) { return 0; }
  __device__ static void setup(const Args&, uint8_t*, int, int) {}

  struct Q {
    uint2 s[4], b[4];  // columns cb .. cb + 3 of the four groups
  };
  __device__ static void read_q(const uint8_t* q, int bn, int cb, Q& r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r.s[j] = *reinterpret_cast<const uint2*>(gv::q_at(q, bn, 2, 0, j, cb));
      r.b[j] = *reinterpret_cast<const uint2*>(gv::q_at(q, bn, 2, 1, j, cb));
    }
  }

  struct Slab {};
  __device__ static Slab slab(const Args&, const uint8_t*, int, const uint8_t*, int, int) {
    return {};
  }
  __device__ static void decode(const Slab&, int, const uint4& w0, const uint4& w1,
                                uint32_t (&a)[4][2][4]) {
    gv::by_plane(
        [](uint32_t w, int j) {
          uint32_t v;
          asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(v) : "r"(w >> (4 * j)), "r"(0x000F000Fu),
              "r"(0x43004300u));
          return v;
        },
        w0, w1, a);
  }

  // C fragment e of tile p: column cb + 2p + (e >> 1), x row 2 tig + (e & 1) + 8 nt
  template <int NT>
  __device__ static void fold(const Args& a, const Q& r, int j, const float (&tmp)[2][NT][4],
                              const float (&xs)[NT][4], float (&acc)[2][NT][4]) {
    const __nv_bfloat16* sh = reinterpret_cast<const __nv_bfloat16*>(&r.s[j]);
    const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(&r.b[j]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float sc = __bfloat162float(sh[c]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = c >> 1, e = 2 * (c & 1) + h;
          acc[p][nt][e] = fmaf(sc, tmp[p][nt][e], acc[p][nt][e]);
        }
      const float bc = fmaf(-136.f, sc, bias_of(sc, bh[c], a.raw_zp));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = c >> 1, e = 2 * (c & 1) + h;
          acc[p][nt][e] = fmaf(xs[nt][h], bc, acc[p][nt][e]);
        }
    }
  }

  __device__ static float finish(const Args&, float v) { return v; }
};

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

// Second pass of a split-K prefill launch: out = bf16(sum over splits of ws).
__global__ void int4_wo_reduce_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                                      size_t mn, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * mn + i];
  out[i] = __float2bfloat16(acc);
}

template <int KS>
cudaError_t launch(const __nv_bfloat16* x, const int32_t* word, const __nv_bfloat16* s,
                   const __nv_bfloat16* b2, __nv_bfloat16* out, float* ws, float* xs, int M,
                   int K, int N, int bm, int bn, int splits, int per, int raw_zp,
                   cudaStream_t st) {
  if (M <= 16 || xs == nullptr) return cudaErrorInvalidValue;
  const int mp = (M + 3) / 4 * 4;
  magic_xsum_kernel<KS><<<dim3((mp + 3) / 4, (K + 255) / 256), 128, 0, st>>>(x, xs, M, mp, K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const mg::Problem pb{x, out, ws, M, K, N, per, K / mg::kBK};
  return mg::launch<mg::MagicOp<PlaneQ, 16 * KS>>(pb, {word, {s, b2, xs, mp, raw_zp}}, bm, bn,
                                                  splits, st);
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

// The prefill (M > 16). x (M, K) bf16; word (K/8, N) int32; s, b2 (K/g,
// N) bf16 (with raw_zp != 0, b2 holds the tinygemm zero point and the
// kernel forms bf16(zp + 8s)); out (M, N) bf16; the mainloop's tiles (bm,
// bn) from int4_matmul.launch_tiles, per stages of 64 K a split (whole
// units of 8 stages when split), ws (splits, M, N) f32 when splits > 1, xs
// (K/g, ceil(M/4)*4) f32 scratch for the row sums of x. Needs g in {16, 32,
// 64, 128}, N % 32 == 0, K % (4g) == 0 and 16-byte aligned rows; the Python
// wrapper checks them. Returns cudaGetLastError() after the launches.
extern "C" int ao_int4_wo_magic(const void* x_, const void* word_, const void* s_, const void* b2_,
                                void* out_, void* ws_, void* xs_, int M, int K, int N, int G,
                                int bm, int bn, int splits, int per, int raw_zp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  const auto* word = static_cast<const int32_t*>(word_);
  const auto* s = static_cast<const __nv_bfloat16*>(s_);
  const auto* b2 = static_cast<const __nv_bfloat16*>(b2_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  float* ws = splits > 1 ? static_cast<float*>(ws_) : nullptr;
  float* xs = static_cast<float*>(xs_);
  if (M < 1 || N % 32 || K % (4 * G)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = by_group(G, [&](auto ks) {
    return launch<decltype(ks)::value>(x, word, s, b2, out, ws, xs, M, K, N, bm, bn, splits, per,
                                       raw_zp, st);
  });
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  const size_t mn = (size_t)M * N;
  int4_wo_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, out, mn, splits);
  return (int)cudaGetLastError();
}

// The decode (M <= 16), one launch on the weight-stream mainloop: x, word,
// s, b2 and out as above; the plan (wn warps along N, wk warps along K,
// cluster CTAs along K, ring stages) from
// int4_matmul.gemv_plan, checked again here (gv::plan_ok). Returns
// cudaGetLastError() after the launch, or minus libcuda's CUresult for a
// tensor map it refuses.
extern "C" int ao_int4_wo_magic_gemv(const void* x, const void* word, const void* s,
                                     const void* b2, void* out, int M, int K, int N, int G,
                                     int wn, int wk, int cluster, int stages, int raw_zp,
                                     void* stream) {
  if (N % 32 || G < 16 || K % (4 * G) || cluster < 1) return (int)cudaErrorInvalidValue;
  const int slabs = K / (4 * (G < 64 ? G : 64));  // of 8 R K values, R = min(g / 2, 32)
  const gv::Problem pb{static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(word),
                       static_cast<__nv_bfloat16*>(out), M, K, N, wn, wk, stages,
                       (slabs + cluster - 1) / cluster};
  const GemvQ::Args args{static_cast<const __nv_bfloat16*>(s),
                         static_cast<const __nv_bfloat16*>(b2), raw_zp};
  const void* q[2] = {s, b2};
  int err = (int)cudaErrorInvalidValue;
  by_group(G, [&](auto ks) {
    err = gv::launch<GemvQ, decltype(ks)::value>(pb, args, q, cluster,
                                                 static_cast<cudaStream_t>(stream));
    return cudaSuccess;
  });
  return err;
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

  __device__ static float finish(const Args&, int, float acc) { return acc; }
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
