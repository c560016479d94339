// The weight-stream decode mainloop of K1 (int4_matmul.cu), K15
// (lut4_matmul.cu) and K14 (fp4_matmul.cu) at M <= 16: one device kernel a
// call over the int4 "magic" words (K/8, N), or K14's fp4-magic words (the
// same layout with one super-group, g = K/4), each Op supplying its decode
// of a word's plane and its per-group fold, or its block scales.
//
// What bounds it on the H100: the weight stream, 0.5 B a weight plus 4 B of
// qparams a group and column, against 3.35 TB/s. The earlier kernel lacked
// bytes in flight (by Little's law about 18 KB an SM at all times): each
// thread issued one run's word loads, then consumed them all before it
// issued the next run's. At decode a CTA's warps are also few (one or two a
// scheduler), so every instruction a slab costs its latency: a first
// version of this loop that issued each slab by cp.async, 16 bytes a
// thread, spent about 1050 instructions a warp a slab (588 of them
// decoding) and 3500 cycles, 14.5 us at 4096 x 4096 (PERF.md). So:
//
// * A ring of `stages` slabs in shared memory, filled by TMA
//   (tma_ring.cuh): a producer warp issues a slab's few boxes, a box a
//   lane, against the stage's full barrier once every consumer warp has
//   released the stage (its empty barrier); no consumer spends an
//   instruction on a copy, nor waits while one is issued (800-1100 cycles a
//   slab). A slab is R word rows (a whole super-group up to 32 rows, g <=
//   64; half a super-group at g = 128: R / 8 k16 steps of each of its four
//   groups) by the CTA's BN = 32 wn columns, a box of R rows x 128 bytes a
//   warp of columns with the 128-byte swizzle; the thread of group gid
//   reads 16-byte chunk cw = gid / 2 + 4 (gid % 2) of the warp's box rows
//   tig and tig + 4, so a quarter warp's reads fall in eight distinct
//   chunks (no bank conflict). Beside it in the same stage: the slab's K
//   slices of x (2 R values of each of its four groups; boxes of 8 or 16
//   rows x 128 bytes, swizzled, rows past M filled with zeros by TMA) and,
//   in the stage that ends a group's part in this CTA, the qparam rows of
//   the slab's four groups (boxes of 4 rows x 128 bytes, or of a whole row
//   where shorter).
// * x staged once a CTA: every warp takes its B fragments by ldmatrix from
//   the stage; (Ops with a bias) x's sums over the warp's steps come from
//   one more mma a group and step, its A fragment every weight 1, so no
//   thread sums x and no barrier of the CTA's warps falls in the loop.
// * The weights stay the A operand of mma.sync m16n8k16 (the swapped
//   operands of int4_tiles.cuh: 16 columns as the rows of an m16 tile, the
//   batch rows of x as the n8 tile's columns), so at M = 8 no half of a tile
//   is spent on rows of x that do not exist. A warp owns 32 columns and the
//   k16 steps s = wk_i, wk_i + wk, .. of each slab.
// * Per group, tmp = x_G . w_G on the tensor cores; the fold (Op::fold)
//   adds it to acc in f32 once the group's part in the CTA ends (the last
//   slab of its super-group, or of the CTA's range of K), with the qparams
//   of that slab's stage, before the warp releases it.
// * One launch, no workspace: the wk warps along K of a CTA are summed in
//   shared memory in warp order, then the cluster of CTAs along K (grid.z,
//   at most 8) through distributed shared memory in rank order
//   (cluster_sum.cuh); rank r of the cluster takes slabs [r per, (r+1) per).
//
// The plan (wn warps along N, wk warps along K, cluster, stages) comes from
// int4_matmul.gemv_plan, which mirrors gv::smem_bytes and gv::plan_ok;
// int4_matmul.gemv_mirror repeats the kernel's summation order in PyTorch
// for the CPU tests. The tensor maps are encoded on the host for each call
// (encode_maps: the host's cost a call stayed within its noise of the
// parent's two launches, PERF.md); a map libcuda refuses makes the C entry
// return minus its CUresult.
//
// An Op supplies: Args; kBias (its fold adds sum(x_G) * b2, so the mainloop
// takes the x sums); kQArrays and kQBytes (its qparam arrays, (K/g, N) of
// kQBytes a value: 16 BN bytes a folding stage in all); kBlockScales and
// kStageQ (the bytes a column of a stage's side rows: 16 for the folding
// qparams; an Op with block scales has them in every stage, kStageQ / 8
// bytes a value, see below); setup_bytes(args) and setup(args, smem, tid,
// threads) (per-CTA tables, K15's codebooks, K14's code tables, by plain
// stores); Q and read_q(q, bn, cb, Q&) (the thread's four columns' qparams
// of the four groups, through q_at); Slab and slab(args, setup, group, q,
// bn, cb) (per-slab state of the decode; q the stage's side rows); with
// block scales, scale_row(slab&, r); decode(slab, k, w0, w1, a) (step k's
// A fragments of the four groups from the thread's two 16-byte word reads;
// by_plane builds them plane by plane); fold<NT>(args, Q, j, tmp, xs, acc)
// (xs in the layout of an n8 tile's C fragment, value e row 2 tig + (e &
// 1) + 8 nt of x); finish(args, v) (an output value before its bf16
// rounding).
//
// K14 (KS = 0): g = K/4, one super-group, so plane j is logical rows [jK/4,
// (j+1)K/4) and slab s its rows [64 s, 64 s + 64); R = 32, and the slab's K
// slice of x is taken at run time. Its Op has no qparams and no bias: no
// per-group fold, plane j's mma go to chain j % kChains of the tmp set,
// summed into acc after the loop (one chain of 16 dependent mma a slab ran
// slower). Its block scales, (K/32, N) values of kStageQ / 8 bytes viewed
// as (4 planes, K/128 rows, N), come with every slab: rows 2 s and 2 s + 1
// of each plane (the two 32-row blocks of its 64 rows), one 3-D box of (BN,
// 2, 4) values (maps.q[0]). A warp along K takes a run of the slab's steps
// (both steps of a block where wk <= 2), and scale_row(slab, r) decodes row
// r once at the first of its steps; the decode of step k uses row k >> 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_sum.cuh"
#include "tma_ring.cuh"

namespace gv {

constexpr int kMaxWarps = 8;
constexpr int kMaxCluster = 8;
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;

// The bytes a row of a qparam box holds: 128, or a whole row of BN values
// of es bytes where that is less (K1's bf16 at wn = 1).
__host__ __device__ constexpr int q_box_bytes(int bn, int es) {
  return bn * es < 128 ? bn * es : 128;
}

struct Problem {
  const __nv_bfloat16* x;
  const int32_t* word;
  __nv_bfloat16* out;
  int M, K, N;
  int wn, wk, stages;  // the plan (cluster = gridDim.z)
  int per;             // slabs a CTA along K
};

// The tensor maps of a launch, a kernel parameter.
struct Maps {
  CUtensorMap w;     // words (K/8 rows, 4 N bytes): boxes of R rows x 128 bytes, swizzled
  CUtensorMap x;     // x (M rows, 2 K bytes): boxes of 8 NT rows x 128 bytes, swizzled
  CUtensorMap q[2];  // the qparam arrays (K/g rows, N kQBytes bytes): boxes of 4 rows
};

__host__ __device__ constexpr int align_up(int b, int a) { return (b + a - 1) / a * a; }

// The word rows of a slab at g = 16 KS: a whole super-group up to 32 rows
// (g <= 64), half of one at g = 128; 32 at g = K/4 (KS = 0, K14).
template <int KS>
__host__ __device__ constexpr int slab_rows() {
  return KS == 0 || 8 * KS >= 32 ? 32 : 8 * KS;
}

// The bytes of one stage (1024-byte aligned, as the swizzled boxes need):
// wn word boxes of R x 128, R / 8 x boxes of MP x 128, qcol BN bytes of side
// rows (16 BN: the qparam boxes).
struct Stage {
  int w_box, x, x_box, q, bytes;
  __host__ __device__ Stage(int wn, int rows, int mp, int qcol = 16)
      : w_box(rows * 128),
        x(wn * rows * 128),
        x_box(mp * 128),
        q(wn * rows * 128 + rows / 8 * mp * 128),
        bytes(align_up(wn * rows * 128 + rows / 8 * mp * 128 + qcol * 32 * wn, 1024)) {}
};

// Dynamic shared memory of a launch: 1024 bytes of alignment slack, the
// ring (or, after the loop, the K warps' partials), the Op's tables, the
// cluster's partials, a full and an empty barrier a stage.
__host__ __device__ inline int smem_bytes(int wn, int wk, int rows, int stages, int nt,
                                          int setup, int qcol = 16) {
  const int mp = 8 * nt, nv = 8 * nt;
  const int ring = stages * Stage(wn, rows, mp, qcol).bytes;
  const int red = (wk - 1) * wn * nv * 32 * 4;
  return 1024 + align_up(ring > red ? ring : red, 16) + align_up(setup, 16) +
         (nv + 7) * 32 * wn * 4 + align_up(16 * stages, 16);
}

// Group j's qparam of column col in a folding stage's boxes: array a's row
// of BN values of es bytes is BN es / q_box_bytes boxes of the four groups'
// rows.
__device__ __forceinline__ const uint8_t* q_at(const uint8_t* q, int bn, int es, int a, int j,
                                               int col) {
  const int qb = q_box_bytes(bn, es), b = col * es;
  return q + ((a * (bn * es / qb) + b / qb) * 4 + j) * qb + b % qb;
}

// Spin until the phase of parity `parity` of `bar` has completed; a phase
// that never completes (bytes a copy never brings) traps, so a launch
// fails rather than hangs.
__device__ __forceinline__ void wait_full(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = tma::smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of NT n8 tiles (rows of x) for one k16 step: b[nt][0] holds
// k 2 tig, 2 tig + 1 of row gid + 8 nt, b[nt][1] the same 8 further on.
template <int NT>
__device__ __forceinline__ void ldmatrix_b(uint32_t (&b)[NT][2], uint32_t addr) {
  if constexpr (NT == 1) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b[0][0]), "=r"(b[0][1])
                 : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
                 : "r"(addr));
  }
}

// A step's A fragments, plane by plane: plane(w, j) of the thread's words
// (columns cb .. cb + 3 of rows tig (w0) and tig + 4 (w1)); tile p holds
// columns cb + 2p (its rows 0..7) and cb + 2p + 1 (rows 8..15).
template <class F>
__device__ __forceinline__ void by_plane(F&& plane, const uint4& w0, const uint4& w1,
                                         uint32_t (&a)[4][2][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0][0] = plane(w0.x, j);
    a[j][0][1] = plane(w0.y, j);
    a[j][0][2] = plane(w1.x, j);
    a[j][0][3] = plane(w1.y, j);
    a[j][1][0] = plane(w0.z, j);
    a[j][1][1] = plane(w0.w, j);
    a[j][1][2] = plane(w1.z, j);
    a[j][1][3] = plane(w1.w, j);
  }
}

// Grid (N / 32 wn, 1, cluster), 32 (wn wk + 1) threads: wn wk consumer
// warps, then the producer warp. g = 16 KS (K/4 at KS = 0); NT n8 tiles of
// x rows (M <= 8 NT).
template <class Op, int KS, int NT>
__global__ void __launch_bounds__(32 * (kMaxWarps + 1))
    gemv_kernel(const __grid_constant__ Maps maps, const Problem pb,
                const typename Op::Args args) {
  constexpr int MP = 8 * NT, NV = 8 * NT;
  constexpr int R = slab_rows<KS>();
  constexpr bool kFold = Op::kQArrays > 0 || Op::kBias;
  // Without a fold, plane j's mma go to tmp[j % kChains], kChains chains of
  // dependent mma, summed into acc after the loop.
  constexpr int kChains = 2;
  const int G = KS ? 16 * KS : pb.K / 4, SPS = G / 2 / R;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (tma::smem_u32(smem_raw) & 1023)) & 1023);
  const bool clustered = gridDim.z > 1;
  if (clustered) cluster_started();
  const int tid = threadIdx.x, threads = 32 * pb.wn * pb.wk;  // the consumers'
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const bool producer = warp == pb.wn * pb.wk;  // the last warp issues the copies
  const int wn_i = warp % pb.wn, wk_i = warp / pb.wn;
  const int BN = 32 * pb.wn;
  const int cw = (gid >> 1) | ((gid & 1) << 2);  // the thread's chunk of its warp's box rows
  const int n0 = blockIdx.x * BN, cb = 32 * wn_i + 4 * cw;  // its columns: cb .. cb + 3
  const Stage L(pb.wn, R, MP, Op::kStageQ);
  const int ring_bytes = pb.stages * L.bytes, red_bytes = (pb.wk - 1) * pb.wn * NV * 32 * 4;
  uint8_t* setup = ring + align_up(ring_bytes > red_bytes ? ring_bytes : red_bytes, 16);
  float* part = reinterpret_cast<float*>(setup + align_up(Op::setup_bytes(args), 16));
  uint64_t* full = reinterpret_cast<uint64_t*>(part + (NV + 7) * 32 * pb.wn);  // a stage each
  uint64_t* empty = full + pb.stages;  // every consumer warp is done with the stage

  const int s0 = blockIdx.z * pb.per;
  const int s1 = min(s0 + pb.per, pb.K / (8 * R));
  const int n = max(0, s1 - s0);
  auto folds = [&](int s) { return (s + 1) % SPS == 0 || s + 1 == s1; };

  // Slab s0 + i into `slot`, by the producer warp, a box a lane: lanes
  // [0, wn) the word boxes of the CTA's wn
  // warps of columns, lanes [8, 8 + R / 8) x's boxes of 64 values (box b:
  // from group 32 b / R of the slab), in a folding slab lanes [16, 16 + 16
  // BN / 512) the qparam boxes (block scales: lane 16 the slab's box, every
  // slab); lane 0 first arms the stage's barrier.
  const int qb = q_box_bytes(BN, Op::kQBytes), q_boxes = BN * Op::kQBytes / qb;
  auto load = [&](int i, int slot) {
    const int s = s0 + i, t = KS ? s / SPS : 0, r0 = KS ? s % SPS * R : s * R;
    uint8_t* st = ring + slot * L.bytes;
    uint64_t* bar = full + slot;
    const bool fq = folds(s);
    if (lane == 0)
      tma::mbar_arrive_expect_tx(bar, pb.wn * L.w_box + R / 8 * L.x_box +
                                          (Op::kBlockScales ? Op::kStageQ * BN
                                           : fq             ? 16 * BN
                                                            : 0));
    __syncwarp();
    if (lane < pb.wn) {
      tma::load_2d(st + lane * L.w_box, &maps.w, bar, 4 * (n0 + 32 * lane), t * (G / 2) + r0);
    } else if (lane >= 8 && lane < 8 + R / 8) {
      const int b = lane - 8;
      tma::load_2d(st + L.x + b * L.x_box, &maps.x, bar, 2 * ((4 * t + 32 * b / R) * G + 2 * r0),
                   0);
    } else if constexpr (Op::kBlockScales) {
      if (lane == 16) tma::load_3d(st + L.q, &maps.q[0], bar, n0, 2 * s, 0);
    } else if (fq && lane >= 16 && lane < 16 + Op::kQArrays * q_boxes) {
      const int a = (lane - 16) / q_boxes, b = (lane - 16) % q_boxes;
      tma::load_2d(st + L.q + (lane - 16) * 4 * qb, &maps.q[a], bar, n0 * Op::kQBytes + qb * b,
                   4 * t);
    }
  };

  // tmp: group j's x_G . w_G over this warp's steps since its last fold;
  // xa (Ops with a bias): x_G's sums over the same steps, from an mma with
  // every weight 1 (value e: row 2 tig + (e & 1) + 8 nt of x)
  float acc[2][NT][4], tmp[4][2][NT][4], xa[4][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[p][nt][e] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) tmp[j][p][nt][e] = xa[j][nt][e] = 0.f;
      }
  const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};  // bf16x2 1s
  typename Op::Q q;

  if (tid == 0) {
    tma::prefetch_map(&maps.w);
    tma::prefetch_map(&maps.x);
    for (int i = 0; i < pb.stages; ++i) {
      tma::mbar_init(full + i, 1);
      tma::mbar_init(empty + i, pb.wn * pb.wk);
    }
    tma::mbar_init_fence();
  }
  __syncthreads();  // the barriers
  if (producer) {
    // Slab i into slot i % stages once the consumers released its fill
    // (i / stages) - 1. Issuing a slab's boxes holds a warp 800-1100 cycles
    // (H100): a consumer warp that issued them held every other one at the
    // next barrier for as long, a quarter of each slab's time.
    for (int i = 0, slot = 0, phase = 0; i < n; ++i) {
      if (i >= pb.stages) wait_full(empty + slot, phase ^ 1);
      load(i, slot);
      if (++slot == pb.stages) slot = 0, phase ^= 1;
    }
  } else {
    Op::setup(args, setup, tid, threads);
    asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");  // the consumers: the tables
  }
  // ldmatrix: lane l gives row r = (l & 7) + 8 (l >> 4) of x, the upper 8
  // values of a step at l >> 3 & 1; chunk c of row r sits at c ^ (r & 7)
  const int lrow = (lane & 7) + (NT == 2 ? 8 * (lane >> 4) : 0), lh = lane >> 3 & 1;
  const uint32_t x_lane = tma::smem_u32(ring) + L.x + lrow * 128;
  // words of step k: box rows 8 k + tig and 8 k + 4 + tig, chunk cw (swizzled)
  const int w_lane0 = wn_i * L.w_box + tig * 128 + ((cw ^ tig) << 4);
  const int w_lane1 = wn_i * L.w_box + (4 + tig) * 128 + ((cw ^ tig ^ 4) << 4);
  // slab i in slot i % stages, its fill (i / stages) & 1 of the slot's barrier
  for (int i = 0, slot = 0, phase = 0; i < n && !producer; ++i) {
    wait_full(full + slot, phase);  // slab i has landed
    const uint8_t* st = ring + slot * L.bytes;
    const int s = s0 + i;
    typename Op::Slab sl = Op::slab(args, setup, 4 * (KS ? s / SPS : 0), st + L.q, BN, cb);
    const uint32_t xl = x_lane + slot * L.bytes;
#pragma unroll
    for (int k = 0; k < R / 8; ++k) {
      if constexpr (Op::kBlockScales) {
        // warp wk_i's steps: a run of R / 8 / wk from k0, so a block's two
        // steps share the scales the Op decodes at the first of them
        const int run = R / 8 / pb.wk, k0 = wk_i * run;
        if (k < k0 || k >= k0 + run) continue;
        if ((k & 1) == 0 || k == k0) Op::scale_row(sl, k >> 1);
      } else {
        if ((k & (pb.wk - 1)) != wk_i) continue;  // warp wk_i's steps: wk_i, wk_i + wk, ..
      }
      const uint4 w0 = *reinterpret_cast<const uint4*>(st + w_lane0 + 1024 * k);
      const uint4 w1 = *reinterpret_cast<const uint4*>(st + w_lane1 + 1024 * k);
      uint32_t a[4][2][4];  // group j's A fragments of the step's two m16 tiles
      Op::decode(sl, k, w0, w1, a);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[NT][2];
        const int v = j * 2 * R + 16 * k;  // the step's first value of the slab's x
        ldmatrix_b<NT>(b, xl + (v >> 6) * L.x_box + (((((v >> 3) & 7) | lh) ^ (lrow & 7)) << 4));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if constexpr (kFold) {
            mma_16816(tmp[j][0][nt], a[j][0], b[nt][0], b[nt][1]);
            mma_16816(tmp[j][1][nt], a[j][1], b[nt][0], b[nt][1]);
            if (Op::kBias) mma_16816(xa[j][nt], ones, b[nt][0], b[nt][1]);
          } else {
            mma_16816(tmp[j % kChains][0][nt], a[j][0], b[nt][0], b[nt][1]);
            mma_16816(tmp[j % kChains][1][nt], a[j][1], b[nt][0], b[nt][1]);
          }
        }
      }
    }
    if constexpr (kFold) {
      if (folds(s)) {  // the four groups' part in this CTA ends: fold with their qparams
        Op::read_q(st + L.q, BN, cb, q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Op::template fold<NT>(args, q, j, tmp[j], xa[j], acc);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) tmp[j][0][nt][e] = tmp[j][1][nt][e] = xa[j][nt][e] = 0.f;
        }
      }
    }
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(empty + slot);  // this warp is done with the slot
    if (++slot == pb.stages) slot = 0, phase ^= 1;
  }

  if constexpr (!kFold) {  // the chains into acc, in order
#pragma unroll
    for (int c = 0; c < kChains; ++c)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][nt][e] += tmp[c][p][nt][e];
  }
  float v[NV];  // value (p NT + nt) 4 + e: column 2p + (e >> 1), row 2 tig + (e & 1) + 8 nt
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[(p * NT + nt) * 4 + e] = acc[p][nt][e];
  if (pb.wk > 1) {  // the warps along K into warp row 0, in order; their partials in the ring
    __syncthreads();
    float* red = reinterpret_cast<float*>(ring);
    if (!producer && wk_i > 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) red[(((wk_i - 1) * pb.wn + wn_i) * NV + i) * 32 + lane] = v[i];
    }
    __syncthreads();
    if (wk_i == 0) {
      for (int w = 1; w < pb.wk; ++w) {
#pragma unroll
        for (int i = 0; i < NV; ++i) v[i] += red[(((w - 1) * pb.wn + wn_i) * NV + i) * 32 + lane];
      }
    }
  }
  const int col = n0 + cb;
  if (clustered) {
    cluster_sum(v, part, 32 * wn_i + lane, 32 * pb.wn, wk_i == 0, [&](int i, float sum) {
      const int e = i & 3, nt = (i >> 2) % NT, p = (i >> 2) / NT;
      const int r = 2 * tig + (e & 1) + 8 * nt;
      if (r < pb.M)
        pb.out[(size_t)r * pb.N + col + 2 * p + (e >> 1)] = __float2bfloat16(Op::finish(args, sum));
    });
    return;
  }
  if (wk_i != 0) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * tig + h + 8 * nt;
      if (r >= pb.M) continue;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(Op::finish(args, v[nt * 4 + h]),
                                                      Op::finish(args, v[nt * 4 + 2 + h]));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(Op::finish(args, v[(NT + nt) * 4 + h]),
                                                      Op::finish(args, v[(NT + nt) * 4 + 2 + h]));
      *reinterpret_cast<uint2*>(pb.out + (size_t)r * pb.N + col) = make_uint2(
          *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    }
}

// The checks of int4_matmul.gemv_plan_ok: every CTA along K has slabs, the
// warps along K split a slab's steps evenly.
__host__ inline bool plan_ok(int M, int K, int N, int G, int wn, int wk, int cluster, int stages,
                             int per) {
  const int rows = G / 2 < 32 ? G / 2 : 32;
  if (M < 1 || M > 16 || (wn != 1 && wn != 2 && wn != 4) || (wk != 1 && wk != 2 && wk != 4) ||
      wn * wk > kMaxWarps || N % (32 * wn) || (rows / 8) % wk)
    return false;
  if (stages < 2 || stages > kMaxStages || cluster < 1 || cluster > kMaxCluster || per < 1)
    return false;
  const int slabs = K / (8 * rows);
  return K % (8 * rows) == 0 && (cluster - 1) * per < slabs && slabs <= cluster * per;
}

// The map of a row-major (rows, row_bytes) byte matrix in boxes of box_rows
// x box_bytes, unswizzled (the qparam rows).
inline CUresult encode_rows_plain(CUtensorMap* map, const void* base, uint64_t rows,
                                  uint64_t row_bytes, uint32_t box_rows, uint32_t box_bytes) {
  const tma::EncodeTiled fn = tma::encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {row_bytes, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_bytes, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The map of block scales (K/32, N) of es bytes (1 or 4) viewed as (4
// planes, K/128 rows, N), in boxes of (bn, 2, 4) values: a slab's two rows
// of each plane.
inline CUresult encode_block_scales(CUtensorMap* map, const void* base, int K, int N, int es,
                                    int bn) {
  const tma::EncodeTiled fn = tma::encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K / 128, 4};
  const cuuint64_t strides[2] = {(cuuint64_t)N * es, (cuuint64_t)K / 128 * N * es};
  const cuuint32_t box[3] = {(cuuint32_t)bn, 2, 4};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, es == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT32, 3,
            const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The maps of a launch at g = G: the words in boxes of a slab's rows, x in
// boxes of its n8 tiles' rows, each of the Op's qparam arrays (or its block
// scales).
template <class Op>
CUresult encode_maps(Maps* m, const Problem& pb, int G, const void* const* q) {
  const int rows = G / 2 < 32 ? G / 2 : 32;
  CUresult r = tma::encode_rows_sw128(&m->w, pb.word, pb.K / 8, 4ull * pb.N, rows);
  if (r == CUDA_SUCCESS)
    r = tma::encode_rows_sw128(&m->x, pb.x, pb.M, 2ull * pb.K, pb.M <= 8 ? 8 : 16);
  for (int a = 0; a < Op::kQArrays && r == CUDA_SUCCESS; ++a)
    r = encode_rows_plain(&m->q[a], q[a], pb.K / G, (uint64_t)Op::kQBytes * pb.N, 4,
                          q_box_bytes(32 * pb.wn, Op::kQBytes));
  if (Op::kBlockScales && r == CUDA_SUCCESS)
    r = encode_block_scales(&m->q[0], q[0], pb.K, pb.N, Op::kStageQ / 8, 32 * pb.wn);
  return r;
}

template <class Op, int KS, int NT>
cudaError_t launch_nt(const Maps& maps, const Problem& pb, const typename Op::Args& args,
                      int cluster, cudaStream_t st) {
  auto kernel = gemv_kernel<Op, KS, NT>;
  const int smem = smem_bytes(pb.wn, pb.wk, slab_rows<KS>(), pb.stages, NT,
                              Op::setup_bytes(args), Op::kStageQ);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // dynamic shared memory above 48 KB needs the opt-in (per device: every call)
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pb.N / (32 * pb.wn), 1, cluster);
  cfg.blockDim = dim3(32 * (pb.wn * pb.wk + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, maps, pb, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// One launch of the mainloop at g = 16 KS (K/4 at KS = 0): the plan
// checked, the maps encoded (a map libcuda refuses: minus its CUresult),
// the kernel launched (a cudaError_t).
template <class Op, int KS>
int launch(const Problem& pb, const typename Op::Args& args, const void* const* q, int cluster,
           cudaStream_t st) {
  const int G = KS ? 16 * KS : pb.K / 4;
  if (!plan_ok(pb.M, pb.K, pb.N, G, pb.wn, pb.wk, cluster, pb.stages, pb.per))
    return (int)cudaErrorInvalidValue;
  Maps maps;
  const CUresult r = encode_maps<Op>(&maps, pb, G, q);
  if (r != CUDA_SUCCESS) return -(int)r;
  return (int)(pb.M <= 8 ? launch_nt<Op, KS, 1>(maps, pb, args, cluster, st)
                         : launch_nt<Op, KS, 2>(maps, pb, args, cluster, st));
}

}  // namespace gv
