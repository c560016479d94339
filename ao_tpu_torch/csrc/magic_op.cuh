// The int4 "magic" layout on the shared wgmma mainloop (mixed_gemm.cuh), for
// the prefill forms (M > 16) of K1 (int4_matmul.cu: q = u - 8 with the group
// scale and bias) and K15 (lut4_matmul.cu: a 16-entry codebook with the
// group scaler). Both TPU kernels form each group's dot in f32 from exact
// bf16 weights and scale it after the products; so does MagicOp, through
// the mainloop's per-group fold.
//
// Layout (quantization/qarrays/int4.py): words (K/8, N) int32; word row
// (g/2)t + r' holds, at bits 4j + 16h, logical row (4t + j)g + 2r' + h, so
// plane j of super-group t is group 4t + j, and a word's plane j is two
// consecutive K rows of one column: one bf16x2 register of wgmma's A
// fragment (K pair 2 tig, 2 tig + 1 of a k16 step from word row tig of the
// step's eight, 2 tig + 8, + 9 from row tig + 4).
//
// K order. A k16 step is 8 word rows of one plane: 16 consecutive K values
// of one group, so plain K order (stage s is K values 64 s .. 64 s + 63)
// runs each group's steps one after the other. A unit is 64 word rows (512
// K values; fewer at a ragged end of K), whole super-groups, loaded once per
// CTA into a unit buffer that serves its 8 stages: the four planes of a word
// come from one load (the TPU kernel shifts its VMEM words once per plane; a
// stage that loaded one plane's 32 word rows would read the words four
// times from L2).
//
// The slot of a stage holds, for each group the stage touches (one at g >=
// 64, 64 / g below), the Decode's group bytes (scales, bias, x sums or
// codebook), loaded again in both stages of a g = 128 group, so that the
// decode (K15's codebook) and the fold (the stage that ends the group) read
// their own slot. A Decode supplies: Params; group_bytes<BN>() (for up to
// kMagicMaxBM x rows); Thread<BM, BN, NT>(p, pb, m0, n0, tid) with
// load(p, pb, dst, group) (its cp.async chunks of a group's bytes);
// plane(group bytes, word, j) (bf16x2 of plane j); fold<BM, BN>(p, group
// bytes, cl, lane, tmp, acc). Every offset that does not change over K is
// computed once per thread, before the K loop (MagicOp::Thread): the fold's
// second accumulator set leaves few registers, and the first version, which
// computed each stage's addresses anew, issued about 700 instructions a
// warp a stage against the tensor cores' 512 cycles (PERF.md).

#pragma once

#include "mixed_gemm.cuh"

namespace mg {

constexpr int kMagicUnitRows = 64;  // word rows of a unit
constexpr int kMagicMaxBM = 128;    // the largest tile of x rows a fold runs

template <class Decode, int G>
struct MagicOp {
  static_assert(G == 16 || G == 32 || G == 64 || G == 128, "group sizes 16 .. 128");
  struct Args {
    const int32_t* word;
    typename Decode::Params q;
  };
  static constexpr int kGroup = G;
  static constexpr int kUnitStages = kMagicUnitRows / 8;  // 8 stages of 64 K a unit
  static constexpr int kPieceSteps = G / 16 < 4 ? G / 16 : 4;  // a group's steps in one stage
  static constexpr int kPieces = 4 / kPieceSteps;               // groups a stage touches

  template <int BN>
  __host__ __device__ static constexpr int unit_bytes() {
    return kMagicUnitRows * (BN + 8) * 4;  // rows padded by 32 bytes: no bank conflicts
  }
  template <int BN>
  __host__ __device__ static constexpr int raw_bytes() {
    return kPieces * Decode::template group_bytes<BN>();
  }

  // Step kk of stage s holds K values k = 64 s + 16 kk .. + 15: group k / G,
  // plane (k / G) % 4, and, in the unit's buffer, the block of eight word
  // rows from (super-group in the unit) * G / 2 + (k % G) / 2.
  // (unsigned: divisions by powers of two are shifts, without sign fix-ups)
  __device__ static uint32_t group_of(uint32_t s, uint32_t kk) { return (kBK * s + 16 * kk) / G; }
  __device__ static uint32_t unit_row(uint32_t s, uint32_t kk) {
    const uint32_t ku = kBK * (s % kUnitStages) + 16 * kk;  // K value within the unit
    return ku / (4 * G) * (G / 2) + ku % G / 2;
  }

  // A thread's offsets, fixed over the K loop: its chunks of a unit's words
  // (column 4 cc of rows r0 + k RS), its fragments' words (row tig, column
  // cl of a step's block of eight) and the Decode's chunks of a group.
  template <int BM, int BN, int NT>
  struct Thread {
    static_assert(BM <= kMagicMaxBM, "group bytes hold the x sums of kMagicMaxBM rows");
    static constexpr int kRow = BN + 8;  // words a unit row
    static constexpr int CH = BN / 4;    // 16-byte chunks of a unit row
    static constexpr int RS = NT / CH;   // unit rows a pass of the block covers
    const int32_t* wsrc;                 // word row r0, column n0 + 4 cc
    int wrow, wdst, fdst;
    bool wcol;
    int cl, lane;
    typename Decode::template Thread<BM, BN, NT> dec;

    __device__ Thread(const Args& a, const Problem& pb, int m0, int n0, int tid)
        : wsrc(a.word + (size_t)(tid / CH) * pb.N + n0 + 4 * (tid % CH)),
          wrow(tid / CH),
          wdst((tid / CH * kRow + 4 * (tid % CH)) * 4),
          fdst((tid & 3) * kRow + (tid >> 5) * 16 + ((tid & 31) >> 2)),
          wcol(n0 + 4 * (tid % CH) < pb.N),
          cl((tid >> 5) * 16 + ((tid & 31) >> 2)),
          lane(tid & 31),
          dec(a.q, pb, m0, n0, tid) {}

    // Stage s's group bytes and, at a unit's first stage, the unit's words
    // (zero past K / 8 and N); no commit.
    __device__ void load(const Args& a, const Problem& pb, uint8_t* raw, uint8_t* unit,
                         bool unit_starts, int s) {
      if (unit_starts) {
        const int row0 = s / kUnitStages * kMagicUnitRows;
        const int32_t* src = wsrc + (size_t)row0 * pb.N;
#pragma unroll
        for (int k = 0; k < kMagicUnitRows / RS; ++k) {
          const bool ok = wcol && row0 + wrow + k * RS < pb.K / 8;
          cp_async16(unit + wdst + k * RS * kRow * 4, ok ? src + (size_t)k * RS * pb.N : a.word,
                     ok);
        }
      }
#pragma unroll
      for (int e = 0; e < kPieces; ++e)
        dec.load(a.q, pb, raw + e * Decode::template group_bytes<BN>(),
                 group_of(s, e * kPieceSteps));
    }

    // Step kk's fragment registers: plane j of the words of rows tig (a0, a1)
    // and tig + 4 (a2, a3) of its block of eight, columns cl (a0, a2) and
    // cl + 8.
    __device__ void decode(const Args&, const uint8_t* raw, const uint8_t* unit, int s,
                           uint32_t (&frag)[4][4]) const {
      const uint32_t* words = reinterpret_cast<const uint32_t*>(unit) + fdst;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t* w = words + unit_row(s, kk) * kRow;
        const int j = group_of(s, kk) % 4;
        const uint8_t* gb = raw + kk / kPieceSteps * Decode::template group_bytes<BN>();
        frag[kk][0] = Decode::plane(gb, w[0], j);
        frag[kk][1] = Decode::plane(gb, w[8], j);
        frag[kk][2] = Decode::plane(gb, w[4 * kRow], j);
        frag[kk][3] = Decode::plane(gb, w[4 * kRow + 8], j);
      }
    }

    // the group that step kk of the stage whose slot is raw ends
    __device__ void fold(const Args& a, const uint8_t* raw, int kk, const float (&tmp)[BM / 2],
                         float (&acc)[BM / 2]) const {
      Decode::template fold<BM, BN>(
          a.q, raw + kk / kPieceSteps * Decode::template group_bytes<BN>(), cl, lane, tmp, acc);
    }
  };

  __device__ static float finish(const Args&, float acc) { return acc; }
};

}  // namespace mg
