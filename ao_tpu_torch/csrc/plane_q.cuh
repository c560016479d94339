// K1's decode for MagicOp (magic_op.cuh): the prefill form of K1
// (int4_matmul.cu) and the row tiles of K13's magic form (grouped_matmul.cu)
// run it on the shared wgmma mainloop.

#pragma once

#include "int4_tiles.cuh"
#include "magic_op.cuh"

namespace {

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

}  // namespace
