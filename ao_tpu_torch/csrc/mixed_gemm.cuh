// A mixed-input matmul mainloop for Hopper (sm_90a): y = x @ W with x bf16
// (M, K) and W a packed low-bit weight decoded exactly to bf16 inside the
// kernel, f32 sums on the tensor cores through wgmma. Shared by K14
// (fp4_matmul.cu: MXFP4 / NVFP4, the TPU kernels
// ao_tpu/ops/pallas/fp4_matmul.py::_mx_kernel and ::_nv_kernel), K11
// (int4_matmul.cu: the split-half int4 layout, the TPU kernels
// ao_tpu/ops/pallas/int4_matmul.py::_kernel and ::_kernel_twoplane) and,
// with a per-group fold (below), K1 and K15 over the int4 magic layout
// (magic_op.cuh; the TPU kernels int4_matmul.py::_magic_kernel and
// lut4_matmul.py::_lut4_kernel). Only the decode differs between them: it
// is the template parameter Op.
//
// What bounds these kernels on the H100: at prefill sizes (M in the hundreds
// or more) the tensor-core operations, 2 M K N against 989 TFLOP/s, with
// the decode of each weight (a few integer or f32 instructions) on the same
// SM's ALUs beside them. The TPU kernels decode each weight once per grid
// step into VMEM and feed the MXU from there. Here:
//
//  * a CTA owns BM rows of x by BN columns of W (BN = 64: one warpgroup of
//    128 threads; 128: two) and walks K in stages of 64 values, optionally
//    one contiguous range of stages per K split (grid.z; f32 partials summed
//    by a second pass, never atomics);
//  * a ring of shared-memory slots (as many, up to 8, as fit two CTAs an SM,
//    or one at BM = 256), each filled by cp.async.cg with commit / wait
//    groups: the stage's x tile (BM x 64 bf16 in wgmma's canonical K-major
//    layout with the 128-byte swizzle, zero rows past M) and its raw weight
//    bytes and scales (Op::load_raw);
//  * the weight is wgmma's A operand, from registers: warp w of a warpgroup
//    owns 16 of its 64 weight columns, and each thread decodes, straight from
//    the raw slot, exactly the four bf16x2 fragment registers of each k16
//    step that it feeds (Op::decode_a), so each weight is decoded once per
//    CTA, into registers, with no decoded tile written to shared memory and
//    no barrier between a warp's decode and its wgmma;
//  * x is the B operand (N = BM), read by wgmma from the slot through the
//    async proxy after fence.proxy.async.shared::cta and a barrier;
//  * wgmma.mma_async m64nBMk16 (f32 += bf16 x bf16) keeps the sums in
//    registers, transposed (weight columns as rows), and the epilogue writes
//    them back as y's rows, a lane shuffle pairing neighbouring columns;
//  * one wgmma group stays queued across stages: the decode of stage s + 1
//    (into the other of two register fragments) and the loads of stage s +
//    ST - 1 run while the tensor cores work through stage s.
//
// An Op supplies: Args (its pointers); raw_bytes<BN>() (raw bytes a stage
// needs in its slot); x_col(args, pb, stage, chunk, valid) (the K column of
// the stage's 16-byte x chunk 0..7, whose order defines the stage's K order
// for the decode too); load_raw<BN, NT>(...) (cp.async of a stage's raw
// bytes, no commit); decode_a<BN>(args, raw, stage, cl, lane, a) (the A
// fragments a[k16 step][4] of local weight columns cl and cl + 8, lane's
// K pairs); finish(args, acc) (the f32 epilogue before the bf16 store).
// (A first version decoded each stage into a swizzled bf16 tile in shared
// memory for wgmma to read as its B operand, x as A: the stores, the extra
// barrier and the decoded tile's reads made it far slower.)
//
// The per-group fold (K1 and K15, magic_op.cuh). The TPU kernels scale each
// group's f32 dot after its products (acc += s_G * (x_G . w_G)), which keeps
// every weight exact in bf16 (q or a codebook entry, never q * s). An Op
// that declares kGroup = G (16, 32, 64 or 128 K values) gets a second
// accumulator set, tmp: the wgmma of a group's first k16 step have scale-d
// 0, and once the group's last step retired the Op folds tmp into acc in
// f32 (K1: acc += s * tmp + xsum * b2, two FMAs an accumulator; K15: one).
// Such an Op reads x in K order, 64 K values a stage; supplies
// unit_bytes<BN>() and kUnitStages (a buffer of raw weight bytes that its
// stages share: both unit buffers sit after the ring) and a per-thread
// state Thread<BM, BN, NT>(args, pb, m0, n0, tid), built before the K loop
// with every offset that does not change over it, with load(...),
// decode(...) and fold(...) in place of load_raw and decode_a. Its tiles
// are (128, 128) at one CTA an SM (acc and tmp take 128 of its registers)
// and (64, 128) at two; its last tile of columns may be ragged (N % 32 ==
// 0: zero-filled loads, predicated stores); K splits fall on units.
// Ops without a group length compile as before.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mg {

constexpr int kBK = 64;  // K values per stage: one 128-byte row of bf16
constexpr int kRowBytes = 128;

// The problem every Op shares: x (M, K) bf16, out (M, N) bf16 or, with a K
// split, ws (splits, M, N) f32 partials; ``per`` stages of kBK per split,
// ``stages`` in all.
struct Problem {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  float* ws;
  int M, K, N;
  int per, stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offset of 16-byte chunk c (K values 8c .. 8c + 7) of row r in a
// K-major tile of 64 bf16 a row under the 128-byte swizzle: 8-row atoms of
// 1024 bytes, chunk c of row r at chunk position c ^ (r & 7).
__device__ __forceinline__ int sw128(int r, int c) { return r * kRowBytes + ((c ^ (r & 7)) << 4); }

// The wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile
// whose 8-row atoms start 1024-aligned: start address >> 4, leading byte
// offset unused (1), stride byte offset 1024 >> 4 between 8-row atoms,
// layout type 1 (128-byte swizzle) in bits 62-63. Adding 2 advances it by
// 32 bytes, one k16 step.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of the generic proxy (here cp.async) made visible to
// the async proxy (wgmma's operand reads); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator accesses across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// f(e) for each of TOTAL chunks e = tid + k NT a thread of NT takes.
template <int TOTAL, int NT, class F>
__device__ __forceinline__ void for_chunks(int tid, F&& f) {
#pragma unroll
  for (int k = 0; k < (TOTAL + NT - 1) / NT; ++k) {
    const int e = tid + k * NT;
    if (TOTAL % NT == 0 || e < TOTAL) f(e);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D (64 x 64 f32, registers) += A (64 x 16 bf16, registers: a fragment of
// four) * B (64 x 16 bf16, shared memory, K-major); 32 accumulators a thread.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 128 f32, registers) += A (64 x 16 bf16, registers: a fragment of
// four) * B (128 x 16 bf16, shared memory, K-major); 64 accumulators a thread.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 256 f32, registers) += A (64 x 16 bf16, registers: a fragment of
// four) * B (256 x 16 bf16, shared memory, K-major); 128 accumulators a thread.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x BM f32) = A B + (scale_d ? D : 0), the wgmma of a tile of BM x rows.
template <int BM>
__device__ __forceinline__ void wgmma_rs(float (&d)[BM / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  wgmma_rs_n64(d, a, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  wgmma_rs_n128(d, a, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  wgmma_rs_n256(d, a, db, scale_d);
}

// An Op's group length in K values (Op::kGroup), or 0 for an Op without a
// fold (K14's and K11's).
template <class Op, class = void>
struct GroupLen {
  static constexpr int value = 0;
};
template <class Op>
struct GroupLen<Op, std::void_t<decltype(Op::kGroup)>> {
  static constexpr int value = Op::kGroup;
};

// Bytes of a fold Op's two unit buffers (0 without a fold).
template <class Op, int BN, bool = (GroupLen<Op>::value > 0)>
struct UnitBytes {
  static constexpr int value = 0;
};
template <class Op, int BN>
struct UnitBytes<Op, BN, true> {
  static constexpr int value = 2 * Op::template unit_bytes<BN>();
};

// A fold Op's per-thread state (Op::Thread<BM, BN, NT>), or nothing.
struct NoThread {
  template <class... T>
  __device__ explicit NoThread(const T&...) {}
};
template <class Op, int BM, int BN, int NT, bool = (GroupLen<Op>::value > 0)>
struct ThreadOf {
  using type = NoThread;
};
template <class Op, int BM, int BN, int NT>
struct ThreadOf<Op, BM, BN, NT, true> {
  using type = typename Op::template Thread<BM, BN, NT>;
};

// A CTA's shared memory: a ring of slots (x tile, then raw bytes), as many
// (at most 8) as fit CTAS CTAs on an SM beside UNITS bytes of unit buffers
// after the ring, and 1024 bytes to align the base.
template <int BM, int RAW, int UNITS = 0, int CTAS = (BM == 256 ? 1 : 2)>
struct Layout {
  static constexpr int kX = BM * kRowBytes;                // x tile of a slot
  static constexpr int kRaw = (RAW + 1023) / 1024 * 1024;  // raw bytes of a slot
  static constexpr int kSlot = kX + kRaw;
  static constexpr int kBudget = (CTAS == 1 ? 227 : 113) * 1024 - 1024 - UNITS;
  static constexpr int kStages = kBudget / kSlot < 8 ? kBudget / kSlot : 8;
  static constexpr int kSmem = kStages * kSlot + UNITS + 1024;
  static_assert(kStages >= 3, "the ring needs three slots");
};

// What a tile (BM, BN) of an Op takes of an SM. Without a fold: one CTA at
// BM = 256 (128 accumulators a thread), else two (at most 128 registers a
// thread at BN = 128). With a fold (acc and tmp, BM / 2 each): one CTA at
// (128, 128), two at (64, 128).
template <class Op, int BM, int BN>
struct Tile {
  static constexpr int kGroup = GroupLen<Op>::value;
  static constexpr int kCtas = kGroup ? (BM == 128 && BN == 128 ? 1 : 2) : (BM == 256 ? 1 : 2);
  static constexpr int kMinBlocks = kGroup ? kCtas : (BM == 256 ? 1 : 256 / BN);
  static constexpr int kUnit = kGroup ? UnitBytes<Op, BN>::value / 2 : 0;
  using L = Layout<BM, Op::template raw_bytes<BN>(), UnitBytes<Op, BN>::value, kCtas>;
};

// grid (ceil(N / BN), ceil(M / BM), splits), 2 BN threads: warp w (of 4) of
// warpgroup wg owns weight columns n0 + 64 wg + 16 w .. + 15, all BM rows.
// Split z takes stages [z per, min((z + 1) per, stages)). Without a fold,
// at most 128 registers a thread below BM = 256.
//
// A fold Op (kGroup = G > 0) reads x in K order and runs each group's k16
// steps into tmp; once they have retired its per-thread state folds tmp
// into acc (th.fold). Its units of kUnitStages stages, which splits never
// cut, each have a buffer (two, in turns, after the ring) that th.load
// fills at the unit's first stage and th.decode reads in all of them.
template <class Op, int BM, int BN>
__global__ void __launch_bounds__(2 * BN, (Tile<Op, BM, BN>::kMinBlocks))
    mixed_gemm_kernel(Problem pb, typename Op::Args args) {
  constexpr int NT = 2 * BN;
  constexpr int kG = GroupLen<Op>::value;
  using L = typename Tile<Op, BM, BN>::L;
  constexpr int ST = L::kStages;
  extern __shared__ uint8_t smem_dyn[];
  uint8_t* ring = smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);

  const int tid = threadIdx.x, lane = tid & 31;
  const int cl = (tid >> 5) * 16 + (lane >> 2);  // the thread's first local weight column
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int s0 = blockIdx.z * pb.per;
  const int count = min(pb.per, pb.stages - s0);
  // fold Ops: x in K order (stage s is columns 64 s .. 64 s + 63), each
  // thread's row offsets, and the Op's per-thread state, hoisted out of the
  // K loop; unit u of stages [u U, (u + 1) U) in buffer u % 2
  constexpr int XC = BM * 8 / NT;  // x chunks a thread
  uint32_t xoff[kG > 0 ? XC : 1];  // element offsets in x (M K < 2^32)
  uint32_t xok = 0;                // bit k: the thread's row k of x exists
  if constexpr (kG > 0) {
#pragma unroll
    for (int k = 0; k < XC; ++k) {
      const int r = m0 + (tid >> 3) + k * (NT / 8);
      xok |= (uint32_t)(r < pb.M) << k;
      xoff[k] = (uint32_t)(r < pb.M ? r : 0) * pb.K + 8 * (tid & 7);
    }
  }
  typename ThreadOf<Op, BM, BN, NT>::type th(args, pb, m0, n0, tid);
  auto slot_at = [&](int i) {  // local stage i's slot (a fold Op's index math unsigned)
    if constexpr (kG > 0)
      return ring + (uint32_t)i % ST * L::kSlot;
    else
      return ring + (i % ST) * L::kSlot;
  };
  auto unit_of = [&](int s) {
    if constexpr (kG > 0)
      return ring + ST * L::kSlot + (uint32_t)s / Op::kUnitStages % 2 * Tile<Op, BM, BN>::kUnit;
    else
      return ring;
  };

  // local stage i into slot i % ST, one commit group; the thread's x chunk
  // is always c = tid % 8, of rows tid / 8 + k NT / 8
  auto load = [&](int i) {
    if (i < count) {
      uint8_t* slot = slot_at(i);
      const int s = s0 + i, c = tid & 7;
      if constexpr (kG > 0) {
#pragma unroll
        for (int k = 0; k < XC; ++k)
          cp_async16(slot + sw128(tid >> 3, c) + k * (NT / 8) * kRowBytes,
                     pb.x + (xoff[k] + (uint32_t)(kBK * s)), (xok >> k) & 1);
        th.load(args, pb, slot + L::kX, unit_of(s), (uint32_t)s % Op::kUnitStages == 0, s);
      } else {
        bool kv;
        const int col = Op::x_col(args, pb, s, c, kv);
        for_chunks<BM * 8, NT>(tid, [&](int e) {
          const int r = e >> 3;
          const bool valid = kv && m0 + r < pb.M;
          const __nv_bfloat16* src = valid ? pb.x + (size_t)(m0 + r) * pb.K + col : pb.x;
          cp_async16(slot + sw128(r, c), src, valid);
        });
        Op::template load_raw<BN, NT>(args, pb, slot + L::kX, s, n0, tid);
      }
    }
    cp_async_commit();
  };
  auto decode = [&](int i, uint32_t (&a)[4][4]) {
    const uint8_t* raw = slot_at(i) + L::kX;
    if constexpr (kG > 0)
      th.decode(args, raw, unit_of(s0 + i), s0 + i, a);
    else
      Op::template decode_a<BN>(args, raw, s0 + i, cl, lane, a);
  };

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  float tmp[kG > 0 ? BM / 2 : 1];  // a fold Op's group sums
#pragma unroll
  for (int i = 0; i < (kG > 0 ? BM / 2 : 1); ++i) tmp[i] = 0.f;
  // fold the group that step kk of local stage i ends, once its wgmma retired
  auto fold = [&](int i, int kk) {
    if constexpr (kG > 0) {
      wgmma_wait<0>();
      fence_acc(tmp);
      th.fold(args, slot_at(i) + L::kX, kk, tmp, acc);
    }
  };

  // Stage i: issue its four wgmma with the fragments in acur, wait for stage
  // i - 1's (one group stays queued on the tensor cores), then, past a
  // barrier that tells every warpgroup's stage i - 1 done and stage i + 1's
  // bytes landed (each thread's cp.async waited and fenced for the async
  // proxy first), fetch stage i + ST - 1 into the slot stage i - 1 left and
  // decode stage i + 1 into anext.
  //
  // A fold Op's wgmma run into tmp, scale-d 0 on a group's first step. A
  // group that ends inside the stage (g < 64) is folded there; one that ends
  // with it after stage i + 1's decode, which so overlaps the stage's wgmma.
  // The fold empties the tensor-core queue: with one CTA an SM nothing fills
  // it meanwhile. (Folding tmp in two halves, each beside the other half's
  // wgmma, made ptxas serialize every wgmma: C7514, accumulators read inside
  // a pipeline stage.)
  auto step = [&](int i, uint32_t (&acur)[4][4], uint32_t (&anext)[4][4]) {
    const uint64_t db = sw128_desc(slot_at(i));
    wgmma_fence();
    if constexpr (kG == 0) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs<BM>(acc, acur[kk], db + 2 * kk);
    } else {
      constexpr int SPG = kG / 16;  // k16 steps a group
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_rs<BM>(tmp, acur[kk], db + 2 * kk, (uint32_t)(4 * (s0 + i) + kk) % SPG != 0);
        if constexpr (SPG < 4) {
          if (kk < kBK / 16 - 1 && (kk + 1) % SPG == 0) {  // a group ends inside the stage
            wgmma_commit();
            fold(i, kk);
            wgmma_fence();
          }
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    cp_async_wait<ST - 3>();
    fence_proxy_async();
    __syncthreads();
    load(i + ST - 1);
    if (i + 1 < count) decode(i + 1, anext);
    if constexpr (kG > 0) {
      // the stage ends a group
      if ((uint32_t)(4 * (s0 + i) + 4) % (kG / 16) == 0) fold(i, kBK / 16 - 1);
    }
  };

  uint32_t a0[4][4], a1[4][4];
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) load(i);
  cp_async_wait<ST - 2>();
  fence_proxy_async();
  __syncthreads();
  decode(0, a0);
  for (int i = 0; i < count; i += 2) {
    step(i, a0, a1);
    if (i + 1 < count) step(i + 1, a1, a0);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

  // accumulator d[4i + 2h + e]: weight column cl + 8h, row 8i + 2 (lane % 4)
  // + e. Lanes 4 apart hold neighbouring columns: an even column's lane
  // trades its e = 1 value for its neighbour's e = 0 one and writes row
  // 2 (lane % 4) + 8i, columns (c, c + 1); the odd lane writes the next row.
  // A fold Op's last tile of columns may be ragged (N % 32 == 0).
  const bool odd = (lane >> 2) & 1;
  const int n = n0 + (cl & ~1);
  float* ws = pb.ws == nullptr ? nullptr : pb.ws + (size_t)blockIdx.z * pb.M * pb.N;
#pragma unroll
  for (int i = 0; i < BM / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      const float recv = __shfl_xor_sync(0xFFFFFFFFu, odd ? v0 : v1, 4);
      const float lo = odd ? recv : v0, hi = odd ? v1 : recv;
      const int r = m0 + 8 * i + 2 * (lane & 3) + odd;
      if (r >= pb.M || (kG > 0 && n + 8 * h >= pb.N)) continue;
      const size_t off = (size_t)r * pb.N + n + 8 * h;
      if (ws != nullptr)
        *reinterpret_cast<float2*>(ws + off) = make_float2(lo, hi);
      else
        *reinterpret_cast<uint32_t*>(pb.out + off) =
            pack_bf16x2(Op::finish(args, lo), Op::finish(args, hi));
    }
}

template <class Op, int BM, int BN>
cudaError_t launch_tile(const Problem& pb, const typename Op::Args& args, int splits,
                        cudaStream_t st) {
  constexpr int smem = Tile<Op, BM, BN>::L::kSmem;
  auto kern = mixed_gemm_kernel<Op, BM, BN>;
  // dynamic shared memory above 48 KB needs the opt-in (per device: every call)
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((pb.N + BN - 1) / BN, (pb.M + BM - 1) / BM, splits);
  kern<<<grid, 2 * BN, smem, st>>>(pb, args);
  return cudaGetLastError();
}

// The tiles the mainloop is built for, (BM, BN): without a fold (256, 128),
// (128, 128), (64, 128), (128, 64), (64, 64), N % BN == 0; with one (128,
// 128) and (64, 128), N % 32 == 0 and splits of whole units.
// Anything else is refused.
template <class Op>
cudaError_t launch(const Problem& pb, const typename Op::Args& args, int bm, int bn, int splits,
                   cudaStream_t st) {
  if (pb.per < 1 || splits < 1 || (splits - 1) * pb.per >= pb.stages ||
      splits * pb.per < pb.stages || (splits > 1) != (pb.ws != nullptr))
    return cudaErrorInvalidValue;
  if constexpr (GroupLen<Op>::value > 0) {
    if (pb.N % 32 || (splits > 1 && pb.per % Op::kUnitStages)) return cudaErrorInvalidValue;
    if (bm == 128 && bn == 128) return launch_tile<Op, 128, 128>(pb, args, splits, st);
    if (bm == 64 && bn == 128) return launch_tile<Op, 64, 128>(pb, args, splits, st);
  } else {
    if (pb.N % bn) return cudaErrorInvalidValue;
    if (bm == 256 && bn == 128) return launch_tile<Op, 256, 128>(pb, args, splits, st);
    if (bm == 128 && bn == 128) return launch_tile<Op, 128, 128>(pb, args, splits, st);
    if (bm == 64 && bn == 128) return launch_tile<Op, 64, 128>(pb, args, splits, st);
    if (bm == 128 && bn == 64) return launch_tile<Op, 128, 64>(pb, args, splits, st);
    if (bm == 64 && bn == 64) return launch_tile<Op, 64, 64>(pb, args, splits, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace mg
