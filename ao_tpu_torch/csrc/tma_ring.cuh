// The pieces of a TMA-fed ring of shared-memory stages for Hopper (sm_90a):
// 2-D and 3-D tensor maps encoded on the host, bulk tensor copies that
// complete on an mbarrier, and the mbarrier operations a producer and its
// consumers use. K17's prefill kernel (fp8_matmul.cu) and the attention
// mainloop of K8 and K16 (attn_mainloop.cuh) are built on them.
//
// Tensor maps are encoded by cuTensorMapEncodeTiled, a libcuda function.
// Its address comes from the runtime (cudaGetDriverEntryPoint*), once, so
// that no library links libcuda; cuda.h gives only its types. A kernel
// takes a map as a `const __grid_constant__ CUtensorMap` parameter.
//
// A ring of ST stages has two barriers a stage:
//  * full[s]: the stage's bytes have landed. The producer arrives with the
//    bytes it expects (expect_tx); each bulk copy completes its share of
//    them; the phase completes when every arrival and every byte has come.
//  * empty[s]: every consumer is done with the stage (its wgmma retired, its
//    shared-memory reads made), so the producer may refill it.
// Stage i of a loop uses slot i % ST in round i / ST: consumers wait on
// full with parity (i / ST) & 1, the producer on empty with the opposite
// parity, so that its first round finds every slot free.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialization visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` more from bulk copies this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival, made once every cp.async the thread started before it has
// landed (.noinc: the barrier's count includes it).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The box of `map` at (c0 innermost, c1) into shared memory at dst,
// completing its bytes on bar. Rows past the tensor's edge land as zeros.
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                        int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The box of a 3-D `map` at (c0 innermost, c1, c2), as load_2d.
__device__ __forceinline__ void load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                        int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// 4 bytes global -> shared by cp.async, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Warpgroup register budgets (multiples of 8, 24-256; the whole warpgroup
// executes them).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, or null if it cannot be had.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major (rows, row_bytes) byte matrix at `base` (16-byte
// aligned, row_bytes % 16 == 0) in boxes of box_rows x 128 bytes, with the
// 128-byte swizzle wgmma's K-major operands use (chunk c of row r at chunk
// c ^ (r % 8) of an 8-row, 1024-byte atom). Returns libcuda's CUresult,
// or CUDA_ERROR_NOT_FOUND without the entry point.
inline CUresult encode_rows_sw128(CUtensorMap* map, const void* base, uint64_t rows,
                                  uint64_t row_bytes, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {row_bytes, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {128, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The map of a bf16 tensor (n2, n1, n0), n0 innermost and contiguous, at
// `base` (16-byte aligned), n1 and n2 strided by stride1 and stride2 bytes
// (multiples of 16), in boxes of box1 x 64 values (128 bytes a row) at one
// index of n2, with the 128-byte swizzle. A box that runs past n1 lands as
// zeros and never reads the next n2 index's rows. Returns libcuda's CUresult,
// or CUDA_ERROR_NOT_FOUND without the entry point.
inline CUresult encode_bf16_3d_sw128(CUtensorMap* map, const void* base, uint64_t n0, uint64_t n1,
                                     uint64_t n2, uint64_t stride1, uint64_t stride2,
                                     uint32_t box1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {stride1, stride2};
  const cuuint32_t box[3] = {64, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace tma
