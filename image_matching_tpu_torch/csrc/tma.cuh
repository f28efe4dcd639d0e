// Tensor copies (TMA) for sm_90a, shared by csrc/attention.cu and
// csrc/attention_bwd_chunked.cu: mbarriers in shared memory, 64-row x
// 64-value bf16 panels copied by one thread in the 128-byte swizzle that
// the wgmma descriptors of hopper.cuh read, and the host side that encodes
// an operand as a tensor map. Each source includes it once, after
// hopper.cuh, inside no namespace.
#pragma once

#include <cuda.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// This thread's arrival at `bar`, which completes its phase once `bytes` more have landed
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// This thread's arrival at `bar` (release: its earlier reads and writes come first)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Rows [r0, r0 + 64) of batch element b, the 64 PANELS values from column
// `col`, of the operand that `map` describes (`bf16_map`): a tensor copy of
// a 64-value panel each, `WG_TILE_BYTES` apart from `tile` on, in the
// 128-byte swizzle, rows past the operand's end as zeros; they complete on
// `bar`.
template <int PANELS>
__device__ __forceinline__ void load_panels(unsigned char* tile, const CUtensorMap* map, int col, int r0, int b,
                                            uint64_t* bar) {
#pragma unroll
  for (int p = 0; p < PANELS; ++p)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
        "[%5];\n" ::"r"(smem_addr(tile + p * WG_TILE_BYTES)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(col + 64 * p), "r"(r0), "r"(b), "r"(smem_addr(bar))
        : "memory");
}

// A 128-value chunk tile: two panels.
__device__ __forceinline__ void load_chunk(unsigned char* tile, const CUtensorMap* map, int col, int r0, int b,
                                           uint64_t* bar) {
  load_panels<2>(tile, map, col, r0, b, bar);
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no link to the
// driver library), or null.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (batches, rows, cols) bf16 operand, rows `rs` and batch elements `bs`
// values apart, as tensor copies of 64 rows x 64 values in the 128-byte
// swizzle, rows past `rows` read as zeros.
bool bf16_map(CUtensorMap* map, const __nv_bfloat16* base, int64_t bs, int64_t rs, int batches, int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batches};
  const cuuint64_t strides[2] = {(cuuint64_t)rs * 2, (cuuint64_t)(batches > 1 ? bs : rs * rows) * 2};
  const cuuint32_t box[3] = {64, T, 1}, step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<__nv_bfloat16*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
