// A probe of the shared-memory pipe, not a kernel of any path: what one
// 16-byte load a lane (LDS.128) costs a warp, by the lane pattern of its
// addresses. The f32 FFMA tiles (csrc/ffma.cuh) feed 64 FMAs a thread from
// 8 such loads per 4 dims, so if every LDS.128 took four of the SM's
// shared-memory cycles whatever its lanes share, the loads would cap a
// 4 x 4 tile near half the FMA pipe, and an 8 x 8 tile would be the lever;
// if a load's cost follows the bytes its lanes ask for, they do not.
//
// Patterns, rows of a tile with the FFMA tiles' pitch of 68 floats (64 + 4):
//   0: 8 rows on distinct banks, each read by 4 lanes (nt_product's own operand);
//   1: 4 rows, each broadcast to 8 lanes (nt_product's looped operand);
//   2: 32 distinct rows (512 bytes);
//   3: one row, broadcast to all 32 lanes.
// Every block (one an SM: its dynamic shared memory keeps a second out) runs
// 32 warps of `iters` x 16 independent loads (`ld.volatile`, so that the
// assembler keeps every one, 16 bytes wide); thread 0 writes the block's
// SM clock cycles, so cycles / (32 x 16 x iters) is the SM's cycles per
// warp-wide LDS.128.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PITCH = 68, ROWS = 64, UNROLL = 16, THREADS = 1024;

__device__ __forceinline__ int lane_row(int pattern, int lane) {
  switch (pattern) {
    case 0: return lane % 8;
    case 1: return lane / 8;
    case 2: return lane;
    default: return 0;
  }
}

__global__ void __launch_bounds__(THREADS, 1) lds_probe_kernel(int pattern, int iters, float* out,
                                                               long long* cycles) {
  extern __shared__ __align__(16) float tile[];
  for (int i = threadIdx.x; i < ROWS * PITCH; i += THREADS) tile[i] = i * 1e-3f;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tile + lane_row(pattern, lane) * PITCH));
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    // every lane steps along its row alike (the pattern's banks, shifted), by
    // an amount that changes with `it`; `ld.volatile` keeps the assembler
    // from hoisting the loads out of the loop or narrowing them to the one
    // float a load adds up
    const uint32_t a = base + (it % 4) * 64;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float x, y, z, w;
      asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(x), "=f"(y), "=f"(z), "=f"(w)
                   : "r"(a + u * 16));
      (void)y, (void)z, (void)w;
      acc[u % 4] += x;
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  out[blockIdx.x * THREADS + threadIdx.x] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

// out: blocks x 1024 floats; cycles: blocks int64. `smem_bytes` (at least
// the tile's 17 KB) sets how many blocks an SM can hold.
extern "C" int lds_probe(int pattern, int iters, void* out, void* cycles, int blocks, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(lds_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  lds_probe_kernel<<<blocks, THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      pattern, iters, static_cast<float*>(out), static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}
