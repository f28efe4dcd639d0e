// Device helpers shared by the attention kernels (csrc/attention.cu and
// csrc/attention_bwd.cu) for sm_90a: 16-byte `cp.async` staging of 64-row
// bf16 tiles, `ldmatrix` and warp-level `mma.sync.m16n8k16` on padded
// row-major tiles, and warpgroup `wgmma` (m64n64k16) on tiles in the
// 128-byte swizzle. Each source includes it once, inside no namespace.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int T = 64;        // rows per staged tile, and own rows per block
constexpr int PAD = 8;       // bf16 of padding per staged row
constexpr int GROUP = 128;   // threads of a warpgroup: 4 warps, 16 own rows each

// True when batch element b has no valid key. Every thread of the block
// must call it.
__device__ __forceinline__ bool dead_batch(const uint8_t* mask, int b, int M) {
  if (mask == nullptr) return false;
  int any = 0;
  for (int j = threadIdx.x; j < M; j += blockDim.x) any |= mask[(int64_t)b * M + j];
  return !__syncthreads_or(any);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device memory to shared memory without passing
// through registers; `ok` false copies nothing and writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most PENDING of this thread's committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Barrier of one warpgroup (ids 1.., 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(grp + 1), "n"(GROUP) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. r[m] holds (row lane / 4, columns 2 (lane % 4)
// and + 1) of matrix m, or with .trans (rows 2 (lane % 4) and + 1, column
// lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// ------------------------------------------------------------------ padded tiles, mma.sync

template <int DH>
__host__ __device__ constexpr int tile_elems() { return T * (DH + PAD); }

// Rows [r0, r0 + T) of a row-strided (rows, DH) bf16 matrix into a padded
// row-major tile by `NTHREADS` threads, zeros past `rows`.
template <int DH, int NTHREADS>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* tile, const __nv_bfloat16* base, int64_t rs,
                                           int r0, int rows, int tid) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int c = tid; c < T * CH; c += NTHREADS) {
    const int row = c / CH, col = (c % CH) * 8;
    const bool ok = r0 + row < rows;
    cp_async_16(tile + row * (DH + PAD) + col, ok ? base + (r0 + row) * rs + col : base, ok);
  }
}

// This lane's ldmatrix address for the A fragments of the warp's 16 rows
// (from `wr`) of a staged tile, at k-step 0; k-step ks is 32 bytes on.
template <int DH>
__device__ __forceinline__ uint32_t a_lane_addr(const __nv_bfloat16* tile, int wr, int lane) {
  const int row = wr + (lane % 8) + ((lane / 8) % 2) * 8, col = (lane / 16) * 8;
  return smem_addr(tile + row * (DH + PAD) + col);
}

// A fragments of the warp's 16 rows (from `wr`) of a staged tile, per
// k-step: a0 (g, 2t), a1 (g+8, 2t), a2 (g, 2t+8), a3 (g+8, 2t+8).
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const __nv_bfloat16* tile, int wr, int lane) {
  const uint32_t addr = a_lane_addr<DH>(tile, wr, lane);
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) ldsm_x4(a[ks], addr + ks * 32);
}

// Byte offsets of this lane's row address in a padded tile, for the two
// ldmatrix patterns below: `nt` (16 tile rows as B of A . tile^T) and
// `tn` (16 tile rows as B of A . tile, transposed on the way in).
template <int DH>
__device__ __forceinline__ uint32_t nt_lane_offset(int lane) {
  return (((lane % 8) + (lane / 16) * 8) * (DH + PAD) + ((lane / 8) % 2) * 8) * 2;
}

template <int DH>
__device__ __forceinline__ uint32_t tn_lane_offset(int lane) {
  return (((lane % 8) + ((lane / 8) % 2) * 8) * (DH + PAD) + (lane / 16) * 8) * 2;
}

// c (16 own rows x all 64 tile rows) += A (16 x DH, read from shared memory at
// `a_addr`, `a_lane_addr`) . tile^T, the tile at `tile_nt` (its address plus
// the lane's offset): each k-step's A fragments are read once for the
// tile's 8 n-tiles, c[2 kk] and c[2 kk + 1] holding tile rows 16 kk ..
template <int DH>
__device__ __forceinline__ void mma_nt_tile(float (*c)[4], uint32_t a_addr, uint32_t tile_nt) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_addr + ks * 32);
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      uint32_t r[4];
      ldsm_x4(r, tile_nt + kk * 16 * (DH + PAD) * 2 + ks * 32);
      mma_bf16(c[2 * kk], a, r[0], r[1]);
      mma_bf16(c[2 * kk + 1], a, r[2], r[3]);
    }
  }
}

// c (16 own rows x 16 tile rows) += A (16 x DH, fragments) . tile^T, for the
// 16 tile rows at `tile_nt`: the tile's address in shared memory plus the
// lane's and the rows' offsets. One ldmatrix brings both 8-row halves'
// B fragments of a k-step.
template <int DH>
__device__ __forceinline__ void mma_nt(float (*c)[4], const uint32_t (*a)[4], uint32_t tile_nt) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t r[4];
    ldsm_x4(r, tile_nt + ks * 32);
    mma_bf16(c[0], a[ks], r[0], r[1]);
    mma_bf16(c[1], a[ks], r[2], r[3]);
  }
}

// mma_nt with A's fragments read from shared memory a k-step at a time, at
// `a_addr` (`a_lane_addr`), where holding them all in registers would cost
// 4 DH / 16 registers a thread.
template <int DH>
__device__ __forceinline__ void mma_nt_smem_a(float (*c)[4], uint32_t a_addr, uint32_t tile_nt) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t a[4], r[4];
    ldsm_x4(a, a_addr + ks * 32);
    ldsm_x4(r, tile_nt + ks * 32);
    mma_bf16(c[0], a, r[0], r[1]);
    mma_bf16(c[1], a, r[2], r[3]);
  }
}

// c (16 own rows x DH) += A (16 x 16: one k-step over 16 tile rows) . tile,
// for the 16 tile rows at `tile_tn` (address plus the lane's and the rows'
// offsets), B fragments transposed on the way in.
template <int DH>
__device__ __forceinline__ void mma_tn(float (*c)[4], const uint32_t* a, uint32_t tile_tn) {
#pragma unroll
  for (int np = 0; np < DH / 16; ++np) {
    uint32_t r[4];
    ldsm_x4_trans(r, tile_tn + np * 32);
    mma_bf16(c[2 * np], a, r[0], r[1]);
    mma_bf16(c[2 * np + 1], a, r[2], r[3]);
  }
}

// The C layout of a 16 x 16 f32 tile as the bf16 A fragment of one k-step.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float (*c)[4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

template <int NT>
__device__ __forceinline__ void zero(float (*c)[4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// This thread's NT x 4 partial sums to / from a group's scratch, laid out
// so that a warp's accesses are contiguous; thread `gt` of every group
// owns the same elements of the block's 64 x DH output.
template <int NT>
__device__ __forceinline__ void put_partial(float* scratch, const float (*c)[4], int gt) {
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) scratch[i * GROUP + gt] = c[i / 4][i % 4];
}

template <int NT>
__device__ __forceinline__ void add_partial(float (*c)[4], const float* scratch, int gt) {
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) c[i / 4][i % 4] += scratch[i * GROUP + gt];
}

// Write a 16 x DH f32 C tile (rows r0, r0+8) to a contiguous (., H*DH) bf16 output.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int b, int rows, int H, int h,
                                           int r0, int t, const float (*c)[4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* o = out + ((int64_t)b * rows + row) * (int64_t)(H * DH) + h * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8) = pack_bf16(c[n][2 * r], c[n][2 * r + 1]);
  }
}

// ------------------------------------------------------------------ swizzled tiles, wgmma (dh = 64)

// At dh = 64 a row of a tile is 128 bytes, the width of wgmma's 128-byte
// swizzle: tiles are (64, 64) bf16, 1024-byte aligned, 16-byte chunk c of
// row r at chunk c ^ (r % 8), and a warpgroup multiplies whole 64 x 64
// tiles straight from shared memory (m64n64k16, f32 accumulators in
// registers), with no ldmatrix and no fragment registers for B.
constexpr int WG_TILE_BYTES = T * 64 * 2;  // 8 KB

// Shared-memory matrix descriptor of a swizzled tile (or of a 32-byte /
// 2048-byte step into it): address / 16, 1024 bytes between 8-row groups,
// 128-byte swizzle. `+ 2 * ks` moves 16 columns on (K-major operands),
// `+ 128 * kk` 16 rows on (B read as (k, n) with n contiguous).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

#define WG_ACC(d)                                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),       \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),          \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),        \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),        \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_REGS                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, this thread's 32 of it) = or += A . B^T, A (64 x 16) and B
// (64 x 16) both row-major in shared memory
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A . B, A (64 x 16) from registers (the warp's 16 rows as mma.sync
// fragments), B (16 x 64) row-major in shared memory (read transposed)
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// Wait until at most PENDING of the warpgroup's committed batches of
// products are in flight; `d`, a finished batch's accumulators, is read
// only after it.
template <int PENDING>
__device__ __forceinline__ void wg_wait(float* d) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// cp.async's writes, made visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + 64) of a row-strided (rows, 64) bf16 matrix into a
// swizzled tile, zeros past `rows`.
template <int NTHREADS>
__device__ __forceinline__ void stage_swizzled(unsigned char* tile, const __nv_bfloat16* base, int64_t rs,
                                               int r0, int rows, int tid) {
  for (int c = tid; c < T * 8; c += NTHREADS) {
    const int row = c / 8, ch = c % 8;
    const bool ok = r0 + row < rows;
    cp_async_16(tile + row * 128 + ((ch ^ (row % 8)) * 16), ok ? base + (r0 + row) * rs + ch * 8 : base, ok);
  }
}

// The C layout of a 64 x 64 f32 tile (32 a thread) as the bf16 A fragments
// of its 4 k-steps.
__device__ __forceinline__ void wg_c_to_a(uint32_t (*a)[4], const float* c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(c[8 * kk + 2 * i], c[8 * kk + 2 * i + 1]);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// More than 48 KB of shared memory is dynamic and asked for by attribute; a
// size the card does not have comes back as the launch's error.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
