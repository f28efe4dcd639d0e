// The s2d entry conv: a SAME 3x3 conv fused with 2x2 space-to-depth.
//
// Replaces: image_matching_tpu/ops/pallas/entry_conv.py, entry_conv_pallas
// (_kernel). x is a direct map (B, H, W, ci); the result is the aligned s2d
// map (B, H/2, W/2, 4co), channels (py, px, co):
//   out[b, i, j, (2py+px)*co + c] =
//       sum_{ky, kx, k} x[b, 2i+py+ky-1, 2j+px+kx-1, k] * w[ky, kx, k, c]
// with zeros outside the image: the ordinary 3x3 conv of full-resolution
// pixel (2i+py, 2j+px), stored at its cell's parity group. Products are taken
// in the input type, summed in f32 and rounded once; no bias, no epilogue (the
// model adds the bias to the rounded result).
//
// The TPU kernel multiplies a 16-tap im2col patch by a (16ci, 4co) matrix that
// is 9/16 dense. This one computes the function instead: each output pixel
// takes its 9 real taps and is written straight to its parity group, so no
// multiply-add is spent on a structural zero.
//
// What bounds it on an H100 (bf16, per call at batch 4): 64 -> 64 at 240x320
// is 22.6 GFLOP (23 us at 989 TFLOP/s) against 79 MB (24 us); 64 -> 128 at
// 120x160 and 128 -> 128 at 60x80 are bound by operations (11 us, 6 us); the
// 1 -> 64 image conv at 480x640 is bound by its 157 MB store (47 us).
//
// bf16, ci in {16, 32, 64, 128}, co % 64 == 0: `s2d_entry_wg`, an implicit
// GEMM on warpgroup wgmma (m64n64k16, f32 accumulators in registers). M is a
// tile of 4 x 16 output pixels (4 and 16 divide 60, 120, 240 rows and 80, 160,
// 320 columns: no ragged tile at the backbone's sizes), N = 64 output
// channels a product (128 a block where co % 128 == 0 and ci <= 64: two
// products share each A fragment), K = 9 ci. Blocks are persistent, one per
// SM: a block owns a 64- or 128-channel slice of the weights and copies all
// 9 taps of it into shared memory once (one `cp.async` batch behind one
// barrier, in the 128-byte swizzle, so wgmma reads B straight from it). Its
// warpgroups (4, 2 or 1, as shared memory allows) then each walk their own
// share of the tiles: a tile's input, with a 1-pixel halo, is staged by 16-byte
// `cp.async` (zero-fill by source size 0 does the borders) into the group's
// 2-stage ring, so the next tile's halo lands while this tile's products
// run. A (the warp's 16 pixels, shifted by the tap) is read from the halo by
// `ldmatrix` (pixels padded by 8 bf16: conflict-free); a tap's products are
// one wgmma batch, and the next tap's A fragments are loaded while it runs.
// The weights cross L2 once per block (132 x 74-147 KB) in place of once
// per 8 x 16 tile (177 MB at 64 -> 64 before). The C tile goes through the
// spent halo stage, so whole parity groups leave as 16-byte vectors, whole
// cells in a row where co == NBK.
//
// bf16, ci == 1, co % 64 == 0 (the image conv): `s2d_entry_image`, tensor
// cores with K = 9 padded to 16: each pixel's A row holds its 9 taps and 7
// zeros, built from an image tile staged once in shared memory; B, the (16 x
// 64) weights, sits in registers for the whole block; mma.sync.m16n8k16 with
// f32 accumulators (bf16 products are exact in f32, the zero taps add
// nothing). A warp owns a row pair, so each 16-pixel segment gives 8 whole
// s2d cells (4 KB contiguous at co = 64), staged in shared memory and stored
// as 16-byte vectors. It is bound by its store.
//
// f32 and every other width: `s2d_entry_ffma`, a register-tiled SIMT
// implicit GEMM on f32 FMAs (tensor cores would round f32 products to TF32).
// M = output pixels, N = output channels, K = 9 ci. A block takes TH x 32
// pixels (TH = 8, or 4 where 8-row tiles would leave the card short of
// blocks) x 64 channels, a thread 8 neighbouring pixels of one row x 8
// channels: 64 accumulators. K goes in stages of 8 input channels: the
// stage's halo ((TH + 2) x 34 pixels, a plane per channel) and its 9 x 8 x
// 64 weights go to shared memory (f32 pixels by 16-byte loads split over 4
// planes, or 4-byte `cp.async` where ci % 4 != 0; bf16 pixels converted; the
// weights by 16-byte `cp.async`), two stages deep, so the next chunk's
// copies are issued before this one is multiplied; zeros fill borders and
// ragged channels. For each (ky, channel) a thread reads its 10 halo values
// (its 8 pixels and their neighbours) once and uses them for all three kx
// taps against two float4 of weights: 192 FMAs for 9 shared-memory loads. Every output sums stage by stage, then ky, channel,
// kx: a fixed order, no atomics, reruns give the same bits. It is bound by
// f32 operations (2 x 9 ci co a pixel at 67 TFLOP/s: 0.338 ms at 64 -> 64,
// 240x320, batch 4), and reaches 62% of that bound there (0.543 ms; the
// same loop without the halo's copies 0.503).
//
// f32 or bf16, ci == 1, 256 a multiple of co / 8: `s2d_entry_simt_image`, a
// thread per pixel and 8 channels, its 72 weights in registers.
#include <type_traits>

#include "hopper.cuh"

namespace {

// ------------------------------------------------------------------ bf16, wgmma

constexpr int WG_TH = 4;                                // output rows per tile
constexpr int WG_TW = 16;                               // output columns per tile
constexpr int NB = 64;                                  // output channels of a weight slab
constexpr int HALO_PIX = (WG_TH + 2) * (WG_TW + 2);     // staged pixels per tile
constexpr int C_PITCH = NB + PAD;                       // bf16 per staged output pixel of 64 channels

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }

// A block computes NBK = 64 or 128 output channels from one or two 64-column
// weight slabs. Its warpgroups share the slabs, and each walks its own
// tiles through its own 2-stage ring: as many as fit in shared memory, up
// to 4 (at 64 -> 64, 4 groups: 0.054 ms, 3: 0.054, 2 or 1 in each of 2
// blocks: 0.060); at ci = 128 the slab (147 KB) leaves room for one.
template <int CI, int NBK>
struct WgShape {
  static constexpr int NH = NBK / NB;                   // 64-channel slabs
  static constexpr int NWG = CI >= 128 ? 1 : (NH == 2 && CI == 64) ? 2 : 4;
  static constexpr int PS = CI + PAD;                   // bf16 per staged halo pixel
  static constexpr int CP = NBK + PAD;                  // bf16 per staged output pixel
  static constexpr int STAGE_BYTES =
      round_up(max_of(HALO_PIX * PS * 2, WG_TH * WG_TW * CP * 2), 128);
  static constexpr int W_HALF = 9 * CI * NB * 2;        // a slab: 9 taps x CI rows of 128 bytes
  static constexpr int W_BYTES = NH * W_HALF;
  static constexpr int SMEM = 1024 + W_BYTES + NWG * 2 * STAGE_BYTES;
};

// w: (9 * CI, co) bf16, row (ky * 3 + kx) * CI + k. Rows of the block's 64
// channels go to row r of the swizzled slab: 16-byte chunk c at c ^ (r % 8).
template <int CI, int NH, int NTHREADS>
__device__ __forceinline__ void stage_weights(unsigned char* ws, const __nv_bfloat16* w, int co, int n0) {
  for (int c = threadIdx.x; c < NH * 9 * CI * 8; c += NTHREADS) {
    const int h = c / (9 * CI * 8), r = (c / 8) % (9 * CI), ch = c % 8;
    cp_async_16(ws + h * (9 * CI * NB * 2) + r * 128 + ((ch ^ (r % 8)) * 16),
                w + (int64_t)r * co + n0 + h * NB + ch * 8, true);
  }
}

// The tile's input rows y0 - 1 .. y0 + 4, columns x0 - 1 .. x0 + 16, all CI
// channels, zeros outside the image, by the 128 threads of a warpgroup.
template <int CI>
__device__ __forceinline__ void stage_halo(unsigned char* stage, const __nv_bfloat16* x, int H, int W,
                                           int tile, int tiles_x, int tiles_y, int gt) {
  constexpr int VPP = CI / 8;  // 16-byte chunks per pixel
  const int x0 = (tile % tiles_x) * WG_TW, y0 = ((tile / tiles_x) % tiles_y) * WG_TH;
  const int b = tile / (tiles_x * tiles_y);
  for (int c = gt; c < HALO_PIX * VPP; c += GROUP) {
    const int pix = c / VPP, ch = c % VPP;
    const int yy = y0 + pix / (WG_TW + 2) - 1, xx = x0 + pix % (WG_TW + 2) - 1;
    const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
    const __nv_bfloat16* src = ok ? x + (((int64_t)b * H + yy) * W + xx) * CI + ch * 8 : x;
    cp_async_16(stage + (pix * (CI + PAD) + ch * 8) * 2, src, ok);
  }
}

template <int CI, int NBK>
__global__ void __launch_bounds__(WgShape<CI, NBK>::NWG * GROUP)
s2d_entry_wg(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             __nv_bfloat16* __restrict__ out, int H, int W, int co, int tiles_x, int tiles_y,
             int tiles, int n_split) {
  using S = WgShape<CI, NBK>;
  constexpr int KS = CI / 16;  // k-steps per tap
  constexpr int NH = S::NH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ws = align_1024(smem_raw);

  const int grp = threadIdx.x / GROUP, gt = threadIdx.x % GROUP;
  const int warp = gt / 32, lane = gt % 32;
  const int g = lane / 4, t = lane % 4;
  unsigned char* stages = ws + S::W_BYTES + grp * 2 * S::STAGE_BYTES;  // this warpgroup's ring
  const int n0 = (blockIdx.x % n_split) * NBK;
  // the warpgroups of the card, S::NWG per block, share the tiles of a 64-channel slice
  const int step = gridDim.x / n_split * S::NWG;
  const int Ho = H / 2, Wo = W / 2;

  int tile = blockIdx.x / n_split * S::NWG + grp;
  if (tile < tiles) stage_halo<CI>(stages, x, H, W, tile, tiles_x, tiles_y, gt);
  stage_weights<CI, NH, S::NWG * GROUP>(ws, w, co, n0);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();  // cp.async writes, seen by wgmma's reads of the weights
  __syncthreads();     // the slab is whole; from here on each warpgroup goes its own way

  // this lane's ldmatrix row: pixel (lane % 8) + 8 ((lane / 8) % 2) of the
  // warp's 16, channels + 8 (lane / 16)
  const int a_pix = (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const uint32_t w_addr = smem_addr(ws);

  for (int s = 0; tile < tiles; tile += step, s ^= 1) {
    unsigned char* stage = stages + s * S::STAGE_BYTES;
    const int next = tile + step;
    if (next < tiles) stage_halo<CI>(stages + (s ^ 1) * S::STAGE_BYTES, x, H, W, next, tiles_x, tiles_y, gt);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's halo landed
    group_sync(grp);

    const uint32_t h_addr = smem_addr(stage) + ((warp * (WG_TW + 2) + a_pix) * S::PS + a_col) * 2;
    float acc[NH][32];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    uint32_t a[2][KS][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const uint32_t at = h_addr + ((ky * (WG_TW + 2) + kx) * S::PS) * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(a[tap & 1][ks], at + ks * 32);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int h = 0; h < NH; ++h)
          wgmma_rs(acc[h], a[tap & 1][ks], wg_desc(w_addr + h * S::W_HALF + (tap * CI + ks * 16) * 128));
      wg_commit();
#pragma unroll
      for (int h = 0; h < NH; ++h) wg_wait<1>(acc[h]);  // the previous tap's batch is done: its A registers are free
    }
#pragma unroll
    for (int h = 0; h < NH; ++h) wg_wait<0>(acc[h]);
    group_sync(grp);  // every warp's reads of the halo are done: it takes the C tile

    // acc[h][4j + e]: pixel g + 8 (e / 2) of the warp's row, channel 64h + 8j + 2t + e % 2
    __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(stage);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(cs + (warp * WG_TW + g) * S::CP + h * NB + 8 * j + 2 * t) =
            pack_bf16(acc[h][4 * j], acc[h][4 * j + 1]);
        *reinterpret_cast<uint32_t*>(cs + (warp * WG_TW + g + 8) * S::CP + h * NB + 8 * j + 2 * t) =
            pack_bf16(acc[h][4 * j + 2], acc[h][4 * j + 3]);
      }
    group_sync(grp);

    // 2 cell rows x 8 cells x 4 parity groups x NBK / 8 chunks of 16 bytes,
    // in the output's order: contiguous runs of whole cells where co == NBK
    constexpr int CPP = NBK / 8;  // chunks per pixel
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y, b = tile / (tiles_x * tiles_y);
    const int i0 = ty * (WG_TH / 2), j0 = tx * (WG_TW / 2);
#pragma unroll
    for (int it = 0; it < 4 * NH; ++it) {
      const int idx = it * GROUP + gt;
      const int ch = idx % CPP, pg = (idx / CPP) % 4, cell = (idx / (4 * CPP)) % 8, crow = idx / (32 * CPP);
      if (i0 + crow >= Ho || j0 + cell >= Wo) continue;
      const int pix = (2 * crow + pg / 2) * WG_TW + 2 * cell + pg % 2;
      const uint4 v = *reinterpret_cast<const uint4*>(cs + pix * S::CP + ch * 8);
      *reinterpret_cast<uint4*>(out + ((((int64_t)b * Ho + i0 + crow) * Wo + j0 + cell) * 4 + pg) * co + n0 + ch * 8) = v;
    }
    group_sync(grp);  // the stage is free for the prefetch after next
  }
  cp_async_wait<0>();
}

template <int CI, int NBK>
int launch_wg(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* out, int B, int H, int W,
              int co, cudaStream_t stream) {
  using S = WgShape<CI, NBK>;
  // once per instantiation: the dynamic shared memory limit (no static
  // shared memory in the kernel) and how many blocks fill the card
  static int resident = -1;
  if (resident < 0) {
    const cudaError_t attr = allow_smem(s2d_entry_wg<CI, NBK>, S::SMEM);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, s2d_entry_wg<CI, NBK>, S::NWG * GROUP, S::SMEM);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles_x = (W + WG_TW - 1) / WG_TW, tiles_y = (H + WG_TH - 1) / WG_TH;
  const int tiles = tiles_x * tiles_y * B, n_split = co / NBK;
  // persistent blocks, a whole number for every 64-channel slice, no more
  // warpgroups than tiles
  int per_slice = resident / n_split;
  if (per_slice > (tiles + S::NWG - 1) / S::NWG) per_slice = (tiles + S::NWG - 1) / S::NWG;
  if (per_slice < 1) per_slice = 1;
  s2d_entry_wg<CI, NBK><<<per_slice * n_split, S::NWG * GROUP, S::SMEM, stream>>>(x, w, out, H, W, co, tiles_x,
                                                                              tiles_y, tiles, n_split);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ bf16, ci == 1, mma.sync

constexpr int IM_WARPS = 8;                 // a row pair each
constexpr int IM_ROWS = 2 * IM_WARPS;       // image rows per block
constexpr int IM_COLS = 64;                 // image columns per block: 4 segments of 16
constexpr int IM_PITCH = IM_COLS + 2 + 6;   // bf16 per staged image row (72)

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// w: (9, co) bf16. Block: 16 image rows x 64 columns, 64 output channels.
__global__ void __launch_bounds__(IM_WARPS * 32)
s2d_entry_image(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ out, int H, int W, int co, int tiles_x, int tiles_y) {
  __shared__ __align__(16) __nv_bfloat16 img[IM_ROWS + 2][IM_PITCH];
  __shared__ __align__(16) __nv_bfloat16 cs[IM_WARPS][2 * 16][C_PITCH];

  const int tile = blockIdx.x;
  const int x0 = (tile % tiles_x) * IM_COLS;
  const int y0 = ((tile / tiles_x) % tiles_y) * IM_ROWS;
  const int b = tile / (tiles_x * tiles_y);
  const int n0 = blockIdx.y * NB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16 zero_bf = __float2bfloat16(0.f);

  // B fragments, k = tap: b0 (taps 2t, 2t+1; channel g of n-tile j), b1
  // (taps 2t+8, 2t+9: tap 8 for t == 0, zeros past it)
  uint32_t bw[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + 8 * j + g;
    bw[j][0] = pack_raw(w[(2 * t) * co + c], w[(2 * t + 1) * co + c]);
    bw[j][1] = t == 0 ? pack_raw(w[8 * co + c], zero_bf) : 0u;
  }

  const __nv_bfloat16* im = x + (int64_t)b * H * W;
  for (int i = threadIdx.x; i < (IM_ROWS + 2) * (IM_COLS + 2); i += IM_WARPS * 32) {
    const int r = i / (IM_COLS + 2), c = i % (IM_COLS + 2);
    const int yy = y0 + r - 1, xx = x0 + c - 1;
    img[r][c] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? im[(int64_t)yy * W + xx] : zero_bf;
  }
  __syncthreads();

  // the staged offsets of this thread's taps 2t and 2t + 1 (and 8)
  const int o0 = (2 * t) / 3 * IM_PITCH + (2 * t) % 3, o1 = (2 * t + 1) / 3 * IM_PITCH + (2 * t + 1) % 3;
  const int o8 = 2 * IM_PITCH + 2;
  const int Ho = H / 2, Wo = W / 2;
  const int prow = y0 / 2 + warp;  // the warp's cell row
  if (2 * prow >= H) return;
  const __nv_bfloat16* base = &img[0][0];
  for (int seg = 0; seg < IM_COLS / 16; ++seg) {
    const int sx = seg * 16;
    if (x0 + sx >= W) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const __nv_bfloat16* p = base + (2 * warp + r) * IM_PITCH + sx;
      uint32_t a[4];
      a[0] = pack_raw(p[g + o0], p[g + o1]);
      a[1] = pack_raw(p[g + 8 + o0], p[g + 8 + o1]);
      a[2] = t == 0 ? pack_raw(p[g + o8], zero_bf) : 0u;
      a[3] = t == 0 ? pack_raw(p[g + 8 + o8], zero_bf) : 0u;
      float acc[8][4];
      zero<8>(acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_bf16(acc[j], a, bw[j][0], bw[j][1]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(&cs[warp][r * 16 + g][8 * j + 2 * t]) = pack_bf16(acc[j][0], acc[j][1]);
        *reinterpret_cast<uint32_t*>(&cs[warp][r * 16 + g + 8][8 * j + 2 * t]) = pack_bf16(acc[j][2], acc[j][3]);
      }
    }
    __syncwarp();
    // 8 cells x 4 parity groups x 8 chunks of 16 bytes, in the output's order
    const int j0 = (x0 + sx) / 2;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int idx = it * 32 + lane;
      const int ch = idx % 8, grp = (idx / 8) % 4, cell = idx / 32;
      if (j0 + cell >= Wo) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(&cs[warp][(grp / 2) * 16 + 2 * cell + grp % 2][ch * 8]);
      *reinterpret_cast<uint4*>(out + ((((int64_t)b * Ho + prow) * Wo + j0 + cell) * 4 + grp) * co + n0 + ch * 8) = v;
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------------ SIMT, register-tiled (f32; other widths)

constexpr int FT_TW = 32;            // output columns of a tile: 4 segments of 8 pixels
constexpr int FT_NB = 64;            // output channels of a block
constexpr int FT_KC = 8;             // input channels a stage
constexpr int FT_PITCH = FT_TW + 4;  // floats per staged halo row (34 used), 16-byte aligned

// TH output rows a tile, a warp each. A stage holds KC channel planes of the
// (TH + 2) x (TW + 2) halo and the 9 x KC x 64 weight slab, in f32. A plane
// is 4 floats past a multiple of 32, so the 8 planes x 4 pixels that a warp
// writes while staging fall in 32 different banks.
template <int TH>
struct FtShape {
  static constexpr int THREADS = TH * 32;
  static_assert(THREADS % (FT_KC * FT_NB / 4) == 0, "the staging gives each thread fixed channels");
  static constexpr int HALO = (TH + 2) * (FT_TW + 2);
  static constexpr int PLANE = round_up((TH + 2) * FT_PITCH - 4, 32) + 4;
  static constexpr int HALO_FLOATS = FT_KC * PLANE;
  static constexpr int STAGE = HALO_FLOATS + 9 * FT_KC * FT_NB;
  static constexpr int SMEM = 2 * STAGE * 4;
};

// Input channels k0 .. k0 + KC - 1 of the tile's halo and of the weights of
// its 64 output channels into stage `st`, zeros outside the image and past
// ci and co. f32 pixels with ci % 4 == 0 go by 16-byte loads through
// registers, split over 4 planes (cheaper than 4-byte `cp.async`: 0.5430
// against 0.5735 ms at 64 -> 64); other f32 pixels by 4-byte `cp.async` and
// bf16 ones through registers, converted, a channel a copy; the weight rows
// (f32 for both) by 16-byte `cp.async`. The block's threads are a multiple
// of 128 = 16 x KC, so the channels a thread copies are the same in every
// pixel and every tap.
template <typename E, int TH>
__device__ __forceinline__ void ft_stage(float* st, const E* x, const float* w, int H, int W, int ci, int co,
                                         int b, int y0, int x0, int n0, int k0) {
  using S = FtShape<TH>;
  constexpr int HW = FT_TW + 2;  // pixels a halo row
  bool quads = false;
  if constexpr (std::is_same<E, float>::value) quads = ci % 4 == 0;
  if (quads) {
    // a pair of threads a pixel (channels 4q .. 4q + 3); two pixels' loads in
    // flight before their stores (more would spill)
    const int q = threadIdx.x % 2;
#pragma unroll 1
    for (int p0 = threadIdx.x / 2; p0 < S::HALO; p0 += S::THREADS) {
      float4 v[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int pix = p0 + m * (S::THREADS / 2);
        const int yy = y0 - 1 + pix / HW, xx = x0 - 1 + pix % HW;
        const bool ok = pix < S::HALO && k0 + 4 * q < ci && yy >= 0 && yy < H && xx >= 0 && xx < W;
        v[m] = ok ? __ldg(reinterpret_cast<const float4*>(x + (((int64_t)b * H + yy) * W + xx) * ci + k0 + 4 * q))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int pix = p0 + m * (S::THREADS / 2);
        if (pix >= S::HALO) break;
        float* d = st + 4 * q * S::PLANE + pix / HW * FT_PITCH + pix % HW;
        d[0] = v[m].x, d[S::PLANE] = v[m].y, d[2 * S::PLANE] = v[m].z, d[3 * S::PLANE] = v[m].w;
      }
    }
  } else {
    // a thread a channel (8 neighbouring threads: 8 channels of a pixel),
    // STEP pixels apart: 16 or 32, under a halo row
    constexpr int STEP = S::THREADS / FT_KC;
    const int k = threadIdx.x % FT_KC;
    const bool k_ok = k0 + k < ci;
    const E* xb = x + (int64_t)b * H * W * ci + k0 + k;
    float* dst = st + k * S::PLANE;
    int hr = (threadIdx.x / FT_KC) / HW, hc = (threadIdx.x / FT_KC) % HW;
#pragma unroll 1
    for (int pix = threadIdx.x / FT_KC; pix < S::HALO; pix += STEP) {
      const int yy = y0 - 1 + hr, xx = x0 - 1 + hc;
      const bool ok = k_ok && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const E* src = ok ? xb + ((int64_t)yy * W + xx) * ci : x;
      if constexpr (std::is_same<E, float>::value) cp_async_4(dst + hr * FT_PITCH + hc, src, ok);
      else dst[hr * FT_PITCH + hc] = ok ? __bfloat162float(*src) : 0.f;
      hc += STEP;
      if (hc >= HW) hc -= HW, ++hr;
    }
  }
  const int c4 = threadIdx.x % (FT_NB / 4), kw = (threadIdx.x / (FT_NB / 4)) % FT_KC;
  const bool w_ok = k0 + kw < ci && n0 + 4 * c4 < co;
  const float* wsrc = w + (int64_t)(k0 + kw) * co + n0 + 4 * c4;
  float* wdst = st + S::HALO_FLOATS + kw * FT_NB + 4 * c4;
#pragma unroll 1
  for (int tap = threadIdx.x / (FT_KC * FT_NB / 4); tap < 9; tap += S::THREADS / (FT_KC * FT_NB / 4))
    cp_async_16(wdst + tap * FT_KC * FT_NB, w_ok ? wsrc + (int64_t)tap * ci * co : w, w_ok);
}

__device__ __forceinline__ void store4(float* dst, const float* y) {
  *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* y) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
}

// w: (9 * ci, co) f32, row (ky * 3 + kx) * ci + channel, already rounded to E.
// Block: TH x 32 output pixels x 64 channels. Thread (row r = warp, segment
// s = lane / 8, channel group g = lane % 8): pixels x0 + 8s .. + 7 of row r,
// channels 4g .. 4g + 3 and 32 + 4g .. 32 + 4g + 3 (so a warp's weight loads
// are 8 different float4 in a row: one conflict-free wavefront).
template <typename E, int TH>
__global__ void __launch_bounds__(TH * 32, 512 / (TH * 32))
s2d_entry_ffma(const E* __restrict__ x, const float* __restrict__ w, E* __restrict__ out, int H, int W, int ci,
               int co, int tiles_x, int tiles_y) {
  using S = FtShape<TH>;
  extern __shared__ __align__(16) float fsm[];
  const int tile = blockIdx.x;
  const int x0 = (tile % tiles_x) * FT_TW, y0 = ((tile / tiles_x) % tiles_y) * TH;
  const int b = tile / (tiles_x * tiles_y);
  const int n0 = blockIdx.y * FT_NB;
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane % 8, s = lane / 8;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

  const int chunks = (ci + FT_KC - 1) / FT_KC;
  ft_stage<E, TH>(fsm, x, w, H, W, ci, co, b, y0, x0, n0, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks)
      ft_stage<E, TH>(fsm + ((c + 1) & 1) * S::STAGE, x, w, H, W, ci, co, b, y0, x0, n0, (c + 1) * FT_KC);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's stage landed
    __syncthreads();
    const float* hs = fsm + (c & 1) * S::STAGE + r * FT_PITCH + 8 * s;
    const float* ws = fsm + (c & 1) * S::STAGE + S::HALO_FLOATS + 4 * g;
    // each output sums chunk by chunk, then ky, channel, kx: a fixed order
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int k = 0; k < FT_KC; ++k) {
        // the 10 halo values of this row's 8 pixels and their neighbours,
        // used by all three kx taps
        const float* h = hs + k * S::PLANE + ky * FT_PITCH;
        const float4 h0 = *reinterpret_cast<const float4*>(h);
        const float4 h1 = *reinterpret_cast<const float4*>(h + 4);
        const float2 h2 = *reinterpret_cast<const float2*>(h + 8);
        const float v[10] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w, h2.x, h2.y};
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wp = ws + ((ky * 3 + kx) * FT_KC + k) * FT_NB;
          const float4 wa = *reinterpret_cast<const float4*>(wp);
          const float4 wb = *reinterpret_cast<const float4*>(wp + 32);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < 8; ++p)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[p][j] = fmaf(v[p + kx], wv[j], acc[p][j]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage: it takes the chunk after next
  }

  // a thread's 8 pixels are 4 cells of one parity row; each 4-channel run is
  // one store (16 bytes in f32), the 8 runs of a segment's threads contiguous
  const int y = y0 + r, Ho = H / 2, Wo = W / 2;
  if (y >= H) return;
  E* row = out + (((int64_t)b * Ho + y / 2) * Wo) * 4 * co + (2 * (y & 1)) * co + n0 + 4 * g;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int xp = x0 + 8 * s + p;
    if (xp >= W) break;
    E* o = row + ((int64_t)(xp / 2) * 4 + (p & 1)) * co;
    if (n0 + 4 * g < co) store4(o, acc[p]);
    if (n0 + 32 + 4 * g < co) store4(o + 32, acc[p] + 4);
  }
}

template <typename E, int TH>
int launch_ffma(const E* x, const float* w, E* out, int B, int H, int W, int ci, int co, cudaStream_t stream) {
  using S = FtShape<TH>;
  static const cudaError_t attr = allow_smem(s2d_entry_ffma<E, TH>, S::SMEM);  // once per instantiation
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles_x = (W + FT_TW - 1) / FT_TW, tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y * B, (co + FT_NB - 1) / FT_NB);
  s2d_entry_ffma<E, TH><<<grid, S::THREADS, S::SMEM, stream>>>(x, w, out, H, W, ci, co, tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}

// Tiles of 8 rows where that gives the card at least 4 blocks an SM, else of
// 4 rows (twice the blocks, so fewer SMs idle in the last wave). On this
// kernel's first build: 128 -> 128 at 60x80, batch 4, 0.205 ms in 4-row
// tiles against 0.246 in 8-row ones; 64 -> 64 at 240x320 0.612 against
// 0.621 the other way round.
int ffma_rows(int B, int H, int W, int co) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int64_t blocks8 = (int64_t)((W + FT_TW - 1) / FT_TW) * ((H + 7) / 8) * B * ((co + FT_NB - 1) / FT_NB);
  return blocks8 >= 4LL * sms ? 8 : 4;
}

// ------------------------------------------------------------------ SIMT, ci == 1

constexpr int CH_GROUP = 8;    // output channels per thread
constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void store8(float* dst, const float* y) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(y[0], y[1], y[2], y[3]);
  d[1] = make_float4(y[4], y[5], y[6], y[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* y) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]),
                                              pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
}

// Decode item -> (channel group, pixel in s2d order (b, i, j, py, px)). Items
// are counted in 32 bits (the launcher refuses more), which keeps the
// divisions cheap.
struct Item {
  int gch, b, y, x;
  uint32_t p;
};

__device__ __forceinline__ Item decode(uint32_t item, uint32_t groups, uint32_t Ho, uint32_t Wo) {
  Item it;
  it.gch = (int)(item % groups);
  it.p = item / groups;
  const uint32_t cell = it.p >> 2;
  it.x = 2 * (int)(cell % Wo) + (int)(it.p & 1);
  it.y = 2 * (int)((cell / Wo) % Ho) + (int)((it.p >> 1) & 1);
  it.b = (int)(cell / (Wo * Ho));
  return it;
}

// ci == 1, THREADS % (co / 8) == 0: a thread's channel group never changes in
// its grid-stride loop, so its 72 taps are loaded into registers once.
template <typename E>
__global__ void __launch_bounds__(THREADS)
s2d_entry_simt_image(const E* __restrict__ x, const float* __restrict__ w, E* __restrict__ out,
                     int B, int H, int W, int co) {
  const uint32_t groups = co / CH_GROUP, Ho = H / 2, Wo = W / 2;
  const int gch = threadIdx.x % groups;
  float wr[9][CH_GROUP];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int c = 0; c < CH_GROUP; ++c) wr[tap][c] = __ldg(w + tap * co + gch * CH_GROUP + c);
  const uint32_t total = (uint32_t)B * H * W * groups, stride = gridDim.x * THREADS;
  for (uint32_t item = blockIdx.x * THREADS + threadIdx.x; item < total; item += stride) {
    const Item it = decode(item, groups, Ho, Wo);  // it.gch == gch
    const E* im = x + (int64_t)it.b * H * W;
    float acc[CH_GROUP];
#pragma unroll
    for (int c = 0; c < CH_GROUP; ++c) acc[c] = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int yy = it.y + ky - 1;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int xx = it.x + kx - 1;
        const float v = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                            ? load_f(im + (int64_t)yy * W + xx) : 0.f;
#pragma unroll
        for (int c = 0; c < CH_GROUP; ++c) acc[c] = fmaf(v, wr[ky * 3 + kx][c], acc[c]);
      }
    }
    store8(out + (int64_t)it.p * co + gch * CH_GROUP, acc);
  }
}

int grid_for(int64_t total) {
  int64_t blocks = (total + THREADS - 1) / THREADS;
  const int64_t cap = 132 * 16;  // enough resident blocks to fill every SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

template <typename E>
int launch_simt(const void* x, const void* w, void* out, int B, int H, int W, int ci, int co,
                void* stream) {
  if (co % CH_GROUP != 0 || H % 2 != 0 || W % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = co / CH_GROUP;
  const E* xp = static_cast<const E*>(x);
  const float* wp = static_cast<const float*>(w);
  E* op = static_cast<E*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ci == 1 && THREADS % groups == 0) {
    // items are counted in 32 bits, with room for one grid stride past the end
    if ((int64_t)B * H * W * groups >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    s2d_entry_simt_image<E><<<grid_for((int64_t)B * H * W * groups), THREADS, 0, s>>>(xp, wp, op, B, H, W, co);
    return static_cast<int>(cudaGetLastError());
  }
  return ffma_rows(B, H, W, co) == 8 ? launch_ffma<E, 8>(xp, wp, op, B, H, W, ci, co, s)
                                     : launch_ffma<E, 4>(xp, wp, op, B, H, W, ci, co, s);
}

}  // namespace

// bf16, ci in {16, 32, 64, 128}, co % 64 == 0; w (3, 3, ci, co) contiguous.
extern "C" int s2d_entry_conv_bf16_wg(const void* x, const void* w, void* out, int B, int H, int W,
                                      int ci, int co, void* stream) {
  if (co % NB != 0 || H % 2 != 0 || W % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128 channels a block where they fit (one A fragment feeds two products:
  // 0.0264 against 0.0288 ms at 64 -> 128); a ci = 128 slab pair would not
  if (co % 128 == 0) switch (ci) {
    case 16: return launch_wg<16, 128>(xp, wp, op, B, H, W, co, s);
    case 32: return launch_wg<32, 128>(xp, wp, op, B, H, W, co, s);
    case 64: return launch_wg<64, 128>(xp, wp, op, B, H, W, co, s);
    default: break;
  }
  switch (ci) {
    case 16: return launch_wg<16, 64>(xp, wp, op, B, H, W, co, s);
    case 32: return launch_wg<32, 64>(xp, wp, op, B, H, W, co, s);
    case 64: return launch_wg<64, 64>(xp, wp, op, B, H, W, co, s);
    case 128: return launch_wg<128, 64>(xp, wp, op, B, H, W, co, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16, ci == 1, co % 64 == 0; w (3, 3, 1, co) contiguous.
extern "C" int s2d_entry_conv_bf16_image(const void* x, const void* w, void* out, int B, int H, int W,
                                         int co, void* stream) {
  if (co % NB != 0 || H % 2 != 0 || W % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (W + IM_COLS - 1) / IM_COLS, tiles_y = (H + IM_ROWS - 1) / IM_ROWS;
  const dim3 grid(tiles_x * tiles_y * B, co / NB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  s2d_entry_image<<<grid, IM_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), H, W, co, tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int s2d_entry_conv_bf16_simt(const void* x, const void* w, void* out, int B, int H,
                                        int W, int ci, int co, void* stream) {
  return launch_simt<__nv_bfloat16>(x, w, out, B, H, W, ci, co, stream);
}

extern "C" int s2d_entry_conv_f32_simt(const void* x, const void* w, void* out, int B, int H,
                                       int W, int ci, int co, void* stream) {
  return launch_simt<float>(x, w, out, B, H, W, ci, co, stream);
}
