// Fused image entry conv: y = relu(conv3x3_same(img, w) * scale + shift).
//
// Replaces: image_matching_tpu/ops/pallas/entry_h.py, entry_h_fused_pallas
// (_kernel), the first ConvBNReLU of SuperPointBN with the conv bias and
// the inference BatchNorm folded into one per-channel f32 affine.
//
// Layout: img (B, H, W) in T; w (9, 64) f32 taps in (ky, kx) order, already
// rounded to T by the caller; scale, shift (64,) f32. Two outputs in T:
//   direct (H_LAYOUT = false): out (B, H, W, 64), channels-last, for the
//     plain backbone;
//   alignedH (H_LAYOUT = true, H even): out (B, H/2, W, 128) with
//     out[b, i, x, p * 64 + c] = y[b, 2i + p, x, c], the H-only
//     space-to-depth layout that the TPU kernel writes and the H-only
//     backbone reads (`ops/s2d_conv.space_to_depth_h`).
// Both run the same arithmetic in the same order for every pixel, so the
// alignedH output is space_to_depth_h of the direct one, bit for bit.
//
// What bounds it on an H100: writing the output. At (8, 480, 640) x 64 bf16
// the store is 315 MB (~94 us at 3.35 TB/s) against a 4.9 MB image read and
// 9 multiply-adds per output value (1.4 G, ~42 us of the f32 FMA pipe).
//
// Design (`entry_tile<T>`, bf16 and f32): persistent blocks walk tiles of
// 8 x 64 pixels. A block stages its tile's image with the 1-pixel halo in
// shared memory once (zeros outside the image, so no tap is bounds-checked).
// A thread owns 16 bytes of a pixel's output (8 channels in bf16, 4 in f32),
// so its taps and affine values stay in registers for the whole launch, and
// neighbouring threads cover a pixel's 64 channels: each store instruction of
// a warp writes 512 contiguous bytes, straight from registers, as 16-byte
// streaming stores. A thread walks pairs of pixels (two independent sums):
// in the direct layout 32 columns apart; in alignedH rows 2i and 2i + 1 of
// one column, whose two 16-byte stores go to the two parity halves of the
// same 256-byte (bf16) output pixel, so a warp's pair of store instructions
// fills 1 KiB contiguously. A pixel's 9 taps are shared-memory broadcasts. The products are f32 FMAs in (ky, kx) order from zero, then
// fmaf(acc, scale, shift), ReLU, one rounding to T: the same arithmetic, in
// the same order, as the plain version's convolution on the card (tensor
// cores, tried, sum the 9 products in another order: 129 of 157 M outputs of
// the main path's first layer one bf16 step apart, and the detector's top
// 1024 keypoints then differ from the plain path's).
#include "hopper.cuh"

namespace {

constexpr int CO = 64;
constexpr int THREADS = 256;
constexpr int TILE_H = 8, TILE_W = 64;       // pixels of a tile
constexpr int PITCH = TILE_W + 2 + 2;        // staged values per image row (68)

// A thread owns 16 bytes of a pixel's output: 8 channels in bf16, 4 in f32.
template <typename T>
struct Split {
  static constexpr int CH = 16 / sizeof(T);  // output channels per thread
  static constexpr int GROUPS = CO / CH;     // threads per pixel
  static constexpr int SLOTS = THREADS / GROUPS;  // pixel pairs in flight per block
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* y) {
  uint4 v;
  v.x = pack_bf16(y[0], y[1]);
  v.y = pack_bf16(y[2], y[3]);
  v.z = pack_bf16(y[4], y[5]);
  v.w = pack_bf16(y[6], y[7]);
  __stcs(reinterpret_cast<uint4*>(dst), v);
}
__device__ __forceinline__ void store16(float* dst, const float* y) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(y[0], y[1], y[2], y[3]));
}

// Two blocks an SM (at most 128 registers a thread): the alignedH bf16 form
// took 142 registers without the bound, one block an SM, and ran 14% slower.
template <typename T, bool H_LAYOUT>
__global__ void __launch_bounds__(THREADS, 2)
entry_tile(const T* __restrict__ img, const float* __restrict__ w, const float* __restrict__ scale,
           const float* __restrict__ shift, T* __restrict__ out, int H, int W, int tiles_x, int tiles_y,
           int tiles) {
  using S = Split<T>;
  constexpr int CH = S::CH;
  __shared__ float im[TILE_H + 2][PITCH];
  const int g = threadIdx.x % S::GROUPS, slot = threadIdx.x / S::GROUPS;
  float wr[9][CH], sc[CH], sh[CH];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int c = 0; c < CH; ++c) wr[t][c] = __ldg(w + t * CO + g * CH + c);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    sc[c] = __ldg(scale + g * CH + c);
    sh[c] = __ldg(shift + g * CH + c);
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int x0 = (tile % tiles_x) * TILE_W;
    const int y0 = ((tile / tiles_x) % tiles_y) * TILE_H;
    const int b = tile / (tiles_x * tiles_y);
    const T* src = img + (int64_t)b * H * W;
    __syncthreads();  // the previous tile's reads of `im` are done
    for (int i = threadIdx.x; i < (TILE_H + 2) * (TILE_W + 2); i += THREADS) {
      const int r = i / (TILE_W + 2), c = i % (TILE_W + 2);
      const int yy = y0 + r - 1, xx = x0 + c - 1;
      im[r][c] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? to_f(src[(int64_t)yy * W + xx]) : 0.f;
    }
    __syncthreads();

    // pixel pairs: direct, (col, col + 32) of a row; alignedH, rows
    // (2i, 2i + 1) of a column. Either way the warp's slots cover
    // neighbouring columns, so its stores are contiguous.
    for (int p = slot; p < TILE_H * TILE_W / 2; p += S::SLOTS) {
      const int row = H_LAYOUT ? 2 * (p / TILE_W) : p / (TILE_W / 2);
      const int col = H_LAYOUT ? p % TILE_W : p % (TILE_W / 2);
      const int dr = H_LAYOUT ? 1 : 0, dc = H_LAYOUT ? 0 : TILE_W / 2;  // the second pixel
      const int y = y0 + row;
      if (y >= H || x0 + col >= W) continue;
      const bool two = H_LAYOUT || x0 + col + dc < W;  // H is even in alignedH
      float acc[2][CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[0][c] = acc[1][c] = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float v0 = im[row + ky][col + kx], v1 = im[row + dr + ky][col + dc + kx];
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            acc[0][c] = fmaf(v0, wr[ky * 3 + kx][c], acc[0][c]);
            acc[1][c] = fmaf(v1, wr[ky * 3 + kx][c], acc[1][c]);
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[h][c] = fmaxf(fmaf(acc[h][c], sc[c], sh[c]), 0.f);
      if (H_LAYOUT) {  // out (B, H/2, W, 2 x 64): parity p at channel p * 64
        T* dst = out + (((int64_t)b * (H / 2) + y / 2) * W + x0 + col) * (2 * CO) + g * CH;
        store16(dst, acc[0]);
        store16(dst + CO, acc[1]);
      } else {
        T* dst = out + (((int64_t)b * H + y) * W + x0 + col) * CO + g * CH;
        store16(dst, acc[0]);
        if (two) store16(dst + dc * CO, acc[1]);
      }
    }
  }
}

template <typename T, bool H_LAYOUT>
int launch(const void* img, const void* w, const void* scale, const void* shift, void* out, int B, int H,
           int W, void* stream) {
  if (H_LAYOUT && H % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  static int resident = 0;  // blocks that fit on the card at once
  if (resident == 0) {
    int per_sm = 0, sms = 0, dev = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, entry_tile<T, H_LAYOUT>, THREADS, 0);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int tiles_x = (W + TILE_W - 1) / TILE_W, tiles_y = (H + TILE_H - 1) / TILE_H;
  const int tiles = B * tiles_x * tiles_y, blocks = tiles < resident ? tiles : resident;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  entry_tile<T, H_LAYOUT><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(img), static_cast<const float*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(out), H, W, tiles_x, tiles_y, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int entry_conv_bf16(const void* img, const void* w, const void* scale, const void* shift,
                               void* out, int B, int H, int W, void* stream) {
  return launch<__nv_bfloat16, false>(img, w, scale, shift, out, B, H, W, stream);
}

extern "C" int entry_conv_f32(const void* img, const void* w, const void* scale, const void* shift,
                              void* out, int B, int H, int W, void* stream) {
  return launch<float, false>(img, w, scale, shift, out, B, H, W, stream);
}

extern "C" int entry_conv_h_bf16(const void* img, const void* w, const void* scale, const void* shift,
                                 void* out, int B, int H, int W, void* stream) {
  return launch<__nv_bfloat16, true>(img, w, scale, shift, out, B, H, W, stream);
}

extern "C" int entry_conv_h_f32(const void* img, const void* w, const void* scale, const void* shift,
                                void* out, int B, int H, int W, void* stream) {
  return launch<float, true>(img, w, scale, shift, out, B, H, W, stream);
}
