// Fused image entry conv: y = relu(conv3x3_same(img, w) * scale + shift).
//
// Replaces: image_matching_tpu/ops/pallas/entry_h.py, entry_h_fused_pallas
// (_kernel), the first ConvBNReLU of SuperPointBN with the conv bias and
// the inference BatchNorm folded into one per-channel f32 affine.
//
// Layout: img (B, H, W) in T; w (9, 64) f32 taps in (ky, kx) order, already
// rounded to T by the caller; scale, shift (64,) f32; out (B, H, W, 64) in T,
// the direct channels-last layout (not the TPU's H-space-to-depth layout).
//
// What bounds it on an H100: writing the output. At (8, 480, 640) x 64 bf16
// the store is 315 MB (~94 us at 3.35 TB/s) against a 4.9 MB image read and
// 9 FMAs per output value. The design therefore spends nothing on the input
// side and makes every store a full 16-byte, fully coalesced write:
//   * one thread owns 8 consecutive channels of one pixel; 8 neighbouring
//     threads cover the pixel's 64 channels, so a warp writes 4 whole pixels
//     (512 contiguous bytes in bf16);
//   * a thread's channel group never changes in its grid-stride loop, so its
//     72 taps and 16 affine values are loaded into registers once;
//   * the 9 image taps come through the read-only cache (neighbouring pixels
//     share them, and the 8 threads of one pixel read the same address);
//   * the accumulator and the epilogue stay in f32; one rounding to T.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CO = 64;
constexpr int GROUP = 8;             // channels per thread
constexpr int GROUPS = CO / GROUP;   // threads per pixel
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
  uint4 v;
  __nv_bfloat162 h0 = __floats2bfloat162_rn(y[0], y[1]);
  __nv_bfloat162 h1 = __floats2bfloat162_rn(y[2], y[3]);
  __nv_bfloat162 h2 = __floats2bfloat162_rn(y[4], y[5]);
  __nv_bfloat162 h3 = __floats2bfloat162_rn(y[6], y[7]);
  v.x = *reinterpret_cast<uint32_t*>(&h0);
  v.y = *reinterpret_cast<uint32_t*>(&h1);
  v.z = *reinterpret_cast<uint32_t*>(&h2);
  v.w = *reinterpret_cast<uint32_t*>(&h3);
  *reinterpret_cast<uint4*>(dst) = v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
entry_conv_kernel(const T* __restrict__ img, const float* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  T* __restrict__ out, int B, int H, int W) {
  const int g = threadIdx.x % GROUPS;
  float wr[9][GROUP], sc[GROUP], sh[GROUP];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int c = 0; c < GROUP; ++c) wr[t][c] = __ldg(w + t * CO + g * GROUP + c);
#pragma unroll
  for (int c = 0; c < GROUP; ++c) {
    sc[c] = __ldg(scale + g * GROUP + c);
    sh[c] = __ldg(shift + g * GROUP + c);
  }

  const int npix = B * H * W;
  const int per_block = THREADS / GROUPS;
  for (int p = blockIdx.x * per_block + threadIdx.x / GROUPS; p < npix;
       p += gridDim.x * per_block) {
    const int x = p % W;
    const int y = (p / W) % H;
    const T* im = img + (p - y * W - x);  // start of this pixel's image
    float acc[GROUP];
#pragma unroll
    for (int c = 0; c < GROUP; ++c) acc[c] = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int yy = y + ky - 1;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int xx = x + kx - 1;
        const float v = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                            ? load_f(im + yy * W + xx) : 0.f;
#pragma unroll
        for (int c = 0; c < GROUP; ++c) acc[c] = fmaf(v, wr[ky * 3 + kx][c], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < GROUP; ++c) acc[c] = fmaxf(fmaf(acc[c], sc[c], sh[c]), 0.f);
    store8(out + (int64_t)p * CO + g * GROUP, acc);
  }
}

template <typename T>
int launch(const void* img, const void* w, const void* scale, const void* shift,
           void* out, int B, int H, int W, void* stream) {
  const int npix = B * H * W;
  const int per_block = THREADS / GROUPS;
  int blocks = (npix + per_block - 1) / per_block;
  const int cap = 132 * 16;  // enough resident blocks to fill every SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  entry_conv_kernel<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(img), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(out), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int entry_conv_bf16(const void* img, const void* w, const void* scale,
                               const void* shift, void* out, int B, int H, int W,
                               void* stream) {
  return launch<__nv_bfloat16>(img, w, scale, shift, out, B, H, W, stream);
}

extern "C" int entry_conv_f32(const void* img, const void* w, const void* scale,
                              const void* shift, void* out, int B, int H, int W,
                              void* stream) {
  return launch<float>(img, w, scale, shift, out, B, H, W, stream);
}
