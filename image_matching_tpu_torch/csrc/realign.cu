// Parity realign fused with the 2x2 max pool of the 2x2 space-to-depth
// backbone.
//
// Replaces: image_matching_tpu/ops/pallas/realign.py, maxpool_realign_pallas
// (_kernel). U is the unaligned output of the in-level conv, (B, H+1, W1, 4C)
// with W1 >= W+1; parity group (py, px), channels (2py+px)*C .. +C, holds its
// value for output index (i, j) at U[i+py, j+px]. The kernel writes
//   out[b, i, j, c] = max(U[b, i,   j,   c],      U[b, i,   j+1, C+c],
//                         U[b, i+1, j,   2C+c],   U[b, i+1, j+1, 3C+c])
// as (B, H, W, C). A NaN in any tap gives NaN, as torch.maximum does.
//
// What bounds it on an H100: bytes. Every value of U is read once and a
// quarter as many are written (198 MB at U (4, 241, 321, 256) bf16, ~59 us
// at 3.35 TB/s) for three compares per output. So a thread takes 16 bytes of
// channels (8 bf16 or 4 f32) of one output pixel: four 16-byte loads, one
// 16-byte store, neighbouring threads on neighbouring channels, then
// neighbouring pixels. The four taps of a pixel lie in two rows of U, and
// the rows of neighbouring pixels are the same ones, so each row of U comes
// from device memory once and from cache the second time. U is addressed by
// its real row pitch W1 * 4C: no aligned width, no row blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// max that carries a NaN from either side
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ uint4 max16(uint4 a, uint4 b, float) {
  uint4 r;
  r.x = __float_as_uint(max_nan(__uint_as_float(a.x), __uint_as_float(b.x)));
  r.y = __float_as_uint(max_nan(__uint_as_float(a.y), __uint_as_float(b.y)));
  r.z = __float_as_uint(max_nan(__uint_as_float(a.z), __uint_as_float(b.z)));
  r.w = __float_as_uint(max_nan(__uint_as_float(a.w), __uint_as_float(b.w)));
  return r;
}

__device__ __forceinline__ uint32_t max_bf162(uint32_t a, uint32_t b) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&b);
  const float lo = max_nan(__low2float(x), __low2float(y));
  const float hi = max_nan(__high2float(x), __high2float(y));
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);  // exact: both are bf16 values
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint4 max16(uint4 a, uint4 b, __nv_bfloat16) {
  return make_uint4(max_bf162(a.x, b.x), max_bf162(a.y, b.y), max_bf162(a.z, b.z),
                    max_bf162(a.w, b.w));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxpool_realign_kernel(const T* __restrict__ u, T* __restrict__ out, int B, int H, int W,
                       int W1, int C) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = C / VEC;
  const int64_t total = (int64_t)B * H * W * chunks;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % chunks) * VEC;
  const int64_t pix = idx / chunks;
  const int j = (int)(pix % W);
  const int i = (int)((pix / W) % H);
  const int b = (int)(pix / ((int64_t)W * H));
  const int64_t row = (int64_t)W1 * 4 * C;  // elements per row of U
  const T* p = u + ((int64_t)b * (H + 1) + i) * row + (int64_t)j * 4 * C + c;
  const uint4 g00 = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 g01 = __ldg(reinterpret_cast<const uint4*>(p + 4 * C + C));
  const uint4 g10 = __ldg(reinterpret_cast<const uint4*>(p + row + 2 * C));
  const uint4 g11 = __ldg(reinterpret_cast<const uint4*>(p + row + 4 * C + 3 * C));
  const uint4 r = max16(max16(g00, g01, T()), max16(g10, g11, T()), T());
  *reinterpret_cast<uint4*>(out + pix * C + c) = r;
}

template <typename T>
int launch(const void* u, void* out, int B, int H, int W, int W1, int C, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t total = (int64_t)B * H * W * (C / VEC);
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  maxpool_realign_kernel<T><<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<T*>(out), B, H, W, W1, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int maxpool_realign_bf16(const void* u, void* out, int B, int H, int W, int W1, int C,
                                    void* stream) {
  return launch<__nv_bfloat16>(u, out, B, H, W, W1, C, stream);
}

extern "C" int maxpool_realign_f32(const void* u, void* out, int B, int H, int W, int W1, int C,
                                   void* stream) {
  return launch<float>(u, out, B, H, W, W1, C, stream);
}
