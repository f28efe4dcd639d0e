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
// multiply-add is spent on a structural zero. Borders are masked in the
// kernel; the input is not padded.
//
// What bounds it on an H100 (bf16, per call at batch 4): 64 -> 64 at 240x320
// is 22.6 GFLOP (23 us at 989 TFLOP/s) against 79 MB (23 us); 64 -> 128 at
// 120x160 and 128 -> 128 at 60x80 are bound by operations (11 us, 6 us); the
// 1 -> 64 image conv at 480x640 is bound by its 157 MB store (47 us).
//
// bf16 with ci % 16 == 0 and co % 64 == 0: `s2d_entry_mma`, an implicit GEMM
// on tensor cores through warp-level mma.sync.m16n8k16 with f32 accumulators.
// M is a tile of 8 x 16 output pixels, N 64 output channels, K = 9 * ci. A
// block of 4 warps stages the tile's input with a 1-pixel halo in shared
// memory, CK input channels at a time, and one (64 x CK) slab of the weights
// per tap. A warp owns 2 rows of 16 pixels: a tap's A fragments are plain
// shifted reads of the halo tile (no im2col copy), B fragments come from the
// slab. Both are padded by 8 bf16 per pixel / row, which makes every fragment
// read conflict-free (word stride 36 or 12: 4g + t, or 12g + t, hits 32
// different banks). No cp.async, TMA or wgmma yet: loads and math alternate.
//
// Everything else (f32; the 1-channel image; widths that do not fill the
// tiles): `s2d_entry_simt`, plain FMAs. A thread owns 8 output channels of
// one pixel, and pixels are walked in s2d order (cell, py, px), so a warp
// writes whole contiguous cells. With ci == 1 the 72 taps of a thread's
// channels stay in registers (it is bound by its store, like the image entry
// conv of csrc/entry_conv.cu).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ bf16, mma

constexpr int TH = 8;          // output rows per block
constexpr int TW = 16;         // output columns per block: one m16 tile per row
constexpr int NB = 64;         // output channels per block
constexpr int MMA_WARPS = 4;   // 2 rows each
constexpr int PAD = 8;         // bf16 of padding per staged pixel / weight row

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

// wt: (co, 9 * ci), k = (ky * 3 + kx) * ci + channel
template <int CK>
__global__ void __launch_bounds__(MMA_WARPS * 32)
s2d_entry_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
              __nv_bfloat16* __restrict__ out, int H, int W, int ci, int co, int tiles_x,
              int tiles_y) {
  constexpr int PS = CK + PAD;       // staged pixel / weight-row stride
  constexpr int VPP = CK / 8;        // 16-byte vectors per staged pixel
  __shared__ __align__(16) __nv_bfloat16 halo[TH + 2][TW + 2][PS];
  __shared__ __align__(16) __nv_bfloat16 ws[NB][PS];

  const int tile = blockIdx.x;
  const int x0 = (tile % tiles_x) * TW;
  const int y0 = ((tile / tiles_x) % tiles_y) * TH;
  const int b = tile / (tiles_x * tiles_y);
  const int n0 = blockIdx.y * NB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair

  float acc[2][NB / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  const __nv_bfloat16* xb = x + (int64_t)b * H * W * ci;
  for (int c0 = 0; c0 < ci; c0 += CK) {
    __syncthreads();  // the previous chunk's halo tile is consumed
    for (int idx = threadIdx.x; idx < (TH + 2) * (TW + 2) * VPP; idx += MMA_WARPS * 32) {
      const int pix = idx / VPP, cc = (idx % VPP) * 8;
      const int hy = pix / (TW + 2), hx = pix % (TW + 2);
      const int yy = y0 + hy - 1, xx = x0 + hx - 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = __ldg(reinterpret_cast<const uint4*>(xb + ((int64_t)yy * W + xx) * ci + c0 + cc));
      *reinterpret_cast<uint4*>(&halo[hy][hx][cc]) = v;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      __syncthreads();  // the previous slab is consumed
      for (int idx = threadIdx.x; idx < NB * VPP; idx += MMA_WARPS * 32) {
        const int n = idx / VPP, cc = (idx % VPP) * 8;
        *reinterpret_cast<uint4*>(&ws[n][cc]) = __ldg(reinterpret_cast<const uint4*>(
            wt + (int64_t)(n0 + n) * 9 * ci + tap * ci + c0 + cc));
      }
      __syncthreads();  // slab (and, at tap 0, the halo tile) visible
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        // A fragments: a0 (pixel g, k 2t), a1 (pixel g+8, k 2t),
        //              a2 (pixel g, k 2t+8), a3 (pixel g+8, k 2t+8)
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* p = &halo[warp * 2 + mt + ky][g + kx][kk * 16 + 2 * t];
          a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * PS);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * PS + 8);
        }
        // B fragments: b0 (k 2t, n g), b1 (k 2t+8, n g)
#pragma unroll
        for (int n = 0; n < NB / 8; ++n) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&ws[n * 8 + g][kk * 16 + 2 * t]);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&ws[n * 8 + g][kk * 16 + 8 + 2 * t]);
          mma_bf16(acc[0][n], a[0], b0, b1);
          mma_bf16(acc[1][n], a[1], b0, b1);
        }
      }
    }
  }

  // C layout: acc[..][n][0..1] pixel g, acc[..][n][2..3] pixel g+8, channels 8n+2t+{0,1}
  const int Ho = H / 2, Wo = W / 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int y = y0 + warp * 2 + mt;
    if (y >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int xq = x0 + g + 8 * half;
      if (xq >= W) continue;
      const int64_t cell = ((int64_t)b * Ho + (y >> 1)) * Wo + (xq >> 1);
      __nv_bfloat16* o = out + (cell * 4 + (y & 1) * 2 + (xq & 1)) * co + n0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NB / 8; ++n)
        *reinterpret_cast<uint32_t*>(o + n * 8) = pack_bf16(acc[mt][n][2 * half], acc[mt][n][2 * half + 1]);
    }
  }
}

// ------------------------------------------------------------------ SIMT

constexpr int GROUP = 8;       // output channels per thread
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

// w: (9 * ci, co) f32, k = (ky * 3 + kx) * ci + channel, already rounded to T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
s2d_entry_simt(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
               int B, int H, int W, int ci, int co) {
  const uint32_t groups = co / GROUP, Ho = H / 2, Wo = W / 2;
  const uint32_t total = (uint32_t)B * H * W * groups, stride = gridDim.x * THREADS;
  for (uint32_t item = blockIdx.x * THREADS + threadIdx.x; item < total; item += stride) {
    const Item it = decode(item, groups, Ho, Wo);
    float acc[GROUP];
#pragma unroll
    for (int c = 0; c < GROUP; ++c) acc[c] = 0.f;
    for (int ky = 0; ky < 3; ++ky) {
      const int yy = it.y + ky - 1;
      if (yy < 0 || yy >= H) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const int xx = it.x + kx - 1;
        if (xx < 0 || xx >= W) continue;
        const T* xp = x + (((int64_t)it.b * H + yy) * W + xx) * ci;
        const float* wp = w + (int64_t)(ky * 3 + kx) * ci * co + it.gch * GROUP;
        for (int k = 0; k < ci; ++k) {
          const float v = load_f(xp + k);
          const float4 w0 = __ldg(reinterpret_cast<const float4*>(wp + (int64_t)k * co));
          const float4 w1 = __ldg(reinterpret_cast<const float4*>(wp + (int64_t)k * co) + 1);
          acc[0] = fmaf(v, w0.x, acc[0]); acc[1] = fmaf(v, w0.y, acc[1]);
          acc[2] = fmaf(v, w0.z, acc[2]); acc[3] = fmaf(v, w0.w, acc[3]);
          acc[4] = fmaf(v, w1.x, acc[4]); acc[5] = fmaf(v, w1.y, acc[5]);
          acc[6] = fmaf(v, w1.z, acc[6]); acc[7] = fmaf(v, w1.w, acc[7]);
        }
      }
    }
    store8(out + (int64_t)it.p * co + it.gch * GROUP, acc);
  }
}

// ci == 1, THREADS % (co / 8) == 0: a thread's channel group never changes in
// its grid-stride loop, so its 72 taps are loaded into registers once.
template <typename T>
__global__ void __launch_bounds__(THREADS)
s2d_entry_simt_image(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                     int B, int H, int W, int co) {
  const uint32_t groups = co / GROUP, Ho = H / 2, Wo = W / 2;
  const int gch = threadIdx.x % groups;
  float wr[9][GROUP];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int c = 0; c < GROUP; ++c) wr[tap][c] = __ldg(w + tap * co + gch * GROUP + c);
  const uint32_t total = (uint32_t)B * H * W * groups, stride = gridDim.x * THREADS;
  for (uint32_t item = blockIdx.x * THREADS + threadIdx.x; item < total; item += stride) {
    const Item it = decode(item, groups, Ho, Wo);  // it.gch == gch
    const T* im = x + (int64_t)it.b * H * W;
    float acc[GROUP];
#pragma unroll
    for (int c = 0; c < GROUP; ++c) acc[c] = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int yy = it.y + ky - 1;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int xx = it.x + kx - 1;
        const float v = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                            ? load_f(im + (int64_t)yy * W + xx) : 0.f;
#pragma unroll
        for (int c = 0; c < GROUP; ++c) acc[c] = fmaf(v, wr[ky * 3 + kx][c], acc[c]);
      }
    }
    store8(out + (int64_t)it.p * co + gch * GROUP, acc);
  }
}

int grid_for(int64_t total) {
  int64_t blocks = (total + THREADS - 1) / THREADS;
  const int64_t cap = 132 * 16;  // enough resident blocks to fill every SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

template <typename T>
int launch_simt(const void* x, const void* w, void* out, int B, int H, int W, int ci, int co,
                void* stream) {
  if (co % GROUP != 0 || H % 2 != 0 || W % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = co / GROUP;
  // items are counted in 32 bits, with room for one grid stride past the end
  if ((int64_t)B * H * W * groups >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = grid_for((int64_t)B * H * W * groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ci == 1 && THREADS % groups == 0) {
    s2d_entry_simt_image<T><<<blocks, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(out), B, H, W, co);
  } else {
    s2d_entry_simt<T><<<blocks, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(out), B, H, W, ci, co);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int s2d_entry_conv_bf16_mma(const void* x, const void* wt, void* out, int B, int H,
                                       int W, int ci, int co, void* stream) {
  if (ci % 16 != 0 || co % NB != 0 || H % 2 != 0 || W % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y * B, co / NB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(wt);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if (ci % 64 == 0)
    s2d_entry_mma<64><<<grid, MMA_WARPS * 32, 0, s>>>(xp, wp, op, H, W, ci, co, tiles_x, tiles_y);
  else
    s2d_entry_mma<16><<<grid, MMA_WARPS * 32, 0, s>>>(xp, wp, op, H, W, ci, co, tiles_x, tiles_y);
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
