// Log-domain Sinkhorn: `iters` alternating max-shifted logsumexp updates of
// the potentials u (rows) and v (columns), then z + u + v.
//
// Replaces: image_matching_tpu/ops/pallas/sinkhorn.py, fused_log_sinkhorn
// (_sinkhorn_kernel). Per iteration, in the same order as that kernel:
//   t = z + v;  u = log_mu - (max_j t + log sum_j exp(t - max_j t))
//   t = z + u;  v = log_nu - (max_i t + log sum_i exp(t - max_i t))
// starting from u = v = 0; the result is written to a separate buffer
// (z is left as it was).
//
// What bounds it on an H100: memory traffic over Z. One (1025, 1025) f32
// coupling is 4.2 MB, so the TPU kernel's idea (the whole loop against one
// on-chip copy) does not carry over: it exceeds one SM's 227 KB of shared
// memory. At B=4 the whole 16.8 MB does fit in the 50 MB L2, so here the
// 2*iters passes over Z are served from L2 and only the first read and the
// final write touch device memory. The work is ~5 flops and one exp per
// element and pass, far below the bandwidth line.
//
// Design: the simple multi-launch form, with u and v kept on the device.
//   * row pass: one warp per row, lanes stride the row (coalesced), a warp
//     max then a warp sum of exp (two reads of the row; the second hits L1);
//   * column pass: a block per 32-column strip and batch element; the 32
//     lanes of a warp read 32 neighbouring columns of one row (coalesced),
//     8 warps split the rows, and shared memory joins their max and sum;
//   * epilogue: one elementwise pass writing z + u + v.
// One call makes 2 * iters + 1 kernel launches on the caller's stream.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROW_WARPS = 8;   // rows per block in the row pass
constexpr int COL_W = 32;      // columns per block in the column pass
constexpr int COL_H = 8;       // row groups per block in the column pass

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(ROW_WARPS * 32)
row_pass(const float* __restrict__ z, const float* __restrict__ log_mu,
         const float* __restrict__ v, float* __restrict__ u, int Mr, int Nc) {
  const int b = blockIdx.y;
  const int row = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= Mr) return;  // whole warp leaves together
  const float* zr = z + ((int64_t)b * Mr + row) * Nc;
  const float* vb = v + (int64_t)b * Nc;
  float mx = -INFINITY;
  for (int j = lane; j < Nc; j += 32) mx = fmaxf(mx, zr[j] + vb[j]);
  mx = warp_max(mx);
  float s = 0.f;
  for (int j = lane; j < Nc; j += 32) s += expf(zr[j] + vb[j] - mx);
  s = warp_sum(s);
  if (lane == 0) u[(int64_t)b * Mr + row] = log_mu[(int64_t)b * Mr + row] - (mx + logf(s));
}

__global__ void __launch_bounds__(COL_W * COL_H)
col_pass(const float* __restrict__ z, const float* __restrict__ log_nu,
         const float* __restrict__ u, float* __restrict__ v, int Mr, int Nc) {
  __shared__ float red[COL_H][COL_W + 1];
  const int b = blockIdx.y;
  const int tx = threadIdx.x % COL_W, ty = threadIdx.x / COL_W;
  const int col = blockIdx.x * COL_W + tx;
  const bool ok = col < Nc;
  const float* zb = z + (int64_t)b * Mr * Nc + col;
  const float* ub = u + (int64_t)b * Mr;

  float mx = -INFINITY;
  if (ok)
    for (int i = ty; i < Mr; i += COL_H) mx = fmaxf(mx, zb[(int64_t)i * Nc] + ub[i]);
  red[ty][tx] = mx;
  __syncthreads();
  mx = red[0][tx];
#pragma unroll
  for (int r = 1; r < COL_H; ++r) mx = fmaxf(mx, red[r][tx]);
  __syncthreads();

  float s = 0.f;
  if (ok)
    for (int i = ty; i < Mr; i += COL_H) s += expf(zb[(int64_t)i * Nc] + ub[i] - mx);
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && ok) {
    s = 0.f;
#pragma unroll
    for (int r = 0; r < COL_H; ++r) s += red[r][tx];
    v[(int64_t)b * Nc + col] = log_nu[(int64_t)b * Nc + col] - (mx + logf(s));
  }
}

__global__ void epilogue(const float* __restrict__ z, const float* __restrict__ u,
                         const float* __restrict__ v, float* __restrict__ out,
                         int B, int Mr, int Nc) {
  const int64_t total = (int64_t)B * Mr * Nc;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t bi = idx / Nc;  // b * Mr + i
    const int j = idx % Nc;
    const int b = bi / Mr;
    out[idx] = z[idx] + u[bi] + v[(int64_t)b * Nc + j];
  }
}

}  // namespace

// u (B, Mr) is scratch; v (B, Nc) must be zero on entry. All f32, contiguous.
extern "C" int sinkhorn_f32(const float* z, const float* log_mu, const float* log_nu,
                            float* u, float* v, float* out, int B, int Mr, int Nc,
                            int iters, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 row_grid((Mr + ROW_WARPS - 1) / ROW_WARPS, B);
  const dim3 col_grid((Nc + COL_W - 1) / COL_W, B);
  for (int it = 0; it < iters; ++it) {
    row_pass<<<row_grid, ROW_WARPS * 32, 0, stream>>>(z, log_mu, v, u, Mr, Nc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    col_pass<<<col_grid, COL_W * COL_H, 0, stream>>>(z, log_nu, u, v, Mr, Nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  epilogue<<<132 * 8, 256, 0, stream>>>(z, u, v, out, B, Mr, Nc);
  return static_cast<int>(cudaGetLastError());
}
