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
// What bounds it on an H100: the exponentials by count, two per element per
// iteration (one for the row sums, one for the column sums) on the SFU at 16
// a clock an SM: at (4, 1025, 1025) x 30 that is 252 M, ~0.06 ms on 132 SMs,
// against 0.01 ms to read Z once and write the result once. In practice the
// instructions around each exponential and the two grid barriers of each
// iteration take most of the time, so the design cuts both:
//   * everything runs in base 2 (z log2 e staged once, potentials in log2
//     units), so an exponential is one SFU instruction;
//   * a row's or column's sum is taken under the log-sum it had in the
//     previous iteration, with no max pass and no rescaling, and kept when it
//     lands in [2^-60, 2^60]; else (the first iteration, or a shift that moved
//     too far) it is taken again under the exact max, as the plain version does.
//
// The TPU kernel's idea, one read of Z and the whole loop against an on-chip
// copy, carries over: Z is split by whole rows over the SMs' shared memory
// (16.8 MB over 132 SMs is 127 KB each, inside 227 KB). Two routes, chosen
// by the caller from the shape (`ops/sinkhorn.sinkhorn_route`):
//
// * resident (Z fits in the blocks' shared memory): one cooperative,
//   persistent launch per call. Block (e, band) holds `rows` whole rows of
//   batch element e in shared memory for the whole call. Per iteration:
//     - the row update is local: a warp two rows at once, a lane summing
//       chunks of 8 of its values held in registers;
//     - each block writes, for every column, the (shift, sum) of its band's
//       rows under the new u (a thread two columns at once), laid out by
//       tiles of 32 columns so that stores and reads are whole lines;
//     - grid barrier; each block merges the bands' partials of its tiles of
//       32 columns (warps over bands, then across warps, in a fixed order)
//       into v; grid barrier; every block reads v back.
//   Z is read from device memory once and z + u + v written once (z read
//   again, from L2). One launch per call in place of 2 * iters + 1.
// * streamed (Z larger than that): per iteration one pass over bands of
//   rows, staged in shared memory, gives u for its rows and, from the same
//   tile, its band's column partials; a merge kernel gives v. One read of Z
//   an iteration in place of four; 2 * iters + 1 launches.
//
// Partials are merged online: (m, s) + (m', s') = (M, s 2^(m - M) + s'
// 2^(m' - M)), M = max(m, m'), starting from the first element, never from
// -inf. Every sum has a fixed order, so reruns give the same bits.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;        // a block of either route
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 8;            // values a thread holds at once; rows of a band are a multiple
constexpr int MERGE_LOADS = 8;      // partials a lane loads before merging them
constexpr int RED_BYTES = WARPS * 32 * 8;  // shared memory of a tile's merge
constexpr int NOT_CO_RESIDENT = -1;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// A sum of 2^(t - c) under a shift c taken from the previous iteration is kept
// when it lands in [2^-60, 2^60]: its largest term is then a normal float and
// the terms it loses to underflow are below f32's resolution of it. Otherwise
// (the first iteration; a shift that has moved too far) the sum is taken again
// under the exact max.
constexpr float SUM_LO = 8.673617379884035e-19f, SUM_HI = 1.152921504606847e18f;

// Everything inside works in base 2: z2 = z log2 e, potentials u2 = u log2 e
// and v2 = v log2 e, sums of 2^x, so an exponential is one SFU instruction.
struct MaxSum {
  float m, s;  // the set's sum of 2^x is s 2^m; s == 0: nothing merged yet
};

// 2^x, one instruction; relative error ~2^-22, -inf gives 0. Its argument is
// always a difference taken first: both sides can be near BIG_NEG log2 e.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool in_range(float s) { return s >= SUM_LO && s <= SUM_HI; }

// Symmetric in its arguments, so the same bits whichever side comes first.
__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  if (b.s == 0.f) return a;
  if (a.s == 0.f) return b;
  const float m = fmaxf(a.m, b.m);
  return {m, a.s * ex2(a.m - m) + b.s * ex2(b.m - m)};
}

// The warp's 32 partials merged, in every lane: a butterfly of the max,
// each lane's sum rescaled to it, a butterfly of the sum (the same bits in
// every lane).
__device__ __forceinline__ MaxSum warp_merge(MaxSum x) {
  float m = x.s == 0.f ? -INFINITY : x.m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float s = x.s == 0.f ? 0.f : x.s * ex2(x.m - m);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return {m, s};
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Sum of 2^(t[c] - c0) as a tree (values past the end are -inf: 0).
__device__ __forceinline__ float shifted_sum(const float (&t)[CHUNK], float c0) {
  float a[CHUNK];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) a[c] = ex2(t[c] - c0);
#pragma unroll
  for (int w = CHUNK / 2; w >= 1; w /= 2)
#pragma unroll
    for (int c = 0; c < w; ++c) a[c] += a[c + w];
  return a[0];
}

// Folds CHUNK values into a running (max, sum) under the exact max: one
// rescale of the sum a chunk, the chunk's max and sum taken as trees. t[0] is
// a real value; those past the end are -inf.
__device__ __forceinline__ void accumulate(MaxSum& acc, const float (&t)[CHUNK]) {
  float a[CHUNK];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) a[c] = t[c];
#pragma unroll
  for (int w = CHUNK / 2; w >= 1; w /= 2)
#pragma unroll
    for (int c = 0; c < w; ++c) a[c] = fmaxf(a[c], a[c + w]);
  const float m = acc.s == 0.f ? a[0] : fmaxf(acc.m, a[0]);
  const float s = shifted_sum(t, m);
  acc = {m, acc.s == 0.f ? s : fmaf(acc.s, ex2(acc.m - m), s)};
}

// log2 sum_j 2^(zr_j + vs_j) of one row under its exact max, by a warp.
__device__ __forceinline__ float row_lse_exact(const float* zr, const float* vs, int nc) {
  const int lane = threadIdx.x % 32;
  MaxSum acc{0.f, 0.f};
  int j0 = lane;
  for (; j0 + 32 * (CHUNK - 1) < nc; j0 += 32 * CHUNK) {
    float t[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) t[c] = zr[j0 + 32 * c] + vs[j0 + 32 * c];
    accumulate(acc, t);
  }
  for (; j0 < nc; j0 += 32) acc = merge(acc, {zr[j0] + vs[j0], 1.f});
  acc = warp_merge(acc);
  return acc.m + __log2f(acc.s);
}

// u2_r = log_mu_r log2 e - log2 sum_j 2^(z2_rj + v2_j) for `rows` rows held
// in `zs`: a warp two rows at once (r and r + WARPS, two independent chains),
// a lane every 32nd column, CHUNK of them at a time, then the last few (such
// as the dustbin column past 1024) one at a time. `shift` holds each row's
// log-sum of the previous iteration: with `shifted`, the sum is taken under
// it, with no max; the result (the new shift) is written back.
__device__ __forceinline__ void update_rows(const float* zs, const float* vs, float* us, float* shift,
                                            const float* __restrict__ log_mu, int rows, int nc, bool shifted) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += 2 * WARPS) {
    const bool two = r + WARPS < rows;  // the same for the whole warp
    const float* za = zs + r * nc;
    const float* zb = two ? za + WARPS * nc : za;
    float la = 0.f, lb = 0.f;
    bool ok_a = false, ok_b = !two;
    if (shifted) {
      const float ca = shift[r], cb = two ? shift[r + WARPS] : ca;
      float sa = 0.f, sb = 0.f;
      int j0 = lane;
      for (; j0 + 32 * (CHUNK - 1) < nc; j0 += 32 * CHUNK) {
        float ta[CHUNK], tb[CHUNK];
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const float vj = vs[j0 + 32 * c];
          ta[c] = za[j0 + 32 * c] + vj;
          tb[c] = zb[j0 + 32 * c] + vj;
        }
        sa += shifted_sum(ta, ca);
        if (two) sb += shifted_sum(tb, cb);
      }
      for (; j0 < nc; j0 += 32) {
        sa += ex2(za[j0] + vs[j0] - ca);
        if (two) sb += ex2(zb[j0] + vs[j0] - cb);
      }
      sa = warp_sum(sa);
      ok_a = in_range(sa);
      la = ca + __log2f(sa);
      if (two) {
        sb = warp_sum(sb);
        ok_b = in_range(sb);
        lb = cb + __log2f(sb);
      }
    }
    if (!ok_a) la = row_lse_exact(za, vs, nc);  // the same for the whole warp
    if (!ok_b) lb = row_lse_exact(zb, vs, nc);
    if (lane == 0) {
      us[r] = __ldg(log_mu + r) * LOG2E - la;
      shift[r] = la;
      if (two) {
        us[r + WARPS] = __ldg(log_mu + r + WARPS) * LOG2E - lb;
        shift[r + WARPS] = lb;
      }
    }
  }
}

// (max, sum) of column j over `rows` rows under the exact max, from p (the
// column's first row, `nc` apart).
__device__ __forceinline__ MaxSum column_exact(const float* p, const float* us, int rows, int nc) {
  MaxSum acc{0.f, 0.f};
  int r0 = 0;
  for (; r0 + CHUNK <= rows; r0 += CHUNK) {
    float t[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) t[c] = p[(r0 + c) * nc] + us[r0 + c];
    accumulate(acc, t);
  }
  for (int r = r0; r < rows; ++r) acc = merge(acc, {p[r * nc] + us[r], 1.f});
  return acc;
}

// For every column j: a (shift, sum) partial of 2^(z2_ij + u2_i) over the
// `rows` rows in `zs`, under the column's previous log-sum log_nu_j log2 e -
// v2_j when `shifted` and the sum lands in range, else under its exact max.
// Partials are laid out by tiles of 32 columns, part[((j / 32) * bands + band)
// * 32 + j % 32], so that a warp stores 256 contiguous bytes and a tile's merge
// reads contiguous ones. Whole rounds of THREADS columns go a thread a column,
// two rounds at once (two chains, u loaded once), CHUNK rows at a time (`rows`
// is a multiple of CHUNK but for the last band, whose rest go one at a time);
// the few columns past them (such as the dustbin column past 1024) go a warp a
// column, lanes over rows, under the exact max.
__device__ __forceinline__ void column_partials(const float* zs, const float* us, const float* vs,
                                                const float* __restrict__ log_nu, int rows, int nc,
                                                float2* part, int band, int bands, bool shifted) {
  auto put = [&](int j, MaxSum acc) {
    part[((int64_t)(j / 32) * bands + band) * 32 + j % 32] = make_float2(acc.m, acc.s);
  };
  const int whole = nc - nc % THREADS;
  const int tail = nc - whole < THREADS / 32 ? whole : nc;  // columns from here on go a warp each
  for (int j = threadIdx.x; j < tail; j += 2 * THREADS) {
    const bool two = j + THREADS < tail;  // the same for the whole warp
    const float* pa = zs + j;
    const float* pb = two ? pa + THREADS : pa;
    MaxSum a{0.f, 0.f}, b{0.f, 0.f};
    if (shifted) {
      const float ca = __ldg(log_nu + j) * LOG2E - vs[j];
      const float cb = two ? __ldg(log_nu + j + THREADS) * LOG2E - vs[j + THREADS] : ca;
      float sa = 0.f, sb = 0.f;
      int r0 = 0;
      for (; r0 + CHUNK <= rows; r0 += CHUNK) {
        // u of the chunk's rows, 16 bytes at a time (us and CHUNK rows are 16-byte aligned)
        static_assert(CHUNK == 8, "two float4 of u a chunk");
        const float4 u0 = *reinterpret_cast<const float4*>(us + r0), u1 = *reinterpret_cast<const float4*>(us + r0 + 4);
        const float ur[CHUNK] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
        float ta[CHUNK], tb[CHUNK];
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          ta[c] = pa[(r0 + c) * nc] + ur[c];
          tb[c] = pb[(r0 + c) * nc] + ur[c];
        }
        sa += shifted_sum(ta, ca);
        if (two) sb += shifted_sum(tb, cb);
      }
      for (int r = r0; r < rows; ++r) {
        sa += ex2(pa[r * nc] + us[r] - ca);
        if (two) sb += ex2(pb[r * nc] + us[r] - cb);
      }
      a = {ca, sa};
      b = {cb, sb};
    }
    if (!shifted || !in_range(a.s)) a = column_exact(pa, us, rows, nc);
    if (two && (!shifted || !in_range(b.s))) b = column_exact(pb, us, rows, nc);
    put(j, a);
    if (two) put(j + THREADS, b);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = tail + warp; j < nc; j += THREADS / 32) {
    MaxSum acc{0.f, 0.f};
    for (int r = lane; r < rows; r += 32) acc = merge(acc, {zs[r * nc + j] + us[r], 1.f});
    acc = warp_merge(acc);
    if (lane == 0) put(j, acc);
  }
}

// v2_j = log_nu_j log2 e - log2 sum over the bands' partials, for the 32
// columns of tile jt (lane = column): warp w takes bands w, w + WARPS, ...
// (MERGE_LOADS of them in flight at once), then warp 0 the warps' results
// through `red`; each set is merged as its max, then its sum rescaled to it,
// in a fixed order. Partials may have been written by other blocks of this
// launch: they are read from L2 (`__ldcg`), not L1. Every thread of the
// block calls it.
__device__ __forceinline__ void merge_tile(const float2* part, int bands, int jt, int nc,
                                           const float* __restrict__ log_nu, float* v, float2* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float2* pt = part + (int64_t)jt * bands * 32 + lane;
  MaxSum acc{0.f, 0.f};
  for (int k0 = warp; k0 < bands; k0 += WARPS * MERGE_LOADS) {
    float2 p[MERGE_LOADS];
#pragma unroll
    for (int c = 0; c < MERGE_LOADS; ++c) {
      const int k = k0 + WARPS * c;
      p[c] = k < bands ? __ldcg(pt + k * 32) : make_float2(-INFINITY, 0.f);
    }
    float m = p[0].x;  // band k0 < bands: a real partial
#pragma unroll
    for (int c = 1; c < MERGE_LOADS; ++c) m = fmaxf(m, p[c].x);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < MERGE_LOADS; ++c) s += p[c].y == 0.f ? 0.f : p[c].y * ex2(p[c].x - m);
    acc = merge(acc, {m, s});
  }
  red[warp * 32 + lane] = make_float2(acc.m, acc.s);
  __syncthreads();
  const int j = jt * 32 + lane;
  if (warp == 0 && j < nc) {  // columns past nc have no partials: nothing to merge
    float m = -INFINITY;
    for (int w = 0; w < WARPS; ++w) {
      const float2 q = red[w * 32 + lane];
      if (q.y != 0.f) m = fmaxf(m, q.x);
    }
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float2 q = red[w * 32 + lane];
      if (q.y != 0.f) s += q.y * ex2(q.x - m);
    }
    v[j] = __ldg(log_nu + j) * LOG2E - (m + __log2f(s));
  }
  __syncthreads();  // `red` is free again
}

// `count` floats of z from `src` into shared memory, times log2 e.
__device__ __forceinline__ void stage(float* zs, const float* src, int count) {
  for (int k = threadIdx.x; k < count; k += THREADS) cp_async_4(zs + k, src + k, true);
  cp_async_commit();
  cp_async_wait<0>();
  for (int k = threadIdx.x; k < count; k += THREADS) zs[k] *= LOG2E;  // each thread its own copies
}

// Shared memory of a block: the merge's scratch, its rows of z2, their u2
// and log-sums, and v2.
__global__ void __launch_bounds__(THREADS, 1)
sinkhorn_resident(const float* __restrict__ z, const float* __restrict__ log_mu,
                  const float* __restrict__ log_nu, float* v, float2* part, float* __restrict__ out,
                  int Mr, int Nc, int iters, int rows, int bands) {
  extern __shared__ __align__(16) float smem[];
  const int e = blockIdx.x / bands, band = blockIdx.x % bands;
  const int r0 = band * rows, nr = min(rows, Mr - r0);
  float2* red = reinterpret_cast<float2*>(smem);
  float* zs = smem + RED_BYTES / 4;
  float* us = zs + rows * Nc;
  float* rs = us + rows;
  float* vs = rs + rows;
  const int64_t base = ((int64_t)e * Mr + r0) * Nc;
  stage(zs, z + base, nr * Nc);
  for (int r = threadIdx.x; r < rows; r += THREADS) us[r] = 0.f;
  for (int j = threadIdx.x; j < Nc; j += THREADS) vs[j] = 0.f;
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  if (!grid.is_valid()) __trap();  // launched without the cooperative attribute: fail, never hang
  const int tiles = (Nc + 31) / 32;
  float* ve = v + (int64_t)e * Nc;
  float2* pe = part + (int64_t)e * tiles * bands * 32;
  const float* mu = log_mu + (int64_t)e * Mr + r0;
  const float* nu = log_nu + (int64_t)e * Nc;
  for (int it = 0; it < iters; ++it) {
    update_rows(zs, vs, us, rs, mu, nr, Nc, it > 0);
    __syncthreads();
    column_partials(zs, us, vs, nu, nr, Nc, pe, band, bands, it > 0);
    grid.sync();
    for (int jt = band; jt < tiles; jt += bands) merge_tile(pe, bands, jt, Nc, nu, ve, red);
    grid.sync();
    for (int j = threadIdx.x; j < Nc; j += THREADS) vs[j] = __ldcg(ve + j);
    __syncthreads();
  }
  const int count = nr * Nc;
  for (int k = threadIdx.x; k < count; k += THREADS) {
    const int r = k / Nc;
    out[base + k] = __ldg(z + base + k) + us[r] * LN2 + vs[k - r * Nc] * LN2;
  }
}

// Streamed route, one iteration's first half: u2 of a band's rows, and the
// band's column partials under it, from one staging of the band. u2 (B, Mr)
// and v2 (B, Nc) live in device memory between launches.
__global__ void __launch_bounds__(THREADS)
band_pass(const float* __restrict__ z, const float* __restrict__ log_mu, const float* __restrict__ log_nu,
          const float* __restrict__ v, float* __restrict__ u, float2* __restrict__ part, int Mr, int Nc,
          int rows, int bands, int shifted) {
  extern __shared__ __align__(16) float smem[];
  const int e = blockIdx.x / bands, band = blockIdx.x % bands;
  const int r0 = band * rows, nr = min(rows, Mr - r0);
  float* zs = smem + RED_BYTES / 4;
  float* us = zs + rows * Nc;
  float* rs = us + rows;
  float* vs = rs + rows;
  const float* mu = log_mu + (int64_t)e * Mr + r0;
  stage(zs, z + ((int64_t)e * Mr + r0) * Nc, nr * Nc);
  for (int j = threadIdx.x; j < Nc; j += THREADS) vs[j] = v[(int64_t)e * Nc + j];
  for (int r = threadIdx.x; r < nr; r += THREADS) rs[r] = mu[r] * LOG2E - u[(int64_t)e * Mr + r0 + r];
  __syncthreads();
  update_rows(zs, vs, us, rs, mu, nr, Nc, shifted);
  __syncthreads();
  for (int r = threadIdx.x; r < nr; r += THREADS) u[(int64_t)e * Mr + r0 + r] = us[r];
  column_partials(zs, us, vs, log_nu + (int64_t)e * Nc, nr, Nc,
                  part + (int64_t)e * ((Nc + 31) / 32) * bands * 32, band, bands, shifted);
}

// Streamed route, second half: v2 of a tile of 32 columns from the bands' partials.
__global__ void __launch_bounds__(THREADS)
merge_pass(const float2* __restrict__ part, const float* __restrict__ log_nu, float* __restrict__ v,
           int Nc, int bands) {
  __shared__ float2 red[WARPS * 32];
  const int e = blockIdx.y, tiles = gridDim.x;
  merge_tile(part + (int64_t)e * tiles * bands * 32, bands, blockIdx.x, Nc, log_nu + (int64_t)e * Nc,
             v + (int64_t)e * Nc, red);
}

// out = z + u + v from the base-2 potentials.
__global__ void epilogue(const float* __restrict__ z, const float* __restrict__ u,
                         const float* __restrict__ v, float* __restrict__ out, int B, int Mr, int Nc) {
  const int64_t total = (int64_t)B * Mr * Nc;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t bi = idx / Nc;  // b * Mr + i
    const int j = idx % Nc;
    const int b = bi / Mr;
    out[idx] = z[idx] + u[bi] * LN2 + v[(int64_t)b * Nc + j] * LN2;
  }
}

// What `ops/sinkhorn.sinkhorn_route` counts too.
int smem_bytes(int rows, int Nc) { return RED_BYTES + (rows * Nc + 2 * rows + Nc) * 4; }

}  // namespace

// The current device's SM count and the shared memory a block may opt in to:
// what the route is chosen from.
extern "C" int sinkhorn_device_limits(int* sms, int* smem_per_block) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

// z, out (B, Mr, Nc); log_mu, u (B, Mr); log_nu, v (B, Nc); part (B,
// ceil(Nc / 32), bands, 32) float2 scratch, bands = ceil(Mr / rows). All f32,
// contiguous; u and v zero on entry on the streamed route (the resident one
// starts from zeros in shared memory). `resident` and `rows` come from the
// route. Returns a CUDA error code, or NOT_CO_RESIDENT when the resident
// route's blocks cannot all be resident at once.
extern "C" int sinkhorn_f32(const float* z, const float* log_mu, const float* log_nu, float* u, float* v,
                            void* part, float* out, int B, int Mr, int Nc, int iters, int rows,
                            int resident, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int bands = (Mr + rows - 1) / rows;
  const int smem = smem_bytes(rows, Nc);
  float2* p = static_cast<float2*>(part);
  if (resident) {
    static int allowed = 0;  // the largest shared memory asked for so far
    cudaError_t err = cudaSuccess;
    if (smem > allowed) {
      err = allow_smem(sinkhorn_resident, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = smem;
    }
    int per_sm = 0, sms = 0, dev = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinkhorn_resident, THREADS, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm * sms < B * bands) return NOT_CO_RESIDENT;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * bands);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(&cfg, sinkhorn_resident, z, log_mu, log_nu, v, p, out,
                                               Mr, Nc, iters, rows, bands));
  }
  static int allowed = 0;
  if (smem > allowed) {
    cudaError_t err = allow_smem(band_pass, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const dim3 merge_grid((Nc + 31) / 32, B);
  for (int it = 0; it < iters; ++it) {
    band_pass<<<B * bands, THREADS, smem, stream>>>(z, log_mu, log_nu, v, u, p, Mr, Nc, rows, bands, it > 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    merge_pass<<<merge_grid, THREADS, 0, stream>>>(p, log_nu, v, Nc, bands);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t total = (int64_t)B * Mr * Nc;
  const int blocks = static_cast<int>(total / 256 < 4096 ? total / 256 + 1 : 4096);
  epilogue<<<blocks, 256, 0, stream>>>(z, u, v, out, B, Mr, Nc);
  return static_cast<int>(cudaGetLastError());
}
