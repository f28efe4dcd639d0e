// Masked multi-head softmax attention, backward, on packed heads.
//
// Replaces: image_matching_tpu/ops/pallas/attention.py, _flash_backward,
// its two kernels:
//   _flash_bwd_dkv_kernel (dK, dV accumulated over query blocks);
//   _flash_bwd_dq_kernel  (dQ accumulated over key blocks).
// Per batch b and head h (columns h*dh .. h*dh+dh-1 of the packed
// (B, ., H*dh) tensors), from the forward's f32 LSE (csrc/attention.cu,
// LSE = true), both FA2 passes recompute
//   S = Q K^T * scale (f32, masked keys as below),  P = exp(S - lse),
//   dP = dO V^T,  dS = P * (dP - delta) * scale, 0 at every masked key,
// and accumulate dV = P^T dO, dK = dS^T Q, dQ = dS K in f32.
//
// delta: FA2 (and the TPU kernel) take delta = rowsum(dO * O) from the
// stored output. In bf16 O is rounded, so a row's dS no longer sums to 0,
// and dQ picks up a bias along the row's attention-weighted mean key,
// which the query projection's bias gradient sums over all rows. Here the
// dQ kernel, which runs first, makes a first pass over the keys for
// delta = rowsum(P * dP) / rowsum(P) in f32 from the backward's own P and
// dP, writes it to (B, H, N), and the dK/dV kernel reads it. Dividing by
// rowsum(P) keeps every row of dS summing to 0 (the softmax's Jacobian)
// when the forward's LSE is a rounding off and P sums to 1 +- 1e-6: where
// the keys share a large common part, that residue alone turns dQ.
// chip_smoke.py holds the kernels against each call's exact gradient on a
// training step (PERF.md).
//
// Masking holds to the einsum reference (`jnp.where` then softmax), not to
// the TPU flash kernel: a masked key's logit is replaced, so it passes no
// gradient (dS = 0 there), and its P is 0 unless the batch element has no
// valid key at all. In such a "dead" element every logit was -1e9, the
// forward averaged V, and its LSE row holds log(M) (see csrc/attention.cu):
// P = exp(0 - log M) = 1/M, so dV = sum_i dO_i / M, and dQ = dK = 0.
//
// What bounds it on an H100: the function needs 7 matrix products of
// 2*B*H*N*M*dh (dK/dV: S, dP, P^T dO, dS^T Q; dQ: S, dP, dS K), 1.9 GFLOP
// at the training path's (4, 512, 4 x 32) bf16, against ~3 MB of
// q/k/v/dO/dq/dk/dv: 1.9 us at the tensor-core peak, 0.9 us at HBM's
// rate. The kernels do 11: the dQ kernel's delta pass recomputes S and
// dP, and dS enters each of its two products as two (below). At that
// size one call is 128 blocks, under one wave, so latency, not a peak,
// bounds it.
//
// No carry between blocks (the TPU grid's "arbitrary" axis): one block per
// (b, head, 64-key tile) loops over every query tile for dK/dV, and one
// block per (b, head, 64-query tile) loops over every key tile for dQ, with
// the sums in registers. No atomics, so every sum has a fixed order.
//
// bf16: tensor cores through mma.sync.m16n8k16 (f32 accumulate), as the
// forward. 4 warps, 16 rows each. The warp's own 16 rows (keys for dK/dV,
// queries for dQ) stay in registers as A fragments; the other side is
// staged in shared memory both row-major and transposed (8 bf16 of padding
// per row), so every B fragment is one conflict-free 32-bit read. The
// C-fragment layout of P^T and dS is reused as A fragments. P, dP and dS
// are f32. P is rounded to bf16 for dV = P^T dO (P >= 0, so the rounding
// stays relative to the sum, as the forward's P V). dS is not rounded: the
// TPU kernel takes dS K and dS^T Q as f32 products (attention.py:157-160,
// 199-201). Here dS enters each as a bf16 part plus its bf16 residue, two
// products that come within f32 rounding of the f32 one. No cp.async, TMA
// or wgmma yet.
//
// f32: plain FMAs, no tensor cores, 4 threads per row as the forward's SIMT
// kernel; products and exponentials in full f32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 64;   // rows per staged tile
constexpr int PAD = 8;  // bf16 of padding per staged row
constexpr int WARPS = 4;

// key state: 0 valid, 1 masked in a dead batch element (logit 0), 2 masked
// in a live element or past M (P = 0)
constexpr uint8_t VALID = 0, DEAD_KEY = 1, NO_KEY = 2;

__device__ __forceinline__ bool dead_batch(const uint8_t* mask, int b, int M) {
  if (mask == nullptr) return false;
  int any = 0;
  for (int j = threadIdx.x; j < M; j += blockDim.x) any |= mask[(int64_t)b * M + j];
  return !__syncthreads_or(any);
}

__device__ __forceinline__ uint8_t key_state(const uint8_t* mask, int b, int M, int key, bool dead) {
  if (key >= M) return NO_KEY;
  if (mask == nullptr || mask[(int64_t)b * M + key]) return VALID;
  return dead ? DEAD_KEY : NO_KEY;
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of 16 rows x DH from a row-strided bf16 matrix, rows r0 and
// r0 + 8 of this thread (zero past `rows`):
// a0 (r0, 2t), a1 (r0+8, 2t), a2 (r0, 2t+8), a3 (r0+8, 2t+8) per k-step.
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const __nv_bfloat16* base, int64_t rs,
                                       int r0, int rows, int t) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + (i & 1) * 8, col = kk * 16 + (i >> 1) * 8 + 2 * t;
      a[kk][i] = row < rows ? ld32(base + row * rs + col) : 0u;
    }
}

// Stage rows [r0, r0 + T) of a row-strided (rows, DH) bf16 matrix into
// `rm` (row-major) and/or `tr` (transposed), zero past `rows`.
template <int DH>
__device__ __forceinline__ void stage(__nv_bfloat16 (*rm)[DH + PAD], __nv_bfloat16 (*tr)[T + PAD],
                                      const __nv_bfloat16* base, int64_t rs, int r0, int rows) {
  for (int idx = threadIdx.x; idx < T * DH / 4; idx += WARPS * 32) {
    const int j = idx / (DH / 4), d = (idx % (DH / 4)) * 4;
    uint2 x = make_uint2(0u, 0u);
    if (r0 + j < rows) x = *reinterpret_cast<const uint2*>(base + (r0 + j) * rs + d);
    if (rm != nullptr) *reinterpret_cast<uint2*>(&rm[j][d]) = x;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int i = 0; i < 4; ++i) tr[d + i][j] = e[i];
    }
  }
}

// C (16 x 8*NT) += A (16 x 16*KS, fragments) . B, with B's fragment for
// n-tile n and k-step kk read from `bs` (rows n, contiguous along k).
template <int NT, int KS, int LD>
__device__ __forceinline__ void mma_rows(float (*c)[4], const uint32_t (*a)[4],
                                         const __nv_bfloat16 (*bs)[LD], int g, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma_bf16(c[n], a[kk], ld32(&bs[n * 8 + g][kk * 16 + 2 * t]),
               ld32(&bs[n * 8 + g][kk * 16 + 8 + 2 * t]));
}

// The C layout of a 16 x 64 f32 tile as bf16 A fragments over its 64 columns.
__device__ __forceinline__ void c_to_a(uint32_t (*a)[4], const float (*c)[4]) {
#pragma unroll
  for (int kk = 0; kk < T / 16; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// The rounding residue of the same tile, c - bf16(c), as bf16 A fragments:
// A = hi + lo carries c to ~16 significant bits, so two products with an
// exact bf16 B come within f32 rounding of the f32 product.
__device__ __forceinline__ float residue(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void c_to_a_lo(uint32_t (*a)[4], const float (*c)[4]) {
#pragma unroll
  for (int kk = 0; kk < T / 16; ++kk) {
    a[kk][0] = pack_bf16(residue(c[2 * kk][0]), residue(c[2 * kk][1]));
    a[kk][1] = pack_bf16(residue(c[2 * kk][2]), residue(c[2 * kk][3]));
    a[kk][2] = pack_bf16(residue(c[2 * kk + 1][0]), residue(c[2 * kk + 1][1]));
    a[kk][3] = pack_bf16(residue(c[2 * kk + 1][2]), residue(c[2 * kk + 1][3]));
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (*c)[4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
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

// ------------------------------------------------------------------ bf16 dK/dV

template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
dkdv_mma(const __nv_bfloat16* __restrict__ q, int64_t q_bs, int64_t q_rs,
         const __nv_bfloat16* __restrict__ k, int64_t k_bs, int64_t k_rs,
         const __nv_bfloat16* __restrict__ v, int64_t v_bs, int64_t v_rs,
         const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
         int N, int M, int H, float scale) {
  constexpr int KS = DH / 16, DT = DH / 8;
  __shared__ __align__(16) __nv_bfloat16 qs[T][DH + PAD];    // Q, row-major: B of S^T = K Q^T
  __shared__ __align__(16) __nv_bfloat16 qt[DH][T + PAD];    // Q^T: B of dK += dS^T Q
  __shared__ __align__(16) __nv_bfloat16 dos[T][DH + PAD];   // dO: B of dP^T = V dO^T
  __shared__ __align__(16) __nv_bfloat16 dot_[DH][T + PAD];  // dO^T: B of dV += P^T dO
  __shared__ float lse_s[T], delta_s[T];

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * T + warp * 16 + g;  // this thread's keys r0, r0 + 8
  const bool dead = dead_batch(mask, b, M);
  uint8_t st[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) st[r] = key_state(mask, b, M, r0 + 8 * r, dead);

  uint32_t ka[KS][4], va[KS][4];
  load_a<DH>(ka, k + b * k_bs + h * DH, k_rs, r0, M, t);
  load_a<DH>(va, v + b * v_bs + h * DH, v_rs, r0, M, t);
  float dkc[DT][4], dvc[DT][4];
  zero<DT>(dkc);
  zero<DT>(dvc);

  const int64_t do_rs = (int64_t)H * DH;
  const float* lse_b = lse + ((int64_t)b * H + h) * N;
  const float* delta_b = delta + ((int64_t)b * H + h) * N;
  for (int qt0 = 0; qt0 < N; qt0 += T) {
    __syncthreads();  // the previous tile is consumed
    stage<DH>(qs, qt, q + b * q_bs + h * DH, q_rs, qt0, N);
    stage<DH>(dos, dot_, dout + b * N * do_rs + h * DH, do_rs, qt0, N);
    for (int j = threadIdx.x; j < T; j += WARPS * 32) {
      const bool in = qt0 + j < N;
      lse_s[j] = in ? lse_b[qt0 + j] : INFINITY;  // P = 0 for rows past N
      delta_s[j] = in ? delta_b[qt0 + j] : 0.f;
    }
    __syncthreads();

    // S^T: rows = keys r0, r0+8; columns = the tile's 64 queries.
    // C layout: c[n][0..1] key r0, c[n][2..3] key r0+8, queries 8n+2t+{0,1}
    float p[T / 8][4];
    zero<T / 8>(p);
    mma_rows<T / 8, KS, DH + PAD>(p, ka, qs, g, t);
#pragma unroll
    for (int n = 0; n < T / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = lse_s[n * 8 + 2 * t + (e & 1)];
        const uint8_t s = st[e >> 1];
        p[n][e] = s == VALID ? __expf(p[n][e] * scale - l) : (s == DEAD_KEY ? __expf(-l) : 0.f);
      }
    uint32_t pa[T / 16][4];
    c_to_a(pa, p);
    mma_rows<DT, T / 16, T + PAD>(dvc, pa, dot_, g, t);  // dV += P^T dO

    float ds[T / 8][4];
    zero<T / 8>(ds);
    mma_rows<T / 8, KS, DH + PAD>(ds, va, dos, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < T / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = st[e >> 1] == VALID
                       ? p[n][e] * (ds[n][e] - delta_s[n * 8 + 2 * t + (e & 1)]) * scale
                       : 0.f;
    c_to_a(pa, ds);
    mma_rows<DT, T / 16, T + PAD>(dkc, pa, qt, g, t);  // dK += dS^T Q, dS's bf16 part
    c_to_a_lo(pa, ds);
    mma_rows<DT, T / 16, T + PAD>(dkc, pa, qt, g, t);  // and its residue
  }
  store_rows<DH>(dk, b, M, H, h, r0, t, dkc);
  store_rows<DH>(dv, b, M, H, h, r0, t, dvc);
}

// ------------------------------------------------------------------ bf16 dQ

template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
dq_mma(const __nv_bfloat16* __restrict__ q, int64_t q_bs, int64_t q_rs,
       const __nv_bfloat16* __restrict__ k, int64_t k_bs, int64_t k_rs,
       const __nv_bfloat16* __restrict__ v, int64_t v_bs, int64_t v_rs,
       const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
       const float* __restrict__ lse, float* __restrict__ delta,
       __nv_bfloat16* __restrict__ dq, int N, int M, int H, float scale) {
  constexpr int KS = DH / 16, DT = DH / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[T][DH + PAD];  // K: B of S = Q K^T
  __shared__ __align__(16) __nv_bfloat16 vs[T][DH + PAD];  // V: B of dP = dO V^T
  __shared__ __align__(16) __nv_bfloat16 kt[DH][T + PAD];  // K^T: B of dQ += dS K
  __shared__ uint8_t valid[T];

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * T + warp * 16 + g;  // this thread's queries r0, r0 + 8

  const int64_t do_rs = (int64_t)H * DH;
  uint32_t qa[KS][4], da[KS][4];
  load_a<DH>(qa, q + b * q_bs + h * DH, q_rs, r0, N, t);
  load_a<DH>(da, dout + b * N * do_rs + h * DH, do_rs, r0, N, t);
  float lse_r[2], delta_r[2] = {0.f, 0.f}, psum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    lse_r[r] = row < N ? lse[((int64_t)b * H + h) * N + row] : INFINITY;  // P = 0 past N
  }

  // pass 1: delta = rowsum(P * dP) / rowsum(P) over the valid keys
  for (int kt0 = 0; kt0 < M; kt0 += T) {
    __syncthreads();  // the previous tile is consumed
    stage<DH>(ks, nullptr, k + b * k_bs + h * DH, k_rs, kt0, M);
    stage<DH>(vs, nullptr, v + b * v_bs + h * DH, v_rs, kt0, M);
    for (int j = threadIdx.x; j < T; j += WARPS * 32)
      valid[j] = key_state(mask, b, M, kt0 + j, false) == VALID;
    __syncthreads();
    float p[T / 8][4], dp[T / 8][4];
    zero<T / 8>(p);
    zero<T / 8>(dp);
    mma_rows<T / 8, KS, DH + PAD>(p, qa, ks, g, t);
    mma_rows<T / 8, KS, DH + PAD>(dp, da, vs, g, t);
#pragma unroll
    for (int n = 0; n < T / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (valid[n * 8 + 2 * t + (e & 1)]) {
          const float pe = __expf(p[n][e] * scale - lse_r[e >> 1]);
          delta_r[e >> 1] += pe * dp[n][e];
          psum[e >> 1] += pe;
        }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 threads of a row group share a row
    delta_r[r] += __shfl_xor_sync(0xffffffffu, delta_r[r], 1);
    delta_r[r] += __shfl_xor_sync(0xffffffffu, delta_r[r], 2);
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
    delta_r[r] = psum[r] > 0.f ? delta_r[r] / psum[r] : 0.f;
    const int row = r0 + 8 * r;
    if (t == 0 && row < N) delta[((int64_t)b * H + h) * N + row] = delta_r[r];
  }

  // pass 2: dS and dQ
  float dqc[DT][4];
  zero<DT>(dqc);
  for (int kt0 = 0; kt0 < M; kt0 += T) {
    __syncthreads();  // the previous tile is consumed
    stage<DH>(ks, kt, k + b * k_bs + h * DH, k_rs, kt0, M);
    stage<DH>(vs, nullptr, v + b * v_bs + h * DH, v_rs, kt0, M);
    for (int j = threadIdx.x; j < T; j += WARPS * 32)
      valid[j] = key_state(mask, b, M, kt0 + j, false) == VALID;
    __syncthreads();

    // S: rows = queries r0, r0+8; columns = the tile's 64 keys
    float p[T / 8][4], ds[T / 8][4];
    zero<T / 8>(p);
    zero<T / 8>(ds);
    mma_rows<T / 8, KS, DH + PAD>(p, qa, ks, g, t);
    mma_rows<T / 8, KS, DH + PAD>(ds, da, vs, g, t);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < T / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        // only valid keys carry dS; the others' P does not matter here
        ds[n][e] = valid[n * 8 + 2 * t + (e & 1)]
                       ? __expf(p[n][e] * scale - lse_r[r]) * (ds[n][e] - delta_r[r]) * scale
                       : 0.f;
      }
    uint32_t dsa[T / 16][4];
    c_to_a(dsa, ds);
    mma_rows<DT, T / 16, T + PAD>(dqc, dsa, kt, g, t);  // dQ += dS K, dS's bf16 part
    c_to_a_lo(dsa, ds);
    mma_rows<DT, T / 16, T + PAD>(dqc, dsa, kt, g, t);  // and its residue
  }
  store_rows<DH>(dq, b, N, H, h, r0, t, dqc);
}

// ------------------------------------------------------------------ f32, SIMT

constexpr int SIMT_THREADS = 128;
constexpr int TPR = 4;                       // threads per row
constexpr int SIMT_ROWS = SIMT_THREADS / TPR;

__device__ __forceinline__ void load4(const float* p, float* d) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
}

// This thread's dims of a DH-vector: CHUNKS chunks of 4, interleaved by part.
template <int DH>
__device__ __forceinline__ void load_row(float (*x)[4], const float* row, int part, bool ok) {
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {
    if (ok) {
      load4(row + c * 16 + part * 4, x[c]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[c][e] = 0.f;
    }
  }
}

// Dot product of this thread's dims with a staged row, summed over the 4
// threads of the row.
template <int DH>
__device__ __forceinline__ float row_dot(const float (*x)[4], const float* srow, int part) {
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {
    float y[4];
    load4(srow + c * 16 + part * 4, y);
#pragma unroll
    for (int e = 0; e < 4; ++e) dot = fmaf(x[c][e], y[e], dot);
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  return dot + __shfl_xor_sync(0xffffffffu, dot, 2);
}

// acc += w * staged row (this thread's dims)
template <int DH>
__device__ __forceinline__ void row_axpy(float (*acc)[4], float w, const float* srow, int part) {
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {
    float y[4];
    load4(srow + c * 16 + part * 4, y);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = fmaf(w, y[e], acc[c][e]);
  }
}

template <int DH>
__device__ __forceinline__ void store_row(float* out, const float (*x)[4], int part) {
#pragma unroll
  for (int c = 0; c < DH / 16; ++c)
    *reinterpret_cast<float4*>(out + c * 16 + part * 4) = make_float4(x[c][0], x[c][1], x[c][2], x[c][3]);
}

// Stage rows [r0, r0 + T) of a row-strided (rows, DH) f32 matrix, zero past `rows`.
template <int DH>
__device__ __forceinline__ void stage_f32(float (*s)[DH], const float* base, int64_t rs, int r0, int rows) {
  for (int idx = threadIdx.x; idx < T * DH / 4; idx += SIMT_THREADS) {
    const int j = idx / (DH / 4), d = (idx % (DH / 4)) * 4;
    if (r0 + j < rows) {
      load4(base + (r0 + j) * rs + d, &s[j][d]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][d + e] = 0.f;
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(SIMT_THREADS)
dkdv_simt(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
          const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
          const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
          const uint8_t* __restrict__ mask, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dk, float* __restrict__ dv, int N, int M, int H, float scale) {
  constexpr int C = DH / 16;
  __shared__ __align__(16) float qs[T][DH];
  __shared__ __align__(16) float dos[T][DH];
  __shared__ float lse_s[T], delta_s[T];

  const int b = blockIdx.z, h = blockIdx.y;
  const int key = blockIdx.x * SIMT_ROWS + threadIdx.x / TPR, part = threadIdx.x % TPR;
  const bool dead = dead_batch(mask, b, M);
  const uint8_t st = key_state(mask, b, M, key, dead);
  float kr[C][4], vr[C][4], dkc[C][4], dvc[C][4];
  load_row<DH>(kr, k + b * k_bs + key * k_rs + h * DH, part, key < M);
  load_row<DH>(vr, v + b * v_bs + key * v_rs + h * DH, part, key < M);
  load_row<DH>(dkc, nullptr, part, false);
  load_row<DH>(dvc, nullptr, part, false);

  const int64_t do_rs = (int64_t)H * DH;
  const float* lse_b = lse + ((int64_t)b * H + h) * N;
  const float* delta_b = delta + ((int64_t)b * H + h) * N;
  for (int qt0 = 0; qt0 < N; qt0 += T) {
    __syncthreads();
    stage_f32<DH>(qs, q + b * q_bs + h * DH, q_rs, qt0, N);
    stage_f32<DH>(dos, dout + b * N * do_rs + h * DH, do_rs, qt0, N);
    for (int j = threadIdx.x; j < T; j += SIMT_THREADS) {
      const bool in = qt0 + j < N;
      lse_s[j] = in ? lse_b[qt0 + j] : INFINITY;
      delta_s[j] = in ? delta_b[qt0 + j] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < T; ++i) {
      const float s = row_dot<DH>(kr, qs[i], part);
      const float dp = row_dot<DH>(vr, dos[i], part);
      const float p = st == VALID ? expf(s * scale - lse_s[i]) : (st == DEAD_KEY ? expf(-lse_s[i]) : 0.f);
      const float ds = st == VALID ? p * (dp - delta_s[i]) * scale : 0.f;
      row_axpy<DH>(dvc, p, dos[i], part);
      row_axpy<DH>(dkc, ds, qs[i], part);
    }
  }
  if (key < M) {
    store_row<DH>(dk + ((int64_t)b * M + key) * do_rs + h * DH, dkc, part);
    store_row<DH>(dv + ((int64_t)b * M + key) * do_rs + h * DH, dvc, part);
  }
}

template <int DH>
__global__ void __launch_bounds__(SIMT_THREADS)
dq_simt(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
        const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
        const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
        const uint8_t* __restrict__ mask, const float* __restrict__ dout,
        const float* __restrict__ lse, float* __restrict__ delta,
        float* __restrict__ dq, int N, int M, int H, float scale) {
  constexpr int C = DH / 16;
  __shared__ __align__(16) float ks[T][DH];
  __shared__ __align__(16) float vs[T][DH];
  __shared__ uint8_t valid[T];

  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * SIMT_ROWS + threadIdx.x / TPR, part = threadIdx.x % TPR;
  const bool ok = row < N;
  const int64_t do_rs = (int64_t)H * DH;
  float qr[C][4], dr[C][4], dqc[C][4];
  load_row<DH>(qr, q + b * q_bs + row * q_rs + h * DH, part, ok);
  load_row<DH>(dr, dout + ((int64_t)b * N + row) * do_rs + h * DH, part, ok);
  load_row<DH>(dqc, nullptr, part, false);
  const int64_t i = ((int64_t)b * H + h) * N + row;
  const float lse_r = ok ? lse[i] : INFINITY;

  // pass 1: delta = rowsum(P * dP) / rowsum(P) over the valid keys (the 4
  // threads of a row hold the same full dot products, so the same sums)
  float delta_r = 0.f, psum = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt0 = 0; kt0 < M; kt0 += T) {
      __syncthreads();
      stage_f32<DH>(ks, k + b * k_bs + h * DH, k_rs, kt0, M);
      stage_f32<DH>(vs, v + b * v_bs + h * DH, v_rs, kt0, M);
      for (int j = threadIdx.x; j < T; j += SIMT_THREADS)
        valid[j] = key_state(mask, b, M, kt0 + j, false) == VALID;
      __syncthreads();
      for (int j = 0; j < T; ++j) {
        const float s = row_dot<DH>(qr, ks[j], part);
        const float dp = row_dot<DH>(dr, vs[j], part);
        const float p = valid[j] ? expf(s * scale - lse_r) : 0.f;
        if (pass == 0) {
          delta_r = fmaf(p, dp, delta_r);
          psum += p;
        } else {
          row_axpy<DH>(dqc, p * (dp - delta_r) * scale, ks[j], part);  // pass 2: dQ
        }
      }
    }
    if (pass == 0) {
      delta_r = psum > 0.f ? delta_r / psum : 0.f;
      if (ok && part == 0) delta[i] = delta_r;
    }
  }
  if (ok) store_row<DH>(dq + ((int64_t)b * N + row) * do_rs + h * DH, dqc, part);
}


// ------------------------------------------------------------------ launch

#define BWD_IN(T_)                                                                   \
  const T_ *q, int64_t q_bs, int64_t q_rs, const T_ *k, int64_t k_bs, int64_t k_rs, \
      const T_ *v, int64_t v_bs, int64_t v_rs, const uint8_t *mask, const T_ *dout, \
      const float *lse
#define BWD_IN_PASS q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout, lse

#define DISPATCH_DH(KERNEL, GRID, THREADS, ...)                                       \
  switch (DH) {                                                                       \
    case 16: KERNEL<16><<<GRID, THREADS, 0, stream>>>(__VA_ARGS__); break;            \
    case 32: KERNEL<32><<<GRID, THREADS, 0, stream>>>(__VA_ARGS__); break;            \
    case 64: KERNEL<64><<<GRID, THREADS, 0, stream>>>(__VA_ARGS__); break;            \
    default: return static_cast<int>(cudaErrorInvalidValue);                         \
  }                                                                                   \
  return static_cast<int>(cudaGetLastError());

int launch_dkdv_bf16(BWD_IN(__nv_bfloat16), const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv,
                     int B, int N, int M, int H, int DH, float scale, cudaStream_t stream) {
  const dim3 grid((M + T - 1) / T, H, B);
  DISPATCH_DH(dkdv_mma, grid, WARPS * 32, BWD_IN_PASS, delta, dk, dv, N, M, H, scale)
}

int launch_dq_bf16(BWD_IN(__nv_bfloat16), float* delta, __nv_bfloat16* dq, int B, int N, int M, int H,
                   int DH, float scale, cudaStream_t stream) {
  const dim3 grid((N + T - 1) / T, H, B);
  DISPATCH_DH(dq_mma, grid, WARPS * 32, BWD_IN_PASS, delta, dq, N, M, H, scale)
}

int launch_dkdv_f32(BWD_IN(float), const float* delta, float* dk, float* dv, int B, int N, int M, int H,
                    int DH, float scale, cudaStream_t stream) {
  const dim3 grid((M + SIMT_ROWS - 1) / SIMT_ROWS, H, B);
  DISPATCH_DH(dkdv_simt, grid, SIMT_THREADS, BWD_IN_PASS, delta, dk, dv, N, M, H, scale)
}

int launch_dq_f32(BWD_IN(float), float* delta, float* dq, int B, int N, int M, int H, int DH, float scale,
                  cudaStream_t stream) {
  const dim3 grid((N + SIMT_ROWS - 1) / SIMT_ROWS, H, B);
  DISPATCH_DH(dq_simt, grid, SIMT_THREADS, BWD_IN_PASS, delta, dq, N, M, H, scale)
}

}  // namespace

#define C_IN                                                                          \
  const void *q, int64_t q_bs, int64_t q_rs, const void *k, int64_t k_bs, int64_t k_rs, \
      const void *v, int64_t v_bs, int64_t v_rs, const void *mask, const void *dout,    \
      const void *lse, void *delta
#define C_IN_PASS(T_)                                                                        \
  static_cast<const T_*>(q), q_bs, q_rs, static_cast<const T_*>(k), k_bs, k_rs,              \
      static_cast<const T_*>(v), v_bs, v_rs, static_cast<const uint8_t*>(mask),              \
      static_cast<const T_*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta)
#define C_TAIL int B, int N, int M, int H, int DH, float scale, void *stream
#define C_TAIL_PASS B, N, M, H, DH, scale, static_cast<cudaStream_t>(stream)

// dout (B, N, H*DH), dk / dv (B, M, H*DH) and dq (B, N, H*DH) are contiguous;
// lse and delta are (B, H, N) f32. The dQ kernel writes delta and runs
// first; the dK/dV kernel reads it.
extern "C" int attention_dq_bf16(C_IN, void* dq, C_TAIL) {
  using T_ = __nv_bfloat16;
  return launch_dq_bf16(C_IN_PASS(T_), static_cast<T_*>(dq), C_TAIL_PASS);
}

extern "C" int attention_dkdv_bf16(C_IN, void* dk, void* dv, C_TAIL) {
  using T_ = __nv_bfloat16;
  return launch_dkdv_bf16(C_IN_PASS(T_), static_cast<T_*>(dk), static_cast<T_*>(dv), C_TAIL_PASS);
}

extern "C" int attention_dq_f32(C_IN, void* dq, C_TAIL) {
  return launch_dq_f32(C_IN_PASS(float), static_cast<float*>(dq), C_TAIL_PASS);
}

extern "C" int attention_dkdv_f32(C_IN, void* dk, void* dv, C_TAIL) {
  return launch_dkdv_f32(C_IN_PASS(float), static_cast<float*>(dk), static_cast<float*>(dv), C_TAIL_PASS);
}
