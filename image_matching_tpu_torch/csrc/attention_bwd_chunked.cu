// Masked multi-head softmax attention, backward, on packed heads wider
// than 128 values.
//
// Replaces: image_matching_tpu/ops/pallas/attention.py, _flash_backward
// (_flash_bwd_dkv_kernel, _flash_bwd_dq_kernel) at head widths above 128,
// which the kernels of csrc/attention_bwd.cu do not take. The function and
// its semantics (delta, key masking, dead batch elements) are that file's;
// see its notes.
//
// Heads wider than 128 (dh = C * 128, C >= 2), bf16: `dq_chunked` /
// `dkdv_chunked`, one body (`chunked_bwd`), launched as thread block
// clusters of the chunk blocks as the f32 pair below is, on Hopper's
// warpgroup products. The G blocks of one 64-row tile (G the largest
// divisor of C up to 8; each owns C / G chunks) keep their own rows' chunk
// in shared memory (Q_c and dO_c for dQ, K_c and V_c for dK/dV), bring only
// their chunk of each 64-row loop tile into a 3-slot ring by tensor copies
// (TMA, in the 128-byte swizzle, issued by one thread, an mbarrier a slot),
// multiply partial S_c (warpgroup 0) and dP_c (warpgroup 1) with
// wgmma.m64n64k16, and add the cluster's partials in f32 through
// distributed shared memory in rank order: one cluster barrier a tile,
// split, with the next copies and (a chunk a block, C <= 8) the next tile's
// partial products issued between its arrive and its wait. Then
// the output product, A (P or dS, rounded to bf16) from registers: dQ_c +=
// dS K_c, each warpgroup over half the tile's keys, or dV_c += P^T dO_c
// (warpgroup 0) and dK_c += dS^T Q_c (warpgroup 1) in one block. dQ's delta
// pass exchanges S only. Work: dQ 5 C chunk products (a delta pass of 2 C,
// then 3 C) for the function's 3 C, dK/dV 4 C for 4 C. Bound: the
// function's 7 products at D = 1024's training shape (4, 512, 4 x 256),
// 15 GFLOP, take 0.0152 ms at 989 TFLOP/s. What holds the pair is the
// exchange, the partner's partials read through distributed shared memory
// and the barrier's release: half the pair's time on the card (PERF.md,
// with the routes that were timed against this one).
//
// f32: `dq_3xtf32_chunked` / `dkdv_3xtf32_chunked`, one body
// (`chunked_bwd_tf32`), launched as thread block clusters. The C chunk
// blocks of one 64-row tile form a cluster (up to 8; above 8 chunks each
// block owns C / G of them, G the largest divisor of C up to 8). Each keeps
// its own rows' chunk in shared memory (Q_c and dO_c for dQ, K_c and V_c for
// dK/dV), streams only its chunk of each 32-row loop tile through a 3-slot
// `cp.async` ring, multiplies partial S_c and dP_c, and the cluster adds
// the partials through distributed shared memory in rank order, so every
// block holds the same S and dP without the other chunks' products. Then
// its own output product: dQ_c += dS K_c, or dV_c += P^T dO_c and dK_c +=
// dS^T Q_c in one block. One cluster barrier a loop tile, the partials in
// two exchange buffers. Work: dQ 5 C chunk products (a delta pass of 2 C,
// then 3 C) for the function's 3 C, dK/dV 4 C for 4 C. Bound: the
// function's 7 products at D = 1024's training shape (4, 512, 4 x 256) are
// 15 GFLOP, 0.09 ms at 165 TFLOP/s of f32-accurate tensor-core products,
// 0.22 ms on the FMA pipe. So the products run on the tensor cores as
// 3xTF32, as f32 SDPA's do: each f32 operand a TF32 part (rounded to
// nearest) and its rest, three mma.sync.m16n8k8 products (lo hi, hi lo, hi
// hi) a k-step, summed from zero and added to an f32 total, which keeps the
// gradients 1.4-4x closer to float64 than the plain f32 version at 512-1024
// keys. On the card the pair takes 0.74 ms there, 2x f32 SDPA's backward:
// the cluster's exchange (the other blocks' partials and the barrier) and
// the ring's staging take a third of it (PERF.md). Key masking, dead
// elements and delta are those of csrc/attention_bwd.cu.
//
// The kernels live in a source of their own so that nvcc builds them beside
// csrc/attention_bwd.cu, not after it.
#include <math.h>

#include "hopper.cuh"
#include "ffma.cuh"
#include "attention_bwd.cuh"
#include "tma.cuh"
#include "tf32.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CW = 128;  // head values a chunk

// ------------------------------------------------------------------ f32: clusters, 3xTF32
//
// A cluster of G blocks (along y) shares one 64-row tile of one (b, head);
// block r owns chunks r, r + G, ... (C / G of them, one where C <= 8). Per
// 32-row loop tile each block multiplies only its own chunks into partial
// S and dP (64 x 32), leaves them in its exchange buffer, and after one
// cluster barrier adds the G partials through distributed shared memory in
// rank order: every block holds the same S and dP. Warps 0-3 take S, 4-7
// dP, 16 own rows each. The block then takes its output product with the
// loop tile's chunk: dQ += dS K_c (warp w: rows 16 (w % 4), dims 64 (w / 4)
// of the chunk) or dV += P^T dO_c (warps 0-3) and dK += dS^T Q_c (4-7), 16
// keys x 128 dims a warp.

constexpr int TL = 32;                    // loop rows a step
constexpr int RING = 3;                   // ring stages
constexpr int LDF = CW + 4;               // row pitch of a staged f32 tile
constexpr int EP = TL + 8;                // row pitch of an exchange tile: float2 stores on distinct banks
constexpr int MAX_CLUSTER = 8;            // blocks of a portable cluster
constexpr int OWN_F = 2 * T * LDF;        // the own rows' two tiles (S's and dP's operand)
constexpr int SLOT_F = 2 * TL * LDF + 2 * TL;  // a ring slot: two loop tiles, then lse and delta rows
constexpr int EXCH_F = 2 * T * EP;        // an exchange buffer: partial S, then partial dP
constexpr int TF32_SMEM_BYTES = (OWN_F + RING * SLOT_F + 2 * EXCH_F) * 4;

// Blocks of a cluster for C chunks: the largest divisor of C up to 8, so
// that every block owns as many chunks.
__host__ __device__ constexpr int cluster_blocks(int C) {
  int g = C < MAX_CLUSTER ? C : MAX_CLUSTER;
  while (C % g) --g;
  return g;
}

// Rows [r0, r0 + R) of a row-strided f32 matrix, the 128 values from `base`,
// into a tile of pitch LDF by the block's FG threads, zeros past `rows`.
template <int R>
__device__ __forceinline__ void stage_chunk(float* tile, const float* base, int64_t rs, int r0, int rows, int tid) {
  constexpr int CH = CW / 4;
#pragma unroll
  for (int c = tid; c < R * CH; c += FG) {
    const int row = c / CH, col = (c % CH) * 4;
    const bool ok = r0 + row < rows;
    cp_async_16(tile + row * LDF + col, ok ? base + (int64_t)(r0 + row) * rs + col : base, ok);
  }
}

// c[n] (the warp's 16 own rows x loop rows 8n .. 8n + 7, in the C layout)
// += Own . Loop^T over the chunk's 128 values: `a_addr` the lane's ldmatrix
// address in the own tile (its 16 rows), `l_addr` the lane's in the loop
// tile. ldmatrix moves 32-bit values as pairs of 16-bit ones: matrix i of
// x4 gives A fragment a_i of m16n8k8 (rows g, g + 8; columns t, t + 4) and
// two n-tiles' B fragments.
__device__ __forceinline__ void partial_product(float (*c)[4], uint32_t a_addr, uint32_t l_addr) {
#pragma unroll 2
  for (int ks = 0; ks < CW / 8; ++ks) {
    uint32_t a[4], ah[4], al[4];
    ldsm_x4(a, a_addr + ks * 32);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), ah[e], al[e]);
#pragma unroll
    for (int np = 0; np < TL / 16; ++np) {
      uint32_t bf[4], bh[4], bl[4];
      ldsm_x4(bf, l_addr + np * 16 * LDF * 4 + ks * 32);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(bf[e]), bh[e], bl[e]);
      mma_3xtf32(c[2 * np], ah, al, bh, bl);
      mma_3xtf32(c[2 * np + 1], ah, al, bh + 2, bl + 2);
    }
  }
}

// c[n] (16 own rows x dims 8n .. 8n + 7) += X (16 own rows x the TL loop
// rows, A fragments split in xh, xl) . Y (loop rows x dims), `y` the loop
// tile at row 2t, column g of the warp's first dim. K-step kk takes loop
// rows 8 kk + 2t as its column t and 8 kk + 2t + 1 as t + 4, so that X's
// fragments are the C layout of S and dP as they are, and a warp's reads
// of Y (8t + g) fall on distinct banks.
template <int NT>
__device__ __forceinline__ void output_product(float (*c)[4], const uint32_t (*xh)[4], const uint32_t (*xl)[4],
                                               const float* y) {
#pragma unroll
  for (int kk = 0; kk < TL / 8; ++kk)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* p = y + kk * 8 * LDF + n * 8;
      uint32_t bh[2], bl[2];
      split_tf32(p[0], bh[0], bl[0]);
      split_tf32(p[LDF], bh[1], bl[1]);
      mma_3xtf32(c[n], xh[kk], xl[kk], bh, bl);
    }
}

// The cluster's sums of the partial tile `part` (an exchange tile) at this
// lane's entries for k-step kk: rows g, g + 8 of the warp's 16 (from `row0`),
// loop rows 8 kk + 2t, + 1; x = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1);
// only the k-steps set in `ksteps` are read
__device__ __forceinline__ void cluster_sum(float (*x)[4], cg::cluster_group& cluster, int G, const float* part,
                                            int row0, int g, int t, unsigned ksteps = 0xfu) {
#pragma unroll
  for (int kk = 0; kk < TL / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[kk][e] = 0.f;
  for (int o = 0; o < G; ++o) {  // in rank order, in every block
    const float* p = cluster.map_shared_rank(part, o) + (row0 + g) * EP + 2 * t;
#pragma unroll
    for (int kk = 0; kk < TL / 8; ++kk) {
      if (!((ksteps >> kk) & 1u)) continue;  // k-steps the warp does not use
      const float2 top = *reinterpret_cast<const float2*>(p + kk * 8);
      const float2 bot = *reinterpret_cast<const float2*>(p + 8 * EP + kk * 8);
      x[kk][0] += top.x;
      x[kk][1] += top.y;
      x[kk][2] += bot.x;
      x[kk][3] += bot.y;
    }
  }
}

// x (k-step kk's entries as `cluster_sum` lays them out) as the split A
// fragments of `output_product`: a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1),
// a3 (g + 8, 2t + 1)
__device__ __forceinline__ void to_fragments(uint32_t (*xh)[4], uint32_t (*xl)[4], const float (*x)[4]) {
#pragma unroll
  for (int kk = 0; kk < TL / 8; ++kk) {
    split_tf32(x[kk][0], xh[kk][0], xl[kk][0]);
    split_tf32(x[kk][2], xh[kk][1], xl[kk][1]);
    split_tf32(x[kk][1], xh[kk][2], xl[kk][2]);
    split_tf32(x[kk][3], xh[kk][3], xl[kk][3]);
  }
}

// One block of the cluster. dQ (DQ): a delta pass over the key tiles, then
// one output pass per owned chunk; dK/dV: one output pass per owned chunk.
// A pass walks the loop tiles; a tile takes one ring step per owned chunk,
// the output pass's own chunk last, so that its loop tile is in the ring
// for the output product. With one chunk a block the own rows are staged
// once; with several, each step stages its chunk's own rows.
template <bool DQ>
__device__ __forceinline__ void chunked_bwd_tf32(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
                                                 const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
                                                 const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
                                                 const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                                                 const float* __restrict__ lse, float* __restrict__ delta,
                                                 float* __restrict__ out_s, float* __restrict__ out_p, int N, int M,
                                                 int H, float scale, int C, float* fsm) {
  __shared__ float2 row_sums[2][T];  // dQ: (sum P dP, sum P) per half of the key tile's columns and own row
  cg::cluster_group cluster = cg::this_cluster();
  const int G = cluster.num_blocks(), r = cluster.block_rank(), nr = C / G;
  const int b = blockIdx.z, h = blockIdx.y / G, r0 = blockIdx.x * T, tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4, wr = 16 * (w % 4), half = w / 4;
  const int DH = C * CW;
  const int own_rows = DQ ? N : M, loop_rows = DQ ? M : N, ntiles = (loop_rows + TL - 1) / TL;
  const int64_t do_rs = (int64_t)H * DH;
  const float* qh = q + b * q_bs + h * DH;
  const float* kh = k + b * k_bs + h * DH;
  const float* vh = v + b * v_bs + h * DH;
  const float* doh = dout + b * N * do_rs + h * DH;
  // S's operands (own, loop): (Q, K) for dQ, (K, Q) for dK/dV; dP's (dO, V), (V, dO)
  const float* own_s = DQ ? qh : kh;
  const float* own_p = DQ ? doh : vh;
  const float* loop_s = DQ ? kh : qh;
  const float* loop_p = DQ ? vh : doh;
  const int64_t own_s_rs = DQ ? q_rs : k_rs, own_p_rs = DQ ? do_rs : v_rs;
  const int64_t loop_s_rs = DQ ? k_rs : q_rs, loop_p_rs = DQ ? v_rs : do_rs;
  const float* lse_b = lse + ((int64_t)b * H + h) * N;
  float* delta_b = delta + ((int64_t)b * H + h) * N;
  float* own = fsm;
  float* ring = own + OWN_F;
  float* exch = ring + RING * SLOT_F;

  // flat steps: pass (dQ: 0 the delta pass), loop tile, chunk step i < nr.
  // Output pass p's tile takes chunks r + G ((p + 1 + i) % nr): its own, r + p G, last.
  const int pass0 = DQ ? 1 : 0, per_pass = ntiles * nr, steps = (pass0 + nr) * per_pass;
  auto chunk_of = [&](int u) {
    const int p = u / per_pass - pass0;
    return r + G * ((p + 1 + u % nr) % nr);  // the delta pass (p = -1): r, r + G, ...
  };
  auto stage_own = [&](int cc) {
    stage_chunk<T>(own, own_s + cc * CW, own_s_rs, r0, own_rows, tid);
    stage_chunk<T>(own + T * LDF, own_p + cc * CW, own_p_rs, r0, own_rows, tid);
  };
  auto stage = [&](int u) {  // step u's loop tile, its chunk, and (dK/dV) the tile's lse and delta rows
    float* slot = ring + (u % RING) * SLOT_F;
    const int j0 = (u / nr) % ntiles * TL, cc = chunk_of(u);
    stage_chunk<TL>(slot, loop_s + cc * CW, loop_s_rs, j0, loop_rows, tid);
    stage_chunk<TL>(slot + TL * LDF, loop_p + cc * CW, loop_p_rs, j0, loop_rows, tid);
    if (!DQ && tid < 2 * TL) {  // rows past N: lse = delta = 0 beside dO = 0
      const int j = tid % TL;
      const bool ok = j0 + j < N;
      const float* src = tid < TL ? lse_b : delta_b;
      cp_async_4(slot + 2 * TL * LDF + tid, ok ? src + j0 + j : src, ok);
    }
  };

  if (nr == 1) stage_own(r);
  stage(0);
  cp_async_commit();
  if (steps > 1) stage(1);
  cp_async_commit();
  // the factors of this lane's own rows wr + g, + 8: dQ, the rows' lse log2 e
  // (P = 0 past N); dK/dV, the keys' states as `dkdv_ffma` takes them
  float l2[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f}, ds_scale[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  bool counts[2] = {false, false};
  const bool dead = DQ ? false : dead_batch(mask, b, M);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = r0 + wr + g + 8 * e;
    if constexpr (DQ) {
      l2[e] = row < N ? lse_b[row] * LOG2E : INFINITY;
    } else {
      const KeyRow key = key_row(key_state(mask, b, M, row, dead), scale);
      s2[e] = key.s_scale * LOG2E;
      ds_scale[e] = key.ds_scale;
      counts[e] = key.counts;
    }
  }
  cp_async_wait<1>();  // the own rows and step 0's tiles have landed
  cluster.sync();      // every block of the cluster runs: its shared memory may be read

  const uint32_t a_addr = smem_addr(own + half * T * LDF + (wr + lane % 8 + 8 * ((lane / 8) % 2)) * LDF +
                                    4 * (lane / 16));
  const uint32_t l_lane = ((lane % 8 + 8 * (lane / 16)) * LDF + 4 * ((lane / 8) % 2)) * 4;
  float part[TL / 8][4], acc[DQ ? 8 : 16][4];
  zero<DQ ? 8 : 16>(acc);
  float num[2] = {0.f, 0.f}, den[2] = {0.f, 0.f};
  for (int u = 0; u < steps; ++u) {
    const int i = u % nr, tile = u / nr, pass = u / per_pass, j0 = tile % ntiles * TL;
    const bool last = i == nr - 1;  // the tile's last chunk step: exchange, P and dS, output product
    float* slot = ring + (u % RING) * SLOT_F;
    if (nr > 1) {  // this step's own chunk; every thread is done with the last one's
      stage_own(chunk_of(u));
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    bool ok[TL / 8][2];  // dQ: the tile's keys that are valid, asked for ahead of the products
    if (DQ && last) {
#pragma unroll
      for (int kk = 0; kk < TL / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j0 + 8 * kk + 2 * t + e;
          ok[kk][e] = key < M && (mask == nullptr || mask[(int64_t)b * M + key]);
        }
    }
    if (i == 0) zero<TL / 8>(part);
    partial_product(part, a_addr, smem_addr(slot + half * TL * LDF) + l_lane);  // S (warps 0-3), dP (4-7)
    float* ex = exch + (tile % 2) * EXCH_F;  // a tile's buffer; the next tile writes the other
    if (last) {
#pragma unroll
      for (int n = 0; n < TL / 8; ++n) {
        float* p = ex + half * T * EP + (wr + g) * EP + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(p) = make_float2(part[n][0], part[n][1]);
        *reinterpret_cast<float2*>(p + 8 * EP) = make_float2(part[n][2], part[n][3]);
      }
    }
    cp_async_wait<0>();  // step u + 1's tiles have landed
    if (last) {
      cluster.sync();  // the partials are written; every block is done with step u - 1
    } else {
      __syncthreads();
    }
    if (u + RING - 1 < steps) stage(u + RING - 1);  // into step u - 1's slot
    cp_async_commit();
    if (!last) continue;

    uint32_t xh[TL / 8][4], xl[TL / 8][4];
    float s[TL / 8][4], dp[TL / 8][4];
    if constexpr (DQ) {
      const unsigned use = pass == 0 ? (half ? 0xcu : 0x3u) : 0xfu;  // the delta pass: the warp's half of the keys
      cluster_sum(s, cluster, G, ex, wr, g, t, use);
      cluster_sum(dp, cluster, G, ex + T * EP, wr, g, t, use);
#pragma unroll
      for (int kk = 0; kk < TL / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // the exponential outside the choice: no branch
          const float pe = exp2f(fmaf(s[kk][e], scale * LOG2E, -l2[e >> 1]));
          s[kk][e] = ok[kk][e & 1] ? pe : 0.f;
        }
      if (pass == 0) {  // the delta pass: this lane's sums over its half of the tile's keys
#pragma unroll
        for (int kk = 0; kk < TL / 8; ++kk) {
          if (kk / (TL / 16) != half) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            num[e >> 1] = fmaf(s[kk][e], dp[kk][e], num[e >> 1]);
            den[e >> 1] += s[kk][e];
          }
        }
        if (tile == ntiles - 1) {  // delta = rowsum(P dP) / rowsum(P): the row's 4 lanes, then its 2 warps, in order
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            num[e] += __shfl_xor_sync(0xffffffffu, num[e], 1);
            num[e] += __shfl_xor_sync(0xffffffffu, num[e], 2);
            den[e] += __shfl_xor_sync(0xffffffffu, den[e], 1);
            den[e] += __shfl_xor_sync(0xffffffffu, den[e], 2);
            if (t == 0) row_sums[half][wr + g + 8 * e] = make_float2(num[e], den[e]);
          }
          __syncthreads();
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = wr + g + 8 * e;
            const float2 lo = row_sums[0][row], hi = row_sums[1][row];
            const float sn = lo.x + hi.x, sd = lo.y + hi.y;
            delta_r[e] = sd > 0.f ? sn / sd : 0.f;
            if (r == 0 && half == 0 && t == 0 && r0 + row < N) delta_b[r0 + row] = delta_r[e];
          }
        }
        continue;
      }
#pragma unroll
      for (int kk = 0; kk < TL / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[kk][e] = s[kk][e] * (dp[kk][e] - delta_r[e >> 1]) * scale;
      to_fragments(xh, xl, s);
      output_product<8>(acc, xh, xl, slot + 2 * t * LDF + g + 64 * half);  // dQ_c += dS K_c
    } else {
      const float* rows = slot + 2 * TL * LDF;  // the tile's lse, then delta
      cluster_sum(s, cluster, G, ex, wr, g, t);
      if (half) cluster_sum(dp, cluster, G, ex + T * EP, wr, g, t);
#pragma unroll
      for (int kk = 0; kk < TL / 8; ++kk) {
        const float2 l = *reinterpret_cast<const float2*>(rows + 8 * kk + 2 * t);
        const float2 d = *reinterpret_cast<const float2*>(rows + TL + 8 * kk + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(fmaf(s[kk][e], s2[e >> 1], -((e & 1) ? l.y : l.x) * LOG2E));
          s[kk][e] = counts[e >> 1] ? pe : 0.f;
          if (half) s[kk][e] = s[kk][e] * (dp[kk][e] - ((e & 1) ? d.y : d.x)) * ds_scale[e >> 1];
        }
      }
      to_fragments(xh, xl, s);
      // dV_c += P^T dO_c (warps 0-3), dK_c += dS^T Q_c (4-7)
      output_product<16>(acc, xh, xl, slot + (half ? 0 : TL * LDF) + 2 * t * LDF + g);
    }
    if (tile % ntiles == ntiles - 1) {  // the pass's output chunk is done
      const int cc = chunk_of(u);
      float* o = (half || DQ ? out_s : out_p) + (int64_t)b * own_rows * do_rs + h * DH + cc * CW + (DQ ? 64 * half : 0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + wr + g + 8 * e;
        if (row >= own_rows) continue;
#pragma unroll
        for (int n = 0; n < (DQ ? 8 : 16); ++n)
          *reinterpret_cast<float2*>(o + row * do_rs + 8 * n + 2 * t) = make_float2(acc[n][2 * e], acc[n][2 * e + 1]);
      }
      zero<DQ ? 8 : 16>(acc);
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // no block leaves while another reads its exchange buffer
}

__global__ void __launch_bounds__(FG, 1)
dq_3xtf32_chunked(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
                  const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
                  const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
                  const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  float* __restrict__ dq, int N, int M, int H, float scale, int C) {
  extern __shared__ __align__(16) float fsm[];
  chunked_bwd_tf32<true>(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout, lse, delta, dq, nullptr, N, M, H,
                         scale, C, fsm);
}

__global__ void __launch_bounds__(FG, 1)
dkdv_3xtf32_chunked(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
                    const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
                    const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
                    const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, int N, int M, int H, float scale, int C) {
  extern __shared__ __align__(16) float fsm[];
  float* d = const_cast<float*>(delta);  // read only
  chunked_bwd_tf32<false>(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout, lse, d, dk, dv, N, M, H, scale,
                          C, fsm);
}

// ------------------------------------------------------------------ bf16: clusters, wgmma
//
// The f32 pair's cluster, in bf16 on warpgroup products: G blocks (along y)
// share one 64-row tile of one (b, head); block r owns chunks r, r + G, ...
// Per 64-row loop tile each block multiplies only its own chunks into
// partial S (warpgroup 0) and dP (warpgroup 1), 64 x 64 each
// (wgmma.m64n64k16, both operands in shared memory in the 128-byte
// swizzle), leaves them in its exchange buffer, and after one cluster
// barrier adds the G partials through distributed shared memory in rank
// order, so every block holds the same S and dP. Then its output product
// with the loop tile's chunk, A from registers: dQ_c += dS K_c (warpgroup
// w: the keys of half w of the tile, all 64 rows and 128 values; the two
// halves' sums added at the end of the pass) or dV_c += P^T dO_c
// (warpgroup 0) and dK_c += dS^T Q_c (warpgroup 1). dQ's delta pass
// exchanges S only: each block adds rowsum(P dP_c) over its own chunks from
// its own partial dP, and the cluster adds the 64 rows' sums once, at the
// end of the pass.

constexpr int CHUNK_TILE = 2 * WG_TILE_BYTES;  // 64 rows of a chunk: two 64-value panels in the 128-byte swizzle
constexpr int PANEL = WG_TILE_BYTES >> 4;      // the second panel's step in a descriptor (16-byte units)
constexpr int RINGB = 3;                       // ring stages
constexpr int SLOT_B = 2 * CHUNK_TILE + 1024;  // a ring slot: the loop tile's two chunk tiles, then lse and delta rows
constexpr int PART_F = T / 8 * GROUP * 4;      // floats of a warpgroup's 64 x 64 partial: 8 float4 a thread
constexpr int EXCH_BF = 2 * PART_F;             // an exchange buffer: partial S, then partial dP
// the own tiles, the ring, two exchange buffers and dK/dV's P; dQ adds its key bits
constexpr int BF16_SMEM_BYTES = 1024 + 2 * CHUNK_TILE + RINGB * SLOT_B + (2 * EXCH_BF + PART_F) * 4;

__host__ __device__ constexpr int bf16_smem_bytes(int key_tiles) { return BF16_SMEM_BYTES + 8 * key_tiles; }

// 2^x, one instruction (as csrc/attention.cu's): relative error ~2^-22
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// part (the warpgroup's 64 own rows x 64 loop rows in wgmma's C layout:
// this thread's rows wr + g, + 8 and loop rows 8n + 2t, + 1 at part[n])
// = or += Own . Loop^T over one chunk's 128 values, `own` and `loop` the
// chunk tiles' descriptors; committed, not waited for.
__device__ __forceinline__ void partial_wg(float* part, uint64_t own, uint64_t loop, bool accumulate) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < CW / 16; ++ks) {
    const int step = (ks / 4) * PANEL + 2 * (ks % 4);
    wgmma_ss(part, own + step, loop + step, accumulate || ks > 0);
  }
  wg_commit();
}

// acc (the warpgroup's 64 own rows x the chunk's 128 values, acc[0 .. 7]
// the first panel's n-tiles, acc[8 ..] the second's) += X . Y over NK
// k-steps of 16 loop rows from k-step kk0: X's A fragments (this warp's 16
// rows), Y the loop tile's chunk (loop rows x values); waited for.
template <int NK>
__device__ __forceinline__ void output_wg(float (*acc)[4], const uint32_t (*xa)[4], uint64_t y, int kk0) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    wgmma_rs(&acc[0][0], xa[kk], y + 128 * (kk0 + kk));
    wgmma_rs(&acc[8][0], xa[kk], y + PANEL + 128 * (kk0 + kk));
  }
  wg_commit();
  wg_wait<0>(&acc[0][0]);
  wg_wait<0>(&acc[8][0]);
}

// This warp's rows of an output chunk (acc: the C layout of rows wr + g,
// + 8 and the chunk's 128 values) as bf16 into `tile`, 64 rows of 256
// bytes, 16-byte piece c of row r at piece c ^ (r % 8): a warp's stores on
// distinct banks.
__device__ __forceinline__ void put_out(unsigned char* tile, const float (*acc)[4], int wr, int g, int t) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = wr + g + 8 * e;
#pragma unroll
    for (int n = 0; n < CW / 8; ++n)
      *reinterpret_cast<uint32_t*>(tile + row * CW * 2 + ((n ^ (row % 8)) * 16) + 4 * t) =
          pack_bf16(acc[n][2 * e], acc[n][2 * e + 1]);
  }
}

// `put_out`'s tile into values col .. col + 127 of rows r0 .. of a
// contiguous (., rows, width) bf16 output, 16 bytes a thread and step.
__device__ __forceinline__ void copy_out(__nv_bfloat16* out, const unsigned char* tile, int b, int rows, int width,
                                         int col, int r0, int tid) {
  for (int i = tid; i < T * CW / 8; i += FG) {
    const int row = i / (CW / 8), c = i % (CW / 8);
    if (r0 + row >= rows) continue;
    *reinterpret_cast<uint4*>(out + ((int64_t)b * rows + r0 + row) * width + col + 8 * c) =
        *reinterpret_cast<const uint4*>(tile + row * CW * 2 + ((c ^ (row % 8)) * 16));
  }
}

// A warpgroup's 64 x 64 f32 tile in shared memory as its threads hold it:
// n-tile n of thread gt (4 values of the C layout) at float4 GROUP n + gt,
// so that a warp's accesses are 512 contiguous bytes, and every warpgroup's
// thread gt holds the same entries.
__device__ __forceinline__ void put_tile(float* tile, const float (*c)[4], int gt) {
#pragma unroll
  for (int n = 0; n < T / 8; ++n)
    *reinterpret_cast<float4*>(tile + 4 * (GROUP * n + gt)) = make_float4(c[n][0], c[n][1], c[n][2], c[n][3]);
}

// x[n] = n-tile n0 + n of this thread's entries of tile `tile`
template <int NX>
__device__ __forceinline__ void get_tile(float (*x)[4], const float* tile, int n0, int gt) {
#pragma unroll
  for (int n = 0; n < NX; ++n) {
    const float4 v = *reinterpret_cast<const float4*>(tile + 4 * (GROUP * (n0 + n) + gt));
    x[n][0] = v.x;
    x[n][1] = v.y;
    x[n][2] = v.z;
    x[n][3] = v.w;
  }
}

// x[n] = the cluster's sum, in rank order, of exchange tile `tile` at this
// thread's n-tile n0 + n
template <int NX>
__device__ __forceinline__ void sum_tile(float (*x)[4], cg::cluster_group& cluster, int G, int r, const float* tile,
                                         int n0, int gt) {
  zero<NX>(x);
  for (int o = 0; o < G; ++o) {
    const float* p = (o == r ? tile : cluster.map_shared_rank(tile, o)) + 4 * (GROUP * n0 + gt);
    float4 v[NX];
#pragma unroll
    for (int n = 0; n < NX; ++n) v[n] = *reinterpret_cast<const float4*>(p + 4 * GROUP * n);
#pragma unroll
    for (int n = 0; n < NX; ++n) {
      x[n][0] += v[n].x;
      x[n][1] += v[n].y;
      x[n][2] += v[n].z;
      x[n][3] += v[n].w;
    }
  }
}

// The cluster barrier in two halves. Arrive, once this block's partials
// are written: a block barrier, one thread's release fence at cluster scope
// (cumulative: it covers the writes that the block barrier ordered before
// it), a block barrier, then every thread's relaxed arrival; a release by
// every thread takes longer (PERF.md). Wait: every block has arrived.
__device__ __forceinline__ void cluster_arrive() {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  __syncthreads();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One block of the cluster. dQ (DQ): a delta pass over the key tiles, then
// one output pass per owned chunk; dK/dV: one output pass per owned chunk.
// A pass walks the loop tiles; a tile takes one ring step per owned chunk,
// the output pass's own chunk last, so that its loop tile is in the ring
// for the output product. With one chunk a block (ONE: C <= 8) the own rows
// are staged once, and the next tile's partial products are issued between
// this tile's arrive and wait at the cluster barrier, so they run while the
// barrier completes and the partner's partials are read; with several, each
// step stages its chunk's own rows and then multiplies.
template <bool DQ, bool ONE>
__device__ __forceinline__ void chunked_bwd(const CUtensorMap* map_own_s, const CUtensorMap* map_own_p,
                                            const CUtensorMap* map_loop_s, const CUtensorMap* map_loop_p,
                                            const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                                            float* __restrict__ delta, __nv_bfloat16* __restrict__ out_s,
                                            __nv_bfloat16* __restrict__ out_p, int N, int M, int H, float scale, int C,
                                            unsigned char* smem_raw) {
  __shared__ float row_num[2][T], row_den[2][T], row_delta[T];  // dQ: each half's row sums, and delta
  __shared__ uint64_t bars[RINGB + 1];                             // the ring's slots', then the own tiles' arrivals
  cg::cluster_group cluster = cg::this_cluster();
  const int G = cluster.num_blocks(), r = cluster.block_rank(), nr = ONE ? 1 : C / G;
  const int b = blockIdx.z, h = blockIdx.y / G, r0 = blockIdx.x * T, tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4, wr = 16 * (w % 4), half = w / 4;
  const int gt = tid % GROUP;
  const int DH = C * CW;
  const int own_rows = DQ ? N : M, loop_rows = DQ ? M : N, ntiles = (loop_rows + T - 1) / T;
  const float* lse_b = lse + ((int64_t)b * H + h) * N;
  float* delta_b = delta + ((int64_t)b * H + h) * N;
  unsigned char* own = align_1024(smem_raw);  // S's and dP's own chunk tiles
  unsigned char* ring = own + 2 * CHUNK_TILE;
  float* exch = reinterpret_cast<float*>(ring + RINGB * SLOT_B);
  float* ptile = exch + 2 * EXCH_BF;                                   // dK/dV: P, from warpgroup 0 to 1
  uint32_t* key_bits = reinterpret_cast<uint32_t*>(ptile + PART_F);  // dQ: the batch element's valid keys

  // flat steps: pass (dQ: 0 the delta pass), loop tile, chunk step i < nr.
  // Output pass p's tile takes chunks r + G ((p + 1 + i) % nr): its own, r + p G, last.
  const int pass0 = DQ ? 1 : 0, per_pass = ntiles * nr, steps = (pass0 + nr) * per_pass;
  auto chunk_of = [&](int u) {
    const int p = u / per_pass - pass0;
    return r + G * ((p + 1 + u % nr) % nr);  // the delta pass (p = -1): r, r + G, ...
  };
  auto stage_own = [&](int cc) {  // by one thread of warpgroup 1, the less busy one
    mbar_expect(&bars[RINGB], 2 * CHUNK_TILE);
    load_chunk(own, map_own_s, h * DH + cc * CW, r0, b, &bars[RINGB]);
    load_chunk(own + CHUNK_TILE, map_own_p, h * DH + cc * CW, r0, b, &bars[RINGB]);
  };
  auto stage = [&](int u) {  // step u's loop tile, its chunk (one thread), and (dK/dV) the tile's lse and delta rows
    unsigned char* slot = ring + (u % RINGB) * SLOT_B;
    const int j0 = (u / nr) % ntiles * T, cc = chunk_of(u);
    if (tid == GROUP) {
      mbar_expect(&bars[u % RINGB], 2 * CHUNK_TILE);
      load_chunk(slot, map_loop_s, h * DH + cc * CW, j0, b, &bars[u % RINGB]);
      load_chunk(slot + CHUNK_TILE, map_loop_p, h * DH + cc * CW, j0, b, &bars[u % RINGB]);
    }
    if (!DQ && tid < 2 * T) {  // rows past N: lse = delta = 0 beside dO = 0
      float* rows = reinterpret_cast<float*>(slot + 2 * CHUNK_TILE);
      const int j = tid % T;
      const bool ok = j0 + j < N;
      const float* src = tid < T ? lse_b : delta_b;
      cp_async_4(rows + tid, ok ? src + j0 + j : src, ok);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < RINGB + 1; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (nr == 1 && tid == GROUP) stage_own(r);
  stage(0);
  cp_async_commit();
  if (steps > 1) stage(1);
  cp_async_commit();
  // the factors of this lane's own rows wr + g, + 8: dQ, the rows' lse log2 e
  // (P = 0 past N); dK/dV, the keys' states as `dkdv_mma` takes them
  float l2[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f}, ds_scale[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  bool counts[2] = {false, false};
  const bool dead = DQ ? false : dead_batch(mask, b, M);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = r0 + wr + g + 8 * e;
    if constexpr (DQ) {
      l2[e] = row < N ? lse_b[row] * LOG2E : INFINITY;
    } else {
      const KeyRow key = key_row(key_state(mask, b, M, row, dead), scale);
      s2[e] = key.s_scale * LOG2E;
      ds_scale[e] = key.ds_scale;
      counts[e] = key.counts;
    }
  }
  if constexpr (DQ) {  // a bit a key, 0 past M: only valid keys carry P (a dead element needs no flag)
    for (int base = 32 * w; base < ntiles * T; base += 32 * (FG / 32)) {
      const int key = base + lane;
      const uint32_t word = __ballot_sync(0xffffffffu, key < M && (mask == nullptr || mask[(int64_t)b * M + key]));
      if (lane == 0) key_bits[base / 32] = word;
    }
  }
  cp_async_wait<1>();  // step 0's lse and delta rows have landed
  if (nr == 1) mbar_wait(&bars[RINGB], 0);  // and the own tiles
  cluster.sync();  // every block of the cluster runs: its shared memory may be read

  const uint64_t own_desc = wg_desc(smem_addr(own + half * CHUNK_TILE));
  auto loop_desc = [&](int u, int tile) { return wg_desc(smem_addr(ring + (u % RINGB) * SLOT_B + tile * CHUNK_TILE)); };
  constexpr int NT = T / 8, NQ = NT / 2;  // a tile's n-tiles; dQ: a warpgroup's half of them
  float part[NT][4], acc[CW / 8][4];
  zero<CW / 8>(acc);
  float num[2] = {0.f, 0.f}, den[2] = {0.f, 0.f};
  if constexpr (ONE) {
    mbar_wait(&bars[0], 0);
    partial_wg(&part[0][0], own_desc, loop_desc(0, half), false);
  }
  for (int u = 0; u < steps; ++u) {
    const int i = u % nr, tile = u / nr, pass = u / per_pass, j0 = tile % ntiles * T;
    const bool last = ONE || i == nr - 1;  // the tile's last chunk step: exchange, P and dS, output product
    const bool delta_pass = DQ && pass == 0;
    unsigned char* slot = ring + (u % RINGB) * SLOT_B;
    if constexpr (!ONE) {
      __syncthreads();  // this step's own chunk; every thread is done with the last one's
      if (tid == GROUP) stage_own(chunk_of(u));
      mbar_wait(&bars[RINGB], u & 1);
      mbar_wait(&bars[u % RINGB], (u / RINGB) & 1);  // step u's tiles have landed
      partial_wg(&part[0][0], own_desc, loop_desc(u, half), i > 0);  // S (warpgroup 0), dP (1)
    }
    // dQ: which of the keys of this warpgroup's half of the tile are valid, bits 2n + e
    uint32_t ok = 0;
    if (DQ && last) {
      const uint64_t word = *reinterpret_cast<const uint64_t*>(key_bits + j0 / 32);
#pragma unroll
      for (int n = 0; n < NQ; ++n) ok |= (uint32_t)((word >> (8 * (half * NQ + n) + 2 * t)) & 3u) << (2 * n);
    }
    wg_wait<0>(&part[0][0]);
    float* ex = exch + (tile % 2) * EXCH_BF;  // a tile's buffer; the next tile writes the other
    if (last) put_tile(ex + half * PART_F, part, gt);  // dQ's delta pass: the partial dP is for this block only
    if (!last) {
      cp_async_wait<0>();  // step u + 1's lse and delta rows have landed
      __syncthreads();
      if (u + RINGB - 1 < steps) stage(u + RINGB - 1);  // into step u - 1's slot
      cp_async_commit();
      continue;
    }
    cluster_arrive();    // the partials are written
    if constexpr (ONE) {  // the next tile's partial products (at the last, this tile's again, unused)
      const int un = u + 1 < steps ? u + 1 : u;
      mbar_wait(&bars[un % RINGB], (un / RINGB) & 1);
      partial_wg(&part[0][0], own_desc, loop_desc(un, half), false);
    }
    cp_async_wait<0>();  // step u + 1's lse and delta rows have landed
    __syncthreads();     // and are every thread's; every thread is done with step u - 1's slot
    if (u + RINGB - 1 < steps) stage(u + RINGB - 1);
    cp_async_commit();
    cluster_wait();  // every block's partials are written

    const uint64_t y_s = loop_desc(u, 0), y_p = loop_desc(u, 1);
    uint32_t xa[T / 16][4];
    if constexpr (DQ) {
      // S, and dP (the delta pass: this block's partial), on this warpgroup's half of the tile's keys
      float s[NQ][4], dp[NQ][4];
      sum_tile<NQ>(s, cluster, G, r, ex, half * NQ, gt);
      if (delta_pass) {
        get_tile<NQ>(dp, ex + PART_F, half * NQ, gt);
      } else {
        sum_tile<NQ>(dp, cluster, G, r, ex + PART_F, half * NQ, gt);
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // the exponential outside the choice: no branch
          const float pe = ex2(fmaf(s[n][e], scale * LOG2E, -l2[e >> 1]));
          s[n][e] = (ok >> (2 * n + (e & 1))) & 1u ? pe : 0.f;
        }
      if (delta_pass) {  // rowsum(P dP_c) over this block's chunks, and rowsum(P)
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            num[e >> 1] = fmaf(s[n][e], dp[n][e], num[e >> 1]);
            den[e >> 1] += s[n][e];
          }
        if (tile == ntiles - 1) {  // delta = rowsum(P dP) / rowsum(P): the row's 4 lanes, 2 halves, then the cluster
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            num[e] += __shfl_xor_sync(0xffffffffu, num[e], 1);
            num[e] += __shfl_xor_sync(0xffffffffu, num[e], 2);
            den[e] += __shfl_xor_sync(0xffffffffu, den[e], 1);
            den[e] += __shfl_xor_sync(0xffffffffu, den[e], 2);
            if (t == 0) {
              row_num[half][wr + g + 8 * e] = num[e];
              row_den[half][wr + g + 8 * e] = den[e];
            }
          }
          cluster.sync();
          if (tid < T) {  // in rank order, in every block
            float sn = 0.f;
            for (int o = 0; o < G; ++o) {
              const float* rn = cluster.map_shared_rank(&row_num[0][0], o);
              sn += rn[tid] + rn[T + tid];
            }
            const float sd = row_den[0][tid] + row_den[1][tid], d = sd > 0.f ? sn / sd : 0.f;
            row_delta[tid] = d;
            if (r == 0 && r0 + tid < N) delta_b[r0 + tid] = d;
          }
          __syncthreads();
#pragma unroll
          for (int e = 0; e < 2; ++e) delta_r[e] = row_delta[wr + g + 8 * e];
        }
        continue;
      }
      // dQ_c += dS K_c over this warpgroup's keys
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] * (dp[n][e] - delta_r[e >> 1]) * scale;
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) c_to_a(xa[kk], s + 2 * kk);
      output_wg<NQ / 2>(acc, xa, y_s, half * NQ / 2);
    } else {
      // warpgroup 0: S, then P, which it hands to warpgroup 1; warpgroup 1: dP, then dS in its place
      const float* rows = reinterpret_cast<const float*>(slot + 2 * CHUNK_TILE);  // the tile's lse, then delta
      float s[NT][4], dp[NT][4];
      if (half) {
        sum_tile<NT>(dp, cluster, G, r, ex + PART_F, 0, gt);
      } else {
        sum_tile<NT>(s, cluster, G, r, ex, 0, gt);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 l = *reinterpret_cast<const float2*>(rows + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = ex2(fmaf(s[n][e], s2[e >> 1], -((e & 1) ? l.y : l.x) * LOG2E));
            s[n][e] = counts[e >> 1] ? pe : 0.f;
          }
        }
        put_tile(ptile, s, gt);
      }
      __syncthreads();  // P is in
      if (half) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float4 p = *reinterpret_cast<const float4*>(ptile + 4 * (GROUP * n + gt));
          const float2 d = *reinterpret_cast<const float2*>(rows + T + 8 * n + 2 * t);
          const float pn[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[n][e] = pn[e] * (dp[n][e] - ((e & 1) ? d.y : d.x)) * ds_scale[e >> 1];
        }
#pragma unroll
        for (int kk = 0; kk < T / 16; ++kk) c_to_a(xa[kk], dp + 2 * kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < T / 16; ++kk) c_to_a(xa[kk], s + 2 * kk);
      }
      output_wg<T / 16>(acc, xa, half ? y_s : y_p, 0);  // dV_c += P^T dO_c (warpgroup 0), dK_c += dS^T Q_c (1)
    }
    if (tile % ntiles == ntiles - 1) {  // the pass's output chunk is done: out through the own tiles' space
      const int col = (h * C + chunk_of(u)) * CW;
      if constexpr (DQ) {  // the two halves' sums over the keys, in order, through the exchange buffers
        cluster.sync();  // no block reads this block's exchange buffers any more
        if (half) put_partial<CW / 8>(exch, acc, gt);
        __syncthreads();
        if (!half) {
          add_partial<CW / 8>(acc, exch, gt);
          put_out(own, acc, wr, g, t);
        }
        __syncthreads();
        copy_out(out_s, own, b, own_rows, H * DH, col, r0, tid);
      } else {
        put_out(own + half * CHUNK_TILE, acc, wr, g, t);  // dV, dK
        __syncthreads();
        copy_out(out_p, own, b, own_rows, H * DH, col, r0, tid);
        copy_out(out_s, own + CHUNK_TILE, b, own_rows, H * DH, col, r0, tid);
      }
      fence_async_smem();  // before the next pass's own tiles land there
      zero<CW / 8>(acc);
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // no block leaves while another reads its shared memory
}

// q, k, v and dout as tensor maps (`bf16_map`): S's operands (own, loop)
// are (Q, K) for dQ and (K, Q) for dK/dV, dP's (dO, V) and (V, dO).
template <bool ONE>
__global__ void __launch_bounds__(FG, 1)
dq_chunked(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
           const uint8_t* __restrict__ mask, const float* __restrict__ lse, float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dq, int N, int M, int H, float scale, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  chunked_bwd<true, ONE>(&map_q, &map_do, &map_k, &map_v, mask, lse, delta, dq, nullptr, N, M, H, scale, C, smem);
}

template <bool ONE>
__global__ void __launch_bounds__(FG, 1)
dkdv_chunked(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
             const uint8_t* __restrict__ mask, const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N, int M, int H, float scale, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* d = const_cast<float*>(delta);  // read only
  chunked_bwd<false, ONE>(&map_k, &map_v, &map_q, &map_do, mask, lse, d, dk, dv, N, M, H, scale, C, smem);
}

// ------------------------------------------------------------------ launch

#define BWD_IN(T_)                                                                   \
  const T_ *q, int64_t q_bs, int64_t q_rs, const T_ *k, int64_t k_bs, int64_t k_rs, \
      const T_ *v, int64_t v_bs, int64_t v_rs, const uint8_t *mask, const T_ *dout, \
      const float *lse
#define BWD_IN_PASS q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout, lse

// Heads of DH = C * 128 values, C >= 2, or the call's error.
__host__ __device__ constexpr bool chunked_width(int DH) { return DH > CW && DH % CW == 0; }

// A cluster of `cluster_blocks(C)` blocks along y per 64 own rows of one
// (b, head), blockIdx.y = head G + rank; a launch the card refuses (no
// cluster of that many such blocks fits) is the call's error.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int G, int bytes, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = G;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(FG);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int run_chunked_bf16(BWD_IN(__nv_bfloat16), float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                     int B, int N, int M, int H, int DH, float scale, cudaStream_t stream) {
  if (!chunked_width(DH)) return static_cast<int>(cudaErrorInvalidValue);
  const int C = DH / CW, G = cluster_blocks(C);
  CUtensorMap mq, mk, mv, mdo;
  if (!bf16_map(&mq, q, q_bs, q_rs, B, N, H * DH) || !bf16_map(&mk, k, k_bs, k_rs, B, M, H * DH) ||
      !bf16_map(&mv, v, v_bs, v_rs, B, M, H * DH) ||
      !bf16_map(&mdo, dout, (int64_t)N * H * DH, (int64_t)H * DH, B, N, H * DH))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool one = G == C;  // a chunk a block
  if (dq != nullptr)
    return static_cast<int>(launch_cluster(one ? dq_chunked<true> : dq_chunked<false>, dim3((N + T - 1) / T, H * G, B),
                                           G, bf16_smem_bytes((M + T - 1) / T), stream, mq, mk, mv, mdo, mask, lse,
                                           delta, dq, N, M, H, scale, C));
  return static_cast<int>(launch_cluster(one ? dkdv_chunked<true> : dkdv_chunked<false>,
                                         dim3((M + T - 1) / T, H * G, B), G, bf16_smem_bytes(0), stream, mq, mk, mv,
                                         mdo, mask, lse, static_cast<const float*>(delta), dk, dv, N, M, H, scale, C));
}

int run_chunked_f32(BWD_IN(float), float* delta, float* dq, float* dk, float* dv, int B, int N, int M, int H, int DH,
                    float scale, cudaStream_t stream) {
  if (!chunked_width(DH)) return static_cast<int>(cudaErrorInvalidValue);
  const int C = DH / CW, G = cluster_blocks(C);
  if (dq != nullptr)
    return static_cast<int>(launch_cluster(dq_3xtf32_chunked, dim3((N + T - 1) / T, H * G, B), G, TF32_SMEM_BYTES,
                                           stream, BWD_IN_PASS, delta, dq, N, M, H, scale, C));
  return static_cast<int>(launch_cluster(dkdv_3xtf32_chunked, dim3((M + T - 1) / T, H * G, B), G, TF32_SMEM_BYTES,
                                         stream, BWD_IN_PASS, static_cast<const float*>(delta), dk, dv, N, M, H, scale,
                                         C));
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
// lse and delta are (B, H, N) f32; DH is a multiple of 128 above it. bf16:
// q, k, v, dout rows are 16-byte aligned. The dQ kernel writes delta and
// runs first; the dK/dV kernel reads it.
extern "C" int attention_dq_bf16(C_IN, void* dq, C_TAIL) {
  using T_ = __nv_bfloat16;
  return run_chunked_bf16(C_IN_PASS(T_), static_cast<T_*>(dq), nullptr, nullptr, C_TAIL_PASS);
}

extern "C" int attention_dkdv_bf16(C_IN, void* dk, void* dv, C_TAIL) {
  using T_ = __nv_bfloat16;
  return run_chunked_bf16(C_IN_PASS(T_), nullptr, static_cast<T_*>(dk), static_cast<T_*>(dv), C_TAIL_PASS);
}

extern "C" int attention_dq_f32(C_IN, void* dq, C_TAIL) {
  return run_chunked_f32(C_IN_PASS(float), static_cast<float*>(dq), nullptr, nullptr, C_TAIL_PASS);
}

extern "C" int attention_dkdv_f32(C_IN, void* dk, void* dv, C_TAIL) {
  return run_chunked_f32(C_IN_PASS(float), nullptr, static_cast<float*>(dk), static_cast<float*>(dv), C_TAIL_PASS);
}
