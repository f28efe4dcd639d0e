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
// `dkdv_chunked` (mma.sync), one body (`chunked_bwd`) in three roles. A
// block owns 64 rows of one (b, head) and one 128-value chunk c of one
// output: dQ_c, dK_c or dV_c (dK and dV in blocks of their own, so a
// block's accumulators are those of width 128 and dV's blocks need no dP).
// Per tile of the other side it adds S and dP over the head's C chunks, one
// ring step a chunk product with the own side's and the tile's chunk staged
// together (2 slots of two padded 64 x 128 tiles and a tile's lse / delta
// rows), then takes one step with the tile's chunk c for the output's
// product with dS or P. dQ's delta pass runs in every chunk block (S and dP
// over the keys, the same for every chunk), and chunk 0 writes delta. Work:
// dQ C (4 C + 1) chunk products for the function's 3 C, dK/dV C (3 C + 2)
// for 4 C (3x and 2x at 256; PERF.md).
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

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CW = 128;  // head values a chunk
enum Role { ROLE_DQ, ROLE_DK, ROLE_DV };

// bf16: a ring slot holds two padded 64 x 128 tiles, then a loop tile's lse
// and delta rows.
constexpr int CHUNK_TILE = tile_elems<CW>();
constexpr int CHUNK_SLOT_BYTES = 2 * CHUNK_TILE * 2 + 2 * T * 4;

// One block's output chunk: dQ_c = dS K_c with delta (ROLE_DQ: two passes
// over the keys, the first for delta, which chunk 0 writes), dK_c = dS^T Q_c
// (ROLE_DK) or dV_c = P^T dO_c (ROLE_DV, which needs no dP), with the key
// masking, dead elements and delta of `dq_mma` / `dkdv_mma`. One warpgroup.
template <int ROLE>
__device__ __forceinline__ void chunked_bwd(const __nv_bfloat16* __restrict__ q, int64_t q_bs, int64_t q_rs,
                                            const __nv_bfloat16* __restrict__ k, int64_t k_bs, int64_t k_rs,
                                            const __nv_bfloat16* __restrict__ v, int64_t v_bs, int64_t v_rs,
                                            const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
                                            const float* __restrict__ lse, float* __restrict__ delta,
                                            __nv_bfloat16* __restrict__ out, int N, int M, int H, float scale,
                                            int C, int head_chunk, unsigned char* smem) {
  constexpr bool DQ = ROLE == ROLE_DQ;
  constexpr int LD = CW + PAD;
  const int b = blockIdx.z, h = head_chunk / C, c = head_chunk % C, tid = threadIdx.x;
  const int lane = tid % 32, wr = (tid / 32) * 16, g = lane / 4, t = lane % 4;
  const int DH = C * CW, r0 = blockIdx.x * T;  // the block's own rows r0 .. r0 + 63
  const int own_rows = DQ ? N : M, loop_rows = DQ ? M : N, ntiles = (loop_rows + T - 1) / T;
  const int64_t do_rs = (int64_t)H * DH;
  const __nv_bfloat16* qh = q + b * q_bs + h * DH;
  const __nv_bfloat16* kh = k + b * k_bs + h * DH;
  const __nv_bfloat16* vh = v + b * v_bs + h * DH;
  const __nv_bfloat16* doh = dout + b * N * do_rs + h * DH;
  // S's operands (own, loop): (Q, K) for dQ, (K, Q) for dK / dV; dP's (dO, V), (V, dO)
  const __nv_bfloat16* own_s = DQ ? qh : kh;
  const __nv_bfloat16* own_p = DQ ? doh : vh;
  const __nv_bfloat16* loop_s = DQ ? kh : qh;
  const __nv_bfloat16* loop_p = DQ ? vh : doh;
  const int64_t own_s_rs = DQ ? q_rs : k_rs, own_p_rs = DQ ? do_rs : v_rs;
  const int64_t loop_s_rs = DQ ? k_rs : q_rs, loop_p_rs = DQ ? v_rs : do_rs;
  const float* lse_b = lse + ((int64_t)b * H + h) * N;
  float* delta_b = delta + ((int64_t)b * H + h) * N;
  // the steps of a loop tile: `prods` chunk products (S, then dP), then the output's
  const int prods = ROLE == ROLE_DV ? C : 2 * C, per_tile = prods + 1;
  const int pass1 = DQ ? ntiles * prods : 0;  // dQ's delta pass: S and dP only
  const int steps = pass1 + ntiles * per_tile;

  // step u's tiles into its slot: the own side's and the loop tile's chunk
  // of a product, or the loop tile's chunk c of the output's product (K_c,
  // Q_c, dO_c) and, for dK / dV, the loop tile's lse and delta
  auto stage = [&](int u) {
    unsigned char* slot = smem + (u % STAGES) * CHUNK_SLOT_BYTES;
    __nv_bfloat16* ta = reinterpret_cast<__nv_bfloat16*>(slot);
    const int w = u < pass1 ? u : u - pass1, per = u < pass1 ? prods : per_tile;
    const int j0 = w / per * T, sub = w % per;
    if (sub < prods) {
      const int cc = sub % C;
      const bool p = sub >= C;
      stage_tile<CW, GROUP>(ta, (p ? own_p : own_s) + cc * CW, p ? own_p_rs : own_s_rs, r0, own_rows, tid);
      stage_tile<CW, GROUP>(ta + CHUNK_TILE, (p ? loop_p : loop_s) + cc * CW, p ? loop_p_rs : loop_s_rs, j0,
                            loop_rows, tid);
      return;
    }
    if (ROLE == ROLE_DV) {
      stage_tile<CW, GROUP>(ta + CHUNK_TILE, doh + c * CW, do_rs, j0, N, tid);
    } else {
      stage_tile<CW, GROUP>(ta + CHUNK_TILE, loop_s + c * CW, loop_s_rs, j0, loop_rows, tid);
    }
    if (!DQ) {  // rows past N: lse = delta = 0 beside dO = 0
      float* rows = reinterpret_cast<float*>(slot + 2 * CHUNK_TILE * 2);
      const int j = tid % T;
      const bool ok = j0 + j < N;
      const float* src = tid < T ? lse_b : delta_b;
      cp_async_4(rows + tid, ok ? src + j0 + j : src, ok);
    }
  };

  stage(0);
  cp_async_commit();
  // the key states: for dQ the batch element's valid keys, once per block
  // (only valid keys carry dS, so a dead element needs no flag); for dK / dV
  // the factors of this thread's two own keys
  uint8_t* valid = smem + STAGES * CHUNK_SLOT_BYTES;  // dQ: [ntiles * T]
  float lse_r[2] = {0.f, 0.f};                        // dQ: the own rows' lse
  KeyRow key[2];
  if constexpr (DQ) {
    for (int j = tid; j < ntiles * T; j += GROUP) valid[j] = j < M && (mask == nullptr || mask[(int64_t)b * M + j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) lse_r[r] = r0 + wr + g + 8 * r < N ? lse_b[r0 + wr + g + 8 * r] : INFINITY;
  } else {
    own_key_rows(key, mask, b, M, r0 + wr + g, scale);
  }
  const uint32_t lane_nt = nt_lane_offset<CW>(lane), lane_tn = tn_lane_offset<CW>(lane);

  // P of S in place: rows = own g, g + 8 of the warp, columns = loop 8n + 2t + {0, 1}
  auto probs = [&](float (*s)[4], const float* lse_s, int j0) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if constexpr (DQ) {
        const uchar2 ok = *reinterpret_cast<const uchar2*>(valid + j0 + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // the exponential outside the choice: no branch
          const float pe = __expf(fmaf(s[n][e], scale, -lse_r[e >> 1]));
          s[n][e] = ((e & 1) ? ok.y : ok.x) ? pe : 0.f;
        }
      } else {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = p_of(s[n][e], key[e >> 1], (e & 1) ? l2.y : l2.x);
      }
    }
  };

  float s[8][4], dp[8][4], acc[CW / 8][4];
  zero<CW / 8>(acc);
  float num[2] = {0.f, 0.f}, den[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  for (int u = 0; u < steps; ++u) {
    if (DQ && u == pass1) {  // delta = rowsum(P dP) / rowsum(P); the 4 threads of a row group share a row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        num[r] += __shfl_xor_sync(0xffffffffu, num[r], 1);
        num[r] += __shfl_xor_sync(0xffffffffu, num[r], 2);
        den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
        den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
        delta_r[r] = den[r] > 0.f ? num[r] / den[r] : 0.f;
        if (c == 0 && t == 0 && r0 + wr + g + 8 * r < N) delta_b[r0 + wr + g + 8 * r] = delta_r[r];
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // step u's tiles have landed; step u - 1's slot is read no more
    if (u + 1 < steps) stage(u + 1);
    cp_async_commit();
    const unsigned char* slot = smem + (u % STAGES) * CHUNK_SLOT_BYTES;
    const __nv_bfloat16* ta = reinterpret_cast<const __nv_bfloat16*>(slot);
    const uint32_t tb = smem_addr(ta + CHUNK_TILE);
    const int w = u < pass1 ? u : u - pass1, per = u < pass1 ? prods : per_tile;
    const int j0 = w / per * T, sub = w % per;
    if (sub < C) {  // S += own_c' loop_c'^T
      if (sub == 0) zero<8>(s);
      mma_nt_tile<CW>(s, a_lane_addr<CW>(ta, wr, lane), tb + lane_nt);
    } else if (sub < prods) {  // dP += own_c' loop_c'^T
      if (sub == C) zero<8>(dp);
      mma_nt_tile<CW>(dp, a_lane_addr<CW>(ta, wr, lane), tb + lane_nt);
    }
    if (u < pass1) {
      if (sub == prods - 1) {  // dQ's delta pass: the tile's rowsum(P dP) and rowsum(P)
        probs(s, nullptr, j0);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            num[e >> 1] += s[n][e] * dp[n][e];
            den[e >> 1] += s[n][e];
          }
      }
      continue;
    }
    if (sub < prods) continue;
    // the tile's output product with chunk c: X = dS (dQ, dK) or P (dV)
    const float* rows = reinterpret_cast<const float*>(slot + 2 * CHUNK_TILE * 2);  // lse, then delta
    probs(s, rows, j0);
    if (ROLE != ROLE_DV) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(rows + T + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = DQ ? delta_r[e >> 1] : ((e & 1) ? d2.y : d2.x);
          s[n][e] = s[n][e] * (dp[n][e] - d) * (DQ ? scale : key[e >> 1].ds_scale);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) mma_ds<CW>(acc, s + 2 * kk, tb + kk * 16 * LD * 2 + lane_tn);  // out += X . tile
  }
  cp_async_wait<0>();
  store_rows<CW>(out, b, own_rows, H * C, h * C + c, r0 + wr + g, t, acc);  // chunk c of head h: "head" h C + c of 128
}

__host__ __device__ constexpr int chunked_smem_bytes(int key_tiles) { return STAGES * CHUNK_SLOT_BYTES + key_tiles * T; }

__global__ void __launch_bounds__(GROUP)
dq_chunked(const __nv_bfloat16* __restrict__ q, int64_t q_bs, int64_t q_rs,
           const __nv_bfloat16* __restrict__ k, int64_t k_bs, int64_t k_rs,
           const __nv_bfloat16* __restrict__ v, int64_t v_bs, int64_t v_rs,
           const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ lse, float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
           int N, int M, int H, float scale, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  chunked_bwd<ROLE_DQ>(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout, lse, delta, dq, N, M, H, scale, C,
                       blockIdx.y, smem);
}

// dK and dV blocks side by side: blockIdx.y = 2 (head C + chunk) + (1 for dK)
__global__ void __launch_bounds__(GROUP)
dkdv_chunked(const __nv_bfloat16* __restrict__ q, int64_t q_bs, int64_t q_rs,
             const __nv_bfloat16* __restrict__ k, int64_t k_bs, int64_t k_rs,
             const __nv_bfloat16* __restrict__ v, int64_t v_bs, int64_t v_rs,
             const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
             int N, int M, int H, float scale, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* d = const_cast<float*>(delta);  // read only
  if (blockIdx.y % 2)
    chunked_bwd<ROLE_DK>(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout, lse, d, dk, N, M, H, scale, C,
                         blockIdx.y / 2, smem);
  else
    chunked_bwd<ROLE_DV>(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout, lse, d, dv, N, M, H, scale, C,
                         blockIdx.y / 2, smem);
}

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

// x as a TF32 part, rounded to nearest (ties away), and the rest, whose low
// 13 bits the tensor cores drop.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b over one k-step as three TF32 products, the small ones first
// (lo hi, hi lo, hi hi), summed from zero and added to c in f32. An mma's
// sum rounds toward zero at the scale of its largest term: carried through
// the running total, that bias grew with the depth of the sum (4-6x the
// plain f32 version's distance to float64 on the card); from zero it stays
// at the scale of 8 products, and the total rounds to nearest.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah, const uint32_t* al, const uint32_t* bh,
                                           const uint32_t* bl) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
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

// ------------------------------------------------------------------ launch

#define BWD_IN(T_)                                                                   \
  const T_ *q, int64_t q_bs, int64_t q_rs, const T_ *k, int64_t k_bs, int64_t k_rs, \
      const T_ *v, int64_t v_bs, int64_t v_rs, const uint8_t *mask, const T_ *dout, \
      const float *lse
#define BWD_IN_PASS q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout, lse

// A block per 64 own rows and 128-value chunk of its output (dK and dV
// blocks side by side); heads of DH = C * 128 values, C >= 2, or the call's
// error.
__host__ __device__ constexpr bool chunked_width(int DH) { return DH > CW && DH % CW == 0; }

int run_chunked_bf16(BWD_IN(__nv_bfloat16), float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                     int B, int N, int M, int H, int DH, float scale, cudaStream_t stream) {
  if (!chunked_width(DH)) return static_cast<int>(cudaErrorInvalidValue);
  const int C = DH / CW;
  if (dq != nullptr) {
    const int bytes = chunked_smem_bytes((M + T - 1) / T);
    const cudaError_t err = allow_smem(dq_chunked, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_chunked<<<dim3((N + T - 1) / T, H * C, B), GROUP, bytes, stream>>>(BWD_IN_PASS, delta, dq, N, M, H, scale, C);
  } else {
    const int bytes = chunked_smem_bytes(0);
    const cudaError_t err = allow_smem(dkdv_chunked, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv_chunked<<<dim3((M + T - 1) / T, 2 * H * C, B), GROUP, bytes, stream>>>(BWD_IN_PASS, delta, dk, dv, N, M,
                                                                                 H, scale, C);
  }
  return static_cast<int>(cudaGetLastError());
}

// A cluster of `cluster_blocks(C)` blocks along y per 64 own rows of one
// (b, head), blockIdx.y = head G + rank; a launch the card refuses (no
// cluster of that many such blocks fits) is the call's error.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int G, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, TF32_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = G;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(FG);
  cfg.dynamicSmemBytes = TF32_SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int run_chunked_f32(BWD_IN(float), float* delta, float* dq, float* dk, float* dv, int B, int N, int M, int H, int DH,
                    float scale, cudaStream_t stream) {
  if (!chunked_width(DH)) return static_cast<int>(cudaErrorInvalidValue);
  const int C = DH / CW, G = cluster_blocks(C);
  if (dq != nullptr)
    return static_cast<int>(launch_cluster(dq_3xtf32_chunked, dim3((N + T - 1) / T, H * G, B), G, stream,
                                           BWD_IN_PASS, delta, dq, N, M, H, scale, C));
  return static_cast<int>(launch_cluster(dkdv_3xtf32_chunked, dim3((M + T - 1) / T, H * G, B), G, stream,
                                         BWD_IN_PASS, static_cast<const float*>(delta), dk, dv, N, M, H, scale, C));
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
