// Masked multi-head softmax attention, backward, on packed heads wider
// than 128 values.
//
// Replaces: image_matching_tpu/ops/pallas/attention.py, _flash_backward
// (_flash_bwd_dkv_kernel, _flash_bwd_dq_kernel) at head widths above 128,
// which the kernels of csrc/attention_bwd.cu do not take. The function and
// its semantics (delta, key masking, dead batch elements) are that file's;
// see its notes.
//
// Heads wider than 128 (dh = C * 128, C >= 2): `dq_chunked` / `dkdv_chunked`
// (bf16, mma.sync) and `dq_ffma_chunked` / `dkdv_ffma_chunked` (f32, the
// FFMA tiles), one body each (`chunked_bwd`, `chunked_bwd_ffma`) in three
// roles. A block owns 64 rows of one (b, head) and one 128-value chunk c of
// one output: dQ_c, dK_c or dV_c (dK and dV in blocks of their own, so a
// block's accumulators are those of width 128 and dV's blocks need no dP).
// Per tile of the other side it adds S and dP over the head's C chunks, one
// ring step a chunk product with the own side's and the tile's chunk staged
// together (2 slots of two padded 64 x 128 tiles and a tile's lse / delta
// rows), then takes one step with the tile's chunk c for the output's
// product with dS or P. dQ's delta pass runs in every chunk block (S and dP
// over the keys, the same for every chunk), and chunk 0 writes delta. Key
// masking, dead elements and delta are those of csrc/attention_bwd.cu. Work:
// dQ C (4 C + 1) chunk products for the function's 3 C, dK/dV C (3 C + 2)
// for 4 C (3x and 2x at 256; PERF.md).
//
// The kernels live in a source of their own so that nvcc builds them beside
// csrc/attention_bwd.cu, not after it.
#include <math.h>

#include "hopper.cuh"
#include "ffma.cuh"
#include "attention_bwd.cuh"

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

// f32, heads wider than 128: `chunked_bwd`'s steps on the FFMA tiles of one
// group of 8 warps. A ring slot holds two 64 x 128 f32 tiles, then a loop
// tile's lse and delta rows; S and dP are 4 x 4 register tiles a thread
// (`nt_product` over each chunk in turn), X (dS or P) goes through shared
// memory as X[loop][own], and out += X^T . tile_c gives each thread 4 own
// rows x 8 dims.
constexpr int CHUNK_F32_TILE = T * f32_ld<CW>();           // floats
constexpr int CHUNK_F32_SLOT = 2 * CHUNK_F32_TILE + 2 * T;  // floats

__host__ __device__ constexpr int ffma_chunked_smem_bytes() { return (STAGES * CHUNK_F32_SLOT + T * XLD) * 4; }

template <int ROLE>
__device__ __forceinline__ void chunked_bwd_ffma(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
                                                 const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
                                                 const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
                                                 const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                                                 const float* __restrict__ lse, float* __restrict__ delta,
                                                 float* __restrict__ out, int N, int M, int H, float scale, int C,
                                                 int head_chunk, float* fsm) {
  constexpr bool DQ = ROLE == ROLE_DQ;
  constexpr int LD = f32_ld<CW>(), DW = CW / 16;
  __shared__ float2 row_sums[4][T];  // dQ: (sum P dP, sum P) per warp row and own row
  float* xs = fsm + STAGES * CHUNK_F32_SLOT;  // X[loop][own]
  const int b = blockIdx.z, h = head_chunk / C, c = head_chunk % C, tid = threadIdx.x;
  const int DH = C * CW, r0 = blockIdx.x * T;
  const int own_rows = DQ ? N : M, loop_rows = DQ ? M : N, ntiles = (loop_rows + T - 1) / T;
  const int64_t do_rs = (int64_t)H * DH;
  const float* qh = q + b * q_bs + h * DH;
  const float* kh = k + b * k_bs + h * DH;
  const float* vh = v + b * v_bs + h * DH;
  const float* doh = dout + b * N * do_rs + h * DH;
  const float* own_s = DQ ? qh : kh;
  const float* own_p = DQ ? doh : vh;
  const float* loop_s = DQ ? kh : qh;
  const float* loop_p = DQ ? vh : doh;
  const int64_t own_s_rs = DQ ? q_rs : k_rs, own_p_rs = DQ ? do_rs : v_rs;
  const int64_t loop_s_rs = DQ ? k_rs : q_rs, loop_p_rs = DQ ? v_rs : do_rs;
  const float* lse_b = lse + ((int64_t)b * H + h) * N;
  float* delta_b = delta + ((int64_t)b * H + h) * N;
  const int prods = ROLE == ROLE_DV ? C : 2 * C, per_tile = prods + 1;
  const int pass1 = DQ ? ntiles * prods : 0;
  const int steps = pass1 + ntiles * per_tile;

  auto stage = [&](int u) {
    float* slot = fsm + (u % STAGES) * CHUNK_F32_SLOT;
    const int w = u < pass1 ? u : u - pass1, per = u < pass1 ? prods : per_tile;
    const int j0 = w / per * T, sub = w % per;
    if (sub < prods) {
      const int cc = sub % C;
      const bool p = sub >= C;
      stage_f32<CW, FG>(slot, (p ? own_p : own_s) + cc * CW, p ? own_p_rs : own_s_rs, r0, own_rows, tid);
      stage_f32<CW, FG>(slot + CHUNK_F32_TILE, (p ? loop_p : loop_s) + cc * CW, p ? loop_p_rs : loop_s_rs, j0,
                        loop_rows, tid);
      return;
    }
    if (ROLE == ROLE_DV) {
      stage_f32<CW, FG>(slot + CHUNK_F32_TILE, doh + c * CW, do_rs, j0, N, tid);
    } else {
      stage_f32<CW, FG>(slot + CHUNK_F32_TILE, loop_s + c * CW, loop_s_rs, j0, loop_rows, tid);
    }
    if (!DQ && tid < 2 * T) {  // rows past N: lse = delta = 0 beside dO = 0
      const int j = tid % T;
      const bool ok = j0 + j < N;
      const float* src = tid < T ? lse_b : delta_b;
      cp_async_4(slot + 2 * CHUNK_F32_TILE + tid, ok ? src + j0 + j : src, ok);
    }
  };

  stage(0);
  cp_async_commit();
  // the factors of this thread's own rows L.own + 8i: dQ, the rows' lse log2 e
  // (P = 0 past N); dK / dV, the keys' states as `dkdv_ffma` takes them
  const NtLane L = nt_lane(tid);
  const TnLane R = tn_lane<CW, DW>(tid);
  const int lane = tid % 32, wq = tid / 64;  // a row's threads: lanes 8 apart, warps 2 apart
  float l2[4], s2[4], ds_scale[4];
  bool counts[4];
  const bool dead = DQ ? false : dead_batch(mask, b, M);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + L.own + 8 * i;
    if constexpr (DQ) {
      l2[i] = row < N ? lse_b[row] * LOG2E : INFINITY;
    } else {
      const KeyRow key = key_row(key_state(mask, b, M, row, dead), scale);
      s2[i] = key.s_scale * LOG2E;
      ds_scale[i] = key.ds_scale;
      counts[i] = key.counts;
    }
  }

  // P of S in place for loop tile j0 (dK / dV: its lse rows at `rows`)
  auto probs = [&](float (*s)[4], const float* rows, int j0) {
    if constexpr (DQ) {
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = j0 + L.loop + 4 * j;
        ok[j] = key < M && (mask == nullptr || mask[(int64_t)b * M + key]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // the exponential outside the choice: no branch
          const float e = exp2f(fmaf(s[i][j], scale * LOG2E, -l2[i]));
          s[i][j] = ok[j] ? e : 0.f;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lj = rows[L.loop + 4 * j] * LOG2E;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = exp2f(fmaf(s[i][j], s2[i], -lj));
          s[i][j] = counts[i] ? e : 0.f;
        }
      }
    }
  };

  float s[4][4], dp[4][4], acc[4][DW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DW; ++e) acc[i][e] = 0.f;
  float num[4] = {0.f, 0.f, 0.f, 0.f}, den[4] = {0.f, 0.f, 0.f, 0.f}, delta_r[4] = {0.f, 0.f, 0.f, 0.f};
  for (int u = 0; u < steps; ++u) {
    if (DQ && u == pass1) {  // delta = rowsum(P dP) / rowsum(P) over the row's 16 threads, in a fixed order
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        num[i] += __shfl_xor_sync(0xffffffffu, num[i], 8);
        num[i] += __shfl_xor_sync(0xffffffffu, num[i], 16);
        den[i] += __shfl_xor_sync(0xffffffffu, den[i], 8);
        den[i] += __shfl_xor_sync(0xffffffffu, den[i], 16);
        if (lane < 8) row_sums[wq][L.own + 8 * i] = make_float2(num[i], den[i]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 sum = make_float2(0.f, 0.f);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          sum.x += row_sums[w][L.own + 8 * i].x;
          sum.y += row_sums[w][L.own + 8 * i].y;
        }
        delta_r[i] = sum.y > 0.f ? sum.x / sum.y : 0.f;
        if (c == 0 && wq == 0 && lane < 8 && r0 + L.own + 8 * i < N) delta_b[r0 + L.own + 8 * i] = delta_r[i];
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // step u's tiles have landed; step u - 1's slot is read no more
    if (u + 1 < steps) stage(u + 1);
    cp_async_commit();
    const float* slot = fsm + (u % STAGES) * CHUNK_F32_SLOT;
    const float* tb = slot + CHUNK_F32_TILE;
    const int w = u < pass1 ? u : u - pass1, per = u < pass1 ? prods : per_tile;
    const int j0 = w / per * T, sub = w % per;
    if (sub < C) {  // S += own_c' loop_c'^T
      if (sub == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      nt_product<CW>(s, slot + L.own * LD, tb + L.loop * LD);
    } else if (sub < prods) {  // dP += own_c' loop_c'^T
      if (sub == C)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
      nt_product<CW>(dp, slot + L.own * LD, tb + L.loop * LD);
    }
    if (u < pass1) {
      if (sub == prods - 1) {  // dQ's delta pass: this thread's partial sums
        probs(s, nullptr, j0);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            num[i] = fmaf(s[i][j], dp[i][j], num[i]);
            den[i] += s[i][j];
          }
      }
      continue;
    }
    if (sub < prods) continue;
    // the tile's output product with chunk c: X = dS (dQ, dK) or P (dV)
    const float* rows = slot + 2 * CHUNK_F32_TILE;  // lse, then delta
    probs(s, rows, j0);
    if (ROLE != ROLE_DV) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dj = DQ ? 0.f : rows[T + L.loop + 4 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i][j] = DQ ? s[i][j] * (dp[i][j] - delta_r[i]) * scale : s[i][j] * (dp[i][j] - dj) * ds_scale[i];
      }
    }
    store_x(xs, s, L);
    __syncthreads();
    tn_product<CW, DW>(acc, xs + R.own, tb + R.dim);  // out += X^T tile_c
  }
  cp_async_wait<0>();
  store_out<DW>(out + (int64_t)b * own_rows * do_rs + h * DH + c * CW, r0, own_rows, do_rs, acc, R);
}

__global__ void __launch_bounds__(FG, 1)
dq_ffma_chunked(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
                const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
                const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
                const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ delta,
                float* __restrict__ dq, int N, int M, int H, float scale, int C) {
  extern __shared__ __align__(16) float fsm[];
  chunked_bwd_ffma<ROLE_DQ>(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout, lse, delta, dq, N, M, H, scale,
                            C, blockIdx.y, fsm);
}

// dK and dV blocks side by side: blockIdx.y = 2 (head C + chunk) + (1 for dK)
__global__ void __launch_bounds__(FG, 1)
dkdv_ffma_chunked(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
                  const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
                  const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
                  const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int N, int M, int H, float scale, int C) {
  extern __shared__ __align__(16) float fsm[];
  float* d = const_cast<float*>(delta);  // read only
  if (blockIdx.y % 2)
    chunked_bwd_ffma<ROLE_DK>(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout, lse, d, dk, N, M, H, scale, C,
                              blockIdx.y / 2, fsm);
  else
    chunked_bwd_ffma<ROLE_DV>(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout, lse, d, dv, N, M, H, scale, C,
                              blockIdx.y / 2, fsm);
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

int run_chunked_f32(BWD_IN(float), float* delta, float* dq, float* dk, float* dv, int B, int N, int M, int H, int DH,
                    float scale, cudaStream_t stream) {
  constexpr int BYTES = ffma_chunked_smem_bytes();
  if (!chunked_width(DH)) return static_cast<int>(cudaErrorInvalidValue);
  const int C = DH / CW;
  if (dq != nullptr) {
    const cudaError_t err = allow_smem(dq_ffma_chunked, BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_ffma_chunked<<<dim3((N + T - 1) / T, H * C, B), FG, BYTES, stream>>>(BWD_IN_PASS, delta, dq, N, M, H, scale,
                                                                             C);
  } else {
    const cudaError_t err = allow_smem(dkdv_ffma_chunked, BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv_ffma_chunked<<<dim3((M + T - 1) / T, 2 * H * C, B), FG, BYTES, stream>>>(BWD_IN_PASS, delta, dk, dv, N, M,
                                                                                   H, scale, C);
  }
  return static_cast<int>(cudaGetLastError());
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
