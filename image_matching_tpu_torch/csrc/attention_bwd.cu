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
// q/k/v/dO/dq/dk/dv: 1.9 us at the tensor-core peak, 0.9 us at HBM's rate.
// The bf16 kernels do 9: the dQ kernel's delta pass computes S and dP too.
// At that size a 64-row block per (b, head) tile makes 128 blocks, under
// one wave of the 132 SMs, and a warp owns 16 rows: with one warp per row
// group an SM holds 4 warps and each walks the whole other side in turn,
// so latency, not a peak, bounds it; of a call's ~10 us more than half is
// spent outside the loop over tiles (launch, first loads, mask, partial
// sums, stores; PERF.md). At (4, 1024, 4 x 64) and beyond the products
// themselves count. What the design does about it:
//  - NG warpgroups of 4 warps share a block's 64 own rows and split the
//    looped side: group g takes 64-row tiles g, g + NG, ... of it, and the
//    partial sums are added through shared memory in the groups' order.
//  - Every group runs its own pipeline: its 128 threads bring tile i + 1
//    of the looped side (Q, dO, lse, delta for dK/dV; K, V for dQ) into a
//    2-stage ring by `cp.async` (16-byte copies, rows past the end
//    zero-filled by a source size of 0) while tile i is multiplied, and
//    meet at a named barrier of their own, so the groups drift apart and
//    one's exponentials overlap another's products.
//  - Up to dh = 32, and at dh = 128: mma.sync.m16n8k16 (f32 accumulate),
//    as the forward, from one row-major copy of each tile, rows padded by
//    8 bf16 so that the 8 rows of an `ldmatrix` fall on distinct banks. B
//    fragments of S and dP come by `ldmatrix`, those of the products that
//    contract over the tile's rows (P^T dO, dS^T Q, dS K) by
//    `ldmatrix.trans` from the same copy; the block's own rows are staged
//    once and read as A fragments. NG = 4: one block of 16 warps on an SM.
//    At dh = 128, NG = 2 (4 would need 317 KB of shared memory in dK/dV,
//    313 KB in dQ), and dK/dV reads its own rows' A fragments from shared
//    memory at each use: dK and dV's accumulators alone take 128 registers
//    a thread there.
//  - At dh = 64: wgmma (m64n64k16) on whole 64 x 64 tiles straight from
//    shared memory in the 128-byte swizzle, S and dP with both operands in
//    shared memory, the three products that contract over the tile's rows
//    with A (P^T, dS) from registers and B read transposed by its
//    descriptor. 4 (dQ) and 3 (dK/dV) warpgroups of one block on an SM.
//  - The inner loops over P and dS run without a branch: a key's state is
//    folded into factors and the exponential stands outside every choice
//    (a conditional around it cost a quarter of a dK/dV call's time).
//  - The dQ kernel's second pass walks the keys last tile first, so the
//    tiles the delta pass left in the ring need no second load: none at
//    all up to NG * 2 * 64 keys (512 at dh = 32, the training path).
//  - The key mask is read once per block (the whole row into shared
//    memory for dQ, an any-reduction for dK/dV's dead flag).
//
// No carry between blocks (the TPU grid's "arbitrary" axis) and no atomics:
// every sum has a fixed order, so two runs give the same bits.
//
// The C-fragment layout of P^T and dS is reused as A fragments. P, dP and
// dS are f32. P is rounded to bf16 for dV = P^T dO (P >= 0, so the rounding
// stays relative to the sum, as the forward's P V). dS is rounded to bf16
// for dS K and dS^T Q: the rounding is relative to each entry, so a row's
// sum stays 0 to within 2^-9 of its norm, and on a training step's calls
// the gradients keep a cosine of 0.9999 and more to the exact ones. The
// TPU kernel takes those two as f32 products (attention.py:157-160,
// 199-201); dS as a bf16 part plus its bf16 residue, two products, bought
// 5 times smaller errors, the same cosines, and cost a tenth of the time
// (PERF.md).
//
// Heads wider than 128 run in csrc/attention_bwd_chunked.cu, in chunks of
// 128 values.
//
// f32 (compute_dtype="float32") up to dh = 64: `dq_ffma` and `dkdv_ffma`,
// register-tiled SIMT kernels on plain f32 FMAs; products and exponentials
// in full f32. Bound: the FMA pipe, 67 TFLOP/s. The function's 7 products
// are 1.88 GFLOP at (4, 512, 4 x 32), 0.028 ms (its 7.3 MB of
// q/k/v/dO/dq/dk/dv: 0.0022 ms); the kernels do 9 (the delta pass computes
// S and dP too), 0.036 ms. PyTorch's f32 SDPA backward runs its products on
// the tensor cores as three TF32 products each, a ceiling of 165 TFLOP/s.
// What the design does about the FMA pipe:
//  - A group of 8 warps takes a 64 x 64 tile of S and of dP, 4 x 4 of each
//    a thread (own rows 8 apart, looped rows 4 apart): per 4 dims, 8
//    LDS.128 (a warp's 8 own rows on distinct banks, its 4 looped rows
//    broadcast) for 64 FMAs, no shuffles, chains as deep as dh.
//  - P and dS go through shared memory (a pitch of 72 floats: conflict-free
//    stores). The products over the tile's rows read a float4 of them and
//    DW dims of the looped tile a row, 4 x DW accumulators a thread: in
//    dK/dV warps 0-3 take dV = P^T dO and warps 4-7 dK = dS^T Q (DW = dh /
//    8), in dQ all 8 warps dQ = dS K (DW = dh / 16).
//  - Two groups of a block split the looped side (16 warps on an SM at the
//    training path's 128 blocks), each with its own 2-stage `cp.async`
//    ring and named barrier; their partial sums are added through shared
//    memory in the groups' order. dK/dV at dh = 64 keeps one group (two
//    would need 244 KB of shared memory), and so does dQ at dh = 16 (two
//    spill at 128 registers a thread).
//  - dQ's first pass keeps each thread's partial rowsum(P dP) and
//    rowsum(P), reduced once after it (the row's 4 lanes by shuffles, then
//    its 4 warps and the groups through shared memory, in a fixed order);
//    the second pass walks the keys last tile first, so the two tiles the
//    first pass left in the ring need no second load.
//  - P = exp2(S scale log2 e - lse log2 e), key states as factors: no branch.
// The tiles live in csrc/ffma.cuh, shared with the f32 forward. The kernels
// reach 39-52% of the FMA pipe (PERF.md); the shared-memory loads of 4 x 4
// tiles cap them at two thirds of it (csrc/lds_probe.cu: an LDS.128 costs
// the SM 4 cycles, 2 when each quarter-warp reads one address), so the
// loads are not all that holds them.
//
// f32 at dh = 128: `dq_3xtf32` and `dkdv_3xtf32`, one body
// (`wide_bwd_tf32`), every product on the tensor cores as 3xTF32
// (csrc/tf32.cuh: each operand a TF32 part rounded to nearest and its rest,
// three mma.sync.m16n8k8 products a k-step summed from zero and added to the
// f32 total), P, dS, delta and every sum in f32. On the FMA pipe the 9
// products' work of the pair takes 0.144 ms at the training shape (4, 512,
// 4 x 128), 0.78x f32 SDPA's backward at a perfect pipe; 3xTF32's 165
// TFLOP/s bound the function's 7 at 0.0455 ms. The design, that of
// `attention_wide_3xtf32` (csrc/attention.cu) carried to the backward:
//  - A warp owns 16 own rows and half of the head (64 values): it
//    multiplies its rows' partial S and dP over its half, and the warp
//    holding the other half of the same rows swaps them with it through
//    shared memory behind a 64-thread barrier of their own; both add them
//    in the same order, so both hold the same bits of S, dP, P and dS.
//  - Then each adds its half of the outputs: dQ_half += dS K_half, or
//    dV_half += P^T dO_half and dK_half += dS^T Q_half. S's columns are the
//    loop rows in `wf_key` order, so that S's C layout is the A fragment of
//    these products, and their B fragments come as two 16-byte loads a row
//    (`wb_value`).
//  - dQ += dS (K - 1 k0^T), k0 the batch element's first key row: every
//    row of dS sums to 0, so it is dS K, and a common part of the keys
//    drops out before the products round it (their split is coarser than
//    an FMA's rounding): it brings dQ's worst distance from float64 over a
//    D = 512 f32 step's calls down by a tenth or more (PERF.md).
//  - Each half's warps stage their half of the own rows once and of each
//    loop tile through a 2-slot `cp.async` ring of their own, behind a
//    barrier of their own: no block barrier in the loop.
//  - dQ: 64 own rows a block (8 warps, one block an SM), 32-row loop tiles,
//    the score products unrolled 4 k-steps deep (fully: 255 registers,
//    slower); its delta pass computes S and dP as `dq_ffma`'s does. dK/dV:
//    32 own rows a block (4 warps, two blocks an SM), 16-row loop tiles
//    (32-row ones spill beside dK and dV's 64 registers a thread).
//  - Every thread may take 255 registers (`__launch_bounds__` with the
//    blocks an SM): a bound on threads alone drew ~190 and ran 10-20% slower.
#include <math.h>

#include "hopper.cuh"
#include "ffma.cuh"
#include "attention_bwd.cuh"
#include "tf32.cuh"

namespace {

// Warpgroups of a block, each measured on the card against its neighbours
// (PERF.md): the mma.sync kernels; the wgmma kernels, which registers cap
// (128 a thread for dQ at 4 groups, 168 for dK/dV at 3).
constexpr int MMA_GROUPS = 4, WG_GROUPS_DQ = 4, WG_GROUPS_DKDV = 3;
// at dh = 128 (not measured against others): what the shared memory holds
constexpr int WIDE_GROUPS = 2;

// ------------------------------------------------------------------ bf16 dK/dV

// One stage of a dK/dV group's ring: Q and dO tiles, then lse and delta rows.
template <int DH>
__host__ __device__ constexpr int dkdv_stage_bytes() { return 2 * tile_elems<DH>() * 2 + 2 * T * 4; }

template <int DH, int NG>
__host__ __device__ constexpr int dkdv_smem_bytes() { return 2 * tile_elems<DH>() * 2 + NG * STAGES * dkdv_stage_bytes<DH>(); }

template <int DH, int NG>
__global__ void __launch_bounds__(NG * GROUP)
dkdv_mma(const __nv_bfloat16* __restrict__ q, int64_t q_bs, int64_t q_rs,
         const __nv_bfloat16* __restrict__ k, int64_t k_bs, int64_t k_rs,
         const __nv_bfloat16* __restrict__ v, int64_t v_bs, int64_t v_rs,
         const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
         int N, int M, int H, float scale) {
  constexpr int LD = DH + PAD, KS = DH / 16, DT = DH / 8, TILE = tile_elems<DH>();
  constexpr int STAGE = dkdv_stage_bytes<DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* own_k = reinterpret_cast<__nv_bfloat16*>(smem);  // A of S^T = K Q^T
  __nv_bfloat16* own_v = own_k + TILE;                            // A of dP^T = V dO^T
  unsigned char* rings = smem + 2 * TILE * 2;

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, grp = warp / 4, gt = tid % GROUP;
  const int wr = (warp % 4) * 16, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * T;            // the block's keys k0 .. k0 + 63
  const int ntiles = (N + T - 1) / T;       // query tiles; group grp takes grp, grp + NG, ...
  const int cnt = grp < ntiles ? (ntiles - grp + NG - 1) / NG : 0;
  const int64_t do_rs = (int64_t)H * DH;
  const __nv_bfloat16* q_b = q + b * q_bs + h * DH;
  const __nv_bfloat16* do_b = dout + b * N * do_rs + h * DH;
  const float* lse_b = lse + ((int64_t)b * H + h) * N;
  const float* delta_b = delta + ((int64_t)b * H + h) * N;
  unsigned char* ring = rings + grp * STAGES * STAGE;

  // Q, dO (B fragments both ways), lse and delta of query tile `tile` into stage `s`
  auto stage = [&](int s, int tile) {
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(ring + s * STAGE);
    float* rows = reinterpret_cast<float*>(ring + s * STAGE + 2 * TILE * 2);
    const int r0 = tile * T;
    stage_tile<DH, GROUP>(qs, q_b, q_rs, r0, N, gt);
    stage_tile<DH, GROUP>(qs + TILE, do_b, do_rs, r0, N, gt);
    const int j = gt % T;
    const bool ok = r0 + j < N;
    const float* src = gt < T ? lse_b : delta_b;
    cp_async_4(rows + gt, ok ? src + r0 + j : src, ok);  // rows past N: lse = delta = 0 beside dO = 0
  };

  stage_tile<DH, NG * GROUP>(own_k, k + b * k_bs + h * DH, k_rs, k0, M, tid);
  stage_tile<DH, NG * GROUP>(own_v, v + b * v_bs + h * DH, v_rs, k0, M, tid);
  cp_async_commit();
  if (cnt > 0) stage(0, grp);
  cp_async_commit();

  KeyRow key[2];
  own_key_rows(key, mask, b, M, k0 + wr + g, scale);

  cp_async_wait<1>();  // the own tiles have landed
  __syncthreads();
  // the own rows' A fragments in registers up to dh = 64; at dh = 128 they
  // would take 64 registers beside dK and dV's 128, and are read at each use
  constexpr bool A_IN_REGS = DH <= 64;
  uint32_t ka[A_IN_REGS ? KS : 1][4], va[A_IN_REGS ? KS : 1][4];
  if constexpr (A_IN_REGS) {
    load_a<DH>(ka, own_k, wr, lane);
    load_a<DH>(va, own_v, wr, lane);
  }
  const uint32_t ka_addr = a_lane_addr<DH>(own_k, wr, lane), va_addr = a_lane_addr<DH>(own_v, wr, lane);
  float dkc[DT][4], dvc[DT][4];
  zero<DT>(dkc);
  zero<DT>(dvc);

  // lane offsets of the two ldmatrix patterns, in bytes
  const uint32_t lane_nt = nt_lane_offset<DH>(lane);
  const uint32_t lane_tn = tn_lane_offset<DH>(lane);

  for (int it = 0; it < cnt; ++it) {
    if (it + 1 < cnt) stage((it + 1) % STAGES, grp + (it + 1) * NG);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile `it` has landed
    group_sync(grp);
    const unsigned char* cur = ring + (it % STAGES) * STAGE;
    const uint32_t qs = smem_addr(cur), dos = qs + TILE * 2;
    const float* lse_s = reinterpret_cast<const float*>(cur + 2 * TILE * 2);
    const float* delta_s = lse_s + T;
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {  // 16 queries at a time
      const uint32_t rows_nt = kk * 16 * LD * 2 + lane_nt, rows_tn = kk * 16 * LD * 2 + lane_tn;
      // S^T and dP^T: rows = keys g, g+8 of the warp; columns = queries.
      // C layout: c[n][0..1] key g, c[n][2..3] key g+8, queries 8n+2t+{0,1}
      float p[2][4], ds[2][4];
      zero<2>(p);
      zero<2>(ds);
      if constexpr (A_IN_REGS) {
        mma_nt<DH>(p, ka, qs + rows_nt);
        mma_nt<DH>(ds, va, dos + rows_nt);
      } else {
        mma_nt_smem_a<DH>(p, ka_addr, qs + rows_nt);
        mma_nt_smem_a<DH>(ds, va_addr, dos + rows_nt);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + kk * 16 + n * 8 + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + kk * 16 + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p_ds(p[n][e], ds[n][e], key[e >> 1], (e & 1) ? l2.y : l2.x, (e & 1) ? d2.y : d2.x);
      }
      uint32_t pa[4];
      c_to_a(pa, p);
      mma_tn<DH>(dvc, pa, dos + rows_tn);  // dV += P^T dO
      mma_ds<DH>(dkc, ds, qs + rows_tn);   // dK += dS^T Q
    }
    group_sync(grp);  // the stage is free for tile it + 2
  }

  // partial sums of groups 1.. through their own (now idle) rings, added in order
  if (grp > 0) {
    float* scratch = reinterpret_cast<float*>(ring);
    put_partial<DT>(scratch, dkc, gt);
    put_partial<DT>(scratch + DT * 4 * GROUP, dvc, gt);
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int o = 1; o < NG; ++o) {
      const float* scratch = reinterpret_cast<const float*>(rings + o * STAGES * STAGE);
      add_partial<DT>(dkc, scratch, gt);
      add_partial<DT>(dvc, scratch + DT * 4 * GROUP, gt);
    }
    store_rows<DH>(dk, b, M, H, h, k0 + wr + g, t, dkc);
    store_rows<DH>(dv, b, M, H, h, k0 + wr + g, t, dvc);
  }
}

// ------------------------------------------------------------------ bf16 dQ

template <int DH, int NG>
__host__ __device__ constexpr int dq_smem_bytes(int key_tiles) {
  return (2 + NG * STAGES * 2) * tile_elems<DH>() * 2 + key_tiles * T;
}

// Two passes over the keys: the first for delta = rowsum(P * dP) / rowsum(P)
// over the valid keys, which it writes for the dK/dV kernel; the second, in
// the reverse order, for dS and dQ. A group's last STAGES tiles are still in
// its ring when the second pass starts, so at up to NG * STAGES * 64 keys
// (512 at dh = 32) the second pass loads nothing.
template <int DH, int NG>
__global__ void __launch_bounds__(NG * GROUP)
dq_mma(const __nv_bfloat16* __restrict__ q, int64_t q_bs, int64_t q_rs,
       const __nv_bfloat16* __restrict__ k, int64_t k_bs, int64_t k_rs,
       const __nv_bfloat16* __restrict__ v, int64_t v_bs, int64_t v_rs,
       const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
       const float* __restrict__ lse, float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
       int N, int M, int H, float scale) {
  constexpr int LD = DH + PAD, KS = DH / 16, DT = DH / 8, TILE = tile_elems<DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 row_sums[NG][T];  // each group's (sum P dP, sum P) per own row
  __nv_bfloat16* own_q = reinterpret_cast<__nv_bfloat16*>(smem);  // A of S = Q K^T
  __nv_bfloat16* own_do = own_q + TILE;                           // A of dP = dO V^T
  __nv_bfloat16* rings = own_do + TILE;                           // per group and stage: K, V tiles

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, grp = warp / 4, gt = tid % GROUP;
  const int wr = (warp % 4) * 16, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * T;            // the block's queries q0 .. q0 + 63
  const int ntiles = (M + T - 1) / T;       // key tiles; group grp takes grp, grp + NG, ...
  const int cnt = grp < ntiles ? (ntiles - grp + NG - 1) / NG : 0;
  const int64_t do_rs = (int64_t)H * DH;
  const __nv_bfloat16* k_b = k + b * k_bs + h * DH;
  const __nv_bfloat16* v_b = v + b * v_bs + h * DH;
  __nv_bfloat16* ring = rings + grp * STAGES * 2 * TILE;
  uint8_t* valid = reinterpret_cast<uint8_t*>(rings + NG * STAGES * 2 * TILE);  // [ntiles * T]

  // K and V of the group's `it`-th key tile into its stage
  auto stage = [&](int it) {
    __nv_bfloat16* dst = ring + (it % STAGES) * 2 * TILE;
    const int j0 = (grp + it * NG) * T;
    stage_tile<DH, GROUP>(dst, k_b, k_rs, j0, M, gt);
    stage_tile<DH, GROUP>(dst + TILE, v_b, v_rs, j0, M, gt);
  };

  stage_tile<DH, NG * GROUP>(own_q, q + b * q_bs + h * DH, q_rs, q0, N, tid);
  stage_tile<DH, NG * GROUP>(own_do, dout + b * N * do_rs + h * DH, do_rs, q0, N, tid);
  cp_async_commit();
  if (cnt > 0) stage(0);
  cp_async_commit();

  // the batch element's key states, once per block; only valid keys carry
  // dS, so a dead element needs no flag here
  for (int j = tid; j < ntiles * T; j += NG * GROUP)
    valid[j] = j < M && (mask == nullptr || mask[(int64_t)b * M + j]);
  const int64_t row_i = ((int64_t)b * H + h) * N + q0 + wr + g;  // of this thread's first row
  float lse_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lse_r[r] = q0 + wr + g + 8 * r < N ? lse[row_i + 8 * r] : INFINITY;  // P = 0 past N

  cp_async_wait<1>();  // the own tiles have landed
  __syncthreads();
  uint32_t qa[KS][4], da[KS][4];
  load_a<DH>(qa, own_q, wr, lane);
  load_a<DH>(da, own_do, wr, lane);

  const uint32_t lane_nt = nt_lane_offset<DH>(lane);
  const uint32_t lane_tn = tn_lane_offset<DH>(lane);

  // P (valid keys only) and dP of 16 keys of the group's `it`-th tile:
  // rows = queries g, g+8 of the warp; columns = keys 8n+2t+{0,1}
  auto p_dp = [&](int it, int kk, float (*p)[4], float (*dp)[4]) {
    const uint32_t ks = smem_addr(ring + (it % STAGES) * 2 * TILE) + kk * 16 * LD * 2 + lane_nt;
    const uint8_t* valid_t = valid + (grp + it * NG) * T + kk * 16 + 2 * t;
    zero<2>(p);
    zero<2>(dp);
    mma_nt<DH>(p, qa, ks);
    mma_nt<DH>(dp, da, ks + TILE * 2);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const uchar2 ok = *reinterpret_cast<const uchar2*>(valid_t + n * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // the exponential outside the choice: no branch
        const float pe = __expf(fmaf(p[n][e], scale, -lse_r[e >> 1]));
        p[n][e] = ((e & 1) ? ok.y : ok.x) ? pe : 0.f;
      }
    }
  };

  // pass 1: delta
  float num[2] = {0.f, 0.f}, den[2] = {0.f, 0.f};
  for (int it = 0; it < cnt; ++it) {
    if (it + 1 < cnt) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile `it` has landed
    group_sync(grp);
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      float p[2][4], dp[2][4];
      p_dp(it, kk, p, dp);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          num[e >> 1] += p[n][e] * dp[n][e];
          den[e >> 1] += p[n][e];
        }
    }
    if (it + STAGES < cnt) group_sync(grp);  // the stage is free for tile it + 2
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 threads of a row group share a row
    num[r] += __shfl_xor_sync(0xffffffffu, num[r], 1);
    num[r] += __shfl_xor_sync(0xffffffffu, num[r], 2);
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
    if (t == 0) row_sums[grp][wr + g + 8 * r] = make_float2(num[r], den[r]);
  }
  __syncthreads();
  float delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float2 sum = row_sums[0][wr + g + 8 * r];
#pragma unroll
    for (int o = 1; o < NG; ++o) {  // in the groups' order
      sum.x += row_sums[o][wr + g + 8 * r].x;
      sum.y += row_sums[o][wr + g + 8 * r].y;
    }
    delta_r[r] = sum.y > 0.f ? sum.x / sum.y : 0.f;
    if (grp == 0 && t == 0 && q0 + wr + g + 8 * r < N) delta[row_i + 8 * r] = delta_r[r];
  }

  // pass 2, last tile first: dS and dQ. Tile `it` was loaded by pass 1 or
  // two iterations ago; tile it - 2 follows it into its stage.
  float dqc[DT][4];
  zero<DT>(dqc);
  for (int it = cnt - 1; it >= 0; --it) {
    cp_async_wait<1>();
    group_sync(grp);
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      float p[2][4], ds[2][4];
      p_dp(it, kk, p, ds);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - delta_r[e >> 1]) * scale;
      mma_ds<DH>(dqc, ds, smem_addr(ring + (it % STAGES) * 2 * TILE) + kk * 16 * LD * 2 + lane_tn);  // dQ += dS K
    }
    group_sync(grp);  // the stage is free
    if (it >= STAGES) stage(it - STAGES);
    cp_async_commit();
  }

  // partial sums of groups 1.. through their own (now idle) rings, added in order
  if (grp > 0) put_partial<DT>(reinterpret_cast<float*>(ring), dqc, gt);
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int o = 1; o < NG; ++o)
      add_partial<DT>(dqc, reinterpret_cast<const float*>(rings + o * STAGES * 2 * TILE), gt);
    store_rows<DH>(dq, b, N, H, h, q0 + wr + g, t, dqc);
  }
}

// ------------------------------------------------------------------ bf16, dh = 64: wgmma

template <int NG>
__host__ __device__ constexpr int wg_tiles_bytes() { return (2 + NG * STAGES * 2) * WG_TILE_BYTES; }

template <int NG>
__host__ __device__ constexpr int dkdv_wg_smem_bytes() { return 1024 + wg_tiles_bytes<NG>() + NG * STAGES * 2 * T * 4; }

template <int NG>
__global__ void __launch_bounds__(NG * GROUP)
dkdv_wg(const __nv_bfloat16* __restrict__ q, int64_t q_bs, int64_t q_rs,
        const __nv_bfloat16* __restrict__ k, int64_t k_bs, int64_t k_rs,
        const __nv_bfloat16* __restrict__ v, int64_t v_bs, int64_t v_rs,
        const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        int N, int M, int H, float scale) {
  constexpr int DH = 64;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* own_k = align_1024(smem);               // A of S^T = K Q^T
  unsigned char* own_v = own_k + WG_TILE_BYTES;          // A of dP^T = V dO^T
  unsigned char* rings = own_v + WG_TILE_BYTES;          // per group and stage: Q, dO tiles
  float* row_stats = reinterpret_cast<float*>(own_k + wg_tiles_bytes<NG>());  // per group and stage: lse, delta

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, grp = warp / 4, gt = tid % GROUP;
  const int wr = (warp % 4) * 16, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * T;
  const int ntiles = (N + T - 1) / T;
  const int cnt = grp < ntiles ? (ntiles - grp + NG - 1) / NG : 0;
  const int64_t do_rs = (int64_t)H * DH;
  const __nv_bfloat16* q_b = q + b * q_bs + h * DH;
  const __nv_bfloat16* do_b = dout + b * N * do_rs + h * DH;
  const float* lse_b = lse + ((int64_t)b * H + h) * N;
  const float* delta_b = delta + ((int64_t)b * H + h) * N;
  unsigned char* ring = rings + grp * STAGES * 2 * WG_TILE_BYTES;
  float* stats = row_stats + grp * STAGES * 2 * T;

  auto stage = [&](int it) {
    unsigned char* qs = ring + (it % STAGES) * 2 * WG_TILE_BYTES;
    const int r0 = (grp + it * NG) * T;
    stage_swizzled<GROUP>(qs, q_b, q_rs, r0, N, gt);
    stage_swizzled<GROUP>(qs + WG_TILE_BYTES, do_b, do_rs, r0, N, gt);
    const int j = gt % T;
    const bool ok = r0 + j < N;
    const float* src = gt < T ? lse_b : delta_b;
    cp_async_4(stats + (it % STAGES) * 2 * T + gt, ok ? src + r0 + j : src, ok);
  };

  stage_swizzled<NG * GROUP>(own_k, k + b * k_bs + h * DH, k_rs, k0, M, tid);
  stage_swizzled<NG * GROUP>(own_v, v + b * v_bs + h * DH, v_rs, k0, M, tid);
  cp_async_commit();
  if (cnt > 0) stage(0);
  cp_async_commit();

  KeyRow key[2];
  own_key_rows(key, mask, b, M, k0 + wr + g, scale);

  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();
  const uint64_t ka = wg_desc(smem_addr(own_k)), va = wg_desc(smem_addr(own_v));
  float dkc[32], dvc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dkc[i] = dvc[i] = 0.f;

  for (int it = 0; it < cnt; ++it) {
    if (it + 1 < cnt) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    group_sync(grp);
    const uint64_t qs = wg_desc(smem_addr(ring + (it % STAGES) * 2 * WG_TILE_BYTES));
    const uint64_t dos = qs + (WG_TILE_BYTES >> 4);
    const float* lse_s = stats + (it % STAGES) * 2 * T;
    const float* delta_s = lse_s + T;
    // S^T and dP^T: rows = the group's 64 keys (g, g+8 of the warp's 16), columns =
    // queries. Each batch of products runs while the registers of the one before
    // are worked on.
    float p[32], ds[32];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) wgmma_ss(p, ka + 2 * ks, qs + 2 * ks, ks > 0);
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) wgmma_ss(ds, va + 2 * ks, dos + 2 * ks, ks > 0);
    wg_commit();
    wg_wait<1>(p);  // S^T is in
#pragma unroll
    for (int n = 0; n < T / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) p[4 * n + e] = p_of(p[4 * n + e], key[e >> 1], (e & 1) ? l2.y : l2.x);
    }
    uint32_t pa[4][4], dsa[4][4];
    wg_c_to_a(pa, p);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) wgmma_rs(dvc, pa[kk], dos + 128 * kk);  // dV += P^T dO
    wg_commit();
    wg_wait<1>(ds);  // dP^T is in
#pragma unroll
    for (int n = 0; n < T / 8; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta_s + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[4 * n + e] = p[4 * n + e] * (ds[4 * n + e] - ((e & 1) ? d2.y : d2.x)) * key[e >> 1].ds_scale;
    }
    wg_c_to_a(dsa, ds);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) wgmma_rs(dkc, dsa[kk], qs + 128 * kk);  // dK += dS^T Q
    wg_commit();
    wg_wait<0>(dvc);
    wg_wait<0>(dkc);
    group_sync(grp);  // the stage is free for tile it + 2
  }

  if (grp > 0) {
    float* scratch = reinterpret_cast<float*>(ring);
    put_partial<8>(scratch, reinterpret_cast<const float(*)[4]>(dkc), gt);
    put_partial<8>(scratch + 32 * GROUP, reinterpret_cast<const float(*)[4]>(dvc), gt);
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int o = 1; o < NG; ++o) {
      const float* scratch = reinterpret_cast<const float*>(rings + o * STAGES * 2 * WG_TILE_BYTES);
      add_partial<8>(reinterpret_cast<float(*)[4]>(dkc), scratch, gt);
      add_partial<8>(reinterpret_cast<float(*)[4]>(dvc), scratch + 32 * GROUP, gt);
    }
    store_rows<DH>(dk, b, M, H, h, k0 + wr + g, t, reinterpret_cast<const float(*)[4]>(dkc));
    store_rows<DH>(dv, b, M, H, h, k0 + wr + g, t, reinterpret_cast<const float(*)[4]>(dvc));
  }
}

template <int NG>
__host__ __device__ constexpr int dq_wg_smem_bytes(int key_tiles) { return 1024 + wg_tiles_bytes<NG>() + key_tiles * T; }

template <int NG>
__global__ void __launch_bounds__(NG * GROUP)
dq_wg(const __nv_bfloat16* __restrict__ q, int64_t q_bs, int64_t q_rs,
      const __nv_bfloat16* __restrict__ k, int64_t k_bs, int64_t k_rs,
      const __nv_bfloat16* __restrict__ v, int64_t v_bs, int64_t v_rs,
      const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
      const float* __restrict__ lse, float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
      int N, int M, int H, float scale) {
  constexpr int DH = 64;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 row_sums[NG][T];
  unsigned char* own_q = align_1024(smem);               // A of S = Q K^T
  unsigned char* own_do = own_q + WG_TILE_BYTES;         // A of dP = dO V^T
  unsigned char* rings = own_do + WG_TILE_BYTES;         // per group and stage: K, V tiles
  uint8_t* valid = own_q + wg_tiles_bytes<NG>();         // [ntiles * T]

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, grp = warp / 4, gt = tid % GROUP;
  const int wr = (warp % 4) * 16, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * T;
  const int ntiles = (M + T - 1) / T;
  const int cnt = grp < ntiles ? (ntiles - grp + NG - 1) / NG : 0;
  const int64_t do_rs = (int64_t)H * DH;
  const __nv_bfloat16* k_b = k + b * k_bs + h * DH;
  const __nv_bfloat16* v_b = v + b * v_bs + h * DH;
  unsigned char* ring = rings + grp * STAGES * 2 * WG_TILE_BYTES;

  auto stage = [&](int it) {
    unsigned char* dst = ring + (it % STAGES) * 2 * WG_TILE_BYTES;
    const int j0 = (grp + it * NG) * T;
    stage_swizzled<GROUP>(dst, k_b, k_rs, j0, M, gt);
    stage_swizzled<GROUP>(dst + WG_TILE_BYTES, v_b, v_rs, j0, M, gt);
  };

  stage_swizzled<NG * GROUP>(own_q, q + b * q_bs + h * DH, q_rs, q0, N, tid);
  stage_swizzled<NG * GROUP>(own_do, dout + b * N * do_rs + h * DH, do_rs, q0, N, tid);
  cp_async_commit();
  if (cnt > 0) stage(0);
  cp_async_commit();

  for (int j = tid; j < ntiles * T; j += NG * GROUP)
    valid[j] = j < M && (mask == nullptr || mask[(int64_t)b * M + j]);
  const int64_t row_i = ((int64_t)b * H + h) * N + q0 + wr + g;
  float lse_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lse_r[r] = q0 + wr + g + 8 * r < N ? lse[row_i + 8 * r] : INFINITY;

  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();
  const uint64_t qa = wg_desc(smem_addr(own_q)), da = wg_desc(smem_addr(own_do));

  // P (valid keys only) and dP of the group's `it`-th tile: rows = queries
  // (g, g+8 of the warp's 16), columns = keys
  auto p_dp = [&](int it, float* p, float* dp) {
    const uint64_t ks = wg_desc(smem_addr(ring + (it % STAGES) * 2 * WG_TILE_BYTES));
    const uint64_t vs = ks + (WG_TILE_BYTES >> 4);
    const uint8_t* valid_t = valid + (grp + it * NG) * T + 2 * t;
    wg_fence();
#pragma unroll
    for (int s = 0; s < DH / 16; ++s) wgmma_ss(p, qa + 2 * s, ks + 2 * s, s > 0);
    wg_commit();
#pragma unroll
    for (int s = 0; s < DH / 16; ++s) wgmma_ss(dp, da + 2 * s, vs + 2 * s, s > 0);
    wg_commit();
    wg_wait<1>(p);  // S is in; dP runs while the exponentials are taken
#pragma unroll
    for (int n = 0; n < T / 8; ++n) {
      const uchar2 ok = *reinterpret_cast<const uchar2*>(valid_t + n * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(fmaf(p[4 * n + e], scale, -lse_r[e >> 1]));
        p[4 * n + e] = ((e & 1) ? ok.y : ok.x) ? pe : 0.f;
      }
    }
    wg_wait<0>(dp);
  };

  // pass 1: delta
  float num[2] = {0.f, 0.f}, den[2] = {0.f, 0.f};
  for (int it = 0; it < cnt; ++it) {
    if (it + 1 < cnt) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    group_sync(grp);
    float p[32], dp[32];
    p_dp(it, p, dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      num[(i >> 1) & 1] += p[i] * dp[i];
      den[(i >> 1) & 1] += p[i];
    }
    if (it + STAGES < cnt) group_sync(grp);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    num[r] += __shfl_xor_sync(0xffffffffu, num[r], 1);
    num[r] += __shfl_xor_sync(0xffffffffu, num[r], 2);
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
    if (t == 0) row_sums[grp][wr + g + 8 * r] = make_float2(num[r], den[r]);
  }
  __syncthreads();
  float delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float2 sum = row_sums[0][wr + g + 8 * r];
#pragma unroll
    for (int o = 1; o < NG; ++o) {
      sum.x += row_sums[o][wr + g + 8 * r].x;
      sum.y += row_sums[o][wr + g + 8 * r].y;
    }
    delta_r[r] = sum.y > 0.f ? sum.x / sum.y : 0.f;
    if (grp == 0 && t == 0 && q0 + wr + g + 8 * r < N) delta[row_i + 8 * r] = delta_r[r];
  }

  // pass 2, last tile first: dS and dQ
  float dqc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqc[i] = 0.f;
  for (int it = cnt - 1; it >= 0; --it) {
    cp_async_wait<1>();
    fence_async_smem();
    group_sync(grp);
    float p[32], ds[32];
    p_dp(it, p, ds);
#pragma unroll
    for (int i = 0; i < 32; ++i) ds[i] = p[i] * (ds[i] - delta_r[(i >> 1) & 1]) * scale;
    uint32_t dsa[4][4];
    wg_c_to_a(dsa, ds);
    const uint64_t ks = wg_desc(smem_addr(ring + (it % STAGES) * 2 * WG_TILE_BYTES));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) wgmma_rs(dqc, dsa[kk], ks + 128 * kk);  // dQ += dS K
    wg_commit();
    wg_wait<0>(dqc);
    group_sync(grp);
    if (it >= STAGES) stage(it - STAGES);
    cp_async_commit();
  }

  if (grp > 0) put_partial<8>(reinterpret_cast<float*>(ring), reinterpret_cast<const float(*)[4]>(dqc), gt);
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int o = 1; o < NG; ++o)
      add_partial<8>(reinterpret_cast<float(*)[4]>(dqc),
                     reinterpret_cast<const float*>(rings + o * STAGES * 2 * WG_TILE_BYTES), gt);
    store_rows<DH>(dq, b, N, H, h, q0 + wr + g, t, reinterpret_cast<const float(*)[4]>(dqc));
  }
}

// ------------------------------------------------------------------ f32: register-tiled FFMA

// Groups of a block, each count measured on the card against one group
// (PERF.md): two where their shared memory fits and their registers (128 a
// thread at 512 threads) do not spill; one for dK/dV at dh = 64 (two would
// need 244 KB) and for dQ at dh = 16 (two spill).
template <int DH>
__host__ __device__ constexpr int dkdv_ffma_groups() { return DH == 64 ? 1 : 2; }
template <int DH>
__host__ __device__ constexpr int dq_ffma_groups() { return DH == 16 ? 1 : 2; }

// One dK/dV group's ring stage: Q and dO tiles, then the lse and delta rows.
template <int DH>
__host__ __device__ constexpr int dkdv_ffma_stage() { return 2 * T * f32_ld<DH>() + 2 * T; }

// A group's floats: its ring, then the P and dS tiles.
template <int DH>
__host__ __device__ constexpr int dkdv_ffma_group() {
  return STAGES * dkdv_ffma_stage<DH>() + 2 * T * XLD;
}

template <int DH, int NG>
__host__ __device__ constexpr int dkdv_ffma_smem_bytes() { return (2 * T * f32_ld<DH>() + NG * dkdv_ffma_group<DH>()) * 4; }

// dK and dV of the block's 64 keys. Per query tile: S^T and dP^T (64 keys x
// 64 queries) as register tiles, P and dS in registers, through shared
// memory as P[query][key] and dS[query][key]; then warps 0-3 take
// dV += P^T dO and warps 4-7 dK += dS^T Q, 4 keys x dh / 8 dims a thread.
template <int DH, int NG>
__global__ void __launch_bounds__(NG * FG, 1)
dkdv_ffma(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
          const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
          const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
          const uint8_t* __restrict__ mask, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dk, float* __restrict__ dv, int N, int M, int H, float scale) {
  constexpr int LD = f32_ld<DH>(), DW = DH / 8, STAGE = dkdv_ffma_stage<DH>(), GROUP_F = dkdv_ffma_group<DH>();
  extern __shared__ __align__(16) float fsm[];
  float* own_k = fsm;
  float* own_v = own_k + T * LD;
  float* rings = own_v + T * LD;
  const int tid = threadIdx.x, grp = tid / FG, gt = tid % FG;
  float* ring = rings + grp * GROUP_F;
  float* xp = ring + STAGES * STAGE;  // P[query][key]
  float* xs = xp + T * XLD;           // dS[query][key]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * T;
  const int ntiles = (N + T - 1) / T;  // query tiles; group grp takes grp, grp + NG, ...
  const int cnt = grp < ntiles ? (ntiles - grp + NG - 1) / NG : 0;
  const int64_t do_rs = (int64_t)H * DH;
  const float* q_b = q + b * q_bs + h * DH;
  const float* do_b = dout + b * N * do_rs + h * DH;
  const float* lse_b = lse + ((int64_t)b * H + h) * N;
  const float* delta_b = delta + ((int64_t)b * H + h) * N;

  // the group's `it`-th query tile into its stage; rows past N are zeros
  // (lse = delta = 0 beside dO = 0: P finite, dS = 0, no dV)
  auto stage = [&](int it) {
    float* s = ring + (it % STAGES) * STAGE;
    const int r0 = (grp + it * NG) * T;
    stage_f32<DH, FG>(s, q_b, q_rs, r0, N, gt);
    stage_f32<DH, FG>(s + T * LD, do_b, do_rs, r0, N, gt);
    if (gt < 2 * T) {
      const int j = gt % T;
      const bool ok = r0 + j < N;
      const float* src = gt < T ? lse_b : delta_b;
      cp_async_4(s + 2 * T * LD + gt, ok ? src + r0 + j : src, ok);
    }
  };

  stage_f32<DH, NG * FG>(own_k, k + b * k_bs + h * DH, k_rs, k0, M, tid);
  stage_f32<DH, NG * FG>(own_v, v + b * v_bs + h * DH, v_rs, k0, M, tid);
  cp_async_commit();
  if (cnt > 0) stage(0);
  cp_async_commit();

  // the thread's 4 keys of S^T as factors (key_row): P = exp2(S s2 - lse
  // log2 e) where the key counts, dS = P (dP - delta) ds
  const NtLane L = nt_lane(gt);
  const bool dead = dead_batch(mask, b, M);
  float s2[4], ds_scale[4];
  bool counts[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const KeyRow key = key_row(key_state(mask, b, M, k0 + L.own + 8 * i, dead), scale);
    s2[i] = key.s_scale * LOG2E;
    ds_scale[i] = key.ds_scale;
    counts[i] = key.counts;
  }
  const int role = gt / (FG / 2);  // 0: dV = P^T dO, 1: dK = dS^T Q
  const TnLane R = tn_lane<DH, DW>(gt % (FG / 2));
  float acc[4][DW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DW; ++e) acc[i][e] = 0.f;

  cp_async_wait<0>();  // the own tiles (and the first query tile) have landed
  __syncthreads();
  for (int it = 0; it < cnt; ++it) {
    cp_async_wait<0>();  // tile it has landed; the group is done with tile it - 1
    ffma_group_sync(grp);
    if (it + 1 < cnt) stage(it + 1);
    cp_async_commit();
    const float* cur = ring + (it % STAGES) * STAGE;
    const float* qs = cur;
    const float* dos = cur + T * LD;
    const float* rows = cur + 2 * T * LD;  // lse, then delta
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    nt_product<DH>(s, own_k + L.own * LD, qs + L.loop * LD);
    nt_product<DH>(dp, own_v + L.own * LD, dos + L.loop * LD);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float l2 = rows[L.loop + 4 * j] * LOG2E, d = rows[T + L.loop + 4 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // the exponential outside the choice: no branch
        const float e = exp2f(fmaf(s[i][j], s2[i], -l2));
        s[i][j] = counts[i] ? e : 0.f;
        dp[i][j] = s[i][j] * (dp[i][j] - d) * ds_scale[i];
      }
    }
    store_x(xp, s, L);
    store_x(xs, dp, L);
    ffma_group_sync(grp);
    tn_product<DH, DW>(acc, (role ? xs : xp) + R.own, (role ? qs : dos) + R.dim);
  }

  add_groups<NG, 4 * DW>(&acc[0][0], rings, GROUP_F, grp, gt);
  if (grp == 0) store_out<DW>((role ? dk : dv) + (int64_t)b * M * do_rs + h * DH, k0, M, do_rs, acc, R);
}

// A dQ group's ring stage: K and V tiles.
template <int DH>
__host__ __device__ constexpr int dq_ffma_stage() { return 2 * T * f32_ld<DH>(); }

// A group's floats: its ring, then the dS tile.
template <int DH>
__host__ __device__ constexpr int dq_ffma_group() { return STAGES * dq_ffma_stage<DH>() + T * XLD; }

template <int DH, int NG>
__host__ __device__ constexpr int dq_ffma_smem_bytes() { return (2 * T * f32_ld<DH>() + NG * dq_ffma_group<DH>()) * 4; }

// dQ of the block's 64 queries, and their delta. Two passes over the key
// tiles: the first for delta = rowsum(P dP) / rowsum(P) over the valid keys
// (each thread's partial sums over its keys, added across the 16 threads of
// a row and the groups once, in a fixed order), the second, last tile
// first, for dS, through shared memory as dS[key][query], and dQ += dS K,
// 4 queries x dh / 16 dims a thread. A group's last two tiles are still in
// its ring when the second pass starts.
template <int DH, int NG>
__global__ void __launch_bounds__(NG * FG, 1)
dq_ffma(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
        const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
        const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
        const uint8_t* __restrict__ mask, const float* __restrict__ dout,
        const float* __restrict__ lse, float* __restrict__ delta,
        float* __restrict__ dq, int N, int M, int H, float scale) {
  constexpr int LD = f32_ld<DH>(), DW = DH / 16, STAGE = dq_ffma_stage<DH>(), GROUP_F = dq_ffma_group<DH>();
  __shared__ float2 row_sums[NG][4][T];  // (sum P dP, sum P) per group, warp row and own row
  extern __shared__ __align__(16) float fsm[];
  float* own_q = fsm;
  float* own_do = own_q + T * LD;
  float* rings = own_do + T * LD;
  const int tid = threadIdx.x, grp = tid / FG, gt = tid % FG;
  float* ring = rings + grp * GROUP_F;
  float* xs = ring + STAGES * STAGE;  // dS[key][query]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * T;
  const int ntiles = (M + T - 1) / T;  // key tiles; group grp takes grp, grp + NG, ...
  const int cnt = grp < ntiles ? (ntiles - grp + NG - 1) / NG : 0;
  const int64_t do_rs = (int64_t)H * DH;
  const float* k_b = k + b * k_bs + h * DH;
  const float* v_b = v + b * v_bs + h * DH;

  auto stage = [&](int it) {
    float* s = ring + (it % STAGES) * STAGE;
    const int j0 = (grp + it * NG) * T;
    stage_f32<DH, FG>(s, k_b, k_rs, j0, M, gt);
    stage_f32<DH, FG>(s + T * LD, v_b, v_rs, j0, M, gt);
  };

  stage_f32<DH, NG * FG>(own_q, q + b * q_bs + h * DH, q_rs, q0, N, tid);
  stage_f32<DH, NG * FG>(own_do, dout + b * N * do_rs + h * DH, do_rs, q0, N, tid);
  cp_async_commit();
  if (cnt > 0) stage(0);
  cp_async_commit();

  const NtLane L = nt_lane(gt);
  const int64_t row_i = ((int64_t)b * H + h) * N + q0 + L.own;  // of this thread's first own row
  float l2[4];  // lse * log2 e of the thread's 4 rows; P = 0 past N
#pragma unroll
  for (int i = 0; i < 4; ++i) l2[i] = q0 + L.own + 8 * i < N ? lse[row_i + 8 * i] * LOG2E : INFINITY;
  const float s2 = scale * LOG2E;

  // P (valid keys only) and dP of the group's `it`-th key tile: own rows
  // (queries) L.own + 8i, keys L.loop + 4j
  auto p_dp = [&](int it, float (*p)[4], float (*dp)[4]) {
    const float* cur = ring + (it % STAGES) * STAGE;
    const int key0 = (grp + it * NG) * T + L.loop;
    bool ok[4];  // asked for ahead of the products, which hide the trip
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ok[j] = key0 + 4 * j < M && (mask == nullptr || mask[(int64_t)b * M + key0 + 4 * j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = dp[i][j] = 0.f;
    nt_product<DH>(p, own_q + L.own * LD, cur + L.loop * LD);
    nt_product<DH>(dp, own_do + L.own * LD, cur + T * LD + L.loop * LD);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = exp2f(fmaf(p[i][j], s2, -l2[i]));
        p[i][j] = ok[j] ? e : 0.f;
      }
  };

  cp_async_wait<0>();  // the own tiles (and the first key tile) have landed
  __syncthreads();

  // pass 1: delta
  float num[4] = {0.f, 0.f, 0.f, 0.f}, den[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = 0; it < cnt; ++it) {
    cp_async_wait<0>();
    ffma_group_sync(grp);
    if (it + 1 < cnt) stage(it + 1);
    cp_async_commit();
    float p[4][4], dp[4][4];
    p_dp(it, p, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        num[i] = fmaf(p[i][j], dp[i][j], num[i]);
        den[i] += p[i][j];
      }
  }
  const int lane = gt % 32, wq = gt / 64;  // a row's threads: lanes 8 apart, warps 2 apart
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    num[i] += __shfl_xor_sync(0xffffffffu, num[i], 8);
    num[i] += __shfl_xor_sync(0xffffffffu, num[i], 16);
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 8);
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 16);
    if (lane < 8) row_sums[grp][wq][L.own + 8 * i] = make_float2(num[i], den[i]);
  }
  __syncthreads();
  float delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int o = 0; o < NG; ++o)
#pragma unroll
      for (int w = 0; w < 4; ++w) {  // in the groups' and warps' order
        sum.x += row_sums[o][w][L.own + 8 * i].x;
        sum.y += row_sums[o][w][L.own + 8 * i].y;
      }
    delta_r[i] = sum.y > 0.f ? sum.x / sum.y : 0.f;
    if (grp == 0 && wq == 0 && lane < 8 && q0 + L.own + 8 * i < N) delta[row_i + 8 * i] = delta_r[i];
  }

  // pass 2, last tile first: dS and dQ. Tiles cnt - 1 and cnt - 2 are in
  // the ring; tile it - 1 follows tile it + 1 into its stage.
  const TnLane R = tn_lane<DH, DW>(gt);
  float acc[4][DW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DW; ++e) acc[i][e] = 0.f;
  for (int it = cnt - 1; it >= 0; --it) {
    cp_async_wait<0>();
    ffma_group_sync(grp);
    if (it >= 1 && it - 1 < cnt - STAGES) stage(it - 1);
    cp_async_commit();
    float p[4][4], ds[4][4];
    p_dp(it, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ds[i][j] = p[i][j] * (ds[i][j] - delta_r[i]) * scale;
    store_x(xs, ds, L);
    ffma_group_sync(grp);
    tn_product<DH, DW>(acc, xs + R.own, ring + (it % STAGES) * STAGE + R.dim);  // dQ += dS K
  }

  add_groups<NG, 4 * DW>(&acc[0][0], rings, GROUP_F, grp, gt);
  if (grp == 0) store_out<DW>(dq + (int64_t)b * N * do_rs + h * DH, q0, N, do_rs, acc, R);
}

// ------------------------------------------------------------------ f32, heads of 128: 3xTF32 on mma.sync

// A block of `dq_3xtf32` / `dkdv_3xtf32`: BR own rows of one (b, head) of
// 128 values and 2 BR / 16 warps; warp w owns rows 16 (w % (BR / 16)) and
// the head's half w / (BR / 16), 64 values. Every staged tile is kept as
// its two halves, rows of 68 floats (ldmatrix's 8 rows, and the output
// products' float4 of 8 lanes, on distinct banks); each half's warps stage,
// read and wait for their own half alone. Loop tiles of KT rows come
// through a ring of SLOTS slots a half.
constexpr int WB_DH = 128, WB_HALF = 64;
constexpr int WB_LD = f32_ld<WB_HALF>();  // row pitch of a staged half, in floats

template <int BR>
__host__ __device__ constexpr int wb_threads() { return 2 * BR / 16 * 32; }

// A half's slot: its two loop tiles and, for dK/dV, the tile's lse and delta
// rows. An exchange tile: one warp pair's partial S or dP (BR rows of KT + 8).
template <bool DQ, int KT>
__host__ __device__ constexpr int wb_slot() { return 2 * KT * WB_LD + (DQ ? 0 : 2 * KT); }
template <int BR, int KT>
__host__ __device__ constexpr int wb_exch() { return BR * (KT + 8); }

// The bytes of a block's shared memory: each half's own tiles (S's operand,
// then dP's), each half's ring, and the exchange tiles for even and odd
// steps, each half, S and dP.
template <bool DQ, int BR, int KT, int SLOTS>
__host__ __device__ constexpr int wb_smem_bytes() {
  return (4 * BR * WB_LD + 2 * SLOTS * wb_slot<DQ, KT>() + 8 * wb_exch<BR, KT>()) * 4;
}

// The value (of the warp's half) that an output product's column c of
// n-tile n takes: wb_value(c) + n. A lane's B fragments of the 8 n-tiles
// are then two 16-byte loads a row (at value wb_value(g)), on distinct
// banks for the 8 lanes of a quarter warp.
__host__ __device__ constexpr int wb_value(int c) { return 16 * (c % 4) + 8 * (c / 4); }

// s[n] (the warp's 16 own rows x the loop tile's rows 8n + wf_key(c), C
// layout) += Own . Loop^T over the warp's half: `a_addr` the lane's
// ldmatrix address in its own half tile, `b_addr` the lane's in the loop
// half tile (two n-tiles' B fragments an x4, the lane's row the loop row of
// its column). Each k-step's three products summed from zero; UNROLL
// k-steps unrolled.
template <int NT, int UNROLL>
__device__ __forceinline__ void wb_scores(float (*s)[4], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll (UNROLL)
  for (int ks = 0; ks < WB_HALF / 8; ++ks) {
    uint32_t a[4], ah[4], al[4];
    ldsm_x4(a, a_addr + ks * 32);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), ah[e], al[e]);
    uint32_t bf[2 * NT], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) ldsm_x4(bf + 4 * np, b_addr + np * 16 * WB_LD * 4 + ks * 32);
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) split_tf32(__uint_as_float(bf[i]), bh[i / 2][i % 2], bl[i / 2][i % 2]);
    mma_3xtf32_tiles<NT>(s, ah, al, bh, bl);
  }
}

// c[n] (the warp's 16 own rows x its half's values wb_value(col) + n, C
// layout) += X . (Y - 1 y0^T) over the loop tile's KT rows: X's split A
// fragments from S's C layout (k-step kk takes loop rows 8 kk + t and 8 kk
// + t + 4, `wf_key`), `y` the loop half tile at row t and value wb_value(g),
// `y0` (the lane's 8 values of a row taken from every loop row; zeros for
// none) subtracted before the split.
template <int KT>
__device__ __forceinline__ void wb_output(float (*c)[4], const uint32_t (*xh)[4], const uint32_t (*xl)[4],
                                          const float* y, const float* y0) {
#pragma unroll
  for (int kk = 0; kk < KT / 8; ++kk) {
    const float* r0 = y + kk * 8 * WB_LD;
    const float* r1 = r0 + 4 * WB_LD;
    const float4 b00 = *reinterpret_cast<const float4*>(r0), b01 = *reinterpret_cast<const float4*>(r0 + 4);
    const float4 b10 = *reinterpret_cast<const float4*>(r1), b11 = *reinterpret_cast<const float4*>(r1 + 4);
    const float b0[8] = {b00.x, b00.y, b00.z, b00.w, b01.x, b01.y, b01.z, b01.w};
    const float b1[8] = {b10.x, b10.y, b10.z, b10.w, b11.x, b11.y, b11.z, b11.w};
    uint32_t bh[8][2], bl[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      split_tf32(b0[n] - y0[n], bh[n][0], bl[n][0]);
      split_tf32(b1[n] - y0[n], bh[n][1], bl[n][1]);
    }
    mma_3xtf32_tiles<8>(c, xh[kk], xl[kk], bh, bl);
  }
}

// x (n-tiles of the C layout, loop rows 8 kk + t, + 4 as `wb_scores` orders
// them) as split A fragments: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4), C's 0, 2, 1, 3
template <int NT>
__device__ __forceinline__ void wb_fragments(uint32_t (*xh)[4], uint32_t (*xl)[4], const float (*x)[4]) {
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    split_tf32(x[kk][0], xh[kk][0], xl[kk][0]);
    split_tf32(x[kk][2], xh[kk][1], xl[kk][1]);
    split_tf32(x[kk][1], xh[kk][2], xl[kk][2]);
    split_tf32(x[kk][3], xh[kk][3], xl[kk][3]);
  }
}

// The warp's 16 rows of its half of an output (C layout as `wb_output`
// leaves it) to a contiguous (., H * 128) f32 matrix at `out` (the batch,
// head and half applied): lane t's columns 2t, 2t + 1 are 8 consecutive
// values each.
__device__ __forceinline__ void wb_store(float* out, int row0, int rows, int64_t rs, const float (*c)[4], int g,
                                         int t) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + g + 8 * e;
    if (row >= rows) continue;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int i = 2 * e + cc;
      float* o = out + (int64_t)row * rs + wb_value(2 * t + cc);
      *reinterpret_cast<float4*>(o) = make_float4(c[0][i], c[1][i], c[2][i], c[3][i]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(c[4][i], c[5][i], c[6][i], c[7][i]);
    }
  }
}

// Own rows a block, loop rows a step, ring slots a half and the score
// products' unrolled k-steps at heads of 128, each kernel's measured on the
// card against its neighbours (PERF.md).
constexpr int DQ_ROWS = 64, DQ_KT = 32, DQ_SLOTS = 2, DQ_UNROLL = 4;
constexpr int DKDV_ROWS = 32, DKDV_KT = 16, DKDV_SLOTS = 2, DKDV_UNROLL = 8;

// One block. dQ (DQ): own rows are queries; a delta pass over the key tiles,
// then a second pass for dS and dQ_half += dS K_half. dK/dV: own rows are
// keys; one pass over the query tiles, dV_half += P^T dO_half and dK_half +=
// dS^T Q_half. Every step, warp w multiplies its rows' partial S and dP
// over its half; warps w and w's partner in the other half swap them
// through shared memory behind a 64-thread barrier of their own and add
// them (the same bits in both: f32 addition commutes), so both take the same
// P and dS.
template <bool DQ, int BR, int KT, int SLOTS, int UNROLL>
__device__ __forceinline__ void wide_bwd_tf32(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
                                              const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
                                              const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
                                              const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                                              const float* __restrict__ lse, float* __restrict__ delta,
                                              float* __restrict__ out_s, float* __restrict__ out_p, int N, int M,
                                              int H, float scale, float* fsm) {
  constexpr int RG = BR / 16, HT = RG * 32, NT = KT / 8, EP = KT + 8;
  constexpr int OWN = BR * WB_LD, SLOT = wb_slot<DQ, KT>(), EXCH = wb_exch<BR, KT>();
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * BR, tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rg = w % RG, hf = w / RG, wr = 16 * rg, ht = tid % HT;
  const int own_rows = DQ ? N : M, loop_rows = DQ ? M : N, ntiles = (loop_rows + KT - 1) / KT;
  const int steps = (DQ ? 2 : 1) * ntiles;  // dQ: the delta pass, then the output pass
  const int64_t do_rs = (int64_t)H * WB_DH;
  const int col0 = h * WB_DH + hf * WB_HALF;  // the half's first value in a row
  const float* qh = q + b * q_bs + col0;
  const float* kh = k + b * k_bs + col0;
  const float* vh = v + b * v_bs + col0;
  const float* doh = dout + b * N * do_rs + col0;
  // S's operands (own, loop): (Q, K) for dQ, (K, Q) for dK/dV; dP's (dO, V), (V, dO)
  const float* own_s = DQ ? qh : kh;
  const float* own_p = DQ ? doh : vh;
  const float* loop_s = DQ ? kh : qh;
  const float* loop_p = DQ ? vh : doh;
  const int64_t own_s_rs = DQ ? q_rs : k_rs, own_p_rs = DQ ? do_rs : v_rs;
  const int64_t loop_s_rs = DQ ? k_rs : q_rs, loop_p_rs = DQ ? v_rs : do_rs;
  const float* lse_b = lse + ((int64_t)b * H + h) * N;
  float* delta_b = delta + ((int64_t)b * H + h) * N;
  float* own = fsm + hf * 2 * OWN;                     // the half's own tiles: S's operand, dP's
  float* ring = fsm + 4 * OWN + hf * SLOTS * SLOT;      // the half's slots
  float* exch = fsm + 4 * OWN + 2 * SLOTS * SLOT;       // [parity][half][S, dP]

  // step u's loop tile (tile u % ntiles) into its slot: the half's columns of
  // both operands, rows past the end zeros; dK/dV: the tile's lse and delta
  // rows, 0 past N (beside dO = 0: P finite, dS = 0, no dV)
  auto stage = [&](int u) {
    float* slot = ring + (u % SLOTS) * SLOT;
    const int j0 = u % ntiles * KT;
    stage_f32<WB_HALF, HT, KT>(slot, loop_s, loop_s_rs, j0, loop_rows, ht);
    stage_f32<WB_HALF, HT, KT>(slot + KT * WB_LD, loop_p, loop_p_rs, j0, loop_rows, ht);
    if (!DQ && ht < 2 * KT) {
      const int j = ht % KT;
      const bool ok = j0 + j < N;
      const float* src = ht < KT ? lse_b : delta_b;
      cp_async_4(slot + 2 * KT * WB_LD + ht, ok ? src + j0 + j : src, ok);
    }
  };
  stage_f32<WB_HALF, HT, BR>(own, own_s, own_s_rs, r0, own_rows, ht);
  stage_f32<WB_HALF, HT, BR>(own + OWN, own_p, own_p_rs, r0, own_rows, ht);
#pragma unroll
  for (int u = 0; u < SLOTS - 1; ++u) {
    if (u < steps) stage(u);
    cp_async_commit();
  }
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

  const uint32_t a_addr = smem_addr(own) + ((wr + lane % 8 + 8 * ((lane / 8) % 2)) * WB_LD + 4 * (lane / 16)) * 4;
  // the lane's loop row: that of column lane % 8 of n-tile lane / 16 (of a pair)
  const uint32_t b_lane = ((8 * (lane / 16) + wf_key(lane % 8)) * WB_LD + 4 * ((lane / 8) % 2)) * 4;
  const int y_lane = t * WB_LD + wb_value(g);
  // dQ: every row of dS sums to 0, so dS K = dS (K - 1 k0^T), k0 the first key's row: the
  // product takes K less it, and the keys' common part, which the 3xTF32 products would
  // round, drops out before them. dK and dV subtract nothing.
  float k0[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if constexpr (DQ) {
#pragma unroll
    for (int n = 0; n < 8; ++n) k0[n] = kh[wb_value(g) + n];
  }
  float acc[DQ ? 1 : 2][8][4];  // dQ; dK, then dV
#pragma unroll
  for (int i = 0; i < (DQ ? 1 : 2); ++i) zero<8>(acc[i]);
  float num[2] = {0.f, 0.f}, den[2] = {0.f, 0.f};
  for (int u = 0; u < steps; ++u) {
    cp_async_wait<SLOTS - 2>();  // step u's tile has landed
    // for the half's warps, which alone read its slots; and step u - 1's slot is read no more
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + hf), "n"(HT) : "memory");
    if (u + SLOTS - 1 < steps) stage(u + SLOTS - 1);
    cp_async_commit();
    const float* slot = ring + (u % SLOTS) * SLOT;
    const int j0 = u % ntiles * KT;
    // dQ: this lane's keys 8n + wf_key(2t + e), valid (bit 2n + e), asked for ahead of the products
    uint32_t ok = 0;
    if constexpr (DQ) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j0 + 8 * n + t + 4 * e;
          ok |= (key < M && (mask == nullptr || mask[(int64_t)b * M + key]) ? 1u : 0u) << (2 * n + e);
        }
    }
    float s[NT][4], dp[NT][4];
    zero<NT>(s);
    zero<NT>(dp);
    wb_scores<NT, UNROLL>(s, a_addr, smem_addr(slot) + b_lane);
    wb_scores<NT, UNROLL>(dp, a_addr + OWN * 4, smem_addr(slot + KT * WB_LD) + b_lane);
    // the partials swapped with the partner through the tiles of step u's parity, which
    // the partner read at step u - 2, before the pair's barrier of step u - 1
    float* mine = exch + ((u & 1) * 2 + hf) * 2 * EXCH + (wr + g) * EP + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(mine + 8 * n) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(mine + 8 * EP + 8 * n) = make_float2(s[n][2], s[n][3]);
      *reinterpret_cast<float2*>(mine + EXCH + 8 * n) = make_float2(dp[n][0], dp[n][1]);
      *reinterpret_cast<float2*>(mine + EXCH + 8 * EP + 8 * n) = make_float2(dp[n][2], dp[n][3]);
    }
    asm volatile("bar.sync %0, 64;\n" :: "r"(3 + rg) : "memory");
    const float* other = mine + (1 - 2 * hf) * 2 * EXCH;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 s0 = *reinterpret_cast<const float2*>(other + 8 * n);
      const float2 s1 = *reinterpret_cast<const float2*>(other + 8 * EP + 8 * n);
      const float2 d0 = *reinterpret_cast<const float2*>(other + EXCH + 8 * n);
      const float2 d1 = *reinterpret_cast<const float2*>(other + EXCH + 8 * EP + 8 * n);
      s[n][0] += s0.x;
      s[n][1] += s0.y;
      s[n][2] += s1.x;
      s[n][3] += s1.y;
      dp[n][0] += d0.x;
      dp[n][1] += d0.y;
      dp[n][2] += d1.x;
      dp[n][3] += d1.y;
    }
    uint32_t xh[NT][4], xl[NT][4];
    if constexpr (DQ) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // the exponential outside the choice: no branch
          const float pe = exp2f(fmaf(s[n][e], scale * LOG2E, -l2[e >> 1]));
          s[n][e] = (ok >> (2 * n + (e & 1))) & 1u ? pe : 0.f;
        }
      if (u < ntiles) {  // the delta pass: this lane's sums over its keys
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            num[e >> 1] = fmaf(s[n][e], dp[n][e], num[e >> 1]);
            den[e >> 1] += s[n][e];
          }
        if (u == ntiles - 1) {  // delta = rowsum(P dP) / rowsum(P): the row's 4 lanes, in one order in both warps
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            num[e] += __shfl_xor_sync(0xffffffffu, num[e], 1);
            num[e] += __shfl_xor_sync(0xffffffffu, num[e], 2);
            den[e] += __shfl_xor_sync(0xffffffffu, den[e], 1);
            den[e] += __shfl_xor_sync(0xffffffffu, den[e], 2);
            delta_r[e] = den[e] > 0.f ? num[e] / den[e] : 0.f;
            const int row = r0 + wr + g + 8 * e;
            if (hf == 0 && t == 0 && row < N) delta_b[row] = delta_r[e];
          }
        }
        continue;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] * (dp[n][e] - delta_r[e >> 1]) * scale;
      wb_fragments<NT>(xh, xl, s);
      wb_output<KT>(acc[0], xh, xl, slot + y_lane, k0);  // dQ_half += dS (K_half - 1 k0^T)
    } else {
      const float* rows = slot + 2 * KT * WB_LD;  // the tile's lse, then delta
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + t + 4 * (e & 1);
          const float pe = exp2f(fmaf(s[n][e], s2[e >> 1], -rows[col] * LOG2E));
          s[n][e] = counts[e >> 1] ? pe : 0.f;
          dp[n][e] = s[n][e] * (dp[n][e] - rows[KT + col]) * ds_scale[e >> 1];
        }
      wb_fragments<NT>(xh, xl, s);
      wb_output<KT>(acc[1], xh, xl, slot + KT * WB_LD + y_lane, k0);  // dV_half += P^T dO_half
      wb_fragments<NT>(xh, xl, dp);
      wb_output<KT>(acc[0], xh, xl, slot + y_lane, k0);  // dK_half += dS^T Q_half
    }
  }
  cp_async_wait<0>();
  wb_store(out_s + (int64_t)b * own_rows * do_rs + col0, r0 + wr, own_rows, do_rs, acc[0], g, t);
  if constexpr (!DQ) wb_store(out_p + (int64_t)b * own_rows * do_rs + col0, r0 + wr, own_rows, do_rs, acc[1], g, t);
}

// Every thread may take 255 registers: as many blocks an SM as 256 threads
// make (a bound without it drew ~190 registers and ran 10-20% slower).
template <int BR>
__host__ __device__ constexpr int wb_min_blocks() { return 256 / wb_threads<BR>(); }

__global__ void __launch_bounds__(wb_threads<DQ_ROWS>(), wb_min_blocks<DQ_ROWS>())
dq_3xtf32(const float* __restrict__ q, int64_t q_bs, int64_t q_rs, const float* __restrict__ k, int64_t k_bs,
          int64_t k_rs, const float* __restrict__ v, int64_t v_bs, int64_t v_rs, const uint8_t* __restrict__ mask,
          const float* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
          float* __restrict__ dq, int N, int M, int H, float scale) {
  extern __shared__ __align__(16) float fsm[];
  wide_bwd_tf32<true, DQ_ROWS, DQ_KT, DQ_SLOTS, DQ_UNROLL>(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout,
                                                           lse, delta, dq, nullptr, N, M, H, scale, fsm);
}

__global__ void __launch_bounds__(wb_threads<DKDV_ROWS>(), wb_min_blocks<DKDV_ROWS>())
dkdv_3xtf32(const float* __restrict__ q, int64_t q_bs, int64_t q_rs, const float* __restrict__ k, int64_t k_bs,
            int64_t k_rs, const float* __restrict__ v, int64_t v_bs, int64_t v_rs, const uint8_t* __restrict__ mask,
            const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int N, int M, int H, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* d = const_cast<float*>(delta);  // read only
  wide_bwd_tf32<false, DKDV_ROWS, DKDV_KT, DKDV_SLOTS, DKDV_UNROLL>(q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask,
                                                                   dout, lse, d, dk, dv, N, M, H, scale, fsm);
}

// ------------------------------------------------------------------ launch

#define BWD_IN(T_)                                                                   \
  const T_ *q, int64_t q_bs, int64_t q_rs, const T_ *k, int64_t k_bs, int64_t k_rs, \
      const T_ *v, int64_t v_bs, int64_t v_rs, const uint8_t *mask, const T_ *dout, \
      const float *lse
#define BWD_IN_PASS q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, dout, lse

template <int DH, int NG>
int run_dkdv_bf16(BWD_IN(__nv_bfloat16), const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv,
                  int B, int N, int M, int H, float scale, cudaStream_t stream) {
  constexpr int BYTES = dkdv_smem_bytes<DH, NG>();
  const cudaError_t err = allow_smem(dkdv_mma<DH, NG>, BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_mma<DH, NG><<<dim3((M + T - 1) / T, H, B), NG * GROUP, BYTES, stream>>>(
      BWD_IN_PASS, delta, dk, dv, N, M, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int NG>
int run_dq_bf16(BWD_IN(__nv_bfloat16), float* delta, __nv_bfloat16* dq, int B, int N, int M, int H,
                float scale, cudaStream_t stream) {
  const int bytes = dq_smem_bytes<DH, NG>((M + T - 1) / T);
  const cudaError_t err = allow_smem(dq_mma<DH, NG>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_mma<DH, NG><<<dim3((N + T - 1) / T, H, B), NG * GROUP, bytes, stream>>>(
      BWD_IN_PASS, delta, dq, N, M, H, scale);
  return static_cast<int>(cudaGetLastError());
}

int run_dkdv_wg(BWD_IN(__nv_bfloat16), const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv,
                int B, int N, int M, int H, float scale, cudaStream_t stream) {
  constexpr int NG = WG_GROUPS_DKDV, BYTES = dkdv_wg_smem_bytes<NG>();
  const cudaError_t err = allow_smem(dkdv_wg<NG>, BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_wg<NG><<<dim3((M + T - 1) / T, H, B), NG * GROUP, BYTES, stream>>>(
      BWD_IN_PASS, delta, dk, dv, N, M, H, scale);
  return static_cast<int>(cudaGetLastError());
}

int run_dq_wg(BWD_IN(__nv_bfloat16), float* delta, __nv_bfloat16* dq, int B, int N, int M, int H,
              float scale, cudaStream_t stream) {
  constexpr int NG = WG_GROUPS_DQ;
  const int bytes = dq_wg_smem_bytes<NG>((M + T - 1) / T);
  const cudaError_t err = allow_smem(dq_wg<NG>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_wg<NG><<<dim3((N + T - 1) / T, H, B), NG * GROUP, bytes, stream>>>(
      BWD_IN_PASS, delta, dq, N, M, H, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkdv_bf16(BWD_IN(__nv_bfloat16), const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv,
                     int B, int N, int M, int H, int DH, float scale, cudaStream_t stream) {
  switch (DH) {
    case 16: return run_dkdv_bf16<16, MMA_GROUPS>(BWD_IN_PASS, delta, dk, dv, B, N, M, H, scale, stream);
    case 32: return run_dkdv_bf16<32, MMA_GROUPS>(BWD_IN_PASS, delta, dk, dv, B, N, M, H, scale, stream);
    case 64: return run_dkdv_wg(BWD_IN_PASS, delta, dk, dv, B, N, M, H, scale, stream);
    case 128: return run_dkdv_bf16<128, WIDE_GROUPS>(BWD_IN_PASS, delta, dk, dv, B, N, M, H, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_dq_bf16(BWD_IN(__nv_bfloat16), float* delta, __nv_bfloat16* dq, int B, int N, int M, int H,
                   int DH, float scale, cudaStream_t stream) {
  switch (DH) {
    case 16: return run_dq_bf16<16, MMA_GROUPS>(BWD_IN_PASS, delta, dq, B, N, M, H, scale, stream);
    case 32: return run_dq_bf16<32, MMA_GROUPS>(BWD_IN_PASS, delta, dq, B, N, M, H, scale, stream);
    case 64: return run_dq_wg(BWD_IN_PASS, delta, dq, B, N, M, H, scale, stream);
    case 128: return run_dq_bf16<128, WIDE_GROUPS>(BWD_IN_PASS, delta, dq, B, N, M, H, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DH>
int run_dkdv_f32(BWD_IN(float), const float* delta, float* dk, float* dv, int B, int N, int M, int H, float scale,
                 cudaStream_t stream) {
  constexpr int NG = dkdv_ffma_groups<DH>(), BYTES = dkdv_ffma_smem_bytes<DH, NG>();
  const cudaError_t err = allow_smem(dkdv_ffma<DH, NG>, BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_ffma<DH, NG><<<dim3((M + T - 1) / T, H, B), NG * FG, BYTES, stream>>>(
      BWD_IN_PASS, delta, dk, dv, N, M, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int run_dq_f32(BWD_IN(float), float* delta, float* dq, int B, int N, int M, int H, float scale,
               cudaStream_t stream) {
  constexpr int NG = dq_ffma_groups<DH>(), BYTES = dq_ffma_smem_bytes<DH, NG>();
  const cudaError_t err = allow_smem(dq_ffma<DH, NG>, BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_ffma<DH, NG><<<dim3((N + T - 1) / T, H, B), NG * FG, BYTES, stream>>>(
      BWD_IN_PASS, delta, dq, N, M, H, scale);
  return static_cast<int>(cudaGetLastError());
}

int run_dkdv_3xtf32(BWD_IN(float), const float* delta, float* dk, float* dv, int B, int N, int M, int H, float scale,
                    cudaStream_t stream) {
  constexpr int BYTES = wb_smem_bytes<false, DKDV_ROWS, DKDV_KT, DKDV_SLOTS>();
  const cudaError_t err = allow_smem(dkdv_3xtf32, BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_3xtf32<<<dim3((M + DKDV_ROWS - 1) / DKDV_ROWS, H, B), wb_threads<DKDV_ROWS>(), BYTES, stream>>>(
      BWD_IN_PASS, delta, dk, dv, N, M, H, scale);
  return static_cast<int>(cudaGetLastError());
}

int run_dq_3xtf32(BWD_IN(float), float* delta, float* dq, int B, int N, int M, int H, float scale,
                  cudaStream_t stream) {
  constexpr int BYTES = wb_smem_bytes<true, DQ_ROWS, DQ_KT, DQ_SLOTS>();
  const cudaError_t err = allow_smem(dq_3xtf32, BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_3xtf32<<<dim3((N + DQ_ROWS - 1) / DQ_ROWS, H, B), wb_threads<DQ_ROWS>(), BYTES, stream>>>(
      BWD_IN_PASS, delta, dq, N, M, H, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkdv_f32(BWD_IN(float), const float* delta, float* dk, float* dv, int B, int N, int M, int H,
                    int DH, float scale, cudaStream_t stream) {
  switch (DH) {
    case 16: return run_dkdv_f32<16>(BWD_IN_PASS, delta, dk, dv, B, N, M, H, scale, stream);
    case 32: return run_dkdv_f32<32>(BWD_IN_PASS, delta, dk, dv, B, N, M, H, scale, stream);
    case 64: return run_dkdv_f32<64>(BWD_IN_PASS, delta, dk, dv, B, N, M, H, scale, stream);
    case 128: return run_dkdv_3xtf32(BWD_IN_PASS, delta, dk, dv, B, N, M, H, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_dq_f32(BWD_IN(float), float* delta, float* dq, int B, int N, int M, int H, int DH, float scale,
                  cudaStream_t stream) {
  switch (DH) {
    case 16: return run_dq_f32<16>(BWD_IN_PASS, delta, dq, B, N, M, H, scale, stream);
    case 32: return run_dq_f32<32>(BWD_IN_PASS, delta, dq, B, N, M, H, scale, stream);
    case 64: return run_dq_f32<64>(BWD_IN_PASS, delta, dq, B, N, M, H, scale, stream);
    case 128: return run_dq_3xtf32(BWD_IN_PASS, delta, dq, B, N, M, H, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
// lse and delta are (B, H, N) f32. bf16: q, k, v, dout rows are 16-byte
// aligned. The dQ kernel writes delta and runs first; the dK/dV kernel
// reads it.
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
