// Masked multi-head softmax attention, forward, on packed heads.
//
// Replaces: image_matching_tpu/ops/pallas/attention.py, the three forward
// kernels of the JAX package with one kernel used at every key count:
//   _onepass_heads_forward (_attn_onepass_pair_kernel), packed (B, N, H*dh);
//   _onepass_forward (_attn_onepass_kernel), folded (B*H, N, dh);
//   _flash_forward (_flash_kernel), blocked online softmax.
// It computes, per batch b and head h (columns h*dh .. h*dh+dh-1 of the
// packed tensors), softmax(q_h k_h^T / sqrt(dh), masked keys at -1e9) v_h
// and writes (B, N, H*dh). Logits and the softmax statistics stay in f32 on
// chip.
//
// What bounds it on an H100: at the main path's (4, 1024, 4 x 64) bf16 the
// work is 4.3 GFLOP against 8 MB of q/k/v/o, so it is bound by the tensor
// cores' rate (~4 us at 989 TFLOP/s), not by memory; its 16.8 M
// exponentials take as long again at the SFUs' 16 a clock per SM, so the
// exponentials and the products have to run side by side. Measured
// (PERF.md), neither bounds the kernel yet: a call takes ~5x the bound,
// most of it latency along each group's chain of products, softmax and
// products, and each block's fixed cost (first loads, key table, merge).
//
// Common to the kernels below:
//   * keys are walked in 64-key tiles staged in shared memory, with
//     flash-style online softmax (running max m, sum l, rescaled output),
//     because one head's K and V at dh=64, K=1024 (256 KB in bf16) exceed a
//     block's 227 KB;
//   * heads are selected by column offsets into the packed tensors (no fold
//     transposes), and q/k/v may be row-strided views (e.g. slices of one
//     fused QKV projection) as long as their last dimension is contiguous;
//   * masked keys get a logit of exactly -1e9 (a fully masked row averages
//     V uniformly, as the plain version does); keys past the end weigh
//     nothing.
//
// bf16 (the main path) up to 64: one block per (b, head, 64-row query
// tile), NG warpgroups of 4 warps (16 query rows a warp). The groups split the key
// tiles: group g takes tiles g, g + NG, ..., so a block holds 4 NG warps
// although it owns only 64 rows, and one group's exponentials run beside
// another's products. Each group brings its K and V tiles by 16-byte
// `cp.async` (rows past M zero-filled) into its own ring of STAGES tiles,
// behind a named barrier of its own, so loads overlap math. The key mask
// row of batch b is read into shared memory once per block, as a state per
// key. Per tile the scores become logits in log2 units by a per-key factor
// and offset (scale * log2(e) and 0 for a valid key, 0 and -1e9 log2(e) for
// a masked one, 0 and -inf past M: no branch), the running max and sum move
// on (2 quad shuffles per row), P = 2^(logit - m) is rounded to bf16 (as the
// plain version rounds its probabilities) and O += P V. At the end the
// groups' (m, l, O) are merged through shared memory in the groups' order,
// m* = max m_g, O = sum O_g 2^(m_g - m*), l likewise, so two runs give the
// same bits, and one epilogue writes O (and the LSE). One launch per call.
//   * dh = 64, `attention_wg`: wgmma m64n64k16 on tiles in the 128-byte
//     swizzle. Q is staged once; S = Q K^T with both operands in shared
//     memory (K-major), O += P V with P's C layout reused as the A
//     fragments in registers and V (row-major by key) read transposed by
//     its descriptor.
//   * dh <= 32, `attention_mma`: mma.sync.m16n8k16 (f32 accumulate) on one
//     padded row-major copy of each tile (8 bf16 of padding per row, so the
//     8 rows of an ldmatrix fall on distinct banks): Q's A fragments and K's
//     B fragments by `ldmatrix`, V's by `ldmatrix.trans` from the same copy.
//
// bf16 at 128 (D = 320-512; heads of 80 and 96 zero-padded),
// `attention_wide<128, LSE>`, the kernel at 256 below at half its panels: O
// is 64 f32 registers a thread, S = Q K^T 8 k-steps of wgmma_ss over two
// panels, K and V tiles of 16 KB, one warpgroup a block and two blocks an
// SM. Bound: at D = 512's (4, 1024, 4 x 128) the function's 8.6 GFLOP take
// 0.00869 ms at 989 TFLOP/s. One thing differs from 256, measured on the
// card (PERF.md): a warp of its own copies K and V (`wide_producer`). With
// thread 0 of the warpgroup copying, as at 256, a call took 1.5x the time,
// and taking the copies out altogether 0.6x: the copying thread, waiting
// for the other warps to release a slot, held the warpgroup's products
// back. Deeper rings, 128 rows a block sharing the ring, clusters of 2 or 4
// blocks sharing each copy (multicast) and two warpgroups a block that
// split the key tiles did not help enough to keep (PERF.md).
// Measured (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W): 0.026 ms at (4,
// 1024, 4 x 128), 0.79 of SDPA's time and 0.34 of the bound
// (`attention_mma<128, 2>` before it: 0.056); 0.013 with LSE at (4, 512,
// 4 x 128), 0.6 of SDPA's (0.018 before it).
// Taking out the softmax or the copies each saves a sixth; no one part
// holds it.
//
// f32 (the f32 compute dtype) up to 128: `attention_ffma<dh, NG, LSE>`, register-
// tiled on plain f32 FMAs with the tiles of csrc/ffma.cuh that the f32
// backward kernels use; no tensor cores, which would round the products to
// TF32. Bound: the FMA pipe, 67 TFLOP/s: the function's two products are
// 4.3 GFLOP at the headline's (4, 1024, 4 x 64), 0.064 ms, against 8 MB of
// q/k/v/o (0.0025 ms at HBM's rate). A block owns 64 queries of one (b,
// head); NG groups of 8 warps split its key tiles, each group with its own
// 2-stage `cp.async` ring of K and V tiles (rows of dh + 4 floats) and its
// own named barrier. Per tile: S = Q K^T as 4 x 4 register tiles a thread
// (8 LDS.128 for 64 FMAs a step of 4 dims); each key's state (valid, masked,
// past M) from its mask byte, read per tile into registers (shared memory
// does not grow with M); a row's 64 logits lie on 16 threads in 4 warps, so
// its tile max takes 2 shuffles and a table of the 4 warps' maxima in shared
// memory; each row's running shift is an integer in log2 units, so every
// rescale is an exact power of two; P = 2^(x log2 e - shift) goes through
// shared memory as P[key][query], O is rescaled by its rows' corrections,
// and O += P V with 4 queries x 4 dims a thread (at dh < 64 the group's
// threads split the tile's keys into 64 / dh runs, added at the end; at dh =
// 128, 4 queries x 8 dims, and one group a block: two would need 341 KB of
// shared memory, one takes 187 KB). Three
// group barriers a tile. Each thread keeps partial row sums, added once at
// the end in a fixed order; the groups merge as the bf16 kernels' do; the
// LSE, shift ln 2 + log l, is taken in double and rounded once. Measured
// (PERF.md): 41% of the FMA pipe at the headline's shape, 0.89x f32 SDPA's
// time; the tiles' shared-memory loads (csrc/lds_probe.cu) allow two thirds.
//
// Heads wider than 128 (dh = C * 128, C >= 2; the wrapper zero-pads any
// other width above 128 to the next multiple). These replace
// _onepass_forward, _onepass_heads_forward and _flash_forward(_with_lse) at
// those widths, which keep a whole head in VMEM; a 64-row tile of 256
// values is 32 KB in bf16, 64 KB in f32. The route is by width and dtype:
//
// bf16 at 256 (C = 2; D = 640-1024), `attention_wide<256, LSE>`: a block
// of one warpgroup of 64 query rows. Bound:
// at D = 1024's (4, 1024, 4 x 256) the function's 17.2 GFLOP take 0.01737
// ms at 989 TFLOP/s (its 32 MB of q, k, v, o 0.0096 ms at HBM's rate); what
// a block reads through L2 is K and V of every key tile, 64 KB a tile, so
// at 64 rows a block the L2 traffic of a call is 16x the operands. The
// design, against the chunk blocks below:
//   * S once a key tile: a warpgroup owns all 256 output values of its
//     rows (O 64 x 256 f32, 128 registers a thread) and multiplies S =
//     Q K^T over the head's four 64-value panels (16 k-steps of wgmma_ss),
//     so the work is the function's (the chunk blocks: 1.5x) and no block exchanges
//     anything;
//   * Q staged once, by TMA, and read by wgmma from shared memory each tile
//     (no fragments in registers, no restaging);
//   * K_0, V_0, K_1, ... stream through a ring of 32 KB slots by TMA tensor
//     copies (128-byte swizzle, rows past M zeros) issued by thread 0,
//     an mbarrier a slot for "landed" and one for "released" (every
//     warp arrives once its products read the slot), so copies run ahead
//     of the products by the ring's depth, 2 slots (99 KB: two blocks an
//     SM, whose products cover each other's copies);
//   * products on wgmma m64n64k16: S with both operands in shared memory;
//     the online softmax on its C layout, O rescaled, P to A fragments in
//     registers (wg_c_to_a), O += P V with V's four panels read transposed
//     by their descriptors; S of the next tile is queued behind O += P V,
//     so the tensor cores have both while the warpgroup waits once a tile.
// Keys are a bit each in shared memory (8 bytes a tile: any key count), the
// logits made from the bits as `stage_key_table`'s factors make them. A
// block takes 64 rows: 128 (two warpgroups sharing a 4-slot ring, one
// block an SM) ran slower on the card at both of D = 1024's shapes.
// Measured (PERF.md): 0.049 ms at (4, 1024, 4 x 256), 0.64 of SDPA's time
// and 0.35 of the bound; a build with both the softmax and the copies'
// waits taken out still took two thirds of the time: what holds it is the
// chain of each tile's 32 products and the wait for it.
//
// f32 at 256 (C = 2), `attention_wide_3xtf32<LSE>`: a block of 64 query
// rows and two warpgroups. Bound: at D = 1024's (4, 1024, 4 x 256) the
// function's 17.2 GFLOP take 0.1041 ms at 165 TFLOP/s, the rate of
// f32-accurate products on the tensor cores as three TF32 ones (f32 SDPA's
// route), 0.2564 ms on the FMA pipe. The design:
//   * S once a key tile (work 1.0x; the chunk blocks below: 1.5x): warp w
//     owns rows 16 (w % 4) and head half w / 4; it multiplies its rows'
//     partial S over its half, and warps w and w ^ 4 swap the 16 x 16
//     partials through shared memory behind a 64-thread barrier of their
//     own and add them, the same bits in both (f32 addition commutes), so
//     both run the same softmax; each then adds P V over its own half of
//     the output (O 16 x 128 a warp, 64 registers a thread);
//   * both products as 3xTF32 on mma.sync.m16n8k8 (csrc/tf32.cuh): every
//     operand, P too, split into a TF32 part rounded to nearest and its
//     rest, three products a k-step summed from zero and added to the f32
//     total (the tensor cores' truncating sums, chained through the
//     total, would drift from float64 with the depth of the sum). wgmma
//     takes TF32 only K-major, which V (keys x values) is not for P V;
//   * S's columns are keys in the order t, t + 4 of each 8 (`wf_key`), so
//     that S's C layout is P's A fragment for keys in order and V's B
//     fragments come as one 16-byte load a row and four n-tiles (values
//     16c + n of column c), on distinct banks at a pitch of 132 floats,
//     as Q's A and K's B fragments by ldmatrix;
//   * a warpgroup stages its own halves of Q (once), K and V (16-key tiles
//     through a 3-slot `cp.async` ring), which it alone reads, behind a
//     barrier of its own: no block barrier in the loop, and the exchange
//     tiles alternate by tile (189 KB of shared memory: one block an SM);
//   * the softmax, shifts, LSE and dead element as `attention_ffma`'s.
// Measured (PERF.md): 0.45 ms at (4, 1024, 4 x 256), 0.88x f32 SDPA's time
// and 0.23 of the bound. Builds with one warp a row block's whole head, 4
// warps a row block, 32-key tiles, K and V copied by TMA bulk copies, or
// split once as they land all ran slower; taking parts out puts the time
// in the products with their operands' loads (the P V product a third)
// and the staging (a fifth), little in the splits or the exchange.
//
// bf16 above 256 (C >= 3) and f32 above 256:
// `attention_chunked<LSE>` (bf16) and `attention_ffma_chunked<LSE>` (f32).
// A block owns 64 queries of one (b, head) and ONE 128-value
// chunk c of the output (blockIdx.y = head * C + c), and walks the key
// tiles in steps through a 2-slot ring of padded 64 x 128 tiles: per key
// tile, C steps that each stage Q_c' and K_c' together and add Q_c' K_c'^T
// to S (bf16: mma.sync with Q's A fragments read from the slot, a k-step's
// fragments once for the tile's 8 n-tiles, `mma_nt_tile`; f32: the 4 x 4
// `nt_product`), then one step with V_c alone for the online softmax and
// O += P V_c, as the kernels at 128 do them. The accumulators are those of
// width 128; S, the softmax statistics and P are the whole head's, and each
// chunk block computes them again: C (C + 1) chunk products for the
// function's 2 C, 1.5x at 256. One warpgroup a block in bf16 (68 KB of ring
// plus the key table: 2 blocks an SM at K = 1024), one group of 8 warps in
// f32 (150 KB). Chunk 0 writes the LSE. Bound: the tensor cores' rate
// (bf16) or the FMA pipe's (f32); each chunk step brings 34 KB (68 KB in
// f32) through L2 with one step in flight.
//
// Forward with LSE (training): the same kernels with LSE = true also
// write the f32 log-sum-exp of every query row, (B, H, N), for the backward
// kernels of csrc/attention_bwd.cu. This replaces _flash_forward_with_lse
// (_flash_kernel_with_lse, attention.py:100/560). Inference instantiates
// LSE = false. A batch element with no valid key ("dead") has every logit
// at -1e9, where m + log(l) rounds back to -1e9 in f32 and the backward
// could no longer tell p = 1/M from p = 1; for it the kernel writes
// log(l) = log(M), the LSE of the row with the masked logits shifted to 0,
// and the backward kernels recognise the dead element from the mask the
// same way (no valid key in mask[b, :]).
#include <math.h>

#include "hopper.cuh"
#include "ffma.cuh"
#include "tma.cuh"
#include "tf32.cuh"

namespace {

constexpr float MASKED = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr double LN2_D = 0.6931471805599453;

// Warpgroups that split a block's key tiles, and tiles in a group's ring,
// each measured on the card against its neighbours (PERF.md): at dh = 64 two
// blocks of 2 groups on an SM (128 registers), at dh <= 32 one block of 4.
// A third stage moved nothing. (Heads of 128 and 256: `attention_wide`.)
constexpr int STAGES = 2, WG_GROUPS = 2, MMA_GROUPS = 4;

// ------------------------------------------------------------------ bf16, both kernels

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Per key of batch element b, the factor and offset that turn its raw score
// s = q . k into its logit in log2 units, s * f + o: (scale log2(e), 0) for
// a valid key, (0, -1e9 log2(e)) for a masked one, (0, -inf) past M, padded
// to whole tiles. True when the element has no valid key. Every thread of
// the block calls it, and the table may be read once it returns.
__device__ __forceinline__ bool stage_key_table(float2* keys, const uint8_t* mask, int b, int M, int ntiles,
                                                float scale2) {
  int any = 0;
  for (int j = threadIdx.x; j < ntiles * T; j += blockDim.x) {
    const bool valid = j < M && (mask == nullptr || mask[(int64_t)b * M + j]);
    keys[j] = valid ? make_float2(scale2, 0.f) : make_float2(0.f, j < M ? MASKED * LOG2E : -INFINITY);
    any |= valid;
  }
  return !__syncthreads_or(any);
}

// One tile's online softmax over this thread's 32 scores, in the C layout
// of 16 query rows x 64 keys (mma.sync's 8 n-tiles, or a warp's quarter of
// wgmma's 64 x 64): s[4n + e] is row g + 8 (e >> 1), key 8n + 2t + (e & 1).
// `logits(s + 4n, n)` turns n-tile n's raw scores into logits in log2 units,
// the rows' running max m and this thread's partial sums l move on, and the
// scores become P = 2^(logit - m); `corr` gets the factor by which the rows'
// earlier output is rescaled. Maxima and sums run in two chains a row, to
// halve their latency.
template <typename Logits>
__device__ __forceinline__ void online_softmax_by(float* s, float* m, float* l, float* corr, Logits logits) {
  float tmax[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    logits(s + 4 * n, n);
#pragma unroll
    for (int r = 0; r < 2; ++r) tmax[r][n & 1] = fmaxf(tmax[r][n & 1], fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 threads of a row group share a row
    float mx = fmaxf(tmax[r][0], tmax[r][1]);  // finite: key 0 of a tile is in range
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    corr[r] = ex2(m[r] - m_new);  // 0 at the first tile (m = -inf)
    m[r] = m_new;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2(s[i] - m[(i >> 1) & 1]);
    sum[(i >> 1) & 1][(i >> 3) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + (sum[r][0] + sum[r][1]);
}

// `online_softmax_by` with the logits s f + o from the key table
// (`stage_key_table`), `kt` at the entries of keys 2t, 2t + 1 of the tile.
__device__ __forceinline__ void online_softmax(float* s, float* m, float* l, float* corr, const float2* kt) {
  online_softmax_by(s, m, l, corr, [&](float* x, int n) {
    const float4 f = *reinterpret_cast<const float4*>(kt + 8 * n);  // keys 8n + 2t, + 1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      x[2 * r] = fmaf(x[2 * r], f.x, f.y);
      x[2 * r + 1] = fmaf(x[2 * r + 1], f.z, f.w);
    }
  });
}

// The groups' results for the block's rows, merged by group 0 in the
// groups' order: m* = max m_g, l = sum l_g 2^(m_g - m*), O likewise. On
// entry every thread holds its group's running m, its own partial l and
// its NF output partial sums `o` (element i of row (i >> 1) & 1); groups
// 1.. leave theirs in their rings (read no more, `ring_floats` apart from
// `rings`) and in `row_ml`. On return group 0 holds the merged m, l and o,
// l summed over the row's 4 threads. Every thread of the block calls it.
template <int NG, int NF>
__device__ __forceinline__ void merge_groups(float* o, float* m, float* l, float* rings, int ring_floats,
                                             float2 (*row_ml)[T], int grp, int gt, int row, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (grp > 0) {
#pragma unroll
    for (int i = 0; i < NF; ++i) rings[grp * ring_floats + i * GROUP + gt] = o[i];
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) row_ml[grp][row + 8 * r] = make_float2(m[r], l[r]);
    }
  }
  __syncthreads();
  if (grp > 0) return;
  float f[NG][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int p = 1; p < NG; ++p) mx = fmaxf(mx, row_ml[p][row + 8 * r].x);  // finite: group 0 has a tile
    f[0][r] = ex2(m[r] - mx);
    float sum = l[r] * f[0][r];
#pragma unroll
    for (int p = 1; p < NG; ++p) {
      const float2 peer = row_ml[p][row + 8 * r];
      f[p][r] = ex2(peer.x - mx);  // 0 for a group with no tile (m = -inf)
      sum += peer.y * f[p][r];
    }
    m[r] = mx;
    l[r] = sum;
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    float acc = o[i] * f[0][(i >> 1) & 1];
#pragma unroll
    for (int p = 1; p < NG; ++p) acc += rings[p * ring_floats + i * GROUP + gt] * f[p][(i >> 1) & 1];
    o[i] = acc;
  }
}

// Group 0's epilogue: O / l in bf16 (rows r0, r0 + 8 of the C layout)
// and, with LSE, the rows' log-sum-exp in natural units.
template <int DH, bool LSE>
__device__ __forceinline__ void write_rows(__nv_bfloat16* out, float* lse, float* o, const float* m,
                                           const float* l, bool dead, int b, int N, int H, int h, int r0, int t) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = 1.f / l[r];
    if (LSE && t == 0 && r0 + 8 * r < N)
      lse[((int64_t)b * H + h) * N + r0 + 8 * r] = dead ? logf(l[r]) : m[r] * LN2 + logf(l[r]);
  }
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] *= inv[(i >> 1) & 1];
  store_rows<DH>(out, b, N, H, h, r0, t, reinterpret_cast<const float(*)[4]>(o));
}

#define ATTENTION_KERNEL_ARGS                                                                             \
  const __nv_bfloat16 *__restrict__ q, int64_t q_bs, int64_t q_rs, const __nv_bfloat16 *__restrict__ k, \
      int64_t k_bs, int64_t k_rs, const __nv_bfloat16 *__restrict__ v, int64_t v_bs, int64_t v_rs,       \
      const uint8_t *__restrict__ mask, __nv_bfloat16 *__restrict__ out, float *__restrict__ lse, int N,  \
      int M, int H, float scale

// ------------------------------------------------------------------ bf16, dh = 64: wgmma

template <int NG>
__host__ __device__ constexpr int wg_smem_bytes() { return 1024 + (1 + NG * STAGES * 2) * WG_TILE_BYTES; }

template <int NG, bool LSE>
__global__ void __launch_bounds__(NG * GROUP, 2)  // two blocks an SM
attention_wg(ATTENTION_KERNEL_ARGS) {
  constexpr int DH = 64, RING = STAGES * 2 * WG_TILE_BYTES;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 row_ml[NG][T];
  unsigned char* own_q = align_1024(smem);                      // A of S = Q K^T
  unsigned char* rings = own_q + WG_TILE_BYTES;                 // per group and stage: K, V tiles
  float2* keys = reinterpret_cast<float2*>(rings + NG * RING);  // [ntiles * T]

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, grp = warp / 4, gt = tid % GROUP;
  const int wr = (warp % 4) * 16, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * T;
  const int ntiles = (M + T - 1) / T;       // key tiles; group grp takes grp, grp + NG, ...
  const int cnt = grp < ntiles ? (ntiles - grp + NG - 1) / NG : 0;
  const __nv_bfloat16* k_b = k + b * k_bs + h * DH;
  const __nv_bfloat16* v_b = v + b * v_bs + h * DH;
  unsigned char* ring = rings + grp * RING;

  // K and V of the group's `it`-th key tile into its stage
  auto stage = [&](int it) {
    unsigned char* dst = ring + (it % STAGES) * 2 * WG_TILE_BYTES;
    const int j0 = (grp + it * NG) * T;
    stage_swizzled<GROUP>(dst, k_b, k_rs, j0, M, gt);
    stage_swizzled<GROUP>(dst + WG_TILE_BYTES, v_b, v_rs, j0, M, gt);
  };

  stage_swizzled<NG * GROUP>(own_q, q + b * q_bs + h * DH, q_rs, q0, N, tid);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < cnt) stage(s);
    cp_async_commit();
  }
  const bool dead = stage_key_table(keys, mask, b, M, ntiles, scale * LOG2E);
  cp_async_wait<STAGES - 1>();  // Q has landed
  fence_async_smem();
  __syncthreads();
  const uint64_t qa = wg_desc(smem_addr(own_q));

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows wr + g, wr + g + 8
  for (int it = 0; it < cnt; ++it) {
    cp_async_wait<STAGES - 2>();  // tile `it` has landed
    fence_async_smem();
    group_sync(grp);              // for the whole group; and tile it - 1's stage is free
    if (it + STAGES - 1 < cnt) stage(it + STAGES - 1);
    cp_async_commit();
    const uint64_t ks = wg_desc(smem_addr(ring + (it % STAGES) * 2 * WG_TILE_BYTES));
    const uint64_t vs = ks + (WG_TILE_BYTES >> 4);
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(s, qa + 2 * kk, ks + 2 * kk, kk > 0);  // S = Q K^T
    wg_commit();
    wg_wait<0>(s);
    float corr[2];
    online_softmax(s, m, l, corr, keys + (grp + it * NG) * T + 2 * t);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
    uint32_t pa[4][4];
    wg_c_to_a(pa, s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) wgmma_rs(o, pa[kk], vs + 128 * kk);  // O += P V
    wg_commit();
    wg_wait<0>(o);
  }
  cp_async_wait<0>();
  group_sync(grp);  // the ring is read no more: it becomes scratch

  merge_groups<NG, 32>(o, m, l, reinterpret_cast<float*>(rings), RING / 4, row_ml, grp, gt, wr + g, t);
  if (grp == 0) write_rows<DH, LSE>(out, lse, o, m, l, dead, b, N, H, h, q0 + wr + g, t);
}

// ------------------------------------------------------------------ bf16, dh <= 32: mma.sync

template <int DH, int NG>
__host__ __device__ constexpr int mma_smem_bytes() { return (1 + NG * STAGES * 2) * tile_elems<DH>() * 2; }

template <int DH, int NG, bool LSE>
__global__ void __launch_bounds__(NG * GROUP)
attention_mma(ATTENTION_KERNEL_ARGS) {
  constexpr int LD = DH + PAD, KS = DH / 16, DT = DH / 8, TILE = tile_elems<DH>(), RING = STAGES * 2 * TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 row_ml[NG][T];
  __nv_bfloat16* own_q = reinterpret_cast<__nv_bfloat16*>(smem);  // A of S = Q K^T
  __nv_bfloat16* rings = own_q + TILE;                            // per group and stage: K, V tiles
  float2* keys = reinterpret_cast<float2*>(rings + NG * RING);    // [ntiles * T]

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, grp = warp / 4, gt = tid % GROUP;
  const int wr = (warp % 4) * 16, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * T;
  const int ntiles = (M + T - 1) / T;
  const int cnt = grp < ntiles ? (ntiles - grp + NG - 1) / NG : 0;
  const __nv_bfloat16* k_b = k + b * k_bs + h * DH;
  const __nv_bfloat16* v_b = v + b * v_bs + h * DH;
  __nv_bfloat16* ring = rings + grp * RING;

  auto stage = [&](int it) {
    __nv_bfloat16* dst = ring + (it % STAGES) * 2 * TILE;
    const int j0 = (grp + it * NG) * T;
    stage_tile<DH, GROUP>(dst, k_b, k_rs, j0, M, gt);
    stage_tile<DH, GROUP>(dst + TILE, v_b, v_rs, j0, M, gt);
  };

  stage_tile<DH, NG * GROUP>(own_q, q + b * q_bs + h * DH, q_rs, q0, N, tid);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < cnt) stage(s);
    cp_async_commit();
  }
  const bool dead = stage_key_table(keys, mask, b, M, ntiles, scale * LOG2E);
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  uint32_t qa[KS][4];
  load_a<DH>(qa, own_q, wr, lane);
  const uint32_t lane_nt = nt_lane_offset<DH>(lane), lane_tn = tn_lane_offset<DH>(lane);

  float o[DT][4];
  zero<DT>(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < cnt; ++it) {
    cp_async_wait<STAGES - 2>();
    group_sync(grp);
    if (it + STAGES - 1 < cnt) stage(it + STAGES - 1);
    cp_async_commit();
    const uint32_t ks = smem_addr(ring + (it % STAGES) * 2 * TILE), vs = ks + TILE * 2;
    // S = Q K^T, 16 keys at a time; C layout: s[n][0..1] row g, s[n][2..3] row g + 8,
    // keys 8n + 2t + {0, 1}
    float s[8][4];
    zero<8>(s);
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) mma_nt<DH>(s + 2 * kk, qa, ks + kk * 16 * LD * 2 + lane_nt);
    float corr[2];
    online_softmax(&s[0][0], m, l, corr, keys + (grp + it * NG) * T + 2 * t);
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {  // O += P V, P's C layout reused as A fragments
      uint32_t pa[4];
      c_to_a(pa, s + 2 * kk);
      mma_tn<DH>(o, pa, vs + kk * 16 * LD * 2 + lane_tn);
    }
  }
  cp_async_wait<0>();
  group_sync(grp);

  merge_groups<NG, DT * 4>(&o[0][0], m, l, reinterpret_cast<float*>(rings), RING / 2, row_ml, grp, gt, wr + g,
                           t);
  if (grp == 0) write_rows<DH, LSE>(out, lse, &o[0][0], m, l, dead, b, N, H, h, q0 + wr + g, t);
}

// ------------------------------------------------------------------ bf16, heads wider than 128: chunks

// A block of the chunked kernels owns 64 queries of one (b, head) and one
// 128-value chunk c of the output (blockIdx.y = head * C + c); its ring
// slots hold two padded 64 x 128 tiles.
constexpr int CW = 128;
constexpr int CHUNK_TILE = tile_elems<CW>();
constexpr int CHUNK_SLOT_BYTES = 2 * CHUNK_TILE * 2;

// softmax(Q K^T scale) V_c of the block's 64 queries for a head of C
// chunks. Per key tile, C steps S += Q_c' K_c'^T (Q_c' and K_c' staged
// together in a slot, Q's A fragments read from it), then one step with V_c
// alone: the online softmax and O += P V_c as `attention_mma`'s.
template <bool LSE>
__global__ void __launch_bounds__(GROUP)
attention_chunked(ATTENTION_KERNEL_ARGS, int C) {
  constexpr int LD = CW + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* slots = reinterpret_cast<__nv_bfloat16*>(smem);           // STAGES x (A, B tiles)
  float2* keys = reinterpret_cast<float2*>(smem + STAGES * CHUNK_SLOT_BYTES);  // [ntiles * T]

  const int b = blockIdx.z, h = blockIdx.y / C, c = blockIdx.y % C, tid = threadIdx.x;
  const int lane = tid % 32, wr = (tid / 32) * 16, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * T, DH = C * CW;
  const int ntiles = (M + T - 1) / T, steps = ntiles * (C + 1);
  const __nv_bfloat16* q_h = q + b * q_bs + h * DH;
  const __nv_bfloat16* k_h = k + b * k_bs + h * DH;
  const __nv_bfloat16* v_c = v + b * v_bs + h * DH + c * CW;

  // step u of key tile u / (C + 1): Q and K of chunk u % (C + 1), the last V_c
  auto stage = [&](int u) {
    __nv_bfloat16* slot = slots + (u % STAGES) * 2 * CHUNK_TILE;
    const int j0 = u / (C + 1) * T, sub = u % (C + 1);
    if (sub < C) {
      stage_tile<CW, GROUP>(slot, q_h + sub * CW, q_rs, q0, N, tid);
      stage_tile<CW, GROUP>(slot + CHUNK_TILE, k_h + sub * CW, k_rs, j0, M, tid);
    } else {
      stage_tile<CW, GROUP>(slot, v_c, v_rs, j0, M, tid);
    }
  };

  stage(0);
  cp_async_commit();
  const bool dead = stage_key_table(keys, mask, b, M, ntiles, scale * LOG2E);
  const uint32_t lane_nt = nt_lane_offset<CW>(lane), lane_tn = tn_lane_offset<CW>(lane);
  float o[CW / 8][4], s[8][4];
  zero<CW / 8>(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int u = 0; u < steps; ++u) {
    cp_async_wait<0>();
    __syncthreads();  // step u's tiles have landed; step u - 1's slot is read no more
    if (u + 1 < steps) stage(u + 1);
    cp_async_commit();
    const __nv_bfloat16* slot = slots + (u % STAGES) * 2 * CHUNK_TILE;
    const int sub = u % (C + 1);
    if (sub < C) {
      if (sub == 0) zero<8>(s);
      mma_nt_tile<CW>(s, a_lane_addr<CW>(slot, wr, lane), smem_addr(slot + CHUNK_TILE) + lane_nt);  // S += Q K^T
      continue;
    }
    float corr[2];
    online_softmax(&s[0][0], m, l, corr, keys + u / (C + 1) * T + 2 * t);
#pragma unroll
    for (int n = 0; n < CW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    const uint32_t vs = smem_addr(slot) + lane_tn;
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {  // O += P V_c, P's C layout reused as A fragments
      uint32_t pa[4];
      c_to_a(pa, s + 2 * kk);
      mma_tn<CW>(o, pa, vs + kk * 16 * LD * 2);
    }
  }
  cp_async_wait<0>();

  // the rows' sums over their 4 threads, O / l, and (chunk 0) the LSE
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + wr + g + 8 * r;
    if (LSE && c == 0 && t == 0 && row < N)
      lse[((int64_t)b * H + h) * N + row] = dead ? logf(l[r]) : m[r] * LN2 + logf(l[r]);
    const float inv = 1.f / l[r];
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) {
      o[n][2 * r] *= inv;
      o[n][2 * r + 1] *= inv;
    }
  }
  store_rows<CW>(out, b, N, H * C, h * C + c, q0 + wr + g, t, o);  // chunk c of head h: "head" h C + c of 128
}

// ------------------------------------------------------------------ bf16, heads of 128 and 256: wgmma fed by TMA

// A head of DH values is DH / 64 panels of 64 values in the 128-byte
// swizzle: 64 rows of it make one tile, a panel `WIDE_PANEL` on in a
// descriptor.
constexpr int WIDE = 256;
constexpr int WIDE_PANEL = WG_TILE_BYTES >> 4;

template <int DH>
__host__ __device__ constexpr int wide_tile() { return DH / 64 * WG_TILE_BYTES; }

// Key tiles in a ring: two slots (three and four ran slower at 128, and
// more would not let two blocks share an SM at 256).
constexpr int WIDE_SLOTS = 2;

// At 128 a warp of its own copies K and V: thread 0 of a warpgroup, waiting
// there for every warp to release a slot, held the warpgroup's products
// back (1.5x the time). At 256 its registers would spill O.
template <int DH>
__host__ __device__ constexpr bool wide_producer() { return DH == 128; }

template <int DH>
__host__ __device__ constexpr int wide_threads() { return GROUP + (wide_producer<DH>() ? 32 : 0); }

// The Q tile, the ring and a bit a key, 1024-byte aligned.
template <int DH>
__host__ __device__ constexpr int wide_smem_bytes(int key_tiles) {
  return 1024 + (1 + WIDE_SLOTS) * wide_tile<DH>() + 8 * key_tiles;
}

// The wgmma accumulators `d` as written here: after a wait, no read of
// them moves above it.
template <int NF>
__device__ __forceinline__ void wg_hold(float* d) {
#pragma unroll
  for (int i = 0; i < NF; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// softmax(Q K^T scale) V for 64 queries of one (b, head) of DH = 128 or 256
// values, by one warpgroup holding the whole head of its rows: Q staged
// once, S = Q K_j^T (wgmma_ss, DH / 16 k-steps over the panels) once a key
// tile, the online softmax on wgmma's C layout, O (64 x DH f32, DH / 2
// registers a thread) += P V_j with P from registers (wgmma_rs, a panel
// each a k-step). Q, then K_0, V_0, K_1, ... come through a ring of
// `WIDE_SLOTS` slots, each slot refilled once every warp has released it
// (an mbarrier each for "landed" and "released"), copied by the copying
// warp (`wide_producer`) or else by thread 0. The warpgroup queues S of the
// next tile behind O += P V of this one, so the tensor cores run both while
// it waits once.
template <int DH, bool LSE>
__global__ void __launch_bounds__(wide_threads<DH>(), 2)
attention_wide(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const uint8_t* __restrict__ mask,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int N, int M, int H, float scale) {
  constexpr int R = WIDE_SLOTS, P = DH / 64, TILE = wide_tile<DH>();
  constexpr bool PW = wide_producer<DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[R], empty[R], q_full;
  unsigned char* own_q = align_1024(smem);  // Q's tile
  unsigned char* ring = own_q + TILE;       // load u (K_{u/2}, or V_{u/2} for odd u) in slot u % R
  uint32_t* key_bits = reinterpret_cast<uint32_t*>(ring + R * TILE);  // a bit a key: valid

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int q0 = blockIdx.x * T, ntiles = (M + T - 1) / T, loads = 2 * ntiles;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      mbar_init(&full[i]);
      mbar_init(&empty[i], 4);  // every warp of the warpgroup
    }
    mbar_init(&q_full);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int next = 0;  // the copying thread: the next load to issue
  // the copying thread: loads next .. upto - 1, each once every warp has released its slot
  auto issue = [&](int upto) {
    for (; next < upto && next < loads; ++next) {
      if (next >= R) mbar_wait(&empty[next % R], (next / R - 1) & 1);
      uint64_t* bar = &full[next % R];
      mbar_expect(bar, TILE);
      load_panels<P>(ring + (next % R) * TILE, next % 2 ? &map_v : &map_k, h * DH, next / 2 * T, b, bar);
    }
  };
  const bool copies = tid == (PW ? GROUP : 0);
  if (copies) {  // Q, and the ring's first loads
    mbar_expect(&q_full, TILE);
    load_panels<P>(own_q, &map_q, h * DH, q0, b, &q_full);
    issue(R);
  }
  int any = 0;  // the batch element's valid keys, 0 past M, by every warp
  for (int base = tid / 32 * 32; base < ntiles * T; base += blockDim.x) {
    const int key = base + tid % 32;
    const bool valid = key < M && (mask == nullptr || mask[(int64_t)b * M + key]);
    const uint32_t word = __ballot_sync(0xffffffffu, valid);
    if (tid % 32 == 0) key_bits[base / 32] = word;
    any |= valid;
  }
  const bool dead = !__syncthreads_or(any);
  if (PW && tid >= GROUP) {  // the copying warp: the rest of the loads
    if (copies) issue(loads);
    return;
  }

  const int lane = tid % 32, wr = (tid / 32) * 16, g = lane / 4, t = lane % 4;
  const uint64_t qa = wg_desc(smem_addr(own_q)), ring_desc = wg_desc(smem_addr(ring));
  const float scale2 = scale * LOG2E;
  auto slot = [&](int u) { return ring_desc + (u % R) * (TILE >> 4); };
  auto landed = [&](int u) { mbar_wait(&full[u % R], (u / R) & 1); };
  auto release = [&](int u) {
    if (lane == 0) mbar_arrive(&empty[u % R]);
  };
  auto scores = [&](float* s, int j) {  // S = Q K_j^T, committed
    const uint64_t kd = slot(2 * j);
    wg_hold<32>(s);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const int step = (ks / 4) * WIDE_PANEL + 2 * (ks % 4);
      wgmma_ss(s, qa + step, kd + step, ks > 0);
    }
    wg_commit();
  };

  float o[P][32];  // panel p of the output in wgmma's C layout
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  wg_hold<DH / 2>(&o[0][0]);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, s[32];  // rows wr + g, wr + g + 8
  mbar_wait(&q_full, 0);
  landed(0);
  scores(s, 0);
  wg_wait<0>(s);
  // Each tile: S_j has landed (and O += P_{j-1} V_{j-1}); no product is in
  // flight across the loop's back edge, so the accumulators keep their
  // registers and the products their pipeline.
  for (int j = 0; j < ntiles; ++j) {
    release(2 * j);
    if (j > 0) release(2 * j - 1);
    if (!PW && copies) issue(2 * j + R + 1);  // V_j and K_{j+1}, into the slots just released
    // logits in log2 units: valid keys scaled, masked ones -1e9, those past M -inf
    const uint64_t bits = *reinterpret_cast<const uint64_t*>(key_bits + 2 * j) >> (2 * t);
    const int lim = M - j * T - 2 * t;  // this thread's keys 8n + e from lim on are past M
    float corr[2];
    online_softmax_by(s, m, l, corr, [&](float* x, int n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = (bits >> (8 * n + e)) & 1u;
        const float off = 8 * n + e < lim ? MASKED * LOG2E : -INFINITY;
        x[e] = valid ? x[e] * scale2 : off;
        x[2 + e] = valid ? x[2 + e] * scale2 : off;
      }
    });
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= corr[(i >> 1) & 1];
    uint32_t pa[4][4];
    wg_c_to_a(pa, s);
    landed(2 * j + 1);
    const uint64_t vd = slot(2 * j + 1);
    wg_hold<DH / 2>(&o[0][0]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk)
#pragma unroll
      for (int p = 0; p < P; ++p) wgmma_rs(o[p], pa[kk], vd + p * WIDE_PANEL + 128 * kk);  // O += P V_j
    wg_commit();
    if (j + 1 < ntiles) {  // S_{j+1} queued behind O += P V_j
      landed(2 * j + 2);
      scores(s, j + 1);
    }
    wg_wait<0>(s);
    wg_hold<DH / 2>(&o[0][0]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the rows' sums over their 4 threads
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  write_rows<DH, LSE>(out, lse, &o[0][0], m, l, dead, b, N, H, h, q0 + wr + g, t);
}

// ------------------------------------------------------------------ f32: register-tiled FFMA

// Groups of 8 warps that split a block's key tiles: two (16 warps, one
// block an SM at 128 registers a thread), 6-12% faster than one at every
// timed shape on the card (PERF.md); one at dh = 128, whose two groups'
// rings would not fit.
template <int DH>
__host__ __device__ constexpr int ffma_groups() { return DH > 64 ? 1 : 2; }

// A group's floats: its ring of K and V tiles, then its P tile.
template <int DH>
__host__ __device__ constexpr int ffma_group_floats() { return STAGES * 2 * T * f32_ld<DH>() + T * XLD; }

template <int DH, int NG>
__host__ __device__ constexpr int ffma_smem_bytes() { return (T * f32_ld<DH>() + NG * ffma_group_floats<DH>()) * 4; }

// 2^d, exactly, for d <= 0 an integer-valued float (a difference of two
// row shifts), built from its exponent bits; 0 below 2^-126 and for
// d = -inf (a row with no tile yet, or a group with none): what it would
// rescale lies below the f32 resolution of the sums it joins.
__device__ __forceinline__ float pow2(float d) {
  return d < -126.f ? 0.f : __int_as_float((static_cast<int>(d) + 127) << 23);
}

// softmax(Q K^T scale) V of the block's 64 queries, in f32 on plain FMAs.
// Per key tile of a group: S (64 queries x 64 keys) as 4 x 4 register tiles
// (`nt_product`: queries L.own + 8i, keys L.loop + 4j), turned into logits
// x by each key's state (selects, no branch); the rows' tile max from the
// 16 threads that share a row (2 shuffles, then the 4 warps of a row
// through `part`); each row's shift m, an integer at or above its max in
// log2 units, so that every rescale below is an exact power of two (the
// running sums and O pick up no rounding from it, and the LSE, m ln 2 +
// log l, is taken in double); P = 2^(x log2 e - m) through shared memory
// as P[key][query] (`store_x`); the tile's P^T-layout . V (`tn_product`:
// queries R.own .. + 3, dims R.dim .. + 3) summed in registers of its own,
// then O = O corr + that: chains over one tile's keys, then over the
// tiles, not one over all keys, which lands closer to a float64 run
// (PERF.md). Each thread keeps its own partial row sums, rescaled with the
// row, and adds them up once at the end. O += P V gives every thread 4
// queries x OW dims (OW = 4, 8 at dh = 128): at dh < 64 the group's
// threads split the tile's keys into T / dh runs, whose partial sums are
// added at the end.
template <int DH, int NG, bool LSE>
__global__ void __launch_bounds__(NG * FG, 1)
attention_ffma(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
               const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
               const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
               const uint8_t* __restrict__ mask, float* __restrict__ out,
               float* __restrict__ lse, int N, int M, int H, float scale) {
  constexpr int LD = f32_ld<DH>(), TILE = T * LD, GROUP_F = ffma_group_floats<DH>();
  constexpr int OW = DH > 64 ? DH / 16 : 4;  // O's dims a thread
  constexpr int KS = DH > 64 ? 1 : T / DH, TPS = FG / KS, KR = T / KS;  // O's key splits, their threads and keys
  __shared__ float part[NG][4][T];  // a group's rows' partial max (per tile), then sums, per key quarter
  __shared__ __align__(16) float row_corr[NG][T];  // the rows' rescale factor of a tile
  __shared__ float row_m[NG][T];                   // the rows' final shifts
  extern __shared__ __align__(16) float fsm[];
  float* own_q = fsm;
  float* rings = own_q + TILE;
  const int tid = threadIdx.x, grp = tid / FG, gt = tid % FG;
  float* ring = rings + grp * GROUP_F;
  float* xp = ring + STAGES * 2 * TILE;  // P[key][query]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * T;
  const int ntiles = (M + T - 1) / T;  // key tiles; group grp takes grp, grp + NG, ...
  const int cnt = grp < ntiles ? (ntiles - grp + NG - 1) / NG : 0;
  const float* k_b = k + b * k_bs + h * DH;
  const float* v_b = v + b * v_bs + h * DH;

  // K and V of the group's `it`-th key tile into its stage; rows past M are zeros
  auto stage = [&](int it) {
    float* s = ring + (it % STAGES) * 2 * TILE;
    const int j0 = (grp + it * NG) * T;
    stage_f32<DH, FG>(s, k_b, k_rs, j0, M, gt);
    stage_f32<DH, FG>(s + TILE, v_b, v_rs, j0, M, gt);
  };

  stage_f32<DH, NG * FG>(own_q, q + b * q_bs + h * DH, q_rs, q0, N, tid);
  cp_async_commit();
  if (cnt > 0) stage(0);
  cp_async_commit();
  bool dead = false;
  if constexpr (LSE) dead = dead_batch(mask, b, M);

  const NtLane L = nt_lane(gt);
  const int split = gt / TPS;
  const TnLane R = tn_lane<DH, OW>(gt % TPS);
  const int lane = gt % 32, wq = gt / 64;  // a row's threads: lanes 8 apart, warps 2 apart (key quarter wq)
  float m[4], l[4];  // rows L.own + 8i: shift (integer, log2 units); this thread's partial sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float acc[4][OW];  // O of rows R.own + i, dims R.dim + e, over the split's keys
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < OW; ++e) acc[i][e] = 0.f;

  cp_async_wait<0>();  // Q (and the first key tile) have landed
  __syncthreads();
  for (int it = 0; it < cnt; ++it) {
    cp_async_wait<0>();  // tile it has landed; the group is done with tile it - 1
    ffma_group_sync(grp);
    if (it + 1 < cnt) stage(it + 1);
    cp_async_commit();
    const float* ks = ring + (it % STAGES) * 2 * TILE;
    // the keys' states, two bits each (valid; in range), the mask bytes asked
    // for ahead of the product
    const int key0 = (grp + it * NG) * T + L.loop;
    uint32_t state = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + 4 * j;
      const bool valid = key < M && (mask == nullptr || mask[(int64_t)b * M + key]);
      state |= (valid ? 1u << j : 0u) | (key < M ? 16u << j : 0u);
    }
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    nt_product<DH>(s, own_q + L.own * LD, ks + L.loop * LD);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // the logit: s scale, -1e9 masked, -inf past M
        s[i][j] = state & (1u << j) ? s[i][j] * scale : (state & (16u << j) ? MASKED : -INFINITY);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      if (lane < 8) part[grp][wq][L.own + 8 * i] = mx;
    }
    ffma_group_sync(grp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = L.own + 8 * i;
      // finite: key 0 of a tile is in range
      const float mx = fmaxf(fmaxf(part[grp][0][row], part[grp][1][row]), fmaxf(part[grp][2][row], part[grp][3][row]));
      const float m_new = fmaxf(m[i], ceilf(mx * LOG2E));
      const float corr = pow2(m[i] - m_new);  // 0 at the first tile (m = -inf)
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ex2(fmaf(s[i][j], LOG2E, -m_new));
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;
      if (wq == 0 && lane < 8) row_corr[grp][row] = corr;
    }
    store_x(xp, s, L);
    ffma_group_sync(grp);
    const float4 c4 = *reinterpret_cast<const float4*>(&row_corr[grp][R.own]);
    const float corr[4] = {c4.x, c4.y, c4.z, c4.w};
    float tile[4][OW];  // the tile's own sums, then added to O's: two short chains for one long one
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < OW; ++e) tile[i][e] = 0.f;
    tn_product<DH, OW, KR>(tile, xp + split * KR * XLD + R.own, ks + TILE + split * KR * LD + R.dim);  // P V
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < OW; ++e) acc[i][e] = fmaf(acc[i][e], corr[i], tile[i][e]);
  }
  cp_async_wait<0>();

  // each row's sum over its 16 threads (lanes, then key quarters), and the
  // groups' (m, l, O) merged in the groups' order: m* = max m_g, O and l
  // each rescaled by 2^(m_g - m*) (exact), O's key splits added in their order
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 8);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 16);
    if (lane < 8) part[grp][wq][L.own + 8 * i] = l[i];  // the group's last tile read part before its last barrier
    if (wq == 0 && lane < 8) row_m[grp][L.own + 8 * i] = m[i];
  }
  __syncthreads();  // and the rings are read no more: they hold the partial sums of O
  float m_row[4], l_row[4];  // the merged rows R.own + i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = R.own + i;
    float mx = row_m[0][row];  // finite: group 0 has a tile
#pragma unroll
    for (int g = 1; g < NG; ++g) mx = fmaxf(mx, row_m[g][row]);
    const float own = pow2(row_m[grp][row] - mx);  // 0 for a group with no tile (m = -inf)
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      sum += ((part[g][0][row] + part[g][1][row]) + (part[g][2][row] + part[g][3][row])) * pow2(row_m[g][row] - mx);
    m_row[i] = mx;
    l_row[i] = sum;
#pragma unroll
    for (int e = 0; e < OW; ++e) rings[((grp * KS + split) * 4 * OW + OW * i + e) * TPS + gt % TPS] = acc[i][e] * own;
  }
  __syncthreads();
  if (gt >= TPS || grp > 0) return;  // group 0's first split: the block's output
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l_row[i];
#pragma unroll
    for (int e = 0; e < OW; ++e) {
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < NG * KS; ++p) sum += rings[(p * 4 * OW + OW * i + e) * TPS + gt];
      acc[i][e] = sum * inv;
    }
  }
  if constexpr (LSE) {  // the threads of the first 4 dim groups take one of their rows each: one log a lane
    const int i = R.dim / OW;
    float m_i = m_row[0], l_i = l_row[0];
#pragma unroll
    for (int r = 1; r < 4; ++r) {
      m_i = i == r ? m_row[r] : m_i;
      l_i = i == r ? l_row[r] : l_i;
    }
    if (i < 4 && q0 + R.own + i < N)
      lse[((int64_t)b * H + h) * N + q0 + R.own + i] =
          dead ? static_cast<float>(log(static_cast<double>(M)))
               : static_cast<float>(m_i * LN2_D + log(static_cast<double>(l_i)));
  }
  store_out<OW>(out + (int64_t)b * N * H * DH + h * DH, q0, N, (int64_t)H * DH, acc, R);
}

// f32, heads wider than 128: a block (one group of 8 warps) owns 64 queries
// of one (b, head) and one 128-value chunk c of the output. Its ring slots
// hold two 64 x 128 f32 tiles: per key tile, C steps S += Q_c' K_c'^T
// (`nt_product` over each chunk in turn), then one step with V_c alone:
// `attention_ffma`'s softmax of a tile (one group) and O += P V_c.
constexpr int CHUNK_F32_TILE = T * f32_ld<CW>();  // floats

__host__ __device__ constexpr int ffma_chunked_smem_bytes() { return (STAGES * 2 * CHUNK_F32_TILE + T * XLD) * 4; }

template <bool LSE>
__global__ void __launch_bounds__(FG, 1)
attention_ffma_chunked(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
                       const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
                       const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
                       const uint8_t* __restrict__ mask, float* __restrict__ out,
                       float* __restrict__ lse, int N, int M, int H, float scale, int C) {
  constexpr int LD = f32_ld<CW>(), OW = CW / 16;
  __shared__ float part[4][T];                // the rows' partial max (per tile), then sums, per key quarter
  __shared__ __align__(16) float row_corr[T];  // the rows' rescale factor of a tile
  __shared__ float row_m[T];                   // the rows' final shifts
  extern __shared__ __align__(16) float fsm[];
  float* xp = fsm + STAGES * 2 * CHUNK_F32_TILE;  // P[key][query]
  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y / C, c = blockIdx.y % C, q0 = blockIdx.x * T, DH = C * CW;
  const int ntiles = (M + T - 1) / T, steps = ntiles * (C + 1);
  const float* q_h = q + b * q_bs + h * DH;
  const float* k_h = k + b * k_bs + h * DH;
  const float* v_c = v + b * v_bs + h * DH + c * CW;

  // step u of key tile u / (C + 1): Q and K of chunk u % (C + 1), the last V_c
  auto stage = [&](int u) {
    float* slot = fsm + (u % STAGES) * 2 * CHUNK_F32_TILE;
    const int j0 = u / (C + 1) * T, sub = u % (C + 1);
    if (sub < C) {
      stage_f32<CW, FG>(slot, q_h + sub * CW, q_rs, q0, N, tid);
      stage_f32<CW, FG>(slot + CHUNK_F32_TILE, k_h + sub * CW, k_rs, j0, M, tid);
    } else {
      stage_f32<CW, FG>(slot, v_c, v_rs, j0, M, tid);
    }
  };

  stage(0);
  cp_async_commit();
  bool dead = false;
  if constexpr (LSE) dead = dead_batch(mask, b, M);

  const NtLane L = nt_lane(tid);
  const TnLane R = tn_lane<CW, OW>(tid);
  const int lane = tid % 32, wq = tid / 64;  // a row's threads: lanes 8 apart, warps 2 apart (key quarter wq)
  float m[4], l[4], s[4][4], acc[4][OW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < OW; ++e) acc[i][e] = 0.f;
  }
  uint32_t state = 0;
  for (int u = 0; u < steps; ++u) {
    cp_async_wait<0>();
    __syncthreads();  // step u's tiles have landed; step u - 1's slot is read no more
    if (u + 1 < steps) stage(u + 1);
    cp_async_commit();
    const float* slot = fsm + (u % STAGES) * 2 * CHUNK_F32_TILE;
    const int sub = u % (C + 1);
    if (sub < C) {
      if (sub == 0) {
        // the keys' states, two bits each (valid; in range), asked for ahead of the products
        const int key0 = u / (C + 1) * T + L.loop;
        state = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = key0 + 4 * j;
          const bool valid = key < M && (mask == nullptr || mask[(int64_t)b * M + key]);
          state |= (valid ? 1u << j : 0u) | (key < M ? 16u << j : 0u);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      nt_product<CW>(s, slot + L.own * LD, slot + CHUNK_F32_TILE + L.loop * LD);  // S += Q K^T
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // the logit: s scale, -1e9 masked, -inf past M
        s[i][j] = state & (1u << j) ? s[i][j] * scale : (state & (16u << j) ? MASKED : -INFINITY);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      if (lane < 8) part[wq][L.own + 8 * i] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = L.own + 8 * i;
      // finite: key 0 of a tile is in range
      const float mx = fmaxf(fmaxf(part[0][row], part[1][row]), fmaxf(part[2][row], part[3][row]));
      const float m_new = fmaxf(m[i], ceilf(mx * LOG2E));
      const float corr = pow2(m[i] - m_new);  // 0 at the first tile (m = -inf)
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ex2(fmaf(s[i][j], LOG2E, -m_new));
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;
      if (wq == 0 && lane < 8) row_corr[row] = corr;
    }
    store_x(xp, s, L);
    __syncthreads();
    const float4 c4 = *reinterpret_cast<const float4*>(&row_corr[R.own]);
    const float corr[4] = {c4.x, c4.y, c4.z, c4.w};
    float tile[4][OW];  // the tile's own sums, then added to O's
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < OW; ++e) tile[i][e] = 0.f;
    tn_product<CW, OW>(tile, xp + R.own, slot + R.dim);  // P V_c
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < OW; ++e) acc[i][e] = fmaf(acc[i][e], corr[i], tile[i][e]);
  }
  cp_async_wait<0>();

  // each row's sum over its 16 threads (lanes, then key quarters); the last
  // tile read part before its last barrier
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 8);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 16);
    if (lane < 8) part[wq][L.own + 8 * i] = l[i];
    if (wq == 0 && lane < 8) row_m[L.own + 8 * i] = m[i];
  }
  __syncthreads();
  float m_row[4], l_row[4];  // rows R.own + i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = R.own + i;
    m_row[i] = row_m[row];
    l_row[i] = (part[0][row] + part[1][row]) + (part[2][row] + part[3][row]);
    const float inv = 1.f / l_row[i];
#pragma unroll
    for (int e = 0; e < OW; ++e) acc[i][e] *= inv;
  }
  if constexpr (LSE) {  // chunk 0: the threads of the first 4 dim groups take one of their rows each
    const int i = R.dim / OW;
    float m_i = m_row[0], l_i = l_row[0];
#pragma unroll
    for (int r = 1; r < 4; ++r) {
      m_i = i == r ? m_row[r] : m_i;
      l_i = i == r ? l_row[r] : l_i;
    }
    if (c == 0 && i < 4 && q0 + R.own + i < N)
      lse[((int64_t)b * H + h) * N + q0 + R.own + i] =
          dead ? static_cast<float>(log(static_cast<double>(M)))
               : static_cast<float>(m_i * LN2_D + log(static_cast<double>(l_i)));
  }
  store_out<OW>(out + (int64_t)b * N * H * DH + h * DH + c * CW, q0, N, (int64_t)H * DH, acc, R);
}

// ------------------------------------------------------------------ f32, heads of 256: 3xTF32 on mma.sync

// A block of `attention_wide_3xtf32`: 64 query rows of one (b, head) of 256
// values, two warpgroups; warp w owns rows 16 (w % 4) and the head's half
// w / 4 (128 values). Keys come in tiles of WF_KEYS through a ring of
// WF_SLOTS slots; every staged tile is kept as its two halves, rows of 132
// floats. 16 keys in 3 slots: 32 in 2 spilled (255 registers), and the
// two took as long (PERF.md).
constexpr int WF_KEYS = 16, WF_SLOTS = 3;
constexpr int WF_THREADS = 2 * GROUP;
constexpr int WF_LD = f32_ld<CW>();       // row pitch of a staged half, in floats
constexpr int WF_EP = WF_KEYS + 8;        // row pitch of an exchange tile: float2 stores on distinct banks
constexpr int WF_Q = 2 * T * WF_LD;       // Q's two halves
constexpr int WF_SLOT = 4 * WF_KEYS * WF_LD;  // a slot: K's two halves, then V's
constexpr int WF_EXCH = 4 * T * WF_EP;    // each half's partial S, for even and odd tiles
constexpr int WF_SMEM_BYTES = (WF_Q + WF_SLOTS * WF_SLOT + WF_EXCH) * 4;

// s[n] (the warp's 16 rows x the tile's keys 8n + wf_key(c), C layout) +=
// Q K^T over the warp's half: `q_addr` the lane's ldmatrix address in Q's
// half (matrix i of x4 is A fragment a_i of m16n8k8: rows g, g + 8,
// columns t, t + 4), `k_addr` the lane's in K's (two n-tiles' B fragments
// an x4, the lane's row the key of its column). Each k-step's three
// products summed from zero.
__device__ __forceinline__ void wf_scores(float (*s)[4], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll 4
  for (int ks = 0; ks < CW / 8; ++ks) {
    uint32_t a[4], ah[4], al[4];
    ldsm_x4(a, q_addr + ks * 32);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), ah[e], al[e]);
    uint32_t bf[WF_KEYS / 4], bh[WF_KEYS / 8][2], bl[WF_KEYS / 8][2];
#pragma unroll
    for (int np = 0; np < WF_KEYS / 16; ++np) ldsm_x4(bf + 4 * np, k_addr + np * 16 * WF_LD * 4 + ks * 32);
#pragma unroll
    for (int i = 0; i < WF_KEYS / 4; ++i) split_tf32(__uint_as_float(bf[i]), bh[i / 2][i % 2], bl[i / 2][i % 2]);
    mma_3xtf32_tiles<WF_KEYS / 8>(s, ah, al, bh, bl);
  }
}

// o[n] (the warp's 16 rows x its half's values 16c + n of column c, C
// layout: lane t holds values 32t .. 32t + 31) += P V over the tile's keys,
// P's split A fragments (ph, pl) from S's C layout: k-step kk takes keys 8
// kk + t and 8 kk + t + 4 (`wf_key`), so that `y` (V's half at row t,
// value 16g) gives each lane its four n-tiles' B fragments in one 16-byte
// load a row, on distinct banks (4t + 16g at a pitch of 132).
__device__ __forceinline__ void wf_values(float (*o)[4], const uint32_t (*ph)[4], const uint32_t (*pl)[4],
                                          const float* y) {
#pragma unroll
  for (int kk = 0; kk < WF_KEYS / 8; ++kk)
#pragma unroll
    for (int i = 0; i < CW / 32; ++i) {  // n-tiles 4i .. 4i + 3
      const float4 y0 = *reinterpret_cast<const float4*>(y + kk * 8 * WF_LD + 4 * i);
      const float4 y1 = *reinterpret_cast<const float4*>(y + (kk * 8 + 4) * WF_LD + 4 * i);
      const float b0[4] = {y0.x, y0.y, y0.z, y0.w}, b1[4] = {y1.x, y1.y, y1.z, y1.w};
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_tf32(b0[e], bh[e][0], bl[e][0]);
        split_tf32(b1[e], bh[e][1], bl[e][1]);
      }
      mma_3xtf32_tiles<4>(o + 4 * i, ph[kk], pl[kk], bh, bl);
    }
}

// softmax(Q K^T scale) V for 64 queries of one (b, head) of 256 values, in
// f32 with both products on the tensor cores as 3xTF32. Per key tile: warp
// w multiplies its rows' partial S over its half of the head; warps w and
// w ^ 4, which share rows, swap partials through shared memory behind a
// barrier of their own and add them (the same bits in both: f32 addition
// commutes), run the same online softmax (integer shifts in log2 units, as
// `attention_ffma`'s, so every rescale is exact), and each adds P V over
// its own half of the output. S is computed once a key tile.
template <bool LSE>
__global__ void __launch_bounds__(WF_THREADS, 1)
attention_wide_3xtf32(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
                      const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
                      const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
                      const uint8_t* __restrict__ mask, float* __restrict__ out,
                      float* __restrict__ lse, int N, int M, int H, float scale) {
  constexpr int KT = WF_KEYS, LD = WF_LD, NT = KT / 8, EP = WF_EP;
  extern __shared__ __align__(16) float fsm[];
  float* own_q = fsm;                           // Q's halves
  float* ring = own_q + WF_Q;                   // slots of K's and V's halves
  float* exch = ring + WF_SLOTS * WF_SLOT;      // each half's partial S, even and odd tiles

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * T, tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4, wr = 16 * (w % 4), hf = w / 4;
  const int ntiles = (M + KT - 1) / KT;
  const float* k_h = k + b * k_bs + h * WIDE;
  const float* v_h = v + b * v_bs + h * WIDE;

  // the warpgroup's halves of K and V of key tile j into its slot, rows past M zeros
  auto stage = [&](int j) {
    float* slot = ring + (j % WF_SLOTS) * WF_SLOT;
    stage_f32<CW, GROUP, KT>(slot + hf * KT * LD, k_h + hf * CW, k_rs, j * KT, M, tid % GROUP);
    stage_f32<CW, GROUP, KT>(slot + (2 + hf) * KT * LD, v_h + hf * CW, v_rs, j * KT, M, tid % GROUP);
  };
  stage_f32<CW, GROUP>(own_q + hf * T * LD, q + b * q_bs + h * WIDE + hf * CW, q_rs, q0, N, tid % GROUP);
#pragma unroll
  for (int j = 0; j < WF_SLOTS - 1; ++j) {
    if (j < ntiles) stage(j);
    cp_async_commit();
  }
  bool dead = false;
  if constexpr (LSE) dead = dead_batch(mask, b, M);

  const uint32_t q_addr =
      smem_addr(own_q + hf * T * LD) + ((wr + lane % 8 + 8 * ((lane / 8) % 2)) * LD + 4 * (lane / 16)) * 4;
  // the lane's row of K: the key of column lane % 8 of n-tile lane / 16 (of a pair)
  const uint32_t k_lane = ((hf * KT + 8 * (lane / 16) + wf_key(lane % 8)) * LD + 4 * ((lane / 8) % 2)) * 4;
  float o[CW / 8][4];
  zero<CW / 8>(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows wr + g, + 8: shift (log2 units); partial sums
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<WF_SLOTS - 2>();  // tile j has landed
    // for the warpgroup, which alone reads its halves; and its tile j - 1 is read no more
    asm volatile("bar.sync %0, %1;\n" :: "r"(5 + hf), "n"(GROUP) : "memory");
    if (j + WF_SLOTS - 1 < ntiles) stage(j + WF_SLOTS - 1);
    cp_async_commit();
    const float* slot = ring + (j % WF_SLOTS) * WF_SLOT;
    // this lane's keys 8n + wf_key(2t + e): valid (bit 2n + e), in range (bit 16 + 2n + e),
    // the mask bytes asked for ahead of the product
    uint32_t state = 0;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * KT + 8 * n + wf_key(2 * t + e);
        const bool valid = key < M && (mask == nullptr || mask[(int64_t)b * M + key]);
        state |= (valid ? 1u : 0u) << (2 * n + e) | (key < M ? 1u : 0u) << (16 + 2 * n + e);
      }
    float s[NT][4];
    zero<NT>(s);
    wf_scores(s, q_addr, smem_addr(slot) + k_lane);
    // partial S swapped with the partner through the buffers of tile j's parity, which
    // the partner read for tile j - 2 before the pair's barrier of tile j - 1
    float* mine = exch + ((j & 1) * 2 + hf) * T * EP + (wr + g) * EP + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(mine + 8 * n) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(mine + 8 * EP + 8 * n) = make_float2(s[n][2], s[n][3]);
    }
    asm volatile("bar.sync %0, 64;\n" :: "r"(1 + w % 4) : "memory");
    const float* other = mine + (1 - 2 * hf) * T * EP;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 top = *reinterpret_cast<const float2*>(other + 8 * n);
      const float2 bot = *reinterpret_cast<const float2*>(other + 8 * EP + 8 * n);
      s[n][0] += top.x;
      s[n][1] += top.y;
      s[n][2] += bot.x;
      s[n][3] += bot.y;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // the logit: s scale, -1e9 masked, -inf past M
        const int bit = 2 * n + (e & 1);
        s[n][e] = (state >> bit) & 1u ? s[n][e] * scale : ((state >> (16 + bit)) & 1u ? MASKED : -INFINITY);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the row's 4 lanes; finite: key 0 of a tile is in range
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], ceilf(mx[r] * LOG2E));
      corr[r] = pow2(m[r] - m_new);  // 0 at the first tile (m = -inf)
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2(fmaf(s[n][e], LOG2E, -m[e >> 1]));
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int n = 0; n < CW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    uint32_t ph[NT][4], pl[NT][4];  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4): C's 0, 2, 1, 3
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      split_tf32(s[kk][0], ph[kk][0], pl[kk][0]);
      split_tf32(s[kk][2], ph[kk][1], pl[kk][1]);
      split_tf32(s[kk][1], ph[kk][2], pl[kk][2]);
      split_tf32(s[kk][3], ph[kk][3], pl[kk][3]);
    }
    wf_values(o, ph, pl, slot + (2 + hf) * KT * LD + t * LD + 16 * g);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the rows' sums over their 4 lanes, in one order in both warps
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + wr + g + 8 * r;
    if (LSE && hf == 0 && t == 0 && row < N)
      lse[((int64_t)b * H + h) * N + row] = dead ? static_cast<float>(log(static_cast<double>(M)))
                                                 : static_cast<float>(m[r] * LN2_D + log(static_cast<double>(l[r])));
    if (row >= N) continue;
    const float inv = 1.f / l[r];
    float* dst = out + ((int64_t)b * N + row) * H * WIDE + h * WIDE + hf * CW + 32 * t;  // values 32t ..
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // value 16c + n from o[n][c - 2t]: 4 n-tiles a store
      const int c = i / 4, n = 4 * (i % 4);
      *reinterpret_cast<float4*>(dst + 4 * i) = make_float4(o[n][2 * r + c] * inv, o[n + 1][2 * r + c] * inv,
                                                            o[n + 2][2 * r + c] * inv, o[n + 3][2 * r + c] * inv);
    }
  }
}

// ------------------------------------------------------------------ launch

#define ATTENTION_ARGS(T_)                                                              \
  const T_ *q, int64_t q_bs, int64_t q_rs, const T_ *k, int64_t k_bs, int64_t k_rs,    \
      const T_ *v, int64_t v_bs, int64_t v_rs, const uint8_t *mask, T_ *out,            \
      float *lse, int B, int N, int M, int H, int DH, float scale, cudaStream_t stream

#define ATTENTION_PASS q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, out, lse, N, M, H, scale

// The most dynamic shared memory a block of `kernel` may ask for on this
// card: the opt-in maximum less the kernel's static shared memory.
template <typename Kernel>
int smem_optin(Kernel kernel) {
  int dev = 0, bytes = 0;
  cudaFuncAttributes attr;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncGetAttributes(&attr, kernel);
  return bytes - static_cast<int>(attr.sharedSizeBytes);
}

// Launch a bf16 kernel, a block per 64 query rows, with `fixed` bytes of
// dynamic shared memory plus the padded key row's table. Its limit is raised
// to the card's most once per kernel; a size beyond it comes back as the
// launch's error.
template <auto kernel>
int launch_tiled(int fixed, int threads, ATTENTION_ARGS(__nv_bfloat16)) {
  static const cudaError_t attr = allow_smem(kernel, smem_optin(kernel));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + T - 1) / T, H, B);
  const int bytes = fixed + (M + T - 1) / T * T * static_cast<int>(sizeof(float2));
  kernel<<<grid, threads, bytes, stream>>>(ATTENTION_PASS);
  return static_cast<int>(cudaGetLastError());
}

// Heads of DH = C * 128 values, C >= 2: a block per 64 query rows and
// 128-value chunk of the output, with the padded key row's table.
template <bool LSE>
int launch_chunked_bf16(ATTENTION_ARGS(__nv_bfloat16)) {
  static const cudaError_t attr = allow_smem(attention_chunked<LSE>, smem_optin(attention_chunked<LSE>));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int C = DH / CW;
  const int bytes = STAGES * CHUNK_SLOT_BYTES + (M + T - 1) / T * T * static_cast<int>(sizeof(float2));
  attention_chunked<LSE><<<dim3((N + T - 1) / T, H * C, B), GROUP, bytes, stream>>>(ATTENTION_PASS, C);
  return static_cast<int>(cudaGetLastError());
}

// Heads of 128 or 256 values: q, k and v as tensor maps, a block per 64
// queries. The carveout asks for all of the SM's shared memory, which two
// blocks need.
template <int W, bool LSE>
int launch_wide(ATTENTION_ARGS(__nv_bfloat16)) {
  constexpr auto kernel = attention_wide<W, LSE>;
  static const cudaError_t attr = allow_smem(kernel, smem_optin(kernel));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const cudaError_t carveout =
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  CUtensorMap mq, mk, mv;
  if (!bf16_map(&mq, q, q_bs, q_rs, B, N, H * W) || !bf16_map(&mk, k, k_bs, k_rs, B, M, H * W) ||
      !bf16_map(&mv, v, v_bs, v_rs, B, M, H * W))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = wide_smem_bytes<W>((M + T - 1) / T);
  kernel<<<dim3((N + T - 1) / T, H, B), wide_threads<W>(), bytes, stream>>>(mq, mk, mv, mask, out, lse, N, M, H,
                                                                              scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool LSE>
int launch_chunked_f32(ATTENTION_ARGS(float)) {
  constexpr int BYTES = ffma_chunked_smem_bytes();
  static const cudaError_t attr = allow_smem(attention_ffma_chunked<LSE>, BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int C = DH / CW;
  attention_ffma_chunked<LSE><<<dim3((N + T - 1) / T, H * C, B), FG, BYTES, stream>>>(ATTENTION_PASS, C);
  return static_cast<int>(cudaGetLastError());
}

// Heads of 256 values in f32: a block per 64 query rows.
template <bool LSE>
int launch_wide_f32(ATTENTION_ARGS(float)) {
  constexpr auto kernel = attention_wide_3xtf32<LSE>;
  static const cudaError_t attr = allow_smem(kernel, WF_SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3((N + T - 1) / T, H, B), WF_THREADS, WF_SMEM_BYTES, stream>>>(ATTENTION_PASS);
  return static_cast<int>(cudaGetLastError());
}

// a head width the chunked kernels take: a multiple of 128 above it
__host__ __device__ constexpr bool chunked_width(int DH) { return DH > CW && DH % CW == 0; }

template <bool LSE>
int launch_bf16(ATTENTION_ARGS(__nv_bfloat16)) {
#define TILED_PASS q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, out, lse, B, N, M, H, DH, scale, stream
  if (DH == WIDE) return launch_wide<WIDE, LSE>(TILED_PASS);
  if (chunked_width(DH)) return launch_chunked_bf16<LSE>(TILED_PASS);
  switch (DH) {
    case 16:
      return launch_tiled<attention_mma<16, MMA_GROUPS, LSE>>(mma_smem_bytes<16, MMA_GROUPS>(),
                                                              MMA_GROUPS * GROUP, TILED_PASS);
    case 32:
      return launch_tiled<attention_mma<32, MMA_GROUPS, LSE>>(mma_smem_bytes<32, MMA_GROUPS>(),
                                                              MMA_GROUPS * GROUP, TILED_PASS);
    case 64:
      return launch_tiled<attention_wg<WG_GROUPS, LSE>>(wg_smem_bytes<WG_GROUPS>(), WG_GROUPS * GROUP, TILED_PASS);
    case 128: return launch_wide<128, LSE>(TILED_PASS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TILED_PASS
}

// The f32 kernel at head width D, a block per 64 query rows; its shared
// memory limit is raised once per kernel.
template <int D, bool LSE>
int run_f32(ATTENTION_ARGS(float)) {
  constexpr int NG = ffma_groups<D>(), BYTES = ffma_smem_bytes<D, NG>();
  static const cudaError_t attr = allow_smem(attention_ffma<D, NG, LSE>, BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attention_ffma<D, NG, LSE><<<dim3((N + T - 1) / T, H, B), NG * FG, BYTES, stream>>>(ATTENTION_PASS);
  return static_cast<int>(cudaGetLastError());
}

template <bool LSE>
int launch_f32(ATTENTION_ARGS(float)) {
#define F32_PASS q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, out, lse, B, N, M, H, DH, scale, stream
  if (DH == WIDE) return launch_wide_f32<LSE>(F32_PASS);
  if (chunked_width(DH)) return launch_chunked_f32<LSE>(F32_PASS);
  switch (DH) {
    case 16: return run_f32<16, LSE>(F32_PASS);
    case 32: return run_f32<32, LSE>(F32_PASS);
    case 64: return run_f32<64, LSE>(F32_PASS);
    case 128: return run_f32<128, LSE>(F32_PASS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef F32_PASS
}

}  // namespace

#define C_ARGS                                                                         \
  const void *q, int64_t q_bs, int64_t q_rs, const void *k, int64_t k_bs, int64_t k_rs, \
      const void *v, int64_t v_bs, int64_t v_rs, const void *mask, void *out

#define C_PASS(T_)                                                                         \
  static_cast<const T_*>(q), q_bs, q_rs, static_cast<const T_*>(k), k_bs, k_rs,            \
      static_cast<const T_*>(v), v_bs, v_rs, static_cast<const uint8_t*>(mask), static_cast<T_*>(out)

#define C_TAIL int B, int N, int M, int H, int DH, float scale, void *stream
#define C_TAIL_PASS B, N, M, H, DH, scale, static_cast<cudaStream_t>(stream)

// bf16: q, k, v rows start on 16 bytes (8 elements); f32: on 16 bytes too
// (4 elements). out is contiguous (B, N, H*DH).

// Inference: softmax attention only.
extern "C" int attention_bf16(C_ARGS, C_TAIL) {
  return launch_bf16<false>(C_PASS(__nv_bfloat16), nullptr, C_TAIL_PASS);
}

extern "C" int attention_f32(C_ARGS, C_TAIL) {
  return launch_f32<false>(C_PASS(float), nullptr, C_TAIL_PASS);
}

// Training forward: also writes lse (B, H, N) f32.
extern "C" int attention_lse_bf16(C_ARGS, void* lse, C_TAIL) {
  return launch_bf16<true>(C_PASS(__nv_bfloat16), static_cast<float*>(lse), C_TAIL_PASS);
}

extern "C" int attention_lse_f32(C_ARGS, void* lse, C_TAIL) {
  return launch_f32<true>(C_PASS(float), static_cast<float*>(lse), C_TAIL_PASS);
}
