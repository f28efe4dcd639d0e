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
// cores' rate (~4 us at 989 TFLOP/s), not by memory.
//
// Common to both kernels below:
//   * keys are walked in 64-key tiles staged in shared memory, with
//     flash-style online softmax (running max m, sum l, rescaled output),
//     because one head's K and V at dh=64, K=1024 (256 KB in bf16) exceed a
//     block's 227 KB;
//   * heads are selected by column offsets into the packed tensors (no fold
//     transposes), and q/k/v may be row-strided views (e.g. slices of one
//     fused QKV projection) as long as their last dimension is contiguous;
//   * masked keys get a logit of exactly -1e9 (a fully masked row averages
//     V uniformly, as the plain version does); keys past the end get -inf
//     and weigh nothing.
//
// bf16 (the main path): `attention_mma`, tensor cores through warp-level
// mma.sync.m16n8k16 (f32 accumulate), flash-attention-2 style. One block of
// 4 warps per (b, head, 64-row query tile), 16 query rows per warp. Q stays
// in registers as A fragments; S = Q K^T lands in registers in the C layout,
// which is reused directly as the A fragments of P for O += P V (P rounded
// to bf16 for that product, as the plain version rounds its probabilities).
// K is staged row-major and V transposed, both with 8 bf16 of padding per
// row, so every B-fragment read from shared memory is conflict-free. No
// cp.async, TMA or wgmma yet: loads and math do not overlap.
//
// f32 (the f32 compute dtype): `attention_simt`, plain FMAs, no tensor
// cores, so f32 keeps full f32 products. 4 threads per query row, each
// holding dh/4 of the row's q and output in registers, partial dot products
// joined by two warp shuffles; a thread's dims are interleaved in 4-float
// chunks so the 4 threads of a row read 64 consecutive bytes of a staged key.
//
// Forward with LSE (training): the same two kernels with LSE = true also
// write the f32 log-sum-exp of every query row, (B, H, N), for the backward
// kernels of csrc/attention_bwd.cu. This replaces _flash_forward_with_lse
// (_flash_kernel_with_lse, attention.py:100/560). Inference instantiates
// LSE = false, which is the kernel above unchanged. A batch element with no
// valid key ("dead") has every logit at -1e9, where m + log(l) rounds back
// to -1e9 in f32 and the backward could no longer tell p = 1/M from p = 1;
// for it the kernel writes log(l) = log(M), the LSE of the row with the
// masked logits shifted to 0, and the backward kernels recognise the dead
// element from the mask the same way (no valid key in mask[b, :]).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KT = 64;                 // keys per shared-memory tile
constexpr float MASKED = -1e9f;

// Per-key additive state of one tile: 0 valid, -1e9 masked, -inf past M.
__device__ __forceinline__ float key_bias(const uint8_t* mask, int b, int M, int key) {
  if (key >= M) return -INFINITY;
  return (mask != nullptr && !mask[(int64_t)b * M + key]) ? MASKED : 0.f;
}

// True when batch element b has no valid key. Every thread of the block
// must call it.
__device__ __forceinline__ bool dead_batch(const uint8_t* mask, int b, int M) {
  if (mask == nullptr) return false;
  int any = 0;
  for (int j = threadIdx.x; j < M; j += blockDim.x) any |= mask[(int64_t)b * M + j];
  return !__syncthreads_or(any);
}

// ------------------------------------------------------------------ bf16, mma

constexpr int MMA_WARPS = 4;
constexpr int MMA_ROWS = 16 * MMA_WARPS;  // query rows per block
constexpr int PAD = 8;                    // bf16 of padding per staged row

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

template <int DH, bool LSE>
__global__ void __launch_bounds__(MMA_WARPS * 32)
attention_mma(const __nv_bfloat16* __restrict__ q, int64_t q_bs, int64_t q_rs,
              const __nv_bfloat16* __restrict__ k, int64_t k_bs, int64_t k_rs,
              const __nv_bfloat16* __restrict__ v, int64_t v_bs, int64_t v_rs,
              const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
              float* __restrict__ lse, int N, int M, int H, float scale) {
  constexpr int KSTEPS = DH / 16;  // k-steps of Q K^T
  constexpr int DTILES = DH / 8;   // n-tiles of O
  __shared__ __align__(16) __nv_bfloat16 ks[KT][DH + PAD];   // K, row-major
  __shared__ __align__(16) __nv_bfloat16 vt[DH][KT + PAD];   // V, transposed
  __shared__ float kbias[KT];

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  const int r0 = blockIdx.x * MMA_ROWS + warp * 16 + g;  // this thread's rows r0, r0 + 8
  bool dead = false;
  if constexpr (LSE) dead = dead_batch(mask, b, M);

  // Q as A fragments: a0 (r0, 2t), a1 (r0+8, 2t), a2 (r0, 2t+8), a3 (r0+8, 2t+8)
  uint32_t qa[KSTEPS][4];
  const __nv_bfloat16* qb = q + b * q_bs + h * DH + 2 * t;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + (i & 1) * 8, col = kk * 16 + (i >> 1) * 8;
      qa[kk][i] = row < N ? *reinterpret_cast<const uint32_t*>(qb + row * q_rs + col) : 0u;
    }

  float o[DTILES][4];
#pragma unroll
  for (int n = 0; n < DTILES; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows r0, r0 + 8

  const __nv_bfloat16* kb = k + b * k_bs + h * DH;
  const __nv_bfloat16* vb = v + b * v_bs + h * DH;
  for (int kt = 0; kt < M; kt += KT) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < KT * DH / 4; idx += MMA_WARPS * 32) {
      const int j = idx / (DH / 4), d = (idx % (DH / 4)) * 4;
      const int key = kt + j;
      uint2 kv = make_uint2(0u, 0u), vv = make_uint2(0u, 0u);
      if (key < M) {
        kv = *reinterpret_cast<const uint2*>(kb + key * k_rs + d);
        vv = *reinterpret_cast<const uint2*>(vb + key * v_rs + d);
      }
      *reinterpret_cast<uint2*>(&ks[j][d]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 4; ++e) vt[d + e][j] = ve[e];
    }
    for (int j = threadIdx.x; j < KT; j += MMA_WARPS * 32) kbias[j] = key_bias(mask, b, M, kt + j);
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys; B fragment b0 (k=2t, n=g), b1 (k=2t+8, n=g)
    float s[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&ks[n * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&ks[n * 8 + g][kk * 16 + 8 + 2 * t]);
        mma_bf16(s[n], qa[kk], b0, b1);
      }
    }

    // scale and mask; C layout: s[n][0..1] row r0, s[n][2..3] row r0+8, cols 8n+2t+{0,1}
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float kb_ = kbias[n * 8 + 2 * t + (e & 1)];
        s[n][e] = kb_ == 0.f ? s[n][e] * scale : kb_;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 threads of a row group share a row
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);  // finite: key kt is in range
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];  // per-thread partial sum, joined at the end
    }
#pragma unroll
    for (int n = 0; n < DTILES; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];

    // P = exp(S - m), and O += P V with P's C layout reused as A fragments
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* sn = s[2 * kk + half];
        const float p0 = __expf(sn[0] - m[0]), p1 = __expf(sn[1] - m[0]);
        const float p2 = __expf(sn[2] - m[1]), p3 = __expf(sn[3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[2 * half] = pack_bf16(p0, p1);      // a0 / a2: row r0
        pa[2 * half + 1] = pack_bf16(p2, p3);  // a1 / a3: row r0 + 8
      }
#pragma unroll
      for (int n = 0; n < DTILES; ++n) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&vt[n * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&vt[n * 8 + g][kk * 16 + 8 + 2 * t]);
        mma_bf16(o[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= N) continue;
    if constexpr (LSE) {
      if (t == 0) lse[((int64_t)b * H + h) * N + row] = dead ? logf(l[r]) : m[r] + logf(l[r]);
    }
    const float inv = 1.f / l[r];
    __nv_bfloat16* orow = out + ((int64_t)b * N + row) * (int64_t)(H * DH) + h * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < DTILES; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// ------------------------------------------------------------------ f32, SIMT

constexpr int SIMT_THREADS = 128;
constexpr int TPR = 4;                       // threads per query row
constexpr int SIMT_ROWS = SIMT_THREADS / TPR;

__device__ __forceinline__ void load4(const float* p, float* d) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
}

template <int DH, bool LSE>
__global__ void __launch_bounds__(SIMT_THREADS)
attention_simt(const float* __restrict__ q, int64_t q_bs, int64_t q_rs,
               const float* __restrict__ k, int64_t k_bs, int64_t k_rs,
               const float* __restrict__ v, int64_t v_bs, int64_t v_rs,
               const uint8_t* __restrict__ mask, float* __restrict__ out,
               float* __restrict__ lse, int N, int M, int H, float scale) {
  constexpr int CHUNKS = DH / 16;  // 4-float chunks per thread
  __shared__ __align__(16) float sk[KT][DH];
  __shared__ __align__(16) float sv[KT][DH];
  __shared__ float kbias[KT];

  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * SIMT_ROWS + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const bool row_ok = row < N;
  bool dead = false;
  if constexpr (LSE) dead = dead_batch(mask, b, M);

  float qr[CHUNKS][4], acc[CHUNKS][4];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (row_ok) {
      load4(q + b * q_bs + row * q_rs + h * DH + c * 16 + part * 4, qr[c]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qr[c][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const float* kb = k + b * k_bs + h * DH;
  const float* vb = v + b * v_bs + h * DH;
  for (int kt = 0; kt < M; kt += KT) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < KT * DH / 4; idx += SIMT_THREADS) {
      const int j = idx / (DH / 4), d = (idx % (DH / 4)) * 4;
      const int key = kt + j;
      if (key < M) {
        load4(kb + key * k_rs + d, &sk[j][d]);
        load4(vb + key * v_rs + d, &sv[j][d]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) { sk[j][d + e] = 0.f; sv[j][d + e] = 0.f; }
      }
    }
    for (int j = threadIdx.x; j < KT; j += SIMT_THREADS) kbias[j] = key_bias(mask, b, M, kt + j);
    __syncthreads();

    float s[KT];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        float kk[4];
        load4(&sk[j][c * 16 + part * 4], kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) dot = fmaf(qr[c][e], kk[e], dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      s[j] = kbias[j] == 0.f ? dot * scale : kbias[j];
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);  // finite: key kt is always in range
    const float corr = __expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= corr;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p = __expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        float vv[4];
        load4(&sv[j][c * 16 + part * 4], vv);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = fmaf(p, vv[e], acc[c][e]);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    if constexpr (LSE) {
      if (part == 0) lse[((int64_t)b * H + h) * N + row] = dead ? logf(l) : m + logf(l);
    }
    const float inv = 1.f / l;
    float* o = out + ((int64_t)b * N + row) * (int64_t)(H * DH) + h * DH;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
      *reinterpret_cast<float4*>(o + c * 16 + part * 4) =
          make_float4(acc[c][0] * inv, acc[c][1] * inv, acc[c][2] * inv, acc[c][3] * inv);
  }
}

// ------------------------------------------------------------------ launch

#define ATTENTION_ARGS(T)                                                          \
  const T *q, int64_t q_bs, int64_t q_rs, const T *k, int64_t k_bs, int64_t k_rs, \
      const T *v, int64_t v_bs, int64_t v_rs, const uint8_t *mask, T *out,         \
      float *lse, int B, int N, int M, int H, int DH, float scale, cudaStream_t stream

#define ATTENTION_PASS q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, mask, out, lse, N, M, H, scale

template <bool LSE>
int launch_bf16(ATTENTION_ARGS(__nv_bfloat16)) {
  const dim3 grid((N + MMA_ROWS - 1) / MMA_ROWS, H, B);
  const int threads = MMA_WARPS * 32;
  switch (DH) {
    case 16: attention_mma<16, LSE><<<grid, threads, 0, stream>>>(ATTENTION_PASS); break;
    case 32: attention_mma<32, LSE><<<grid, threads, 0, stream>>>(ATTENTION_PASS); break;
    case 64: attention_mma<64, LSE><<<grid, threads, 0, stream>>>(ATTENTION_PASS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool LSE>
int launch_f32(ATTENTION_ARGS(float)) {
  const dim3 grid((N + SIMT_ROWS - 1) / SIMT_ROWS, H, B);
  switch (DH) {
    case 16: attention_simt<16, LSE><<<grid, SIMT_THREADS, 0, stream>>>(ATTENTION_PASS); break;
    case 32: attention_simt<32, LSE><<<grid, SIMT_THREADS, 0, stream>>>(ATTENTION_PASS); break;
    case 64: attention_simt<64, LSE><<<grid, SIMT_THREADS, 0, stream>>>(ATTENTION_PASS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define C_ARGS                                                                         \
  const void *q, int64_t q_bs, int64_t q_rs, const void *k, int64_t k_bs, int64_t k_rs, \
      const void *v, int64_t v_bs, int64_t v_rs, const void *mask, void *out

#define C_PASS(T)                                                                          \
  static_cast<const T*>(q), q_bs, q_rs, static_cast<const T*>(k), k_bs, k_rs,              \
      static_cast<const T*>(v), v_bs, v_rs, static_cast<const uint8_t*>(mask), static_cast<T*>(out)

#define C_TAIL int B, int N, int M, int H, int DH, float scale, void *stream
#define C_TAIL_PASS B, N, M, H, DH, scale, static_cast<cudaStream_t>(stream)

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
