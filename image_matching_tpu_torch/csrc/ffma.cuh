// Register-tiled f32 FFMA tiles for sm_90a, shared by the f32 attention
// kernels (csrc/attention.cu's forward, csrc/attention_bwd.cu's dQ and
// dK/dV): a group of 8 warps multiplies whole 64 x 64 tiles held row-major
// in shared memory, 4 x 4 products a thread for C = Own . Loop^T
// (`nt_product`), then, through a transposed tile X in shared memory, 4 rows
// x DW dims a thread for Out += X^T . Loop (`tn_product`). Each source
// includes it once, after hopper.cuh, inside no namespace.
#pragma once

#include "hopper.cuh"

namespace {

// A group of FG threads (8 warps) works on whole 64 x 64 tiles: the block's
// own 64 rows (keys for dK/dV, queries for dQ and the forward) against one
// 64-row tile of the looped side, both row-major in shared memory with rows
// of DH + 4 floats (16-byte aligned, and 8 consecutive rows fall on distinct
// banks).
constexpr int FG = 256;
constexpr int XLD = T + 8;  // row pitch of an X tile (P, dS), in floats: conflict-free stores

template <int DH>
__host__ __device__ constexpr int f32_ld() { return DH + 4; }

__device__ __forceinline__ void ffma_group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(grp + 1), "n"(FG) : "memory");
}

// Rows [r0, r0 + R) of a row-strided (rows, DH) f32 matrix into a tile of
// pitch DH + 4 by `NT` threads, 16 bytes a `cp.async`, zeros past `rows`.
template <int DH, int NT, int R = T>
__device__ __forceinline__ void stage_f32(float* tile, const float* base, int64_t rs, int r0, int rows, int tid) {
  constexpr int CH = DH / 4;
  for (int c = tid; c < R * CH; c += NT) {
    const int row = c / CH, col = (c % CH) * 4;
    const bool ok = r0 + row < rows;
    cp_async_16(tile + row * f32_ld<DH>() + col, ok ? base + (r0 + row) * rs + col : base, ok);
  }
}

// The first product, C = Own . Loop^T over dh: thread (warp w, lane) holds
// own rows `own` + 8i and loop rows `loop` + 4j, i, j < 4: 16 accumulators
// a product, one float4 of a row per operand and step of 4 dims. A warp
// reads 8 consecutive own rows (conflict-free) and 4 loop rows (broadcast
// to 8 lanes each): 8 LDS.128 for 64 FMAs.
struct NtLane {
  int own, loop;
};

__device__ __forceinline__ NtLane nt_lane(int gt) {
  const int w = gt / 32, lane = gt % 32;
  return {32 * (w % 2) + lane % 8, 16 * (w / 2) + lane / 8};
}

// c[i][j] += sum_d own[8i][d] loop[4j][d], d in order (`own`, `loop`: the
// thread's first rows)
template <int DH>
__device__ __forceinline__ void nt_product(float (*c)[4], const float* own, const float* loop) {
  constexpr int LD = f32_ld<DH>();
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(own + 8 * i * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(loop + 4 * j * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
      }
  }
}

// C (own x loop) into a tile X[loop row][own row] of pitch XLD: a warp's
// 4 x 8 entries of each (i, j) land on 32 distinct banks.
__device__ __forceinline__ void store_x(float* x, const float (*c)[4], const NtLane& L) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[(L.loop + 4 * j) * XLD + L.own + 8 * i] = c[i][j];
}

// The products that contract over the loop tile's rows, Out (own x DH) +=
// X^T . Loop: thread t of the NT that share Out holds own rows `own` ..
// `own` + 3 and dims `dim` .. `dim` + DW - 1 (NT = 16 DH / DW). A warp reads
// 8 float4 of one X row (128 contiguous bytes) and 4 x DW floats of one
// loop row: 2 loads for 4 DW FMAs.
struct TnLane {
  int own, dim;
};

template <int DH, int DW>
__device__ __forceinline__ TnLane tn_lane(int t) {
  constexpr int YS = DH / DW;  // dim groups
  const int rest = t / 8;
  return {4 * (t % 8 + 8 * (rest / YS)), DW * (rest % YS)};
}

template <int DW>
__device__ __forceinline__ void load_dims(float* y, const float* p) {
  if constexpr (DW == 1) {
    y[0] = p[0];
  } else if constexpr (DW == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    y[0] = v.x;
    y[1] = v.y;
  } else {
#pragma unroll
    for (int e = 0; e < DW; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + e);
      y[e] = v.x;
      y[e + 1] = v.y;
      y[e + 2] = v.z;
      y[e + 3] = v.w;
    }
  }
}

// c[i][e] += sum_r x[r][i] loop[r][e], r = 0 .. ROWS - 1 in order (`x`,
// `loop`: the thread's first column of row 0)
template <int DH, int DW, int ROWS = T>
__device__ __forceinline__ void tn_product(float (*c)[DW], const float* x, const float* loop) {
  constexpr int LD = f32_ld<DH>();
#pragma unroll 16
  for (int r = 0; r < ROWS; ++r) {
    const float4 a4 = *reinterpret_cast<const float4*>(x + r * XLD);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float y[DW];
    load_dims<DW>(y, loop + r * LD);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < DW; ++e) c[i][e] = fmaf(a[i], y[e], c[i][e]);
  }
}

// Rows own .. own + 3 (those below `rows`, counted from `row0`) of Out to a
// contiguous (., H * DH) f32 matrix at `out` (batch and head applied).
template <int DW>
__device__ __forceinline__ void store_out(float* out, int row0, int rows, int64_t rs, const float (*c)[DW],
                                          const TnLane& R) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row0 + R.own + i >= rows) continue;
    float* o = out + (int64_t)(row0 + R.own + i) * rs + R.dim;
    if constexpr (DW == 1) {
      o[0] = c[i][0];
    } else if constexpr (DW == 2) {
      *reinterpret_cast<float2*>(o) = make_float2(c[i][0], c[i][1]);
    } else {
#pragma unroll
      for (int e = 0; e < DW; e += 4)
        *reinterpret_cast<float4*>(o + e) = make_float4(c[i][e], c[i][e + 1], c[i][e + 2], c[i][e + 3]);
    }
  }
}

// The partial sums of groups 1.. through their own (idle) rings, added by
// group 0 in the groups' order; thread gt of every group owns the same
// entries. Every thread of the block calls it.
template <int NG, int N>
__device__ __forceinline__ void add_groups(float* c, float* ring0, int ring_floats, int grp, int gt) {
  if constexpr (NG > 1) {
    __syncthreads();  // every group is done with its ring
    if (grp > 0)
#pragma unroll
      for (int k = 0; k < N; ++k) ring0[grp * ring_floats + k * FG + gt] = c[k];
    __syncthreads();
    if (grp == 0)
#pragma unroll
      for (int o = 1; o < NG; ++o)
#pragma unroll
        for (int k = 0; k < N; ++k) c[k] += ring0[o * ring_floats + k * FG + gt];
  }
}

}  // namespace
