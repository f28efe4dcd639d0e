// f32-accurate products on the tensor cores for sm_90a, shared by the f32
// kernels that multiply as 3xTF32 (csrc/attention.cu's forward at heads of
// 256, csrc/attention_bwd.cu's backward at 128 and
// csrc/attention_bwd_chunked.cu's above it): each f32 operand as a TF32
// part and its rest, three `mma.sync.m16n8k8` products a k-step. Each
// source includes it once, after hopper.cuh, inside no namespace.
#pragma once

#include "hopper.cuh"

namespace {

// The loop row of a product's column c (0 .. 7) of an n-tile, relative to
// the n-tile's first: 2t -> t and 2t + 1 -> t + 4, so that the C layout of
// S (lane t: columns 2t, 2t + 1) is P's A fragment for the next product,
// which contracts over those rows, with k-step columns t, t + 4 in row
// order, and its B fragments lie in rows t, t + 4.
__host__ __device__ constexpr int wf_key(int c) { return c / 2 + 4 * (c % 2); }

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

// c[n] += a . b[n] over one k-step for NT n-tiles that share their A
// fragments, each as three TF32 products, the small ones first (lo hi, hi
// lo, hi hi), summed from zero and added to c in f32. An mma's sum rounds
// toward zero at the scale of its largest term: carried through the
// running total, that bias grew with the depth of the sum (4-6x the plain
// f32 version's distance to float64 on the card); from zero it stays at
// the scale of 8 products, and the total rounds to nearest. Issued a
// product kind at a time over the n-tiles, so that NT independent products
// are in flight, not one chain of three.
template <int NT>
__device__ __forceinline__ void mma_3xtf32_tiles(float (*c)[4], const uint32_t* ah, const uint32_t* al,
                                                 const uint32_t (*bh)[2], const uint32_t (*bl)[2]) {
  float d[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(d[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(d[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(d[n], ah, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += d[n][e];
}

// One n-tile: c (4 values) += a . b, b's two fragment registers in bh, bl.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah, const uint32_t* al, const uint32_t* bh,
                                           const uint32_t* bl) {
  mma_3xtf32_tiles<1>(reinterpret_cast<float(*)[4]>(c), ah, al, reinterpret_cast<const uint32_t(*)[2]>(bh),
                      reinterpret_cast<const uint32_t(*)[2]>(bl));
}

}  // namespace
