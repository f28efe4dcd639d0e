// Device helpers of the attention backward sources (csrc/attention_bwd.cu,
// csrc/attention_bwd_chunked.cu): the ring's stages, the key states of a
// batch element and their factors in P and dS, and dS's product. Each
// source includes it once, after hopper.cuh and ffma.cuh, inside no
// namespace.
#pragma once

#include "ffma.cuh"

namespace {

constexpr int STAGES = 2;  // tiles of the looped side in a group's ring
constexpr float LOG2E = 1.4426950408889634f;

// key state: 0 valid, 1 masked in a dead batch element (logit 0), 2 masked
// in a live element or past M (P = 0)
constexpr uint8_t VALID = 0, DEAD_KEY = 1, NO_KEY = 2;

__device__ __forceinline__ uint8_t key_state(const uint8_t* mask, int b, int M, int key, bool dead) {
  if (key >= M) return NO_KEY;
  if (mask == nullptr || mask[(int64_t)b * M + key]) return VALID;
  return dead ? DEAD_KEY : NO_KEY;
}

// c (16 x DH) += dS (16 x 16, f32 in the C layout, rounded to bf16) . tile
// rows at `tile_tn`
template <int DH>
__device__ __forceinline__ void mma_ds(float (*c)[4], const float (*ds)[4], uint32_t tile_tn) {
  uint32_t a[4];
  c_to_a(a, ds);
  mma_tn<DH>(c, a, tile_tn);
}

// A key's part in P and dS, as factors, so that the inner loops run without
// a branch (a conditional around the exponential compiles to one, and with
// one warp on a scheduler nothing hides it): P = exp(S * s_scale - lse) for
// a key that counts (s_scale = scale if valid, 0 in a dead batch element:
// exp(-lse) = 1/M), else 0; dS = P (dP - delta) * ds_scale, ds_scale = scale
// for a valid key, else 0.
struct KeyRow {
  float s_scale, ds_scale;
  bool counts;
};

__device__ __forceinline__ KeyRow key_row(uint8_t state, float scale) {
  const float s = state == VALID ? scale : 0.f;
  return {s, s, state != NO_KEY};
}

// The rows of this thread's two own keys, `first` and `first` + 8. The
// keys' own mask bytes are asked for ahead of the block's reduction over
// the whole mask row, so that the two trips to device memory overlap.
__device__ __forceinline__ void own_key_rows(KeyRow* key, const uint8_t* mask, int b, int M, int first,
                                             float scale) {
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    valid[r] = first + 8 * r < M && (mask == nullptr || mask[(int64_t)b * M + first + 8 * r]);
  const bool dead = dead_batch(mask, b, M);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key[r] = key_row(valid[r] ? VALID : (dead && first + 8 * r < M ? DEAD_KEY : NO_KEY), scale);
}

// P of one (key, query) entry from its S
__device__ __forceinline__ float p_of(float s, const KeyRow& key, float lse) {
  const float e = __expf(fmaf(s, key.s_scale, -lse));
  return key.counts ? e : 0.f;
}

// s -> P and dp -> dS in place, for one (key, query) entry
__device__ __forceinline__ void p_ds(float& s, float& dp, const KeyRow& key, float lse, float delta) {
  s = p_of(s, key, lse);
  dp = s * (dp - delta) * key.ds_scale;
}

}  // namespace
