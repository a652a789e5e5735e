// Philox4x32-10 and the uniform / Box-Muller conversions the filter
// kernels draw from.  Replaces the TPU hardware PRNG helpers of
// ssme_tpu/ops/_prng.py (uniform_bits, normal_bits, uniform_offset).
//
// The mapping from counters to numbers is written down once, in the
// docstring of ssme_tpu_torch/ops/_prng.py; the plain PyTorch version
// there consumes exactly the same bits.  No fast-math intrinsics: logf,
// sqrtf and sincosf are the accurate library functions.
#pragma once

#include <cstdint>

namespace ssme {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// fourth counter word: which stream a draw belongs to
constexpr uint32_t kTagNormal = 0u;  // normal draw 0: init / propagate
constexpr uint32_t kTagOffset = 1u;  // systematic resampling offset (the
                                     // first stage in K2's APF mode)
constexpr uint32_t kTagChain = 2u;   // host-side chain seeds, never here
                                     // normal draw k >= 1: kTagChain + k
constexpr uint32_t kTagPriorUniform = 0x80000000u;  // Liu-West t = 0 prior
constexpr uint32_t kTagSelectOffset = 0x80000001u;  // Liu-West APF selection
// roll resamplers (roll_select.cuh): sweep s of a step's resample takes
// kTagRollSweep + s, of an APF first-stage selection kTagRollSelect + s
constexpr uint32_t kTagRollSweep = 0xC0000000u;
constexpr uint32_t kTagRollSelect = 0xE0000000u;

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kTwoPow24Inv = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoPow23Inv = 1.1920928955078125e-07f;  // 2^-23

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return c;
}

// u1 in (0, 1]: the Box-Muller radius argument, so logf is finite
__device__ __forceinline__ float uniform_open_zero(uint32_t w) {
  return static_cast<float>((w >> 8) + 1u) * kTwoPow24Inv;
}

// u2 in [0, 1): the Box-Muller angle
__device__ __forceinline__ float uniform_closed_zero(uint32_t w) {
  return static_cast<float>(w >> 8) * kTwoPow24Inv;
}

// systematic offset in (0, 1), never 0 and never 1: (w >> 9) + 0.5 is
// exact in float32, so the product is exactly (2k + 1) 2^-24
__device__ __forceinline__ float uniform_offset(uint32_t w) {
  return (static_cast<float>(w >> 9) + 0.5f) * kTwoPow23Inv;
}

// paired Box-Muller: (r cos a, r sin a) from one pair of words
__device__ __forceinline__ float2 box_muller(uint32_t w0, uint32_t w1) {
  const float u1 = uniform_open_zero(w0);
  const float u2 = uniform_closed_zero(w1);
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(kTwoPi * u2, &s, &c);
  return make_float2(r * c, r * s);
}

// the fourth counter word of normal draw `draw` of a step
__device__ __forceinline__ uint32_t normal_tag(uint32_t draw) {
  return draw == 0u ? kTagNormal : kTagChain + draw;
}

// both normals of pair k of row b at step t, draw `draw`: (particle 2k,
// particle 2k+1) = (r cos a, r sin a), the bits ops/_prng.py
// normals_steps gives each of them, from one Philox call and one
// Box-Muller
__device__ __forceinline__ float2 normal_pair_at(uint32_t k0, uint32_t k1,
                                                 uint32_t k, uint32_t t,
                                                 uint32_t b,
                                                 uint32_t draw = 0u) {
  const uint4 w = philox4x32_10(make_uint4(k, t, b, normal_tag(draw)), k0,
                                k1);
  return box_muller(w.x, w.y);
}

__device__ __forceinline__ float offset_at(uint32_t k0, uint32_t k1,
                                           uint32_t t, uint32_t b,
                                           uint32_t tag = kTagOffset) {
  const uint4 w = philox4x32_10(make_uint4(0u, t, b, tag), k0, k1);
  return uniform_offset(w.x);
}

// prior uniforms k = 4 blk .. 4 blk + 3 of particle i in row b, in [0, 1):
// word k & 3 of counter (i, blk, b, kTagPriorUniform)
__device__ __forceinline__ float4 prior_uniforms_at(uint32_t k0, uint32_t k1,
                                                    uint32_t i, uint32_t blk,
                                                    uint32_t b) {
  const uint4 w = philox4x32_10(make_uint4(i, blk, b, kTagPriorUniform), k0,
                                k1);
  return make_float4(uniform_closed_zero(w.x), uniform_closed_zero(w.y),
                     uniform_closed_zero(w.z), uniform_closed_zero(w.w));
}

}  // namespace ssme
