// The normal draws a model hook takes at one step, for the functors of the
// generic filter kernel (kernel_models.cuh) and of the Liu-West kernel
// (lw_models.cuh).  A hook that draws is a template over its rng and asks
// for normal() in its own order; the rng hands out draw `base`, base + 1,
// ... of (particle, step, row), whose counters and tags ops/_prng.py
// writes down (the Liu-West kernel starts its hooks at draw P, after the P
// kernel draws of theta).
// PairRng / PairSines through for_pair: the two particles 2q and 2q + 1
// of a Philox counter, held by one thread (every family of the generic
// and Liu-West kernels, kPer neighbouring particles per thread): one call
// and one Box-Muller per draw serve both, the bits ops/_prng.py
// normals_steps gives each.
#pragma once

#include <cstdint>

#include "philox.cuh"

namespace ssme {

// normal draws of the pair q = (particle 2q, particle 2q + 1) at one step,
// handed to two hook calls in turn: the first particle's k-th normal()
// makes one Philox call on counter (q, t, b, tag of draw base + k) and one
// Box-Muller, returns the cosine and keeps the sine, which the second
// particle's k-th normal() returns (PairSines) -- the bits normals_steps gives
// each of them.  kDraws: the hook's draws (Model::kDraws), so the sines
// stay in registers.
template <int kDraws>
struct PairRng {
  uint32_t k0, k1, q, t, b;
  uint32_t base;
  int draw = 0;
  float sine[kDraws];
  __device__ float normal() {
    const float2 z = normal_pair_at(k0, k1, q, t, b, base + draw);
    sine[draw++] = z.y;
    return z.x;
  }
};

template <int kDraws>
struct PairSines {
  const float (&sine)[kDraws];
  int draw = 0;
  __device__ float normal() { return sine[draw++]; }
};

// One hook of one pair of particles: hook(first's rng, 0) then
// hook(second's rng, 1) on the pair's draws at step t, from draw `base`.
template <int kDraws, class Hook>
__device__ __forceinline__ void for_pair(uint32_t k0, uint32_t k1,
                                         uint32_t q, uint32_t t, uint32_t b,
                                         Hook&& hook, uint32_t base = 0u) {
  PairRng<kDraws> first{k0, k1, q, t, b, base};
  hook(first, 0);
  PairSines<kDraws> second{first.sine};
  hook(second, 1);
}

}  // namespace ssme
