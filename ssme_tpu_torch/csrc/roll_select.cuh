// Roll-based Metropolis and rejection ancestor selection for one CTA per
// filter row, kPer slots per thread (slot j = p * blockDim.x + threadIdx.x,
// n = kPer * blockDim.x a power of two).  Replaces
// metropolis_select_leaves and rejection_select_leaves of
// ssme_tpu/ops/_select.py (Murray, Lee & Jacob's GPU resamplers).
//
// The TPU moves values: each sweep rolls every leaf by the cumulative
// shift c and selects elementwise, because its lanes cannot gather.  Here
// the row's weights sit in shared memory and each thread carries only the
// candidate INDEX of its slots: slot j proposes (j - c) mod n, reads that
// weight and decides.  The leaves move once, by the final ancestors,
// through the caller's gather buffer (gather_leaves_per below).  The law
// is the TPU's exactly, because its rolls are exact:
//  - metropolis: exactly `iters` sweeps of chains that start at j and
//    accept at u w_cur < w_cand (finite-sweep bias: ops/_select.py);
//  - rejection: sweep 0 proposes the slot itself, later sweeps (j - c);
//    accept at u w_max < w_cand; an accepted slot freezes; the row stops
//    when every slot has accepted (__syncthreads_or), or after
//    kRollMaxIters sweeps, when a slot still pending keeps itself.  The
//    TPU stops when all 8 rows of its tile are done; frozen slots do not
//    move, so the law is the same.
// Random numbers (ops/_prng.py): sweep s takes tag tag_base + s; slot j's
// accept uniform is uniform_open_zero of word 0 of counter (j, t, b, tag),
// the row's shift word is word 1 of counter (0, t, b, tag), added modulo
// 2^32.  No fast-math intrinsics: the compare u * w < w' is one rounded
// product, as in the plain version.
#pragma once

#include <cstdint>

#include "philox.cuh"
#include "systematic_select.cuh"

namespace ssme {

// resampler codes of the C entry points (ops/_select.py RESAMPLER_CODES)
constexpr int kResampleSystematic = 0;
constexpr int kResampleMetropolis = 1;
constexpr int kResampleRejection = 2;
constexpr int kRollMaxIters = 4096;

__device__ __forceinline__ float roll_uniform(uint32_t k0, uint32_t k1,
                                              uint32_t j, uint32_t t,
                                              uint32_t b, uint32_t tag) {
  return uniform_open_zero(philox4x32_10(make_uint4(j, t, b, tag), k0, k1).x);
}

__device__ __forceinline__ uint32_t roll_shift(uint32_t k0, uint32_t k1,
                                               uint32_t t, uint32_t b,
                                               uint32_t tag) {
  return philox4x32_10(make_uint4(0u, t, b, tag), k0, k1).y;
}

// Ancestors of this thread's kPer slots under weights w (one per slot).
// wsh: shared float[n], the row's weights, read until the caller's next
// barrier; red: shared float[32].  Every thread of the CTA must call it.
template <int kPer>
__device__ __forceinline__ void roll_ancestors(
    int resampler, int metropolis_iters, const float (&w)[kPer], float* wsh,
    float* red, uint32_t k0, uint32_t k1, uint32_t t, uint32_t b,
    uint32_t tag_base, int (&anc)[kPer]) {
  const uint32_t bd = blockDim.x;
  const uint32_t mask = bd * kPer - 1u;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    wsh[p * bd + threadIdx.x] = w[p];
    anc[p] = static_cast<int>(p * bd + threadIdx.x);
  }
  if (resampler == kResampleMetropolis) {
    __syncthreads();
    float w_cur[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) w_cur[p] = w[p];
    uint32_t c = 0u;
    for (int s = 0; s < metropolis_iters; ++s) {
      const uint32_t tag = tag_base + static_cast<uint32_t>(s);
      c += roll_shift(k0, k1, t, b, tag);
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const uint32_t j = p * bd + threadIdx.x;
        const uint32_t idx = (j - c) & mask;
        const float cand = wsh[idx];
        if (roll_uniform(k0, k1, j, t, b, tag) * w_cur[p] < cand) {
          anc[p] = static_cast<int>(idx);
          w_cur[p] = cand;
        }
      }
    }
    return;
  }
  float m = w[0];
#pragma unroll
  for (int p = 1; p < kPer; ++p) m = fmaxf(m, w[p]);
  const float w_max = block_max(m, red);  // its barriers publish wsh
  bool acc[kPer];
  int pending = 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const uint32_t j = p * bd + threadIdx.x;
    acc[p] = roll_uniform(k0, k1, j, t, b, tag_base) * w_max < w[p];
    pending |= !acc[p];
  }
  uint32_t c = 0u;
  for (int s = 1; s < kRollMaxIters; ++s) {
    if (!__syncthreads_or(pending)) break;
    const uint32_t tag = tag_base + static_cast<uint32_t>(s);
    c += roll_shift(k0, k1, t, b, tag);
    pending = 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (acc[p]) continue;
      const uint32_t j = p * bd + threadIdx.x;
      const uint32_t idx = (j - c) & mask;
      if (roll_uniform(k0, k1, j, t, b, tag) * w_max < wsh[idx]) {
        acc[p] = true;
        anc[p] = static_cast<int>(idx);
      } else {
        pending = 1;
      }
    }
  }
}

// every leaf of the kPer particles of this thread moved by their
// ancestors, through one shared buffer of n floats reused leaf by leaf;
// at kPer = 1 this is gather_leaves
template <int kLeaves, int kPer>
__device__ __forceinline__ void gather_leaves_per(float (&v)[kPer][kLeaves],
                                                  const int (&anc)[kPer],
                                                  float* buf) {
  const int bd = blockDim.x;
#pragma unroll
  for (int l = 0; l < kLeaves; ++l) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) buf[p * bd + threadIdx.x] = v[p][l];
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPer; ++p) v[p][l] = buf[anc[p]];
    __syncthreads();
  }
}

}  // namespace ssme
