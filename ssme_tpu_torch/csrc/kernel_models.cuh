// Model functors of the generic filter kernel (filter_megakernel.cu):
// the CUDA counterparts of the KernelModel hooks of
// ssme_tpu/ops/filter_megakernel.py (svol_kernel_model :848,
// svol_leverage_kernel_model :883).
//
// A model is a struct with
//   traits   kNumParams, kNumState, kDimObs, kDimCov;
//   ctor     Model(const float* row): reads the filter row's constrained
//            parameters once, into registers, with any per-row constants;
//   init       (rng, y[kDimObs], z[kDimCov], x[kNumState])   t = 0 draw
//   propagate  (rng, x[kNumState], y, z)                     transition
//   log_weight (x, y, z) -> float                            log g(y | x)
//   functional (x) -> float          whose filtered mean the kernel emits
// The rng hands out normal k of (particle, step, row) in the order the
// hook asks for them (draw 0 first; the tags are in ops/_prng.py), so a
// hook that draws one normal consumes exactly the SVOL kernel's bits.
#pragma once

#include <cstdint>

#include "philox.cuh"

namespace ssme {

// Model ids of ssme_filter_megakernel's dispatch.  The Python side
// (ssme_tpu_torch/ops/filter_megakernel.py::CUDA_MODEL_IDS) holds the same
// numbers under the quoted names; a CPU test parses these lines.
constexpr int kModelSvol = 0;          // "svol"
constexpr int kModelSvolLeverage = 1;  // "svol_leverage"

constexpr float kHalfLog2Pi = 0.9189385332046727f;
constexpr float kStateClamp = 40.0f;   // models/svol_leverage.py STATE_CLAMP

// normal draws of one particle at one step, handed to one hook call
struct StepRng {
  uint32_t k0, k1, i, t, b;
  uint32_t draw;
  __device__ float normal() { return normal_at(k0, k1, i, t, b, draw++); }
};

// NaN-propagating clamp (as torch.clamp and jnp.clip)
__device__ __forceinline__ float clamp_state(float v) {
  return v < -kStateClamp ? -kStateClamp : (v > kStateClamp ? kStateClamp : v);
}

// Univariate SVOL; row (beta, phi, sigma).  The same float operations as
// svol_filter.cu, so with the same seed the two kernels agree.
struct SvolModel {
  static constexpr int kNumParams = 3;
  static constexpr int kNumState = 1;
  static constexpr int kDimObs = 1;
  static constexpr int kDimCov = 0;

  float beta, phi, sigma, c0;

  __device__ explicit SvolModel(const float* p)
      : beta(p[0]), phi(p[1]), sigma(p[2]),
        c0(-kHalfLog2Pi - logf(p[0])) {}

  __device__ void init(StepRng& rng, const float*, const float*,
                       float* x) const {
    x[0] = rng.normal() * (sigma / sqrtf(1.0f - phi * phi));
  }
  __device__ void propagate(StepRng& rng, float* x, const float*,
                            const float*) const {
    x[0] = phi * x[0] + sigma * rng.normal();
  }
  __device__ float log_weight(const float* x, const float* y,
                              const float*) const {
    const float z = (y[0] / beta) * expf(-0.5f * x[0]);
    return (c0 - 0.5f * x[0]) - 0.5f * z * z;
  }
  __device__ float functional(const float* x) const { return x[0]; }
};

// SVOL with leverage; row (phi, mu, sigma, rho), covariate z = the lagged
// observation:
//   x' = clamp(mu + phi (x - mu) + z rho sigma e^{-x/2}, +-40)
//        + sigma sqrt(1 - rho^2) eps,       y ~ N(0, e^x).
// The mean clamp is where the JAX instance has it (filter_megakernel.py
// :899-901): without it a runaway x -> -inf turns the evidence NaN.
struct SvolLeverageModel {
  static constexpr int kNumParams = 4;
  static constexpr int kNumState = 1;
  static constexpr int kDimObs = 1;
  static constexpr int kDimCov = 1;

  float phi, mu, sigma, rho, sd0, sd;

  __device__ explicit SvolLeverageModel(const float* p)
      : phi(p[0]), mu(p[1]), sigma(p[2]), rho(p[3]),
        sd0(p[2] / sqrtf(1.0f - p[0] * p[0])),
        sd(p[2] * sqrtf(1.0f - p[3] * p[3])) {}

  __device__ void init(StepRng& rng, const float*, const float*,
                       float* x) const {
    x[0] = rng.normal() * sd0;
  }
  __device__ void propagate(StepRng& rng, float* x, const float*,
                            const float* z) const {
    const float mean = clamp_state(mu + phi * (x[0] - mu) +
                                   z[0] * rho * sigma * expf(-0.5f * x[0]));
    x[0] = mean + sd * rng.normal();
  }
  __device__ float log_weight(const float* x, const float* y,
                              const float*) const {
    const float z = y[0] * expf(-0.5f * x[0]);
    return -kHalfLog2Pi - 0.5f * x[0] - 0.5f * z * z;
  }
  __device__ float functional(const float* x) const { return x[0]; }
};

}  // namespace ssme
