// Model functors of the generic filter kernel (filter_megakernel.cu):
// the CUDA counterparts of the KernelModel hooks of
// ssme_tpu/ops/filter_megakernel.py (svol_kernel_model :848,
// svol_leverage_kernel_model :883, factor_svol_kernel_model :926,
// poisson_ar_kernel_model :1008, svol_t_kernel_model :1053).
//
// A model is a struct with
//   traits   kNumParams, kNumState, kDimObs, kDimCov; kRowShared, the
//            count of per-row constants the kernel keeps in shared
//            memory; kHasPropMu, whether the APF mode can run it;
//            kDraws, the normals one init or propagate call takes;
//   row_shared(row, j) -> float      per-row shared constant j (when
//            kRowShared > 0), written once per filter row;
//   ctor     Model(const float* row, const float* shared): reads the
//            filter row's constrained parameters once, into registers,
//            with any per-row constants;
//   init       (rng, y[kDimObs], z[kDimCov], x[kNumState])   t = 0 draw
//   propagate  (rng, x[kNumState], y, z)                     transition
//   prop_mu    (x, y, z, out[kNumState])     the APF lookahead (when
//            kHasPropMu)
//   log_weight (x, y, z) -> float                            log g(y | x)
//   functional (x) -> float          whose filtered mean the kernel emits
// The hooks that draw are templates over the rng, which hands out normal
// k of (particle, step, row) in the order the hook asks for them (draw 0
// first; the tags are in ops/_prng.py), so a hook that draws one normal
// consumes exactly the SVOL kernel's bits: PairRng and PairSines, one
// Philox call per pair of neighbouring particles and draw (both selection
// families; step_rng.cuh, which the Liu-West functors share).
// Each functor performs the float operations of its Python hooks in
// their order, so that with the same bits the kernel and the plain
// version differ only by fused multiply-adds and reduction order.
#pragma once

#include <cstdint>

#include "philox.cuh"
#include "step_rng.cuh"

namespace ssme {

// Model ids of ssme_filter_megakernel's dispatch.  The Python side
// (ssme_tpu_torch/ops/filter_megakernel.py::CUDA_MODEL_IDS) holds the same
// numbers under the quoted names; a CPU test parses these lines.
constexpr int kModelSvol = 0;          // "svol"
constexpr int kModelSvolLeverage = 1;  // "svol_leverage"
constexpr int kModelSvolT = 2;         // "svol_t"
constexpr int kModelPoissonAr = 3;     // "poisson_ar"
constexpr int kModelFactorSvol3 = 4;   // "factor_svol_3"
constexpr int kModelFactorSvol4 = 5;   // "factor_svol_4"
constexpr int kModelFactorSvol5 = 6;   // "factor_svol_5"

constexpr float kHalfLog2Pi = 0.9189385332046727f;
constexpr float kStateClamp = 40.0f;   // models/svol_leverage.py STATE_CLAMP

// NaN-propagating clamp (as torch.clamp and jnp.clip)
__device__ __forceinline__ float clamp_state(float v) {
  return v < -kStateClamp ? -kStateClamp : (v > kStateClamp ? kStateClamp : v);
}

// Univariate SVOL; row (beta, phi, sigma).  The same float operations as
// svol_filter_sys.cu, so with the same seed the two kernels agree.
struct SvolModel {
  static constexpr int kNumParams = 3;
  static constexpr int kNumState = 1;
  static constexpr int kDimObs = 1;
  static constexpr int kDimCov = 0;
  static constexpr int kRowShared = 0;
  static constexpr bool kHasPropMu = true;
  static constexpr int kDraws = 1;

  float beta, phi, sigma, c0;

  __device__ SvolModel(const float* p, const float*)
      : beta(p[0]), phi(p[1]), sigma(p[2]),
        c0(-kHalfLog2Pi - logf(p[0])) {}

  template <class Rng>
  __device__ void init(Rng& rng, const float*, const float*,
                       float* x) const {
    x[0] = rng.normal() * (sigma / sqrtf(1.0f - phi * phi));
  }
  template <class Rng>
  __device__ void propagate(Rng& rng, float* x, const float*,
                            const float*) const {
    x[0] = phi * x[0] + sigma * rng.normal();
  }
  __device__ void prop_mu(const float* x, const float*, const float*,
                          float* out) const {
    out[0] = phi * x[0];
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
  static constexpr int kRowShared = 0;
  static constexpr bool kHasPropMu = true;
  static constexpr int kDraws = 1;

  float phi, mu, sigma, rho, sd0, sd;

  __device__ SvolLeverageModel(const float* p, const float*)
      : phi(p[0]), mu(p[1]), sigma(p[2]), rho(p[3]),
        sd0(p[2] / sqrtf(1.0f - p[0] * p[0])),
        sd(p[2] * sqrtf(1.0f - p[3] * p[3])) {}

  template <class Rng>
  __device__ void init(Rng& rng, const float*, const float*,
                       float* x) const {
    x[0] = rng.normal() * sd0;
  }
  // the clamped transition mean: the transition's and the lookahead
  __device__ float mean(const float* x, const float* z) const {
    return clamp_state(mu + phi * (x[0] - mu) +
                       z[0] * rho * sigma * expf(-0.5f * x[0]));
  }
  template <class Rng>
  __device__ void propagate(Rng& rng, float* x, const float*,
                            const float* z) const {
    x[0] = mean(x, z) + sd * rng.normal();
  }
  __device__ void prop_mu(const float* x, const float*, const float* z,
                          float* out) const {
    out[0] = mean(x, z);
  }
  __device__ float log_weight(const float* x, const float* y,
                              const float*) const {
    const float z = y[0] * expf(-0.5f * x[0]);
    return -kHalfLog2Pi - 0.5f * x[0] - 0.5f * z * z;
  }
  __device__ float functional(const float* x) const { return x[0]; }
};

// Student-t observation SVOL; row (beta, phi, sigma, nu, c_nu), c_nu the
// t constant of the row's nu (ops/filter_megakernel.py
// svol_t_param_rows):
//   x' = phi x + sigma eps,   y = beta e^{x/2} t_nu.
struct SvolTModel {
  static constexpr int kNumParams = 5;
  static constexpr int kNumState = 1;
  static constexpr int kDimObs = 1;
  static constexpr int kDimCov = 0;
  static constexpr int kRowShared = 0;
  static constexpr bool kHasPropMu = true;
  static constexpr int kDraws = 1;

  float beta, phi, sigma, nu, c0, half_nu1;

  __device__ SvolTModel(const float* p, const float*)
      : beta(p[0]), phi(p[1]), sigma(p[2]), nu(p[3]),
        c0(p[4] - logf(p[0])), half_nu1(0.5f * (p[3] + 1.0f)) {}

  template <class Rng>
  __device__ void init(Rng& rng, const float*, const float*,
                       float* x) const {
    x[0] = rng.normal() * (sigma / sqrtf(1.0f - phi * phi));
  }
  template <class Rng>
  __device__ void propagate(Rng& rng, float* x, const float*,
                            const float*) const {
    x[0] = phi * x[0] + sigma * rng.normal();
  }
  __device__ void prop_mu(const float* x, const float*, const float*,
                          float* out) const {
    out[0] = phi * x[0];
  }
  __device__ float log_weight(const float* x, const float* y,
                              const float*) const {
    const float z = (y[0] / beta) * expf(-0.5f * x[0]);
    return (c0 - 0.5f * x[0]) - half_nu1 * log1pf(z * z / nu);
  }
  __device__ float functional(const float* x) const { return x[0]; }
};

// Poisson AR(1) counts; row (phi, mu, sigma), observation row
// (y, gammaln(y + 1)) (ops/filter_megakernel.py poisson_obs_rows):
//   x' = mu + phi (x - mu) + sigma eps,   y ~ Poisson(e^x).
struct PoissonArModel {
  static constexpr int kNumParams = 3;
  static constexpr int kNumState = 1;
  static constexpr int kDimObs = 2;
  static constexpr int kDimCov = 0;
  static constexpr int kRowShared = 0;
  static constexpr bool kHasPropMu = true;
  static constexpr int kDraws = 1;

  float phi, mu, sigma;

  __device__ PoissonArModel(const float* p, const float*)
      : phi(p[0]), mu(p[1]), sigma(p[2]) {}

  template <class Rng>
  __device__ void init(Rng& rng, const float*, const float*,
                       float* x) const {
    x[0] = mu + rng.normal() * (sigma / sqrtf(1.0f - phi * phi));
  }
  template <class Rng>
  __device__ void propagate(Rng& rng, float* x, const float*,
                            const float*) const {
    x[0] = mu + phi * (x[0] - mu) + sigma * rng.normal();
  }
  __device__ void prop_mu(const float* x, const float*, const float*,
                          float* out) const {
    out[0] = mu + phi * (x[0] - mu);
  }
  __device__ float log_weight(const float* x, const float* y,
                              const float*) const {
    return (y[0] * x[0] - expf(x[0])) - y[1];
  }
  __device__ float functional(const float* x) const { return x[0]; }
};

// Factor SVOL with kAssets assets and two factors, a two-leaf state;
// row [phi (2), mu (2), sigma (2), vec(L) (2 kAssets, row-major),
// d (kAssets)]:
//   x'_j = mu_j + phi_j (x_j - mu_j) + sigma_j eps_j,
//   y ~ N(0, L diag(e^x) L' + diag(d)).
// The explicit 2 x 2 Woodbury of the JAX instance: per row A = L' D^-1 L
// and sum log d (registers, from the row), per step v = L' D^-1 y and
// y' D^-1 y from the row's l1/d, l2/d and 1/d (shared memory: 3 kAssets
// floats would not fit in registers beside the rest), then a handful of
// operations per particle.  No lookahead, as in JAX.
template <int kAssets>
struct FactorSvolModel {
  static constexpr int kNumParams = 6 + 3 * kAssets;
  static constexpr int kNumState = 2;
  static constexpr int kDimObs = kAssets;
  static constexpr int kDimCov = 0;
  static constexpr int kRowShared = 3 * kAssets;
  static constexpr bool kHasPropMu = false;
  static constexpr int kDraws = 2;
  static constexpr float kConst =
      static_cast<float>(-kAssets * 0.9189385332046727);
  static constexpr int kD = 6 + 2 * kAssets;  // the first d column

  // [l1 / d (kAssets), l2 / d (kAssets), 1 / d (kAssets)]
  __device__ static float row_shared(const float* p, int j) {
    const int i = j % kAssets;
    const float dinv = 1.0f / p[kD + i];
    return j < kAssets ? p[6 + 2 * i] * dinv
                       : (j < 2 * kAssets ? p[7 + 2 * i] * dinv : dinv);
  }

  float phi[2], mu[2], sigma[2];
  float a11, a12, a22, sum_log_d;
  const float* s;

  __device__ FactorSvolModel(const float* p, const float* shared)
      : phi{p[0], p[1]}, mu{p[2], p[3]}, sigma{p[4], p[5]},
        a11(0.0f), a12(0.0f), a22(0.0f), sum_log_d(0.0f), s(shared) {
#pragma unroll
    for (int i = 0; i < kAssets; ++i) {
      const float l1 = p[6 + 2 * i], l2 = p[7 + 2 * i];
      const float dinv = 1.0f / p[kD + i];
      a11 = a11 + l1 * l1 * dinv;
      a12 = a12 + l1 * l2 * dinv;
      a22 = a22 + l2 * l2 * dinv;
      sum_log_d = sum_log_d + logf(p[kD + i]);
    }
  }

  template <class Rng>
  __device__ void init(Rng& rng, const float*, const float*,
                       float* x) const {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      x[j] = mu[j] + rng.normal() * (sigma[j] / sqrtf(1.0f - phi[j] * phi[j]));
  }
  template <class Rng>
  __device__ void propagate(Rng& rng, float* x, const float*,
                            const float*) const {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      x[j] = mu[j] + phi[j] * (x[j] - mu[j]) + sigma[j] * rng.normal();
  }
  __device__ float log_weight(const float* x, const float* y,
                              const float*) const {
    float v1 = 0.0f, v2 = 0.0f, yy = 0.0f;
#pragma unroll
    for (int i = 0; i < kAssets; ++i) {
      v1 = v1 + s[i] * y[i];
      v2 = v2 + s[kAssets + i] * y[i];
      yy = yy + y[i] * y[i] * s[2 * kAssets + i];
    }
    const float m11 = expf(-x[0]) + a11;
    const float m22 = expf(-x[1]) + a22;
    const float det = m11 * m22 - a12 * a12;
    const float quad_corr =
        (m22 * v1 * v1 - 2.0f * a12 * v1 * v2 + m11 * v2 * v2) / det;
    const float logdet = ((logf(det) + x[0]) + x[1]) + sum_log_d;
    return (kConst - 0.5f * logdet) - 0.5f * (yy - quad_corr);
  }
  __device__ float functional(const float* x) const { return x[0]; }
};

// The functor of a model id: f(Is<Functor>{}), or -1 for an unknown id.
// Both filter families dispatch through this one table
// (tests/test_torch_megakernel.py reads it).
template <class M>
struct Is {
  using type = M;
};

template <class F>
int with_model(int model_id, F&& f) {
  switch (model_id) {
    case kModelSvol: return f(Is<SvolModel>{});
    case kModelSvolLeverage: return f(Is<SvolLeverageModel>{});
    case kModelSvolT: return f(Is<SvolTModel>{});
    case kModelPoissonAr: return f(Is<PoissonArModel>{});
    case kModelFactorSvol3: return f(Is<FactorSvolModel<3>>{});
    case kModelFactorSvol4: return f(Is<FactorSvolModel<4>>{});
    case kModelFactorSvol5: return f(Is<FactorSvolModel<5>>{});
    default: return -1;
  }
}

}  // namespace ssme
