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
// A functor whose state lives in shared memory (kSharedState, below:
// independent AR(1) leaves) takes leafwise draws in place of init and
// propagate:
//   init_leaf (l, eps) -> float, propagate_leaf (l, x_l, eps) -> float
// on draw l of the particle's step (leaf l's normal).
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
constexpr int kModelFactorSvolSv10 = 7;  // "factor_svol_sv_10"

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

// The factor SVOL observation density y ~ N(0, L diag(e^x) L' + diag(d))
// by the explicit 2 x 2 Woodbury of the JAX instance, on a parameter row
// [phi (2), mu (2), sigma (2), vec(L) (2 kAssets, row-major), d
// (kAssets)], in the float operations of the plain hook
// (ops/filter_megakernel.py _factor_log_density).  Shared by K2's
// FactorSvolModel, which takes the pieces once a filter row, and K3's
// FactorSvolLW (lw_models.cuh), whose parameters are a particle's and
// move every step, so it takes them at every call:
//  - piece(p, j): [l1 / d (kAssets), l2 / d (kAssets), 1 / d (kAssets)]
//    entry j, the observation's weights in v = L' D^-1 y and y' D^-1 y;
//  - matrix(p, ...): A = L' D^-1 L and sum log d;
//  - log_density(...): a step's v and y' D^-1 y from the pieces, then
//    det and inverse of M = diag(e^-x) + A, a handful of operations.
template <int kAssets>
struct FactorWoodbury {
  static constexpr float kConst =
      static_cast<float>(-kAssets * 0.9189385332046727);
  static constexpr int kD = 6 + 2 * kAssets;  // the first d column

  __device__ static float piece(const float* p, int j) {
    const int i = j % kAssets;
    const float dinv = 1.0f / p[kD + i];
    return j < kAssets ? p[6 + 2 * i] * dinv
                       : (j < 2 * kAssets ? p[7 + 2 * i] * dinv : dinv);
  }
  __device__ static void matrix(const float* p, float& a11, float& a12,
                                float& a22, float& sum_log_d) {
    a11 = a12 = a22 = sum_log_d = 0.0f;
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
  // s: the pieces (piece(p, j) at s[j]), x: the two factors' state
  __device__ static float log_density(float a11, float a12, float a22,
                                      float sum_log_d, const float* s,
                                      const float* x, const float* y) {
    float v1 = 0.0f, v2 = 0.0f, yy = 0.0f;
#pragma unroll
    for (int i = 0; i < kAssets; ++i) {
      v1 = v1 + s[i] * y[i];
      v2 = v2 + s[kAssets + i] * y[i];
      yy = yy + y[i] * y[i] * s[2 * kAssets + i];
    }
    return solve(a11, a12, a22, sum_log_d, v1, v2, yy, x);
  }
  // the 2 x 2 part: det and inverse of M = diag(e^-x) + A, with v, y' D^-1
  // y and sum log d given (K2's FactorSvolSvModel feeds it a particle's
  // own D = diag(e^u))
  __device__ static float solve(float a11, float a12, float a22,
                                float sum_log_d, float v1, float v2,
                                float yy, const float* x) {
    const float m11 = expf(-x[0]) + a11;
    const float m22 = expf(-x[1]) + a22;
    const float det = m11 * m22 - a12 * a12;
    const float quad_corr =
        (m22 * v1 * v1 - 2.0f * a12 * v1 * v2 + m11 * v2 * v2) / det;
    const float logdet = ((logf(det) + x[0]) + x[1]) + sum_log_d;
    return (kConst - 0.5f * logdet) - 0.5f * (yy - quad_corr);
  }
};

// Factor SVOL with kAssets assets and two factors, a two-leaf state;
// row [phi (2), mu (2), sigma (2), vec(L) (2 kAssets, row-major),
// d (kAssets)]:
//   x'_j = mu_j + phi_j (x_j - mu_j) + sigma_j eps_j,
//   y ~ N(0, L diag(e^x) L' + diag(d)).
// The density is FactorWoodbury's: per row A = L' D^-1 L and sum log d
// (registers, from the row), per step v = L' D^-1 y and y' D^-1 y from
// the row's l1/d, l2/d and 1/d (shared memory: 3 kAssets floats would not
// fit in registers beside the rest), then a handful of operations per
// particle.  No lookahead, as in JAX.
template <int kAssets>
struct FactorSvolModel {
  using Density = FactorWoodbury<kAssets>;
  static constexpr int kNumParams = 6 + 3 * kAssets;
  static constexpr int kNumState = 2;
  static constexpr int kDimObs = kAssets;
  static constexpr int kDimCov = 0;
  static constexpr int kRowShared = 3 * kAssets;
  static constexpr bool kHasPropMu = false;
  static constexpr int kDraws = 2;

  // [l1 / d (kAssets), l2 / d (kAssets), 1 / d (kAssets)]
  __device__ static float row_shared(const float* p, int j) {
    return Density::piece(p, j);
  }

  float phi[2], mu[2], sigma[2];
  float a11, a12, a22, sum_log_d;
  const float* s;

  __device__ FactorSvolModel(const float* p, const float* shared)
      : phi{p[0], p[1]}, mu{p[2], p[3]}, sigma{p[4], p[5]}, s(shared) {
    Density::matrix(p, a11, a12, a22, sum_log_d);
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
    return Density::log_density(a11, a12, a22, sum_log_d, s, x, y);
  }
  __device__ float functional(const float* x) const { return x[0]; }
};

// Factor SV as Pitt & Shephard (1999) publish it, with kAssets assets and
// two factors: the idiosyncratic variances are stochastic too, so the
// state has 2 + kAssets leaves h = (f1, f2, u_1 .. u_kAssets), each an
// AR(1); row [phi (2 + kAssets), mu (2 + kAssets), sigma (2 + kAssets),
// vec(L) (2 kAssets, row-major)]:
//   h'_j = mu_j + phi_j (h_j - mu_j) + sigma_j eps_j,
//   y ~ N(0, L diag(e^f) L' + diag(e^u)).
// D = diag(e^u) is a particle's own, so A = L' D^-1 L, v = L' D^-1 y and
// y' D^-1 y are a particle's work every step (kAssets expf and six
// multiply-adds an asset, from the row's l1, l2, l1 l1, l1 l2 and l2 l2),
// then FactorWoodbury's 2 x 2 solve with sum u in place of sum log d; the
// float operations of the plain hook (ops/filter_megakernel.py
// factor_svol_sv_kernel_model, models/factor_svol.py
// two_factor_sv_log_g) in their order.  Each leaf is clamped to +-40
// (kStateClamp) after its draw, as the other SV functors' states are:
// e^{-u} of a runaway leaf would overflow.
// Registers: the particles' 12 leaves and carried log-weights live in
// shared memory (kSharedState: with the state in registers, four
// particles a thread spilled 252-372 bytes at 128 registers, the 12
// draws' Philox calls and the densities in flight), drawn leaf by leaf
// (init_leaf, propagate_leaf: the leaves' AR(1)s are independent), the
// density one particle at a time.  The row's constants live in shared
// memory too, a leaf's (phi, mu, sigma, its stationary sd) in one 16-byte
// word and an asset's (l1 l1, l1 l2, l2 l2, -) and (l1, l2) in the next 8
// words, read by volatile vector loads (lds4, lds2) in each hook call:
// with plain loads the compiler keeps all 108 in registers across the
// particles.  Systematic selection only (as every shared-state functor):
// the roll families keep every moved value in shared memory, and 13
// leaves' worth at kPer 16 would not fit.  No lookahead.
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}
__device__ __forceinline__ float2 lds2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

template <int kAssets>
struct FactorSvolSvModel {
  static constexpr int kLeaves = 2 + kAssets;
  static constexpr int kNumParams = 3 * (2 + kAssets) + 2 * kAssets;
  static constexpr int kNumState = 2 + kAssets;
  static constexpr int kDimObs = kAssets;
  static constexpr int kDimCov = 0;
  static constexpr int kRowShared = 4 * (2 + kAssets) + 8 * kAssets;
  static constexpr bool kHasPropMu = false;
  static constexpr bool kSharedState = true;
  static constexpr int kDraws = 2 + kAssets;
  // the first word of the loadings' block in the shared row
  static constexpr int kL = 4 * (2 + kAssets);

  // leaf j at 4 j: (phi, mu, sigma, sigma / sqrt(1 - phi^2)); asset i at
  // kL + 8 i: (l1 l1, l1 l2, l2 l2, 0, l1, l2, 0, 0)
  __device__ static float row_shared(const float* p, int j) {
    if (j < kL) {
      const int leaf = j / 4, c = j % 4;
      const float phi = p[leaf], sigma = p[2 * kLeaves + leaf];
      return c == 0 ? phi : c == 1 ? p[kLeaves + leaf] : c == 2 ? sigma
                          : sigma / sqrtf(1.0f - phi * phi);
    }
    const int i = (j - kL) / 8, c = (j - kL) % 8;
    const float l1 = p[3 * kLeaves + 2 * i], l2 = p[3 * kLeaves + 2 * i + 1];
    return c == 0 ? l1 * l1 : c == 1 ? l1 * l2 : c == 2 ? l2 * l2
         : c == 4 ? l1 : c == 5 ? l2 : 0.0f;
  }

  const float* s;

  __device__ FactorSvolSvModel(const float*, const float* shared)
      : s(shared) {}

  // the leafwise hooks of a shared-state functor: leaf l from the
  // stationary law, and its AR(1) transition, on normal eps
  __device__ float init_leaf(int l, float eps) const {
    const float4 c = lds4(s + 4 * l);  // phi, mu, sigma, stationary sd
    return clamp_state(c.y + eps * c.w);
  }
  __device__ float propagate_leaf(int l, float x, float eps) const {
    const float4 c = lds4(s + 4 * l);
    return clamp_state(c.y + c.x * (x - c.y) + c.z * eps);
  }
  __device__ float log_weight(const float* x, const float* y,
                              const float*) const {
    float a11 = 0.0f, a12 = 0.0f, a22 = 0.0f, v1 = 0.0f, v2 = 0.0f;
    float yy = 0.0f, sum_u = 0.0f;
#pragma unroll
    for (int i = 0; i < kAssets; ++i) {
      const float4 q = lds4(s + kL + 8 * i);  // l1 l1, l1 l2, l2 l2
      const float2 l = lds2(s + kL + 8 * i + 4);  // l1, l2
      const float u = x[2 + i];
      const float dinv = expf(-u);
      a11 = a11 + q.x * dinv;
      a12 = a12 + q.y * dinv;
      a22 = a22 + q.z * dinv;
      const float yd = y[i] * dinv;
      v1 = v1 + l.x * yd;
      v2 = v2 + l.y * yd;
      yy = yy + y[i] * yd;
      sum_u = sum_u + u;
    }
    return FactorWoodbury<kAssets>::solve(a11, a12, a22, sum_u, v1, v2, yy,
                                          x);
  }
  __device__ float functional(const float* x) const { return x[0]; }
};

// Whether a functor's state lives in shared memory between its hooks
// (kSharedState = true), else in registers; such a functor runs the
// systematic family's bootstrap only (its kernel model in
// ops/filter_megakernel.py sets systematic_only, and the wrapper refuses
// the roll resamplers before a launch)
template <class M, class = void>
struct SharedState {
  static constexpr bool value = false;
};
template <class M>
struct SharedState<M, decltype(void(M::kSharedState))> {
  static constexpr bool value = M::kSharedState;
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
    case kModelFactorSvolSv10: return f(Is<FactorSvolSvModel<10>>{});
    default: return -1;
  }
}

}  // namespace ssme
