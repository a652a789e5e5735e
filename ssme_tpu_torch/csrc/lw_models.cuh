// Model functors of the Liu-West filter kernel (lw_megakernel_sys.cuh):
// the CUDA counterparts of the LWKernelModel hooks of
// ssme_tpu/ops/liu_west_megakernel.py (svol_leverage_lw_kernel_model :739,
// svol_t_lw_kernel_model :792; factor SVOL, which JAX runs only through
// its generic filter, is new here), with the same float operations in the
// same order as the plain hooks of
// ssme_tpu_torch/ops/liu_west_megakernel.py.
//
// A model is a struct with
//   traits   kNumParams, kNumState, kDimObs, kDimCov, kNumFunctionals,
//            and code(k), the transform code of parameter k;
//   ctor     Model(const float* args): the call-time model constants;
//   init       (rng, cp, y, z, x)          t = 0 draw
//   propagate  (rng, cp, x, y, z)          transition, in place
//   prop_mu    (cp, x, y, z, out)          APF lookahead
//   log_weight (cp, x, y, z) -> float      log g(y | x)
//   functional (k, cp, x) -> float         whose filtered mean is emitted
// and, where kHasProposal is true, the SISR form's own proposal (JAX's
// optional LWKernelModel.sample_q / log_fq; APF never uses them):
//   sample_q   (rng, cp, x_anc, y, z, x_out)  draw x_out from q
//   log_fq     (cp, x_new, x_anc, y, z) -> float   log f - log q
// and the trait kDraws, the normals one init, propagate or sample_q call
// takes.  Unlike the bootstrap kernel's functors the parameters are per
// particle: each hook takes that particle's constrained cp[kNumParams].
// The hooks that draw are templates over the rng (step_rng.cuh: PairRng /
// PairSines through for_pair), which hands out the step's normals from
// draw kNumParams on
// (draws 0 .. P-1 are the kernel draws of theta;
// ssme_tpu_torch/ops/_prng.py).
#pragma once

#include <cstdint>

#include "kernel_models.cuh"
#include "step_rng.cuh"

namespace ssme {

// Model ids of ssme_lw_megakernel's dispatch.  The Python side
// (ssme_tpu_torch/ops/liu_west_megakernel.py::CUDA_LW_MODEL_IDS) holds the
// same numbers under the quoted names; a CPU test parses these lines.
constexpr int kLWModelSvolLeverage = 0;  // "svol_leverage_lw"
constexpr int kLWModelSvolT = 1;         // "svol_t_lw"
constexpr int kLWModelSvolLeverageQ = 2;  // "svol_leverage_lw_q"
constexpr int kLWModelFactorSvol5 = 3;    // "factor_svol_5_lw"

// transform codes (ssme_tpu_torch/transforms.py numbering)
constexpr int kTransNull = 0;
constexpr int kTransLog = 1;
constexpr int kTransLogit = 2;
constexpr int kTransTwiceFisher = 3;

// constrained -> transformed, the Pallas kernel's float operations
__device__ __forceinline__ float to_transformed(int code, float p) {
  switch (code) {
    case kTransLog: return logf(p);
    case kTransLogit: return logf(p) - log1pf(-p);
    case kTransTwiceFisher: return log1pf(p) - log1pf(-p);
    default: return p;
  }
}

// transformed -> constrained
__device__ __forceinline__ float to_constrained(int code, float z) {
  switch (code) {
    case kTransLog: return expf(z);
    case kTransLogit: return 1.0f / (1.0f + expf(-z));
    case kTransTwiceFisher: return tanhf(0.5f * z);
    default: return z;
  }
}

// SVOL with leverage; (phi, mu, sigma, rho), covariate z = the lagged
// observation:
//   x' = clamp(mu + phi (x - mu) + z rho sigma e^{-x/2}, +-40)
//        + sigma sqrt(1 - rho^2) eps,       y ~ N(0, e^x).
struct SvolLeverageLW {
  static constexpr int kNumParams = 4;
  static constexpr int kNumState = 1;
  static constexpr int kDimObs = 1;
  static constexpr int kDimCov = 1;
  static constexpr int kNumFunctionals = 0;
  static constexpr bool kHasProposal = false;
  static constexpr int kDraws = kNumState;  // normals per init/propagate
  __host__ __device__ static constexpr int code(int k) {
    constexpr int codes[kNumParams] = {  // "svol_leverage_lw"
        kTransLogit, kTransNull, kTransLog, kTransTwiceFisher};
    return codes[k];
  }

  __device__ explicit SvolLeverageLW(const float*) {}

  __device__ static float mean(const float* cp, float x, const float* z) {
    return clamp_state(cp[1] + cp[0] * (x - cp[1]) +
                       z[0] * cp[3] * cp[2] * expf(-0.5f * x));
  }
  template <class Rng>
  __device__ void init(Rng& rng, const float* cp, const float*,
                       const float*, float* x) const {
    const float sd0 = cp[2] / sqrtf(1.0f - cp[0] * cp[0]);
    x[0] = rng.normal() * sd0;
  }
  template <class Rng>
  __device__ void propagate(Rng& rng, const float* cp, float* x,
                            const float*, const float* z) const {
    const float m = mean(cp, x[0], z);
    const float sd = cp[2] * sqrtf(1.0f - cp[3] * cp[3]);
    x[0] = m + sd * rng.normal();
  }
  __device__ void prop_mu(const float* cp, const float* x, const float*,
                          const float* z, float* out) const {
    out[0] = mean(cp, x[0], z);
  }
  __device__ float log_weight(const float*, const float* x, const float* y,
                              const float*) const {
    const float zz = y[0] / expf(0.5f * x[0]);
    return (-kHalfLog2Pi - 0.5f * x[0]) - 0.5f * zz * zz;
  }
  __device__ float functional(int, const float*, const float*) const {
    return 0.0f;
  }
};

// Student-t observation SVOL; (beta, phi, sigma) at a fixed dof nu:
//   x' = phi x + sigma eps,   y = beta e^{x/2} t_nu.
// args: (c_nu, nu, (nu + 1) / 2), c_nu computed in double on the host.
struct SvolTLW {
  static constexpr int kNumParams = 3;
  static constexpr int kNumState = 1;
  static constexpr int kDimObs = 1;
  static constexpr int kDimCov = 0;
  static constexpr int kNumFunctionals = 1;
  static constexpr bool kHasProposal = false;
  static constexpr int kDraws = kNumState;  // normals per init/propagate
  __host__ __device__ static constexpr int code(int k) {
    constexpr int codes[kNumParams] = {  // "svol_t_lw"
        kTransLog, kTransTwiceFisher, kTransLog};
    return codes[k];
  }

  float c_nu, nu, half_nu1;

  __device__ explicit SvolTLW(const float* args)
      : c_nu(args[0]), nu(args[1]), half_nu1(args[2]) {}

  template <class Rng>
  __device__ void init(Rng& rng, const float* cp, const float*,
                       const float*, float* x) const {
    x[0] = rng.normal() * (cp[2] / sqrtf(1.0f - cp[1] * cp[1]));
  }
  template <class Rng>
  __device__ void propagate(Rng& rng, const float* cp, float* x,
                            const float*, const float*) const {
    // one product fused, the other rounded, written out: left to the
    // compiler, the fused product depended on where the normal came from,
    // and the two layouts of lw_megakernel_sys.cuh rounded apart
    x[0] = fmaf(cp[2], rng.normal(), __fmul_rn(cp[1], x[0]));
  }
  __device__ void prop_mu(const float* cp, const float* x, const float*,
                          const float*, float* out) const {
    out[0] = cp[1] * x[0];
  }
  __device__ float log_weight(const float* cp, const float* x, const float* y,
                              const float*) const {
    const float zval = (y[0] / cp[0]) * expf(-0.5f * x[0]);
    return ((c_nu - logf(cp[0])) - 0.5f * x[0]) -
           half_nu1 * log1pf(zval * zval / nu);
  }
  // the filtered mean log-volatility
  __device__ float functional(int, const float*, const float* x) const {
    return x[0];
  }
};

// SvolLeverageLW with a SISR proposal of its own: the transition widened by
// a call-time factor kappa, x' ~ N(mean_f, (kappa sd)^2) with sd = sigma
// sqrt(1 - rho^2), and log_fq the log ratio of the two normal densities.
// The test vehicle of the kernel's sample_q / log_fq path (no JAX instance
// sets those hooks).  At kappa = 1 its draws, weights and evidence are the
// plain SISR path's bit for bit.  args: (kappa).
struct SvolLeverageQLW {
  static constexpr int kNumParams = 4;
  static constexpr int kNumState = 1;
  static constexpr int kDimObs = 1;
  static constexpr int kDimCov = 1;
  static constexpr int kNumFunctionals = 0;
  static constexpr bool kHasProposal = true;
  static constexpr int kDraws = kNumState;  // per init/propagate/sample_q
  __host__ __device__ static constexpr int code(int k) {
    constexpr int codes[kNumParams] = {  // "svol_leverage_lw_q"
        kTransLogit, kTransNull, kTransLog, kTransTwiceFisher};
    return codes[k];
  }

  SvolLeverageLW base;
  float kappa;

  __device__ explicit SvolLeverageQLW(const float* args)
      : base(args), kappa(args[0]) {}

  template <class Rng>
  __device__ void init(Rng& rng, const float* cp, const float* y,
                       const float* z, float* x) const {
    base.init(rng, cp, y, z, x);
  }
  template <class Rng>
  __device__ void propagate(Rng& rng, const float* cp, float* x,
                            const float* y, const float* z) const {
    base.propagate(rng, cp, x, y, z);
  }
  __device__ void prop_mu(const float* cp, const float* x, const float* y,
                          const float* z, float* out) const {
    base.prop_mu(cp, x, y, z, out);
  }
  __device__ float log_weight(const float* cp, const float* x,
                              const float* y, const float* z) const {
    return base.log_weight(cp, x, y, z);
  }
  __device__ float functional(int, const float*, const float*) const {
    return 0.0f;
  }
  template <class Rng>
  __device__ void sample_q(Rng& rng, const float* cp, const float* x_anc,
                           const float*, const float* z, float* x) const {
    const float m = SvolLeverageLW::mean(cp, x_anc[0], z);
    const float sd = cp[2] * sqrtf(1.0f - cp[3] * cp[3]);
    x[0] = m + (kappa * sd) * rng.normal();
  }
  __device__ float log_fq(const float* cp, const float* x_new,
                          const float* x_anc, const float*,
                          const float* z) const {
    const float d = x_new[0] - SvolLeverageLW::mean(cp, x_anc[0], z);
    const float sd = cp[2] * sqrtf(1.0f - cp[3] * cp[3]);
    const float sq = kappa * sd;
    const float ef = d / sd;
    const float eq = d / sq;
    return (-logf(sd) - 0.5f * ef * ef) - (-logf(sq) - 0.5f * eq * eq);
  }
};

// Two-factor SVOL over 5 assets (K2's FactorSvolModel<5>,
// kernel_models.cuh), learned online: each particle carries its own 21
// parameters [phi (2), mu (2), sigma (2), vec(L) (10, row-major), d (5)]
// under the transforms of models/factor_svol.py, a two-leaf state (the
// factors' log-volatilities) and a 5-column observation:
//   x'_j = mu_j + phi_j (x_j - mu_j) + sigma_j eps_j,
//   y ~ N(0, L diag(e^x) L' + diag(d)),
// the density FactorWoodbury<5>'s, its pieces taken from the particle's
// parameters at every call (Liu-West moves them every step; K2 takes them
// once a row).  The lookahead is the transition's mean, the functionals
// the two factors' log-volatilities.  The state and the lookahead are
// clamped to +-40 (kStateClamp, the leverage model's bound): the kernel
// draws move sigma and mu freely, and a factor the data hardly identify
// walked to x = -83 in 313 steps at N = 1024 (sigma 7), where e^-x
// overflows float32 and the density turns NaN; past 40 a factor's
// variance, e^-40 or e^40 of the others', changes no density in float32.  Only the 5-asset count is compiled,
// as K2 compiles the counts it has; at 21 parameters the systematic
// family runs it through its wide row (lw_megakernel_sys.cuh
// lw_wide_row).  The means are rounded as the plain hooks round them, and
// each draw's product fused once, written out so that every compilation
// rounds alike.
struct FactorSvolLW {
  static constexpr int kNumParams = 21;
  static constexpr int kNumState = 2;
  static constexpr int kDimObs = 5;
  static constexpr int kDimCov = 0;
  static constexpr int kNumFunctionals = 2;
  static constexpr bool kHasProposal = false;
  static constexpr int kDraws = kNumState;  // normals per init/propagate
  static constexpr int kAssets = kDimObs;
  using Density = FactorWoodbury<kAssets>;
  __host__ __device__ static constexpr int code(int k) {
    constexpr int codes[kNumParams] = {  // "factor_svol_5_lw"
        kTransTwiceFisher, kTransTwiceFisher, kTransNull, kTransNull,
        kTransLog, kTransLog,
        kTransNull, kTransNull, kTransNull, kTransNull, kTransNull,
        kTransNull, kTransNull, kTransNull, kTransNull, kTransNull,
        kTransLog, kTransLog, kTransLog, kTransLog, kTransLog};
    return codes[k];
  }

  __device__ explicit FactorSvolLW(const float*) {}

  // factor j's transition mean mu_j + phi_j (x_j - mu_j), unclamped
  __device__ static float mean(const float* cp, const float* x, int j) {
    return __fadd_rn(cp[2 + j], __fmul_rn(cp[j], __fsub_rn(x[j], cp[2 + j])));
  }
  template <class Rng>
  __device__ void init(Rng& rng, const float* cp, const float*,
                       const float*, float* x) const {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      x[j] = fmaf(rng.normal(), cp[4 + j] / sqrtf(1.0f - cp[j] * cp[j]),
                  cp[2 + j]);
  }
  template <class Rng>
  __device__ void propagate(Rng& rng, const float* cp, float* x,
                            const float*, const float*) const {
    float m[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) m[j] = mean(cp, x, j);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      x[j] = clamp_state(fmaf(cp[4 + j], rng.normal(), m[j]));
  }
  __device__ void prop_mu(const float* cp, const float* x, const float*,
                          const float*, float* out) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) out[j] = clamp_state(mean(cp, x, j));
  }
  __device__ float log_weight(const float* cp, const float* x,
                              const float* y, const float*) const {
    float s[3 * kAssets];
#pragma unroll
    for (int j = 0; j < 3 * kAssets; ++j) s[j] = Density::piece(cp, j);
    float a11, a12, a22, sum_log_d;
    Density::matrix(cp, a11, a12, a22, sum_log_d);
    return Density::log_density(a11, a12, a22, sum_log_d, s, x, y);
  }
  // the filtered mean log-volatility of factor k
  __device__ float functional(int k, const float*, const float* x) const {
    return x[k];
  }
};

}  // namespace ssme
