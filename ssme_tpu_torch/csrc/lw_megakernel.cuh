// Whole-sequence Liu-West filter bank for Hopper: template kernels over
// model functors (lw_models.cuh) and the selection family.
//
// Replaces ssme_tpu/ops/liu_west_megakernel.py::lw_megakernel (the Pallas
// body _build_kernel) and, through its svol_leverage_lw instance,
// ssme_tpu/ops/svol_leverage_lw_kernel.py::svol_leverage_lw_pallas, to
// which that instance is bit-compatible in JAX.  F filters, each on a
// joint (state, theta) cloud of N particles, over T observations in ONE
// launch; the cloud never leaves the chip.  One template,
// lw_megakernel_sys.cuh, laid out for Hopper on row_select.cuh (kPer
// NEIGHBOURING particles per thread, j = kPer * threadIdx.x + p, paired
// Philox draws, the Cholesky on every thread, 8 barriers in an APF step
// that resamples; its note gives the design), in two families, one nvcc
// per file so that they build in parallel:
//  - systematic selection (N a multiple of 32 up to 1024), kPer 2, the
//    values in registers: lw_megakernel_sys.cu, one CTA a filter, and
//    lw_megakernel_sys_pair.cu, a cluster of two CTAs a filter, one of
//    which draws the step's random numbers for the other (lw_ring.cuh),
//    taken when the card holds every filter's cluster at once; a functor
//    of more than kRegParams parameters (factor_svol_5_lw's 21) runs the
//    wide row, theta and the moments in shared memory, in both layouts;
//  - the roll resamplers (roll_select.cuh: Metropolis or rejection, chosen
//    at run time; N a power of two up to 4096, JAX's
//    MAX_LW_METROPOLIS_PARTICLES), kPer 2, 4 and 8, the values in shared
//    memory: lw_megakernel_sys_roll{2,4,8}.cu.
// The Philox counters are keyed by the particle index, so the plain
// version's bits hold in every layout.  lw_megakernel.cu holds the C
// entry points.  ys (T, dim_obs) and zs (T, dim_cov) are read row-major
// from global memory.  The inputs are T floats, the outputs (F, T) and
// the final cloud.
//
// Per step it computes what _build_kernel computes:
//   t = 0   prior draw (uniform box, lo + (hi - lo) u), transform, init,
//           lw = log g, lcl = LSE(lw) - log N, functionals, then the
//           resample schedule;
//   t > 0   theta_bar = sum w theta / sum w and Vt = sum w (theta -
//           theta_bar)(theta - theta_bar)' / sum w, in two passes, with w
//           = exp(lw); L = chol(h^2 Vt), diagonal floored at 1e-9;
//           shrunk = a theta + (1 - a) theta_bar;
//     apf:  lookahead at the pre-shrinkage theta, first-stage weights
//           lw + log g(y, lookahead; shrunk), a selection on them
//           (systematic with offset tag 2^31 + 1, or a roll resampler on
//           the first-stage sweep tags) and a joint gather of (state,
//           lookahead density, shrunk) (roll: of state and theta, the
//           ancestor's density read where it was written and its shrunk
//           theta recomputed from its theta, the same bits);
//     both: theta' = shrunk_anc + L e (draws 0 .. P-1), the transition
//           (its normals from draw P on) or, under sisr with a functor
//           that has a proposal (kHasProposal), sample_q;
//     apf:  lw' = log g(y, x'; theta') - log g(y, lookahead_anc;
//           shrunk_anc), lcl = LSE(fsw) - LSE(lw) + LSE(lw') - log N;
//     sisr: lw' = lw + log g(y, x'; theta') (+ log_fq(x', x_anc), the
//           proposal's log f - log q), lcl = LSE(lw') - LSE(lw);
//   then    functionals under the normalised weights, lw' renormalised by
//           its maximum, and the joint (state, theta) resample on the
//           resample_every schedule or when ESS < ess_limit, lw' = 0.
//   Outputs: lcl (F, T), the functional paths (K, F, T), the final cloud
//   (F, S + 1 + P, N) rows [state x S, logw, theta x P].
//
// Intended divergences from the Pallas kernel:
//  - the ESS gate is per filter (as the Pallas kernel's one-filter grid
//    rows; there is no tile to share it);
//  - the loop runs to T exactly: no padded steps, no steps_per_cell;
//  - no (N, N) lt matrix, no compensated_cdf and no tile_seeds: the
//    systematic selection is the search and walk on the CDF of
//    row_select.cuh, the roll resamplers carry ancestor indices
//    (roll_select.cuh);
//  - no zero pad rows in the cloud (a TPU sublane artefact);
//  - random numbers are Philox4x32-10 (philox.cuh), not the TPU's;
//  - the log-weights are renormalised by their maximum after every step
//    (the conditional likelihoods are unchanged; the cloud's log-weight
//    row has maximum 0);
//  - the hooks are compiled functors, so only the instances of
//    lw_models.cuh run here (the SISR proposal too: a functor's sample_q
//    and log_fq, not any Python hook);
//  - the wide row's Cholesky leaves a column 0 below a pivot at or below
//    1e-4 of its diagonal (lw_megakernel_sys.cuh kRankRel), where float32
//    rounding would otherwise blow the factor up on a cloud that spans
//    fewer than P directions.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "lw_models.cuh"
#include "philox.cuh"

namespace ssme_lw {

constexpr int kMaxThreads = 1024;
constexpr int kMaxParams = 21;  // factor_svol_5_lw's 21
constexpr int kMaxModelArgs = 4;
constexpr float kEpsChol = 1e-9f;

// call-time arguments, passed by value
struct LWArgs {
  float a, one_minus_a, h2;     // kernel shrinkage, from delta on the host
  float prior_lo[kMaxParams];   // uniform prior box lo, hi - lo (float32)
  float prior_scale[kMaxParams];
  float model[kMaxModelArgs];   // the functor's constants
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <class Model>
__device__ __forceinline__ void load_step(const float* ys, const float* zs,
                                          int t, float* y, float* z) {
#pragma unroll
  for (int j = 0; j < Model::kDimObs; ++j) y[j] = ys[t * Model::kDimObs + j];
#pragma unroll
  for (int j = 0; j < Model::kDimCov; ++j) z[j] = zs[t * Model::kDimCov + j];
}

template <class Model>
__device__ __forceinline__ void constrain(const float* th, float* cp) {
#pragma unroll
  for (int k = 0; k < Model::kNumParams; ++k)
    cp[k] = ssme::to_constrained(Model::code(k), th[k]);
}

// the launch's arguments, as the C entry point receives them
struct LWLaunch {
  const int64_t* seed;
  const float* ys;
  const float* zs;
  int num_filters, num_steps, num_particles, apf, resample_every;
  float ess_limit;
  int resampler, metropolis_iters;
  float *lcl, *fpaths, *cloud;
  cudaStream_t stream;
  long long* spans = nullptr;  // a twin's record, or null
};

// Run<Model>::go(args...) for every model id; -1 for an unknown one
template <template <class> class Run, class... Args>
int dispatch_model(int model_id, const Args&... args) {
  switch (model_id) {
    case ssme::kLWModelSvolLeverage:
      return Run<ssme::SvolLeverageLW>::go(args...);
    case ssme::kLWModelSvolT:
      return Run<ssme::SvolTLW>::go(args...);
    case ssme::kLWModelSvolLeverageQ:
      return Run<ssme::SvolLeverageQLW>::go(args...);
    case ssme::kLWModelFactorSvol5:
      return Run<ssme::FactorSvolLW>::go(args...);
    default:
      return -1;
  }
}

}  // namespace ssme_lw
