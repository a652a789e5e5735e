// The generic whole-sequence filter bank for Hopper: the launch arguments
// of its kernel template (filter_megakernel_sys.cuh) and the step
// recursion both selection families compute.
//
// Replaces ssme_tpu/ops/filter_megakernel.py::filter_megakernel (the Pallas
// body _make_kernel): B filters over T observations, with optional
// covariates, in ONE launch, the particle cloud never leaving the chip.
// Instances: svol, svol_leverage, svol_t, poisson_ar and factor_svol at 3,
// 4 and 5 assets (kernel_models.cuh), chosen at run time by a model id
// (ssme::with_model); each in bootstrap mode and, where the functor has a
// lookahead, APF mode; each under systematic selection (N a multiple of
// 32 up to 1024) and under the roll resamplers (roll_select.cuh:
// Metropolis or rejection, chosen at run time; N a power of two up to
// 4096).  filter_megakernel_sys.cuh has the layout, kPer neighbouring
// particles per thread on row_select.cuh, and what bounds it;
// filter_megakernel.cu holds the C entry points.  ys (T, dim_obs) and zs
// (T, dim_cov) are read row-major from global memory, one broadcast load
// per step (zs is null when dim_cov = 0).
//
// Per step it computes what _make_kernel computes:
//   t = 0   init (the model's init hook), lw = 0, carry = log N;
//   bootstrap, t > 0:
//           gate_stride 1: resample (always, or when ESS < tau N) THEN
//           propagate; gate_stride g > 1: propagate only;
//           lw += log_weight(x, y_t, z_t);
//   apf, t > 0 (every step; the ESS gate is ignored, g = 1):
//           look = prop_mu(x), fsw = lw + log_weight(look), a selection of
//           the state on exp(fsw - max): systematic with the step's
//           resampling offset (tag 1, unused otherwise in this mode) and
//           LSE(fsw) from the CDF's total, or a roll resampler on the
//           first-stage sweep tags and LSE(fsw) from a row sum; the
//           lookahead's density at the selected state (gathered with it,
//           the value the Pallas kernel re-evaluates there); propagate;
//           lw = log_weight(x') - log_weight(look);
//   check   (every step at g = 1; at t = g-1 mod g and t = T-1 otherwise)
//           lcl = LSE(lw) - carry (bootstrap and t = 0) or [LSE(fsw) -
//           carry] + [LSE(lw) - log N] (apf), fmean = the filtered mean of
//           the model's functional under the full carried weights,
//           renormalise (lw -= max, carry = log sum); at g > 1 the ESS
//           of the renormalised weights then gates a resample;
//   lcl and fmean are zero off the check columns;
//   with a cloud output, the state and the carried log-weights after the
//   last step.
//
// Intended divergences from the Pallas kernel:
//  - the ESS gate is per row (the TPU gates on the worst row of an 8-row
//    tile and pads B with a real row; there is no tile here), and so is
//    the rejection resampler's end (the TPU's tile ends when its 8 rows
//    are done; accepted slots freeze, so the law is the same);
//  - the loop runs to T exactly: no padded steps, so the padded-step wipe
//    of the TPU kernel at T mod 128 in [1, g-1] cannot occur;
//  - steps_per_cell, substep_regions and the (N, N) lt matrix are TPU
//    artefacts and have no counterpart;
//  - random numbers are Philox4x32-10 (philox.cuh), not the TPU's;
//  - the APF selection moves the state and the lookahead's density (the
//    TPU gathers state and lookahead, in bf16 under the systematic
//    selection, and re-evaluates the density for that reason);
//  - under g = 1 the bootstrap resamples step t + 1 at the end of step
//    t's check, on the same weights and states and with step t + 1's
//    offset or sweep draws (the same computation in another order);
//  - the hooks are compiled functors, so only the instances in
//    kernel_models.cuh run here, each with its one functional (the TPU
//    traces any Python hook, and a vector of functionals, into the
//    kernel).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "kernel_models.cuh"
#include "philox.cuh"
#include "roll_select.cuh"

namespace ssme_fmk {

// particles a row takes under systematic selection and under the roll
// resamplers
constexpr int kMaxSysParticles = 1024;
constexpr int kMaxRollParticles = 4096;

template <int kDim>
__device__ __forceinline__ void load_row(const float* src, int t, float* dst) {
#pragma unroll
  for (int j = 0; j < kDim; ++j) dst[j] = src[t * kDim + j];
}

// the launch's arguments, as the C entry point receives them
struct Launch {
  const int64_t* seed;
  const float* params;
  const float* ys;
  const float* zs;
  int num_rows, num_steps, num_particles;
  float ess_limit;
  int always, gate_stride, resampler, metropolis_iters;
  float *total, *lcl, *fmean, *cloud, *cloud_lw;
  cudaStream_t stream;
};

}  // namespace ssme_fmk
