// Generic whole-sequence filter bank for Hopper: one template kernel over
// model functors (kernel_models.cuh) and the filtering mode.
//
// Replaces ssme_tpu/ops/filter_megakernel.py::filter_megakernel (the Pallas
// body _make_kernel): B filters over T observations, with optional
// covariates, in ONE launch, the particle cloud never leaving the chip.
// Instances: svol, svol_leverage, svol_t, poisson_ar and factor_svol at 3,
// 4 and 5 assets (kernel_models.cuh), chosen at run time by a model id;
// each in bootstrap mode and, where the functor has a lookahead, APF mode.
// The mode is a template parameter, so the bootstrap instances compile
// without the APF branch.
//
// Layout: as svol_filter.cu.  One CTA per filter row, one particle per
// thread (blockDim = N, a multiple of 32, at most 1024).  The state
// leaves and the carried log-weight live in registers for all T steps;
// shared memory holds one CDF, one gather buffer reused leaf by leaf, the
// reduction scratch and the functor's per-row constants (factor_svol's
// l/d and 1/d).  ys (T, dim_obs) and zs (T, dim_cov) are read row-major
// from global memory, one broadcast load per step (zs is null when
// dim_cov = 0).  __launch_bounds__(1024, 1) caps a thread at 64
// registers.
//
// What bounds it: per-step latency of block barriers, not bytes, as in
// svol_filter.cu.  Each of the T sequential steps costs one max and one
// three-way sum reduction (plus a scan and a gather per leaf when it
// resamples) and the model's transcendentals; APF adds a max, a scan, a
// gather per leaf and two more densities every step.
//
// Per step it computes what _make_kernel computes:
//   t = 0   init (the model's init hook), lw = 0, carry = log N;
//   bootstrap, t > 0:
//           gate_stride 1: resample (always, or when ESS < tau N) THEN
//           propagate; gate_stride g > 1: propagate only;
//           lw += log_weight(x, y_t, z_t);
//   apf, t > 0 (every step; the ESS gate is ignored, g = 1):
//           look = prop_mu(x), fsw = lw + log_weight(look), a systematic
//           selection of the state on exp(fsw - max) with the step's
//           resampling offset (tag 1, unused otherwise in this mode),
//           LSE(fsw) from the scan's total; the lookahead recomputed at
//           the selected state (with an exact gather it is the gathered
//           lookahead, bit for bit, so only the state leaves move), its
//           density re-evaluated; propagate; lw = log_weight(x') -
//           log_weight(look);
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
//    tile and pads B with a real row; there is no tile here);
//  - the loop runs to T exactly: no padded steps, so the padded-step wipe
//    of the TPU kernel at T mod 128 in [1, g-1] cannot occur;
//  - steps_per_cell, substep_regions and the (N, N) lt matrix are TPU
//    artefacts and have no counterpart;
//  - random numbers are Philox4x32-10 (philox.cuh), not the TPU's;
//  - the APF selection moves the state leaves only and recomputes the
//    lookahead (the TPU gathers both, in bf16, and re-evaluates the
//    density for that reason);
//  - the hooks are compiled functors, so only the instances in
//    kernel_models.cuh run here, each with its one functional (the TPU
//    traces any Python hook, and a vector of functionals, into the
//    kernel).
#include <cstdint>

#include <cuda_runtime.h>

#include "kernel_models.cuh"
#include "philox.cuh"
#include "systematic_select.cuh"

namespace {

constexpr int kMaxParticles = 1024;

template <int kDim>
__device__ __forceinline__ void load_row(const float* src, int t, float* dst) {
#pragma unroll
  for (int j = 0; j < kDim; ++j) dst[j] = src[t * kDim + j];
}

template <class Model, bool kApf>
__global__ void __launch_bounds__(kMaxParticles, 1)
filter_megakernel(const int64_t* __restrict__ seed,
                  const float* __restrict__ params,
                  const float* __restrict__ ys,
                  const float* __restrict__ zs, int num_steps,
                  float ess_limit, int always, int gate_stride,
                  float* __restrict__ total, float* __restrict__ lcl,
                  float* __restrict__ fmean, float* __restrict__ cloud,
                  float* __restrict__ cloud_lw) {
  constexpr int kLeaves = Model::kNumState;
  constexpr int kObs = Model::kDimObs;
  constexpr int kCov = Model::kDimCov;
  __shared__ float cdf[kMaxParticles];
  __shared__ float buf[kMaxParticles];
  __shared__ float red[3 * 32];
  __shared__ float row_shared[Model::kRowShared > 0 ? Model::kRowShared : 1];

  const uint32_t b = blockIdx.x;
  const uint32_t i = threadIdx.x;
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const float* row = params + static_cast<size_t>(b) * Model::kNumParams;
  if constexpr (Model::kRowShared > 0) {
    for (int j = i; j < Model::kRowShared; j += blockDim.x)
      row_shared[j] = Model::row_shared(row, j);
    __syncthreads();
  }
  const Model model(row, row_shared);
  const float log_n = logf(static_cast<float>(blockDim.x));
  float* lcl_row = lcl + static_cast<size_t>(b) * num_steps;
  float* fmean_row = fmean + static_cast<size_t>(b) * num_steps;

  float y[kObs];
  float z[kCov > 0 ? kCov : 1];
  float x[kLeaves];
  load_row<kObs>(ys, 0, y);
  load_row<kCov>(zs, 0, z);
  {
    ssme::StepRng rng{k0, k1, i, 0u, b, 0u};
    model.init(rng, y, z, x);
  }
  float lw = 0.0f;
  float carry = log_n;
  float wn = 1.0f;            // exp(lw) after the last check
  float s_last = 1.0f;        // sum and sum of squares of wn at that check
  float s2_last = 1.0f;
  float lse_fs = 0.0f;        // apf: LSE of the step's first-stage weights
  float row_total = 0.0f;

  for (int t = 0; t < num_steps; ++t) {
    if (t > 0) {
      load_row<kObs>(ys, t, y);
      load_row<kCov>(zs, t, z);
      if constexpr (kApf) {
        float look[kLeaves];
        model.prop_mu(x, y, z, look);
        const float fsw = lw + model.log_weight(look, y, z);
        const float m_fs = ssme::block_max(fsw, red);
        const int anc = ssme::systematic_ancestor(
            expf(fsw - m_fs), ssme::offset_at(k0, k1, t, b), cdf, red);
        lse_fs = m_fs + logf(cdf[blockDim.x - 1]);
        ssme::gather_leaves<kLeaves>(x, anc, buf);
        model.prop_mu(x, y, z, look);
        const float lg_look = model.log_weight(look, y, z);
        ssme::StepRng rng{k0, k1, i, static_cast<uint32_t>(t), b, 0u};
        model.propagate(rng, x, y, z);
        lw = model.log_weight(x, y, z) - lg_look;
      } else {
        if (gate_stride == 1 &&
            (always || s_last * s_last / s2_last < ess_limit)) {
          const int anc = ssme::systematic_ancestor(
              wn, ssme::offset_at(k0, k1, t, b), cdf, red);
          ssme::gather_leaves<kLeaves>(x, anc, buf);
          lw = 0.0f;
          carry = log_n;
        }
        ssme::StepRng rng{k0, k1, i, static_cast<uint32_t>(t), b, 0u};
        model.propagate(rng, x, y, z);
      }
    }
    if (!kApf || t == 0) lw = lw + model.log_weight(x, y, z);

    const bool check = gate_stride == 1 || t % gate_stride == gate_stride - 1
                       || t == num_steps - 1;
    if (!check) {
      if (i == 0) {
        lcl_row[t] = 0.0f;
        fmean_row[t] = 0.0f;
      }
      continue;
    }
    const float m = ssme::block_max(lw, red);
    wn = expf(lw - m);
    const float3 r = ssme::block_sum3(wn, model.functional(x) * wn,
                                      wn * wn, red);
    const float step_lcl =
        (kApf && t > 0) ? ((lse_fs - carry) + (m + logf(r.x))) - log_n
                        : (m + logf(r.x)) - carry;
    lw = lw - m;
    carry = logf(r.x);
    s_last = r.x;
    s2_last = r.z;
    if (i == 0) {
      lcl_row[t] = step_lcl;
      fmean_row[t] = r.y / r.x;
    }
    row_total += step_lcl;
    if (gate_stride > 1 && r.x * r.x / r.z < ess_limit) {
      const int anc = ssme::systematic_ancestor(
          wn, ssme::offset_at(k0, k1, t, b), cdf, red);
      ssme::gather_leaves<kLeaves>(x, anc, buf);
      lw = 0.0f;
      carry = log_n;
    }
  }
  if (i == 0) total[b] = row_total;
  if (cloud != nullptr) {
    const size_t rows = gridDim.x;
    const size_t at = static_cast<size_t>(b) * blockDim.x + i;
#pragma unroll
    for (int l = 0; l < kLeaves; ++l)
      cloud[static_cast<size_t>(l) * rows * blockDim.x + at] = x[l];
    cloud_lw[at] = lw;
  }
}

// the launch's arguments, as the C entry point receives them
struct Launch {
  const int64_t* seed;
  const float* params;
  const float* ys;
  const float* zs;
  int num_rows, num_steps, num_particles;
  float ess_limit;
  int always, gate_stride;
  float *total, *lcl, *fmean, *cloud, *cloud_lw;
  cudaStream_t stream;
};

template <class Model, bool kApf>
void launch(const Launch& a) {
  filter_megakernel<Model, kApf><<<a.num_rows, a.num_particles, 0, a.stream>>>(
      a.seed, a.params, a.ys, a.zs, a.num_steps, a.ess_limit, a.always,
      a.gate_stride, a.total, a.lcl, a.fmean, a.cloud, a.cloud_lw);
}

// -2: APF mode for a functor without a lookahead
template <class Model>
int dispatch(int apf, const Launch& a) {
  if (apf) {
    if constexpr (Model::kHasPropMu) {
      launch<Model, true>(a);
    } else {
      return -2;
    }
  } else {
    launch<Model, false>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers the caller allocated; zs is null for a model without
// covariates, cloud and cloud_lw are null unless the final cloud is
// wanted (cloud: (kNumState, B, N), cloud_lw: (B, N)).  apf = 1 selects
// the APF mode.  The kernel allocates nothing and runs on `stream`.
// Returns cudaGetLastError() after the launch, -1 for an unknown model id
// or -2 for APF mode on a model without a lookahead.
extern "C" int ssme_filter_megakernel(int model_id, int apf,
                                      const int64_t* seed,
                                      const float* params, const float* ys,
                                      const float* zs, int num_rows,
                                      int num_steps, int num_particles,
                                      float ess_limit, int always,
                                      int gate_stride, float* total,
                                      float* lcl, float* fmean, float* cloud,
                                      float* cloud_lw, void* stream) {
  const Launch a{seed, params, ys, zs, num_rows, num_steps, num_particles,
                 ess_limit, always, gate_stride, total, lcl, fmean, cloud,
                 cloud_lw, static_cast<cudaStream_t>(stream)};
  switch (model_id) {
    case ssme::kModelSvol:
      return dispatch<ssme::SvolModel>(apf, a);
    case ssme::kModelSvolLeverage:
      return dispatch<ssme::SvolLeverageModel>(apf, a);
    case ssme::kModelSvolT:
      return dispatch<ssme::SvolTModel>(apf, a);
    case ssme::kModelPoissonAr:
      return dispatch<ssme::PoissonArModel>(apf, a);
    case ssme::kModelFactorSvol3:
      return dispatch<ssme::FactorSvolModel<3>>(apf, a);
    case ssme::kModelFactorSvol4:
      return dispatch<ssme::FactorSvolModel<4>>(apf, a);
    case ssme::kModelFactorSvol5:
      return dispatch<ssme::FactorSvolModel<5>>(apf, a);
    default:
      return -1;
  }
}
