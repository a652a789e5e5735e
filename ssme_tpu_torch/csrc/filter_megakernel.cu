// Generic whole-sequence bootstrap filter bank for Hopper: one template
// kernel over model functors (kernel_models.cuh).
//
// Replaces the bootstrap mode of
// ssme_tpu/ops/filter_megakernel.py::filter_megakernel (the Pallas body
// _make_kernel): B filters over T observations, with optional
// covariates, in ONE launch, the particle cloud never leaving the chip.
// Instances: svol and svol_leverage (kernel_models.cuh), chosen at run
// time by a model id.
//
// Layout: as svol_filter.cu.  One CTA per filter row, one particle per
// thread (blockDim = N, a multiple of 32, at most 1024).  The state
// leaves and the carried log-weight live in registers for all T steps;
// shared memory holds one CDF, one gather buffer reused leaf by leaf and
// the reduction scratch.  ys (T, dim_obs) and zs (T, dim_cov) are read
// row-major from global memory, one broadcast load per step (zs is null
// when dim_cov = 0).  __launch_bounds__(1024, 1) caps a thread at 64
// registers.
//
// What bounds it: per-step latency of block barriers, not bytes, as in
// svol_filter.cu.  Each of the T sequential steps costs one max and one
// three-way sum reduction (plus a scan and a gather per leaf when it
// resamples) and the model's transcendentals; the leverage instance adds
// one exp in the transition mean.
//
// Per step it computes what _make_kernel's bootstrap mode computes:
//   t = 0   init (the model's init hook), lw = 0, carry = log N;
//   t > 0   gate_stride 1: resample (always, or when ESS < tau N) THEN
//           propagate; gate_stride g > 1: propagate only;
//   weight  lw += log_weight(x, y_t, z_t);
//   check   (every step at g = 1; at t = g-1 mod g and t = T-1 otherwise)
//           lcl = LSE(lw) - carry, fmean = the filtered mean of the
//           model's functional under the full carried weights,
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
//  - the hooks are compiled functors, so only the instances in
//    kernel_models.cuh run here (the TPU traces any Python hook into the
//    kernel); APF mode and vector functionals are not ported yet.
#include <cstdint>

#include <cuda_runtime.h>

#include "kernel_models.cuh"
#include "philox.cuh"
#include "systematic_select.cuh"

namespace {

constexpr int kMaxParticles = 1024;

template <class Model>
__device__ __forceinline__ void load_step(const float* ys, const float* zs,
                                          int t, float* y, float* z) {
#pragma unroll
  for (int j = 0; j < Model::kDimObs; ++j) y[j] = ys[t * Model::kDimObs + j];
#pragma unroll
  for (int j = 0; j < Model::kDimCov; ++j) z[j] = zs[t * Model::kDimCov + j];
}

template <class Model>
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
  __shared__ float cdf[kMaxParticles];
  __shared__ float buf[kMaxParticles];
  __shared__ float red[3 * 32];

  const uint32_t b = blockIdx.x;
  const uint32_t i = threadIdx.x;
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const Model model(params + static_cast<size_t>(b) * Model::kNumParams);
  const float log_n = logf(static_cast<float>(blockDim.x));
  float* lcl_row = lcl + static_cast<size_t>(b) * num_steps;
  float* fmean_row = fmean + static_cast<size_t>(b) * num_steps;

  float y[Model::kDimObs];
  float z[Model::kDimCov > 0 ? Model::kDimCov : 1];
  float x[kLeaves];
  load_step<Model>(ys, zs, 0, y, z);
  {
    ssme::StepRng rng{k0, k1, i, 0u, b, 0u};
    model.init(rng, y, z, x);
  }
  float lw = 0.0f;
  float carry = log_n;
  float wn = 1.0f;            // exp(lw) after the last check
  float s_last = 1.0f;        // sum and sum of squares of wn at that check
  float s2_last = 1.0f;
  float row_total = 0.0f;

  for (int t = 0; t < num_steps; ++t) {
    if (t > 0) {
      load_step<Model>(ys, zs, t, y, z);
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
    lw = lw + model.log_weight(x, y, z);

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
    const float step_lcl = (m + logf(r.x)) - carry;
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

template <class Model>
void launch(const int64_t* seed, const float* params, const float* ys,
            const float* zs, int num_rows, int num_steps, int num_particles,
            float ess_limit, int always, int gate_stride, float* total,
            float* lcl, float* fmean, float* cloud, float* cloud_lw,
            cudaStream_t stream) {
  filter_megakernel<Model><<<num_rows, num_particles, 0, stream>>>(
      seed, params, ys, zs, num_steps, ess_limit, always, gate_stride, total,
      lcl, fmean, cloud, cloud_lw);
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers the caller allocated; zs is null for a model without
// covariates, cloud and cloud_lw are null unless the final cloud is
// wanted (cloud: (kNumState, B, N), cloud_lw: (B, N)).  The kernel
// allocates nothing and runs on `stream`.  Returns cudaGetLastError()
// after the launch, or -1 for an unknown model id.
extern "C" int ssme_filter_megakernel(int model_id, const int64_t* seed,
                                      const float* params, const float* ys,
                                      const float* zs, int num_rows,
                                      int num_steps, int num_particles,
                                      float ess_limit, int always,
                                      int gate_stride, float* total,
                                      float* lcl, float* fmean, float* cloud,
                                      float* cloud_lw, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (model_id) {
    case ssme::kModelSvol:
      launch<ssme::SvolModel>(seed, params, ys, zs, num_rows, num_steps,
                              num_particles, ess_limit, always, gate_stride,
                              total, lcl, fmean, cloud, cloud_lw, s);
      break;
    case ssme::kModelSvolLeverage:
      launch<ssme::SvolLeverageModel>(seed, params, ys, zs, num_rows,
                                      num_steps, num_particles, ess_limit,
                                      always, gate_stride, total, lcl, fmean,
                                      cloud, cloud_lw, s);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
