// Generic whole-sequence filter bank for Hopper: model functors
// (kernel_models.cuh) over two kernel templates, one per selection family.
//
// Replaces ssme_tpu/ops/filter_megakernel.py::filter_megakernel (the Pallas
// body _make_kernel): B filters over T observations, with optional
// covariates, in ONE launch, the particle cloud never leaving the chip.
// Instances: svol, svol_leverage, svol_t, poisson_ar and factor_svol at 3,
// 4 and 5 assets (kernel_models.cuh), chosen at run time by a model id
// (ssme::with_model); each in bootstrap mode and, where the functor has a
// lookahead, APF mode.  The systematic family (N a multiple of 32 up to
// 1024) is filter_megakernel_sys.cuh: kPer neighbouring particles per
// thread on row_select.cuh, instances in filter_megakernel_sys{2,4}.cu.
// This header holds the launch arguments both families take and the roll
// family (roll_select.cuh: metropolis or rejection, chosen at run time),
// instances in filter_megakernel_roll{1,2,4}.cu, one file per kPer, so
// that nvcc builds them in parallel; filter_megakernel.cu holds the C
// entry point.
//
// Roll layout: one CTA per filter row, a power of two N up to 4096 with
// kPer = N / 1024 particles per thread above 1024 (blockDim = N / kPer):
// particle j = p * blockDim + threadIdx.x, so global loads and stores stay
// coalesced, and the reductions first fold a thread's kPer values.  Of the
// two designs that reach 4096 (kPer particles per thread, or a cluster of
// N / 1024 CTAs reading each other's shared memory) this one keeps every
// barrier inside one CTA and needs no cluster launch: the selection only
// reads the row's weights (16 KB at 4096) and gathers through one buffer
// of N floats, 32 KB of static shared memory in all, under the 48 KB that
// needs no opt-in.  The state leaves and the carried log-weights live in
// registers for all T steps; shared memory holds the roll resamplers'
// weights, one gather buffer reused leaf by leaf, the reduction scratch
// and the functor's per-row constants (factor_svol's l/d and 1/d).  ys (T,
// dim_obs) and zs (T, dim_cov) are read row-major from global memory, one
// broadcast load per step (zs is null when dim_cov = 0).
// __launch_bounds__(1024, 1) caps a thread at 64 registers.
//
// What bounds it: per-step latency of block barriers, not bytes, as in
// svol_filter.cu.  Each of the T sequential steps costs one max and one
// three-way sum reduction (plus, when it resamples, the roll sweeps:
// Philox draws per slot and, for rejection, one barrier per sweep) and the
// model's transcendentals; APF adds a max, a sum, a selection, a gather
// per leaf and two more densities every step.
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
//           first-stage sweep tags and LSE(fsw) from a block sum; the
//           lookahead recomputed at the selected state (with an exact
//           gather it is the gathered lookahead, bit for bit, so only the
//           state leaves move), its density re-evaluated; propagate; lw =
//           log_weight(x') - log_weight(look);
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
//  - the APF selection moves the state leaves only and recomputes the
//    lookahead (the TPU gathers both, in bf16 under the systematic
//    selection, and re-evaluates the density for that reason);
//  - the systematic family resamples step t + 1 at the end of step t's
//    check, on the same weights and states and with step t + 1's offset
//    (the same computation in another order, filter_megakernel_sys.cuh);
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

constexpr int kMaxThreads = 1024;

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

// the ancestors of this thread's particles on weights w under the roll
// resampler, on the sweep tags from tag_roll; every state leaf moved by
// them
template <int kPer, int kLeaves>
__device__ __forceinline__ void select_state(
    const float (&w)[kPer], float (&x)[kPer][kLeaves], int resampler,
    int metropolis_iters, uint32_t k0, uint32_t k1, uint32_t t, uint32_t b,
    uint32_t tag_roll, float* cdf, float* buf, float* red) {
  int anc[kPer];
  ssme::roll_ancestors<kPer>(resampler, metropolis_iters, w, cdf, red, k0, k1,
                             t, b, tag_roll, anc);
  ssme::gather_leaves_per<kLeaves, kPer>(x, anc, buf);
}

template <class Model, bool kApf, int kPer>
__global__ void __launch_bounds__(kMaxThreads, 1)
filter_megakernel(const int64_t* __restrict__ seed,
                  const float* __restrict__ params,
                  const float* __restrict__ ys,
                  const float* __restrict__ zs, int num_steps,
                  float ess_limit, int always, int gate_stride,
                  int resampler, int metropolis_iters,
                  float* __restrict__ total, float* __restrict__ lcl,
                  float* __restrict__ fmean, float* __restrict__ cloud,
                  float* __restrict__ cloud_lw) {
  constexpr int kLeaves = Model::kNumState;
  constexpr int kObs = Model::kDimObs;
  constexpr int kCov = Model::kDimCov;
  __shared__ float cdf[kMaxThreads * kPer];
  __shared__ float buf[kMaxThreads * kPer];
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
  const float log_n = logf(static_cast<float>(blockDim.x * kPer));
  float* lcl_row = lcl + static_cast<size_t>(b) * num_steps;
  float* fmean_row = fmean + static_cast<size_t>(b) * num_steps;

  float y[kObs];
  float z[kCov > 0 ? kCov : 1];
  float x[kPer][kLeaves];
  load_row<kObs>(ys, 0, y);
  load_row<kCov>(zs, 0, z);
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    ssme::StepRng rng{k0, k1, p * blockDim.x + i, 0u, b, 0u};
    model.init(rng, y, z, x[p]);
  }
  float lw[kPer];
  float wn[kPer];             // exp(lw) after the last check
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    lw[p] = 0.0f;
    wn[p] = 1.0f;
  }
  float carry = log_n;
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
        float fsw[kPer];
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          model.prop_mu(x[p], y, z, look);
          fsw[p] = lw[p] + model.log_weight(look, y, z);
        }
        float m_loc = fsw[0];
#pragma unroll
        for (int p = 1; p < kPer; ++p) m_loc = fmaxf(m_loc, fsw[p]);
        const float m_fs = ssme::block_max(m_loc, red);
        float w_fs[kPer];
#pragma unroll
        for (int p = 0; p < kPer; ++p) w_fs[p] = expf(fsw[p] - m_fs);
        float s_fs[1] = {w_fs[0]};
#pragma unroll
        for (int p = 1; p < kPer; ++p) s_fs[0] += w_fs[p];
        ssme::block_sum<1>(s_fs, red);
        lse_fs = m_fs + logf(s_fs[0]);
        select_state<kPer, kLeaves>(
            w_fs, x, resampler, metropolis_iters, k0, k1, t, b,
            ssme::kTagRollSelect, cdf, buf, red);
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          model.prop_mu(x[p], y, z, look);
          const float lg_look = model.log_weight(look, y, z);
          ssme::StepRng rng{k0, k1, p * blockDim.x + i,
                            static_cast<uint32_t>(t), b, 0u};
          model.propagate(rng, x[p], y, z);
          lw[p] = model.log_weight(x[p], y, z) - lg_look;
        }
      } else {
        if (gate_stride == 1 &&
            (always || s_last * s_last / s2_last < ess_limit)) {
          select_state<kPer, kLeaves>(
              wn, x, resampler, metropolis_iters, k0, k1, t, b,
              ssme::kTagRollSweep, cdf, buf, red);
#pragma unroll
          for (int p = 0; p < kPer; ++p) lw[p] = 0.0f;
          carry = log_n;
        }
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          ssme::StepRng rng{k0, k1, p * blockDim.x + i,
                            static_cast<uint32_t>(t), b, 0u};
          model.propagate(rng, x[p], y, z);
        }
      }
    }
    if (!kApf || t == 0) {
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        lw[p] = lw[p] + model.log_weight(x[p], y, z);
    }

    const bool check = gate_stride == 1 || t % gate_stride == gate_stride - 1
                       || t == num_steps - 1;
    if (!check) {
      if (i == 0) {
        lcl_row[t] = 0.0f;
        fmean_row[t] = 0.0f;
      }
      continue;
    }
    float m_loc = lw[0];
#pragma unroll
    for (int p = 1; p < kPer; ++p) m_loc = fmaxf(m_loc, lw[p]);
    const float m = ssme::block_max(m_loc, red);
    wn[0] = expf(lw[0] - m);
    float s0 = wn[0], s1 = model.functional(x[0]) * wn[0], s2 = wn[0] * wn[0];
#pragma unroll
    for (int p = 1; p < kPer; ++p) {
      wn[p] = expf(lw[p] - m);
      s0 += wn[p];
      s1 += model.functional(x[p]) * wn[p];
      s2 += wn[p] * wn[p];
    }
    const float3 r = ssme::block_sum3(s0, s1, s2, red);
    const float step_lcl =
        (kApf && t > 0) ? ((lse_fs - carry) + (m + logf(r.x))) - log_n
                        : (m + logf(r.x)) - carry;
#pragma unroll
    for (int p = 0; p < kPer; ++p) lw[p] = lw[p] - m;
    carry = logf(r.x);
    s_last = r.x;
    s2_last = r.z;
    if (i == 0) {
      lcl_row[t] = step_lcl;
      fmean_row[t] = r.y / r.x;
    }
    row_total += step_lcl;
    if (gate_stride > 1 && r.x * r.x / r.z < ess_limit) {
      select_state<kPer, kLeaves>(
          wn, x, resampler, metropolis_iters, k0, k1, t, b,
          ssme::kTagRollSweep, cdf, buf, red);
#pragma unroll
      for (int p = 0; p < kPer; ++p) lw[p] = 0.0f;
      carry = log_n;
    }
  }
  if (i == 0) total[b] = row_total;
  if (cloud != nullptr) {
    const size_t rows = gridDim.x;
    const size_t n = static_cast<size_t>(blockDim.x) * kPer;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const size_t at = static_cast<size_t>(b) * n + p * blockDim.x + i;
#pragma unroll
      for (int l = 0; l < kLeaves; ++l) cloud[l * rows * n + at] = x[p][l];
      cloud_lw[at] = lw[p];
    }
  }
}

template <class Model, bool kApf, int kPer>
void launch(const Launch& a) {
  filter_megakernel<Model, kApf, kPer>
      <<<a.num_rows, a.num_particles / kPer, 0, a.stream>>>(
          a.seed, a.params, a.ys, a.zs, a.num_steps, a.ess_limit, a.always,
          a.gate_stride, a.resampler, a.metropolis_iters, a.total, a.lcl,
          a.fmean, a.cloud, a.cloud_lw);
}

// the roll instances of every model id at kPer; -1 for an unknown id, -2
// for APF mode on a functor without a lookahead
template <int kPer>
int dispatch_roll(int model_id, int apf, const Launch& a) {
  return ssme::with_model(model_id, [&](auto is) -> int {
    using Model = typename decltype(is)::type;
    if (!apf) {
      launch<Model, false, kPer>(a);
    } else if constexpr (Model::kHasPropMu) {
      launch<Model, true, kPer>(a);
    } else {
      return -2;
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// the roll instances, one translation unit per kPer
// (filter_megakernel_roll{1,2,4}.cu)
int dispatch_roll1(int model_id, int apf, const Launch& a);
int dispatch_roll2(int model_id, int apf, const Launch& a);
int dispatch_roll4(int model_id, int apf, const Launch& a);

}  // namespace ssme_fmk
