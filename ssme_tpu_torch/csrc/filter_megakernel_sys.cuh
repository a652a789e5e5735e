// The generic filter kernel's systematic family, laid out for Hopper: B
// filters of one model functor (kernel_models.cuh) over T observations in
// ONE launch, bootstrap or APF, under systematic selection (N a multiple
// of 32 in [32, 1024], the JAX package's MAX_KERNEL_PARTICLES).
//
// Replaces ssme_tpu/ops/filter_megakernel.py::_make_kernel under
// select_leaves_dense.  The step recursion, its check columns and the
// intended divergences from the Pallas kernel are those of
// filter_megakernel.cuh's note (the roll family's kernel).  One change of
// order computes the same thing, as in svol_filter_sys.cu: under the
// bootstrap's every-step schedule (g = 1) the resample of step t + 1 runs
// at the end of step t's check, on the same weights and states and with
// step t + 1's offset.  And in APF mode the lookahead's log-density
// moves with the state through the selection's gather (exact), where the
// roll family recomputes it at the selected state: the same value.
//
// Layout: one CTA per row; thread i owns kPer NEIGHBOURING particles
// j = kPer * i + p (kPer = 2 or 4), blockDim = N / kPer rounded up to a
// warp, the lanes past N / kPer masked (N = 32 or 96 at kPer 2 leave part
// of a warp empty).  kPer per N is fixed in kper_for() from the grid
// measured on the card (PERF.md §6).  The state leaves and the carried
// log-weights live in registers for all T steps; the CDF and one gather
// buffer per state leaf, padded_size(N) floats each (row_select.cuh), in
// static shared memory (12.7 KB at N = 1024 with factor SVOL's two
// leaves), so a two-leaf gather rides the same barrier as a one-leaf one;
// the functor's per-row constants (kRowShared) beside them.  Instances:
// every functor, bootstrap and (with a lookahead) APF, at kPer 2 and 4,
// one file per kPer (filter_megakernel_sys{2,4}.cu); at most 256 threads
// and two CTAs an SM (B = 256 rows fill the 132 SMs in one wave).  The
// svol_leverage functor also has instrumented twins (kSpans) in both
// modes, which count the barriers a step crosses.
//
// What bounds it: per-step latency, not bytes.  The design cuts the
// step's chain as K1's (svol_filter_sys.cu) does:
//  - paired draws: particles 2q and 2q + 1 share Philox counter
//    (q, t, b, tag of draw k) and now share a thread, so one
//    philox4x32_10 call and one Box-Muller give draw k of both
//    (ssme::for_pair: the first particle's hook computes, the second's is
//    served the cached sine): the bits of ops/_prng.py normals_steps at
//    half the calls, for a functor of any number of draws (factor SVOL
//    takes two);
//  - barriers per step (row_select.cuh: one per exchange, the max's and
//    the sums' partial buffers alternating, so no leading barrier):
//      bootstrap: 3 in a step that resamples (the row max; the three
//      sums, with the warps' CDF totals riding the same exchange; the CDF
//      and gather buffers), 2 at a check that does not, 0 in a step
//      without a check;
//      APF, t > 0: 5 (the first-stage max; one sum that carries the warps'
//      CDF totals, whose chained total gives LSE(fsw); the CDF and gather
//      buffers, the lookahead's log-density in one more; the check's max
//      and its two sums), and 2 at t = 0;
//    the APF step's exchanges run max, sums, max, sums, so the two
//    partial buffers still alternate: each is written again only after
//    the other's barrier, which every thread crosses after its last read;
//    the stage's barrier lies between and only adds one;
//  - selection without a per-slot search: each thread searches for its
//    first slot and gallops forward over the rest on a padded CDF
//    (row_select.cuh systematic_walk), which never falls;
//  - the step's offset is drawn by thread 0 alone (every thread drew it at
//    every check, though most checks of an ESS-gated schedule do not
//    resample), ahead of the reductions, and read by all after the max's
//    barrier; the shared word is written again only at the next check,
//    after the sums' barrier; y_{t+1} and z_{t+1} are loaded a step
//    ahead.
// The warps' CDF totals are computed at every bootstrap check (a lane scan
// and a redux), because whether the row resamples is known only after the
// sums' barrier; the raise that keeps the CDF from falling, only when it
// is staged.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "filter_megakernel.cuh"
#include "kernel_models.cuh"
#include "philox.cuh"
#include "row_select.cuh"

namespace ssme_fmk {

constexpr int kSysThreads = 256;  // threads an instance takes at most

// particles per thread at each N, from the grid measured on the card
// (PERF.md §6)
inline int kper_for(int n) { return n <= 512 ? 2 : 4; }

// The instrumented twins record, per row, by thread 0 in shared memory:
// the clock64 cycles of the step's parts (APF: the first stage's
// lookahead, max, sum, stage, walk and gather count under the same parts
// as the check's and the resample's), the counts of checks, resamples and
// APF steps (t > 0), the barriers crossed in bootstrap steps that
// resample, in checks that do not (and APF's t = 0), in steps without a
// check and in APF steps, and the layout the launch ran (kPer, blockDim).
enum SysSpan { kSpanPropagate, kSpanMax, kSpanSums, kSpanStage, kSpanWalk,
               kSpanGather, kSpanChecks, kSpanResamples, kSpanApfSteps,
               kSpanBarResample, kSpanBarCheck, kSpanBarOther, kSpanBarApf,
               kSpanLayoutPer, kSpanLayoutThreads, kNumSysSpans };

template <class Model, bool kApf, int kPer, bool kSpans>
__global__ void __launch_bounds__(kSysThreads, 2)
filter_megakernel_sys(const int64_t* __restrict__ seed,
                      const float* __restrict__ params,
                      const float* __restrict__ ys,
                      const float* __restrict__ zs, int num_steps,
                      int num_particles, float ess_limit, int always,
                      int gate_stride, float* __restrict__ total,
                      float* __restrict__ lcl, float* __restrict__ fmean,
                      float* __restrict__ cloud,
                      float* __restrict__ cloud_lw,
                      long long* __restrict__ spans) {
  static_assert(kPer % 2 == 0, "a thread holds whole Philox pairs");
  constexpr int kPairs = kPer / 2;
  constexpr int kLeaves = Model::kNumState;
  constexpr int kObs = Model::kDimObs;
  constexpr int kCov = Model::kDimCov > 0 ? Model::kDimCov : 1;
  constexpr int kDraws = Model::kDraws;
  // gathered values per particle: the state leaves and, in APF mode, the
  // lookahead's log-density (staged beside them, so it moves exactly)
  constexpr int kMoved = kLeaves + (kApf ? 1 : 0);
  constexpr int kRow = ssme::padded_size(kPer * kSysThreads);
  __shared__ float cdf[kRow];
  __shared__ float buf[kMoved * kRow];
  __shared__ float max_part[32];
  __shared__ float offset;  // the step's offset, drawn by thread 0
  __shared__ float4 sum_part[32];
  __shared__ float row_shared[Model::kRowShared > 0 ? Model::kRowShared : 1];
  // the spans, then the last clock read and this step's barriers
  constexpr int kMark = kNumSysSpans, kStepBars = kNumSysSpans + 1;
  __shared__ long long rec[kSpans ? kNumSysSpans + 2 : 1];
  long long* const bars = kSpans ? &rec[kSpans ? kStepBars : 0] : nullptr;

  const uint32_t b = blockIdx.x;
  const uint32_t i = threadIdx.x;
  const int n = num_particles;
  const bool active = static_cast<int>(kPer * i) < n;
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const float* row = params + static_cast<size_t>(b) * Model::kNumParams;
  if constexpr (Model::kRowShared > 0) {
    for (int j = i; j < Model::kRowShared; j += blockDim.x)
      row_shared[j] = Model::row_shared(row, j);
    __syncthreads();
  }
  const Model model(row, row_shared);
  const float log_n = logf(static_cast<float>(n));
  float* lcl_row = lcl + static_cast<size_t>(b) * num_steps;
  float* fmean_row = fmean + static_cast<size_t>(b) * num_steps;

  auto tick = [&](int k) {
    if constexpr (kSpans) {
      if (i == 0) {
        const long long now = clock64();
        rec[k] += now - rec[kMark];
        rec[kMark] = now;
      }
    }
  };
  // the step's barriers to the count of its kind
  auto close_step = [&](int kind) {
    if constexpr (kSpans) {
      if (i == 0) {
        rec[kind] += rec[kStepBars];
        rec[kStepBars] = 0;
      }
    }
  };
  auto count = [&](int k) {
    if constexpr (kSpans) {
      if (i == 0) rec[k] += 1;
    }
  };

  float y[kObs];
  float z[kCov];
  float x[kPer][kLeaves];
  load_row<kObs>(ys, 0, y);
  if constexpr (Model::kDimCov > 0) load_row<kCov>(zs, 0, z);
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    ssme::for_pair<kDraws>(k0, k1, kPairs * i + q, 0u, b,
                           [&](auto& rng, int e) {
                             model.init(rng, y, z, x[2 * q + e]);
                           });
  }
  float lw[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) lw[p] = 0.0f;
  float carry = log_n;
  float lse_fs = 0.0f;        // apf: LSE of the step's first-stage weights
  float row_total = 0.0f;
  if constexpr (kSpans) {
    if (i == 0) {
#pragma unroll
      for (int k = 0; k < kNumSysSpans + 2; ++k) rec[k] = 0;
      rec[kMark] = clock64();
    }
  }

  for (int t = 0; t < num_steps; ++t) {
    const uint32_t tu = static_cast<uint32_t>(t);
    float y_next[kObs];
    float z_next[kCov];
    if (t + 1 < num_steps) {
      load_row<kObs>(ys, t + 1, y_next);
      if constexpr (Model::kDimCov > 0) load_row<kCov>(zs, t + 1, z_next);
    }
    if (t > 0) {
      if constexpr (kApf) {
        // the first stage: a systematic selection on lw + log g(lookahead),
        // its offset drawn by thread 0 and read after the max's barrier
        if (i == 0) offset = ssme::offset_at(k0, k1, tu, b);
        float w[kPer];
        float v[kPer][kMoved];  // the state and log g(lookahead), staged
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          float look[kLeaves];
          model.prop_mu(x[p], y, z, look);
          v[p][kLeaves] = model.log_weight(look, y, z);
          w[p] = lw[p] + v[p][kLeaves];
#pragma unroll
          for (int l = 0; l < kLeaves; ++l) v[p][l] = x[p][l];
        }
        tick(kSpanPropagate);
        const float m_fs = ssme::row_max<kPer>(w, active, max_part, bars);
        const float u0 = offset;
        tick(kSpanMax);
        float s_fs[1] = {0.0f};
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          w[p] = active ? expf(w[p] - m_fs) : 0.0f;
          s_fs[0] += w[p];
        }
        ssme::warp_cdf<kPer>(w, active);
        const float warp_last = ssme::warp_cdf_raise<kPer>(w, active);
        float base = 0.0f, cdf_total = 0.0f;
        ssme::row_sums<1, true>(s_fs, warp_last, sum_part, base, cdf_total,
                                bars);
        lse_fs = m_fs + logf(cdf_total);
        tick(kSpanSums);
        ssme::row_stage<kPer, kMoved>(w, base, v, active, cdf, buf, kRow);
        ssme::row_sync(bars);
        tick(kSpanStage);
        int anc[kPer];
        ssme::systematic_walk<kPer>(u0, cdf_total, n, cdf, anc);
        tick(kSpanWalk);
        ssme::row_gather<kPer, kMoved>(v, anc, buf, kRow);
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
#pragma unroll
          for (int l = 0; l < kLeaves; ++l) x[p][l] = v[p][l];
        }
        tick(kSpanGather);
        // the transition, the second-stage weights against the selected
        // lookahead's density
#pragma unroll
        for (int q = 0; q < kPairs; ++q) {
          ssme::for_pair<kDraws>(k0, k1, kPairs * i + q, tu, b,
                                 [&](auto& rng, int e) {
                                   model.propagate(rng, x[2 * q + e], y, z);
                                 });
        }
#pragma unroll
        for (int p = 0; p < kPer; ++p)
          lw[p] = model.log_weight(x[p], y, z) - v[p][kLeaves];
      } else {
#pragma unroll
        for (int q = 0; q < kPairs; ++q) {
          ssme::for_pair<kDraws>(k0, k1, kPairs * i + q, tu, b,
                                 [&](auto& rng, int e) {
                                   model.propagate(rng, x[2 * q + e], y, z);
                                 });
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
#pragma unroll
      for (int k = 0; k < kObs; ++k) y[k] = y_next[k];
#pragma unroll
      for (int k = 0; k < kCov; ++k) z[k] = z_next[k];
      tick(kSpanPropagate);
      close_step(kSpanBarOther);
      continue;
    }
    // bootstrap: the offset of a resample that may follow, drawn by thread
    // 0 ahead of the reductions, so its Philox rounds overlap them, and
    // read after the max's barrier
    if (!kApf && i == 0)
      offset = ssme::offset_at(k0, k1, gate_stride == 1 ? tu + 1 : tu, b);
    tick(kSpanPropagate);
    const float m = ssme::row_max<kPer>(lw, active, max_part, bars);
    const float u0 = offset;
    tick(kSpanMax);
    constexpr int kSums = kApf ? 2 : 3;
    float w[kPer];
    float s[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = 0.0f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      w[p] = active ? expf(lw[p] - m) : 0.0f;
      lw[p] = lw[p] - m;
      s[0] += w[p];
      s[1] += model.functional(x[p]) * w[p];
      if constexpr (!kApf) s[2] += w[p] * w[p];
    }
    float base = 0.0f, cdf_total = 0.0f;
    if constexpr (kApf) {
      ssme::row_sums<2, false>(s, 0.0f, sum_part, base, cdf_total, bars);
    } else {
      ssme::warp_cdf<kPer>(w, active);
      const float warp_last = ssme::warp_cdf_total<kPer>(w, active);
      ssme::row_sums<3, true>(s, warp_last, sum_part, base, cdf_total, bars);
    }
    const float step_lcl =
        (kApf && t > 0) ? ((lse_fs - carry) + (m + logf(s[0]))) - log_n
                        : (m + logf(s[0])) - carry;
    carry = logf(s[0]);
    if (i == 0) {
      lcl_row[t] = step_lcl;
      fmean_row[t] = s[1] / s[0];
    }
    row_total += step_lcl;
    count(kSpanChecks);
    tick(kSpanSums);
#pragma unroll
    for (int k = 0; k < kObs; ++k) y[k] = y_next[k];
#pragma unroll
    for (int k = 0; k < kCov; ++k) z[k] = z_next[k];
    if constexpr (kApf) {
      if (t > 0) count(kSpanApfSteps);
      close_step(t > 0 ? kSpanBarApf : kSpanBarCheck);
    } else {
      // g = 1: step t + 1's resample (none after the last step); g > 1:
      // this check's, the last one's too (the cloud follows it)
      const bool resample = (gate_stride > 1 || t + 1 < num_steps) &&
                            (always || s[0] * s[0] / s[2] < ess_limit);
      if (resample) {
        ssme::warp_cdf_raise<kPer>(w, active);
        ssme::row_stage<kPer, kLeaves>(w, base, x, active, cdf, buf, kRow);
        ssme::row_sync(bars);
        tick(kSpanStage);
        int anc[kPer];
        ssme::systematic_walk<kPer>(u0, cdf_total, n, cdf, anc);
        tick(kSpanWalk);
        ssme::row_gather<kPer, kLeaves>(x, anc, buf, kRow);
#pragma unroll
        for (int p = 0; p < kPer; ++p) lw[p] = 0.0f;
        carry = log_n;
        count(kSpanResamples);
        tick(kSpanGather);
      }
      close_step(resample ? kSpanBarResample : kSpanBarCheck);
    }
  }
  if (i == 0) {
    total[b] = row_total;
    if constexpr (kSpans) {
      rec[kSpanLayoutPer] = kPer;
      rec[kSpanLayoutThreads] = blockDim.x;
#pragma unroll
      for (int k = 0; k < kNumSysSpans; ++k)
        spans[kNumSysSpans * b + k] = rec[k];
    }
  }
  if (cloud != nullptr && active) {
    const size_t plane = static_cast<size_t>(gridDim.x) * n;
    const size_t at = static_cast<size_t>(b) * n + kPer * i;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
#pragma unroll
      for (int l = 0; l < kLeaves; ++l) cloud[l * plane + at + p] = x[p][l];
      cloud_lw[at + p] = lw[p];
    }
  }
}

template <class Model, bool kApf, int kPer, bool kSpans = false>
int launch_sys(const Launch& a, long long* spans = nullptr) {
  const int threads = (a.num_particles / kPer + 31) / 32 * 32;
  filter_megakernel_sys<Model, kApf, kPer, kSpans>
      <<<a.num_rows, threads, 0, a.stream>>>(
          a.seed, a.params, a.ys, a.zs, a.num_steps, a.num_particles,
          a.ess_limit, a.always, a.gate_stride, a.total, a.lcl, a.fmean,
          a.cloud, a.cloud_lw, spans);
  return static_cast<int>(cudaGetLastError());
}

// the systematic instances of every model id at kPer; -1 for an unknown
// id, -2 for APF mode on a functor without a lookahead
template <int kPer>
int dispatch_sys(int model_id, int apf, const Launch& a) {
  return ssme::with_model(model_id, [&](auto is) -> int {
    using Model = typename decltype(is)::type;
    if (!apf) return launch_sys<Model, false, kPer>(a);
    if constexpr (Model::kHasPropMu) {
      return launch_sys<Model, true, kPer>(a);
    } else {
      return -2;
    }
  });
}

// the instrumented twins (svol_leverage, both modes) at kPer
template <int kPer>
int dispatch_sys_spans(int apf, const Launch& a, long long* spans) {
  using Model = ssme::SvolLeverageModel;
  return apf ? launch_sys<Model, true, kPer, true>(a, spans)
             : launch_sys<Model, false, kPer, true>(a, spans);
}

// the systematic instances, one translation unit per kPer
// (filter_megakernel_sys{2,4}.cu); spans null for the plain instances
int dispatch_sys2(int model_id, int apf, const Launch& a, long long* spans);
int dispatch_sys4(int model_id, int apf, const Launch& a, long long* spans);

}  // namespace ssme_fmk
