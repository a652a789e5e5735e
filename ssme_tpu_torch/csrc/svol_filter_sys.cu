// Whole-sequence univariate-SVOL bootstrap filter bank under systematic
// selection, laid out for Hopper.
//
// Replaces ssme_tpu/ops/svol_filter_kernel.py::svol_filter_pallas (the
// Pallas kernel body _make_kernel) under systematic selection: B filters
// over T observations in ONE launch, the particle cloud never leaving the
// chip.  The roll resamplers keep their kernel in svol_filter.cu.
//
// The recursion, its check columns and its intended divergences from the
// Pallas kernel are those of svol_filter.cu's header note.  One change of
// order computes the same thing: under the every-step schedule the
// resample of step t + 1 runs at the end of step t's check, on the same
// weights and states and with step t + 1's offset.
//
// Layout: one CTA per row; thread i owns kPer NEIGHBOURING particles
// j = kPer * i + p (kPer = 2, 4 or 8), blockDim = N / kPer rounded up to a
// warp, the lanes past N / kPer masked (N = 32 or 96 at kPer 2 leave part
// of a warp empty).  kPer per N is fixed in kper_for() from the grid
// measured on the card (PERF.md §6).  x and the carried log-weights live
// in registers for all T steps; the CDF and the gather buffer, N floats
// each plus a pad word per 32 (row_select.cuh padded), in static shared
// memory (33 KB at N = 4096, kPer 8 x 512 threads).  Four instances
// (launch_for): kPer 2 and 4 at up to 256 threads, kPer 8 at up to 256
// and 512; two CTAs share an SM (B = 256 rows fill the 132 SMs in one
// wave).  Each has an instrumented twin (kSpans) that also counts the
// barriers a step crosses.
//
// What bounds it: per-step latency, not bytes (about 8 bytes a step per
// row).  The design cuts the step's chain:
//  - paired draws: particles 2k and 2k+1 share Philox counter
//    (k, t, b, 0) and now share a thread, so one philox4x32_10 call and
//    one Box-Muller give both (cos to 2k, sin to 2k+1): the bits of
//    ops/_prng.py normals_steps at half the calls;
//  - barriers per step: 3 in a step that resamples (the row max; the
//    three sums, with the warps' CDF totals riding the same exchange; the
//    CDF and gather buffer), 2 at a check that does not resample, 0 in a
//    step without a check (row_select.cuh: one barrier per exchange, two
//    alternating partial buffers, so no leading barrier; the instrumented
//    instances count them, ops/svol_filter_kernel.py step_spans);
//  - selection without a per-slot search: each thread searches for its
//    first slot and gallops forward over the rest (row_select.cuh), on a
//    padded layout, so the lanes' reads kPer entries apart do not meet in
//    a bank;
//  - y_{t+1} is loaded a step ahead.
// The warps' CDF is computed at every check (a few shuffles), because
// whether the row resamples is known only after the sums' barrier.
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"
#include "row_select.cuh"

namespace {

constexpr float kHalfLog2Pi = 0.9189385332046727f;
constexpr int kMaxParticles = 4096;

// The instrumented instances (kSpans) record, per row, by thread 0 in
// shared memory (no register held across a step): the clock64 cycles of
// the step's parts, the counts of checks and resamples, the barriers
// crossed in steps that resample, in checks that do not and in the other
// steps (row_sync), and the layout the launch ran (kPer, blockDim).
enum Span { kPropagate, kMax, kSums, kStage, kWalk, kGather, kChecks,
            kResamples, kBarResample, kBarCheck, kBarOther, kLayoutPer,
            kLayoutThreads, kNumSpans };

// Two CTAs an SM, but for the instrumented twin of the 512-thread instance:
// at two CTAs it would spill, so it gives up the second for registers (its
// record at N = 4096 counts barriers and layout; its cycles run alone)
template <int kPer, int kThreads, bool kSpans>
__global__ void __launch_bounds__(kThreads,
                                  kSpans && kThreads > 256 ? 1 : 2)
svol_filter_sys_kernel(const int64_t* __restrict__ seed,
                       const float* __restrict__ params,
                       const float* __restrict__ ys, int num_steps,
                       int num_particles, float ess_limit, int always,
                       int gate_stride, float* __restrict__ total,
                       float* __restrict__ lcl, float* __restrict__ xmean,
                       long long* __restrict__ spans) {
  static_assert(kPer % 2 == 0, "a thread holds whole Philox pairs");
  constexpr int kPairs = kPer / 2;
  __shared__ float cdf[ssme::padded_size(kPer * kThreads)];
  __shared__ float buf[ssme::padded_size(kPer * kThreads)];
  __shared__ float max_part[32];
  __shared__ float4 sum_part[32];
  // the spans, then the last clock read and this step's barriers
  constexpr int kMark = kNumSpans, kStepBars = kNumSpans + 1;
  __shared__ long long rec[kSpans ? kNumSpans + 2 : 1];
  long long* const bars = kSpans ? &rec[kSpans ? kStepBars : 0] : nullptr;

  const uint32_t b = blockIdx.x;
  const uint32_t i = threadIdx.x;
  const int n = num_particles;
  const bool active = static_cast<int>(kPer * i) < n;
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const float beta = params[3 * b];
  const float phi = params[3 * b + 1];
  const float sigma = params[3 * b + 2];
  const float log_n = logf(static_cast<float>(n));
  const float c0 = -kHalfLog2Pi - logf(beta);
  const size_t row = static_cast<size_t>(b) * num_steps;

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

  float x[kPer];
  float lw[kPer];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const float2 z = ssme::normal_pair_at(k0, k1, kPairs * i + q, 0u, b);
    x[2 * q] = z.x * (sigma / sqrtf(1.0f - phi * phi));
    x[2 * q + 1] = z.y * (sigma / sqrtf(1.0f - phi * phi));
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) lw[p] = 0.0f;
  float carry = log_n;
  float row_total = 0.0f;
  float y = ys[0];
  if constexpr (kSpans) {
    if (i == 0) {
#pragma unroll
      for (int k = 0; k < kNumSpans + 2; ++k) rec[k] = 0;
      rec[kMark] = clock64();
    }
  }

  for (int t = 0; t < num_steps; ++t) {
    const float y_next = t + 1 < num_steps ? ys[t + 1] : 0.0f;
    if (t > 0) {
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const float2 z = ssme::normal_pair_at(k0, k1, kPairs * i + q, t, b);
        x[2 * q] = phi * x[2 * q] + sigma * z.x;
        x[2 * q + 1] = phi * x[2 * q + 1] + sigma * z.y;
      }
    }
    const float yb = y / beta;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const float z = yb * expf(-0.5f * x[p]);
      lw[p] = lw[p] + ((c0 - 0.5f * x[p]) - 0.5f * z * z);
    }
    y = y_next;

    const bool check = gate_stride == 1 || t % gate_stride == gate_stride - 1
                       || t == num_steps - 1;
    if (!check) {
      if (i == 0) {
        lcl[row + t] = 0.0f;
        xmean[row + t] = 0.0f;
      }
      tick(kPropagate);
      close_step(kBarOther);
      continue;
    }
    // the offset of a resample that may follow, drawn ahead of the
    // reductions so its Philox rounds overlap them (at kPer 8 after them:
    // its 64 registers have no room to hold it)
    const uint32_t t_sel = gate_stride == 1 ? t + 1 : t;
    float u0 = 0.0f;
    if constexpr (kPer < 8) u0 = ssme::offset_at(k0, k1, t_sel, b);
    tick(kPropagate);
    const float m = ssme::row_max<kPer>(lw, active, max_part, bars);  // 1
    tick(kMax);
    float w[kPer];
    float s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      w[p] = active ? expf(lw[p] - m) : 0.0f;
      lw[p] = lw[p] - m;
      s[0] += w[p];
      s[1] += x[p] * w[p];
      s[2] += w[p] * w[p];
    }
    ssme::warp_cdf<kPer>(w, active);
    const float warp_last = ssme::warp_cdf_raise<kPer>(w, active);
    float base = 0.0f, cdf_total = 0.0f;
    ssme::row_sums<3, true>(s, warp_last, sum_part, base, cdf_total,
                            bars);  // barrier 2
    const float step_lcl = (m + logf(s[0])) - carry;
    carry = logf(s[0]);
    if (i == 0) {
      lcl[row + t] = step_lcl;
      xmean[row + t] = s[1] / s[0];
    }
    row_total += step_lcl;
    if constexpr (kSpans) {
      if (i == 0) rec[kChecks] += 1;
    }
    tick(kSums);
    const bool resample =
        t + 1 < num_steps && (always || s[0] * s[0] / s[2] < ess_limit);
    if (resample) {
      ssme::row_stage<kPer>(w, base, x, active, cdf, buf);
      ssme::row_sync(bars);  // barrier 3
      tick(kStage);
      if constexpr (kPer >= 8) u0 = ssme::offset_at(k0, k1, t_sel, b);
      int anc[kPer];
      ssme::systematic_walk<kPer>(u0, cdf_total, n, cdf, anc);
      tick(kWalk);
      ssme::row_gather<kPer>(x, anc, buf);
#pragma unroll
      for (int p = 0; p < kPer; ++p) lw[p] = 0.0f;
      carry = log_n;
      if constexpr (kSpans) {
        if (i == 0) rec[kResamples] += 1;
      }
      tick(kGather);
    }
    close_step(resample ? kBarResample : kBarCheck);
  }
  if (i == 0) {
    total[b] = row_total;
    if constexpr (kSpans) {
      rec[kLayoutPer] = kPer;
      rec[kLayoutThreads] = blockDim.x;
#pragma unroll
      for (int k = 0; k < kNumSpans; ++k) spans[kNumSpans * b + k] = rec[k];
    }
  }
}

struct Launch {
  const int64_t* seed;
  const float* params;
  const float* ys;
  int rows, steps, n;
  float ess_limit;
  int always, gate_stride;
  float* total;
  float* lcl;
  float* xmean;
  long long* spans;
  cudaStream_t stream;
};

template <int kPer, int kThreads, bool kSpans = false>
int launch(const Launch& a, int threads) {
  svol_filter_sys_kernel<kPer, kThreads, kSpans>
      <<<a.rows, threads, 0, a.stream>>>(
          a.seed, a.params, a.ys, a.steps, a.n, a.ess_limit, a.always,
          a.gate_stride, a.total, a.lcl, a.xmean, a.spans);
  return static_cast<int>(cudaGetLastError());
}

// particles per thread at each N, from the grid measured on the card
// (PERF.md §6): at N = 512 kPer 2 is 15% faster than 4 with one row per
// SM (B = 128, the flagship's width) and within 3.4% of it at B = 256; at
// 1024 kPer 2 needs 1024 threads, one CTA per SM, and loses at B = 256
int kper_for(int n) { return n <= 512 ? 2 : n <= 1024 ? 4 : 8; }

bool takes(int n) {
  return n >= 32 && ((n <= 1024 && n % 32 == 0) ||
                     (n <= kMaxParticles && n % 128 == 0));
}

// the instance of kper_for(n): kPer 2 and 4 take at most 256 threads, kPer
// 8 up to 512 (N = 4096)
template <bool kSpans>
int launch_for(const Launch& a) {
  const int kper = kper_for(a.n);
  const int threads = (a.n / kper + 31) / 32 * 32;
  if (kper == 2) return launch<2, 256, kSpans>(a, threads);
  if (kper == 4) return launch<4, 256, kSpans>(a, threads);
  if (threads <= 256) return launch<8, 256, kSpans>(a, threads);
  return launch<8, 512, kSpans>(a, threads);
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers the caller allocated; the kernel allocates nothing and runs on
// `stream`.  num_particles: a multiple of 32 up to 1024, of 128 up to
// 4096.  spans: null, or int64[num_rows * 13] for the instrumented
// instance's record (enum Span).  Returns cudaGetLastError() after the
// launch, or -3 for a shape it does not take.
extern "C" int ssme_svol_filter_sys(const int64_t* seed, const float* params,
                                    const float* ys, int num_rows,
                                    int num_steps, int num_particles,
                                    float ess_limit, int always,
                                    int gate_stride, float* total,
                                    float* lcl, float* xmean,
                                    long long* spans, void* stream) {
  if (!takes(num_particles)) return -3;
  const Launch a{seed, params, ys, num_rows, num_steps, num_particles,
                 ess_limit, always, gate_stride, total, lcl, xmean, spans,
                 static_cast<cudaStream_t>(stream)};
  return spans ? launch_for<true>(a) : launch_for<false>(a);
}
