// Whole-sequence univariate-SVOL bootstrap filter bank for Hopper, under
// systematic selection and the roll resamplers.
//
// Replaces ssme_tpu/ops/svol_filter_kernel.py::svol_filter_pallas (the
// Pallas kernel body _make_kernel): B filters over T observations in ONE
// launch, the particle cloud never leaving the chip, under
// select_leaves_dense (systematic) or metropolis_select_leaves /
// rejection_select_leaves (the roll resamplers, chosen at run time,
// roll_select.cuh; the kRoll family).
//
// Per step it computes what the Pallas kernel computes:
//   t = 0   x ~ N(0, sigma^2 / (1 - phi^2)), lw = 0, carry = log N;
//   t > 0   gate_stride 1: resample (always, or when ESS < tau N) THEN
//           propagate x' = phi x + sigma eps;
//           gate_stride g > 1: propagate only, weights accumulate;
//   weight  lw += -log(2 pi)/2 - log beta - x/2 - (y e^{-x/2} / beta)^2 / 2;
//   check   (every step at g = 1; at t = g-1 mod g and t = T-1 otherwise)
//           lcl = LSE(lw) - carry, xmean under the full carried weights,
//           renormalise (lw -= max, carry = log sum); at g > 1 the ESS of
//           the renormalised weights then gates a resample.
//   lcl and xmean are zero off the check columns.
// One change of order computes the same thing: under the every-step
// schedule the resample of step t + 1 runs at the end of step t's check,
// on the same weights and states and with step t + 1's offset
// (systematic) or sweep draws (roll).
//
// Intended divergences from the Pallas kernel:
//  - the ESS gate is per row (the TPU gates on the worst row of an 8-row
//    tile and pads B with a real row; there is no tile here);
//  - the loop runs to T exactly: no padded steps, so the padded-step wipe
//    of the TPU kernel at T mod 128 in [1, g-1] cannot occur;
//  - steps_per_cell, substep_regions and compensated_cdf are TPU
//    artefacts and have no counterpart;
//  - random numbers are Philox4x32-10 (philox.cuh), not the TPU's.
//
// Layout: one CTA per row; thread i owns kPer NEIGHBOURING particles
// j = kPer * i + p, blockDim = N / kPer rounded up to a warp, the lanes
// past N / kPer masked (N = 32 or 96 at kPer 2 leave part of a warp
// empty).  kPer per N is fixed in kper_for() from the grids measured on
// the card (PERF.md §6).  x and the carried log-weights live in registers
// for all T steps; the gather buffer, N floats plus a pad word per 32
// (row_select.cuh padded), and the systematic selection's marks (N ints)
// or, under the roll resamplers, the weights (padded as the gather
// buffer) and each thread's ancestors (uint16 at a constant stride, slot
// p of thread i at p * kThreads + i, so their addresses take no
// registers), in static shared memory (42 KB at N = 4096).  Instances
// (launch_for): systematic kPer 2 and 4 at up to 256 threads, kPer 8 at
// up to 256 and 512; roll kPer 2, 4 and 8 at up to 256 threads and the
// N = 4096 layout of kper_for; two CTAs share an SM (B = 256 rows fill
// the 132 SMs in one wave).  Each has an instrumented twin (kSpans) that
// also counts the barriers a step crosses and, under the roll
// resamplers, the selections' sweeps, votes and tail slots.
//
// What bounds it: per-step latency, not bytes (about 8 bytes a step per
// row).  The design cuts the step's chain:
//  - paired draws: particles 2k and 2k+1 share Philox counter
//    (k, t, b, 0) and share a thread, so one philox4x32_10 call and one
//    Box-Muller give both (cos to 2k, sin to 2k+1): the bits of
//    ops/_prng.py normals_steps at half the calls;
//  - barriers per step: systematic, 3 in a step that resamples (the row
//    max; the three sums, with the warps' CDF totals riding the same
//    exchange; the marks and gather buffer), 2 at a check that does not
//    resample, 0 in a step without a check; roll, 2 at every check (the
//    row max; the three sums, whose barrier also publishes the weights
//    and states staged before it) and in a step that resamples under
//    rejection the selection's votes (one per chunk of 32 sweeps) and, in
//    its tail, two more; Metropolis adds none (row_select.cuh: one
//    barrier per exchange, two alternating partial buffers, so no leading
//    barrier; the instrumented instances count them, ops/
//    svol_filter_kernel.py step_spans);
//  - systematic selection without a search (row_select.cuh): each
//    particle counts the points at or below its CDF entry in registers
//    and marks its first slot (and each warp's first slot in its range),
//    and each thread scans its own slots' marks after the barrier that
//    publishes them; no shared load waits on another;
//  - roll selection keyed by slot (roll_select.cuh, NeighbourSlots): the
//    row's largest weight is exactly 1 (w = exp(lw - max)), shift scans
//    by chunks of 32 sweeps, a vote per chunk, a sweep-parallel tail, the
//    Philox counters of ops/_prng.py, so the ancestors are the plain
//    law's bits; the weights and states are staged before the sums'
//    barrier and the ancestors wait in shared memory, so no particle's
//    value holds a register while the selection runs;
//  - y_{t+1} is loaded a step ahead.
// The warps' CDF is computed at every systematic check (a few shuffles),
// because whether the row resamples is known only after the sums'
// barrier.
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"
#include "roll_select.cuh"
#include "row_select.cuh"

namespace {

constexpr float kHalfLog2Pi = 0.9189385332046727f;
constexpr int kMaxParticles = 4096;

// The instrumented instances (kSpans) record, per row, by thread 0 in
// shared memory (no register held across a step): the clock64 cycles of
// the step's parts (systematic: the counts, marks and the states' stage
// count as the stage, the scan of the marks as the walk; roll: the
// selection counts as the walk), the counts of checks and resamples, the
// barriers crossed in steps that resample, in checks that do not and in
// the other steps (row_sync; a roll selection's apart), the roll
// selections' votes and tail barriers, the sweeps they ran (1 + the last
// accept sweep, 4096 at the cap) and the slots their tails took, the
// systematic selections' fix-ups (counts whose first guess missed) and
// the most marks one thread wrote in a selection, and the layout the
// launch ran (kPer, blockDim).
enum Span { kPropagate, kMax, kSums, kStage, kWalk, kGather, kChecks,
            kResamples, kBarResample, kBarCheck, kBarOther, kVotes,
            kTailBars, kSweeps, kTailSlots, kFixups, kMostMarks,
            kLayoutPer, kLayoutThreads, kNumSpans };

// Two CTAs an SM, but for the instrumented twin of a 512-thread instance:
// at two CTAs it would spill, so it gives up the second for registers (its
// record at N = 4096 counts barriers and layout; its cycles run alone)
template <int kPer, int kThreads, bool kSpans, bool kRoll>
__global__ void __launch_bounds__(kThreads,
                                  kSpans && kThreads > 256 ? 1 : 2)
svol_filter_sys_kernel(const int64_t* __restrict__ seed,
                       const float* __restrict__ params,
                       const float* __restrict__ ys, int num_steps,
                       int num_particles, float ess_limit, int always,
                       int gate_stride, int resampler, int metropolis_iters,
                       float* __restrict__ total, float* __restrict__ lcl,
                       float* __restrict__ xmean,
                       long long* __restrict__ spans) {
  static_assert(kPer % 2 == 0, "a thread holds whole Philox pairs");
  constexpr int kPairs = kPer / 2;
  // roll: the weights; systematic: the selection's marks
  __shared__ float weights[kRoll ? ssme::padded_size(kPer * kThreads) : 1];
  __shared__ __align__(16) int marks[kRoll ? 1 : kPer * kThreads];
  __shared__ float buf[ssme::padded_size(kPer * kThreads)];
  __shared__ float max_part[32];
  __shared__ float4 sum_part[32];
  // the roll selection's ancestors, each thread's own kPer
  __shared__ uint16_t roll_anc[kRoll ? kPer * kThreads : 1];
  // the spans, then the last clock read and this step's barriers
  constexpr int kMark = kNumSpans, kStepBars = kNumSpans + 1;
  __shared__ long long rec[kSpans ? kNumSpans + 2 : 1];
  long long* const bars = kSpans ? &rec[kSpans ? kStepBars : 0] : nullptr;
  // a roll selection's record (roll_select.cuh): sweeps, votes, tail
  // slots; the systematic selections' (note_selection), each warp's
  // folded at the row's end through sel_part
  __shared__ int roll_rec[kSpans && kRoll ? 3 : 1];
  __shared__ int sel_part[kSpans && !kRoll ? 64 : 1];

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
  const int staged = ssme::padded(kPer * i);

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
  auto ancestor = [&](int p) -> uint16_t& {
    return roll_anc[p * kThreads + i];
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
  if constexpr (!kRoll) ssme::clear_marks<kPer>(marks);
  if constexpr (kSpans && !kRoll) ssme::clear_selections(sel_part);
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
    // the step word of a resample that may follow and, under systematic
    // selection, its offset, drawn ahead of the reductions so its Philox
    // rounds overlap them (at kPer 8 once the row resamples, before the
    // counts: its 64 registers have no room to hold it across them)
    const uint32_t t_sel = gate_stride == 1 ? t + 1 : t;
    float u0 = 0.0f;
    if constexpr (!kRoll && kPer < 8) u0 = ssme::offset_at(k0, k1, t_sel, b);
    tick(kPropagate);
    const float m = ssme::row_max<kPer>(lw, active, max_part, bars);  // 1
    tick(kMax);
    float w[kPer];
    float s[3] = {0.0f, 0.0f, 0.0f};
    float base = 0.0f, cdf_total = 0.0f;
    if constexpr (kRoll) {
      // each particle's weight and state to shared memory as they come,
      // which the sums' barrier publishes for a resample that may follow
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const float wp = active ? expf(lw[p] - m) : 0.0f;
        lw[p] = lw[p] - m;
        s[0] += wp;
        s[1] += x[p] * wp;
        s[2] += wp * wp;
        if (active) {
          weights[staged + p] = wp;
          buf[staged + p] = x[p];
        }
      }
      ssme::row_sums<3, false>(s, 0.0f, sum_part, base, cdf_total,
                               bars);  // barrier 2
    } else {
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
      ssme::row_sums<3, true>(s, warp_last, sum_part, base, cdf_total,
                              bars);  // barrier 2
    }
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
      if constexpr (kRoll) {
        // the selection on the staged weights (their largest exactly 1),
        // its ancestors to shared memory, then each state from its
        // ancestor's staged one
#pragma unroll
        for (int p = 0; p < kPer; ++p)
          ancestor(p) = static_cast<uint16_t>(kPer * i + p);
        ssme::roll_select<kPer, ssme::NeighbourSlots<kPer>>(
            resampler, metropolis_iters, active, weights, 1.0f, n, k0, k1,
            t_sel, b, ssme::kTagRollSweep,
            [&](int p, int a) { ancestor(p) = static_cast<uint16_t>(a); },
            nullptr, kSpans ? roll_rec : nullptr);
        if constexpr (kSpans) {
          if (i == 0) {
            rec[kVotes] += roll_rec[1];
            rec[kTailBars] += roll_rec[2] > 0 ? 2 : 0;
            rec[kSweeps] += roll_rec[0];
            rec[kTailSlots] += roll_rec[2];
          }
        }
        tick(kWalk);
        if (active) {  // a masked lane's slots were never staged
#pragma unroll
          for (int p = 0; p < kPer; ++p)
            x[p] = buf[ssme::padded(ancestor(p))];
        }
      } else {
        if constexpr (kPer >= 8) u0 = ssme::offset_at(k0, k1, t_sel, b);
        int fixups = 0;
        const int wrote = ssme::systematic_marks<kPer>(
            w, base, u0, cdf_total, n, active, marks, fixups);
        if constexpr (kSpans) ssme::note_selection(sel_part, fixups, wrote);
        ssme::row_stage<kPer>(x, active, buf);
        ssme::row_sync(bars);  // barrier 3
        tick(kStage);
        int anc[kPer];
        ssme::systematic_scan<kPer>(marks, active, anc);
        tick(kWalk);
        ssme::row_gather<kPer>(x, anc, buf);
      }
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
  if constexpr (kSpans && !kRoll)
    ssme::fold_selections(sel_part, rec[kFixups], rec[kMostMarks]);
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
  int always, gate_stride, resampler, metropolis_iters;
  float* total;
  float* lcl;
  float* xmean;
  long long* spans;
  cudaStream_t stream;
};

template <int kPer, int kThreads, bool kSpans, bool kRoll>
int launch(const Launch& a, int threads) {
  svol_filter_sys_kernel<kPer, kThreads, kSpans, kRoll>
      <<<a.rows, threads, 0, a.stream>>>(
          a.seed, a.params, a.ys, a.steps, a.n, a.ess_limit, a.always,
          a.gate_stride, a.resampler, a.metropolis_iters, a.total, a.lcl,
          a.xmean, a.spans);
  return static_cast<int>(cudaGetLastError());
}

// particles per thread at each N, from the grids measured on the card
// (PERF.md §6): systematic, at N = 512 kPer 2 is 15% faster than 4 with
// one row per SM (B = 128, the flagship's width) and within 3.4% of it at
// B = 256; at 1024 kPer 2 needs 1024 threads, one CTA per SM, and loses
// at B = 256; roll, the same to 2048, and at 4096 kPer 16 at 256 threads
int kper_for(int n, bool roll) {
  if (roll && n > 2048) return 16;
  return n <= 512 ? 2 : n <= 1024 ? 4 : 8;
}

bool takes(int n, int resampler) {
  if (resampler != ssme::kResampleSystematic)
    return (resampler == ssme::kResampleMetropolis ||
            resampler == ssme::kResampleRejection) &&
           n >= 32 && n <= kMaxParticles && (n & (n - 1)) == 0;
  return n >= 32 && ((n <= 1024 && n % 32 == 0) ||
                     (n <= kMaxParticles && n % 128 == 0));
}

// the instance of kper_for(n): kPer 2, 4 and 16 take at most 256 threads,
// kPer 8 up to 512 (systematic at N = 4096)
template <bool kSpans, bool kRoll>
int launch_for(const Launch& a) {
  const int kper = kper_for(a.n, kRoll);
  const int threads = (a.n / kper + 31) / 32 * 32;
  if (kper == 2) return launch<2, 256, kSpans, kRoll>(a, threads);
  if (kper == 4) return launch<4, 256, kSpans, kRoll>(a, threads);
  if constexpr (kRoll) {
    if (kper == 16) return launch<16, 256, kSpans, kRoll>(a, threads);
    return launch<8, 256, kSpans, kRoll>(a, threads);
  } else {
    if (threads <= 256) return launch<8, 256, kSpans, kRoll>(a, threads);
    return launch<8, 512, kSpans, kRoll>(a, threads);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers the caller allocated; the kernel allocates nothing and runs on
// `stream`.  resampler: 0 systematic (num_particles a multiple of 32 up
// to 1024, of 128 up to 4096), 1 metropolis with metropolis_iters sweeps,
// 2 rejection (both on a power of two in [32, 4096]).  spans: null, or
// int64[num_rows * 19] for the instrumented instance's record (enum
// Span).  Returns cudaGetLastError() after the launch, or -3 for a shape
// or resampler it does not take.
extern "C" int ssme_svol_filter(const int64_t* seed, const float* params,
                                const float* ys, int num_rows, int num_steps,
                                int num_particles, float ess_limit,
                                int always, int gate_stride, int resampler,
                                int metropolis_iters, float* total,
                                float* lcl, float* xmean, long long* spans,
                                void* stream) {
  if (!takes(num_particles, resampler)) return -3;
  const Launch a{seed, params, ys, num_rows, num_steps, num_particles,
                 ess_limit, always, gate_stride, resampler, metropolis_iters,
                 total, lcl, xmean, spans, static_cast<cudaStream_t>(stream)};
  if (resampler == ssme::kResampleSystematic)
    return spans ? launch_for<true, false>(a) : launch_for<false, false>(a);
  return spans ? launch_for<true, true>(a) : launch_for<false, true>(a);
}
