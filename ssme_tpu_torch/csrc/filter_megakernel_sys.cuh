// The generic filter kernel, laid out for Hopper: B filters of one model
// functor (kernel_models.cuh) over T observations in ONE launch, bootstrap
// or APF, under a selection family that is a template parameter: the
// systematic one (N a multiple of 32 in [32, 1024], the JAX package's
// MAX_KERNEL_PARTICLES) or the roll resamplers (kRoll; Metropolis or
// rejection, chosen at run time, roll_select.cuh; N a power of two in
// [32, 4096], the JAX package's MAX_METROPOLIS_PARTICLES).
//
// Replaces ssme_tpu/ops/filter_megakernel.py::_make_kernel under
// select_leaves_dense, metropolis_select_leaves and
// rejection_select_leaves.  The step recursion, its check columns and the
// intended divergences from the Pallas kernel are in filter_megakernel.cuh's
// note.  One change of order computes the same thing, as in
// svol_filter_sys.cu: under the bootstrap's every-step schedule (g = 1)
// the resample of step t + 1 runs at the end of step t's check, on the
// same weights and states and with step t + 1's offset (systematic) or
// sweep draws (roll).  And in APF mode the lookahead's log-density moves
// with the state through the selection's gather (exact), where the plain
// version recomputes it at the selected state: the same value.
//
// Layout: one CTA per row; thread i owns kPer NEIGHBOURING particles
// j = kPer * i + p, blockDim = N / kPer rounded up to a warp, the lanes
// past N / kPer masked (N = 32 or 96 at kPer 2 leave part of a warp
// empty).  kPer per N is fixed in kper_for() from the grid measured on
// the card (PERF.md §6): 2 to N = 512, 4 at 1024 (both families), 8 at
// 2048 and 16 at 4096 (roll).  The state leaves and the carried
// log-weights live in registers for all T steps (but those of a
// shared-state functor, factor_svol_sv_10's 12 leaves, which live in
// dynamic shared memory, 110 KB a CTA at kPer 4); the systematic
// selection's marks (roll: the weights) and one gather buffer per state
// leaf, padded_size(kPer * 256) words each (row_select.cuh), in static
// shared memory (12.7 KB at N =
// 1024 with factor SVOL's two leaves), or in dynamic shared memory where
// they pass kStaticBytes (row_floats(): every bootstrap and APF instance
// at kPer 16, 50-67 KB), so a two-leaf gather rides the same barrier as a
// one-leaf one; the functor's per-row constants (kRowShared) beside them.
// Under the roll resamplers the states, the weights and (bootstrap) the
// carried log-weights pass the check's exchange and the selection in
// shared memory, and the ancestors stay there too (each thread's own), so
// no particle's values hold registers while the selection runs.
// Instances: every functor, bootstrap and (with a lookahead) APF, one
// file per family and kPer (filter_megakernel_sys{2,4}.cu,
// filter_megakernel_sys_roll{2,4,8,16}.cu); at most 256 threads and two
// CTAs an SM (B = 256 rows fill the 132 SMs in one wave), but one for
// factor SVOL at kPer 16 (min_ctas).  Instrumented twins (kSpans) count the barriers a
// step crosses: svol_leverage in both modes and families, svol's
// bootstrap under the roll resamplers, factor_svol_sv_10's bootstrap under
// systematic selection.  A shared-state functor (factor_svol_sv_10: 12
// leaves) has systematic bootstrap instances only.
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
//      bootstrap, systematic: 3 in a step that resamples (the row max; the
//      three sums, with the warps' CDF totals riding the same exchange;
//      the marks and gather buffers), 2 at a check that does not, 0 in a
//      step without a check;
//      bootstrap, roll: 2 at every check (the row max; the three sums,
//      whose barrier also publishes the weights and the states staged
//      before it), and in a step that resamples under rejection the
//      selection's votes (one per chunk of 32 sweeps) and, in its tail,
//      two more; Metropolis adds none;
//      APF, t > 0: systematic 5 (the first-stage max; one sum that carries
//      the warps' CDF totals, whose chained total gives LSE(fsw); the
//      marks and gather buffers, the lookahead's log-density in one more; the
//      check's max and its two sums), roll 4 and the votes (the
//      first-stage sum publishes the staged weights and values), and 2 at
//      t = 0;
//    the APF step's exchanges run max, sums, max, sums, so the two
//    partial buffers still alternate: each is written again only after
//    the other's barrier, which every thread crosses after its last read;
//    the stage's barrier lies between and only adds one.  The shared
//    weights, marks and gather buffers are written once per check (roll)
//    or resample, after that check's max barrier, which every thread
//    crosses after its last read of the previous selection;
//  - selection without a search (systematic): each particle counts the
//    points at or below its CDF entry in registers and marks its first
//    slot, and each thread scans its slots' marks after the stage's
//    barrier (row_select.cuh systematic_marks, systematic_scan); the
//    roll resamplers read candidates' weights from the padded buffer
//    (roll_select.cuh: shift scans by chunks, a vote per chunk, a
//    sweep-parallel tail), with the row's largest weight exactly 1 (the
//    weights are exp(lw - max));
//  - the step's offset is drawn by thread 0 alone (every thread drew it at
//    every check, though most checks of an ESS-gated schedule do not
//    resample), ahead of the reductions, and read by all after the max's
//    barrier; the shared word is written again only at the next check,
//    after the sums' barrier; y_{t+1} and z_{t+1} are loaded a step
//    ahead.
// The warps' CDF totals are computed at every bootstrap check (a lane scan
// and a redux), because whether the row resamples is known only after the
// sums' barrier; the raise that keeps the CDF from falling, only when the
// row resamples.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "filter_megakernel.cuh"
#include "kernel_models.cuh"
#include "philox.cuh"
#include "row_select.cuh"

namespace ssme_fmk {

constexpr int kSysThreads = 256;  // threads an instance takes at most
// static shared memory an instance's marks (roll: weights) and gather
// buffers may take; above it they move to dynamic shared memory
constexpr int kStaticBytes = 40 * 1024;

// particles per thread at each N, from the grids measured on the card
// (PERF.md §6)
inline int kper_for(int n) {
  return n <= 512 ? 2 : n <= 1024 ? 4 : n <= 2048 ? 8 : 16;
}

// CTAs an SM an instance's launch bounds ask for: two (B = 256 rows in one
// wave on the 132 SMs, at most 128 registers a thread), but one for a
// two-leaf functor at 16 particles a thread, whose states and log-weights
// would spill at 128 registers
__host__ __device__ constexpr int min_ctas(int leaves, int kper) {
  return leaves > 1 && kper > 8 ? 1 : 2;
}

// words of an instance's row arrays in shared memory: the systematic
// selection's marks (roll: the weights) and one gather buffer per moved
// value, padded_size(kPer * 256) each, then kShadow more (a shared-state
// functor's second state buffer, one a leaf) and, in the bootstrap under
// the roll resamplers, each thread's carried log-weights (kPer * 256)
template <int kMoved, int kPer, bool kCarried, int kShadow = 0>
__host__ __device__ constexpr int row_floats() {
  return (1 + kMoved + kShadow) * ssme::padded_size(kPer * kSysThreads) +
         (kCarried ? kPer * kSysThreads : 0);
}

// The instrumented twins record, per row, by thread 0 in shared memory:
// the clock64 cycles of the step's parts (the transition's draws apart
// from the observation density's weights; APF: the first stage's
// lookahead, max, sum, stage, walk and gather count under the same parts
// as the check's and the resample's; roll: the selection counts as the
// walk), the counts of checks, resamples (roll: and APF first stages) and
// APF steps (t > 0), the barriers crossed in bootstrap steps that
// resample, in checks that do not (and APF's t = 0), in steps without a
// check and in APF steps, and of those the roll selections' votes and tail
// barriers, the sweeps the roll selections ran (1 + the last accept
// sweep, 4096 at the cap) and the slots their tails took, the systematic
// selections' fix-ups (counts whose first guess missed) and the most marks
// one thread wrote in a selection (row_select.cuh note_selection), and
// the layout the launch ran (kPer, blockDim).  Under the roll resamplers
// the twins also write each selection's sweeps to sweeps[b * T + t] and
// the ratio of its largest weight to its mean, N / sum(w), to
// ratio[b * T + t], t the step of its draws (0 where none).
enum SysSpan { kSpanPropagate, kSpanWeight, kSpanMax, kSpanSums, kSpanStage,
               kSpanWalk, kSpanGather, kSpanChecks, kSpanResamples,
               kSpanApfSteps,
               kSpanBarResample, kSpanBarCheck, kSpanBarOther, kSpanBarApf,
               kSpanVotes, kSpanTailBars, kSpanSweeps, kSpanTailSlots,
               kSpanFixups, kSpanMostMarks, kSpanLayoutPer,
               kSpanLayoutThreads, kNumSysSpans };

// the step's selection arguments under the roll resamplers
struct RollArgs {
  int resampler, metropolis_iters;
  int* sweeps;   // the twins' record of sweeps per step, or null
  float* ratio;  // and of max / mean weight per step, or null
};

template <class Model, bool kApf, int kPer, bool kSpans, bool kRoll = false>
__global__ void __launch_bounds__(kSysThreads,
                                  min_ctas(Model::kNumState, kPer))
filter_megakernel_sys(const int64_t* __restrict__ seed,
                      const float* __restrict__ params,
                      const float* __restrict__ ys,
                      const float* __restrict__ zs, int num_steps,
                      int num_particles, float ess_limit, int always,
                      int gate_stride, float* __restrict__ total,
                      float* __restrict__ lcl, float* __restrict__ fmean,
                      float* __restrict__ cloud,
                      float* __restrict__ cloud_lw,
                      long long* __restrict__ spans, RollArgs roll) {
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
  // the bootstrap under a roll resampler keeps each particle's carried
  // log-weight in shared memory across the check's exchange and the
  // selection, as it keeps the states, so that no particle's values wait
  // in registers on either branch (slot p of thread i at p * kSysThreads
  // + i: a constant stride, so the addresses take no registers)
  // A shared-state functor (kernel_models.cuh SharedState: its leaves
  // would not fit in registers beside the step's work) keeps each
  // particle's state in two row buffers of kLeaves planes, the gather
  // buffers and one more (leaf l of particle j at l * kRow + padded(j)),
  // the selection's gather writing each from the other, and its carried
  // log-weights in shared memory as the roll bootstrap does, in registers
  // only from the check's max to its end.  Its hooks are leafwise: a
  // pair's leaf l drawn from one Philox call in place (the pair loop not
  // unrolled, so at most two leaves' calls are in flight), and the
  // density of one particle at a time.  Bootstrap, systematic.
  constexpr bool kShared = ssme::SharedState<Model>::value;
  static_assert(!kShared || (!kApf && !kRoll),
                "a shared state runs the systematic bootstrap only");
  constexpr int kShadow = kShared ? kLeaves : 0;
  constexpr bool kCarried = (kRoll && !kApf) || kShared;
  constexpr bool kDynamic =
      row_floats<kMoved, kPer, kCarried, kShadow>() * 4 > kStaticBytes;
  static_assert(!kShared || kDynamic, "a shared state's rows are dynamic");
  __shared__ __align__(16) float cdf_static[kDynamic ? 1 : kRow];
  __shared__ float buf_static[kDynamic ? 1 : kMoved * kRow];
  __shared__ float carried_static[kDynamic || !kCarried ? 1
                                                        : kPer * kSysThreads];
  extern __shared__ float dynamic_row[];  // row_floats() floats
  // roll: the weights; systematic: the selection's marks in its place
  float* const cdf = kDynamic ? dynamic_row : cdf_static;
  int* const marks = reinterpret_cast<int*>(cdf);
  float* const buf = kDynamic ? dynamic_row + kRow : buf_static;
  float* const carried =
      kDynamic ? dynamic_row + (1 + kMoved + kShadow) * kRow
               : carried_static;
  // kShared: the state's row buffer, and the one the next gather fills
  float* st = buf;
  float* st_next = buf + kMoved * kRow;
  __shared__ float max_part[32];
  __shared__ float offset;  // the step's offset, drawn by thread 0
  __shared__ float4 sum_part[32];
  // 16-byte aligned: a functor may read its constants in vector words
  __shared__ __align__(16) float
      row_shared[Model::kRowShared > 0 ? Model::kRowShared : 1];
  // the spans, then the last clock read and this step's barriers
  constexpr int kMark = kNumSysSpans, kStepBars = kNumSysSpans + 1;
  __shared__ long long rec[kSpans ? kNumSysSpans + 2 : 1];
  long long* const bars = kSpans ? &rec[kSpans ? kStepBars : 0] : nullptr;
  // a roll selection's record (roll_select.cuh): sweeps, votes, tail
  // slots; the systematic selections' (note_selection), each warp's
  // folded at the row's end through sel_part
  __shared__ int roll_rec[kSpans && kRoll ? 3 : 1];
  __shared__ int sel_part[kSpans && !kRoll ? 64 : 1];
  // the roll selection's ancestors, each thread's own kPer (slot p of
  // thread i at p * kSysThreads + i), in shared memory so that the states
  // need no registers while the selection runs
  __shared__ uint16_t roll_anc[kRoll ? kPer * kSysThreads : 1];

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
  // this thread's first staged slot, and particle p's ancestor after a
  // roll selection (each thread reads and writes its own)
  const int staged = ssme::padded(kPer * i);
  auto ancestor = [&](int p) -> uint16_t& {
    return roll_anc[p * kSysThreads + i];
  };
  // the roll selection of this thread's particles on the staged weights
  // (their largest exactly 1, their sum `sum`), at step word ts on the
  // sweep tags from tag_base, its ancestors to ancestor(p); and the twins'
  // record of it
  auto roll_ancestors = [&](uint32_t ts, uint32_t tag_base, float sum) {
    if constexpr (kRoll) {
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        ancestor(p) = static_cast<uint16_t>(kPer * i + p);
      ssme::roll_select<kPer, ssme::NeighbourSlots<kPer>>(
          roll.resampler, roll.metropolis_iters, active, cdf, 1.0f, n, k0,
          k1, ts, b, tag_base,
          [&](int p, int a) { ancestor(p) = static_cast<uint16_t>(a); },
          bars, kSpans ? roll_rec : nullptr);
      if constexpr (kSpans) {
        if (i == 0) {
          rec[kSpanVotes] += roll_rec[1];
          rec[kSpanTailBars] += roll_rec[2] > 0 ? 2 : 0;
          rec[kSpanSweeps] += roll_rec[0];
          rec[kSpanTailSlots] += roll_rec[2];
          const size_t at = static_cast<size_t>(b) * num_steps + ts;
          if (roll.sweeps) roll.sweeps[at] = roll_rec[0];
          if (roll.ratio) roll.ratio[at] = static_cast<float>(n) / sum;
        }
      }
    }
  };

  float y[kObs];
  float z[kCov];
  float x[kPer][kLeaves];   // the state, unless kShared
  // kShared: pair q's leaves drawn in shared memory, leaf l of both
  // particles from draw l's Philox call (the cosine the first's, the sine
  // the second's: for_pair's bits); at t = 0 from the stationary law
  auto leaf_draws = [&](int q, uint32_t tt, bool first) {
    if constexpr (kShared) {
      float* const at = st + staged + 2 * q;
#pragma unroll 2
      for (int l = 0; l < kLeaves; ++l) {
        const float2 e = ssme::normal_pair_at(k0, k1, kPairs * i + q, tt, b,
                                              static_cast<uint32_t>(l));
        float* const v = at + l * kRow;
        if (first) {
          v[0] = model.init_leaf(l, e.x);
          v[1] = model.init_leaf(l, e.y);
        } else {
          v[0] = model.propagate_leaf(l, v[0], e.x);
          v[1] = model.propagate_leaf(l, v[1], e.y);
        }
      }
    }
  };
  // kShared: particle p's leaves into registers
  auto load_particle = [&](int p, float (&v)[kLeaves]) {
#pragma unroll
    for (int l = 0; l < kLeaves; ++l) v[l] = st[l * kRow + staged + p];
  };
  load_row<kObs>(ys, 0, y);
  if constexpr (Model::kDimCov > 0) load_row<kCov>(zs, 0, z);
  if constexpr (kShared) {
#pragma unroll 1
    for (int q = 0; q < kPairs; ++q) leaf_draws(q, 0u, true);
#pragma unroll
    for (int p = 0; p < kPer; ++p) carried[p * kSysThreads + i] = 0.0f;
  } else {
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      ssme::for_pair<kDraws>(k0, k1, kPairs * i + q, 0u, b,
                             [&](auto& rng, int e) {
                               model.init(rng, y, z, x[2 * q + e]);
                             });
    }
  }
  float lw[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) lw[p] = 0.0f;
  float carry = log_n;
  float lse_fs = 0.0f;        // apf: LSE of the step's first-stage weights
  float row_total = 0.0f;
  if constexpr (!kRoll) ssme::clear_marks<kPer>(marks);
  if constexpr (kSpans && !kRoll) ssme::clear_selections(sel_part);
  if constexpr (kSpans) {
    if (i == 0) {
#pragma unroll
      for (int k = 0; k < kNumSysSpans + 2; ++k) rec[k] = 0;
      rec[kMark] = clock64();
    }
  }
  // a systematic selection of this thread's particles on their CDF
  // entries base + w[p] (warp_cdf raised), offset u0, total: the marks,
  // staged beside the moved values v, the barrier that publishes both,
  // the scan to the ancestors, then the gather
  auto systematic_resample = [&](const float (&w)[kPer], float base,
                                 float u0, float cdf_total, auto& v) {
    int fixups = 0;
    const int wrote = ssme::systematic_marks<kPer>(w, base, u0, cdf_total,
                                                   n, active, marks, fixups);
    if constexpr (kSpans) ssme::note_selection(sel_part, fixups, wrote);
    ssme::row_stage(v, active, buf, kRow);
    ssme::row_sync(bars);
    tick(kSpanStage);
    int anc[kPer];
    ssme::systematic_scan<kPer>(marks, active, anc);
    tick(kSpanWalk);
    ssme::row_gather(v, anc, buf, kRow);
  };
  // the same selection on a shared state: the marks and the barrier that
  // publishes them (the states were written at the step's transition, two
  // barriers before), the scan, then the gather into the other buffer
  auto shared_resample = [&](const float (&w)[kPer], float base, float u0,
                             float cdf_total) {
    int fixups = 0;
    const int wrote = ssme::systematic_marks<kPer>(w, base, u0, cdf_total,
                                                   n, active, marks, fixups);
    if constexpr (kSpans) ssme::note_selection(sel_part, fixups, wrote);
    ssme::row_sync(bars);
    tick(kSpanStage);
    int anc[kPer];
    ssme::systematic_scan<kPer>(marks, active, anc);
    tick(kSpanWalk);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int from = ssme::padded(anc[p]);
#pragma unroll
      for (int l = 0; l < kLeaves; ++l)
        st_next[l * kRow + staged + p] = st[l * kRow + from];
    }
    float* const was = st;
    st = st_next;
    st_next = was;
  };

  for (int t = 0; t < num_steps; ++t) {
    const uint32_t tu = static_cast<uint32_t>(t);
    float y_next[kObs];
    float z_next[kCov];
    if (t + 1 < num_steps) {
      load_row<kObs>(ys, t + 1, y_next);
      if constexpr (Model::kDimCov > 0) load_row<kCov>(zs, t + 1, z_next);
    }
    if (t > 0) {
      if constexpr (kApf && kRoll) {
        // the first stage under a roll resampler, streamed through shared
        // memory: each particle's lw + log g(lookahead) to the weights'
        // buffer, its state and log g(lookahead) to the gather buffers, as
        // they come, so that no particle's values wait in registers
        float m_loc[1] = {ssme::neg_inf()};
        if (active) {
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
            float look[kLeaves];
            model.prop_mu(x[p], y, z, look);
            const float lg = model.log_weight(look, y, z);
            const float fsw = lw[p] + lg;
            cdf[staged + p] = fsw;
            buf[kLeaves * kRow + staged + p] = lg;
#pragma unroll
            for (int l = 0; l < kLeaves; ++l)
              buf[l * kRow + staged + p] = x[p][l];
            m_loc[0] = fmaxf(m_loc[0], fsw);
          }
        }
        tick(kSpanPropagate);
        const float m_fs = ssme::row_max<1>(m_loc, active, max_part, bars);
        tick(kSpanMax);
        // the weights in place (each thread its own), then the sum, whose
        // barrier publishes them
        float s_fs[1] = {0.0f};
        if (active) {
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
            const float w = expf(cdf[staged + p] - m_fs);
            cdf[staged + p] = w;
            s_fs[0] += w;
          }
        }
        float base = 0.0f, sum_total = 0.0f;
        ssme::row_sums<1, false>(s_fs, 0.0f, sum_part, base, sum_total,
                                 bars);
        lse_fs = m_fs + logf(s_fs[0]);
        tick(kSpanSums);
        roll_ancestors(tu, ssme::kTagRollSelect, s_fs[0]);
        tick(kSpanWalk);
#pragma unroll
        for (int p = 0; p < kPer; ++p)
          ssme::row_take(x[p], ancestor(p), buf, kRow);
        tick(kSpanGather);
        // the transition, the second-stage weights against the selected
        // lookahead's density, read again from its staged value
#pragma unroll
        for (int q = 0; q < kPairs; ++q) {
          ssme::for_pair<kDraws>(k0, k1, kPairs * i + q, tu, b,
                                 [&](auto& rng, int e) {
                                   model.propagate(rng, x[2 * q + e], y, z);
                                 });
        }
        tick(kSpanPropagate);
#pragma unroll
        for (int p = 0; p < kPer; ++p)
          lw[p] = model.log_weight(x[p], y, z) -
                  buf[kLeaves * kRow + ssme::padded(ancestor(p))];
      } else if constexpr (kApf) {
        // the first stage: a systematic selection on lw + log
        // g(lookahead), its offset drawn by thread 0 and read after the
        // max's barrier
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
        systematic_resample(w, base, u0, cdf_total, v);
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
        tick(kSpanPropagate);
#pragma unroll
        for (int p = 0; p < kPer; ++p)
          lw[p] = model.log_weight(x[p], y, z) - v[p][kLeaves];
      } else if constexpr (kShared) {
#pragma unroll 1
        for (int q = 0; q < kPairs; ++q) leaf_draws(q, tu, false);
        tick(kSpanPropagate);
      } else {
#pragma unroll
        for (int q = 0; q < kPairs; ++q) {
          ssme::for_pair<kDraws>(k0, k1, kPairs * i + q, tu, b,
                                 [&](auto& rng, int e) {
                                   model.propagate(rng, x[2 * q + e], y, z);
                                 });
        }
        tick(kSpanPropagate);
      }
    }
    if constexpr (kShared) {
#pragma unroll 1
      for (int p = 0; p < kPer; ++p) {
        float v[kLeaves];
        load_particle(p, v);
        carried[p * kSysThreads + i] += model.log_weight(v, y, z);
      }
    } else if (!kApf || t == 0) {
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        lw[p] = lw[p] + model.log_weight(x[p], y, z);
    }
    tick(kSpanWeight);
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
    // bootstrap: the step word of a resample that may follow (g = 1: step
    // t + 1's), and under systematic selection its offset, drawn by thread
    // 0 ahead of the reductions, so its Philox rounds overlap them, and
    // read after the max's barrier
    const uint32_t t_resample = gate_stride == 1 ? tu + 1 : tu;
    if (!kApf && !kRoll && i == 0)
      offset = ssme::offset_at(k0, k1, t_resample, b);
    if constexpr (kShared) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) lw[p] = carried[p * kSysThreads + i];
    }
    tick(kSpanPropagate);
    const float m = ssme::row_max<kPer>(lw, active, max_part, bars);
    const float u0 = kRoll ? 0.0f : offset;
    tick(kSpanMax);
    constexpr int kSums = kApf ? 2 : 3;
    float w[kPer];
    float s[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = 0.0f;
    if constexpr (kRoll && !kApf) {
      // each particle's weight and state to shared memory as they come,
      // which the sums' barrier publishes for a resample that may follow
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const float wp = active ? expf(lw[p] - m) : 0.0f;
        lw[p] = lw[p] - m;
        s[0] += wp;
        s[1] += model.functional(x[p]) * wp;
        s[2] += wp * wp;
        if (active) {
          cdf[staged + p] = wp;
#pragma unroll
          for (int l = 0; l < kLeaves; ++l)
            buf[l * kRow + staged + p] = x[p][l];
        }
        carried[p * kSysThreads + i] = lw[p];
      }
    } else {
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        w[p] = active ? expf(lw[p] - m) : 0.0f;
        lw[p] = lw[p] - m;
        s[0] += w[p];
        if constexpr (kShared) {
          float v[kLeaves];
          load_particle(p, v);
          s[1] += model.functional(v) * w[p];
        } else {
          s[1] += model.functional(x[p]) * w[p];
        }
        if constexpr (!kApf) s[2] += w[p] * w[p];
      }
    }
    float base = 0.0f, cdf_total = 0.0f;
    if constexpr (kApf) {
      ssme::row_sums<2, false>(s, 0.0f, sum_part, base, cdf_total, bars);
    } else if constexpr (kRoll) {
      ssme::row_sums<3, false>(s, 0.0f, sum_part, base, cdf_total, bars);
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
      if constexpr (kRoll) {
        // the states from the ancestors' staged ones (a check without a
        // resample: their own), the log-weights from shared memory
        if (resample) {
          roll_ancestors(t_resample, ssme::kTagRollSweep, s[0]);
          tick(kSpanWalk);
        }
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          ssme::row_take(x[p], resample ? ancestor(p) : kPer * i + p, buf,
                         kRow);
          lw[p] = resample ? 0.0f : carried[p * kSysThreads + i];
        }
        if (resample) {
          carry = log_n;
          count(kSpanResamples);
          tick(kSpanGather);
        }
      } else if (resample) {
        ssme::warp_cdf_raise<kPer>(w, active);
        if constexpr (kShared) {
          shared_resample(w, base, u0, cdf_total);
        } else {
          systematic_resample(w, base, u0, cdf_total, x);
        }
#pragma unroll
        for (int p = 0; p < kPer; ++p) lw[p] = 0.0f;
        carry = log_n;
        count(kSpanResamples);
        tick(kSpanGather);
      }
      if constexpr (kShared) {
#pragma unroll
        for (int p = 0; p < kPer; ++p) carried[p * kSysThreads + i] = lw[p];
      }
      close_step(resample ? kSpanBarResample : kSpanBarCheck);
    }
  }
  if constexpr (kSpans && !kRoll)
    ssme::fold_selections(sel_part, rec[kSpanFixups], rec[kSpanMostMarks]);
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
      for (int l = 0; l < kLeaves; ++l)
        cloud[l * plane + at + p] =
            kShared ? st[l * kRow + staged + p] : x[p][l];
      cloud_lw[at + p] = lw[p];
    }
  }
}

// one launch of an instance; spans, sweeps and ratio: the twins' records
template <class Model, bool kApf, int kPer, bool kRoll, bool kSpans = false>
int launch_sys(const Launch& a, long long* spans = nullptr,
               int* sweeps = nullptr, float* ratio = nullptr) {
  constexpr int kMoved = Model::kNumState + (kApf ? 1 : 0);
  constexpr bool kShared = ssme::SharedState<Model>::value;
  constexpr int kBytes =
      row_floats<kMoved, kPer, (kRoll && !kApf) || kShared,
                 kShared ? Model::kNumState : 0>() * 4;
  auto* kernel = filter_megakernel_sys<Model, kApf, kPer, kSpans, kRoll>;
  int dynamic = 0;
  if constexpr (kBytes > kStaticBytes) {
    dynamic = kBytes;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if constexpr (kShared) {
    // two CTAs an SM need 2 x 110 KB at kPer 4: the largest carveout
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = (a.num_particles / kPer + 31) / 32 * 32;
  kernel<<<a.num_rows, threads, dynamic, a.stream>>>(
      a.seed, a.params, a.ys, a.zs, a.num_steps, a.num_particles,
      a.ess_limit, a.always, a.gate_stride, a.total, a.lcl, a.fmean,
      a.cloud, a.cloud_lw, spans,
      RollArgs{a.resampler, a.metropolis_iters, sweeps, ratio});
  return static_cast<int>(cudaGetLastError());
}

// the instances of every model id at kPer in one selection family; -1 for
// an unknown id, -2 for APF mode on a functor without a lookahead, -4 for
// a roll resampler on a shared-state functor (systematic family only)
template <int kPer, bool kRoll>
int dispatch_family(int model_id, int apf, const Launch& a) {
  return ssme::with_model(model_id, [&](auto is) -> int {
    using Model = typename decltype(is)::type;
    if constexpr (kRoll && ssme::SharedState<Model>::value) {
      return -4;
    } else {
      if (!apf) return launch_sys<Model, false, kPer, kRoll>(a);
      if constexpr (Model::kHasPropMu) {
        return launch_sys<Model, true, kPer, kRoll>(a);
      } else {
        return -2;
      }
    }
  });
}

// the instrumented twins at kPer: svol_leverage in both modes and, under
// the roll resamplers, svol's bootstrap; under systematic selection also
// factor_svol_sv_10's bootstrap; -1 for another functor or mode
template <int kPer, bool kRoll>
int dispatch_spans(int model_id, int apf, const Launch& a, long long* spans,
                   int* sweeps, float* ratio) {
  if constexpr (!kRoll) {
    if (model_id == ssme::kModelFactorSvolSv10 && !apf)
      return launch_sys<ssme::FactorSvolSvModel<10>, false, kPer, false,
                        true>(a, spans, sweeps, ratio);
  }
  if (model_id == ssme::kModelSvolLeverage) {
    using Model = ssme::SvolLeverageModel;
    return apf ? launch_sys<Model, true, kPer, kRoll, true>(a, spans, sweeps,
                                                            ratio)
               : launch_sys<Model, false, kPer, kRoll, true>(a, spans,
                                                             sweeps, ratio);
  }
  if constexpr (kRoll) {
    if (model_id == ssme::kModelSvol && !apf)
      return launch_sys<ssme::SvolModel, false, kPer, true, true>(
          a, spans, sweeps, ratio);
  }
  return -1;
}

// the instances, one translation unit per family and kPer
// (filter_megakernel_sys{2,4}.cu, filter_megakernel_sys_roll{2,4,8,16}.cu);
// spans null for the plain instances, else the twins' records
int dispatch_sys2(int model_id, int apf, const Launch& a, long long* spans,
                  int* sweeps, float* ratio);
int dispatch_sys4(int model_id, int apf, const Launch& a, long long* spans,
                  int* sweeps, float* ratio);
int dispatch_roll2(int model_id, int apf, const Launch& a, long long* spans,
                   int* sweeps, float* ratio);
int dispatch_roll4(int model_id, int apf, const Launch& a, long long* spans,
                   int* sweeps, float* ratio);
int dispatch_roll8(int model_id, int apf, const Launch& a, long long* spans,
                   int* sweeps, float* ratio);
int dispatch_roll16(int model_id, int apf, const Launch& a, long long* spans,
                    int* sweeps, float* ratio);

}  // namespace ssme_fmk
