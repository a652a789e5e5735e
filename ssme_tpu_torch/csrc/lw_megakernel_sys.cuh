// The Liu-West filter kernel, laid out for Hopper: F filters, each on a
// joint (state, theta) cloud of N particles, over T observations in ONE
// launch, APF or SISR, for every functor of lw_models.cuh, under a
// selection family that is a template parameter: systematic (N a
// multiple of 32 in [32, 1024], the JAX package's
// MAX_LW_KERNEL_PARTICLES) or the roll resamplers (kRoll; Metropolis or
// rejection, chosen at run time, roll_select.cuh; N a power of two in
// [32, 4096], the JAX package's MAX_LW_METROPOLIS_PARTICLES).
//
// Replaces ssme_tpu/ops/liu_west_megakernel.py::lw_megakernel (the Pallas
// body _build_kernel: moments and shrinkage :369-382, the APF lookahead
// and joint selection :385-401, the Cholesky, the kernel draws and the
// weights :413-444) and, through its svol_leverage_lw instance,
// ssme_tpu/ops/svol_leverage_lw_kernel.py::svol_leverage_lw_pallas.  The
// step recursion and the intended divergences from the Pallas kernel are
// those of lw_megakernel.cuh's note.
//
// Layout: one CTA per filter (the systematic family's paired layout adds
// a second, below); thread i owns kPer NEIGHBOURING particles
// j = kPer * i + p, blockDim = N / kPer rounded up to a warp, the lanes
// past N / kPer masked (N = 32 or 96 leave part of a warp empty); the
// Philox counters stay keyed by the particle index, so the prior
// uniforms, the kernel draws, the transition draws, the offsets and the
// roll sweeps are the plain version's bits.
//  - systematic (lw_sys_row): the template takes kPer 2 or 4; the
//    instances run kLWPer = 2 at every N, from the grid measured on the
//    card (PERF.md §6: kPer 4 lost 13-32%).  Each particle keeps its
//    state, theta[P] and its log-weight in registers for all T steps.
//    Shared memory holds the selections' marks and one padded gather
//    buffer per leaf (row_select.cuh; S + 1 + P leaves, 25 KB at N = 1024
//    for the leverage model), the partial buffers of the exchanges and
//    the step's two selection offsets.  Two layouts (lw_ring.cuh), one
//    row and the same bits: single, one CTA a filter, which draws its own
//    random numbers; paired, a cluster of two CTAs a filter (grid 2F), whose
//    rank 1 draws each step's P + kDraws normal pairs and both offsets
//    into a ring of 4 steps in rank 0's dynamic shared memory (20 KB a
//    step at N = 1024 for the leverage model) while rank 0 runs the row,
//    each CTA on an SM of its own (pair_dynamic_bytes).  The wrapper takes
//    the paired layout when the card holds every filter's cluster at once
//    (cudaOccupancyMaxActiveClusters, PairClusters), else the single one:
//    past that count the clusters run in two waves, 60-69% slower than
//    one CTA a filter at F = 67-132 on the H100 (PERF.md §6).
//  - roll (lw_roll_row): kPer 2 to N = 1024, then 4 and 8 (roll_kper_for,
//    from the grid measured on the card), at most 512 threads.  At 8
//    particles a thread the particles' values (S + P floats each, the
//    log-weight, the lookahead density, the functionals) would not fit
//    the 128 registers of 512 threads, so they live in dynamic shared
//    memory at a constant stride, slot p of thread i at p * kThreads + i
//    (a blockDim stride would keep the addresses in registers), and a
//    thread streams through them a pair at a time; the row's weights sit
//    at NeighbourSlots' padded indices (roll_select.cuh), and the
//    ancestors (uint16) at the constant stride.  A selection hands its
//    ancestors to shared memory; the gather reads the ancestors' values
//    into registers, crosses one barrier and writes them to the thread's
//    own slots (no second copy of the cloud): 140 KB at N = 4096, set
//    with cudaFuncSetAttribute above 48 KB (roll_row_bytes).  APF's
//    first stage writes the lookahead's density beside the values and
//    the second stage reads its ancestor's there; the ancestor's shrunk
//    theta is recomputed from its gathered theta (the same operations,
//    the same bits).
// Instances (lw_megakernel_sys.cu, lw_megakernel_sys_pair.cu,
// lw_megakernel_sys_roll{2,4,8}.cu): every functor, and beside each an
// instrumented twin (kRecord), which counts
// the barriers a step crosses (a roll selection's votes and tail barriers
// apart, with its sweeps and tail slots) and times its parts by clock64
// on thread 0 (the paired layout's waits on its ring apart).  A twin must
// compute its plain instance's bits, and the paired layout the single
// one's: ptxas fused the Cholesky's multiply-subtracts in one compilation
// and not in the other, so they are written as fmaf, the shrinkage's
// products are rounded apart, and so is the Student-t transition's
// (lw_models.cuh).
//
// What bounds it: per-step latency, not bytes.  At F <= 64 each row has an
// SM to itself (two in the paired layout), so the wall time is T times one
// row's step, and on the H100 that step waits on dependent arithmetic
// more than on its barriers: 8 warps a row at N = 512 hide less of it than
// 16 (PERF.md §6).  The paired layout takes the step's random numbers
// (five Philox calls and Box-Mullers a pair, and the offsets) off that
// chain: at F = 64, N = 512 the twins' draws part fell from about 3650 to
// 1300 cycles a step, the ring's wait costs about 220, and what is left
// is the model's arithmetic (transforms, densities, the Cholesky), the
// exchanges and the selection (PERF.md §6).  Under the roll
// resamplers the selections add one Philox call a pending slot and sweep
// (roll_select.cuh).  The design cuts the step's chain of barriers and
// its random-number work:
//  - barriers per step (row_select.cuh: one per exchange; the max's
//    partial buffer and two sums' buffers, A and B, used so that a buffer
//    is written again only after another barrier that every thread
//    crosses after its last read of it):
//      the moments, 2: sum w and sum w theta (A), then the centred Gram
//      sum w (theta - bar)(theta - bar)' (B), the two-pass form;
//      APF's first stage, 3: the max, one exchange that carries only the
//      warps' CDF totals (A; its chained total, bit for bit the CDF's last
//      entry, gives LSE(fsw); roll: the sum of the weights, whose barrier
//      publishes them), and the stage of the marks with the S + 1 + P
//      leaves (state, the lookahead's log-density, shrunk theta), then the
//      scan and the gather (roll: the selection, then the gather's
//      barrier);
//      the weights, 2: the max, and one exchange (B) of s, the functional
//      sums, s^2 and the warps' CDF totals (roll: the weights published);
//      a step that resamples stages the marks with the S + P leaves
//      (state, theta) and crosses 1 more (roll: the gather's);
//    so 8 in an APF step that resamples, 7 in one that does not, 5 and 4
//    in SISR, 3 and 2 at t = 0, in both families (one particle per thread,
//    with two barriers an exchange and two a gathered leaf, took about
//    40), besides a roll selection's votes (rejection: one per chunk of 32
//    sweeps) and its tail's two;
//  - the Cholesky of h^2 Vt on every thread, from the Gram sums every
//    thread holds with the same bits, into registers (no thread-0 factor,
//    no shared theta_bar, no barrier to publish them), one reciprocal a
//    column in place of a divide an entry;
//  - paired draws: particles 2q and 2q + 1 share Philox counter (q, t, b,
//    tag of draw k) and a thread, so one philox4x32_10 call and one
//    Box-Muller give draw k of both, for the P kernel draws and, through
//    ssme::for_pair from draw P on, the transition's or sample_q's
//    (step_rng.cuh): half the calls of one particle per thread;
//  - systematic selection without a search: each particle counts the
//    points at or below its CDF entry in registers and marks its first
//    slot, and each thread scans its slots' marks after the stage's
//    barrier (row_select.cuh systematic_marks, systematic_scan); roll
//    selection keyed by slot (roll_select.cuh: shift scans by chunks of
//    32 sweeps, a vote per chunk, a sweep-parallel tail), the row's
//    largest weight exactly 1;
//  - the two systematic offsets (first stage, tag 2^31 + 1; resample, tag
//    1) drawn by thread 0 (paired: read off the ring) ahead of the max
//    that precedes their use, and read after it; y_{t+1} and z_{t+1}
//    loaded a step ahead;
//  - the paired layout, where the card holds every filter's cluster:
//    draws computed off the row's SM, ahead of their use (lw_ring.cuh).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "lw_megakernel.cuh"
#include "lw_models.cuh"
#include "lw_ring.cuh"
#include "philox.cuh"
#include "roll_select.cuh"
#include "row_select.cuh"
#include "step_rng.cuh"

namespace ssme_lw {

// particles per thread of the instances, at every N (at N = 1024, 512
// threads), from the grid measured on the card (PERF.md §6)
constexpr int kLWPer = 2;

// The twins record, per row, by thread 0 in shared memory:
// the clock64 cycles of the step's parts (t = 0: the prior and init draws
// count under draws; the paired layout's waits on its ring apart, 0 in the
// single layout), the rows' resamples at t = 0 and at t > 0, the
// barriers crossed at t = 0 in a step that resamples and in one that does
// not, and at t > 0 likewise (a roll selection's apart), the roll
// selections' votes and tail barriers, the sweeps they ran (1 + the last
// accept sweep, 4096 at the cap) and the slots their tails took, the
// systematic selections' fix-ups (counts whose first guess missed, both
// selections of a step) and the most marks one thread wrote in a
// selection (row_select.cuh note_selection), and the layout the launch
// ran (kPer, blockDim, CTAs a filter).
enum LWSpan { kLWSpanMoments, kLWSpanCholesky, kLWSpanFirstStage,
              kLWSpanDraws, kLWSpanWeigh, kLWSpanResample, kLWSpanRingWait,
              kLWSpanFirstResamples, kLWSpanResamples,
              kLWSpanBarFirstResample, kLWSpanBarFirstOther,
              kLWSpanBarResample, kLWSpanBarOther, kLWSpanVotes,
              kLWSpanTailBars, kLWSpanSweeps, kLWSpanTailSlots,
              kLWSpanFixups, kLWSpanMostMarks, kLWSpanLayoutPer,
              kLWSpanLayoutThreads, kLWSpanCluster, kNumLWSpans };

// one vector store of a thread's kPer neighbouring values of a cloud row
template <int kPer>
__device__ __forceinline__ void store_neighbours(float* dst,
                                                 const float (&v)[kPer]) {
  if constexpr (kPer == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// the unrolled P x P Cholesky of h^2 Vt on every thread, the floored
// diagonal, from h2w = h^2 / sum w and the Gram sums, v2[r (r + 1) / 2 + c]
// entry (r, c).  One divide for h^2 / wsum and a reciprocal per column
// (the plain version divides each entry: a few ulp apart); each
// subtraction of a product is one fmaf, and h^2 G is rounded before it,
// so every compilation rounds alike.
template <int P>
__device__ __forceinline__ void kernel_cholesky(float h2w, const float* v2,
                                                float (&chol)[P][P]) {
#pragma unroll
  for (int jj = 0; jj < P; ++jj) {
    float acc = __fmul_rn(h2w, v2[jj * (jj + 1) / 2 + jj]);
#pragma unroll
    for (int k = 0; k < jj; ++k) acc = fmaf(-chol[jj][k], chol[jj][k], acc);
    chol[jj][jj] = sqrtf(acc < kEpsChol ? kEpsChol : acc);
    const float inv_d = 1.0f / chol[jj][jj];
#pragma unroll
    for (int r = jj + 1; r < P; ++r) {
      float acc2 = __fmul_rn(h2w, v2[r * (r + 1) / 2 + jj]);
#pragma unroll
      for (int k = 0; k < jj; ++k)
        acc2 = fmaf(-chol[r][k], chol[jj][k], acc2);
      chol[r][jj] = acc2 * inv_d;
    }
  }
}

// shrunk = a theta + (1 - a) theta_bar, both products rounded as the plain
// version rounds them
__device__ __forceinline__ float shrink(const LWArgs& args, float th,
                                        float tbar) {
  return __fadd_rn(__fmul_rn(args.a, th), __fmul_rn(args.one_minus_a, tbar));
}

// one row of the systematic family (the kernel's note above): filter b of
// num_filters, its draws at t >= 1 from `draws` (lw_ring.cuh: OwnDraws in
// the single layout, RingDraws in the paired one)
template <class Model, int kPer, bool kRecord, class Draws>
__device__ __forceinline__ void lw_sys_row(
    const int64_t* __restrict__ seed, const float* __restrict__ ys,
    const float* __restrict__ zs, int num_steps, int num_particles, int apf,
    int resample_every, float ess_limit, const LWArgs& args,
    float* __restrict__ lcl, float* __restrict__ fpaths,
    float* __restrict__ cloud, long long* __restrict__ spans, uint32_t b,
    int num_filters, const Draws& draws) {
  static_assert(kPer == 2 || kPer == 4, "whole Philox pairs, kPer | 32");
  constexpr int kPairs = kPer / 2;
  constexpr int P = Model::kNumParams;
  constexpr int S = Model::kNumState;
  constexpr int K = Model::kNumFunctionals;
  constexpr int kK = K > 0 ? K : 1;
  constexpr int kGram = P * (P + 1) / 2;
  constexpr int kDraws = Model::kDraws;
  constexpr int kCov = Model::kDimCov > 0 ? Model::kDimCov : 1;
  constexpr int kLook = S + 1 + P;  // leaves APF's first stage moves
  constexpr int kJoint = S + P;     // leaves the joint resample moves
  constexpr int kRow = ssme::padded_size(kMaxThreads);
  __shared__ __align__(16) int marks[kMaxThreads];  // the selections'
  __shared__ float buf[kLook * kRow];
  __shared__ float max_part[32];
  // A: the moments' first pass, the first stage's scan; B: the Gram, the
  // weights' sums and scan
  __shared__ float4 sums_a[32 * ssme::wide_stride(1 + P) / 4];
  __shared__ float4 sums_b[32 * cmax(ssme::wide_stride(kGram),
                                    ssme::wide_stride(K + 3)) / 4];
  __shared__ float offsets[2];  // first stage, resample; thread 0 draws
                                // them (paired: reads them off the ring)
  // the twin's record: the spans, then the last clock read and this
  // step's barriers
  constexpr int kMark = kNumLWSpans, kStepBars = kNumLWSpans + 1;
  __shared__ long long rec[kRecord ? kNumLWSpans + 2 : 1];
  long long* const bars = kRecord ? &rec[kRecord ? kStepBars : 0] : nullptr;
  // the selections' record (note_selection), each warp's folded at the
  // row's end through sel_part
  __shared__ int sel_part[kRecord ? 64 : 1];

  const uint32_t i = threadIdx.x;
  const int n = num_particles;
  const bool active = static_cast<int>(kPer * i) < n;
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const Model model(args.model);
  const float log_n = logf(static_cast<float>(n));
  float* lcl_row = lcl + static_cast<size_t>(b) * num_steps;

  auto tick = [&](int k) {
    if constexpr (kRecord) {
      if (i == 0) {
        const long long now = clock64();
        rec[k] += now - rec[kMark];
        rec[kMark] = now;
      }
    }
  };
  // the step's barriers to the count of its kind
  auto close_step = [&](int kind) {
    if constexpr (kRecord) {
      if (i == 0) {
        rec[kind] += rec[kStepBars];
        rec[kStepBars] = 0;
      }
    }
  };
  auto count = [&](int k) {
    if constexpr (kRecord) {
      if (i == 0) rec[k] += 1;
    }
  };
  ssme::clear_marks<kPer>(marks);
  if constexpr (kRecord) ssme::clear_selections(sel_part);
  if constexpr (kRecord) {
    if (i == 0) {
#pragma unroll
      for (int k = 0; k < kNumLWSpans + 2; ++k) rec[k] = 0;
      rec[kMark] = clock64();
    }
  }
  // a systematic selection of this thread's particles on their CDF
  // entries base + w[p] (warp_cdf raised), offset u0, total: the marks,
  // staged beside the moved values g, the barrier that publishes both,
  // the scan to the ancestors, then the gather
  auto systematic_resample = [&](const float (&w)[kPer], float base,
                                 float u0, float total, auto& g) {
    int fixups = 0;
    const int wrote = ssme::systematic_marks<kPer>(w, base, u0, total, n,
                                                   active, marks, fixups);
    if constexpr (kRecord) ssme::note_selection(sel_part, fixups, wrote);
    ssme::row_stage(g, active, buf, kRow);
    ssme::row_sync(bars);
    int anc[kPer];
    ssme::systematic_scan<kPer>(marks, active, anc);
    ssme::row_gather(g, anc, buf, kRow);
  };

  float y[Model::kDimObs], z[kCov];
  float x[kPer][S], th[kPer][P], lw[kPer];
  float lw_new[kPer];
  float hv[kPer][kK];  // the functionals of the step's particles

  // The weights' max, then one exchange of s, the functional sums, s^2
  // and the warps' CDF totals; lcl and the functional means of column t
  // by thread 0; lw = lw_new - max; and, when the row resamples, the marks
  // and the stage of (state, theta), the scan and the gather, lw = 0.
  // lcl_of(lse) gives column t's value from LSE(lw_new).  Returns whether
  // the row resampled.  At t > 0 the max's barrier follows every read of
  // the step's draws, so the paired layout frees its ring slot there.
  auto weigh_and_resample = [&](int t, auto lcl_of) -> bool {
    const uint32_t tu = static_cast<uint32_t>(t);
    const bool may_fire = ess_limit > 0.0f || resample_every == 1 ||
                          (t + 1) % resample_every == 0;
    if (may_fire && i == 0)
      offsets[1] = t == 0 ? ssme::offset_at(k0, k1, 0u, b)
                          : draws.offset(tu, ssme::kTagOffset);
    const float m = ssme::row_max<kPer>(lw_new, active, max_part, bars);
    if (t > 0) draws.release(tu);
    float w[kPer];
    float v[K + 2];
#pragma unroll
    for (int k = 0; k < K + 2; ++k) v[k] = 0.0f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      w[p] = active ? expf(lw_new[p] - m) : 0.0f;
      lw[p] = lw_new[p] - m;
      v[0] += w[p];
#pragma unroll
      for (int k = 0; k < K; ++k) v[1 + k] += hv[p][k] * w[p];
      v[K + 1] += w[p] * w[p];
    }
#pragma unroll
    for (int k = 0; k < K + 2; ++k) v[k] = active ? v[k] : 0.0f;
    ssme::warp_cdf<kPer>(w, active);
    const float warp_last = ssme::warp_cdf_total<kPer>(w, active);
    float base = 0.0f, total = 0.0f;
    ssme::row_sums_wide<K + 2, true>(v, warp_last, sums_b, base, total,
                                     bars);
    if (i == 0) {
      lcl_row[t] = lcl_of(m + logf(v[0]));
#pragma unroll
      for (int k = 0; k < K; ++k)
        fpaths[(static_cast<size_t>(k) * num_filters + b) * num_steps + t] =
            v[1 + k] / v[0];
    }
    tick(kLWSpanWeigh);
    const bool fire = ess_limit > 0.0f ? v[0] * v[0] / v[K + 1] < ess_limit
                                       : may_fire;
    if (!fire) return false;
    ssme::warp_cdf_raise<kPer>(w, active);
    float g[kPer][kJoint];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
#pragma unroll
      for (int l = 0; l < S; ++l) g[p][l] = x[p][l];
#pragma unroll
      for (int k = 0; k < P; ++k) g[p][S + k] = th[p][k];
    }
    systematic_resample(w, base, offsets[1], total, g);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
#pragma unroll
      for (int l = 0; l < S; ++l) x[p][l] = g[p][l];
#pragma unroll
      for (int k = 0; k < P; ++k) th[p][k] = g[p][S + k];
      lw[p] = 0.0f;
    }
    tick(kLWSpanResample);
    return true;
  };

  // t = 0: the prior draw (uniforms keyed by the particle), the init draw
  // from draw P on, the first weights
  load_step<Model>(ys, zs, 0, y, z);
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    ssme::for_pair<kDraws>(
        k0, k1, kPairs * i + q, 0u, b,
        [&](auto& rng, int e) {
          const int p = 2 * q + e;
          const uint32_t j = kPer * i + p;
          float cp[P];
#pragma unroll
          for (int blk = 0; blk < (P + 3) / 4; ++blk) {
            const float4 u = ssme::prior_uniforms_at(k0, k1, j, blk, b);
            const float uu[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int c = 0; c < 4 && 4 * blk + c < P; ++c) {
              const int k = 4 * blk + c;
              cp[k] = args.prior_lo[k] + args.prior_scale[k] * uu[c];
              th[p][k] = ssme::to_transformed(Model::code(k), cp[k]);
            }
          }
          model.init(rng, cp, y, z, x[p]);
          lw_new[p] = model.log_weight(cp, x[p], y, z);
#pragma unroll
          for (int k = 0; k < K; ++k) hv[p][k] = model.functional(k, cp, x[p]);
        },
        static_cast<uint32_t>(P));
  }
  tick(kLWSpanDraws);
  {
    const bool fired = weigh_and_resample(
        0, [&](float lse) { return lse - log_n; });
    if (fired) count(kLWSpanFirstResamples);
    close_step(fired ? kLWSpanBarFirstResample : kLWSpanBarFirstOther);
  }

  float y_next[Model::kDimObs], z_next[kCov];
  if (num_steps > 1) load_step<Model>(ys, zs, 1, y_next, z_next);
  for (int t = 1; t < num_steps; ++t) {
    const uint32_t tu = static_cast<uint32_t>(t);
    if constexpr (Draws::kPaired) {
      tick(kLWSpanMoments);  // the loop's top, as in the single layout
      draws.wait(tu);
      tick(kLWSpanRingWait);
    }
#pragma unroll
    for (int k = 0; k < Model::kDimObs; ++k) y[k] = y_next[k];
#pragma unroll
    for (int k = 0; k < Model::kDimCov; ++k) z[k] = z_next[k];
    if (t + 1 < num_steps) load_step<Model>(ys, zs, t + 1, y_next, z_next);

    // weighted shrinkage moments in two passes; lw has maximum 0
    float ww[kPer];
    float v1[1 + P];
#pragma unroll
    for (int k = 0; k < 1 + P; ++k) v1[k] = 0.0f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      ww[p] = expf(lw[p]);
      v1[0] += ww[p];
#pragma unroll
      for (int k = 0; k < P; ++k) v1[1 + k] += th[p][k] * ww[p];
    }
    // an inactive lane's particles count for nothing (selects, not
    // branches, so the neighbours' folds stay one block of code)
#pragma unroll
    for (int k = 0; k < 1 + P; ++k) v1[k] = active ? v1[k] : 0.0f;
    float unused_base, unused_total;
    ssme::row_sums_wide<1 + P, false>(v1, 0.0f, sums_a, unused_base,
                                      unused_total, bars);
    const float wsum = v1[0];
    float tbar[P];
#pragma unroll
    for (int k = 0; k < P; ++k) tbar[k] = v1[1 + k] / wsum;
    float v2[kGram];
#pragma unroll
    for (int k = 0; k < kGram; ++k) v2[k] = 0.0f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      float cen[P];
#pragma unroll
      for (int k = 0; k < P; ++k) cen[k] = th[p][k] - tbar[k];
      int at = 0;
#pragma unroll
      for (int r = 0; r < P; ++r)
#pragma unroll
        for (int c = 0; c <= r; ++c, ++at) v2[at] += (cen[r] * ww[p]) * cen[c];
    }
#pragma unroll
    for (int k = 0; k < kGram; ++k) v2[k] = active ? v2[k] : 0.0f;
    ssme::row_sums_wide<kGram, false>(v2, 0.0f, sums_b, unused_base,
                                      unused_total, bars);
    tick(kLWSpanMoments);
    float chol[P][P];
    kernel_cholesky<P>(args.h2 / wsum, v2, chol);
    float shrunk[kPer][P];
#pragma unroll
    for (int p = 0; p < kPer; ++p)
#pragma unroll
      for (int k = 0; k < P; ++k)
        shrunk[p][k] = shrink(args, th[p][k], tbar[k]);
    tick(kLWSpanCholesky);

    float lg_anc[kPer];
    float lse_fs = 0.0f;
    if (apf) {
      // the first stage: lookahead at the pre-shrinkage theta, weights
      // lw + log g(y, lookahead; shrunk), a systematic selection, and the
      // joint gather of (state, log g(y, lookahead; shrunk), shrunk
      // theta): the ancestor's lookahead density moves with it, the value
      // the second stage would recompute from the gathered lookahead and
      // shrunk theta
      if (i == 0) offsets[0] = draws.offset(tu, ssme::kTagSelectOffset);
      float g[kPer][kLook];
      float lfs[kPer];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        float cp[P], look[S];
        constrain<Model>(th[p], cp);
        model.prop_mu(cp, x[p], y, z, look);
        constrain<Model>(shrunk[p], cp);
        const float lg = model.log_weight(cp, look, y, z);
        lfs[p] = lw[p] + lg;
#pragma unroll
        for (int l = 0; l < S; ++l) g[p][l] = x[p][l];
        g[p][S] = lg;
#pragma unroll
        for (int k = 0; k < P; ++k) g[p][S + 1 + k] = shrunk[p][k];
      }
      const float mfs = ssme::row_max<kPer>(lfs, active, max_part, bars);
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        lfs[p] = active ? expf(lfs[p] - mfs) : 0.0f;
      ssme::warp_cdf<kPer>(lfs, active);
      const float warp_last = ssme::warp_cdf_raise<kPer>(lfs, active);
      float base = 0.0f, total = 0.0f;
      ssme::row_sums_wide<0, true>(nullptr, warp_last, sums_a, base, total,
                                   bars);
      lse_fs = mfs + logf(total);
      systematic_resample(lfs, base, offsets[0], total, g);
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
#pragma unroll
        for (int l = 0; l < S; ++l) x[p][l] = g[p][l];
        lg_anc[p] = g[p][S];
#pragma unroll
        for (int k = 0; k < P; ++k) shrunk[p][k] = g[p][S + 1 + k];
      }
      tick(kLWSpanFirstStage);
    }

    // pair by pair: the kernel draws theta' = shrunk_anc + L e (draws 0 ..
    // P-1), then the transition or sample_q from draw P on, the weights
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const uint32_t qg = kPairs * i + q;
      const int p0 = 2 * q, p1 = 2 * q + 1;
#pragma unroll
      for (int r = 0; r < P; ++r) {
        th[p0][r] = shrunk[p0][r];
        th[p1][r] = shrunk[p1][r];
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float2 e = draws.kernel_normal(qg, tu, k);
#pragma unroll
        for (int r = k; r < P; ++r) {
          th[p0][r] = th[p0][r] + chol[r][k] * e.x;
          th[p1][r] = th[p1][r] + chol[r][k] * e.y;
        }
      }
      draws.template for_pair<kDraws>(
          qg, tu,
          [&](auto& rng, int e) {
            const int p = 2 * q + e;
            float cp[P];
            constrain<Model>(th[p], cp);
            if (apf) {
              model.propagate(rng, cp, x[p], y, z);
              lw_new[p] = model.log_weight(cp, x[p], y, z) - lg_anc[p];
            } else if constexpr (Model::kHasProposal) {
              // the SISR form's own proposal and its log f - log q
              float x_anc[S];
#pragma unroll
              for (int l = 0; l < S; ++l) x_anc[l] = x[p][l];
              model.sample_q(rng, cp, x_anc, y, z, x[p]);
              lw_new[p] = lw[p] + (model.log_weight(cp, x[p], y, z) +
                                   model.log_fq(cp, x[p], x_anc, y, z));
            } else {
              model.propagate(rng, cp, x[p], y, z);
              lw_new[p] = lw[p] + model.log_weight(cp, x[p], y, z);
            }
#pragma unroll
            for (int k = 0; k < K; ++k)
              hv[p][k] = model.functional(k, cp, x[p]);
          },
          static_cast<uint32_t>(P));
    }
    tick(kLWSpanDraws);
    const bool fired = weigh_and_resample(t, [&](float lse) {
      return apf ? ((lse_fs - logf(wsum)) + lse) - log_n
                 : lse - logf(wsum);
    });
    if (fired) count(kLWSpanResamples);
    close_step(fired ? kLWSpanBarResample : kLWSpanBarOther);
  }

  if constexpr (kRecord)
    ssme::fold_selections(sel_part, rec[kLWSpanFixups], rec[kLWSpanMostMarks]);
  if (kRecord && i == 0) {
    rec[kLWSpanLayoutPer] = kPer;
    rec[kLWSpanLayoutThreads] = blockDim.x;
    rec[kLWSpanCluster] = Draws::kPaired ? 2 : 1;
#pragma unroll
    for (int k = 0; k < kNumLWSpans; ++k)
      spans[kNumLWSpans * b + k] = rec[k];
  }
  if (active) {
    // rows [state x S, logw, theta x P], this thread's kPer neighbours in
    // one vector store per row
    float* out = cloud + static_cast<size_t>(b) * (S + 1 + P) * n + kPer * i;
    float row[kPer];
#pragma unroll
    for (int l = 0; l < S; ++l) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) row[p] = x[p][l];
      store_neighbours<kPer>(out + static_cast<size_t>(l) * n, row);
    }
    store_neighbours<kPer>(out + static_cast<size_t>(S) * n, lw);
#pragma unroll
    for (int k = 0; k < P; ++k) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) row[p] = th[p][k];
      store_neighbours<kPer>(out + static_cast<size_t>(S + 1 + k) * n, row);
    }
  }
}


// bytes of dynamic shared memory a roll instance's row takes: the weights
// (padded, NeighbourSlots), the S + P value leaves, the carried
// log-weights, the lookahead densities and the K functionals at kPer *
// kThreads floats each, and the ancestors (uint16)
template <class Model, int kPer, int kThreads>
__host__ __device__ constexpr int roll_row_bytes() {
  constexpr int kSlots = kPer * kThreads;
  return 4 * (ssme::padded_size(kSlots) +
              (Model::kNumState + Model::kNumParams + 2 +
               Model::kNumFunctionals) * kSlots) +
         2 * kSlots;
}

// One row of the roll family: the systematic row's recursion and
// barriers, with each particle's values in shared memory (roll_row_bytes)
// at a constant stride, slot p of thread i at p * kThreads + i, so that a
// thread's registers hold only the pair it works on and the addresses
// take none; the selections are roll_select's, keyed by slot.
template <class Model, int kPer, int kThreads, bool kRecord>
__device__ __forceinline__ void lw_roll_row(
    const int64_t* __restrict__ seed, const float* __restrict__ ys,
    const float* __restrict__ zs, int num_steps, int num_particles, int apf,
    int resample_every, float ess_limit, int resampler, int metropolis_iters,
    const LWArgs& args, float* __restrict__ lcl, float* __restrict__ fpaths,
    float* __restrict__ cloud, long long* __restrict__ spans) {
  static_assert(kPer % 2 == 0 && 32 % kPer == 0, "whole Philox pairs");
  constexpr int kPairs = kPer / 2;
  constexpr int P = Model::kNumParams;
  constexpr int S = Model::kNumState;
  constexpr int K = Model::kNumFunctionals;
  constexpr int kGram = P * (P + 1) / 2;
  constexpr int kDraws = Model::kDraws;
  constexpr int kCov = Model::kDimCov > 0 ? Model::kDimCov : 1;
  constexpr int kSlots = kPer * kThreads;
  constexpr int kLeaves = S + P;  // value leaves: state, then theta
  extern __shared__ float lw_roll_arrays[];
  float* const wsh = lw_roll_arrays;
  float* const vals = wsh + ssme::padded_size(kSlots);
  float* const lwv = vals + kLeaves * kSlots;
  float* const lgv = lwv + kSlots;
  float* const hvv = lgv + kSlots;
  uint16_t* const anc = reinterpret_cast<uint16_t*>(hvv + K * kSlots);
  __shared__ float max_part[32];
  __shared__ float4 sums_a[32 * ssme::wide_stride(1 + P) / 4];
  __shared__ float4 sums_b[32 * cmax(ssme::wide_stride(kGram),
                                    ssme::wide_stride(K + 2)) / 4];
  constexpr int kMark = kNumLWSpans, kStepBars = kNumLWSpans + 1;
  __shared__ long long rec[kRecord ? kNumLWSpans + 2 : 1];
  long long* const bars = kRecord ? &rec[kRecord ? kStepBars : 0] : nullptr;
  __shared__ int roll_rec[kRecord ? 3 : 1];

  const uint32_t b = blockIdx.x;
  const uint32_t i = threadIdx.x;
  const int n = num_particles;
  const bool active = static_cast<int>(kPer * i) < n;
  const int num_filters = gridDim.x;
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const Model model(args.model);
  const float log_n = logf(static_cast<float>(n));
  float* lcl_row = lcl + static_cast<size_t>(b) * num_steps;

  auto tick = [&](int k) {
    if constexpr (kRecord) {
      if (i == 0) {
        const long long now = clock64();
        rec[k] += now - rec[kMark];
        rec[kMark] = now;
      }
    }
  };
  auto close_step = [&](int kind) {
    if constexpr (kRecord) {
      if (i == 0) {
        rec[kind] += rec[kStepBars];
        rec[kStepBars] = 0;
      }
    }
  };
  auto count = [&](int k) {
    if constexpr (kRecord) {
      if (i == 0) rec[k] += 1;
    }
  };
  if constexpr (kRecord) {
    if (i == 0) {
#pragma unroll
      for (int k = 0; k < kNumLWSpans + 2; ++k) rec[k] = 0;
      rec[kMark] = clock64();
    }
  }
  // this thread's slot p in the per-slot arrays, particle a's slot, and
  // this thread's weight entry of particle p (NeighbourSlots)
  auto own = [&](int p) { return p * kThreads + static_cast<int>(i); };
  auto slot_of = [](unsigned a) {
    return static_cast<int>((a % kPer) * kThreads + a / kPer);
  };
  auto weight_at = [&](int p) -> float& {
    return wsh[ssme::padded(kPer * static_cast<int>(i) + p)];
  };
  auto leaf = [&](int l, int slot) -> float& {
    return vals[l * kSlots + slot];
  };
  // the roll selection on the published weights wsh (their largest
  // exactly 1) at step word t on the sweep tags from tag_base, its
  // ancestors to anc; then every value leaf of this thread's particles
  // from its ancestor's, through registers and one barrier
  auto select_and_gather = [&](uint32_t t, uint32_t tag_base) {
#pragma unroll
    for (int p = 0; p < kPer; ++p)
      anc[own(p)] = static_cast<uint16_t>(kPer * i + p);
    ssme::roll_select<kPer, ssme::NeighbourSlots<kPer>>(
        resampler, metropolis_iters, active, wsh, 1.0f, n, k0, k1, t, b,
        tag_base,
        [&](int p, int a) { anc[own(p)] = static_cast<uint16_t>(a); },
        nullptr, kRecord ? roll_rec : nullptr);
    if constexpr (kRecord) {
      if (i == 0) {
        rec[kLWSpanVotes] += roll_rec[1];
        rec[kLWSpanTailBars] += roll_rec[2] > 0 ? 2 : 0;
        rec[kLWSpanSweeps] += roll_rec[0];
        rec[kLWSpanTailSlots] += roll_rec[2];
      }
    }
    float g[kPer][kLeaves];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int from = slot_of(anc[own(p)]);
#pragma unroll
      for (int l = 0; l < kLeaves; ++l) g[p][l] = leaf(l, from);
    }
    ssme::row_sync(bars);  // every read of the old values is done
#pragma unroll
    for (int p = 0; p < kPer; ++p)
#pragma unroll
      for (int l = 0; l < kLeaves; ++l) leaf(l, own(p)) = g[p][l];
  };

  // The weights' max, then one exchange of s, the functional sums and s^2
  // (whose barrier publishes the weights); lcl and the functional means of
  // column t by thread 0; lw = lw_new - max; and, when the row resamples,
  // the selection and the gather, lw = 0.  lwv holds lw_new on entry.
  auto weigh_and_resample = [&](int t, auto lcl_of) -> bool {
    float m_loc[1] = {ssme::neg_inf()};
#pragma unroll
    for (int p = 0; p < kPer; ++p) m_loc[0] = fmaxf(m_loc[0], lwv[own(p)]);
    const float m = ssme::row_max<1>(m_loc, active, max_part, bars);
    float v[K + 2];
#pragma unroll
    for (int k = 0; k < K + 2; ++k) v[k] = 0.0f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const float lw_new = lwv[own(p)];
      const float w = active ? expf(lw_new - m) : 0.0f;
      lwv[own(p)] = lw_new - m;
      v[0] += w;
#pragma unroll
      for (int k = 0; k < K; ++k) v[1 + k] += hvv[k * kSlots + own(p)] * w;
      v[K + 1] += w * w;
      if (active) weight_at(p) = w;
    }
#pragma unroll
    for (int k = 0; k < K + 2; ++k) v[k] = active ? v[k] : 0.0f;
    float base = 0.0f, total = 0.0f;
    ssme::row_sums_wide<K + 2, false>(v, 0.0f, sums_b, base, total, bars);
    if (i == 0) {
      lcl_row[t] = lcl_of(m + logf(v[0]));
#pragma unroll
      for (int k = 0; k < K; ++k)
        fpaths[(static_cast<size_t>(k) * num_filters + b) * num_steps + t] =
            v[1 + k] / v[0];
    }
    tick(kLWSpanWeigh);
    const bool fire = ess_limit > 0.0f
                          ? v[0] * v[0] / v[K + 1] < ess_limit
                          : resample_every == 1 ||
                                (t + 1) % resample_every == 0;
    if (!fire) return false;
    select_and_gather(static_cast<uint32_t>(t), ssme::kTagRollSweep);
#pragma unroll
    for (int p = 0; p < kPer; ++p) lwv[own(p)] = 0.0f;
    tick(kLWSpanResample);
    return true;
  };

  float y[Model::kDimObs], z[kCov];
  // t = 0: the prior draw (uniforms keyed by the particle), the init draw
  // from draw P on, the first weights
  load_step<Model>(ys, zs, 0, y, z);
  // one pair at a time (not unrolled: the values are in shared memory,
  // and an unrolled loop's interleaved pairs would hold registers)
#pragma unroll 1
  for (int q = 0; q < kPairs; ++q) {
    ssme::for_pair<kDraws>(
        k0, k1, kPairs * i + q, 0u, b,
        [&](auto& rng, int e) {
          const int p = 2 * q + e;
          const uint32_t j = kPer * i + p;
          float cp[P];
#pragma unroll
          for (int blk = 0; blk < (P + 3) / 4; ++blk) {
            const float4 u = ssme::prior_uniforms_at(k0, k1, j, blk, b);
            const float uu[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int c = 0; c < 4 && 4 * blk + c < P; ++c) {
              const int k = 4 * blk + c;
              cp[k] = args.prior_lo[k] + args.prior_scale[k] * uu[c];
              leaf(S + k, own(p)) = ssme::to_transformed(Model::code(k),
                                                         cp[k]);
            }
          }
          float x[S];
          model.init(rng, cp, y, z, x);
#pragma unroll
          for (int l = 0; l < S; ++l) leaf(l, own(p)) = x[l];
          lwv[own(p)] = model.log_weight(cp, x, y, z);
#pragma unroll
          for (int k = 0; k < K; ++k)
            hvv[k * kSlots + own(p)] = model.functional(k, cp, x);
        },
        static_cast<uint32_t>(P));
  }
  tick(kLWSpanDraws);
  {
    const bool fired = weigh_and_resample(
        0, [&](float lse) { return lse - log_n; });
    if (fired) count(kLWSpanFirstResamples);
    close_step(fired ? kLWSpanBarFirstResample : kLWSpanBarFirstOther);
  }

  float y_next[Model::kDimObs], z_next[kCov];
  if (num_steps > 1) load_step<Model>(ys, zs, 1, y_next, z_next);
  for (int t = 1; t < num_steps; ++t) {
    const uint32_t tu = static_cast<uint32_t>(t);
#pragma unroll
    for (int k = 0; k < Model::kDimObs; ++k) y[k] = y_next[k];
#pragma unroll
    for (int k = 0; k < Model::kDimCov; ++k) z[k] = z_next[k];
    if (t + 1 < num_steps) load_step<Model>(ys, zs, t + 1, y_next, z_next);

    // weighted shrinkage moments in two passes; lw has maximum 0
    float ww[kPer];
    float v1[1 + P];
#pragma unroll
    for (int k = 0; k < 1 + P; ++k) v1[k] = 0.0f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      ww[p] = expf(lwv[own(p)]);
      v1[0] += ww[p];
#pragma unroll
      for (int k = 0; k < P; ++k) v1[1 + k] += leaf(S + k, own(p)) * ww[p];
    }
#pragma unroll
    for (int k = 0; k < 1 + P; ++k) v1[k] = active ? v1[k] : 0.0f;
    float unused_base, unused_total;
    ssme::row_sums_wide<1 + P, false>(v1, 0.0f, sums_a, unused_base,
                                      unused_total, bars);
    const float wsum = v1[0];
    float tbar[P];
#pragma unroll
    for (int k = 0; k < P; ++k) tbar[k] = v1[1 + k] / wsum;
    float v2[kGram];
#pragma unroll
    for (int k = 0; k < kGram; ++k) v2[k] = 0.0f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      float cen[P];
#pragma unroll
      for (int k = 0; k < P; ++k) cen[k] = leaf(S + k, own(p)) - tbar[k];
      int at = 0;
#pragma unroll
      for (int r = 0; r < P; ++r)
#pragma unroll
        for (int c = 0; c <= r; ++c, ++at) v2[at] += (cen[r] * ww[p]) * cen[c];
    }
#pragma unroll
    for (int k = 0; k < kGram; ++k) v2[k] = active ? v2[k] : 0.0f;
    ssme::row_sums_wide<kGram, false>(v2, 0.0f, sums_b, unused_base,
                                      unused_total, bars);
    tick(kLWSpanMoments);
    float chol[P][P];
    kernel_cholesky<P>(args.h2 / wsum, v2, chol);
    tick(kLWSpanCholesky);

    float lse_fs = 0.0f;
    if (apf) {
      // the first stage: lookahead at the pre-shrinkage theta, weights lw
      // + log g(y, lookahead; shrunk) to the weights' buffer and the
      // density to lgv as they come, the roll selection, and the joint
      // gather of (state, theta): the ancestor's shrunk theta is
      // recomputed from its theta (the same bits) and its lookahead
      // density read from lgv
      float m_loc[1] = {ssme::neg_inf()};
#pragma unroll 1
      for (int p = 0; p < kPer; ++p) {
        float th[P], cp[P], x[S], look[S];
#pragma unroll
        for (int k = 0; k < P; ++k) th[k] = leaf(S + k, own(p));
#pragma unroll
        for (int l = 0; l < S; ++l) x[l] = leaf(l, own(p));
        constrain<Model>(th, cp);
        model.prop_mu(cp, x, y, z, look);
#pragma unroll
        for (int k = 0; k < P; ++k) th[k] = shrink(args, th[k], tbar[k]);
        constrain<Model>(th, cp);
        const float lg = model.log_weight(cp, look, y, z);
        const float lfs = lwv[own(p)] + lg;
        lgv[own(p)] = lg;
        if (active) weight_at(p) = lfs;
        m_loc[0] = fmaxf(m_loc[0], lfs);
      }
      const float mfs = ssme::row_max<1>(m_loc, active, max_part, bars);
      float s_fs[1] = {0.0f};
      if (active) {
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const float w = expf(weight_at(p) - mfs);
          weight_at(p) = w;
          s_fs[0] += w;
        }
      }
      float base = 0.0f, total = 0.0f;
      ssme::row_sums_wide<1, false>(s_fs, 0.0f, sums_a, base, total, bars);
      lse_fs = mfs + logf(s_fs[0]);
      select_and_gather(tu, ssme::kTagRollSelect);
      tick(kLWSpanFirstStage);
    }

    // pair by pair: the kernel draws theta' = shrunk_anc + L e (draws 0 ..
    // P-1), then the transition or sample_q from draw P on, the weights
#pragma unroll 1
    for (int q = 0; q < kPairs; ++q) {
      const uint32_t qg = kPairs * i + q;
      float th[2][P], x[2][S];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int k = 0; k < P; ++k)
          th[e][k] = shrink(args, leaf(S + k, own(2 * q + e)), tbar[k]);
#pragma unroll
        for (int l = 0; l < S; ++l) x[e][l] = leaf(l, own(2 * q + e));
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float2 ek = ssme::normal_pair_at(k0, k1, qg, tu, b, k);
#pragma unroll
        for (int r = k; r < P; ++r) {
          th[0][r] = th[0][r] + chol[r][k] * ek.x;
          th[1][r] = th[1][r] + chol[r][k] * ek.y;
        }
      }
      ssme::for_pair<kDraws>(
          k0, k1, qg, tu, b,
          [&](auto& rng, int e) {
            const int p = 2 * q + e;
            float cp[P];
            constrain<Model>(th[e], cp);
            float lw_new;
            if (apf) {
              model.propagate(rng, cp, x[e], y, z);
              lw_new = model.log_weight(cp, x[e], y, z) -
                       lgv[slot_of(anc[own(p)])];
            } else if constexpr (Model::kHasProposal) {
              // the SISR form's own proposal and its log f - log q
              float x_anc[S];
#pragma unroll
              for (int l = 0; l < S; ++l) x_anc[l] = x[e][l];
              model.sample_q(rng, cp, x_anc, y, z, x[e]);
              lw_new = lwv[own(p)] + (model.log_weight(cp, x[e], y, z) +
                                      model.log_fq(cp, x[e], x_anc, y, z));
            } else {
              model.propagate(rng, cp, x[e], y, z);
              lw_new = lwv[own(p)] + model.log_weight(cp, x[e], y, z);
            }
            lwv[own(p)] = lw_new;
#pragma unroll
            for (int k = 0; k < K; ++k)
              hvv[k * kSlots + own(p)] = model.functional(k, cp, x[e]);
#pragma unroll
            for (int l = 0; l < S; ++l) leaf(l, own(p)) = x[e][l];
#pragma unroll
            for (int k = 0; k < P; ++k) leaf(S + k, own(p)) = th[e][k];
          },
          static_cast<uint32_t>(P));
    }
    tick(kLWSpanDraws);
    const bool fired = weigh_and_resample(t, [&](float lse) {
      return apf ? ((lse_fs - logf(wsum)) + lse) - log_n
                 : lse - logf(wsum);
    });
    if (fired) count(kLWSpanResamples);
    close_step(fired ? kLWSpanBarResample : kLWSpanBarOther);
  }

  if (kRecord && i == 0) {
    rec[kLWSpanLayoutPer] = kPer;
    rec[kLWSpanLayoutThreads] = blockDim.x;
    rec[kLWSpanCluster] = 1;
#pragma unroll
    for (int k = 0; k < kNumLWSpans; ++k)
      spans[kNumLWSpans * b + k] = rec[k];
  }
  if (active) {
    // rows [state x S, logw, theta x P], this thread's kPer neighbours
    float* out = cloud + static_cast<size_t>(b) * (S + 1 + P) * n + kPer * i;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
#pragma unroll
      for (int l = 0; l < S; ++l)
        out[static_cast<size_t>(l) * n + p] = leaf(l, own(p));
      out[static_cast<size_t>(S) * n + p] = lwv[own(p)];
#pragma unroll
      for (int k = 0; k < P; ++k)
        out[static_cast<size_t>(S + 1 + k) * n + p] = leaf(S + k, own(p));
    }
  }
}

// The paired layout of the systematic family (lw_ring.cuh): filter
// blockIdx.x / 2 on a cluster of two CTAs; rank 0 runs the row on the
// draws rank 1 writes into its ring.  Both set up their barriers and cross
// a cluster barrier before either touches the other's shared memory, and
// another before either exits.
template <class Model, int kPer, bool kRecord>
__device__ __forceinline__ void lw_pair_row(
    const int64_t* __restrict__ seed, const float* __restrict__ ys,
    const float* __restrict__ zs, int num_steps, int num_particles, int apf,
    int resample_every, float ess_limit, const LWArgs& args,
    float* __restrict__ lcl, float* __restrict__ fpaths,
    float* __restrict__ cloud, long long* __restrict__ spans) {
  static_assert(kPer == 2, "one producer thread a pair of a filter thread");
  constexpr int kAll = Model::kNumParams + Model::kDraws;
  extern __shared__ __align__(16) unsigned long long lw_ring_area[];
  const uint32_t rank = cluster_rank();
  const uint32_t b = blockIdx.x / 2;
  const int threads = blockDim.x;
  const uint32_t ring = smem_addr(lw_ring_area);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kRingSlots; ++s) {
      if (rank == 0)
        ring_bar_init(ring + 8 * s, threads / 32);  // full: producer warps
      else
        ring_bar_init(ring + 8 * (kRingSlots + s), 1);  // empty: thread 0
    }
    ring_bar_init_fence();
  }
  cluster_sync();
  if (rank == 0) {
    const RingDraws draws{
        reinterpret_cast<const float2*>(lw_ring_area + 2 * kRingSlots), ring,
        map_rank(ring + 8 * kRingSlots, 1), threads,
        ring_slot_pairs(kAll, threads)};
    lw_sys_row<Model, kPer, kRecord>(seed, ys, zs, num_steps, num_particles,
                                     apf, resample_every, ess_limit, args,
                                     lcl, fpaths, cloud, spans, b,
                                     static_cast<int>(gridDim.x / 2), draws);
  } else {
    lw_ring_produce<kAll>(static_cast<uint32_t>(seed[0]),
                          static_cast<uint32_t>(seed[1]), num_steps,
                          num_particles, b, ring);
  }
  cluster_sync();
}

// The kernel: one row per CTA, the systematic family (kRoll false) or the
// roll family at kPer particles a thread and up to kThreads threads; or,
// kPaired, the systematic family's paired layout, one row per cluster of
// two CTAs
template <class Model, int kPer, int kThreads, bool kRecord, bool kRoll,
          bool kPaired>
__global__ void __launch_bounds__(kThreads, 1)
lw_megakernel_sys(const int64_t* __restrict__ seed,
                  const float* __restrict__ ys, const float* __restrict__ zs,
                  int num_steps, int num_particles, int apf,
                  int resample_every, float ess_limit, int resampler,
                  int metropolis_iters, LWArgs args,
                  float* __restrict__ lcl, float* __restrict__ fpaths,
                  float* __restrict__ cloud, long long* __restrict__ spans) {
  if constexpr (kRoll) {
    static_assert(!kPaired, "the roll family runs one CTA a row");
    lw_roll_row<Model, kPer, kThreads, kRecord>(
        seed, ys, zs, num_steps, num_particles, apf, resample_every,
        ess_limit, resampler, metropolis_iters, args, lcl, fpaths, cloud,
        spans);
  } else if constexpr (kPaired) {
    static_assert(kThreads * kPer == kMaxThreads, "the systematic row");
    lw_pair_row<Model, kPer, kRecord>(seed, ys, zs, num_steps, num_particles,
                                      apf, resample_every, ess_limit, args,
                                      lcl, fpaths, cloud, spans);
  } else {
    static_assert(kThreads * kPer == kMaxThreads, "the systematic row");
    const OwnDraws draws{static_cast<uint32_t>(seed[0]),
                         static_cast<uint32_t>(seed[1]), blockIdx.x};
    lw_sys_row<Model, kPer, kRecord>(seed, ys, zs, num_steps, num_particles,
                                     apf, resample_every, ess_limit, args,
                                     lcl, fpaths, cloud, spans, blockIdx.x,
                                     static_cast<int>(gridDim.x), draws);
  }
}

// the paired layout's configuration of `filters` filters: clusters of two
// CTAs of `threads` threads and `dynamic` bytes of dynamic shared memory
inline cudaLaunchConfig_t pair_config(int filters, int threads, int dynamic,
                                      cudaStream_t stream,
                                      cudaLaunchAttribute* cluster) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = 2;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * filters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = dynamic;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// an instance's dynamic shared memory at `threads` threads, admitted with
// cudaFuncSetAttribute above 48 KB; the attribute's error, or cudaSuccess
template <class Model, int kPer, int kThreads, bool kRecord, bool kRoll,
          bool kPaired>
cudaError_t admit_dynamic(int threads, int* dynamic) {
  *dynamic = 0;
  if constexpr (kRoll) {
    *dynamic = roll_row_bytes<Model, kPer, kThreads>();
  } else if constexpr (kPaired) {
    *dynamic = pair_dynamic_bytes(Model::kNumParams + Model::kDraws, threads);
  }
  if (*dynamic <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      lw_megakernel_sys<Model, kPer, kThreads, kRecord, kRoll, kPaired>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, *dynamic);
}

// one launch of an instance (a.spans: its twin's record, or null); the
// paired layout launches clusters of two CTAs
template <class Model, int kPer, int kThreads, bool kRecord, bool kRoll,
          bool kPaired>
int launch_row(const LWLaunch& a, const LWArgs& args) {
  auto* kernel =
      lw_megakernel_sys<Model, kPer, kThreads, kRecord, kRoll, kPaired>;
  const int threads = (a.num_particles / kPer + 31) / 32 * 32;
  int dynamic;
  cudaError_t e = admit_dynamic<Model, kPer, kThreads, kRecord, kRoll,
                                kPaired>(threads, &dynamic);
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (kPaired) {
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg =
        pair_config(a.num_filters, threads, dynamic, a.stream, &cluster);
    e = cudaLaunchKernelEx(&cfg, kernel, a.seed, a.ys, a.zs, a.num_steps,
                           a.num_particles, a.apf, a.resample_every,
                           a.ess_limit, a.resampler, a.metropolis_iters, args,
                           a.lcl, a.fpaths, a.cloud, a.spans);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    kernel<<<a.num_filters, threads, dynamic, a.stream>>>(
        a.seed, a.ys, a.zs, a.num_steps, a.num_particles, a.apf,
        a.resample_every, a.ess_limit, a.resampler, a.metropolis_iters,
        args, a.lcl, a.fpaths, a.cloud, a.spans);
  }
  return static_cast<int>(cudaGetLastError());
}

// Run<Model>::go of dispatch_model: how many clusters of Model's paired
// systematic instance at num_particles the card holds at once, into
// *count (cudaOccupancyMaxActiveClusters; launches nothing)
template <class Model>
struct PairClusters {
  static int go(int num_particles, int* count) {
    constexpr int kThreads = kMaxThreads / kLWPer;
    const int threads = (num_particles / kLWPer + 31) / 32 * 32;
    int dynamic;
    cudaError_t e = admit_dynamic<Model, kLWPer, kThreads, false, false,
                                  true>(threads, &dynamic);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg =
        pair_config(1, threads, dynamic, nullptr, &cluster);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(
        count,
        lw_megakernel_sys<Model, kLWPer, kThreads, false, false, true>,
        &cfg));
  }
};

// Run<Model>::go of dispatch_model for one layout and family
template <int kPer, int kThreads, bool kRecord, bool kRoll, bool kPaired>
struct LayoutAt {
  template <class Model>
  struct Run {
    static int go(const LWLaunch& a, const LWArgs& args) {
      return launch_row<Model, kPer, kThreads, kRecord, kRoll, kPaired>(
          a, args);
    }
  };
};

// the instances of every model id in one layout and family or, with
// a.spans, their instrumented twins; -1 for an unknown id
template <int kPer, int kThreads, bool kRoll, bool kPaired = false>
int dispatch_layout(int model_id, const LWLaunch& a, const LWArgs& args) {
  if (a.spans == nullptr)
    return dispatch_model<LayoutAt<kPer, kThreads, false, kRoll,
                                   kPaired>::template Run>(model_id, a, args);
  return dispatch_model<LayoutAt<kPer, kThreads, true, kRoll,
                                 kPaired>::template Run>(model_id, a, args);
}

// The roll family's layout at each N, from the grid measured on the card
// (PERF.md §6): kPer 2 at up to 512 threads to N = 1024, then 4 and 8
inline int roll_kper_for(int n) { return n <= 1024 ? 2 : n <= 2048 ? 4 : 8; }
constexpr int kRollThreads = 512;

// the systematic instances (lw_megakernel_sys.cu), their paired layout
// and its occupancy query (lw_megakernel_sys_pair.cu), and the roll ones, one file per kPer
// (lw_megakernel_sys_roll{2,4,8}.cu)
int dispatch_sys(int model_id, const LWLaunch& a, const LWArgs& args);
int dispatch_pair(int model_id, const LWLaunch& a, const LWArgs& args);
int pair_clusters(int model_id, int num_particles, int* count);
int dispatch_roll2(int model_id, const LWLaunch& a, const LWArgs& args);
int dispatch_roll4(int model_id, const LWLaunch& a, const LWArgs& args);
int dispatch_roll8(int model_id, const LWLaunch& a, const LWArgs& args);

}  // namespace ssme_lw
