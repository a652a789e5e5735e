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
//    state, theta[P] and its log-weight in registers for all T steps (at
//    P <= kRegParams; past it, the wide row lw_wide_row keeps theta, the
//    Gram and the Cholesky factor in shared memory, in both layouts: its
//    note below).
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
// lw_megakernel_sys_roll{2,4,8}.cu): every functor (a wide one in
// lw_megakernel_sys.cu alone), and beside each an instrumented twin
// (kRecord), which counts
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
// count under draws; the wide row's fold of the moments apart, 0 in the
// other rows; the paired layout's waits on its ring apart, 0 in the single
// layout), the rows' resamples at t = 0 and at t > 0, the
// barriers crossed at t = 0 in a step that resamples and in one that does
// not, and at t > 0 likewise (a roll selection's apart), the roll
// selections' votes and tail barriers, the sweeps they ran (1 + the last
// accept sweep, 4096 at the cap) and the slots their tails took, the
// systematic selections' fix-ups (counts whose first guess missed, both
// selections of a step) and the most marks one thread wrote in a
// selection (row_select.cuh note_selection), and the layout the launch
// ran (kPer, blockDim, CTAs a filter).
enum LWSpan { kLWSpanMoments, kLWSpanMomentsFold, kLWSpanCholesky,
              kLWSpanFirstStage, kLWSpanDraws, kLWSpanWeigh,
              kLWSpanResample, kLWSpanRingWait,
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

// A systematic row's record in its twin (kRecord; every call a no-op
// otherwise), kept by thread 0 in shared memory: `rec` holds the LWSpan
// counts, then the last clock read and this step's barriers (bars(),
// which row_sync counts); `sel_part` the selections' (note_selection),
// each warp's folded at the row's end.  lw_sys_row and lw_wide_row keep
// one each.
template <bool kRecord>
struct RowRecord {
  static constexpr int kMark = kNumLWSpans, kStepBars = kNumLWSpans + 1;
  static constexpr int kWords = kRecord ? kNumLWSpans + 2 : 1;
  static constexpr int kSelWords = kRecord ? 64 : 1;
  long long* rec;
  int* sel_part;
  __device__ long long* bars() const {
    return kRecord ? rec + kStepBars : nullptr;
  }
  __device__ void start() const {
    if constexpr (kRecord) {
      ssme::clear_selections(sel_part);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < kNumLWSpans + 2; ++k) rec[k] = 0;
        rec[kMark] = clock64();
      }
    }
  }
  // the cycles since the last tick to part k
  __device__ void tick(int k) const {
    if constexpr (kRecord) {
      if (threadIdx.x == 0) {
        const long long now = clock64();
        rec[k] += now - rec[kMark];
        rec[kMark] = now;
      }
    }
  }
  // the step's barriers to the count of its kind
  __device__ void close_step(int kind) const {
    if constexpr (kRecord) {
      if (threadIdx.x == 0) {
        rec[kind] += rec[kStepBars];
        rec[kStepBars] = 0;
      }
    }
  }
  __device__ void count(int k) const {
    if constexpr (kRecord) {
      if (threadIdx.x == 0) rec[k] += 1;
    }
  }
  __device__ void note(int fixups, int wrote) const {
    if constexpr (kRecord) ssme::note_selection(sel_part, fixups, wrote);
  }
  // the record to row b of spans, with the layout: kPer, the threads and
  // the CTAs a filter
  __device__ void finish(long long* spans, uint32_t b, int per,
                         int cluster) const {
    if constexpr (kRecord) {
      ssme::fold_selections(sel_part, rec[kLWSpanFixups],
                            rec[kLWSpanMostMarks]);
      if (threadIdx.x == 0) {
        rec[kLWSpanLayoutPer] = per;
        rec[kLWSpanLayoutThreads] = blockDim.x;
        rec[kLWSpanCluster] = cluster;
#pragma unroll
        for (int k = 0; k < kNumLWSpans; ++k)
          spans[kNumLWSpans * b + k] = rec[k];
      }
    }
  }
};

// a systematic selection of this thread's kPer particles on their CDF
// entries base + w[p] (warp_cdf raised), offset u0, total: the marks,
// staged beside the moved values g (buf, a leaf every `stride` floats),
// the barrier that publishes both, the scan to the ancestors anc, then
// the gather of g
template <int kPer, bool kRecord, class G>
__device__ __forceinline__ void select_gather(
    const float (&w)[kPer], float base, float u0, float total, int n,
    bool active, int* marks, const RowRecord<kRecord>& rec, G& g, float* buf,
    int stride, int (&anc)[kPer]) {
  int fixups = 0;
  const int wrote = ssme::systematic_marks<kPer>(w, base, u0, total, n,
                                                 active, marks, fixups);
  rec.note(fixups, wrote);
  ssme::row_stage(g, active, buf, stride);
  ssme::row_sync(rec.bars());
  ssme::systematic_scan<kPer>(marks, active, anc);
  ssme::row_gather(g, anc, buf, stride);
}

// The weights of step t from the new log-weights lw_new: their max m
// over the row (its barrier), then between() (the paired layout frees
// its ring slot there); lw = lw_new - m and w = exp(lw) (0 off the row);
// in one exchange the row's sums of w, of w times each functional (hv)
// and of w^2 beside the warps' CDF totals (base, total: w's CDF, which a
// selection raises); thread 0 writes column t of lcl (lcl_of(m + log
// sum w)) and of the functional paths; the span kLWSpanWeigh.  Returns
// whether the row selects: the ESS gate or, without one, may_fire.
template <int kPer, int K, bool kRecord, class Between, class LclOf>
__device__ __forceinline__ bool weigh_step(
    int t, bool may_fire, float ess_limit, bool active,
    const float (&lw_new)[kPer], const float (&hv)[kPer][K > 0 ? K : 1],
    float (&lw)[kPer], float (&w)[kPer], float& base, float& total,
    float* max_part, float4* sums, const RowRecord<kRecord>& rec,
    float* lcl, float* fpaths, int num_filters, int num_steps, uint32_t b,
    Between between, LclOf lcl_of) {
  const float m = ssme::row_max<kPer>(lw_new, active, max_part, rec.bars());
  between();
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
  base = 0.0f;
  total = 0.0f;
  ssme::row_sums_wide<K + 2, true>(v, warp_last, sums, base, total,
                                   rec.bars());
  if (threadIdx.x == 0) {
    lcl[static_cast<size_t>(b) * num_steps + t] = lcl_of(m + logf(v[0]));
#pragma unroll
    for (int k = 0; k < K; ++k)
      fpaths[(static_cast<size_t>(k) * num_filters + b) * num_steps + t] =
          v[1 + k] / v[0];
  }
  rec.tick(kLWSpanWeigh);
  return ess_limit > 0.0f ? v[0] * v[0] / v[K + 1] < ess_limit : may_fire;
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
  // the twin's record (RowRecord)
  __shared__ long long rec_words[RowRecord<kRecord>::kWords];
  __shared__ int sel_part[RowRecord<kRecord>::kSelWords];
  const RowRecord<kRecord> rec{rec_words, sel_part};
  long long* const bars = rec.bars();

  const uint32_t i = threadIdx.x;
  const int n = num_particles;
  const bool active = static_cast<int>(kPer * i) < n;
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const Model model(args.model);
  const float log_n = logf(static_cast<float>(n));

  ssme::clear_marks<kPer>(marks);
  rec.start();
  // a systematic selection (select_gather), the moved values g through
  // buf
  auto systematic_resample = [&](const float (&w)[kPer], float base,
                                 float u0, float total, auto& g) {
    int anc[kPer];
    select_gather(w, base, u0, total, n, active, marks, rec, g, buf, kRow,
                  anc);
  };

  float y[Model::kDimObs], z[kCov];
  float x[kPer][S], th[kPer][P], lw[kPer];
  float lw_new[kPer];
  float hv[kPer][kK];  // the functionals of the step's particles

  // The weights (weigh_step; lcl_of(lse) gives column t's value from
  // LSE(lw_new)) and, when the row resamples, the marks and the stage of
  // (state, theta), the scan and the gather, lw = 0.  Returns whether the
  // row resampled.  At t > 0 the max's barrier follows every read of the
  // step's draws, so the paired layout frees its ring slot there.
  auto weigh_and_resample = [&](int t, auto lcl_of) -> bool {
    const uint32_t tu = static_cast<uint32_t>(t);
    const bool may_fire = ess_limit > 0.0f || resample_every == 1 ||
                          (t + 1) % resample_every == 0;
    if (may_fire && i == 0)
      offsets[1] = t == 0 ? ssme::offset_at(k0, k1, 0u, b)
                          : draws.offset(tu, ssme::kTagOffset);
    float w[kPer], base, total;
    const bool fire = weigh_step<kPer, K>(
        t, may_fire, ess_limit, active, lw_new, hv, lw, w, base, total,
        max_part, sums_b, rec, lcl, fpaths, num_filters, num_steps, b,
        [&] {
          if (t > 0) draws.release(tu);
        },
        lcl_of);
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
    rec.tick(kLWSpanResample);
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
  rec.tick(kLWSpanDraws);
  {
    const bool fired = weigh_and_resample(
        0, [&](float lse) { return lse - log_n; });
    if (fired) rec.count(kLWSpanFirstResamples);
    rec.close_step(fired ? kLWSpanBarFirstResample : kLWSpanBarFirstOther);
  }

  float y_next[Model::kDimObs], z_next[kCov];
  if (num_steps > 1) load_step<Model>(ys, zs, 1, y_next, z_next);
  for (int t = 1; t < num_steps; ++t) {
    const uint32_t tu = static_cast<uint32_t>(t);
    if constexpr (Draws::kPaired) {
      rec.tick(kLWSpanMoments);  // the loop's top, as in the single layout
      draws.wait(tu);
      rec.tick(kLWSpanRingWait);
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
    rec.tick(kLWSpanMoments);
    float chol[P][P];
    kernel_cholesky<P>(args.h2 / wsum, v2, chol);
    float shrunk[kPer][P];
#pragma unroll
    for (int p = 0; p < kPer; ++p)
#pragma unroll
      for (int k = 0; k < P; ++k)
        shrunk[p][k] = shrink(args, th[p][k], tbar[k]);
    rec.tick(kLWSpanCholesky);

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
      rec.tick(kLWSpanFirstStage);
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
    rec.tick(kLWSpanDraws);
    const bool fired = weigh_and_resample(t, [&](float lse) {
      return apf ? ((lse_fs - logf(wsum)) + lse) - log_n
                 : lse - logf(wsum);
    });
    if (fired) rec.count(kLWSpanResamples);
    rec.close_step(fired ? kLWSpanBarResample : kLWSpanBarOther);
  }

  rec.finish(spans, b, kPer, Draws::kPaired ? 2 : 1);
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


// The wide row: the systematic family at more parameters than
// lw_sys_row holds in registers (kRegParams).  At P = 21 (factor SVOL)
// each thread's theta (42 floats), the Gram's P (P + 1) / 2 = 231 sums and
// a 231-entry Cholesky triangle would not fit 128 registers, so:
//  - theta lives in shared memory, P leaves at the padded stride
//    (wide_leaf), slot padded(j) particle j's; a thread reads its
//    ancestors' theta into registers, crosses a barrier, and writes its
//    own slots (the kernel draws' theta', the joint resample's gather), so
//    one buffer holds the cloud;
//  - the moments in one pass over the cloud on the FP64 tensor cores
//    (moments_pass): with c particle 0's theta (a shift, read by
//    broadcast), particle j's row X_j = [w_j (theta_j - c), w_j] and
//    D_j = [theta_j - c, 1], each in double (the difference of two floats
//    and its product with a float weight are exact there), zero-padded to
//    three tiles of 8, and G = X' D by mma.sync m16n8k4 f64 over steps of
//    4 particles, three products a step for the six lower 8 x 8 tiles: the
//    Gram about c, the sums m = sum w (theta - c) and sum w.  The
//    fragments of A and B share their lane map (lane l: parameter 8 I + l
//    / 4, particle 4 s + l % 4), so a lane reads each of its three theta
//    values once a step, and the weight, which each thread first stages
//    in double for its own particles (the gather buffer's leaves 0 and 1:
//    an exp and a conversion a lane and step would cost 8 lanes the same
//    work); the leaf stride (wide_leaf, 4 mod 32 words) puts a fragment's
//    8 parameters on 8 banks.  The row's first 8 warps (kMomentWarps, two
//    an SM sub-partition) each take a fixed range of the particles; warp w
//    + 4 hands its tiles to warp w, which writes their sum in double
//    (kMomentSlots); after a barrier (moments_fold) a thread an entry sums
//    the slots in order and centres in double, C = G - m m' / sum w, tbar
//    = c + m / sum w, rounded to float where the row keeps tbar, sum w and
//    the Gram; no atomics, so every layout and twin adds alike; 3 barriers
//    (the staged weights and theta published, the slots, the fold).  The
//    double arithmetic beside the products shares the tensor cores' FP64
//    pipe (3 products a step take 48 cycles a sub-partition, with 6
//    double adds 74, PERF.md §6);
//  - the Cholesky of h^2 Vt once a row, by warp 0 alone, lane r holding
//    row r of the factor in registers, right-looking (wide_cholesky), into
//    shared memory column-major, which every thread reads by broadcast in
//    the kernel draws, four entries a load; the other warps go on to the
//    first stage meanwhile (SISR, which has none, crosses one barrier more
//    here);
//  - APF's first stage and the joint resample move the state and the
//    lookahead's density through the gather buffer (S + 1 leaves) and
//    theta by the ancestor's index: the kernel draws read the ancestor's
//    theta and recompute its shrunk theta (lw_roll_row does the same; the
//    same bits as gathering it);
//  - the systematic offsets drawn by thread 0 in both layouts (not read
//    off the ring), so that the paired layout's row waits on its ring only
//    at the kernel draws;
//  - 128 registers a thread (512 threads at N = 1024) and no spill: what
//    the step does not use in registers waits in shared memory (the
//    carried log-weights between steps, the state and the ancestor's
//    density through the kernel draws, the small arrays at static
//    addresses), the moments' pass holds 12 sums in double a lane, and the
//    step's normals are read from shared memory in both layouts (the
//    single layout's thread first draws its pair's P + kDraws into a
//    stash where the paired layout has its ring).
// So 11 / 9 barriers an APF step that does / does not resample, 9 / 7 in
// SISR, 4 / 2 at t = 0.  Two layouts, the same bits: single (OwnDraws, its
// stash after the row's arrays), and paired (RingDrawsT<kWideRingSlots>):
// the cloud's 99 KB of dynamic shared memory at N = 1024 (and 22 KB
// static, 12 KB of it the moments' partial tiles) and a ring of one step
// (92 KB at P + kDraws = 23 normal pairs a thread) fit a block
// (wide_pair_fits), the ring after the row's arrays.
// The twins time the moments' pass (with its first barrier), their fold
// and the Cholesky apart.
constexpr int kRegParams = 8;
// the warps of the moments' pass (warps w, w + 4, .. share an SM
// sub-partition and its tensor core)
constexpr int kMomentWarps = 8;
// the slots of their partial tiles, one a sub-partition (its warps' sum):
// 6 tiles of 8 x 8 doubles a slot
constexpr int kMomentSlots = 4;

template <class Model>
__host__ __device__ constexpr bool is_wide() {
  return Model::kNumParams > kRegParams;
}

__host__ __device__ constexpr int round4(int k) { return (k + 3) / 4 * 4; }

// the factor's column stride in the wide row's shared memory: P rounded
// up to whole float4 words, so the kernel draws read a column's entries
// four at a time
__host__ __device__ constexpr int chol_stride(int p) { return round4(p); }

// floats a leaf of the wide row's shared arrays takes at n particles: the
// padded row (row_select.cuh padded), rounded up to 4 mod 32 words, so
// that leaves k and k + 1 start 4 banks apart (the moments' fragments read
// 8 parameters of 4 neighbouring particles at once) and a leaf stays in
// whole float4 words
__host__ __device__ constexpr int wide_leaf(int n) {
  return (ssme::padded_size(n) + 27) / 32 * 32 + 4;
}

// The wide row's dynamic shared memory at n particles: theta (P leaves)
// and the gather buffer (S + 1 leaves) at wide_leaf(n) floats a leaf; the
// paired layout's ring after them.  Its small arrays (the marks, tbar,
// the moments' partial tiles, the Gram, the factor) are static, at fixed
// addresses: a pointer held for each would cost a register the kernel
// draws lack.
template <class Model>
struct WideRowLayout {
  static constexpr int P = Model::kNumParams;
  static constexpr int S = Model::kNumState;
  static constexpr int kGram = P * (P + 1) / 2;
  __host__ __device__ static constexpr int gather(int n) {
    return P * wide_leaf(n);
  }
  __host__ __device__ static constexpr int bytes(int n) {
    return 4 * (P + S + 1) * wide_leaf(n);
  }
  // the single layout at n particles and `threads` threads: the row's
  // arrays, then the step's P + kDraws normal pairs a thread (its stash)
  __host__ __device__ static constexpr int single_bytes(int n, int threads) {
    return bytes(n) + 8 * (P + Model::kDraws) * threads;
  }
  // the paired layout's rank 0: the row's arrays, then a ring of
  // kWideRingSlots steps
  __host__ __device__ static constexpr int pair_bytes(int n, int threads) {
    return bytes(n) +
           ring_bytes_of(kWideRingSlots, P + Model::kDraws, threads);
  }
};

// the wide row's static shared memory at P = 21, at most (the moments'
// partial tiles 12 KB, the marks 4 KB, tbar, the Gram and the factor 3 KB,
// the exchanges' and the twin's record 2.7 KB; chip_smoke phase 2 holds
// each instance's with its dynamic bytes to the block)
constexpr int kWideStaticBytes = 24 * 1024;

// whether a wide row's cloud and a ring of one step (the paired layout,
// lw_ring.cuh) fit a block at the family's largest N: lw_pair_row holds
// every wide model to it
template <class Model>
__host__ __device__ constexpr bool wide_pair_fits() {
  return WideRowLayout<Model>::pair_bytes(kMaxThreads, kMaxThreads / 2) +
             kWideStaticBytes <=
         kBlockBytes;
}

// one m16n8k4 product on the FP64 tensor cores, accumulated: lane l holds
// entries (l / 4, 2 (l % 4) + i) of the 8 x 8 tile d[0..1] and of d[2..3],
// and d += A B, the tiles stacked in A's rows: A's entries (l / 4, l % 4)
// a0 and (8 + l / 4, l % 4) a1, B's (l % 4, l / 4) b
__device__ __forceinline__ void dmma_16x8x4(double (&d)[4], double a0,
                                            double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// where a warp's partial tiles keep entry (r, col), r >= col, of G (both
// at most P): the three products of a step give the lower tiles (I, J) as
// (0, 0) and (1, 0), (1, 1) and (2, 1), (0, 2) and (2, 2), six tiles of 64
// doubles in that order, entry (r, c) of a tile at 8 r + c; tile (2, 0) is
// read as the transpose of (0, 2)
__device__ __forceinline__ int moment_at(int r, int col) {
  const int I = r >> 3, J = col >> 3;
  if (I == 2 && J == 0) return 4 * 64 + 8 * (col & 7) + (r & 7);
  const int tile = I == 0 ? 0 : (I == 1 ? 1 + J : (J == 1 ? 3 : 5));
  return tile * 64 + 8 * (r & 7) + (col & 7);
}

// The moments' pass of warp w of the mw that run it (the wide row's
// note): over its steps s in [n w / (4 mw), n (w + 1) / (4 mw)), lane l
// loads theta of parameters 8 I + l / 4 (I < 3) of particle j = 4 s + l %
// 4 (slot padded(j) of theta's P leaves th at `stride`) and the
// particle's staged weight w (wst, in double), forms d_I = theta - c and
// x_I = w d_I in double (c particle 0's theta; column P: d = 1, x = w;
// past it 0), and accumulates the lower tiles G_IJ += x_I d_J'
// (moment_at).  Then the warps of one SM sub-partition (w, w + 4, w + 8,
// ..) hand their tiles down through its slot of part, each adding the
// tiles of the warp above it to its own (named barrier 1 + 3 (w % 4) + w
// / 4 between warps w and w + 4), so that warp w % 4 leaves their sum in
// slot w % 4 (384 doubles: lane l's entries 2 l, 2 l + 1 of each tile).
template <int P>
__device__ __forceinline__ void moments_pass(const float* th,
                                             const double* wst, int stride,
                                             int n, int w, int mw,
                                             double* part) {
  static_assert(P >= 16 && P < 24, "the parameters and the sum column in "
                                   "three tiles of 8");
  static_assert(kMomentWarps <= 16, "three named barriers a sub-partition");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  // this lane's leaves (past P, leaf g: a bank no other lane of the load
  // takes; the third tile's d_2 = theta * sc + tc takes it times 0) and
  // the shifts
  int leaf[3];
#pragma unroll
  for (int I = 0; I < 3; ++I)
    leaf[I] = (8 * I + g < P ? 8 * I + g : g) * stride;
  const double c0 = static_cast<double>(th[leaf[0]]);
  const double c1 = static_cast<double>(th[leaf[1]]);
  const bool real = 16 + g < P;
  const double sc = real ? 1.0 : 0.0;
  const double tc = real ? -static_cast<double>(th[leaf[2]])
                         : (16 + g == P ? 1.0 : 0.0);
  double acc[3][4];
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.0;
  const int s0 = n / 4 * w / mw, s1 = n / 4 * (w + 1) / mw;
#pragma unroll 4
  for (int s = s0; s < s1; ++s) {
    const int at = ssme::padded(4 * s + q);
    const double wd = wst[at];
    const double d0 = __dsub_rn(static_cast<double>(th[leaf[0] + at]), c0);
    const double d1 = __dsub_rn(static_cast<double>(th[leaf[1] + at]), c1);
    const double d2 =
        __fma_rn(static_cast<double>(th[leaf[2] + at]), sc, tc);
    dmma_16x8x4(acc[0], __dmul_rn(wd, d0), __dmul_rn(wd, d1), d0);
    dmma_16x8x4(acc[1], __dmul_rn(wd, d1), __dmul_rn(wd, d2), d1);
    dmma_16x8x4(acc[2], __dmul_rn(wd, d0), __dmul_rn(wd, d2), d2);
  }
  // tile 2 u + h of product u: lane l's two entries at 2 l, 2 l + 1
  const int sp = w & 3, k = w >> 2;
  double2* const slot =
      reinterpret_cast<double2*>(part) + sp * 6 * 32 + lane;
  if (w + 4 < mw) {  // the tiles of the warp above, added to this one's
    asm volatile("bar.sync %0, 64;" :: "r"(1 + 3 * sp + k) : "memory");
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const double2 o = slot[(2 * u + h) * 32];
        acc[u][2 * h] = __dadd_rn(acc[u][2 * h], o.x);
        acc[u][2 * h + 1] = __dadd_rn(acc[u][2 * h + 1], o.y);
      }
  }
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      slot[(2 * u + h) * 32] = make_double2(acc[u][2 * h], acc[u][2 * h + 1]);
  if (k > 0)  // handed to the warp below
    asm volatile("bar.arrive %0, 64;" :: "r"(3 * sp + k) : "memory");
}

// the row's warps, read where they are used (asm volatile: a count
// hoisted out of the step loop would hold a register through the kernel
// draws, which have none to spare)
__device__ __forceinline__ int block_warps() {
  unsigned threads;
  asm volatile("mov.u32 %0, %%ntid.x;" : "=r"(threads));
  return static_cast<int>(threads >> 5);
}

// The moments' fold (the wide row's note), after the pass's barrier: the
// Gram's rows v and P - 1 - v a warp (v = warp, warp + nw, .. below (P +
// 1) / 2), lane b of the first holding entry (v, b) and lane v + 1 + b of
// the second (P - 1 - v, b).  G_ab, m_a, m_b and sum w are each the sum of
// the slots of part in slot order (one a sub-partition of the mw warps,
// 384 doubles each, moment_at); q_a = m_a / sum w, by a float reciprocal
// refined twice in double; gram[a (a + 1) / 2 + b] = G_ab - q_a m_b and,
// on the diagonal, tb[a] = c_a + q_a (c particle 0's theta), each rounded
// to float; entry (0, 0) also writes sum w to tb[P] and *wsum.
template <int P>
__device__ __forceinline__ void moments_fold(const float* th, int stride,
                                             const double* part, int mw,
                                             int warp, int nw, float* tb,
                                             float* gram, float* wsum) {
  static_assert(P + 1 <= 32, "two rows of the Gram a warp");
  const int lane = threadIdx.x & 31;
  const int ms = mw < kMomentSlots ? mw : kMomentSlots;
  auto entry = [&](int r, int col) {
    const double* at = part + moment_at(r, col);
    double v = at[0];
#pragma unroll
    for (int k = 1; k < kMomentSlots; ++k)
      if (k < ms) v = __dadd_rn(v, at[k * 6 * 64]);
    return v;
  };
  for (int v = warp; v < (P + 1) / 2; v += nw) {
    const bool first = lane <= v;
    const int a = first ? v : P - 1 - v;
    const int b = first ? lane : lane - v - 1;
    if (b > a || (!first && a == v)) continue;
    const double sw = entry(P, P), ma = entry(P, a), mb = entry(P, b);
    const double gab = entry(a, b);
    double r = static_cast<double>(__fdividef(1.0f, __double2float_rn(sw)));
    r = __fma_rn(r, __fma_rn(-sw, r, 1.0), r);
    r = __fma_rn(r, __fma_rn(-sw, r, 1.0), r);
    const double qa = __dmul_rn(ma, r);
    gram[a * (a + 1) / 2 + b] = __double2float_rn(__fma_rn(-qa, mb, gab));
    if (a == b)
      tb[a] = __double2float_rn(__dadd_rn(
          static_cast<double>(th[a * stride]), qa));
    if (a == 0) tb[P] = *wsum = __double2float_rn(sw);
  }
}

// the wide row's Cholesky of h^2 Vt (h2w = h^2 / sum w) from the Gram
// (gram: its P (P + 1) / 2 sums, entry (r, c) at r (r + 1) / 2 + c) by one
// warp, lane r holding row r, into chol column-major (entry (r, k) at
// chol[k chol_stride(P) + r], 0 above the diagonal).  Right-looking:
// column jj's pivot is broadcast, each lane scales its entry, and the
// column's entries are broadcast one by one to update the rows' later
// entries, independent of one another (a left-looking column would chain
// a shuffle and a fused multiply-add per term).  Each entry takes
// lw_sys_row's kernel_cholesky operations in its order (h^2 G rounded,
// one fmaf a term in k order, the floor kEpsChol), but the column's
// reciprocal is rsqrtf of the floored pivot, beside its sqrtf: warp 0
// runs the factor while the other warps' first stage takes the SM's
// issue slots, so its chain of 21 columns sets the step (a correctly
// rounded divide cost it ~640 cycles a column; the plain version takes
// the same fused products and, through torch.rsqrt, on the card the same
// reciprocal, so that from one Gram both take the rank rule's decisions
// alike).  One rule more: at 21 parameters a cloud of few distinct
// particles makes Vt nearly singular, and in float32 a pivot that falls
// to rounding (with the floor, sqrt(1e-9)) turns the rest of its column
// into rounding over a tiny divisor, which the later columns square and
// divide again: the factor grows without bound (2e25 within 25 steps at N
// = 64).  So a pivot at or below kRankRel of its column's diagonal h^2
// G_jj counts as a direction the cloud does not span: its column below
// the diagonal is 0 (a semi-definite factor; the floored diagonal stays).
// The plain version and the benchmark's reference take the same rule.
constexpr float kRankRel = 1e-4f;

template <int P>
__device__ __forceinline__ void wide_cholesky(float h2w, const float* gram,
                                              float* chol) {
  constexpr int kCol = chol_stride(P);
  static_assert(P <= 32, "a lane a row");
  const int lane = threadIdx.x & 31;
  const int r = lane < P ? lane : P - 1;  // past P: row P - 1, unwritten
  float a[P];  // row r: h^2 G, then the factor as its columns finish
#pragma unroll
  for (int c = 0; c < P; ++c) {
    const int at = r >= c ? r * (r + 1) / 2 + c : 0;
    a[c] = __fmul_rn(h2w, gram[at]);
  }
  // h^2 G_rr before any update, read again (a[r] would index the row by
  // the lane and put it in local memory)
  const int rr = r * (r + 1) / 2 + r;
  const float diag0 = __fmul_rn(h2w, gram[rr]);
#pragma unroll
  for (int jj = 0; jj < P; ++jj) {
    const float dd = __shfl_sync(ssme::kFullMask, a[jj], jj);
    const float diag = __shfl_sync(ssme::kFullMask, diag0, jj);
    const float floored = dd < kEpsChol ? kEpsChol : dd;
    const float d = sqrtf(floored);
    const float inv_d = dd <= kRankRel * diag ? 0.0f : rsqrtf(floored);
    const float l = r == jj ? d : (r > jj ? a[jj] * inv_d : 0.0f);
    a[jj] = l;
#pragma unroll
    for (int c = jj + 1; c < P; ++c) {
      const float lc = __shfl_sync(ssme::kFullMask, l, c);
      a[c] = r >= c ? fmaf(-l, lc, a[c]) : a[c];
    }
  }
  if (lane < P) {
#pragma unroll
    for (int k = 0; k < P; ++k) chol[k * kCol + lane] = a[k];
  }
}

// the wide single layout's PairRng: draw k of the first particle is the
// cosine at draws[k stride] of its stash, whose sine the second's
// PairSines returns (lw_ring.cuh RingPairRng over a volatile stash)
template <int kDraws>
struct StashPairRng {
  volatile const float2* draws;
  int stride;
  int draw = 0;
  float sine[kDraws];
  __device__ float normal() {
    const float c = draws[draw * stride].x;
    sine[draw] = draws[draw * stride].y;
    ++draw;
    return c;
  }
};

// one row of the wide systematic family (the note above): filter b of
// num_filters, its draws at t >= 1 from `draws` (OwnDraws in the single
// layout, RingDrawsT<kWideRingSlots> in the paired one)
template <class Model, int kPer, bool kRecord, class Draws>
__device__ __forceinline__ void lw_wide_row(
    const int64_t* __restrict__ seed, const float* __restrict__ ys,
    const float* __restrict__ zs, int num_steps, int num_particles, int apf,
    int resample_every, float ess_limit, const LWArgs& args,
    float* __restrict__ lcl, float* __restrict__ fpaths,
    float* __restrict__ cloud, long long* __restrict__ spans, uint32_t b,
    int num_filters, const Draws& draws) {
  static_assert(kPer == 2, "one Philox pair a thread");
  constexpr int P = Model::kNumParams;
  constexpr int S = Model::kNumState;
  static_assert(S >= 2, "the moments stage the weights in double in the "
                        "gather buffer's leaves 0 and 1, the carried "
                        "log-weights wait in leaf S");
  constexpr int K = Model::kNumFunctionals;
  constexpr int kK = K > 0 ? K : 1;
  constexpr int kDraws = Model::kDraws;
  constexpr int kCov = Model::kDimCov > 0 ? Model::kDimCov : 1;
  using Layout = WideRowLayout<Model>;
  extern __shared__ __align__(16) float lw_wide_arrays[];
  const int n = num_particles;
  const int stride = wide_leaf(n);
  float* const th = lw_wide_arrays;  // theta, P leaves
  // the gather buffer: the state's S leaves, then the lookahead's density
  float* const gbuf = lw_wide_arrays + Layout::gather(n);
  // the single layout's stash of the step's normals, pair q's draw k at
  // k blockDim + q (volatile: read back as written, not forwarded)
  volatile float2* const stash =
      reinterpret_cast<float2*>(lw_wide_arrays + Layout::bytes(n) / 4);
  __shared__ __align__(16) int marks[kMaxThreads];  // the selections'
  __shared__ float tb[round4(P + 1)];                // tbar, then sum w
  __shared__ __align__(16) double mom_part[kMomentSlots * 6 * 64];
  __shared__ float gram[Layout::kGram];
  __shared__ __align__(16) float chol[P * chol_stride(P)];
  __shared__ float max_part[32];
  // A: the first stage's scan; B: the weights' sums and scan
  __shared__ float4 sums_a[32 * ssme::wide_stride(1) / 4];
  __shared__ float4 sums_b[32 * ssme::wide_stride(K + 3) / 4];
  __shared__ float offsets[2];  // first stage, resample; thread 0 draws
  __shared__ long long rec_words[RowRecord<kRecord>::kWords];
  __shared__ int sel_part[RowRecord<kRecord>::kSelWords];
  const RowRecord<kRecord> rec{rec_words, sel_part};
  long long* const bars = rec.bars();

  const uint32_t i = threadIdx.x;
  const int warp = static_cast<int>(i >> 5);
  const bool active = static_cast<int>(kPer * i) < n;
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const Model model(args.model);
  // thread 0 alone writes lcl: its scalars (log N, the row, the step's
  // sum w and first-stage LSE) are read where it writes, not held
  __shared__ float lcl_terms[2];  // sum w, LSE of the first stage
  // this thread's slot of particle kPer i + p (slot 0 off the row)
  const int own0 = active ? ssme::padded(kPer * static_cast<int>(i)) : 0;

  ssme::clear_marks<kPer>(marks);
  rec.start();
  // lw_sys_row's systematic selection (select_gather), the leaves g
  // through gbuf
  auto systematic_select = [&](const float (&w)[kPer], float base, float u0,
                               float total, auto& g, int (&anc)[kPer]) {
    select_gather(w, base, u0, total, n, active, marks, rec, g, gbuf, stride,
                  anc);
  };

  float y[Model::kDimObs], z[kCov];
  // the carried log-weights live in the gather buffer's last leaf (own
  // slots) between one step's weights and the next step's first stage:
  // held in registers through the Gram, the factor and the kernel draws,
  // they made the twins spill
  float* const lwrow = gbuf + S * stride;
  float x[kPer][S], lw[kPer], lw_new[kPer];
  float hv[kPer][kK];

  // lw_sys_row's weigh_and_resample (weigh_step); the joint resample
  // reads the ancestors' theta into registers, crosses a barrier and
  // writes its own slots.  At t > 0 the max's barrier follows every read
  // of the step's draws, so the paired layout frees its ring slot there.
  auto weigh_and_resample = [&](int t, auto lcl_of) -> bool {
    const uint32_t tu = static_cast<uint32_t>(t);
    const bool may_fire = ess_limit > 0.0f || resample_every == 1 ||
                          (t + 1) % resample_every == 0;
    if (may_fire && i == 0) offsets[1] = ssme::offset_at(k0, k1, tu, b);
    float w[kPer], base, total;
    const bool fire = weigh_step<kPer, K>(
        t, may_fire, ess_limit, active, lw_new, hv, lw, w, base, total,
        max_part, sums_b, rec, lcl, fpaths, num_filters, num_steps, b,
        [&] {
          if (t > 0) draws.release(tu);
        },
        lcl_of);
    if (!fire) {
      if (active) {
#pragma unroll
        for (int p = 0; p < kPer; ++p) lwrow[own0 + p] = lw[p];
      }
      return false;
    }
    ssme::warp_cdf_raise<kPer>(w, active);
    float g[kPer][S];
#pragma unroll
    for (int p = 0; p < kPer; ++p)
#pragma unroll
      for (int l = 0; l < S; ++l) g[p][l] = x[p][l];
    int anc[kPer];
    systematic_select(w, base, offsets[1], total, g, anc);
    float moved[kPer][P];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
#pragma unroll
      for (int l = 0; l < S; ++l) x[p][l] = g[p][l];
      lw[p] = 0.0f;
      const int from = ssme::padded(active ? anc[p] : 0);
#pragma unroll
      for (int k = 0; k < P; ++k) moved[p][k] = th[k * stride + from];
    }
    ssme::row_sync(bars);  // every read of the ancestors' theta is done
    if (active) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
#pragma unroll
        for (int k = 0; k < P; ++k) th[k * stride + own0 + p] = moved[p][k];
        lwrow[own0 + p] = 0.0f;
      }
    }
    rec.tick(kLWSpanResample);
    return true;
  };

  // t = 0: the prior draw (uniforms keyed by the particle) to theta, the
  // init draw from draw P on, the first weights
  load_step<Model>(ys, zs, 0, y, z);
  ssme::for_pair<kDraws>(
      k0, k1, i, 0u, b,
      [&](auto& rng, int p) {
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
            if (active)
              th[k * stride + own0 + p] =
                  ssme::to_transformed(Model::code(k), cp[k]);
          }
        }
        model.init(rng, cp, y, z, x[p]);
        lw_new[p] = model.log_weight(cp, x[p], y, z);
#pragma unroll
        for (int k = 0; k < K; ++k) hv[p][k] = model.functional(k, cp, x[p]);
      },
      static_cast<uint32_t>(P));
  rec.tick(kLWSpanDraws);
  {
    const bool fired = weigh_and_resample(
        0, [&](float lse) { return lse - logf(static_cast<float>(n)); });
    if (fired) rec.count(kLWSpanFirstResamples);
    rec.close_step(fired ? kLWSpanBarFirstResample : kLWSpanBarFirstOther);
  }

  for (int t = 1; t < num_steps; ++t) {
    const uint32_t tu = static_cast<uint32_t>(t);

    // the moments (the note): the weights staged in double and theta
    // published, the pass on the row's first warps, then the fold
    double* const wst = reinterpret_cast<double*>(gbuf);
    if (active) {
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        wst[own0 + p] = static_cast<double>(expf(lwrow[own0 + p]));
    }
    ssme::row_sync(bars);
    {
      // the warps of the pass (the row's first, at most kMomentWarps)
      const int nw = block_warps();
      const int mw = nw < kMomentWarps ? nw : kMomentWarps;
      if (warp < mw) moments_pass<P>(th, wst, stride, n, warp, mw, mom_part);
      ssme::row_sync(bars);
      rec.tick(kLWSpanMoments);
      moments_fold<P>(th, stride, mom_part, mw, warp, nw, tb, gram,
                      lcl_terms);
    }
    ssme::row_sync(bars);
    rec.tick(kLWSpanMomentsFold);
    if (warp == 0) wide_cholesky<P>(args.h2 / tb[P], gram, chol);
    rec.tick(kLWSpanCholesky);
    // the step's observation, loaded where it is used, here and again at
    // the transition (registers held through the moments and the kernel
    // draws would spill)
    load_step<Model>(ys, zs, t, y, z);

    // the first stage (APF): lw_sys_row's, the ancestors' theta left where
    // it is; under SISR each particle is its own ancestor, and a barrier
    // publishes the factor
    int anc[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) anc[p] = kPer * static_cast<int>(i) + p;
    float lg_anc[kPer];
    if (apf) {
      if (i == 0)
        offsets[0] = ssme::offset_at(k0, k1, tu, b, ssme::kTagSelectOffset);
      float g[kPer][S + 1];
      float lfs[kPer];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        float th_p[P], cp[P], look[S];
#pragma unroll
        for (int k = 0; k < P; ++k) th_p[k] = th[k * stride + own0 + p];
        constrain<Model>(th_p, cp);
        model.prop_mu(cp, x[p], y, z, look);
#pragma unroll
        for (int k = 0; k < P; ++k) th_p[k] = shrink(args, th_p[k], tb[k]);
        constrain<Model>(th_p, cp);
        const float lg = model.log_weight(cp, look, y, z);
        lfs[p] = lwrow[own0 + p] + lg;
#pragma unroll
        for (int l = 0; l < S; ++l) g[p][l] = x[p][l];
        g[p][S] = lg;
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
      if (i == 0) lcl_terms[1] = mfs + logf(total);
      systematic_select(lfs, base, offsets[0], total, g, anc);
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
#pragma unroll
        for (int l = 0; l < S; ++l) x[p][l] = g[p][l];
        lg_anc[p] = g[p][S];
      }
      rec.tick(kLWSpanFirstStage);
    } else {
      ssme::row_sync(bars);
    }

    // the kernel draws theta' = shrunk_anc + L e (draws 0 .. P-1), the
    // ancestors' theta read before a barrier and theta' written after it;
    // then the transition from draw P on and the weights.  The paired
    // layout waits on its ring here, its first use of the step's draws.
    {
      float nt[kPer][P];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int from = ssme::padded(active ? anc[p] : 0);
#pragma unroll
        for (int r = 0; r < P; ++r)
          nt[p][r] = shrink(args, th[r * stride + from], tb[r]);
      }
      // every read of the ancestors' theta (and of the first stage's
      // gather) is done: theta' may be written, and the state and the
      // ancestor's density (SISR: the carried log-weight) wait in the
      // gather buffer's own slots through the kernel draws, whose
      // registers they would crowd
      ssme::row_sync(bars);
      if (active) {
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
#pragma unroll
          for (int l = 0; l < S; ++l) gbuf[l * stride + own0 + p] = x[p][l];
          if (apf) lwrow[own0 + p] = lg_anc[p];  // SISR: lw is there
        }
      }
      // the step's normals: the paired layout's ring, or the single
      // layout's stash, which this thread fills first with its pair's P +
      // kDraws draws (drawn where they are used, a Philox call's
      // registers beside the 42 sums, or the hooks' 42 parameters,
      // spilled)
      if constexpr (Draws::kPaired) {
        rec.tick(kLWSpanDraws);
        draws.wait(tu);
        rec.tick(kLWSpanRingWait);
      } else {
#pragma unroll 1
        for (int k = 0; k < P + kDraws; ++k) {
          const float2 e = draws.kernel_normal(i, tu, k);
          stash[k * blockDim.x + i].x = e.x;
          stash[k * blockDim.x + i].y = e.y;
        }
      }
      constexpr int kCol = chol_stride(P);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        float2 e;
        if constexpr (Draws::kPaired) {
          e = draws.kernel_normal(i, tu, k);
        } else {
          e.x = stash[k * blockDim.x + i].x;
          e.y = stash[k * blockDim.x + i].y;
        }
        const float4* col = reinterpret_cast<const float4*>(chol + k * kCol);
#pragma unroll
        for (int q = k / 4; q < kCol / 4; ++q) {
          const float4 c4 = col[q];  // a broadcast: every thread reads it
          const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = 4 * q + u;
            if (r >= k && r < P) {
              nt[0][r] = fmaf(c[u], e.x, nt[0][r]);
              nt[1][r] = fmaf(c[u], e.y, nt[1][r]);
            }
          }
        }
      }
      if (active) {
#pragma unroll
        for (int p = 0; p < kPer; ++p)
#pragma unroll
          for (int r = 0; r < P; ++r) th[r * stride + own0 + p] = nt[p][r];
      }
    }
    load_step<Model>(ys, zs, t, y, z);
    // the transition from draw P on and the weights, a particle a call
    auto transition = [&](auto& rng, int p) {
      float tp[P], cp[P];
#pragma unroll
      for (int k = 0; k < P; ++k) tp[k] = th[k * stride + own0 + p];
#pragma unroll
      for (int l = 0; l < S; ++l) x[p][l] = gbuf[l * stride + own0 + p];
      const float carried = lwrow[own0 + p];
      constrain<Model>(tp, cp);
      if (apf) {
        model.propagate(rng, cp, x[p], y, z);
        lw_new[p] = model.log_weight(cp, x[p], y, z) - carried;
      } else if constexpr (Model::kHasProposal) {
        float x_anc[S];
#pragma unroll
        for (int l = 0; l < S; ++l) x_anc[l] = x[p][l];
        model.sample_q(rng, cp, x_anc, y, z, x[p]);
        lw_new[p] = carried + (model.log_weight(cp, x[p], y, z) +
                               model.log_fq(cp, x[p], x_anc, y, z));
      } else {
        model.propagate(rng, cp, x[p], y, z);
        lw_new[p] = carried + model.log_weight(cp, x[p], y, z);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) hv[p][k] = model.functional(k, cp, x[p]);
    };
    if constexpr (Draws::kPaired) {
      draws.template for_pair<kDraws>(i, tu, transition,
                                      static_cast<uint32_t>(P));
    } else {
      StashPairRng<kDraws> first{stash + P * blockDim.x + i,
                                 static_cast<int>(blockDim.x)};
      transition(first, 0);
      ssme::PairSines<kDraws> second{first.sine};
      transition(second, 1);
    }
    rec.tick(kLWSpanDraws);
    const bool fired = weigh_and_resample(
        t,
        [&](float lse) {
          const float log_w = logf(lcl_terms[0]);
          return apf ? ((lcl_terms[1] - log_w) + lse) -
                           logf(static_cast<float>(n))
                     : lse - log_w;
        });
    if (fired) rec.count(kLWSpanResamples);
    rec.close_step(fired ? kLWSpanBarResample : kLWSpanBarOther);
  }

  rec.finish(spans, b, kPer, Draws::kPaired ? 2 : 1);
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
#pragma unroll
    for (int p = 0; p < kPer; ++p) row[p] = lwrow[own0 + p];
    store_neighbours<kPer>(out + static_cast<size_t>(S) * n, row);
#pragma unroll
    for (int k = 0; k < P; ++k) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) row[p] = th[k * stride + own0 + p];
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
// draws rank 1 writes into its ring (lw_sys_row: kRingSlots steps at the
// start of the dynamic shared memory; the wide row: kWideRingSlots after
// its arrays).  Both set up their barriers and cross a cluster barrier
// before either touches the other's shared memory, and another before
// either exits.
template <class Model, int kPer, bool kRecord>
__device__ __forceinline__ void lw_pair_row(
    const int64_t* __restrict__ seed, const float* __restrict__ ys,
    const float* __restrict__ zs, int num_steps, int num_particles, int apf,
    int resample_every, float ess_limit, const LWArgs& args,
    float* __restrict__ lcl, float* __restrict__ fpaths,
    float* __restrict__ cloud, long long* __restrict__ spans) {
  static_assert(kPer == 2, "one producer thread a pair of a filter thread");
  constexpr bool kWide = is_wide<Model>();
  static_assert(!kWide || wide_pair_fits<Model>(),
                "a wide row and its one-step ring fit a block");
  constexpr int kSlots = kWide ? kWideRingSlots : kRingSlots;
  constexpr int kAll = Model::kNumParams + Model::kDraws;
  extern __shared__ __align__(16) unsigned long long lw_ring_area[];
  unsigned long long* const area =
      kWide ? lw_ring_area + WideRowLayout<Model>::bytes(num_particles) / 8
            : lw_ring_area;
  const uint32_t rank = cluster_rank();
  const uint32_t b = blockIdx.x / 2;
  const int threads = blockDim.x;
  const uint32_t ring = smem_addr(area);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (rank == 0)
        ring_bar_init(ring + 8 * s, threads / 32);  // full: producer warps
      else
        ring_bar_init(ring + 8 * (kSlots + s), 1);  // empty: thread 0
    }
    ring_bar_init_fence();
  }
  cluster_sync();
  if (rank == 0) {
    const RingDrawsT<kSlots> draws{
        reinterpret_cast<const float2*>(area + 2 * kSlots), ring,
        map_rank(ring + 8 * kSlots, 1), threads,
        ring_slot_pairs(kAll, threads)};
    if constexpr (kWide) {
      lw_wide_row<Model, kPer, kRecord>(
          seed, ys, zs, num_steps, num_particles, apf, resample_every,
          ess_limit, args, lcl, fpaths, cloud, spans, b,
          static_cast<int>(gridDim.x / 2), draws);
    } else {
      lw_sys_row<Model, kPer, kRecord>(
          seed, ys, zs, num_steps, num_particles, apf, resample_every,
          ess_limit, args, lcl, fpaths, cloud, spans, b,
          static_cast<int>(gridDim.x / 2), draws);
    }
  } else {
    lw_ring_produce<kAll, kSlots>(static_cast<uint32_t>(seed[0]),
                                  static_cast<uint32_t>(seed[1]), num_steps,
                                  num_particles, b, ring);
  }
  cluster_sync();
}

// The kernel: one row per CTA, the systematic family (kRoll false; the
// wide row past kRegParams parameters) or the roll family at kPer
// particles a thread and up to kThreads threads; or, kPaired, the
// systematic family's paired layout, one row per cluster of two CTAs
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
    if constexpr (is_wide<Model>()) {
      lw_wide_row<Model, kPer, kRecord>(
          seed, ys, zs, num_steps, num_particles, apf, resample_every,
          ess_limit, args, lcl, fpaths, cloud, spans, blockIdx.x,
          static_cast<int>(gridDim.x), draws);
    } else {
      lw_sys_row<Model, kPer, kRecord>(
          seed, ys, zs, num_steps, num_particles, apf, resample_every,
          ess_limit, args, lcl, fpaths, cloud, spans, blockIdx.x,
          static_cast<int>(gridDim.x), draws);
    }
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

// an instance's dynamic shared memory at n particles and `threads`
// threads, admitted with cudaFuncSetAttribute above 48 KB; the
// attribute's error, or cudaSuccess
template <class Model, int kPer, int kThreads, bool kRecord, bool kRoll,
          bool kPaired>
cudaError_t admit_dynamic(int n, int threads, int* dynamic) {
  *dynamic = 0;
  if constexpr (kRoll) {
    *dynamic = roll_row_bytes<Model, kPer, kThreads>();
  } else if constexpr (kPaired && is_wide<Model>()) {
    const int row = WideRowLayout<Model>::pair_bytes(n, threads);
    *dynamic = row > kPairFloorBytes ? row : kPairFloorBytes;
  } else if constexpr (kPaired) {
    *dynamic = pair_dynamic_bytes(Model::kNumParams + Model::kDraws, threads);
  } else if constexpr (is_wide<Model>()) {
    *dynamic = WideRowLayout<Model>::single_bytes(n, threads);
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
                                kPaired>(a.num_particles, threads, &dynamic);
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
                                  true>(num_particles, threads, &dynamic);
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
      // a wide row has no roll form
      if constexpr (is_wide<Model>() && kRoll) {
        return -3;
      } else {
        return launch_row<Model, kPer, kThreads, kRecord, kRoll, kPaired>(
            a, args);
      }
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
