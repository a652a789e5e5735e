// Roll-based Metropolis and rejection ancestor selection for one CTA per
// filter row, keyed by slot index: roll_select below takes the layout as
// a class (NeighbourSlots, the layout of row_select.cuh that the roll
// families of the SVOL, generic and Liu-West filter kernels and the
// standalone selection run).  Replaces metropolis_select_leaves and
// rejection_select_leaves of ssme_tpu/ops/_select.py (Murray, Lee &
// Jacob's GPU resamplers).
//
// The TPU moves values: each sweep rolls every leaf by the cumulative
// shift c and selects elementwise, because its lanes cannot gather.  Here
// the row's weights sit in shared memory and each thread carries only the
// candidate INDEX of its slots: slot j proposes (j - c) mod n, reads that
// weight and decides.  The leaves move once, by the final ancestors,
// through the caller's gather buffers.  The law is the TPU's exactly,
// because its rolls are exact:
//  - metropolis: exactly `iters` sweeps of chains that start at j and
//    accept at u w_cur < w_cand (finite-sweep bias: ops/_select.py);
//  - rejection: sweep 0 proposes the slot itself, later sweeps (j - c);
//    accept at u w_max < w_cand; an accepted slot freezes; a slot still
//    pending after kRollMaxIters sweeps keeps itself.  The TPU stops when
//    all 8 rows of its tile are done; frozen slots do not move, so the law
//    is the same.
// Random numbers (ops/_prng.py): sweep s takes tag tag_base + s; slot j's
// accept uniform is uniform_open_zero of word 0 of counter (j, t, b, tag),
// the row's shift word is word 1 of counter (0, t, b, tag), added modulo
// 2^32.  No fast-math intrinsics: the compare u * w < w' is one rounded
// product, as in the plain version.
//
// Schedule (ops/_select.py roll_schedule is its plain model).  The law
// fixes every draw, so the order of the tests is free:
//  - shifts by chunks of kRollChunk = 32 sweeps: lane l of every warp
//    computes the shift word of sweep s0 + l (one Philox call) and a warp
//    inclusive scan (__shfl_up_sync, uint32 addition, exact modulo 2^32)
//    gives each sweep's cumulative shift, which a slot reads with
//    __shfl_sync.  Every warp computes the chunk itself, so no barrier:
//    one shift call per lane per 32 sweeps, where every thread made one
//    per sweep;
//  - metropolis: each slot runs its chain of exactly `iters` sweeps;
//  - rejection, bulk: after sweep 0, chunks of 32 sweeps; a warp leaves a
//    chunk as soon as none of its slots is pending (__any_sync), and the
//    row votes once per chunk (__syncthreads_count), stopping when no
//    thread holds a pending slot, or at the cap (the sweep index never
//    passes kRollMaxIters);
//  - rejection, tail: once at most kRollTailThreads threads hold a
//    pending slot, those slots go into a shared list and each warp takes
//    one at a time: lane l tests sweep s0 + l of that slot (its own
//    Philox call, its cumulative shift from the same scan) and
//    __ballot_sync + __ffs give the first accepting sweep, chunk after
//    chunk up to the cap.  A slot's decisions depend only on its own
//    uniforms and the row's shifts, so testing its sweeps side by side
//    gives the ancestor the sequential loop gives, bit for bit.
// What bounds it: the Philox calls of the pending slots' uniforms (one a
// slot and sweep, fixed by the counter map) and, in the tail, the sweeps
// of the slowest slot divided by 32.
#pragma once

#include <cstdint>

#include "philox.cuh"
#include "row_select.cuh"

namespace ssme {

// resampler codes of the C entry points (ops/_select.py RESAMPLER_CODES)
constexpr int kResampleSystematic = 0;
constexpr int kResampleMetropolis = 1;
constexpr int kResampleRejection = 2;
constexpr int kRollMaxIters = 4096;
// sweeps a warp's shift scan covers
constexpr int kRollChunk = 32;
// threads holding a pending slot at or below which rejection turns to the
// sweep-parallel tail (PERF.md §6: from a grid on the card, beside the
// sweep counts of chip_smoke phase 23's path)
constexpr int kRollTailThreads = 32;

__device__ __forceinline__ float roll_uniform(uint32_t k0, uint32_t k1,
                                              uint32_t j, uint32_t t,
                                              uint32_t b, uint32_t tag) {
  return uniform_open_zero(philox4x32_10(make_uint4(j, t, b, tag), k0, k1).x);
}

__device__ __forceinline__ uint32_t roll_shift(uint32_t k0, uint32_t k1,
                                               uint32_t t, uint32_t b,
                                               uint32_t tag) {
  return philox4x32_10(make_uint4(0u, t, b, tag), k0, k1).y;
}

// c plus the shift words of sweeps s0 .. s0 + lane (lane = threadIdx.x %
// 32; sweeps at or past `end` add nothing), mod 2^32.  Every lane of the
// warp calls it; no barrier.
__device__ __forceinline__ uint32_t chunk_shifts(uint32_t c, int s0, int end,
                                                 uint32_t k0, uint32_t k1,
                                                 uint32_t t, uint32_t b,
                                                 uint32_t tag_base) {
  const int lane = threadIdx.x & 31;
  uint32_t v = s0 + lane < end
                   ? roll_shift(k0, k1, t, b,
                                tag_base + static_cast<uint32_t>(s0 + lane))
                   : 0u;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFullMask, v, o);
    if (lane >= o) v += y;
  }
  return c + v;
}

// slot p of this thread, and the shared index of particle j's weight
// kPer neighbouring slots a thread, weights at padded indices
// (row_select.cuh)
template <int kPer>
struct NeighbourSlots {
  __device__ static uint32_t slot(int p) { return kPer * threadIdx.x + p; }
  __device__ static int at(uint32_t j) { return padded(static_cast<int>(j)); }
};

// the tail's shared list: its length, then one entry per pending slot
template <int kPer>
__device__ __forceinline__ int* roll_list() {
  __shared__ int list[1 + kRollTailThreads * kPer];
  return list;
}

// The ancestors of this thread's slots Slots::slot(p), p < kPer (none when
// !active), under the row's n weights wsh (shared, at Slots::at(j),
// published by the caller's last barrier and left unwritten until the
// caller's next): take(p, a) hands slot p its ancestor a, once per slot
// whose ancestor may differ from itself (rejection: when it accepts, or
// leaves the tail; metropolis: at the end), so a caller can move the
// slot's state as it comes.  w_max: the row's largest weight (rejection).
// Every thread of the CTA calls it.  Metropolis crosses no barrier;
// rejection one per chunk of 32 sweeps after sweep 0 and, in the tail,
// two more, each counted in *bars when bars is not null.  rec
// (instrumented kernels; shared int[3], or null): on return, read by
// thread 0, the sweeps the selection ran (1 + the last accept sweep,
// kRollMaxIters at the cap; metropolis: iters), its votes and the slots
// it passed to the tail.
//
// The bulk takes a thread's pending slots kGroup at a time (the set bits
// of its pending mask, so p is a run-time index), drawing the group's
// uniforms before it compares them: independent Philox chains a thread
// can overlap, where a row of degenerate weights keeps every slot pending
// for thousands of sweeps on one SM, and no draw for a slot that has
// accepted.
template <int kPer, class Slots, class Take>
__device__ __forceinline__ void roll_select(
    int resampler, int iters, bool active, const float* wsh, float w_max,
    int n, uint32_t k0, uint32_t k1, uint32_t t, uint32_t b,
    uint32_t tag_base, Take&& take, long long* bars = nullptr,
    int* rec = nullptr) {
  const uint32_t mask = static_cast<uint32_t>(n) - 1u;
  if (resampler == kResampleMetropolis) {
    // each chain's current particle; its weight is read again from wsh
    int anc[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) anc[p] = static_cast<int>(Slots::slot(p));
    uint32_t c = 0u;
    for (int s0 = 0; s0 < iters; s0 += kRollChunk) {
      const uint32_t cs = chunk_shifts(c, s0, iters, k0, k1, t, b, tag_base);
      const int k_end = min(kRollChunk, iters - s0);
      for (int k = 0; k < k_end; ++k) {
        const uint32_t c_s = __shfl_sync(kFullMask, cs, k);
        if (!active) continue;
        const uint32_t tag = tag_base + static_cast<uint32_t>(s0 + k);
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const uint32_t j = Slots::slot(p);
          const uint32_t idx = (j - c_s) & mask;
          const float cand = wsh[Slots::at(idx)];
          if (roll_uniform(k0, k1, j, t, b, tag) *
                  wsh[Slots::at(static_cast<uint32_t>(anc[p]))] <
              cand)
            anc[p] = static_cast<int>(idx);
        }
      }
      c = __shfl_sync(kFullMask, cs, 31);
    }
    if (active) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) take(p, anc[p]);
    }
    if (rec && threadIdx.x == 0) {
      rec[0] = iters;
      rec[1] = rec[2] = 0;
    }
    return;
  }
  constexpr int kGroup = kPer < 4 ? kPer : 4;
  int* const list = roll_list<kPer>();
  // sweep 0: each slot proposes itself; pend: this thread's pending slots
  uint32_t pend = 0u;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const uint32_t j = Slots::slot(p);
    if (active && !(roll_uniform(k0, k1, j, t, b, tag_base) * w_max <
                    wsh[Slots::at(j)]))
      pend |= 1u << p;
  }
  // the list's length and the record start here; every write to them
  // comes after the first vote
  if (threadIdx.x == 0) {
    list[0] = 0;
    if (rec) {
      rec[0] = 1;
      rec[1] = rec[2] = 0;
    }
  }
  auto accepted = [&](int s) {
    if (rec) atomicMax(&rec[0], s + 1);
  };
  uint32_t c = 0u;
  int s0 = 1;
  for (;;) {
    const int busy = __syncthreads_count(pend != 0u);
    if (threadIdx.x == 0) {
      if (bars) *bars += 1;
      if (rec) rec[1] += 1;
    }
    if (busy == 0) return;
    if (s0 >= kRollMaxIters) {  // the cap: pending slots keep themselves
      if (rec && threadIdx.x == 0) rec[0] = kRollMaxIters;
      return;
    }
    if (busy <= kRollTailThreads) break;
    const uint32_t cs = chunk_shifts(c, s0, kRollMaxIters, k0, k1, t, b,
                                     tag_base);
    const int k_end = min(kRollChunk, kRollMaxIters - s0);
    for (int k = 0; k < k_end; ++k) {
      if (!__any_sync(kFullMask, pend != 0u)) break;
      const uint32_t c_s = __shfl_sync(kFullMask, cs, k);
      const uint32_t tag = tag_base + static_cast<uint32_t>(s0 + k);
      for (uint32_t todo = pend; todo;) {
        int q[kGroup];  // the group's slots; -1 past the last (drawn as q[0])
        uint32_t idx[kGroup];
        float u[kGroup];
#pragma unroll
        for (int e = 0; e < kGroup; ++e) {
          q[e] = todo ? __ffs(todo) - 1 : -1;
          todo &= todo - 1u;
          const uint32_t j = Slots::slot(q[e] < 0 ? q[0] : q[e]);
          idx[e] = (j - c_s) & mask;
          u[e] = roll_uniform(k0, k1, j, t, b, tag);
        }
#pragma unroll
        for (int e = 0; e < kGroup; ++e) {
          if (q[e] >= 0 && u[e] * w_max < wsh[Slots::at(idx[e])]) {
            pend &= ~(1u << q[e]);
            take(q[e], static_cast<int>(idx[e]));
            accepted(s0 + k);
          }
        }
      }
    }
    c = __shfl_sync(kFullMask, cs, 31);
    s0 += kRollChunk;
  }
  // the tail: this thread's pending slots to the list, then one warp a slot
  const int mine = __popc(pend);
  int at = mine ? 1 + atomicAdd(&list[0], mine) : 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p)
    if (pend >> p & 1u) list[at++] = static_cast<int>(Slots::slot(p));
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int entries = list[0];
  if (threadIdx.x == 0) {
    if (bars) *bars += 1;
    if (rec) rec[2] = entries;
  }
  for (int e = 1 + (threadIdx.x >> 5); e <= entries;
       e += blockDim.x >> 5) {
    const uint32_t j = static_cast<uint32_t>(list[e]);
    uint32_t ce = c;
    int found = -1;
    for (int s = s0; s < kRollMaxIters; s += kRollChunk) {
      const uint32_t cs = chunk_shifts(ce, s, kRollMaxIters, k0, k1, t, b,
                                       tag_base);
      const uint32_t idx = (j - cs) & mask;
      const bool ok =
          s + lane < kRollMaxIters &&
          roll_uniform(k0, k1, j, t, b,
                       tag_base + static_cast<uint32_t>(s + lane)) * w_max <
              wsh[Slots::at(idx)];
      const unsigned vote = __ballot_sync(kFullMask, ok);
      if (vote) {
        const int l = __ffs(vote) - 1;
        found = static_cast<int>(__shfl_sync(kFullMask, idx, l));
        if (lane == 0) accepted(s + l);
        break;
      }
      ce = __shfl_sync(kFullMask, cs, 31);
    }
    if (found < 0 && lane == 0) accepted(kRollMaxIters - 1);
    __syncwarp();  // every lane read list[e] before lane 0 writes it
    if (lane == 0) list[e] = found >= 0 ? found : static_cast<int>(j);
  }
  __syncthreads();
  if (bars && threadIdx.x == 0) *bars += 1;
  at = mine ? at - mine : 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p)
    if (pend >> p & 1u) take(p, list[at++]);
}

}  // namespace ssme
