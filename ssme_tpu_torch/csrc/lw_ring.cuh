// Where the Liu-West kernel's systematic row takes its random numbers at
// t >= 1, in its two layouts (lw_megakernel_sys.cuh):
//  - single (OwnDraws): one CTA a filter computes every draw in place, as
//    it needs it;
//  - paired (RingDraws, lw_ring_produce): each filter runs on a cluster of
//    two CTAs on two SMs.  Rank 0, the filter, runs the row; rank 1, the
//    producer, draws each step's normals and its two systematic offsets
//    into a ring of kRingSlots steps in rank 0's shared memory, through
//    distributed shared memory.  None of them depends on the particles
//    (each is a Philox call keyed by pair, step, row and tag), so the
//    producer runs ahead of the filter and the draws leave the filter's
//    chain of dependent arithmetic; the filter's barriers stay as they
//    are: it waits on the ring once a step and frees a slot with one
//    remote arrive.
// Both compute the same functions on the same counters (philox.cuh
// normal_pair_at and offset_at), so both layouts give the plain version's
// bits.
//
// The ring, in each CTA's dynamic shared memory at the same offsets:
// kRingSlots full barriers (rank 0's: each producer warp's lane 0 arrives
// once, expecting the bytes its warp stores, and each asynchronous remote
// store completes its bytes there, so the phase completes when the slot's
// data has landed), kRingSlots empty barriers (rank 1's: the filter's
// thread 0 arrives after a barrier every thread crosses after its last
// read of the slot), then the slots: slot s holds the step's offsets
// (first stage, resample) as one float2, then draw d of pair q as the
// float2 (particle 2q, particle 2q + 1) at 1 + d * threads + q, for the P
// kernel draws and the hooks' kDraws.  Use u of slot s is step t = 1 + s +
// u kRingSlots; a wait on use u of a barrier takes parity u & 1.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"
#include "step_rng.cuh"

namespace ssme_lw {

constexpr int kRingSlots = 4;
// the least dynamic shared memory of each CTA of a pair: more than half of
// an H100 SM's 228 KB, so that no SM holds two of the launch's CTAs and
// the producer never takes the filter's SM
constexpr int kPairFloorBytes = 116 * 1024;

// float2 entries of a slot, and bytes of the ring, for `draws` normals a
// pair (P + kDraws) at `threads` threads (one a pair)
__host__ __device__ constexpr int ring_slot_pairs(int draws, int threads) {
  return 1 + draws * threads;
}
__host__ __device__ constexpr int ring_bytes(int draws, int threads) {
  return 16 * kRingSlots + 8 * kRingSlots * ring_slot_pairs(draws, threads);
}
__host__ __device__ constexpr int pair_dynamic_bytes(int draws, int threads) {
  return ring_bytes(draws, threads) > kPairFloorBytes
             ? ring_bytes(draws, threads)
             : kPairFloorBytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of both CTAs; orders shared memory across the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// the address, in CTA `rank`'s shared memory, of the variable at `addr` in
// this CTA's
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void ring_bar_init(uint32_t addr, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(addr), "r"(count) : "memory");
}

__device__ __forceinline__ void ring_bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// wait until this CTA's barrier at `addr` has completed the phase of
// `parity`
__device__ __forceinline__ void ring_bar_wait(uint32_t addr, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// one arrive on a barrier of another CTA (`addr` from map_rank)
__device__ __forceinline__ void ring_bar_arrive_remote(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];"
               :: "r"(addr) : "memory");
}

// one arrive on a barrier of another CTA that expects `bytes` more of
// asynchronous stores to complete there
__device__ __forceinline__ void ring_bar_arrive_expect_remote(uint32_t addr,
                                                              uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cluster.b64 _, [%0], %1;"
               :: "r"(addr), "r"(bytes) : "memory");
}

// an asynchronous store into another CTA's shared memory that completes
// its 8 bytes on that CTA's barrier `bar`
__device__ __forceinline__ void store_remote(uint32_t addr, float2 v,
                                             uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32"
               " [%0], {%1, %2}, [%3];"
               :: "r"(addr), "f"(v.x), "f"(v.y), "r"(bar) : "memory");
}

// the single layout: every draw computed where it is used
struct OwnDraws {
  static constexpr bool kPaired = false;
  uint32_t k0, k1, b;
  __device__ void wait(uint32_t) const {}
  __device__ void release(uint32_t) const {}
  __device__ float offset(uint32_t t, uint32_t tag) const {
    return ssme::offset_at(k0, k1, t, b, tag);
  }
  // kernel draw k of pair q
  __device__ float2 kernel_normal(uint32_t q, uint32_t t, int k) const {
    return ssme::normal_pair_at(k0, k1, q, t, b, static_cast<uint32_t>(k));
  }
  // the hook of pair q on its draws from `base` (step_rng.cuh for_pair)
  template <int kDraws, class Hook>
  __device__ void for_pair(uint32_t q, uint32_t t, Hook&& hook,
                           uint32_t base) const {
    ssme::for_pair<kDraws>(k0, k1, q, t, b, hook, base);
  }
};

// PairRng's reader of the ring: draw k of the first particle is the
// cosine at draws[k * stride], whose sine the second particle's PairSines
// returns
template <int kDraws>
struct RingPairRng {
  const float2* draws;
  int stride;
  int draw = 0;
  float sine[kDraws];
  __device__ float normal() {
    const float2 z = draws[draw * stride];
    sine[draw++] = z.y;
    return z.x;
  }
};

// the paired layout's filter (rank 0): the step's draws from the ring
struct RingDraws {
  static constexpr bool kPaired = true;
  const float2* slots;  // slot 0
  uint32_t full;        // full barrier 0, this CTA's
  uint32_t empty;       // empty barrier 0, the producer's (map_rank)
  int threads, slot_pairs;
  __device__ uint32_t slot(uint32_t t) const { return (t - 1) % kRingSlots; }
  __device__ const float2* at(uint32_t t) const {
    return slots + slot(t) * slot_pairs;
  }
  // every thread: until the producer has filled step t's slot
  __device__ void wait(uint32_t t) const {
    ring_bar_wait(full + 8 * slot(t), ((t - 1) / kRingSlots) & 1);
  }
  // thread 0, after a barrier that every thread crosses after its last
  // read of step t's slot: the slot is free
  __device__ void release(uint32_t t) const {
    if (threadIdx.x == 0) ring_bar_arrive_remote(empty + 8 * slot(t));
  }
  __device__ float offset(uint32_t t, uint32_t tag) const {
    const float2 o = at(t)[0];
    return tag == ssme::kTagSelectOffset ? o.x : o.y;
  }
  __device__ float2 kernel_normal(uint32_t q, uint32_t t, int k) const {
    return at(t)[1 + k * threads + static_cast<int>(q)];
  }
  template <int kDraws, class Hook>
  __device__ void for_pair(uint32_t q, uint32_t t, Hook&& hook,
                           uint32_t base) const {
    RingPairRng<kDraws> first{
        at(t) + 1 + static_cast<int>(base) * threads + static_cast<int>(q),
        threads};
    hook(first, 0);
    ssme::PairSines<kDraws> second{first.sine};
    hook(second, 1);
  }
};

// The paired layout's producer (rank 1) of filter b: for t = 1 .. T-1 in
// order, waits for a free slot; then each warp's lane 0 arrives on the
// slot's full barrier expecting the bytes its warp stores, thread q
// stores pair q's `kAll` normals (P + kDraws) into rank 0's slot and
// thread 0 the two offsets, each store completing its bytes on that
// barrier.  `ring` is this CTA's ring (the same offsets as rank 0's).
template <int kAll>
__device__ __forceinline__ void lw_ring_produce(uint32_t k0, uint32_t k1,
                                                int num_steps,
                                                int num_particles, uint32_t b,
                                                uint32_t ring) {
  const uint32_t q = threadIdx.x;
  const int threads = blockDim.x;
  const bool active = static_cast<int>(2 * q) < num_particles;
  const uint32_t full = map_rank(ring, 0);
  const uint32_t empty = ring + 8 * kRingSlots;
  const uint32_t slots = full + 16 * kRingSlots;
  const uint32_t slot_bytes = 8 * ring_slot_pairs(kAll, threads);
  // the bytes this warp stores a step: its active lanes' normals, and
  // warp 0 the offsets
  const uint32_t warp_bytes =
      8 * (kAll * __popc(__ballot_sync(0xffffffffu, active)) + (q < 32));
  for (int t = 1; t < num_steps; ++t) {
    const uint32_t tu = static_cast<uint32_t>(t);
    const uint32_t s = (tu - 1) % kRingSlots, use = (tu - 1) / kRingSlots;
    if (use > 0) ring_bar_wait(empty + 8 * s, (use - 1) & 1);
    const uint32_t slot = slots + s * slot_bytes, bar = full + 8 * s;
    if ((q & 31) == 0) ring_bar_arrive_expect_remote(bar, warp_bytes);
    if (active) {
#pragma unroll
      for (int d = 0; d < kAll; ++d)
        store_remote(slot + 8 * (1 + d * threads + q),
                     ssme::normal_pair_at(k0, k1, q, tu, b,
                                          static_cast<uint32_t>(d)),
                     bar);
    }
    if (q == 0)
      store_remote(slot,
                   make_float2(ssme::offset_at(k0, k1, tu, b,
                                               ssme::kTagSelectOffset),
                               ssme::offset_at(k0, k1, tu, b)),
                   bar);
  }
}

}  // namespace ssme_lw
