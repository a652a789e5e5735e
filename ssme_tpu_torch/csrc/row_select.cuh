// Block primitives for one CTA per filter row with kPer NEIGHBOURING
// particles per thread: particle j = kPer * threadIdx.x + p, p < kPer.
// blockDim.x is a multiple of 32; the first `active` threads hold the n
// particles, and the lanes after them (a partial last warp) hold none and
// are masked out of every reduction.  Every family of the SVOL filter
// kernel (svol_filter_sys.cu), the generic filter kernel
// (filter_megakernel_sys.cuh) and the Liu-West kernel
// (lw_megakernel_sys.cuh) runs these exchanges; the systematic ones
// count, mark, scan and gather here (replacing select_leaves_dense of
// ssme_tpu/ops/_select.py), the roll ones select in roll_select.cuh.
//
// Exchanges.  A thread first folds its kPer values in registers, a warp
// reduces with shuffles, and the warps meet at ONE barrier: lane 0 writes
// the warp's partial, __syncthreads, and every thread reads the partials
// (serially up to kSerialWarps warps, else one per lane and shuffles).  No
// barrier is needed before the write because the caller alternates two
// partial buffers (the max's and the sums'): a buffer is written again
// only after another exchange's barrier, which every thread reaches after
// its last read of it.  The same holds for the marks and the gather
// buffers (one per state leaf), written once per resample between the
// sums' barrier and the next one.
// Every barrier here is row_sync, which the instrumented kernels count.
//
// Systematic selection (the rules of the plain law in ops/_select.py):
//  - the inclusive CDF never falls: each lane's entries are raised to the
//    last entry of the lanes before it (the lane scan rounds otherwise
//    than a serial sum, which could put a lane's first entry an ulp below
//    its neighbour's last), and the warps' offsets chain serially, so
//    warp w + 1 starts at warp w's last entry;
//  - total = the CDF's last entry, u_j = min((j + u0) * (total / n),
//    total);
//  - ancestor_j = the first a with cdf[a] >= u_j.  No thread searches:
//    the CDF stays in registers, each particle counts the points at or
//    below its entry, c(a) (a guess, checked against two points), and
//    since the points never fall its offspring are the slots [c(a - 1),
//    c(a)); it marks the first of them and every warp's first slot among
//    them in shared memory, and after one barrier each thread scans its
//    own slots' marks and its warp's (systematic_marks, systematic_scan;
//    ops/_select.py systematic_ancestors_marks is their plain model).  On
//    a CDF that never falls this gives the binary search's ancestors.
#pragma once

namespace ssme {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// Shared index of gather entry j: one pad word after every 32, so the
// lanes of a warp reading entries kPer apart (each its own slots, or
// ancestors near them) hit 32 different banks instead of 32 / kPer.
// The gather buffers (and the roll selections' weights) are laid out so.
__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

// floats of a padded row array of n entries
__host__ __device__ constexpr int padded_size(int n) { return n + n / 32; }

// __syncthreads, counted: thread 0 adds one to *bars (a shared counter of
// the instrumented kernels; nullptr elsewhere, where it costs nothing)
__device__ __forceinline__ void row_sync(long long* bars) {
  __syncthreads();
  if (bars && threadIdx.x == 0) *bars += 1;
}

// up to this many warps each thread reads the partials serially (a short
// chain of broadcast reads); above it, lane u reads warp u's and the warp
// reduces with shuffles, so the reads do not grow with the warps
constexpr int kSerialWarps = 8;

// The row's max of v (every thread the same bits).  One barrier.
// part: shared float[32], the max's partial buffer; bars: row_sync's.
template <int kPer>
__device__ __forceinline__ float row_max(const float (&v)[kPer], bool active,
                                         float* part,
                                         long long* bars = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float m = v[0];
#pragma unroll
  for (int p = 1; p < kPer; ++p) m = fmaxf(m, v[p]);
  m = warp_max(active ? m : neg_inf());
  if (lane == 0) part[warp] = m;
  row_sync(bars);
  if (nw > kSerialWarps) return warp_max(lane < nw ? part[lane] : neg_inf());
  m = part[0];
  for (int u = 1; u < nw; ++u) m = fmaxf(m, part[u]);
  return m;
}

// The warp's inclusive CDF of w (the thread's kPer weights, 0 on an
// inactive lane), in place, before its raise: w[p] = the weights of the
// warp's earlier lanes plus the serial prefix of this lane's to p.  No
// barrier.
template <int kPer>
__device__ __forceinline__ void warp_cdf(float (&w)[kPer], bool active) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 1; p < kPer; ++p) w[p] = w[p - 1] + w[p];
  float incl = active ? w[kPer - 1] : 0.0f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(kFullMask, incl, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int p = 0; p < kPer; ++p) w[p] = excl + w[p];
}

// warp_cdf's entries raised to at least the last entry of every earlier
// lane, so the CDF never falls (the lane scan rounds otherwise than a
// serial sum).  Returns the warp's last entry (every lane).  No barrier.
template <int kPer>
__device__ __forceinline__ float warp_cdf_raise(float (&w)[kPer],
                                                bool active) {
  const int lane = threadIdx.x & 31;
  float top = active ? w[kPer - 1] : 0.0f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFullMask, top, o);
    if (lane >= o) top = fmaxf(top, y);
  }
  float below = __shfl_up_sync(kFullMask, top, 1);
  if (lane == 0) below = 0.0f;
#pragma unroll
  for (int p = 0; p < kPer; ++p) w[p] = fmaxf(w[p], below);
  return __shfl_sync(kFullMask, top, 31);
}

// The warp's last entry of warp_cdf's entries once raised, without the
// raise: the largest of the lanes' last entries (a max over nonnegative
// floats is the max of their bit patterns, one redux), the same bits as
// warp_cdf_raise returns.  For a kernel that raises only on a step that
// stages its CDF.  No barrier.
template <int kPer>
__device__ __forceinline__ float warp_cdf_total(const float (&w)[kPer],
                                                bool active) {
  return __uint_as_float(__reduce_max_sync(
      kFullMask, __float_as_uint(active ? w[kPer - 1] : 0.0f)));
}

// The row's K sums of the threads' folded v (every thread the same bits)
// and, with kScan, the offset of this warp's CDF (base: the serial sum of
// the earlier warps' last entries warp_last, in warp order) and the row's
// total, which is bit for bit the CDF's last entry.  One barrier.  part:
// shared float4[32], the sums' partial buffer (a warp's partials in one
// 16-byte word); bars: row_sync's.
template <int K, bool kScan>
__device__ __forceinline__ void row_sums(float (&v)[K], float warp_last,
                                         float4* part, float& base,
                                         float& total,
                                         long long* bars = nullptr) {
  static_assert(K + kScan <= 4, "one float4 of partials per warp");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float mine[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < K; ++k) mine[k] = warp_sum(v[k]);
  if constexpr (kScan) mine[K] = warp_last;
  if (lane == 0) part[warp] = make_float4(mine[0], mine[1], mine[2], mine[3]);
  row_sync(bars);
  if (nw > kSerialWarps) {
    const float4 q = lane < nw ? part[lane] : make_float4(0, 0, 0, 0);
    const float qs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = warp_sum(qs[k]);
    if constexpr (kScan) {
      const float* lasts = reinterpret_cast<const float*>(part) + K;
      float acc = 0.0f;
      for (int u = 0; u < nw; ++u) {
        if (u == warp) base = acc;
        acc = acc + lasts[4 * u];
      }
      total = acc;
    }
    return;
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int u = 0; u < nw; ++u) {
    const float4 q = part[u];
    if constexpr (kScan) {
      if (u == warp) base = acc[K];
    }
    acc[0] = acc[0] + q.x;
    acc[1] = acc[1] + q.y;
    acc[2] = acc[2] + q.z;
    acc[3] = acc[3] + q.w;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = acc[k];
  if constexpr (kScan) total = acc[K];
}

// floats a warp's partials take in row_sums_wide's buffer: K (+ 1 with
// the scan) rounded up to an odd number of float4 words, so that lanes
// reading the partials of neighbouring warps meet in no bank
__host__ __device__ constexpr int wide_stride(int k) {
  return 4 * (((k + 3) / 4) % 2 ? (k + 3) / 4 : (k + 3) / 4 + 1);
}

// row_sums for any number of sums: the row's K sums of the threads'
// folded v (every thread the same bits) and, with kScan, the warp's CDF
// offset and the row's total, as row_sums.  One barrier.  part: shared
// float4[32 * wide_stride(K + kScan) / 4], warp w's partials from float
// w * wide_stride(K + kScan), so a thread reads a warp's in
// wide_stride / 4 vector loads; v may be null at K = 0 (the scan alone).
// The caller alternates partial buffers as for row_sums.
template <int K, bool kScan>
__device__ __forceinline__ void row_sums_wide(float* v, float warp_last,
                                              float4* part, float& base,
                                              float& total,
                                              long long* bars = nullptr) {
  constexpr int kW = wide_stride(K + kScan) / 4;  // float4 words a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float mine[4 * kW];
#pragma unroll
  for (int k = 0; k < 4 * kW; ++k) mine[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) mine[k] = v[k] = warp_sum(v[k]);
  if constexpr (kScan) mine[K] = warp_last;
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kW; ++c)
      part[warp * kW + c] = make_float4(mine[4 * c], mine[4 * c + 1],
                                        mine[4 * c + 2], mine[4 * c + 3]);
  }
  row_sync(bars);
  const float* lasts = reinterpret_cast<const float*>(part) + K;
  if (nw > kSerialWarps) {
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const float4 q = lane < nw ? part[lane * kW + c]
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float qs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * c + e < K) v[4 * c + e] = warp_sum(qs[e]);
    }
    if constexpr (kScan) {
      float acc = 0.0f;
      for (int u = 0; u < nw; ++u) {
        if (u == warp) base = acc;
        acc = acc + lasts[4 * kW * u];
      }
      total = acc;
    }
    return;
  }
  float acc[4 * kW];
#pragma unroll
  for (int k = 0; k < 4 * kW; ++k) acc[k] = 0.0f;
  for (int u = 0; u < nw; ++u) {
    if constexpr (kScan) {
      if (u == warp) base = acc[K];
    }
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const float4 q = part[u * kW + c];
      acc[4 * c] = acc[4 * c] + q.x;
      acc[4 * c + 1] = acc[4 * c + 1] + q.y;
      acc[4 * c + 2] = acc[4 * c + 2] + q.z;
      acc[4 * c + 3] = acc[4 * c + 3] + q.w;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = acc[k];
  if constexpr (kScan) total = acc[K];
}

// this thread's kPer values of each of kLeaves state leaves to the row's
// padded shared arrays (leaf l's at buf + l * stride), so every leaf is
// staged before one barrier; the caller's next barrier publishes them
template <int kPer, int kLeaves>
__device__ __forceinline__ void row_stage(const float (&x)[kPer][kLeaves],
                                          bool active, float* buf,
                                          int stride) {
  if (!active) return;
  const int at = padded(kPer * threadIdx.x);  // kPer divides 32: contiguous
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
#pragma unroll
    for (int l = 0; l < kLeaves; ++l) buf[l * stride + at + p] = x[p][l];
  }
}

// one leaf
template <int kPer>
__device__ __forceinline__ void row_stage(const float (&x)[kPer], bool active,
                                          float* buf) {
  float v[kPer][1];
#pragma unroll
  for (int p = 0; p < kPer; ++p) v[p][0] = x[p];
  row_stage<kPer, 1>(v, active, buf, 0);
}

// A row's systematic points u_j = min((j + u0) * step, total), step =
// total / n, each evaluated in this float expression, which never falls
// as j rises; and the count c(e) = #{j : u_j <= e} of an entry e.  The
// guess and its check run on floats (a count below 2^24 is exact there,
// and float(c) - 1 is float(c - 1)) and without branches, so a thread's
// kPer + 1 counts overlap.
struct SystematicPoints {
  float u0, step, total, inv, nf;
  int n;
  __device__ __forceinline__ SystematicPoints(float u0_, float total_,
                                              int n_)
      : u0(u0_), step(total_ / static_cast<float>(n_)), total(total_),
        inv(static_cast<float>(n_) / total_), nf(static_cast<float>(n_)),
        n(n_) {}
  __device__ __forceinline__ float at(float j) const {
    return fminf((j + u0) * step, total);
  }
  // the first guess of c(e): floor(e n / total - u0) + 1 within [0, n],
  // each operation rounded apart (no fused multiply-add), so the plain
  // model's float32 arithmetic guesses alike
  __device__ __forceinline__ float guess(float e) const {
    const float g = floorf(__fsub_rn(__fmul_rn(e, inv), u0)) + 1.0f;
    return fminf(fmaxf(g, 0.0f), nf);
  }
  // whether g is c(e): the point before it lies at or below e, its own
  // above
  __device__ __forceinline__ bool exact(float e, float g) const {
    return ((g == 0.0f) | (at(g - 1.0f) <= e)) &
           ((g == nf) | !(at(g) <= e));
  }
  // c(e), walked from the guess c one point at a time
  __device__ __forceinline__ int fix(float e, int c) const {
    while (c > 0 && !(at(static_cast<float>(c - 1)) <= e)) --c;
    while (c < n && at(static_cast<float>(c)) <= e) ++c;
    return c;
  }
};

// thread i's kPer marks (marks[kPer i ..]) in one vector load, emptied
// behind it
template <int kPer>
__device__ __forceinline__ void take_marks(int* own, int (&m)[kPer]) {
  if constexpr (kPer % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      int4* const at = reinterpret_cast<int4*>(own) + q;
      const int4 v = *at;
      *at = make_int4(0, 0, 0, 0);
      m[4 * q] = v.x;
      m[4 * q + 1] = v.y;
      m[4 * q + 2] = v.z;
      m[4 * q + 3] = v.w;
    }
  } else if constexpr (kPer == 2) {
    int2* const at = reinterpret_cast<int2*>(own);
    const int2 v = *at;
    *at = make_int2(0, 0);
    m[0] = v.x;
    m[1] = v.y;
  } else {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      m[p] = own[p];
      own[p] = 0;
    }
  }
}

// The marks of a row start empty: each thread clears its own kPer slots
// (marks: int[kPer * blockDim], 16-byte aligned) before the row's first
// barrier
template <int kPer>
__device__ __forceinline__ void clear_marks(int* marks) {
#pragma unroll
  for (int p = 0; p < kPer; ++p) marks[kPer * threadIdx.x + p] = 0;
}

// Systematic selection without a search, step 1 of 2 (ops/_select.py
// systematic_ancestors_marks is its plain model), after the exchange that
// gives the warp's base and the row's total and before the barrier that
// publishes the marks.  The thread's CDF entries are e = base +
// cdf_local[p] (warp_cdf raised by warp_cdf_raise, the warps chained by
// row_sums; ops/_select.py kernel_cdf: it never falls), and the entry
// before its first is the previous lane's last (a shuffle) or, on lane 0,
// base, which is the previous warp's last entry bit for bit.  Since the
// points never fall, particle a's offspring are exactly the slots
// [c(a - 1), c(a)) (c(-1) = 0; c of the last entry is n): the slots j
// whose first entry at or above u_j is a, the binary search's ancestors.
// Each count starts from a guess and is checked against at most two
// points; a guess that misses is walked to the count (fixups counts them:
// the estimate's misses).  A particle with offspring writes its index at
// its first slot and at every warp's first slot (32 kPer w) inside its
// range, so each warp's first slot holds a mark and a particle writes at
// most 1 + n / (32 kPer) (a row whose weight sits on one particle: a few
// stores, not n); the marks array (int[n], 0 empty) is published by the
// caller's next barrier.  On a CDF that never falls no two particles
// mark one slot (a row whose weights hold a NaN may: which mark lands is
// then not fixed, and every ancestor still lies in [0, n)).  Returns the
// marks this thread wrote.
template <int kPer>
__device__ __forceinline__ int systematic_marks(
    const float (&cdf_local)[kPer], float base, float u0, float total, int n,
    bool active, int* marks, int& fixups) {
  const SystematicPoints pts(u0, total, n);
  float e[kPer + 1];  // the entry before the thread's first, then its own
#pragma unroll
  for (int p = 0; p < kPer; ++p) e[p + 1] = base + cdf_local[p];
  e[0] = __shfl_up_sync(kFullMask, e[kPer], 1);
  if ((threadIdx.x & 31) == 0) e[0] = base;
  int c[kPer + 1];
  bool exact = true;
#pragma unroll
  for (int k = 0; k <= kPer; ++k) {
    const float g = pts.guess(e[k]);
    exact &= pts.exact(e[k], g);
    c[k] = static_cast<int>(g);
  }
  if (!exact) {
#pragma unroll
    for (int k = 0; k <= kPer; ++k) {
      const int f = pts.fix(e[k], c[k]);
      fixups += k > 0 && f != c[k];
      c[k] = f;
    }
  }
  if (threadIdx.x == 0) c[0] = 0;
  constexpr unsigned kWarpSlots = 32 * kPer;
  int wrote = 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int lo = c[p], hi = c[p + 1];
    const int a = kPer * threadIdx.x + p;
    if (active && hi > lo) {
      marks[lo] = a;
      ++wrote;
    }
    for (int s = (static_cast<unsigned>(lo) / kWarpSlots + 1) * kWarpSlots;
         active && s < hi; s += kWarpSlots) {
      marks[s] = a;
      ++wrote;
    }
  }
  return wrote;
}

// Step 2 of 2, after the barrier that publishes the marks: this thread's
// kPer ancestors.  A running max over its own marks, then the running max
// of the nearest lane below it that holds a mark (a ballot), carried in:
// each warp's first slot holds a mark (particle 0's is 0, the empty
// value) and the marks rise with the slot, so each slot takes the
// greatest mark at or before it in its warp.  The thread's marks are
// emptied as they are read; the next write comes after later barriers.
template <int kPer>
__device__ __forceinline__ void systematic_scan(int* marks, bool active,
                                                int (&anc)[kPer]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < kPer; ++p) anc[p] = 0;
  if (active) take_marks<kPer>(marks + kPer * threadIdx.x, anc);
#pragma unroll
  for (int p = 1; p < kPer; ++p) anc[p] = max(anc[p], anc[p - 1]);
  const unsigned below = __ballot_sync(kFullMask, anc[kPer - 1] > 0) &
                         ((1u << lane) - 1u);
  const int from = __shfl_sync(kFullMask, anc[kPer - 1],
                               below ? 31 - __clz(below) : lane);
  const int carried = below ? from : 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p) anc[p] = max(anc[p], carried);
}

// The twins' record of the systematic selections: each warp's fix-ups
// and the most marks one of its threads wrote in a selection, kept by its
// lane 0 in part[2 w] and part[2 w + 1] (shared int[64]; no exchange
// across warps, and no register held, until the row's end).  Zeroed by
// clear_selections before the row's first barrier.
__device__ __forceinline__ void clear_selections(int* part) {
  if (threadIdx.x < 2 * (blockDim.x >> 5)) part[threadIdx.x] = 0;
}

__device__ __forceinline__ void note_selection(int* part, int fix,
                                               int wrote) {
  const int f = __reduce_add_sync(kFullMask, fix);
  const int m = __reduce_max_sync(kFullMask, wrote);
  if ((threadIdx.x & 31) == 0) {
    int* const own = part + 2 * (threadIdx.x >> 5);
    own[0] += f;
    own[1] = max(own[1], m);
  }
}

// at the row's end, every thread: the warps' records to thread 0's fixups
// (the row's sum) and most (the largest); one uncounted barrier
__device__ __forceinline__ void fold_selections(const int* part,
                                                long long& fixups,
                                                long long& most) {
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      fixups += part[2 * w];
      most = max(most, static_cast<long long>(part[2 * w + 1]));
    }
  }
}

// every leaf of x moved by the same ancestors through the staged buffers
// (leaf l's at buf + l * stride)
template <int kPer, int kLeaves>
__device__ __forceinline__ void row_gather(float (&x)[kPer][kLeaves],
                                           const int (&anc)[kPer],
                                           const float* buf, int stride) {
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int at = padded(anc[p]);
#pragma unroll
    for (int l = 0; l < kLeaves; ++l) x[p][l] = buf[l * stride + at];
  }
}

// every leaf of one particle from particle a's staged values (the roll
// selection hands a slot its ancestor as it comes, roll_select.cuh)
template <int kLeaves>
__device__ __forceinline__ void row_take(float (&x)[kLeaves], int a,
                                         const float* buf, int stride) {
  const int at = padded(a);
#pragma unroll
  for (int l = 0; l < kLeaves; ++l) x[l] = buf[l * stride + at];
}

// one leaf
template <int kPer>
__device__ __forceinline__ void row_gather(float (&x)[kPer],
                                           const int (&anc)[kPer],
                                           const float* buf) {
  float v[kPer][1];
  row_gather<kPer, 1>(v, anc, buf, 0);
#pragma unroll
  for (int p = 0; p < kPer; ++p) x[p] = v[p][0];
}

}  // namespace ssme
