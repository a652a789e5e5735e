// Block primitives for one CTA per filter row with kPer NEIGHBOURING
// particles per thread: particle j = kPer * threadIdx.x + p, p < kPer.
// blockDim.x is a multiple of 32; the first `active` threads hold the n
// particles, and the lanes after them (a partial last warp) hold none and
// are masked out of every reduction.  Every family of the SVOL filter
// kernel (svol_filter_sys.cu), the generic filter kernel
// (filter_megakernel_sys.cuh) and the Liu-West kernel
// (lw_megakernel_sys.cuh) runs these exchanges; the systematic ones stage,
// walk and gather here (replacing select_leaves_dense of
// ssme_tpu/ops/_select.py), the roll ones select in roll_select.cuh.
//
// Exchanges.  A thread first folds its kPer values in registers, a warp
// reduces with shuffles, and the warps meet at ONE barrier: lane 0 writes
// the warp's partial, __syncthreads, and every thread reads the partials
// (serially up to kSerialWarps warps, else one per lane and shuffles).  No
// barrier is needed before the write because the caller alternates two
// partial buffers (the max's and the sums'): a buffer is written again
// only after another exchange's barrier, which every thread reaches after
// its last read of it.  The same holds for the CDF and the gather buffers
// (one per state leaf), written once per resample between the sums'
// barrier and the walk's.
// Every barrier here is row_sync, which the instrumented kernels count.
//
// Systematic selection (the rules of the plain law in ops/_select.py):
//  - the inclusive CDF is written to shared memory and never falls: each
//    lane's entries are raised to the last entry of the lanes before it
//    (the lane scan rounds otherwise than a serial sum, which could put a
//    lane's first entry an ulp below its neighbour's last), and the warps'
//    offsets chain serially, so warp w + 1 starts at warp w's last entry;
//  - total = cdf[n - 1], u_j = min((j + u0) * (total / n), total);
//  - ancestor_j = the first a with cdf[a] >= u_j (predicate cdf[a] < u).
//    Each thread binary-searches its first slot and walks forward over
//    the next kPer - 1, whose points rise; the walk gallops (steps 1, 2,
//    4, ... then a binary search in the last step), so a run of
//    zero-weight particles costs log steps, and it does not move when the
//    row's weight sits on one particle.  On a CDF that never falls this
//    gives the binary search's ancestors (ops/_select.py
//    systematic_ancestors_walk is its plain model).
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

// Shared index of CDF or gather entry j: one pad word after every 32, so
// the lanes of a warp reading entries kPer apart (each its own slots, or
// ancestors near them) hit 32 different banks instead of 32 / kPer.
// The CDF and the gather buffer are laid out so.
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

// this thread's CDF entries (warp_cdf's, raised by warp_cdf_raise, plus
// the warp's base) and its kPer values of each of kLeaves state leaves to
// the row's padded shared arrays (leaf l's at buf + l * stride), so every
// leaf is staged before one barrier; the caller's next barrier publishes
// them
template <int kPer, int kLeaves>
__device__ __forceinline__ void row_stage(const float (&cdf_local)[kPer],
                                          float base,
                                          const float (&x)[kPer][kLeaves],
                                          bool active, float* cdf, float* buf,
                                          int stride) {
  if (!active) return;
  const int at = padded(kPer * threadIdx.x);  // kPer divides 32: contiguous
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    cdf[at + p] = base + cdf_local[p];
#pragma unroll
    for (int l = 0; l < kLeaves; ++l) buf[l * stride + at + p] = x[p][l];
  }
}

// one leaf
template <int kPer>
__device__ __forceinline__ void row_stage(const float (&cdf_local)[kPer],
                                          float base,
                                          const float (&x)[kPer], bool active,
                                          float* cdf, float* buf) {
  float v[kPer][1];
#pragma unroll
  for (int p = 0; p < kPer; ++p) v[p][0] = x[p];
  row_stage<kPer, 1>(cdf_local, base, v, active, cdf, buf, 0);
}

// the first a in [lo, hi] with cdf[a] >= u, given cdf[hi] >= u
__device__ __forceinline__ int cdf_lower_bound(const float* cdf, int lo,
                                               int hi, float u) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[padded(mid)] < u) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Ancestors of this thread's slots j = kPer * threadIdx.x + p on the
// published CDF of n entries (total = cdf[n - 1]) with offset u0: one
// search, then the galloping walk.
template <int kPer>
__device__ __forceinline__ void systematic_walk(float u0, float total, int n,
                                                const float* cdf,
                                                int (&anc)[kPer]) {
  const float step = total / static_cast<float>(n);
  const int j0 = kPer * threadIdx.x;
  int a = cdf_lower_bound(
      cdf, 0, n - 1, fminf((static_cast<float>(j0) + u0) * step, total));
  anc[0] = a;
#pragma unroll
  for (int p = 1; p < kPer; ++p) {
    const float u = fminf((static_cast<float>(j0 + p) + u0) * step, total);
    if (cdf[padded(a)] < u) {
      int lo = a + 1, span = 1;
      while (lo + span - 1 < n - 1 && cdf[padded(lo + span - 1)] < u) {
        lo += span;
        span <<= 1;
      }
      a = cdf_lower_bound(cdf, lo, min(lo + span - 1, n - 1), u);
    }
    anc[p] = a;
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
