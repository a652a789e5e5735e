// Block-wide reductions, scan and systematic ancestor selection for one
// CTA per filter row and one particle per thread (blockDim.x = N, a
// multiple of 32, at most 1024): the standalone systematic_select's at
// kper 1; the roll families' kernels take only the block reductions (the
// systematic families of the SVOL, generic and Liu-West filter kernels,
// kPer particles per thread, are on row_select.cuh).  Replaces
// select_leaves_dense of ssme_tpu/ops/_select.py.
//
// The TPU builds the CDF and the gather as dense (n, n) one-hot matmuls
// because its lanes cannot gather.  Here a float32 block scan writes the
// inclusive CDF to shared memory, each thread binary-searches its own
// point, and values are gathered from shared memory.  The rules of the
// TPU version are kept:
//  - the exclusive CDF is the neighbour of the same rounded array
//    (cdf[i-1], cdf_ex[0] = 0): the search for the first i with
//    cdf[i] >= u is exactly the half-open test cdf_ex < u <= cdf;
//  - u_j = min((j + u0) * (total / N), total): rounding can push the last
//    point past the total, which would select nothing;
//  - u0 must lie in (0, 1) (philox.cuh uniform_offset).
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

// Every warp reduces the per-warp partials itself, so all threads return
// the same bits without a second barrier.  red: shared float[32] for a
// max, float[32 * K] for K sums.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_max(lane < nw ? red[lane] : __int_as_float(0xff800000));
}

// K sums at once (red: shared float[32 * K]); every thread returns them
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[32 * k + warp] = v[k];
  }
  __syncthreads();
  const bool in = lane < nw;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(in ? red[32 * k + lane] : 0.0f);
}

__device__ __forceinline__ float3 block_sum3(float a, float b, float c,
                                             float* red) {
  float v[3] = {a, b, c};
  block_sum<3>(v, red);
  return make_float3(v[0], v[1], v[2]);
}

// inclusive scan of one value per thread into cdf[0 .. blockDim.x)
__device__ __forceinline__ void block_inclusive_scan(float v, float* cdf,
                                                     float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFullMask, v, o);
    if (lane >= o) v += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nw ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFullMask, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) red[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += red[warp - 1];
  cdf[threadIdx.x] = v;
  __syncthreads();
}

// ancestor of output slot j = threadIdx.x under weights w (one per thread)
__device__ __forceinline__ int systematic_ancestor(float w, float u0,
                                                   float* cdf, float* red) {
  block_inclusive_scan(w, cdf, red);
  const int n = blockDim.x;
  const float total = cdf[n - 1];
  const float u = fminf((static_cast<float>(threadIdx.x) + u0) *
                            (total / static_cast<float>(n)),
                        total);
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] < u) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// value of thread `anc` (one value per thread); buf must not alias cdf,
// which slower threads may still be searching
__device__ __forceinline__ float gather_from(float v, int anc, float* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  const float r = buf[anc];
  __syncthreads();
  return r;
}

// every leaf of a particle's state moved by the same ancestor, through
// one shared buffer reused leaf by leaf (kNumLeaves is a compile-time
// count, so the leaves stay in registers)
template <int kNumLeaves>
__device__ __forceinline__ void gather_leaves(float (&v)[kNumLeaves],
                                              int anc, float* buf) {
#pragma unroll
  for (int l = 0; l < kNumLeaves; ++l) v[l] = gather_from(v[l], anc, buf);
}

}  // namespace ssme
