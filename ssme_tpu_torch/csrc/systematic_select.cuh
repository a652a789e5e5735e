// Warp and block reductions for one CTA per filter row, and the one-leaf
// and multi-leaf gathers of one particle per thread: the roll families of
// the SVOL and Liu-West kernels take them (the systematic families and the
// generic kernel's roll family, kPer neighbouring particles per thread,
// are on row_select.cuh, which builds on the warp reductions here).
// Every warp reduces the per-warp partials itself, so all threads return
// the same bits without a second barrier.
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

// red: shared float[32] for a max, float[32 * K] for K sums.
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

// value of thread `anc` (one value per thread); buf must not alias the
// weights a selection may still be reading
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
