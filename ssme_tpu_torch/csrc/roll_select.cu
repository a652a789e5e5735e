// Standalone launch of the roll-based Metropolis and rejection selection
// that the filter kernels inline (roll_select.cuh), so the card can check
// the selection law against the plain PyTorch version on identical
// inputs.  Replaces ssme_tpu/ops/_select.py::metropolis_select_leaves and
// rejection_select_leaves.
//
// One CTA per row, kPer = N / 1024 slots per thread above 1024 particles
// (else one); every leaf moves by the same ancestors.  Bound by the sweep
// loop's Philox draws and, for rejection, one block barrier per sweep.
#include <cstdint>

#include <cuda_runtime.h>

#include "roll_select.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <int kPer>
__global__ void __launch_bounds__(kMaxThreads, 1)
roll_select_kernel(const float* __restrict__ w,
                   const float* __restrict__ leaves,
                   const int64_t* __restrict__ seed, uint32_t step,
                   uint32_t tag, int resampler, int metropolis_iters,
                   int num_leaves, int num_rows, float* __restrict__ picked,
                   int32_t* __restrict__ ancestors) {
  __shared__ float wsh[kMaxThreads * kPer];
  __shared__ float buf[kMaxThreads * kPer];
  __shared__ float red[32];

  const uint32_t b = blockIdx.x;
  const int bd = blockDim.x;
  const size_t n = static_cast<size_t>(bd) * kPer;
  const size_t row = static_cast<size_t>(b) * n;
  float wv[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) wv[p] = w[row + p * bd + threadIdx.x];
  int anc[kPer];
  ssme::roll_ancestors<kPer>(resampler, metropolis_iters, wv, wsh, red,
                             static_cast<uint32_t>(seed[0]),
                             static_cast<uint32_t>(seed[1]), step, b, tag,
                             anc);
#pragma unroll
  for (int p = 0; p < kPer; ++p) ancestors[row + p * bd + threadIdx.x] = anc[p];
  for (int l = 0; l < num_leaves; ++l) {
    const size_t at = static_cast<size_t>(l) * num_rows * n + row;
    float v[kPer][1];
#pragma unroll
    for (int p = 0; p < kPer; ++p) v[p][0] = leaves[at + p * bd + threadIdx.x];
    ssme::gather_leaves_per<1, kPer>(v, anc, buf);
#pragma unroll
    for (int p = 0; p < kPer; ++p) picked[at + p * bd + threadIdx.x] = v[p][0];
  }
}

template <int kPer>
void launch(const float* w, const float* leaves, const int64_t* seed,
            uint32_t step, uint32_t tag, int resampler, int iters,
            int num_leaves, int num_rows, int num_particles, float* picked,
            int32_t* ancestors, cudaStream_t stream) {
  roll_select_kernel<kPer><<<num_rows, num_particles / kPer, 0, stream>>>(
      w, leaves, seed, step, tag, resampler, iters, num_leaves, num_rows,
      picked, ancestors);
}

}  // namespace

// Plain C entry point (bound with ctypes).  w (B, N), leaves (L, B, N),
// picked (L, B, N) and ancestors (B, N) are device arrays the caller
// allocated; seed is the (2,) int64 Philox key on the device; step and
// tag are the counter words of the draws (tag = kTagRollSweep or
// kTagRollSelect); resampler is kResampleMetropolis or
// kResampleRejection; N is a power of two in [32, 4096].  Returns
// cudaGetLastError() after the launch, or -1 for an unsupported N.
extern "C" int ssme_roll_select(const float* w, const float* leaves,
                                const int64_t* seed, unsigned step,
                                unsigned tag, int resampler, int iters,
                                int num_leaves, int num_rows,
                                int num_particles, float* picked,
                                int32_t* ancestors, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_particles > kMaxThreads ? num_particles / kMaxThreads : 1) {
    case 1:
      launch<1>(w, leaves, seed, step, tag, resampler, iters, num_leaves,
                num_rows, num_particles, picked, ancestors, s);
      break;
    case 2:
      launch<2>(w, leaves, seed, step, tag, resampler, iters, num_leaves,
                num_rows, num_particles, picked, ancestors, s);
      break;
    case 4:
      launch<4>(w, leaves, seed, step, tag, resampler, iters, num_leaves,
                num_rows, num_particles, picked, ancestors, s);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
