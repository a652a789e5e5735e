// Standalone launch of the systematic selection device code that the SVOL
// filter kernel inlines (systematic_select.cuh), so the card can check
// the selection law against the plain PyTorch version on identical
// inputs.  Replaces ssme_tpu/ops/_select.py::select_leaves_dense.
//
// One CTA per row and kPer slots per thread, as in the SVOL kernel: one up
// to 1024 particles, then 2 up to 2048 and 4 up to 4096 (slot j = p *
// blockDim + threadIdx.x); every leaf moves by the same ancestors.  Bound
// by barrier latency like the filter's resample step.
#include <cstdint>

#include <cuda_runtime.h>

#include "roll_select.cuh"
#include "systematic_select.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <int kPer>
__global__ void __launch_bounds__(kMaxThreads, 1)
systematic_select_kernel(const float* __restrict__ w,
                         const float* __restrict__ leaves,
                         const float* __restrict__ u0, int num_leaves,
                         int num_rows, float* __restrict__ picked,
                         int32_t* __restrict__ ancestors) {
  __shared__ float cdf[kMaxThreads * kPer];
  __shared__ float buf[kMaxThreads * kPer];
  __shared__ float red[3 * 32];

  const int b = blockIdx.x;
  const int bd = blockDim.x;
  const size_t row = static_cast<size_t>(b) * bd * kPer;
  float wv[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) wv[p] = w[row + p * bd + threadIdx.x];
  int anc[kPer];
  ssme::systematic_ancestors_per<kPer>(wv, u0[b], cdf, red, anc);
#pragma unroll
  for (int p = 0; p < kPer; ++p)
    ancestors[row + p * bd + threadIdx.x] = anc[p];
  for (int l = 0; l < num_leaves; ++l) {
    const size_t at = static_cast<size_t>(l) * num_rows * bd * kPer + row;
    float v[kPer][1];
#pragma unroll
    for (int p = 0; p < kPer; ++p) v[p][0] = leaves[at + p * bd + threadIdx.x];
    ssme::gather_leaves_per<1, kPer>(v, anc, buf);
#pragma unroll
    for (int p = 0; p < kPer; ++p) picked[at + p * bd + threadIdx.x] = v[p][0];
  }
}

template <int kPer>
void launch(const float* w, const float* leaves, const float* u0,
            int num_leaves, int num_rows, int num_particles, float* picked,
            int32_t* ancestors, cudaStream_t stream) {
  systematic_select_kernel<kPer><<<num_rows, num_particles / kPer, 0,
                                   stream>>>(w, leaves, u0, num_leaves,
                                             num_rows, picked, ancestors);
}

}  // namespace

// -3 for a particle count it does not take (a multiple of 32 up to 1024,
// of 128 up to 4096)
extern "C" int ssme_systematic_select(const float* w, const float* leaves,
                                      const float* u0, int num_leaves,
                                      int num_rows, int num_particles,
                                      float* picked, int32_t* ancestors,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kper = num_particles <= kMaxThreads       ? 1
                   : num_particles <= 2 * kMaxThreads ? 2
                                                      : 4;
  if (num_particles > 4 * kMaxThreads || num_particles % (32 * kper))
    return -3;
  switch (kper) {
    case 1:
      launch<1>(w, leaves, u0, num_leaves, num_rows, num_particles, picked,
                ancestors, s);
      break;
    case 2:
      launch<2>(w, leaves, u0, num_leaves, num_rows, num_particles, picked,
                ancestors, s);
      break;
    default:
      launch<4>(w, leaves, u0, num_leaves, num_rows, num_particles, picked,
                ancestors, s);
  }
  return static_cast<int>(cudaGetLastError());
}
