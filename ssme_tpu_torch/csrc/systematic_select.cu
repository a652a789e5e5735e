// Standalone launch of the systematic selection device code that the SVOL
// filter kernel inlines (systematic_select.cuh), so the card can check
// the selection law against the plain PyTorch version on identical
// inputs.  Replaces ssme_tpu/ops/_select.py::select_leaves_dense.
//
// One CTA per row, one slot per thread; every leaf moves by the same
// ancestors.  Bound by barrier latency like the filter's resample step.
#include <cstdint>

#include <cuda_runtime.h>

#include "systematic_select.cuh"

namespace {

constexpr int kMaxParticles = 1024;

__global__ void __launch_bounds__(kMaxParticles, 1)
systematic_select_kernel(const float* __restrict__ w,
                         const float* __restrict__ leaves,
                         const float* __restrict__ u0, int num_leaves,
                         int num_rows, float* __restrict__ picked,
                         int32_t* __restrict__ ancestors) {
  __shared__ float cdf[kMaxParticles];
  __shared__ float buf[kMaxParticles];
  __shared__ float red[3 * 32];

  const int b = blockIdx.x;
  const int n = blockDim.x;
  const size_t slot = static_cast<size_t>(b) * n + threadIdx.x;
  const int anc = ssme::systematic_ancestor(w[slot], u0[b], cdf, red);
  ancestors[slot] = anc;
  for (int l = 0; l < num_leaves; ++l) {
    const size_t at = static_cast<size_t>(l) * num_rows * n + slot;
    picked[at] = ssme::gather_from(leaves[at], anc, buf);
  }
}

}  // namespace

extern "C" int ssme_systematic_select(const float* w, const float* leaves,
                                      const float* u0, int num_leaves,
                                      int num_rows, int num_particles,
                                      float* picked, int32_t* ancestors,
                                      void* stream) {
  systematic_select_kernel<<<num_rows, num_particles, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      w, leaves, u0, num_leaves, num_rows, picked, ancestors);
  return static_cast<int>(cudaGetLastError());
}
