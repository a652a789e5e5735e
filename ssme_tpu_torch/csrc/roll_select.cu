// Standalone launch of the roll-based Metropolis and rejection selection
// that the filter kernels inline (roll_select.cuh), so the card can check
// the selection law against the plain PyTorch version on identical
// inputs.  Replaces ssme_tpu/ops/_select.py::metropolis_select_leaves and
// rejection_select_leaves.
//
// One CTA per row in the generic filter kernel's layout
// (filter_megakernel_sys.cuh): kPer neighbouring slots per thread, kPer
// as that kernel's kper_for (2 up to 512 particles, then N / 256), at
// most 256 threads; the weights and one gather buffer on padded indices
// (row_select.cuh); every leaf moves by the same ancestors, through the
// buffer leaf by leaf.  Bound by the pending slots' Philox calls, as the
// filters' roll resamples are.
#include <cstdint>

#include <cuda_runtime.h>

#include "roll_select.cuh"

namespace {

constexpr int kMaxParticles = 4096;
constexpr int kThreads = 256;

template <int kPer>
__global__ void __launch_bounds__(kThreads, 2)
roll_select_kernel(const float* __restrict__ w,
                   const float* __restrict__ leaves,
                   const int64_t* __restrict__ seed, uint32_t step,
                   uint32_t tag, int resampler, int metropolis_iters,
                   int num_leaves, int num_rows, int n,
                   float* __restrict__ picked,
                   int32_t* __restrict__ ancestors) {
  __shared__ float wsh[ssme::padded_size(kMaxParticles)];
  __shared__ float buf[ssme::padded_size(kMaxParticles)];
  __shared__ float max_part[32];

  const int j0 = kPer * threadIdx.x;
  const bool active = j0 < n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const size_t plane = static_cast<size_t>(num_rows) * n;
  float wv[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    wv[p] = active ? w[row + j0 + p] : 0.0f;
    if (active) wsh[ssme::padded(j0 + p)] = wv[p];
  }
  float w_max = 0.0f;
  if (resampler == ssme::kResampleRejection)
    w_max = ssme::row_max<kPer>(wv, active, max_part);  // publishes wsh
  else
    __syncthreads();
  int anc[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) anc[p] = j0 + p;
  ssme::roll_select<kPer, ssme::NeighbourSlots<kPer>>(
      resampler, metropolis_iters, active, wsh, w_max, n,
      static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(seed[1]), step,
      blockIdx.x, tag, [&](int p, int a) {
#pragma unroll
        for (int q = 0; q < kPer; ++q)  // p may be a run-time index
          if (q == p) anc[q] = a;
      });
  for (int l = 0; l < num_leaves; ++l) {
    if (l > 0) __syncthreads();  // every read of the previous leaf is done
    if (active) {
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        buf[ssme::padded(j0 + p)] = leaves[l * plane + row + j0 + p];
    }
    __syncthreads();
    float x[kPer];
    ssme::row_gather<kPer>(x, anc, buf);
    if (active) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) picked[l * plane + row + j0 + p] = x[p];
    }
  }
  if (!active) return;
#pragma unroll
  for (int p = 0; p < kPer; ++p) ancestors[row + j0 + p] = anc[p];
}

template <int kPer>
void launch(const float* w, const float* leaves, const int64_t* seed,
            uint32_t step, uint32_t tag, int resampler, int iters,
            int num_leaves, int num_rows, int n, float* picked,
            int32_t* ancestors, cudaStream_t stream) {
  const int threads = (n / kPer + 31) / 32 * 32;
  roll_select_kernel<kPer><<<num_rows, threads, 0, stream>>>(
      w, leaves, seed, step, tag, resampler, iters, num_leaves, num_rows, n,
      picked, ancestors);
}

}  // namespace

// Plain C entry point (bound with ctypes).  w (B, N), leaves (L, B, N),
// picked (L, B, N) and ancestors (B, N) are device arrays the caller
// allocated; seed is the (2,) int64 Philox key on the device; step and
// tag are the counter words of the draws (tag = kTagRollSweep or
// kTagRollSelect); resampler is kResampleMetropolis or
// kResampleRejection; N is a power of two in [32, 4096].  Returns
// cudaGetLastError() after the launch, or -3 for an unsupported N.
extern "C" int ssme_roll_select(const float* w, const float* leaves,
                                const int64_t* seed, unsigned step,
                                unsigned tag, int resampler, int iters,
                                int num_leaves, int num_rows,
                                int num_particles, float* picked,
                                int32_t* ancestors, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = num_particles;
  if (n < 32 || n > kMaxParticles || (n & (n - 1))) return -3;
  switch (n <= 2 * kThreads ? 2 : n / kThreads) {
    case 2:
      launch<2>(w, leaves, seed, step, tag, resampler, iters, num_leaves,
                num_rows, n, picked, ancestors, s);
      break;
    case 4:
      launch<4>(w, leaves, seed, step, tag, resampler, iters, num_leaves,
                num_rows, n, picked, ancestors, s);
      break;
    case 8:
      launch<8>(w, leaves, seed, step, tag, resampler, iters, num_leaves,
                num_rows, n, picked, ancestors, s);
      break;
    default:
      launch<16>(w, leaves, seed, step, tag, resampler, iters, num_leaves,
                 num_rows, n, picked, ancestors, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
