// Standalone launch of the systematic selection device code that the
// filter kernels inline, so the card can check it against the plain
// PyTorch version on identical inputs.  Replaces
// ssme_tpu/ops/_select.py::select_leaves_dense.
//
// One CTA per row, kPer = 2, 4 or 8 neighbouring slots per thread, the
// layout of every filter kernel's systematic family (blockDim = N / kPer
// rounded up to a warp), their CDF, counts, marks, scan and padded gather
// buffer from row_select.cuh.  Every leaf moves by the same ancestors;
// the CDF the ancestors were found on (each thread's entries, from its
// registers) can be written out.  Bound by barrier latency like the
// filters' resample step.
#include <cstdint>

#include <cuda_runtime.h>

#include "row_select.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxParticles = 4096;

template <int kPer>
__global__ void __launch_bounds__(kMaxThreads, 1)
row_select_kernel(const float* __restrict__ w,
                  const float* __restrict__ leaves,
                  const float* __restrict__ u0, int num_leaves,
                  int num_rows, int n, float* __restrict__ picked,
                  int32_t* __restrict__ ancestors,
                  float* __restrict__ cdf_out) {
  __shared__ __align__(16) int marks[kMaxParticles];
  __shared__ float buf[ssme::padded_size(kMaxParticles)];
  __shared__ float4 sum_part[32];

  const int j0 = kPer * threadIdx.x;
  const bool active = j0 < n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const size_t plane = static_cast<size_t>(num_rows) * n;
  float wv[kPer], x[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    wv[p] = active ? w[row + j0 + p] : 0.0f;
    x[p] = active ? leaves[row + j0 + p] : 0.0f;
  }
  ssme::clear_marks<kPer>(marks);
  ssme::warp_cdf<kPer>(wv, active);
  const float warp_last = ssme::warp_cdf_raise<kPer>(wv, active);
  float sum[1] = {0.0f};
  float base = 0.0f, total = 0.0f;
  ssme::row_sums<1, true>(sum, warp_last, sum_part, base, total);
  int fixups = 0;
  ssme::systematic_marks<kPer>(wv, base, u0[blockIdx.x], total, n, active,
                               marks, fixups);
  ssme::row_stage<kPer>(x, active, buf);
  __syncthreads();
  int anc[kPer];
  ssme::systematic_scan<kPer>(marks, active, anc);
  for (int l = 0; l < num_leaves; ++l) {
    if (l > 0) {
      __syncthreads();  // every read of the previous leaf is done
      if (active) {
#pragma unroll
        for (int p = 0; p < kPer; ++p)
          buf[ssme::padded(j0 + p)] = leaves[l * plane + row + j0 + p];
      }
      __syncthreads();
    }
    ssme::row_gather<kPer>(x, anc, buf);
    if (active) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) picked[l * plane + row + j0 + p] = x[p];
    }
  }
  if (!active) return;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    ancestors[row + j0 + p] = anc[p];
    if (cdf_out) cdf_out[row + j0 + p] = base + wv[p];
  }
}

template <int kPer>
void launch_row(const float* w, const float* leaves, const float* u0,
                int num_leaves, int num_rows, int n, int threads,
                float* picked, int32_t* ancestors, float* cdf_out,
                cudaStream_t stream) {
  row_select_kernel<kPer><<<num_rows, threads, 0, stream>>>(
      w, leaves, u0, num_leaves, num_rows, n, picked, ancestors, cdf_out);
}

}  // namespace

// kper: 2, 4 or 8 (N a multiple of 32 up to 1024 or of 128 up to 4096, at
// most 1024 threads).  cdf_out: null, or float[B * N] for the
// inclusive CDF.  -3 for a shape it does not take.
extern "C" int ssme_systematic_select(const float* w, const float* leaves,
                                      const float* u0, int num_leaves,
                                      int num_rows, int num_particles,
                                      int kper, float* picked,
                                      int32_t* ancestors, float* cdf_out,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = num_particles;
  if (n < 32 || n % 32 || n > kMaxParticles || (n > kMaxThreads && n % 128))
    return -3;
  const int threads = kper > 0 ? (n / kper + 31) / 32 * 32 : 0;
  if (threads < 32 || threads > kMaxThreads) return -3;
  switch (kper) {
    case 2:
      launch_row<2>(w, leaves, u0, num_leaves, num_rows, n, threads, picked,
                    ancestors, cdf_out, s);
      break;
    case 4:
      launch_row<4>(w, leaves, u0, num_leaves, num_rows, n, threads, picked,
                    ancestors, cdf_out, s);
      break;
    case 8:
      launch_row<8>(w, leaves, u0, num_leaves, num_rows, n, threads, picked,
                    ancestors, cdf_out, s);
      break;
    default:
      return -3;
  }
  return static_cast<int>(cudaGetLastError());
}
