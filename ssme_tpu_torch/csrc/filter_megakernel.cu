// The generic filter kernel's C entry point and its systematic instances
// (one particle per thread).  The kernel template, its layout and the step
// recursion are in filter_megakernel.cuh; the roll instances in
// filter_megakernel_roll{1,2,4}.cu.
#include "filter_megakernel.cuh"

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers the caller allocated; zs is null for a model without
// covariates, cloud and cloud_lw are null unless the final cloud is
// wanted (cloud: (kNumState, B, N), cloud_lw: (B, N)).  apf = 1 selects
// the APF mode.  resampler: 0 systematic (N a multiple of 32 up to 1024),
// 1 metropolis with metropolis_iters sweeps or 2 rejection (N a power of
// two in [32, 4096]).  The kernel allocates nothing and runs on `stream`.
// Returns cudaGetLastError() after the launch, -1 for an unknown model id,
// -2 for APF mode on a model without a lookahead or -3 for a particle
// count the resampler does not take.
extern "C" int ssme_filter_megakernel(int model_id, int apf,
                                      const int64_t* seed,
                                      const float* params, const float* ys,
                                      const float* zs, int num_rows,
                                      int num_steps, int num_particles,
                                      float ess_limit, int always,
                                      int gate_stride, int resampler,
                                      int metropolis_iters, float* total,
                                      float* lcl, float* fmean, float* cloud,
                                      float* cloud_lw, void* stream) {
  using namespace ssme_fmk;
  const Launch a{seed, params, ys, zs, num_rows, num_steps, num_particles,
                 ess_limit, always, gate_stride, resampler,
                 metropolis_iters, total, lcl, fmean, cloud, cloud_lw,
                 static_cast<cudaStream_t>(stream)};
  if (resampler == ssme::kResampleSystematic) {
    if (num_particles > kMaxThreads) return -3;
    return dispatch_model<false, 1>(model_id, apf, a);
  }
  switch (num_particles > kMaxThreads ? num_particles / kMaxThreads : 1) {
    case 1:
      return dispatch_roll1(model_id, apf, a);
    case 2:
      return dispatch_roll2(model_id, apf, a);
    case 4:
      return dispatch_roll4(model_id, apf, a);
    default:
      return -3;
  }
}
