// The generic filter kernel's C entry points.  The systematic family is in
// filter_megakernel_sys.cuh (instances in filter_megakernel_sys{2,4}.cu),
// the roll family, the launch arguments and the step recursion in
// filter_megakernel.cuh (instances in filter_megakernel_roll{1,2,4}.cu).
#include "filter_megakernel_sys.cuh"

namespace {

// the systematic instance of kper_for(N); spans: the instrumented twin's
// record, or null; -3 for a particle count it does not take
int dispatch_systematic(int model_id, int apf, const ssme_fmk::Launch& a,
                        long long* spans) {
  using namespace ssme_fmk;
  const int n = a.num_particles;
  if (n < 32 || n > kMaxThreads || n % 32) return -3;
  return kper_for(n) == 2 ? dispatch_sys2(model_id, apf, a, spans)
                          : dispatch_sys4(model_id, apf, a, spans);
}

}  // namespace

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
  if (resampler == ssme::kResampleSystematic)
    return dispatch_systematic(model_id, apf, a, nullptr);
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

// The systematic family's instrumented twin of the svol_leverage functor
// (filter_megakernel_sys.cuh SysSpan): the same arguments, no cloud, and
// spans int64[num_rows * kNumSysSpans] for its record.
extern "C" int ssme_filter_megakernel_spans(int apf, const int64_t* seed,
                                            const float* params,
                                            const float* ys, const float* zs,
                                            int num_rows, int num_steps,
                                            int num_particles,
                                            float ess_limit, int always,
                                            int gate_stride, float* total,
                                            float* lcl, float* fmean,
                                            long long* spans, void* stream) {
  using namespace ssme_fmk;
  const Launch a{seed, params, ys, zs, num_rows, num_steps, num_particles,
                 ess_limit, always, gate_stride, ssme::kResampleSystematic,
                 16, total, lcl, fmean, nullptr, nullptr,
                 static_cast<cudaStream_t>(stream)};
  return dispatch_systematic(ssme::kModelSvolLeverage, apf, a, spans);
}
