// The generic filter kernel's C entry points.  Both selection families run
// the template of filter_megakernel_sys.cuh, instances in
// filter_megakernel_sys{2,4}.cu (systematic) and
// filter_megakernel_sys_roll{2,4,8,16}.cu (the roll resamplers); the
// launch arguments and the step recursion are in filter_megakernel.cuh.
#include "filter_megakernel_sys.cuh"

namespace {

// the instance of kper_for(N) in the resampler's family; spans, sweeps and
// ratio: the instrumented twin's records, or null; -3 for a particle count
// the resampler does not take
int dispatch(int model_id, int apf, const ssme_fmk::Launch& a,
             long long* spans, int* sweeps, float* ratio) {
  using namespace ssme_fmk;
  const int n = a.num_particles;
  if (a.resampler == ssme::kResampleSystematic) {
    if (n < 32 || n > kMaxSysParticles || n % 32) return -3;
    return kper_for(n) == 2
               ? dispatch_sys2(model_id, apf, a, spans, sweeps, ratio)
               : dispatch_sys4(model_id, apf, a, spans, sweeps, ratio);
  }
  if (n < 32 || n > kMaxRollParticles || (n & (n - 1))) return -3;
  switch (kper_for(n)) {
    case 2:
      return dispatch_roll2(model_id, apf, a, spans, sweeps, ratio);
    case 4:
      return dispatch_roll4(model_id, apf, a, spans, sweeps, ratio);
    case 8:
      return dispatch_roll8(model_id, apf, a, spans, sweeps, ratio);
    default:
      return dispatch_roll16(model_id, apf, a, spans, sweeps, ratio);
  }
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
  const ssme_fmk::Launch a{seed, params, ys, zs, num_rows, num_steps,
                           num_particles, ess_limit, always, gate_stride,
                           resampler, metropolis_iters, total, lcl, fmean,
                           cloud, cloud_lw,
                           static_cast<cudaStream_t>(stream)};
  return dispatch(model_id, apf, a, nullptr, nullptr, nullptr);
}

// The instrumented twins (filter_megakernel_sys.cuh SysSpan): svol_leverage
// (model id 1) in both modes under every resampler, svol (model id 0) in
// bootstrap mode under the roll resamplers.  The same arguments, no
// cloud; spans int64[num_rows * kNumSysSpans] for the record and, under a
// roll resampler, sweeps int32[num_rows * num_steps] and ratio
// float[num_rows * num_steps] (each or null) for each selection's sweeps
// and max / mean weight.  -1 for another functor or mode.
extern "C" int ssme_filter_megakernel_spans(
    int model_id, int apf, const int64_t* seed, const float* params,
    const float* ys, const float* zs, int num_rows, int num_steps,
    int num_particles, float ess_limit, int always, int gate_stride,
    int resampler, int metropolis_iters, float* total, float* lcl,
    float* fmean, long long* spans, int* sweeps, float* ratio,
    void* stream) {
  const ssme_fmk::Launch a{seed, params, ys, zs, num_rows, num_steps,
                           num_particles, ess_limit, always, gate_stride,
                           resampler, metropolis_iters, total, lcl, fmean,
                           nullptr, nullptr,
                           static_cast<cudaStream_t>(stream)};
  return dispatch(model_id, apf, a, spans, sweeps, ratio);
}
