// The Liu-West kernel's C entry points.  lw_megakernel.cuh has the step
// recursion and the divergences from the Pallas kernel;
// lw_megakernel_sys.cuh the template and its two families (instances in
// lw_megakernel_sys.cu, the systematic family's paired layout in
// lw_megakernel_sys_pair.cu, and lw_megakernel_sys_roll{2,4,8}.cu).
#include "lw_megakernel.cuh"
#include "lw_megakernel_sys.cuh"

namespace ssme_lw {
namespace {

// the argument block from the host arrays of the C entry points
LWArgs make_args(const float* coefs, const float* prior_lo,
                 const float* prior_scale, const float* model_args) {
  LWArgs args;
  args.a = coefs[0];
  args.one_minus_a = coefs[1];
  args.h2 = coefs[2];
  for (int k = 0; k < kMaxParams; ++k) {
    args.prior_lo[k] = prior_lo[k];
    args.prior_scale[k] = prior_scale[k];
  }
  for (int k = 0; k < kMaxModelArgs; ++k) args.model[k] = model_args[k];
  return args;
}

// the instances (or, with a.spans, their twins) of the resampler's family
// at the layout of N, in one CTA a filter or, with cluster 2 (systematic
// only), the paired layout; -3 for a particle count, resampler or cluster
// size they do not take
int dispatch(int model_id, const LWLaunch& a, const LWArgs& args,
             int cluster) {
  const int n = a.num_particles;
  if (a.resampler == ssme::kResampleSystematic) {
    if (n < 32 || n > kMaxThreads || n % 32) return -3;
    if (cluster == 2) return dispatch_pair(model_id, a, args);
    return cluster == 1 ? dispatch_sys(model_id, a, args) : -3;
  }
  if (cluster != 1) return -3;
  if ((a.resampler != ssme::kResampleMetropolis &&
       a.resampler != ssme::kResampleRejection) ||
      n < 32 || n > 4 * kMaxThreads || (n & (n - 1)))
    return -3;
  switch (roll_kper_for(n)) {
    case 2: return dispatch_roll2(model_id, a, args);
    case 4: return dispatch_roll4(model_id, a, args);
    case 8: return dispatch_roll8(model_id, a, args);
    default: return -3;
  }
}

}  // namespace
}  // namespace ssme_lw

// Plain C entry point (bound with ctypes).  seed, ys, zs, lcl, fpaths and
// cloud are device pointers the caller allocated (zs null without
// covariates, fpaths null without functionals); coefs (a, 1 - a, h^2),
// prior_lo, prior_scale (kMaxParams each) and model_args (kMaxModelArgs)
// are host arrays, copied into the launch's argument block.  ess_limit > 0
// gates the resample on ESS < ess_limit, else it follows resample_every.
// resampler: 0 systematic (N a multiple of 32 up to 1024), 1 metropolis
// with metropolis_iters sweeps, 2 rejection (both on a power-of-two N up
// to 4096).  cluster: the CTAs a filter, 1, or 2 for the systematic
// family's paired layout (lw_ring.cuh; the caller checks that the card
// holds every filter's cluster at once, ssme_lw_megakernel_clusters).  The
// kernel allocates nothing and runs on `stream`.  Returns
// cudaGetLastError() after the launch, -1 for an unknown model id, or -3
// for a particle count the resampler does not take or another cluster
// size.
extern "C" int ssme_lw_megakernel(int model_id, const int64_t* seed,
                                  const float* ys, const float* zs,
                                  int num_filters, int num_steps,
                                  int num_particles, int apf,
                                  int resample_every, float ess_limit,
                                  int resampler, int metropolis_iters,
                                  int cluster, const float* coefs,
                                  const float* prior_lo,
                                  const float* prior_scale,
                                  const float* model_args, float* lcl,
                                  float* fpaths, float* cloud, void* stream) {
  using namespace ssme_lw;
  const LWArgs args = make_args(coefs, prior_lo, prior_scale, model_args);
  const LWLaunch a{seed, ys, zs, num_filters, num_steps, num_particles,
                   apf, resample_every, ess_limit, resampler,
                   metropolis_iters, lcl, fpaths, cloud,
                   static_cast<cudaStream_t>(stream)};
  return dispatch(model_id, a, args, cluster);
}

// How many clusters of the paired systematic instance of model_id at
// num_particles the card holds at once, into *count
// (cudaOccupancyMaxActiveClusters; nothing is launched).  Returns the
// query's cudaError_t, -1 for an unknown model id, or -3 for a particle
// count the systematic family does not take.
extern "C" int ssme_lw_megakernel_clusters(int model_id, int num_particles,
                                           int* count) {
  using namespace ssme_lw;
  if (num_particles < 32 || num_particles > kMaxThreads || num_particles % 32)
    return -3;
  return pair_clusters(model_id, num_particles, count);
}

// The instrumented twin of the instance ssme_lw_megakernel runs: its
// arguments, and spans, int64[num_filters * kNumLWSpans] the twin writes
// (lw_megakernel_sys.cuh LWSpan): where a step's time goes, the barriers
// it crosses and, under the roll resamplers, what its selections did.
extern "C" int ssme_lw_megakernel_spans(int model_id, const int64_t* seed,
                                        const float* ys, const float* zs,
                                        int num_filters, int num_steps,
                                        int num_particles, int apf,
                                        int resample_every, float ess_limit,
                                        int resampler, int metropolis_iters,
                                        int cluster, const float* coefs,
                                        const float* prior_lo,
                                        const float* prior_scale,
                                        const float* model_args, float* lcl,
                                        float* fpaths, float* cloud,
                                        long long* spans, void* stream) {
  using namespace ssme_lw;
  if (spans == nullptr) return -3;
  const LWArgs args = make_args(coefs, prior_lo, prior_scale, model_args);
  const LWLaunch a{seed, ys, zs, num_filters, num_steps, num_particles,
                   apf, resample_every, ess_limit, resampler,
                   metropolis_iters, lcl, fpaths, cloud,
                   static_cast<cudaStream_t>(stream), spans};
  return dispatch(model_id, a, args, cluster);
}
