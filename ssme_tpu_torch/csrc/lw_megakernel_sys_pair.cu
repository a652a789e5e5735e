// The Liu-West kernel's systematic instances in the paired layout, a
// cluster of two CTAs a filter, and their instrumented twins
// (lw_megakernel_sys.cuh, lw_ring.cuh), in a file of their own so that
// nvcc builds them beside the other families in parallel.
#include "lw_megakernel_sys.cuh"

int ssme_lw::dispatch_pair(int model_id, const LWLaunch& a,
                           const LWArgs& args) {
  return dispatch_layout<kLWPer, kMaxThreads / kLWPer, false, true>(
      model_id, a, args);
}

int ssme_lw::pair_clusters(int model_id, int num_particles, int* count) {
  return dispatch_model<PairClusters>(model_id, num_particles, count);
}
