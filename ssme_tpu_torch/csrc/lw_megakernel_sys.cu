// The Liu-West kernel's systematic instances and their instrumented twins
// (lw_megakernel_sys.cuh), in a file of their own so that nvcc builds
// them beside the roll family's in parallel.
#include "lw_megakernel_sys.cuh"

int ssme_lw::dispatch_sys(int model_id, const LWLaunch& a,
                          const LWArgs& args) {
  return dispatch_layout<kLWPer, kMaxThreads / kLWPer, false>(model_id, a,
                                                              args);
}
