// The Liu-West kernel's roll instances at 2 particles a thread and their
// instrumented twins (lw_megakernel_sys.cuh), in a file of their own so
// that nvcc builds them beside the other families in parallel.
#include "lw_megakernel_sys.cuh"

int ssme_lw::dispatch_roll2(int model_id, const LWLaunch& a,
                            const LWArgs& args) {
  return dispatch_layout<2, kRollThreads, true>(model_id, a, args);
}
