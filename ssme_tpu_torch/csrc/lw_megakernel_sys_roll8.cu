// The Liu-West kernel's roll instances at 8 particles a thread and their
// instrumented twins (lw_megakernel_sys.cuh), in a file of their own so
// that nvcc builds them beside the other families in parallel.
#include "lw_megakernel_sys.cuh"

int ssme_lw::dispatch_roll8(int model_id, const LWLaunch& a,
                            const LWArgs& args) {
  return dispatch_layout<8, kRollThreads, true>(model_id, a, args);
}
