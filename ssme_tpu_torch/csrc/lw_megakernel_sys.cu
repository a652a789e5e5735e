// The Liu-West kernel's systematic instances and their instrumented twins
// (lw_megakernel_sys.cuh), in a file of their own so that nvcc builds
// them beside the roll family in parallel.
#include "lw_megakernel_sys.cuh"

int ssme_lw::dispatch_sys(int model_id, const LWLaunch& a,
                          const LWArgs& args) {
  if (a.spans == nullptr)
    return dispatch_model<SysAt<false>::Run>(model_id, a, args);
  return dispatch_model<SysAt<true>::Run>(model_id, a, args);
}
