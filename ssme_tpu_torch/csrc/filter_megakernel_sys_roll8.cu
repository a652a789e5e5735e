// The generic filter kernel's roll-resampler instances at 8 particles
// per thread (filter_megakernel_sys.cuh), in a file of their own so that
// nvcc builds them beside the other families and kPer in parallel.
#include "filter_megakernel_sys.cuh"

int ssme_fmk::dispatch_roll8(int model_id, int apf, const Launch& a,
                             long long* spans, int* sweeps, float* ratio) {
  return spans
             ? dispatch_spans<8, true>(model_id, apf, a, spans, sweeps, ratio)
             : dispatch_family<8, true>(model_id, apf, a);
}
