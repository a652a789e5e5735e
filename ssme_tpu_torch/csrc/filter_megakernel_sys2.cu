// The generic filter kernel's systematic instances at 2 particles per
// thread (filter_megakernel_sys.cuh), in a file of their own so that nvcc
// builds them beside the other kPer in parallel.
#include "filter_megakernel_sys.cuh"

int ssme_fmk::dispatch_sys2(int model_id, int apf, const Launch& a,
                            long long* spans) {
  return spans ? dispatch_sys_spans<2>(apf, a, spans)
               : dispatch_sys<2>(model_id, apf, a);
}
