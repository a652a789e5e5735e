// The generic filter kernel's systematic instances at 4 particles per
// thread (filter_megakernel_sys.cuh), in a file of their own so that nvcc
// builds them beside the other kPer in parallel.
#include "filter_megakernel_sys.cuh"

int ssme_fmk::dispatch_sys4(int model_id, int apf, const Launch& a,
                            long long* spans) {
  return spans ? dispatch_sys_spans<4>(apf, a, spans)
               : dispatch_sys<4>(model_id, apf, a);
}
