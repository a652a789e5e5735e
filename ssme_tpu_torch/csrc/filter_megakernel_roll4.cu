// The generic filter kernel's roll-resampler instances at four particles
// per thread (filter_megakernel.cuh), in a file of their own so that nvcc
// builds them beside the other kPer in parallel.
#include "filter_megakernel.cuh"

int ssme_fmk::dispatch_roll4(int model_id, int apf, const Launch& a) {
  return dispatch_roll<4>(model_id, apf, a);
}
