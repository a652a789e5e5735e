// Standalone launch of the Philox device code that the SVOL filter kernel
// inlines (philox.cuh): for rows b < B and pairs j < N/2 at step t it
// writes the four Philox words of counter (j, t, b, kTagNormal), the two
// uniforms and the Box-Muller pair taken from the first two words, and
// per row the resampling offset of counter (0, t, b, kTagOffset).  It
// exists so the card can check the bits bitwise against the plain
// PyTorch Philox.  Replaces the TPU helpers of ssme_tpu/ops/_prng.py;
// bound by the integer multiplies of the ten rounds.
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

__global__ void philox_fill_kernel(const int64_t* __restrict__ seed,
                                   int num_rows, int num_pairs, int step,
                                   uint32_t* __restrict__ bits,
                                   float* __restrict__ u1,
                                   float* __restrict__ u2,
                                   float* __restrict__ normals,
                                   float* __restrict__ offsets) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_rows * num_pairs) return;
  const uint32_t b = idx / num_pairs;
  const uint32_t j = idx % num_pairs;
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const uint4 w = ssme::philox4x32_10(
      make_uint4(j, static_cast<uint32_t>(step), b, ssme::kTagNormal), k0,
      k1);
  bits[4 * idx] = w.x;
  bits[4 * idx + 1] = w.y;
  bits[4 * idx + 2] = w.z;
  bits[4 * idx + 3] = w.w;
  u1[idx] = ssme::uniform_open_zero(w.x);
  u2[idx] = ssme::uniform_closed_zero(w.y);
  const float2 z = ssme::box_muller(w.x, w.y);
  normals[2 * idx] = z.x;
  normals[2 * idx + 1] = z.y;
  if (j == 0) offsets[b] = ssme::offset_at(k0, k1, step, b);
}

}  // namespace

extern "C" int ssme_philox_fill(const int64_t* seed, int num_rows,
                                int num_pairs, int step, uint32_t* bits,
                                float* u1, float* u2, float* normals,
                                float* offsets, void* stream) {
  const int threads = 256;
  const int blocks = (num_rows * num_pairs + threads - 1) / threads;
  philox_fill_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      seed, num_rows, num_pairs, step, bits, u1, u2, normals, offsets);
  return static_cast<int>(cudaGetLastError());
}
