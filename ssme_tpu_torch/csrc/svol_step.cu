// One fused SVOL propagate + weight step for a (B, N) particle batch.
//
// Replaces ssme_tpu/ops/svol_kernel.py::fused_svol_propagate_weight (the
// Pallas body _kernel):
//   x'    = phi x + sigma eps,
//   logw' = logw - log(2 pi) / 2 - log sd - (y / sd)^2 / 2,  sd = beta e^{x'/2},
// with eps normal i of row b from counter (i >> 1, 0, b, 0) under the
// seed's key (philox.cuh; the TPU reseeds its hardware PRNG per grid cell
// instead).  One thread per particle pair: the pair's Philox call gives
// both normals of one Box-Muller draw, the cosine to particle 2k and the
// sine to 2k + 1.
//
// What bounds it: bytes.  It reads x and logw and writes x' and logw', 16
// bytes a particle, against one Philox call and three transcendentals per
// pair; at the shapes it is called with, a launch is a few microseconds.
// The products and sums are rounded one by one (__fmul_rn, __fadd_rn), so
// that with the same normals the plain version's x' is equal bit for bit
// and logw' differs only by the libraries' exp and log.  y is read from
// device memory when y_ptr is not null, so a device scalar is never copied
// to the host.
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr float kHalfLog2Pi = 0.9189385332046727f;
constexpr int kThreads = 256;

__device__ __forceinline__ void step_one(float beta, float phi, float sigma,
                                         float y, float eps, float x,
                                         float lw, float* x_out,
                                         float* lw_out) {
  const float xn = __fadd_rn(__fmul_rn(phi, x), __fmul_rn(sigma, eps));
  const float sd = __fmul_rn(beta, expf(__fmul_rn(0.5f, xn)));
  const float z = __fdiv_rn(y, sd);
  const float log_g = __fsub_rn(__fsub_rn(-kHalfLog2Pi, logf(sd)),
                                __fmul_rn(__fmul_rn(0.5f, z), z));
  *x_out = xn;
  *lw_out = __fadd_rn(lw, log_g);
}

__global__ void __launch_bounds__(kThreads)
svol_step_kernel(const int64_t* __restrict__ seed, const float* __restrict__ y_ptr,
                 float y_val, const float* __restrict__ params,
                 const float* __restrict__ x, const float* __restrict__ logw,
                 int num_pairs, float* __restrict__ x_out,
                 float* __restrict__ logw_out) {
  const uint32_t k = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t b = blockIdx.y;
  if (k >= static_cast<uint32_t>(num_pairs)) return;
  const uint4 w = ssme::philox4x32_10(
      make_uint4(k, 0u, b, ssme::kTagNormal), static_cast<uint32_t>(seed[0]),
      static_cast<uint32_t>(seed[1]));
  const float2 eps = ssme::box_muller(w.x, w.y);
  const float beta = params[3 * b], phi = params[3 * b + 1];
  const float sigma = params[3 * b + 2];
  const float y = y_ptr != nullptr ? *y_ptr : y_val;
  const size_t at = (static_cast<size_t>(b) * num_pairs + k) * 2;
  const float2 xv = *reinterpret_cast<const float2*>(x + at);
  const float2 lv = *reinterpret_cast<const float2*>(logw + at);
  float2 xo, lo;
  step_one(beta, phi, sigma, y, eps.x, xv.x, lv.x, &xo.x, &lo.x);
  step_one(beta, phi, sigma, y, eps.y, xv.y, lv.y, &xo.y, &lo.y);
  *reinterpret_cast<float2*>(x_out + at) = xo;
  *reinterpret_cast<float2*>(logw_out + at) = lo;
}

}  // namespace

// Plain C entry point (bound with ctypes).  All arrays are device arrays
// the caller allocated: params (B, 3), x, logw, x_out, logw_out (B, N),
// N even; y_ptr a one-element device array, or null to use y_val.  The
// kernel allocates nothing and runs on `stream`.  Returns
// cudaGetLastError() after the launch.
extern "C" int ssme_svol_step(const int64_t* seed, const float* y_ptr,
                              float y_val, const float* params,
                              const float* x, const float* logw,
                              int num_rows, int num_particles, float* x_out,
                              float* logw_out, void* stream) {
  const int pairs = num_particles / 2;
  const dim3 grid((pairs + kThreads - 1) / kThreads, num_rows);
  svol_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, y_ptr, y_val, params, x, logw, pairs, x_out, logw_out);
  return static_cast<int>(cudaGetLastError());
}
