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
// bytes a particle: 80 us at (4096, 4096) over 3.35 TB/s, against 20 us
// for the special functions (four a pair, three a particle, at 16 a clock
// an SM) and 10 for the Philox call's 20 wide multiplies a pair.  But the
// accurate expf, logf, sincosf and divide that keep the bits issue far
// more than their special-function operations, so a pair is long work and
// the step needs every warp an SM holds to keep enough bytes in flight:
// one pair a thread on 27 registers, 64 warps an SM, reaches 84% of the
// byte bound at (4096, 4096).
// Layouts that gave a thread 2 or 4 neighbouring pairs in 16-byte
// accesses, or one wave of blocks walking the rows in a grid-stride loop,
// held 40-76 registers (24-48 warps an SM) and ran 2-33% slower; forcing 8
// blocks an SM on them spilled and ran up to twice as long (PERF.md, PR
// 12).  The inputs are read once through the non-coherent path and the
// outputs written as streaming stores.  The products and sums are rounded
// one by one (__fmul_rn, __fadd_rn), so that with the same normals the
// plain version's x' is equal bit for bit and logw' differs only by the
// libraries' exp and log.  y is read from device memory when y_ptr is not
// null, so a device scalar is never copied to the host.
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
svol_step_kernel(const int64_t* __restrict__ seed,
                 const float* __restrict__ y_ptr, float y_val,
                 const float* __restrict__ params,
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
  const float2 xv = __ldg(reinterpret_cast<const float2*>(x + at));
  const float2 lv = __ldg(reinterpret_cast<const float2*>(logw + at));
  float2 xo, lo;
  step_one(beta, phi, sigma, y, eps.x, xv.x, lv.x, &xo.x, &lo.x);
  step_one(beta, phi, sigma, y, eps.y, xv.y, lv.y, &xo.y, &lo.y);
  __stcs(reinterpret_cast<float2*>(x_out + at), xo);
  __stcs(reinterpret_cast<float2*>(logw_out + at), lo);
}

// nothing: the card's floor for a launch of a grid
__global__ void empty_kernel() {}

dim3 step_grid(int num_rows, int num_particles) {
  return dim3((num_particles / 2 + kThreads - 1) / kThreads, num_rows);
}

}  // namespace

// Plain C entry point (bound with ctypes).  All arrays are device arrays
// the caller allocated: params (B, 3), x, logw, x_out, logw_out (B, N),
// N even, each 8-byte aligned; y_ptr a one-element device array, or null
// to use y_val.  The kernel allocates nothing and runs on `stream`.
// Returns cudaGetLastError() after the launch.
extern "C" int ssme_svol_step(const int64_t* seed, const float* y_ptr,
                              float y_val, const float* params,
                              const float* x, const float* logw,
                              int num_rows, int num_particles, float* x_out,
                              float* logw_out, void* stream) {
  svol_step_kernel<<<step_grid(num_rows, num_particles), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      seed, y_ptr, y_val, params, x, logw, num_particles / 2, x_out,
      logw_out);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry ssme_svol_step uses for (B, N): grid x, grid y and
// threads a block, written to out[0..2].
extern "C" int ssme_svol_step_grid(int num_rows, int num_particles,
                                   int* out) {
  const dim3 grid = step_grid(num_rows, num_particles);
  out[0] = static_cast<int>(grid.x);
  out[1] = static_cast<int>(grid.y);
  out[2] = kThreads;
  return 0;
}

// An empty kernel on a (gx, gy) grid of `threads`-thread blocks: the
// card's launch floor for that geometry.
extern "C" int ssme_empty_launch(int gx, int gy, int threads, void* stream) {
  empty_kernel<<<dim3(gx, gy), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
