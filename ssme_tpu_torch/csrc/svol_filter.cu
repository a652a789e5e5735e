// Whole-sequence univariate-SVOL bootstrap filter bank for Hopper under
// the roll resamplers.
//
// Replaces ssme_tpu/ops/svol_filter_kernel.py::svol_filter_pallas (the
// Pallas kernel body _make_kernel) under resampler="metropolis" and
// "rejection": B filters over T observations in ONE launch, the particle
// cloud never leaving the chip.  Systematic selection runs in
// svol_filter_sys.cu, laid out for Hopper; this file keeps the roll
// family's kernel.
//
// Layout: one CTA per filter row and kPer particles per thread, a
// template parameter: kPer = 1 up to N = 1024 (blockDim = N, a power of
// two), then kPer = 2 up to 2048 and 4 up to 4096 (blockDim = N / kPer).
// Particle j = p * blockDim + threadIdx.x, so loads and the Philox
// counters (keyed by j) are the plain version's at every kPer, and the
// reductions first fold a thread's kPer values; every barrier stays in
// one CTA.  x and the carried log-weight live in registers for all T steps;
// the row's weights and the gather buffer of N floats each in static
// shared memory, 32 KB at 4096, which is the cap: above it the 48 KB of
// static shared memory would need an opt-in, and the generic bank
// (filters/bootstrap.py) takes larger N.  lcl[b, t] and xmean[b, t] are
// written straight to global memory by thread 0.  __launch_bounds__(1024,
// 1) caps the kernel at 64 registers a thread, so two 512-thread CTAs
// share an SM and B = 256 rows fit the H100's 132 SMs in one wave.
//
// What bounds it: per-step latency, not bytes.  Each of the T sequential
// steps costs block barriers (one max and one three-way sum reduction,
// plus, when it resamples, the selection's votes and a gather) and the
// transcendentals of one Box-Muller half-pair, one exp for the weight and
// one for the renormalisation.  The kernel moves about 8 bytes a step per
// row.
//
// Selection: the roll resamplers (roll_select.cuh, metropolis or
// rejection, chosen at run time) on the sweep tags of ops/_prng.py.
//
// Per step it computes exactly what the Pallas kernel computes:
//   t = 0   x ~ N(0, sigma^2 / (1 - phi^2)), lw = 0, carry = log N;
//   t > 0   gate_stride 1: resample (always, or when ESS < tau N) THEN
//           propagate x' = phi x + sigma eps;
//           gate_stride g > 1: propagate only, weights accumulate;
//   weight  lw += -log(2 pi)/2 - log beta - x/2 - (y e^{-x/2} / beta)^2 / 2;
//   check   (every step at g = 1; at t = g-1 mod g and t = T-1 otherwise)
//           lcl = LSE(lw) - carry, xmean under the full carried weights,
//           renormalise (lw -= max, carry = log sum); at g > 1 the ESS of
//           the renormalised weights then gates a resample.
//   lcl and xmean are zero off the check columns.
//
// Intended divergences from the Pallas kernel:
//  - the ESS gate is per row (the TPU gates on the worst row of an 8-row
//    tile and pads B with a real row; there is no tile here);
//  - the loop runs to T exactly: no padded steps, so the padded-step wipe
//    of the TPU kernel at T mod 128 in [1, g-1] cannot occur;
//  - steps_per_cell, substep_regions and compensated_cdf are TPU
//    artefacts and have no counterpart;
//  - random numbers are Philox4x32-10 (philox.cuh), not the TPU's.
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"
#include "roll_select.cuh"

namespace {

constexpr float kHalfLog2Pi = 0.9189385332046727f;
constexpr int kMaxThreads = 1024;

// the ancestors of this thread's kPer particles on weights wn under the
// roll resampler on the sweep tags, the state moved by them
template <int kPer>
__device__ __forceinline__ void resample(const float (&wn)[kPer],
                                         float (&x)[kPer][1], int resampler,
                                         int metropolis_iters, uint32_t k0,
                                         uint32_t k1, uint32_t t, uint32_t b,
                                         float* cdf, float* buf, float* red) {
  int anc[kPer];
  ssme::roll_ancestors<kPer>(resampler, metropolis_iters, wn, cdf, red, k0,
                             k1, t, b, ssme::kTagRollSweep, anc);
  ssme::gather_leaves_per<1, kPer>(x, anc, buf);
}

template <int kPer>
__global__ void __launch_bounds__(kMaxThreads, 1)
svol_filter_kernel(const int64_t* __restrict__ seed,
                   const float* __restrict__ params,
                   const float* __restrict__ ys, int num_steps,
                   float ess_limit, int always, int gate_stride,
                   int resampler, int metropolis_iters,
                   float* __restrict__ total, float* __restrict__ lcl,
                   float* __restrict__ xmean) {
  __shared__ float cdf[kMaxThreads * kPer];
  __shared__ float buf[kMaxThreads * kPer];
  __shared__ float red[3 * 32];

  const uint32_t b = blockIdx.x;
  const uint32_t i = threadIdx.x;
  const uint32_t bd = blockDim.x;
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const float beta = params[3 * b];
  const float phi = params[3 * b + 1];
  const float sigma = params[3 * b + 2];
  const float log_n = logf(static_cast<float>(bd * kPer));
  const float c0 = -kHalfLog2Pi - logf(beta);
  float* lcl_row = lcl + static_cast<size_t>(b) * num_steps;
  float* xmean_row = xmean + static_cast<size_t>(b) * num_steps;

  float x[kPer][1];
  float lw[kPer];
  float wn[kPer];             // exp(lw) after the last check
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    x[p][0] = ssme::normal_at(k0, k1, p * bd + i, 0u, b) *
              (sigma / sqrtf(1.0f - phi * phi));
    lw[p] = 0.0f;
    wn[p] = 1.0f;
  }
  float carry = log_n;
  float s_last = 1.0f;        // sum and sum of squares of wn at that check
  float s2_last = 1.0f;
  float row_total = 0.0f;

  for (int t = 0; t < num_steps; ++t) {
    if (t > 0) {
      if (gate_stride == 1 &&
          (always || s_last * s_last / s2_last < ess_limit)) {
        resample<kPer>(wn, x, resampler, metropolis_iters, k0, k1, t, b,
                       cdf, buf, red);
#pragma unroll
        for (int p = 0; p < kPer; ++p) lw[p] = 0.0f;
        carry = log_n;
      }
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        x[p][0] = phi * x[p][0] +
                  sigma * ssme::normal_at(k0, k1, p * bd + i, t, b);
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const float z = (ys[t] / beta) * expf(-0.5f * x[p][0]);
      lw[p] = lw[p] + ((c0 - 0.5f * x[p][0]) - 0.5f * z * z);
    }

    const bool check = gate_stride == 1 || t % gate_stride == gate_stride - 1
                       || t == num_steps - 1;
    if (!check) {
      if (i == 0) {
        lcl_row[t] = 0.0f;
        xmean_row[t] = 0.0f;
      }
      continue;
    }
    float m_loc = lw[0];
#pragma unroll
    for (int p = 1; p < kPer; ++p) m_loc = fmaxf(m_loc, lw[p]);
    const float m = ssme::block_max(m_loc, red);
    wn[0] = expf(lw[0] - m);
    float s0 = wn[0], s1 = x[0][0] * wn[0], s2 = wn[0] * wn[0];
#pragma unroll
    for (int p = 1; p < kPer; ++p) {
      wn[p] = expf(lw[p] - m);
      s0 += wn[p];
      s1 += x[p][0] * wn[p];
      s2 += wn[p] * wn[p];
    }
    const float3 r = ssme::block_sum3(s0, s1, s2, red);
    const float step_lcl = (m + logf(r.x)) - carry;
#pragma unroll
    for (int p = 0; p < kPer; ++p) lw[p] = lw[p] - m;
    carry = logf(r.x);
    s_last = r.x;
    s2_last = r.z;
    if (i == 0) {
      lcl_row[t] = step_lcl;
      xmean_row[t] = r.y / r.x;
    }
    row_total += step_lcl;
    if (gate_stride > 1 && r.x * r.x / r.z < ess_limit) {
      resample<kPer>(wn, x, resampler, metropolis_iters, k0, k1, t, b, cdf,
                     buf, red);
#pragma unroll
      for (int p = 0; p < kPer; ++p) lw[p] = 0.0f;
      carry = log_n;
    }
  }
  if (i == 0) total[b] = row_total;
}

int launch(int kper, const int64_t* seed, const float* params,
           const float* ys, int num_rows, int num_steps, int num_particles,
           float ess_limit, int always, int gate_stride, int resampler,
           int metropolis_iters, float* total, float* lcl, float* xmean,
           cudaStream_t s) {
#define SSME_SVOL_LAUNCH(K)                                                  \
  svol_filter_kernel<K><<<num_rows, num_particles / K, 0, s>>>(             \
      seed, params, ys, num_steps, ess_limit, always, gate_stride,          \
      resampler, metropolis_iters, total, lcl, xmean)
  switch (kper) {
    case 1: SSME_SVOL_LAUNCH(1); break;
    case 2: SSME_SVOL_LAUNCH(2); break;
    case 4: SSME_SVOL_LAUNCH(4); break;
    default: return -3;
  }
#undef SSME_SVOL_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers the caller allocated; the kernel allocates nothing and runs
// on `stream`.  resampler: 1 metropolis with metropolis_iters sweeps, 2
// rejection (systematic selection is ssme_svol_filter_sys's).
// num_particles: a power of two, one particle per thread up to 1024, two
// up to 2048, four up to 4096.  Returns cudaGetLastError() after the
// launch, or -3 for a particle count or resampler it does not take.
extern "C" int ssme_svol_filter(const int64_t* seed, const float* params,
                                const float* ys, int num_rows,
                                int num_steps, int num_particles,
                                float ess_limit, int always,
                                int gate_stride, int resampler,
                                int metropolis_iters, float* total,
                                float* lcl, float* xmean, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kper = num_particles <= kMaxThreads       ? 1
                   : num_particles <= 2 * kMaxThreads ? 2
                                                      : 4;
  if (resampler == ssme::kResampleSystematic ||
      num_particles > 4 * kMaxThreads || num_particles % (32 * kper))
    return -3;
  return launch(kper, seed, params, ys, num_rows, num_steps, num_particles,
                ess_limit, always, gate_stride, resampler, metropolis_iters,
                total, lcl, xmean, s);
}
