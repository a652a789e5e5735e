// The Liu-West kernel's C entry points, and its roll family at one
// particle per thread (the Metropolis and rejection resamplers up to 1024
// particles).  lw_megakernel.cuh has the step recursion and the
// divergences from the Pallas kernel; lw_megakernel_sys.cuh the systematic
// family (instances in lw_megakernel_sys.cu); lw_megakernel_roll.cu
// the roll instances above 1024 particles.
//
// This kernel keeps its own code, apart from the kPer one of
// lw_megakernel_roll.cu: instantiated at kPer = 1, that template computed
// svol_t_lw with other float roundings (measured on the H100 against this
// kernel), and the instances here must repeat their results bit for bit.  Per
// step it gathers the APF ancestors' state, lookahead and shrunk theta
// (2S + P leaves) where the kPer kernel gathers state and theta and
// recomputes the other two.
#include "lw_megakernel.cuh"
#include "lw_megakernel_sys.cuh"

namespace ssme_lw {
namespace {

// the max of lw, then the block sums of w = exp(lw - max) (*wn, this
// thread's), of each functional times w and of w^2: *s, the functional
// means fmean[K], *s2, and *lse = LSE(lw).  Returns the max.
template <class Model>
__device__ __forceinline__ float weigh(const Model& model, float lw,
                                       const float* cp, const float* x,
                                       float* red, float* wn, float* s,
                                       float* s2, float* lse, float* fmean) {
  constexpr int K = Model::kNumFunctionals;
  const float m = ssme::block_max(lw, red);
  *wn = expf(lw - m);
  float v[K + 2];
  v[0] = *wn;
#pragma unroll
  for (int k = 0; k < K; ++k) v[1 + k] = model.functional(k, cp, x) * *wn;
  v[K + 1] = *wn * *wn;
  ssme::block_sum<K + 2>(v, red);
  *s = v[0];
  *s2 = v[K + 1];
  *lse = m + logf(v[0]);
#pragma unroll
  for (int k = 0; k < K; ++k) fmean[k] = v[1 + k] / v[0];
  return m;
}

// the ancestor of this thread's particle under the roll resampler, on the
// sweep tags from tag_roll (cdf: the weights')
__device__ __forceinline__ int roll_ancestor(float w, int resampler,
                                             int metropolis_iters,
                                             uint32_t k0, uint32_t k1,
                                             uint32_t t, uint32_t b,
                                             uint32_t tag_roll, float* cdf,
                                             float* red) {
  const float wv[1] = {w};
  int anc[1];
  ssme::roll_ancestors<1>(resampler, metropolis_iters, wv, cdf, red, k0, k1,
                          t, b, tag_roll, anc);
  return anc[0];
}

// the joint (state, theta) resample of one filter, on the resample_every
// schedule or when its ESS falls below ess_limit; lw = 0 after it
template <int S, int P>
__device__ __forceinline__ void maybe_resample(
    int t, float wn, float s, float s2, float ess_limit, int resample_every,
    int resampler, int metropolis_iters, uint32_t k0, uint32_t k1,
    uint32_t b, float (&x)[S], float (&th)[P], float& lw, float* cdf,
    float* buf, float* red) {
  const bool fire = ess_limit > 0.0f
                        ? s * s / s2 < ess_limit
                        : (resample_every == 1 ||
                           (t + 1) % resample_every == 0);
  if (!fire) return;
  const int anc = roll_ancestor(wn, resampler, metropolis_iters, k0, k1, t,
                                b, ssme::kTagRollSweep, cdf, red);
  float v[S + P];
#pragma unroll
  for (int l = 0; l < S; ++l) v[l] = x[l];
#pragma unroll
  for (int k = 0; k < P; ++k) v[S + k] = th[k];
  ssme::gather_leaves<S + P>(v, anc, buf);
#pragma unroll
  for (int l = 0; l < S; ++l) x[l] = v[l];
#pragma unroll
  for (int k = 0; k < P; ++k) th[k] = v[S + k];
  lw = 0.0f;
}

template <class Model>
__global__ void __launch_bounds__(kMaxThreads, 1)
lw_megakernel(const int64_t* __restrict__ seed, const float* __restrict__ ys,
              const float* __restrict__ zs, int num_steps, int apf,
              int resample_every, float ess_limit, int resampler,
              int metropolis_iters, LWArgs args, float* __restrict__ lcl,
              float* __restrict__ fpaths, float* __restrict__ cloud) {
  constexpr int P = Model::kNumParams;
  constexpr int S = Model::kNumState;
  constexpr int K = Model::kNumFunctionals;
  constexpr int kGram = P * (P + 1) / 2;
  constexpr int kSums = cmax(cmax(1 + P, kGram), K + 2);
  __shared__ float cdf[kMaxThreads];
  __shared__ float buf[kMaxThreads];
  __shared__ float red[32 * kSums];
  __shared__ float chol[P * P];
  __shared__ float tbar[P];

  const uint32_t b = blockIdx.x;
  const uint32_t i = threadIdx.x;
  const int n = blockDim.x;
  const int num_filters = gridDim.x;
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const Model model(args.model);
  const float log_n = logf(static_cast<float>(n));
  float* lcl_row = lcl + static_cast<size_t>(b) * num_steps;

  float y[Model::kDimObs];
  float z[Model::kDimCov > 0 ? Model::kDimCov : 1];
  float x[S], th[P], cp[P];
  float fmean[K > 0 ? K : 1];

  // lcl and the functional means of column t, written by thread 0
  const auto emit = [&](int t, float val) {
    if (i == 0) {
      lcl_row[t] = val;
#pragma unroll
      for (int k = 0; k < K; ++k)
        fpaths[(static_cast<size_t>(k) * num_filters + b) * num_steps + t] =
            fmean[k];
    }
  };

  // t = 0: the prior draw, the init draw, the first weights
  float lw, wn, s, s2, lse;
  load_step<Model>(ys, zs, 0, y, z);
#pragma unroll
  for (int blk = 0; blk < (P + 3) / 4; ++blk) {
    const float4 u = ssme::prior_uniforms_at(k0, k1, i, blk, b);
    const float uu[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4 && 4 * blk + j < P; ++j) {
      const int k = 4 * blk + j;
      cp[k] = args.prior_lo[k] + args.prior_scale[k] * uu[j];
      th[k] = ssme::to_transformed(Model::code(k), cp[k]);
    }
  }
  {
    ssme::StepRng rng{k0, k1, i, 0u, b, static_cast<uint32_t>(P)};
    model.init(rng, cp, y, z, x);
  }
  lw = model.log_weight(cp, x, y, z);
  float m = weigh(model, lw, cp, x, red, &wn, &s, &s2, &lse, fmean);
  emit(0, lse - log_n);
  lw = lw - m;
  maybe_resample(0, wn, s, s2, ess_limit, resample_every, resampler,
                 metropolis_iters, k0, k1, b, x, th, lw, cdf, buf, red);

  for (int t = 1; t < num_steps; ++t) {
    load_step<Model>(ys, zs, t, y, z);
    // weighted shrinkage moments in two passes; lw has maximum 0
    const float ww = expf(lw);
    float v1[1 + P];
    v1[0] = ww;
#pragma unroll
    for (int k = 0; k < P; ++k) v1[1 + k] = th[k] * ww;
    ssme::block_sum<1 + P>(v1, red);
    const float wsum = v1[0];
    // theta_bar goes to shared memory (thread 0 writes it; the Gram's
    // barriers publish it) so that it holds no registers across the Gram
    float cen[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float tb = v1[1 + k] / wsum;
      cen[k] = th[k] - tb;
      if (i == 0) tbar[k] = tb;
    }
    float v2[kGram];
    {
      int at = 0;
#pragma unroll
      for (int r = 0; r < P; ++r)
#pragma unroll
        for (int c = 0; c <= r; ++c) v2[at++] = (cen[r] * ww) * cen[c];
    }
    ssme::block_sum<kGram>(v2, red);
    if (i == 0) {
      // unrolled P x P Cholesky of h^2 Vt straight into shared memory,
      // the floored diagonal; v2[r (r + 1) / 2 + c] is Gram entry (r, c)
#pragma unroll
      for (int jj = 0; jj < P; ++jj) {
        float acc = args.h2 * (v2[jj * (jj + 1) / 2 + jj] / wsum);
#pragma unroll
        for (int k = 0; k < jj; ++k)
          acc = acc - chol[jj * P + k] * chol[jj * P + k];
        chol[jj * P + jj] = sqrtf(acc < kEpsChol ? kEpsChol : acc);
#pragma unroll
        for (int r = jj + 1; r < P; ++r) {
          float acc2 = args.h2 * (v2[r * (r + 1) / 2 + jj] / wsum);
#pragma unroll
          for (int k = 0; k < jj; ++k)
            acc2 = acc2 - chol[r * P + k] * chol[jj * P + k];
          chol[r * P + jj] = acc2 / chol[jj * P + jj];
        }
      }
    }
    float shrunk[P];
#pragma unroll
    for (int k = 0; k < P; ++k)
      shrunk[k] = args.a * th[k] + args.one_minus_a * tbar[k];

    float look[S];
    float lse_fs = 0.0f;
    if (apf) {
      constrain<Model>(th, cp);
      model.prop_mu(cp, x, y, z, look);
      constrain<Model>(shrunk, cp);
      const float lfs = lw + model.log_weight(cp, look, y, z);
      const float mfs = ssme::block_max(lfs, red);
      const float wfs = expf(lfs - mfs);
      float sfs[1] = {wfs};
      ssme::block_sum<1>(sfs, red);
      lse_fs = mfs + logf(sfs[0]);
      const int anc = roll_ancestor(wfs, resampler, metropolis_iters, k0, k1,
                                    t, b, ssme::kTagRollSelect, cdf, red);
      float g[2 * S + P];
#pragma unroll
      for (int l = 0; l < S; ++l) {
        g[l] = x[l];
        g[S + l] = look[l];
      }
#pragma unroll
      for (int k = 0; k < P; ++k) g[2 * S + k] = shrunk[k];
      ssme::gather_leaves<2 * S + P>(g, anc, buf);
#pragma unroll
      for (int l = 0; l < S; ++l) {
        x[l] = g[l];
        look[l] = g[S + l];
      }
#pragma unroll
      for (int k = 0; k < P; ++k) shrunk[k] = g[2 * S + k];
    } else {
      __syncthreads();  // the Cholesky factor of thread 0
    }

    // kernel draws theta' = shrunk_anc + L e
#pragma unroll
    for (int r = 0; r < P; ++r) th[r] = shrunk[r];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float e = ssme::normal_at(k0, k1, i, t, b, k);
#pragma unroll
      for (int r = k; r < P; ++r) th[r] = th[r] + chol[r * P + k] * e;
    }
    constrain<Model>(th, cp);
    float lw_new;
    {
      ssme::StepRng rng{k0, k1, i, static_cast<uint32_t>(t), b,
                        static_cast<uint32_t>(P)};
      if constexpr (Model::kHasProposal) {
        if (apf) {
          model.propagate(rng, cp, x, y, z);
        } else {
          // the SISR form's own proposal and its log f - log q
          float x_anc[S];
#pragma unroll
          for (int l = 0; l < S; ++l) x_anc[l] = x[l];
          model.sample_q(rng, cp, x_anc, y, z, x);
          lw_new = lw + (model.log_weight(cp, x, y, z) +
                         model.log_fq(cp, x, x_anc, y, z));
        }
      } else {
        model.propagate(rng, cp, x, y, z);
      }
    }
    if (apf) {
      float cpa[P];
      constrain<Model>(shrunk, cpa);
      lw_new = model.log_weight(cp, x, y, z) -
               model.log_weight(cpa, look, y, z);
    } else if constexpr (!Model::kHasProposal) {
      lw_new = lw + model.log_weight(cp, x, y, z);
    }
    m = weigh(model, lw_new, cp, x, red, &wn, &s, &s2, &lse, fmean);
    emit(t, apf ? ((lse_fs - logf(wsum)) + lse) - log_n : lse - logf(wsum));
    lw = lw_new - m;
    maybe_resample(t, wn, s, s2, ess_limit, resample_every, resampler,
                   metropolis_iters, k0, k1, b, x, th, lw, cdf, buf, red);
  }

  const size_t rows = S + 1 + P;
  float* out = cloud + static_cast<size_t>(b) * rows * n + i;
#pragma unroll
  for (int l = 0; l < S; ++l) out[l * n] = x[l];
  out[S * n] = lw;
#pragma unroll
  for (int k = 0; k < P; ++k) out[(S + 1 + k) * n] = th[k];
}

template <class Model>
struct RunOne {
  static int go(const LWLaunch& a, const LWArgs& args) {
    lw_megakernel<Model><<<a.num_filters, a.num_particles, 0, a.stream>>>(
        a.seed, a.ys, a.zs, a.num_steps, a.apf, a.resample_every,
        a.ess_limit, a.resampler, a.metropolis_iters, args, a.lcl, a.fpaths,
        a.cloud);
    return static_cast<int>(cudaGetLastError());
  }
};

// the argument block from the host arrays of the C entry points
LWArgs make_args(const float* coefs, const float* prior_lo,
                 const float* prior_scale, const float* model_args) {
  LWArgs args;
  args.a = coefs[0];
  args.one_minus_a = coefs[1];
  args.h2 = coefs[2];
  for (int k = 0; k < kMaxParams; ++k) {
    args.prior_lo[k] = prior_lo[k];
    args.prior_scale[k] = prior_scale[k];
  }
  for (int k = 0; k < kMaxModelArgs; ++k) args.model[k] = model_args[k];
  return args;
}

// the systematic instances (or, with a.spans, their twins); -3 for a
// particle count they do not take
int dispatch_systematic(int model_id, const LWLaunch& a,
                        const LWArgs& args) {
  const int n = a.num_particles;
  if (n < 32 || n > kMaxThreads || n % 32) return -3;
  return dispatch_sys(model_id, a, args);
}

}  // namespace
}  // namespace ssme_lw

// Plain C entry point (bound with ctypes).  seed, ys, zs, lcl, fpaths and
// cloud are device pointers the caller allocated (zs null without
// covariates, fpaths null without functionals); coefs (a, 1 - a, h^2),
// prior_lo, prior_scale (kMaxParams each) and model_args (kMaxModelArgs)
// are host arrays, copied into the launch's argument block.  ess_limit > 0
// gates the resample on ESS < ess_limit, else it follows resample_every.
// resampler: 0 systematic (N a multiple of 32 up to 1024), 1 metropolis
// with metropolis_iters sweeps, 2 rejection (both on a power-of-two N up
// to 4096).  The kernel allocates nothing and runs on `stream`.  Returns
// cudaGetLastError() after the launch, -1 for an unknown model id, or -3
// for a particle count the resampler does not take.
extern "C" int ssme_lw_megakernel(int model_id, const int64_t* seed,
                                  const float* ys, const float* zs,
                                  int num_filters, int num_steps,
                                  int num_particles, int apf,
                                  int resample_every, float ess_limit,
                                  int resampler, int metropolis_iters,
                                  const float* coefs, const float* prior_lo,
                                  const float* prior_scale,
                                  const float* model_args, float* lcl,
                                  float* fpaths, float* cloud, void* stream) {
  using namespace ssme_lw;
  const LWArgs args = make_args(coefs, prior_lo, prior_scale, model_args);
  const LWLaunch a{seed, ys, zs, num_filters, num_steps, num_particles,
                   apf, resample_every, ess_limit, resampler,
                   metropolis_iters, lcl, fpaths, cloud,
                   static_cast<cudaStream_t>(stream)};
  if (resampler == ssme::kResampleSystematic)
    return dispatch_systematic(model_id, a, args);
  if (num_particles <= kMaxThreads)
    return dispatch_model<RunOne>(model_id, a, args);
  return dispatch_roll_large(model_id, a, args);
}

// The instrumented twin of the systematic instance ssme_lw_megakernel
// runs: its arguments less the resampler, and spans, int64[num_filters *
// kNumLWSpans] the twin writes (lw_megakernel_sys.cuh LWSpan): where a
// step's time goes and the barriers it crosses.
extern "C" int ssme_lw_megakernel_spans(int model_id, const int64_t* seed,
                                        const float* ys, const float* zs,
                                        int num_filters, int num_steps,
                                        int num_particles, int apf,
                                        int resample_every, float ess_limit,
                                        const float* coefs,
                                        const float* prior_lo,
                                        const float* prior_scale,
                                        const float* model_args, float* lcl,
                                        float* fpaths, float* cloud,
                                        long long* spans, void* stream) {
  using namespace ssme_lw;
  if (spans == nullptr) return -3;
  const LWArgs args = make_args(coefs, prior_lo, prior_scale, model_args);
  const LWLaunch a{seed, ys, zs, num_filters, num_steps, num_particles,
                   apf, resample_every, ess_limit,
                   ssme::kResampleSystematic, 16, lcl, fpaths, cloud,
                   static_cast<cudaStream_t>(stream), spans};
  return dispatch_systematic(model_id, a, args);
}
