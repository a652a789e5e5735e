// The Liu-West kernel's roll-resampler instances above 1024 particles:
// blockDim = 1024 and kPer = N / 1024 particles per thread (particle j = p
// * blockDim + threadIdx.x), in a file of their own so that nvcc builds
// them beside lw_megakernel.cu in parallel.  lw_megakernel.cuh has the
// layout, the step recursion and why this design; each particle's step is
// lw_megakernel.cu's, and the reductions first fold a thread's kPer
// values.
#include "lw_megakernel.cuh"

namespace ssme_lw {
namespace {

// the max of the thread's lw[kPer], then the block sums of w = exp(lw -
// max) (wn, this thread's), of each functional value hv times w and of
// w^2: *s, the functional means fmean[K], *s2, and *lse = LSE(lw).
// Returns the max.
template <int K, int kPer>
__device__ __forceinline__ float weigh(const float (&lw)[kPer],
                                       const float (&hv)[kPer][K > 0 ? K : 1],
                                       float* red, float (&wn)[kPer],
                                       float* s, float* s2, float* lse,
                                       float* fmean) {
  float m_loc = lw[0];
#pragma unroll
  for (int p = 1; p < kPer; ++p) m_loc = fmaxf(m_loc, lw[p]);
  const float m = ssme::block_max(m_loc, red);
  float v[K + 2];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    wn[p] = expf(lw[p] - m);
    if (p == 0) {
      v[0] = wn[p];
#pragma unroll
      for (int k = 0; k < K; ++k) v[1 + k] = hv[p][k] * wn[p];
      v[K + 1] = wn[p] * wn[p];
    } else {
      v[0] += wn[p];
#pragma unroll
      for (int k = 0; k < K; ++k) v[1 + k] += hv[p][k] * wn[p];
      v[K + 1] += wn[p] * wn[p];
    }
  }
  ssme::block_sum<K + 2>(v, red);
  *s = v[0];
  *s2 = v[K + 1];
  *lse = m + logf(v[0]);
#pragma unroll
  for (int k = 0; k < K; ++k) fmean[k] = v[1 + k] / v[0];
  return m;
}

// the state and theta of this thread's particles moved jointly by anc
template <int S, int P, int kPer>
__device__ __forceinline__ void gather_joint(float (&x)[kPer][S],
                                             float (&th)[kPer][P],
                                             const int (&anc)[kPer],
                                             float* buf) {
  float v[kPer][S + P];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
#pragma unroll
    for (int l = 0; l < S; ++l) v[p][l] = x[p][l];
#pragma unroll
    for (int k = 0; k < P; ++k) v[p][S + k] = th[p][k];
  }
  ssme::gather_leaves_per<S + P, kPer>(v, anc, buf);
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
#pragma unroll
    for (int l = 0; l < S; ++l) x[p][l] = v[p][l];
#pragma unroll
    for (int k = 0; k < P; ++k) th[p][k] = v[p][S + k];
  }
}

// the joint (state, theta) resample of one filter, on the resample_every
// schedule or when its ESS falls below ess_limit; lw = 0 after it
template <int S, int P, int kPer>
__device__ __forceinline__ void maybe_resample(
    int t, const float (&wn)[kPer], float s, float s2, float ess_limit,
    int resample_every, int resampler, int metropolis_iters, uint32_t k0,
    uint32_t k1, uint32_t b, float (&x)[kPer][S], float (&th)[kPer][P],
    float (&lw)[kPer], float* cdf, float* buf, float* red) {
  const bool fire = ess_limit > 0.0f
                        ? s * s / s2 < ess_limit
                        : (resample_every == 1 ||
                           (t + 1) % resample_every == 0);
  if (!fire) return;
  int anc[kPer];
  ssme::roll_ancestors<kPer>(resampler, metropolis_iters, wn, cdf, red, k0,
                             k1, t, b, ssme::kTagRollSweep, anc);
  gather_joint<S, P, kPer>(x, th, anc, buf);
#pragma unroll
  for (int p = 0; p < kPer; ++p) lw[p] = 0.0f;
}

template <class Model, int kPer>
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
  __shared__ float cdf[kMaxThreads * kPer];
  __shared__ float buf[kMaxThreads * kPer];
  __shared__ float red[32 * kSums];
  __shared__ float chol[P * P];
  __shared__ float tbar[P];

  const uint32_t b = blockIdx.x;
  const uint32_t i = threadIdx.x;
  const uint32_t bd = blockDim.x;
  const int n = bd * kPer;
  const int num_filters = gridDim.x;
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(seed[1]);
  const Model model(args.model);
  const float log_n = logf(static_cast<float>(n));
  float* lcl_row = lcl + static_cast<size_t>(b) * num_steps;

  float y[Model::kDimObs];
  float z[Model::kDimCov > 0 ? Model::kDimCov : 1];
  float x[kPer][S], th[kPer][P];
  float lw[kPer], wn[kPer];
  float hv[kPer][K > 0 ? K : 1];   // the functionals of the step's particles
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
  float s, s2, lse;
  load_step<Model>(ys, zs, 0, y, z);
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const uint32_t j = p * bd + i;
    float cp[P];
#pragma unroll
    for (int blk = 0; blk < (P + 3) / 4; ++blk) {
      const float4 u = ssme::prior_uniforms_at(k0, k1, j, blk, b);
      const float uu[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int q = 0; q < 4 && 4 * blk + q < P; ++q) {
        const int k = 4 * blk + q;
        cp[k] = args.prior_lo[k] + args.prior_scale[k] * uu[q];
        th[p][k] = ssme::to_transformed(Model::code(k), cp[k]);
      }
    }
    ssme::StepRng rng{k0, k1, j, 0u, b, static_cast<uint32_t>(P)};
    model.init(rng, cp, y, z, x[p]);
    lw[p] = model.log_weight(cp, x[p], y, z);
#pragma unroll
    for (int k = 0; k < K; ++k) hv[p][k] = model.functional(k, cp, x[p]);
  }
  float m = weigh<K, kPer>(lw, hv, red, wn, &s, &s2, &lse, fmean);
  emit(0, lse - log_n);
#pragma unroll
  for (int p = 0; p < kPer; ++p) lw[p] = lw[p] - m;
  maybe_resample<S, P, kPer>(0, wn, s, s2, ess_limit, resample_every,
                             resampler, metropolis_iters, k0, k1, b, x, th,
                             lw, cdf, buf, red);

  for (int t = 1; t < num_steps; ++t) {
    load_step<Model>(ys, zs, t, y, z);
    // weighted shrinkage moments in two passes; lw has maximum 0
    float ww[kPer];
    float v1[1 + P];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      ww[p] = expf(lw[p]);
      if (p == 0) {
        v1[0] = ww[p];
#pragma unroll
        for (int k = 0; k < P; ++k) v1[1 + k] = th[p][k] * ww[p];
      } else {
        v1[0] += ww[p];
#pragma unroll
        for (int k = 0; k < P; ++k) v1[1 + k] += th[p][k] * ww[p];
      }
    }
    ssme::block_sum<1 + P>(v1, red);
    const float wsum = v1[0];
    // theta_bar goes to shared memory too (thread 0 writes it; the Gram's
    // barriers publish it): the shrinkage reads it there
    float tb[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      tb[k] = v1[1 + k] / wsum;
      if (i == 0) tbar[k] = tb[k];
    }
    float v2[kGram];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      float cen[P];
#pragma unroll
      for (int k = 0; k < P; ++k) cen[k] = th[p][k] - tb[k];
      int at = 0;
#pragma unroll
      for (int r = 0; r < P; ++r)
#pragma unroll
        for (int c = 0; c <= r; ++c, ++at) {
          const float term = (cen[r] * ww[p]) * cen[c];
          v2[at] = p == 0 ? term : v2[at] + term;
        }
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

    float lse_fs = 0.0f;
    if (apf) {
      float lfs[kPer];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        float cp[P], sh[P], look[S];
        constrain<Model>(th[p], cp);
        model.prop_mu(cp, x[p], y, z, look);
#pragma unroll
        for (int k = 0; k < P; ++k)
          sh[k] = args.a * th[p][k] + args.one_minus_a * tbar[k];
        constrain<Model>(sh, cp);
        lfs[p] = lw[p] + model.log_weight(cp, look, y, z);
      }
      float m_loc = lfs[0];
#pragma unroll
      for (int p = 1; p < kPer; ++p) m_loc = fmaxf(m_loc, lfs[p]);
      const float mfs = ssme::block_max(m_loc, red);
      float wfs[kPer];
#pragma unroll
      for (int p = 0; p < kPer; ++p) wfs[p] = expf(lfs[p] - mfs);
      float sfs[1] = {wfs[0]};
#pragma unroll
      for (int p = 1; p < kPer; ++p) sfs[0] += wfs[p];
      ssme::block_sum<1>(sfs, red);
      lse_fs = mfs + logf(sfs[0]);
      int anc[kPer];
      ssme::roll_ancestors<kPer>(resampler, metropolis_iters, wfs, cdf, red,
                                 k0, k1, t, b, ssme::kTagRollSelect, anc);
      gather_joint<S, P, kPer>(x, th, anc, buf);
    } else {
      __syncthreads();  // the Cholesky factor of thread 0
    }

#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const uint32_t j = p * bd + i;
      // the (ancestor's) shrunk theta, and under apf its lookahead density
      float sh[P], cp[P];
#pragma unroll
      for (int k = 0; k < P; ++k)
        sh[k] = args.a * th[p][k] + args.one_minus_a * tbar[k];
      float lg_look = 0.0f;
      if (apf) {
        float look[S];
        constrain<Model>(th[p], cp);
        model.prop_mu(cp, x[p], y, z, look);
        constrain<Model>(sh, cp);
        lg_look = model.log_weight(cp, look, y, z);
      }
      // kernel draws theta' = shrunk_anc + L e
#pragma unroll
      for (int r = 0; r < P; ++r) th[p][r] = sh[r];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float e = ssme::normal_at(k0, k1, j, t, b, k);
#pragma unroll
        for (int r = k; r < P; ++r) th[p][r] = th[p][r] + chol[r * P + k] * e;
      }
      constrain<Model>(th[p], cp);
      ssme::StepRng rng{k0, k1, j, static_cast<uint32_t>(t), b,
                        static_cast<uint32_t>(P)};
      if (apf) {
        model.propagate(rng, cp, x[p], y, z);
        lw[p] = model.log_weight(cp, x[p], y, z) - lg_look;
      } else if constexpr (Model::kHasProposal) {
        float xa[S];
#pragma unroll
        for (int l = 0; l < S; ++l) xa[l] = x[p][l];
        model.sample_q(rng, cp, xa, y, z, x[p]);
        lw[p] = lw[p] + (model.log_weight(cp, x[p], y, z) +
                         model.log_fq(cp, x[p], xa, y, z));
      } else {
        model.propagate(rng, cp, x[p], y, z);
        lw[p] = lw[p] + model.log_weight(cp, x[p], y, z);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) hv[p][k] = model.functional(k, cp, x[p]);
    }
    m = weigh<K, kPer>(lw, hv, red, wn, &s, &s2, &lse, fmean);
    emit(t, apf ? ((lse_fs - logf(wsum)) + lse) - log_n : lse - logf(wsum));
#pragma unroll
    for (int p = 0; p < kPer; ++p) lw[p] = lw[p] - m;
    maybe_resample<S, P, kPer>(t, wn, s, s2, ess_limit, resample_every,
                               resampler, metropolis_iters, k0, k1, b, x, th,
                               lw, cdf, buf, red);
  }

  const size_t rows = S + 1 + P;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    float* out = cloud + static_cast<size_t>(b) * rows * n + p * bd + i;
#pragma unroll
    for (int l = 0; l < S; ++l) out[l * n] = x[p][l];
    out[S * n] = lw[p];
#pragma unroll
    for (int k = 0; k < P; ++k) out[(S + 1 + k) * n] = th[p][k];
  }
}

template <class Model>
struct RunLarge {
  static int go(const LWLaunch& a, const LWArgs& args) {
#define SSME_LW_LAUNCH(K)                                                    \
  lw_megakernel<Model, K>                                                    \
      <<<a.num_filters, a.num_particles / K, 0, a.stream>>>(                 \
          a.seed, a.ys, a.zs, a.num_steps, a.apf, a.resample_every,         \
          a.ess_limit, a.resampler, a.metropolis_iters, args, a.lcl,        \
          a.fpaths, a.cloud)
    switch (a.num_particles) {
      case 2 * kMaxThreads: SSME_LW_LAUNCH(2); break;
      case 4 * kMaxThreads: SSME_LW_LAUNCH(4); break;
      default: return -3;
    }
#undef SSME_LW_LAUNCH
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

int dispatch_roll_large(int model_id, const LWLaunch& a,
                        const LWArgs& args) {
  return dispatch_model<RunLarge>(model_id, a, args);
}

}  // namespace ssme_lw
