"""The port's Liu-West kernel module (``ops/liu_west_megakernel.py``, K3,
and ``ops/svol_leverage_lw_kernel.py``, K4) against the JAX package, on
the CPU through the kernel's plain version."""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssme_tpu.ops.liu_west_megakernel as jlwm
import ssme_tpu.ops.svol_leverage_lw_kernel as jk4
from ssme_tpu.filters import LiuWestFilter as JaxLiuWestFilter
from ssme_tpu.models import svol_leverage as jlev
from ssme_tpu_torch.models import svol_leverage as lev
from ssme_tpu_torch.ops import _prng
from ssme_tpu_torch.ops import liu_west_megakernel as lwm
from ssme_tpu_torch.ops import svol_leverage_lw_kernel as k4

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "ssme_tpu_torch", "csrc")
INSTANCES = {"svol_leverage_lw": (lwm.svol_leverage_lw_kernel_model,
                                  jlwm.svol_leverage_lw_kernel_model),
             "svol_t_lw": (lwm.svol_t_lw_kernel_model,
                           jlwm.svol_t_lw_kernel_model)}


def _leverage_data(t_len, seed):
    rng = np.random.default_rng(seed)
    phi, mu, sigma, rho = 0.95, -0.1, 0.3, -0.6
    x, y_prev, ys = 0.0, 0.0, np.empty(t_len, np.float32)
    for t in range(t_len):
        x = (mu + phi * (x - mu) + y_prev * rho * sigma * math.exp(-x / 2)
             + sigma * math.sqrt(1 - rho * rho) * rng.normal())
        y_prev = math.exp(x / 2) * rng.normal()
        ys[t] = y_prev
    return ys, np.concatenate([[0.0], ys[:-1]]).astype(np.float32)


def _run(km, seed, ys, zs=None, **kw):
    return lwm.lw_megakernel(km, seed, torch.from_numpy(ys),
                             None if zs is None else torch.from_numpy(zs),
                             **kw)


class _StubRng:
    """Hands out the same numpy normals and uniforms to either package."""

    HALF_LOG_2PI = _prng.HALF_LOG_2PI

    def __init__(self, wrap, seed):
        self._wrap, self._rng = wrap, np.random.default_rng(seed)

    def normal(self, shape):
        return self._wrap(self._rng.normal(size=shape).astype(np.float32))

    def uniform(self, shape):
        return self._wrap(self._rng.uniform(size=shape).astype(np.float32))


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_instance_hooks_match_jax(name):
    """Every hook of each instance on the same inputs and the same random
    numbers, (P, 1, n) here against (P, n) in JAX, to 1e-6."""
    tmodel, jmodel = INSTANCES[name]
    tk, jk = tmodel(), jmodel()
    n = 64
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, n)).astype(np.float32)
    x[0, :2] = [-60.0, 45.0]                      # the clamp binds
    y, z = np.float32(0.7), np.float32(-2.5)
    ty, tz = (torch.tensor(y),), (torch.tensor(z),)
    jy, jz = (jnp.float32(y),), (jnp.float32(z),)

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got).reshape(-1),
                                   np.asarray(want).reshape(-1), rtol=1e-6,
                                   atol=1e-6)

    cp_t = tk.sample_prior(_StubRng(torch.from_numpy, 1), (1, n))
    cp_j = jk.sample_prior(_StubRng(jnp.asarray, 1), n)
    close(cp_t, cp_j)
    cp = np.asarray(cp_j)
    tcp, jcp = torch.from_numpy(cp.copy())[:, None], jnp.asarray(cp)
    close(tk.transform(tcp), jk.transform(jcp))
    close(tk.constrain(tk.transform(tcp)), jk.constrain(jk.transform(jcp)))
    close(tk.init(_StubRng(torch.from_numpy, 2), tcp, ty, (1, n))[0],
          jk.init(_StubRng(jnp.asarray, 2), jcp, jy, n)[0])
    tx, jx = (torch.from_numpy(x),), (jnp.asarray(x),)
    close(tk.propagate(_StubRng(torch.from_numpy, 4), tcp, tx, ty, tz)[0],
          jk.propagate(_StubRng(jnp.asarray, 4), jcp, jx, jy, jz)[0])
    close(tk.prop_mu(tcp, tx, ty, tz)[0], jk.prop_mu(jcp, jx, jy, jz)[0])
    close(tk.log_weight(tcp, tx, ty, tz), jk.log_weight(jcp, jx, jy, jz))
    for th, jh in zip(tk.functionals or (), jk.functionals or ()):
        close(th(tcp, tx), jh(jcp, jx))
    assert tk.num_params == jk.num_params
    assert tk.transform_codes == jk.transform_codes
    assert (tk.num_state, tk.dim_obs, tk.dim_cov) == (
        jk.num_state, jk.dim_obs, jk.dim_cov)


@pytest.mark.parametrize("code", ["null", "log", "logit", "twice_fisher"])
def test_transform_maps_match_jax(code):
    rng = np.random.default_rng(5)
    p = rng.uniform(0.02, 0.98, 200).astype(np.float32)
    z = rng.normal(size=200).astype(np.float32) * 3
    np.testing.assert_allclose(
        lwm._to_transformed(code, torch.from_numpy(p)).numpy(),
        np.asarray(jlwm._to_transformed(code, jnp.asarray(p))), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        lwm._to_constrained(code, torch.from_numpy(z)).numpy(),
        np.asarray(jlwm._to_constrained(code, jnp.asarray(z))), rtol=1e-6,
        atol=1e-6)
    with pytest.raises(ValueError, match="unknown transform code"):
        lwm._to_transformed("exp", torch.ones(2))


def test_floored_cholesky_matches_the_formula():
    """The unrolled Cholesky of h^2 G: numpy's factor for an SPD G, and the
    1e-9 diagonal floor (JAX's formula) for a singular one."""
    rng = np.random.default_rng(6)
    a = rng.normal(size=(4, 4))
    g = (a @ a.T + 0.1 * np.eye(4)).astype(np.float32)
    h2 = 0.0101
    rows = [[torch.tensor([[g[i, j]]]) for j in range(4)] for i in range(4)]
    lmat = lwm._cholesky(rows, h2, 4)
    got = np.array([[float(lmat[i][j]) if j <= i else 0.0 for j in range(4)]
                    for i in range(4)])
    np.testing.assert_allclose(got, np.linalg.cholesky(h2 * g.astype(
        np.float64)), rtol=1e-5, atol=1e-7)
    zero = [[torch.zeros(1, 1) for _ in range(4)] for _ in range(4)]
    lz = lwm._cholesky(zero, h2, 4)
    for i in range(4):
        assert float(lz[i][i]) == pytest.approx(math.sqrt(1e-9), rel=1e-6)
        for j in range(i):
            assert float(lz[i][j]) == 0.0


@pytest.mark.parametrize("variant", ["apf", "sisr"])
def test_plain_kernel_matches_jax_generic_filter_in_distribution(variant):
    """F=32 filters, N=256, T=100 of simulated leverage data: the plain K3
    and JAX's generic filter (systematic joint resampling) within 4
    combined standard errors.  The APF first stages differ (JAX's generic
    filter selects by multinomial sampling, the kernel systematically);
    at T=100 that does not show, at T=200 it does (4-5 nats, under the
    JAX package's own 8-nat bound for the pair)."""
    ys, zs = _leverage_data(100, 1)
    f = 32
    jf = JaxLiuWestFilter(jlev.make_model(), 256, variant=variant,
                          resampler="systematic")
    want = np.asarray(jax.jit(jax.vmap(lambda key: jf.run(
        key, jnp.asarray(ys[:, None]), jnp.asarray(zs[:, None]))
        .log_likelihood))(jax.random.split(jax.random.key(0), f)),
        np.float64)
    out = _run(lwm.svol_leverage_lw_kernel_model(), 0, ys, zs, num_filters=f,
               num_particles=256, variant=variant)
    got = out["log_likelihood"].double().numpy()
    assert np.isfinite(got).all()
    se = math.sqrt(got.var(ddof=1) / f + want.var(ddof=1) / f)
    assert abs(got.mean() - want.mean()) < 4 * se, (got.mean(), want.mean())
    # lcl sums to the total
    np.testing.assert_allclose(out["log_cond_likes"].sum(-1).numpy(),
                               out["log_likelihood"].numpy(), rtol=1e-6)
    params = lwm.lw_cloud_params(lwm.svol_leverage_lw_kernel_model(),
                                 out["cloud"])
    phi, mu, sigma, rho = params.unbind(-1)
    assert ((phi > 0) & (phi < 1)).all() and (sigma > 0).all()
    assert ((rho > -1) & (rho < 1)).all()


def test_decoders_match_jax_on_the_same_cloud():
    """The factory's and the leverage kernel's decoders against JAX's on
    one cloud, the JAX cloud carrying its two zero pad rows."""
    rng = np.random.default_rng(7)
    cloud = rng.normal(size=(3, 6, 128)).astype(np.float32)
    cloud[:, 1] *= 5
    padded = np.concatenate([cloud, np.zeros((3, 2, 128), np.float32)], 1)
    km, jkm = (lwm.svol_leverage_lw_kernel_model(),
               jlwm.svol_leverage_lw_kernel_model())
    tc, jc = torch.from_numpy(cloud), jnp.asarray(padded)
    for got, want in (
            (lwm.lw_cloud_params(km, tc), jlwm.lw_cloud_params(jkm, jc)),
            (lwm.lw_cloud_weights(km, tc), jlwm.lw_cloud_weights(jkm, jc)),
            (lwm.lw_cloud_states(km, tc), jlwm.lw_cloud_states(jkm, jc)),
            (k4.lw_cloud_params(tc), jk4.lw_cloud_params(jc)),
            (k4.lw_cloud_weights(tc), jk4.lw_cloud_weights(jc))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("t_len,kw,resampled", [
    (1, dict(), True),                        # t = 0 resamples at rs = 1
    (1, dict(resample_every=2), False),
    (3, dict(resample_every=3), True),        # (t + 1) % 3 == 0 at t = 2
    (4, dict(resample_every=3), False),
    (5, dict(ess_threshold=1.0), True),       # ESS < N whenever unequal
    (5, dict(ess_threshold=0.5 / 128), False),  # ESS >= 1: never fires
])
def test_resample_schedules(t_len, kw, resampled):
    """The joint resample leaves the cloud's log-weights at 0; without it
    they are the step's log-weights less their maximum."""
    ys, zs = _leverage_data(t_len, 8)
    for variant in ("apf", "sisr"):
        out = _run(lwm.svol_leverage_lw_kernel_model(), 3, ys, zs,
                   num_filters=2, num_particles=128, variant=variant, **kw)
        lw = out["cloud"][:, 1]
        assert torch.equal(lw == 0, torch.ones_like(lw, dtype=bool)) \
            == resampled
        assert torch.equal(lw.amax(-1), torch.zeros(2))


def test_svol_t_instance_and_its_functional_path():
    km = lwm.svol_t_lw_kernel_model(nu=5.0)
    rng = np.random.default_rng(9)
    ys = (0.3 * rng.normal(size=20)).astype(np.float32)
    for variant in ("apf", "sisr"):
        out = _run(km, 7, ys, num_filters=2, num_particles=128,
                   variant=variant, resample_every=4)
        assert out["log_cond_likes"].shape == (2, 20)
        assert torch.isfinite(out["log_cond_likes"]).all()
        np.testing.assert_allclose(out["log_cond_likes"].sum(-1).numpy(),
                                   out["log_likelihood"].numpy(), rtol=1e-6)
        assert out["cloud"].shape == (2, 5, 128)
        (path,) = out["functional_paths"]
        assert path.shape == (2, 20) and torch.isfinite(path).all()
        beta, phi, sigma = lwm.lw_cloud_params(km, out["cloud"]).unbind(-1)
        assert (beta > 0).all() and (sigma > 0).all()
        assert ((phi > -1) & (phi < 1)).all()
        w = lwm.lw_cloud_weights(km, out["cloud"])
        np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    # the filtered mean of x against its definition on the final step:
    # sum w x / sum w under the final (pre-resample) weights is not kept,
    # but with a schedule that never resamples the cloud's weights are them
    out = _run(km, 8, ys, num_filters=2, num_particles=128, variant="sisr",
               ess_threshold=0.5 / 128)
    w = lwm.lw_cloud_weights(km, out["cloud"])
    x = lwm.lw_cloud_states(km, out["cloud"])[:, 0]
    np.testing.assert_allclose(out["functional_paths"][0][:, -1].numpy(),
                               (w * x).sum(-1).numpy(), rtol=1e-4,
                               atol=1e-5)


def test_constant_functional_is_exactly_42_with_a_cpu_only_model():
    base = lwm.svol_t_lw_kernel_model(nu=5.0)
    km = lwm.LWKernelModel(
        num_params=base.num_params, transform_codes=base.transform_codes,
        sample_prior=base.sample_prior, init=base.init,
        propagate=base.propagate, log_weight=base.log_weight,
        prop_mu=base.prop_mu,
        functionals=(lambda cp, st: torch.full_like(st[0], 42.0),),
        name="svol_t_lw_const42")
    ys = (0.3 * np.random.default_rng(4).normal(size=20)).astype(np.float32)
    out = _run(km, 17, ys, num_filters=2, num_particles=128)
    np.testing.assert_allclose(out["functional_paths"][0].numpy(), 42.0,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="no CUDA instance"):
        lwm._model_id(km)


def test_validation_errors():
    km = lwm.svol_t_lw_kernel_model(nu=5.0)
    ys = torch.ones(8)
    with pytest.raises(ValueError, match="multiple of 32"):
        lwm.lw_megakernel(km, 0, ys, num_particles=100)
    with pytest.raises(ValueError, match="multiple of 32.*above 1024 use "
                       "resampler='metropolis'"):
        lwm.lw_megakernel(km, 0, ys, num_particles=2048)
    with pytest.raises(ValueError, match="dim_cov=0"):
        lwm.lw_megakernel(km, 0, ys, zs=torch.ones(8, 1), num_particles=128)
    km_lev = lwm.svol_leverage_lw_kernel_model()
    with pytest.raises(ValueError, match="needs covariates"):
        lwm.lw_megakernel(km_lev, 0, ys, num_particles=128)
    no_look = lwm.LWKernelModel(
        num_params=1, transform_codes=("null",),
        sample_prior=lambda rng, shape: rng.uniform((1,) + shape),
        init=lambda rng, cp, y, shape: (rng.normal(shape),),
        propagate=lambda rng, cp, st, y, z: st,
        log_weight=lambda cp, st, y, z: torch.zeros_like(st[0]))
    with pytest.raises(ValueError, match="prop_mu"):
        lwm.lw_megakernel(no_look, 0, ys, num_particles=128)
    assert torch.isfinite(lwm.lw_megakernel(
        no_look, 0, ys, num_particles=128, variant="sisr")[
        "log_likelihood"]).all()
    for kw, msg in ((dict(variant="bad"), "variant"),
                    (dict(resample_every=0), "resample_every"),
                    (dict(resampler="metropolis", num_particles=96),
                     "power of two"),
                    (dict(resampler="rejection", num_particles=8192),
                     "exceeds the metropolis cap 4096; use "
                     "filters.LiuWestFilter"),
                    (dict(resampler="metropolis", metropolis_iters=0),
                     "metropolis_iters"),
                    (dict(resampler="bad"), "unknown resampler"),
                    (dict(num_filters=0), "num_filters")):
        with pytest.raises(ValueError, match=msg):
            lwm.lw_megakernel(km, 0, ys, **dict(dict(num_particles=128),
                                                **kw))
    with pytest.raises(ValueError, match="transform_codes"):
        lwm.LWKernelModel(num_params=2, transform_codes=("null",),
                          sample_prior=None, init=None, propagate=None,
                          log_weight=None)
    with pytest.raises(ValueError, match="unknown transform code"):
        lwm.LWKernelModel(num_params=1, transform_codes=("exp",),
                          sample_prior=None, init=None, propagate=None,
                          log_weight=None)
    with pytest.raises(ValueError, match="together"):
        lwm.LWKernelModel(num_params=1, transform_codes=("null",),
                          sample_prior=None, init=None, propagate=None,
                          log_weight=None, sample_q=lambda *a: None)


@pytest.mark.parametrize("variant", ["apf", "sisr"])
def test_leverage_wrapper_is_the_k3_instance(variant):
    """K4's wrapper equals the K3 instance on lagged covariates, bit for
    bit (the Pallas pair's bit-compatibility)."""
    ys, zs = _leverage_data(40, 10)
    a = k4.svol_leverage_lw(13, torch.from_numpy(ys), num_filters=2,
                            num_particles=128, variant=variant)
    b = _run(lwm.svol_leverage_lw_kernel_model(), 13, ys, zs, num_filters=2,
             num_particles=128, variant=variant)
    for key in ("log_cond_likes", "log_likelihood", "cloud"):
        assert torch.equal(a[key], b[key]), key
    assert k4.svol_leverage_lw.launches == 0          # plain on the CPU
    bounds = ((0.5, 0.99), (-1.0, 1.0), (0.05, 0.5), (-0.9, 0.0))
    c = k4.svol_leverage_lw(13, torch.from_numpy(ys), num_filters=2,
                            num_particles=128, prior_bounds=bounds)
    p = k4.lw_cloud_params(c["cloud"])
    assert (p[..., 2] > 0).all() and torch.isfinite(c["log_likelihood"]).all()


def test_sim_future_obs_bridge():
    ys, zs = _leverage_data(16, 11)
    km = lwm.svol_leverage_lw_kernel_model()
    out = _run(km, 3, ys, zs, num_filters=2, num_particles=128)
    fut = lwm.lw_kernel_sim_future_obs(
        km, lev.make_model(), out["cloud"], torch.Generator().manual_seed(1),
        num_steps=4, last_obs=torch.tensor([float(ys[-1])]))
    assert fut.shape == (2, 4, 128, 1) and torch.isfinite(fut).all()
    with pytest.raises(ValueError, match="last_obs"):
        lwm.lw_kernel_sim_future_obs(km, lev.make_model(), out["cloud"],
                                     torch.Generator(), num_steps=2)


def test_prior_uniform_and_select_offset_streams():
    """Prior uniform k of particle i is word k & 3 of counter (i, k >> 2,
    b, 2^31); the first-stage offsets use tag 2^31 + 1.  The header holds
    the same tags."""
    seed = _prng.seed_words(99)
    u = _prng.prior_uniforms(seed, torch.arange(3), 64, 6)
    assert u.shape == (6, 3, 64)
    assert ((u >= 0) & (u < 1)).all()
    k0, k1 = seed[0], seed[1]
    for k, b, i in ((0, 0, 0), (3, 2, 17), (4, 1, 63), (5, 2, 5)):
        words = _prng.philox4x32_10(torch.tensor(i), torch.tensor(k >> 2),
                                    torch.tensor(b),
                                    torch.tensor(_prng.TAG_PRIOR_UNIFORM),
                                    k0, k1)
        assert float(u[k, b, i]) == float(
            _prng.uniform_closed_zero(words[k & 3]))
    sel = _prng.offsets_steps(seed, torch.arange(3), torch.arange(4),
                              tag=_prng.TAG_SELECT_OFFSET)
    res = _prng.offsets_steps(seed, torch.arange(3), torch.arange(4))
    assert not torch.equal(sel, res)
    src = open(os.path.join(CSRC, "philox.cuh")).read()
    tags = {name: int(v, 16) for name, v in re.findall(
        r"constexpr uint32_t (kTag\w+) = 0x([0-9A-Fa-f]+)u;", src)}
    assert tags == {"kTagPriorUniform": _prng.TAG_PRIOR_UNIFORM,
                    "kTagSelectOffset": _prng.TAG_SELECT_OFFSET,
                    "kTagRollSweep": _prng.TAG_ROLL_SWEEP,
                    "kTagRollSelect": _prng.TAG_ROLL_SELECT}
    # the roll resamplers' sweep tags stay clear of every other stream
    roll = [range(t, t + _prng.ROLL_MAX_ITERS)
            for t in (_prng.TAG_ROLL_SWEEP, _prng.TAG_ROLL_SELECT)]
    for tag in (0, 1, 2, _prng.normal_tag(2 ** 31 - 3),
                _prng.TAG_PRIOR_UNIFORM, _prng.TAG_SELECT_OFFSET):
        assert all(tag not in r for r in roll)
    assert roll[0][-1] < roll[1][0] and roll[1][-1] < 2 ** 32
    with pytest.raises(ValueError):
        _prng.normal_tag(2 ** 31)


def test_model_ids_and_transform_codes_match_the_cuda_header():
    """The dispatch ids, each functor's traits and its transform codes are
    written once in csrc/lw_models.cuh; the Python side reads the same."""
    src = open(os.path.join(CSRC, "lw_models.cuh")).read()
    ids = {name: int(num) for num, name in re.findall(
        r"constexpr int kLWModel\w+ = (\d+);\s*// \"(\w+)\"", src)}
    assert ids == lwm.CUDA_LW_MODEL_IDS
    names = {f"kTrans{''.join(w.title() for w in c.split('_'))}": c
             for c in lwm._CODES}
    codes = {inst: tuple(names[c] for c in re.findall(r"kTrans\w+", body))
             for inst, body in re.findall(
                 r"codes\[kNumParams\] = \{\s*// \"(\w+)\"(.*?)\};", src,
                 re.S)}
    structs = dict(re.findall(r"struct (\w+LW) \{(.*?)\n\};", src, re.S))
    cuh = open(os.path.join(CSRC, "lw_megakernel.cuh")).read()
    dispatch = dict(re.findall(
        r"case ssme::(kLWModel\w+):\s*return Run<ssme::(\w+)>::go", cuh))
    assert len(dispatch) == len(ids) == len(codes) == len(structs)
    factories = {inst: tmodel for inst, (tmodel, _) in INSTANCES.items()}
    factories["svol_leverage_lw_q"] = lwm.svol_leverage_lw_q_kernel_model
    assert set(factories) == set(ids)
    for inst, tmodel in factories.items():
        km = tmodel()
        assert km.cuda_instance == inst
        assert codes[inst] == km.transform_codes
        const = re.search(rf"constexpr int (kLWModel\w+) = "
                          rf"{ids[inst]};", src).group(1)
        traits = {k: int(v) for k, v in re.findall(
            r"static constexpr int (k\w+) = (\d+);", structs[dispatch[const]])}
        assert traits == {"kNumParams": km.num_params,
                          "kNumState": km.num_state,
                          "kDimObs": km.dim_obs, "kDimCov": km.dim_cov,
                          "kNumFunctionals": len(km.functionals or ())}
        proposal = re.search(r"static constexpr bool kHasProposal = "
                             r"(true|false);", structs[dispatch[const]])
        assert (proposal.group(1) == "true") == (km.sample_q is not None)


@pytest.mark.parametrize("resampler", ["metropolis", "rejection"])
def test_roll_resamplers_match_jax_generic_filter_in_distribution(resampler):
    """F=32 filters, N=256, T=64, APF: the plain K3 under each roll
    resampler (first stage and joint resample) against JAX's generic
    filter with systematic joint resampling, within 4 combined standard
    errors (Metropolis, 32 sweeps: plus its bias envelope)."""
    from ssme_tpu_torch.ops._select import metropolis_bias_estimate
    ys, zs = _leverage_data(64, 2)
    f, iters = 32, 32
    jf = JaxLiuWestFilter(jlev.make_model(), 256, variant="apf",
                          resampler="systematic")
    want = np.asarray(jax.jit(jax.vmap(lambda key: jf.run(
        key, jnp.asarray(ys[:, None]), jnp.asarray(zs[:, None]))
        .log_likelihood))(jax.random.split(jax.random.key(1), f)),
        np.float64)
    out = _run(lwm.svol_leverage_lw_kernel_model(), 3, ys, zs, num_filters=f,
               num_particles=256, resampler=resampler, metropolis_iters=iters)
    got = out["log_likelihood"].double().numpy()
    assert np.isfinite(got).all()
    se = math.sqrt(got.var(ddof=1) / f + want.var(ddof=1) / f)
    slack = (metropolis_bias_estimate(iters, 64, 1.0)
             if resampler == "metropolis" else 0.0)
    assert abs(got.mean() - want.mean()) <= 4 * se + slack


def test_plain_kernel_at_2048_matches_jax_generic_filter_under_rejection():
    """F=8 filters, N=2048 (the kernel's two particles per thread), T=40,
    APF: the plain K3 under the rejection resampler within 4 combined
    standard errors of JAX's generic LiuWestFilter."""
    ys, zs = _leverage_data(40, 12)
    f, n = 8, 2048
    jf = JaxLiuWestFilter(jlev.make_model(), n, variant="apf",
                          resampler="systematic")
    want = np.asarray(jax.jit(jax.vmap(lambda key: jf.run(
        key, jnp.asarray(ys[:, None]), jnp.asarray(zs[:, None]))
        .log_likelihood))(jax.random.split(jax.random.key(2), f)),
        np.float64)
    out = _run(lwm.svol_leverage_lw_kernel_model(), 5, ys, zs, num_filters=f,
               num_particles=n, resampler="rejection")
    got = out["log_likelihood"].double().numpy()
    assert np.isfinite(got).all()
    se = math.sqrt(got.var(ddof=1) / f + want.var(ddof=1) / f)
    assert abs(got.mean() - want.mean()) <= 4 * se


def _jax_q_hooks(kappa):
    """The svol_leverage_lw_q proposal written for JAX's lw_megakernel."""
    clamp = jlev.STATE_CLAMP

    def mean_sd(cp, x, z):
        phi, mu, sig, rho = cp[0:1], cp[1:2], cp[2:3], cp[3:4]
        m = jnp.clip(mu + phi * (x - mu) + z[0] * rho * sig
                     * jnp.exp(-0.5 * x), -clamp, clamp)
        return m, sig * jnp.sqrt(1.0 - rho * rho)

    def sample_q(rng, cp, state, y, z):
        m, sd = mean_sd(cp, state[0], z)
        return (m + (kappa * sd) * rng.normal(state[0].shape),)

    def log_fq(cp, new_state, state, y, z):
        m, sd = mean_sd(cp, state[0], z)
        d = new_state[0] - m
        sq = kappa * sd
        ef, eq = d / sd, d / sq
        return (-jnp.log(sd) - 0.5 * ef * ef) - (-jnp.log(sq)
                                                 - 0.5 * eq * eq)

    return sample_q, log_fq


def test_q_instance_hooks_match_jax_and_run_in_jax_lw_megakernel():
    """The svol_leverage_lw_q hooks against the same proposal written for
    JAX, on the same inputs and numbers to 1e-6; JAX's lw_megakernel built
    with them runs its SISR form (interpret mode, as
    tests/test_lw_megakernel.py runs the kernels; its random bits are a
    stub there, so the numbers are not compared), and so does the port's
    plain version."""
    import dataclasses
    kappa = 1.5
    tk = lwm.svol_leverage_lw_q_kernel_model(kappa)
    sample_q, log_fq = _jax_q_hooks(kappa)
    jk = dataclasses.replace(jlwm.svol_leverage_lw_kernel_model(),
                             sample_q=sample_q, log_fq=log_fq,
                             name="svol_leverage_lw_q")
    n = 64
    rng = np.random.default_rng(13)
    cp = np.stack([rng.uniform(0.5, 0.99, n), rng.uniform(-1, 1, n),
                   rng.uniform(0.05, 0.5, n),
                   rng.uniform(-0.9, 0.0, n)]).astype(np.float32)
    x = rng.normal(size=(1, n)).astype(np.float32)
    x[0, :2] = [-60.0, 45.0]                      # the clamp binds
    z = np.float32(-1.3)
    tcp, jcp = torch.from_numpy(cp)[:, None], jnp.asarray(cp)
    tz, jz = (torch.tensor(z),), (jnp.float32(z),)
    tx, jx = (torch.from_numpy(x),), (jnp.asarray(x),)
    got = tk.sample_q(_StubRng(torch.from_numpy, 3), tcp, tx, None, tz)[0]
    want = jk.sample_q(_StubRng(jnp.asarray, 3), jcp, jx, None, jz)[0]
    np.testing.assert_allclose(got.numpy().reshape(-1),
                               np.asarray(want).reshape(-1), rtol=1e-6,
                               atol=1e-6)
    new = (got,), (jnp.asarray(got.numpy()),)
    np.testing.assert_allclose(
        tk.log_fq(tcp, new[0], tx, None, tz).numpy().reshape(-1),
        np.asarray(jk.log_fq(jcp, new[1], jx, None, jz)).reshape(-1),
        rtol=1e-5, atol=1e-5)
    ys, zs = _leverage_data(16, 14)
    out = jlwm.lw_megakernel(jk, 3, jnp.asarray(ys), jnp.asarray(zs),
                             num_filters=1, num_particles=128,
                             variant="sisr", interpret=True)
    assert np.isfinite(np.asarray(out["log_cond_likes"])).all()
    port = _run(tk, 3, ys, zs, num_filters=2, num_particles=128,
                variant="sisr")
    assert port["log_cond_likes"].shape == (2, 16)
    assert torch.isfinite(port["log_likelihood"]).all()


def test_q_instance_at_kappa_one_is_the_sisr_path_and_unbiased_above():
    """At kappa 1 the proposal is the transition and log f - log q = 0: the
    plain K3 equals the leverage instance's SISR run bit for bit; at kappa
    1.5 its evidence lies within 4 combined standard errors of that
    run's (the proposal's correction keeps it unbiased); APF ignores the
    proposal, as in JAX; the CUDA model checks."""
    ys, zs = _leverage_data(50, 15)
    base = lwm.svol_leverage_lw_kernel_model()
    kw = dict(num_filters=16, num_particles=256, variant="sisr")
    a = _run(lwm.svol_leverage_lw_q_kernel_model(1.0), 4, ys, zs, **kw)
    b = _run(base, 4, ys, zs, **kw)
    for key in ("log_cond_likes", "cloud"):
        assert torch.equal(a[key], b[key]), key
    c = _run(lwm.svol_leverage_lw_q_kernel_model(1.5), 5, ys, zs, **kw)
    got, want = (c["log_likelihood"].double().numpy(),
                 b["log_likelihood"].double().numpy())
    se = math.sqrt(got.var(ddof=1) / 16 + want.var(ddof=1) / 16)
    assert abs(got.mean() - want.mean()) <= 4 * se
    apf = dict(num_filters=2, num_particles=128, variant="apf")
    assert torch.equal(
        _run(lwm.svol_leverage_lw_q_kernel_model(1.5), 6, ys, zs, **apf)[
            "log_cond_likes"],
        _run(base, 6, ys, zs, **apf)["log_cond_likes"])
    import dataclasses
    q = lwm.svol_leverage_lw_q_kernel_model()
    hooked = dataclasses.replace(base, sample_q=q.sample_q, log_fq=q.log_fq)
    with pytest.raises(ValueError, match="disagree on a SISR proposal"):
        lwm._model_id(hooked)
    assert lwm._model_id(lwm.svol_leverage_lw_q_kernel_model()) == 2
    with pytest.raises(ValueError, match="kappa"):
        lwm.svol_leverage_lw_q_kernel_model(0.0)


@pytest.mark.parametrize("num_filters,max_clusters,want", [
    (8, 66, "paired"), (64, 66, "paired"), (66, 66, "paired"),
    (67, 66, "single"), (128, 66, "single"), (1, 1, "paired"),
    (8, 0, "single"), (1, 0, "single")])
def test_layout_rule_pairs_only_what_the_card_holds(num_filters,
                                                    max_clusters, want):
    """A systematic launch takes the paired layout iff the card holds all
    its filters' clusters at once; with a count of 0, one CTA a filter."""
    assert lwm.layout_for(num_filters, max_clusters) == want
    assert want in lwm.LAYOUTS


def test_plain_version_counts_no_layout():
    """On the CPU the plain version runs: no launch, no layout counted."""
    ys, zs = _leverage_data(12, 3)
    before = dict(lwm.lw_megakernel.layouts)
    _run(lwm.svol_leverage_lw_kernel_model(), 1, ys, zs, num_filters=2,
         num_particles=64)
    assert lwm.lw_megakernel.layouts == before
    assert set(before) == set(lwm.LAYOUTS)


def test_span_record_keeps_the_ring_fields_in_the_enum_order():
    """The twins' record reads the ring's wait as the last part of a step
    and the CTAs a filter after the threads, where LWSpan has them."""
    src = open(os.path.join(CSRC, "lw_megakernel_sys.cuh")).read()
    enum = re.search(r"enum LWSpan \{(.*?)\};", src, re.S).group(1)
    names = [e.strip() for e in enum.split(",") if e.strip()]
    assert names[len(lwm.SPAN_PARTS) - 1] == "kLWSpanRingWait"
    assert names[-2:] == ["kLWSpanCluster", "kNumLWSpans"]
    assert lwm.SPAN_PARTS[-1] == "ring_wait"
    assert lwm.SPAN_RECORD[-3:] == ("kper", "threads", "cluster")
    assert len(names) - 1 == len(lwm.SPAN_RECORD)


def _c_params(src, name):
    """The parameters of the C entry ``name`` in a source."""
    body = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src,
                     re.S).group(1)
    return [p.strip() for p in body.split(",")]


def test_c_entries_take_the_cluster_size_where_ctypes_passes_it():
    """ssme_lw_megakernel and its twin's entry take the CTAs a filter
    after metropolis_iters, and ctypes binds every Liu-West entry with as
    many arguments as the source declares."""
    from ssme_tpu_torch.ops import _cuda
    src = open(os.path.join(CSRC, "lw_megakernel.cu")).read()
    for name in ("ssme_lw_megakernel", "ssme_lw_megakernel_spans"):
        params = _c_params(src, name)
        at = params.index("int metropolis_iters")
        assert params[at + 1] == "int cluster", name
        assert len(params) == len(_cuda._SIGNATURES[name]), name
    params = _c_params(src, "ssme_lw_megakernel_clusters")
    assert params == ["int model_id", "int num_particles", "int* count"]
    assert len(_cuda._SIGNATURES["ssme_lw_megakernel_clusters"]) == 3


@pytest.mark.parametrize("n", [32, 96, 512, 1024])
def test_paired_ring_fits_a_block_and_keeps_an_sm_to_each_cta(n):
    """Each CTA of the paired layout takes more than half an H100 SM's
    228 KB of shared memory, so no SM holds two of a launch's CTAs, and
    rank 0's ring of kRingSlots steps (P + kDraws normal pairs a thread,
    the offsets, the barriers) fits inside that floor for every functor,
    so each CTA's dynamic shared memory is the floor at every N.  Whether
    the floor and the row's static arrays fit a block the card says: its
    launch, and chip_smoke phase 2 from ptxas' figures."""
    ring_src = open(os.path.join(CSRC, "lw_ring.cuh")).read()
    slots = int(re.search(r"constexpr int kRingSlots = (\d+);",
                          ring_src).group(1))
    floor = 1024 * int(re.search(
        r"constexpr int kPairFloorBytes = (\d+) \* 1024;", ring_src).group(1))
    assert 2 <= slots <= 4 and 228 * 1024 // 2 < floor <= 232448
    models = open(os.path.join(CSRC, "lw_models.cuh")).read()
    structs = dict(re.findall(r"struct (\w+LW) \{(.*?)\n\};", models, re.S))
    threads = -(-n // 2 // 32) * 32
    for kmodel in (lwm.svol_leverage_lw_kernel_model(),
                   lwm.svol_t_lw_kernel_model(),
                   lwm.svol_leverage_lw_q_kernel_model()):
        body = next(b for b in structs.values()
                    if f'"{kmodel.cuda_instance}"' in b)
        traits = dict(re.findall(r"static constexpr int (k\w+) = (\w+);",
                                 body))
        draws = kmodel.num_params + int(traits.get(traits["kDraws"],
                                                   traits["kDraws"]))
        ring = 16 * slots + 8 * slots * (1 + draws * threads)
        assert ring <= floor, (kmodel.name, n, ring)
