"""The port's generic filter bank (``ssme_tpu_torch/ops/filter_megakernel.py``)
against the JAX package.

On the CPU ``filter_megakernel`` runs its plain version, which calls the
model hooks step by step with the CUDA kernel's Philox bits;
``test_torch_kernels_cuda.py`` holds the kernel itself to that plain
version on a card.
"""

import dataclasses
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu.filters import replicated_log_like_fn as jax_bank
from ssme_tpu.models import svol_leverage as jlev
from ssme_tpu.ops import filter_megakernel as jfm
from ssme_tpu_torch.ops import _prng
from ssme_tpu_torch.ops import filter_megakernel as fm
from ssme_tpu_torch.ops.svol_filter_kernel import svol_filter_reference

torch.set_num_threads(1)

THETA = (0.9, 0.0, 0.15, -0.3)        # (phi, mu, sigma, rho)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _simulate_leverage(t_len, seed=0, theta=THETA):
    """SPY-like returns from the leverage model itself (float64 numpy)."""
    rng = np.random.default_rng(seed)
    phi, mu, sigma, rho = theta
    x = rng.normal() * sigma / math.sqrt(1 - phi * phi)
    ys, y_prev = np.empty(t_len, np.float32), 0.0
    for t in range(t_len):
        if t:
            x = (mu + phi * (x - mu) + y_prev * rho * sigma * math.exp(-x / 2)
                 + sigma * math.sqrt(1 - rho * rho) * rng.normal())
        ys[t] = math.exp(x / 2) * rng.normal()
        y_prev = ys[t]
    return ys


def _lagged(ys):
    return np.concatenate([[0.0], ys[:-1]]).astype(np.float32)


def _rows(b, theta=THETA):
    return torch.tensor([theta] * b)


@pytest.mark.parametrize("schedule", ["every_step", "ess_half",
                                      "ess_half_g8"])
def test_leverage_plain_matches_jax_bank_in_distribution(schedule):
    """64 rows, N=256, T=200 of the leverage model: mean log-likelihoods
    within 4 combined standard errors of the JAX generic bank (every
    step against every step; the ESS-0.5 schedules against ESS 0.5)."""
    rows, n = 64, 256
    ys = _simulate_leverage(200)
    zs = _lagged(ys)
    ess, g = {"every_step": (1.0, 1), "ess_half": (0.5, 1),
              "ess_half_g8": (0.5, 8)}[schedule]
    bank = jax_bank(jlev.make_model(), n, 1,
                    ess_threshold=None if ess >= 1.0 else ess)
    want = np.asarray(bank(jax.random.key(1),
                           jnp.tile(jnp.asarray(THETA), (rows, 1)),
                           jnp.asarray(ys)[:, None],
                           jnp.asarray(zs)[:, None]))
    got, _, _ = fm.filter_megakernel_reference(
        fm.svol_leverage_kernel_model(), 3, _rows(rows),
        torch.from_numpy(ys), torch.from_numpy(zs), num_particles=n,
        ess_threshold=ess, gate_stride=g)
    got = got.double().numpy()
    se = math.sqrt(got.var(ddof=1) / rows + want.var(ddof=1) / rows)
    assert np.isfinite(got).all()
    assert abs(got.mean() - want.mean()) < 4 * se, (got.mean(), want.mean())


@pytest.mark.parametrize("gate_stride", [1, 8])
def test_svol_instance_consumes_the_svol_kernels_bits(gate_stride):
    """A gate that never fires: the svol instance and the SVOL filter run
    the same recursion on the same bits; totals and means to 1e-4."""
    rng = np.random.default_rng(2)
    ys = torch.from_numpy((0.8 * rng.normal(size=150)).astype(np.float32))
    params = torch.tensor([[1.0, 0.9, math.sqrt(0.05)]] * 8
                          + [[0.8, 0.5, 0.3]] * 8)
    kw = dict(num_particles=128, ess_threshold=1e-6, gate_stride=gate_stride)
    tot, lcl, fmean = fm.filter_megakernel(fm.svol_kernel_model(), 5,
                                           params, ys, **kw)
    tot1, lcl1, xm1 = svol_filter_reference(5, params, ys, **kw)
    torch.testing.assert_close(tot, tot1, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lcl, lcl1, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fmean, xm1, rtol=1e-4, atol=1e-4)


def test_gate_stride_check_columns_match_pallas():
    """T=19, g=4, a gate that never fires: the check columns are the
    Pallas kernel's (interpret mode), the stride-4 totals equal the
    stride-1 totals to rounding (2e-4), and sum(lcl) == total."""
    ys = 0.3 * torch.ones(19)
    zs = torch.from_numpy(_lagged(ys.numpy()))
    params = _rows(8)
    km = fm.svol_leverage_kernel_model()
    kw = dict(num_particles=128, ess_threshold=1e-6)
    tot1, _, _ = fm.filter_megakernel(km, 3, params, ys, zs, **kw)
    tot4, lcl4, fm4 = fm.filter_megakernel(km, 3, params, ys, zs,
                                           gate_stride=4, **kw)
    torch.testing.assert_close(tot4, tot1, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(lcl4.sum(-1), tot4, rtol=1e-5, atol=1e-5)
    _, jl4, jf4 = jfm.filter_megakernel(
        jfm.svol_leverage_kernel_model(), 3,
        jnp.tile(jnp.asarray([THETA]), (8, 1)), jnp.asarray(ys.numpy()),
        jnp.asarray(zs.numpy()), num_particles=128, interpret=True,
        steps_per_cell=8, ess_threshold=1e-6, gate_stride=4)
    port_cols = sorted(set(np.nonzero(lcl4.numpy())[1].tolist()))
    jax_cols = sorted(set(np.nonzero(np.asarray(jl4))[1].tolist()))
    assert port_cols == jax_cols == [3, 7, 11, 15, 18]
    assert sorted(set(np.nonzero(fm4.numpy())[1].tolist())) == port_cols
    assert sorted(set(np.nonzero(np.asarray(jf4))[1].tolist())) == port_cols


def test_ragged_tail_at_t131_keeps_every_step():
    """T=131, g=8 (the Pallas kernel's padded-step wipe): the port loops
    to T exactly, so with a gate that never fires its totals equal its
    own stride-1 totals, and the last check column is 130."""
    ys = _simulate_leverage(131, seed=4)
    kw = dict(num_particles=64, ess_threshold=1e-6)
    args = (fm.svol_leverage_kernel_model(), 5, _rows(8),
            torch.from_numpy(ys), torch.from_numpy(_lagged(ys)))
    tot1, lcl1, _ = fm.filter_megakernel(*args, **kw)
    tot8, lcl8, _ = fm.filter_megakernel(*args, gate_stride=8, **kw)
    torch.testing.assert_close(tot8, tot1, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(lcl1.sum(-1), tot1, rtol=1e-5, atol=1e-5)
    cols = sorted(set(np.nonzero(lcl8.numpy())[1].tolist()))
    assert cols == list(range(7, 131, 8)) + [130]


def test_return_cloud_is_the_state_after_the_last_step():
    """The cloud is the last step's state: its weighted mean is the last
    functional mean, and the weights are max-normalised."""
    ys = _simulate_leverage(40, seed=6)
    tot, lcl, fmean, cloud, clw = fm.filter_megakernel(
        fm.svol_leverage_kernel_model(), 2, _rows(4), torch.from_numpy(ys),
        torch.from_numpy(_lagged(ys)), num_particles=64, ess_threshold=0.5,
        return_cloud=True)
    assert len(cloud) == 1 and cloud[0].shape == clw.shape == (4, 64)
    w = torch.exp(clw)
    torch.testing.assert_close(clw.amax(-1), torch.zeros(4))
    torch.testing.assert_close((cloud[0] * w).sum(-1) / w.sum(-1),
                               fmean[:, -1], rtol=1e-5, atol=1e-5)


def _two_draw_model():
    """A custom model whose propagate draws two normals per step."""
    def init(rng, p, y, z, shape):
        return (rng.normal(shape),)

    def propagate(rng, p, state, y, z):
        (x,) = state
        return (0.5 * x + 0.3 * rng.normal(x.shape)
                + 0.4 * rng.normal(x.shape),)

    def log_weight(p, state, y, z):
        return -0.5 * (y[0] - state[0]) ** 2

    return fm.KernelModel(num_params=1, init=init, propagate=propagate,
                          log_weight=log_weight, name="two_draws")


def test_custom_model_runs_on_the_cpu_with_per_draw_tags():
    """A hook's second normal is draw 1 of the step (its own counter tag,
    ``_prng.normal_tag``); the first is draw 0, the SVOL kernel's."""
    assert [_prng.normal_tag(k) for k in range(4)] == [0, 3, 4, 5]
    seed = _prng.seed_words(9)
    rows, steps = torch.arange(2), torch.arange(3)
    z0 = _prng.normals_steps(seed, rows, steps, 32)
    z1 = _prng.normals_steps(seed, rows, steps, 32, draw=1)
    assert not torch.equal(z0, z1)
    rng = _prng.StepBlocks(seed, rows, 32, 3).at(2)
    torch.testing.assert_close(rng.normal((2, 32)), z0[2], rtol=0, atol=0)
    torch.testing.assert_close(rng.normal((2, 32)), z1[2], rtol=0, atol=0)
    with pytest.raises(ValueError, match="one normal per particle"):
        rng.normal((2, 16))
    # the filter itself: N(0,1) init, every step checked
    out = fm.filter_megakernel(_two_draw_model(), 9, torch.zeros(2, 1),
                               torch.zeros(3), num_particles=32)
    assert torch.isfinite(out[0]).all()


def test_wrapper_validation():
    lev, sv = fm.svol_leverage_kernel_model(), fm.svol_kernel_model()
    p, ys, zs = _rows(8), torch.ones(16), torch.ones(16)
    base = dict(kmodel=lev, seed=0, params=p, ys=ys, zs=zs, num_particles=64)
    no_look = fm.KernelModel(4, lev.init, lev.propagate, lev.log_weight,
                             dim_cov=1)
    for bad in [dict(params=torch.ones(8, 3)),
                dict(zs=None), dict(kmodel=sv, params=torch.ones(8, 3)),
                dict(zs=torch.ones(15)), dict(zs=torch.ones(16, 2)),
                dict(ys=torch.ones(16, 2)), dict(params=p.double()),
                dict(params=torch.ones(4, 8).T),
                dict(num_particles=100), dict(num_particles=2048),
                dict(seed=torch.zeros(3, dtype=torch.int64)),
                dict(gate_stride=4, ess_threshold=1.0),
                dict(gate_stride=0, ess_threshold=0.5),
                dict(mode="apf", gate_stride=4, ess_threshold=0.5),
                dict(mode="apf", kmodel=no_look), dict(mode="smc"),
                dict(resampler="metropolis", num_particles=96),
                dict(resampler="rejection", num_particles=8192),
                dict(resampler="rejection", num_particles=16),
                dict(resampler="metropolis", metropolis_iters=0),
                dict(resampler="multinomial")]:
        kw = dict(base)
        kw.update(bad)
        with pytest.raises(ValueError):
            fm.filter_megakernel(**kw)
    with pytest.raises(ValueError, match="power of two"):
        fm.filter_megakernel(**dict(base, resampler="metropolis",
                                    num_particles=96))
    for resampler in ("metropolis", "rejection"):
        tot, _, _ = fm.filter_megakernel(**dict(base, resampler=resampler))
        assert torch.isfinite(tot).all()
    with pytest.raises(ValueError, match="large-N bridge"):
        fm.megakernel_log_like(lev, 2048, 2)
    with pytest.raises(ValueError, match="no CUDA instance"):
        fm._model_id(_two_draw_model())
    with pytest.raises(ValueError, match="only as a functor's own"):
        fm._model_id(dataclasses.replace(
            lev, functionals=(lambda p_, st: st[0],)))
    with pytest.raises(ValueError, match="3, 4, 5 assets"):
        fm._model_id(fm.factor_svol_kernel_model(6))


def test_apf_mode_runs_every_instance_with_a_lookahead():
    """mode="apf" on CPU tensors for each instance that has prop_mu (the
    JAX package's interpret tests), finite totals and sum(lcl) == total;
    the factor instance has none and raises."""
    ys = _simulate_leverage(24, seed=3)
    counts = torch.poisson(torch.full((24,), 3.0),
                           generator=torch.Generator().manual_seed(0))
    cases = [(fm.svol_kernel_model(), torch.tensor([[1.0, 0.5, 0.1]] * 8),
              torch.from_numpy(ys), None),
             (fm.svol_leverage_kernel_model(), _rows(8),
              torch.from_numpy(ys), torch.from_numpy(_lagged(ys))),
             (fm.svol_t_kernel_model(), fm.svol_t_param_rows(
                 torch.tensor([[1.0, 0.9, 0.04, 5.0]] * 8)),
              torch.from_numpy(ys), None),
             (fm.poisson_ar_kernel_model(),
              torch.tensor([[0.9, 1.0, 0.3]] * 8),
              fm.poisson_obs_rows(counts), None)]
    for km, rows, y, z in cases:
        tot, lcl, fmean = fm.filter_megakernel(km, 5, rows, y, z,
                                               num_particles=128, mode="apf")
        assert bool(torch.isfinite(tot).all()), km.name
        torch.testing.assert_close(lcl.sum(-1), tot, rtol=1e-5, atol=1e-4)
        assert fmean.shape == lcl.shape == (8, y.shape[0])
    fac = fm.factor_svol_kernel_model(3)
    with pytest.raises(ValueError, match="prop_mu"):
        fm.filter_megakernel(fac, 5, torch.ones(8, fac.num_params),
                             torch.zeros(10, 3), num_particles=64,
                             mode="apf")


def _law_model(functionals=None):
    """Deterministic cloud x_i = i / n, identity propagation and
    lookahead, weights exp(3x) at y = 1 and flat at y = 0 (the law and
    vector-functional models of JAX's test_filter_megakernel.py)."""
    n = 256

    def init(rng, p, y, z, shape):
        i = torch.arange(shape[1], dtype=torch.float32).expand(shape)
        return (i / float(n),)

    def propagate(rng, p, state, y, z):
        return state

    def log_weight(p, state, y, z):
        (x,) = state
        return torch.where(y[0] > 0.5, 3.0 * x, torch.zeros_like(x))

    return fm.KernelModel(num_params=1, init=init, propagate=propagate,
                          log_weight=log_weight, functionals=functionals,
                          prop_mu=lambda p, state, y, z: state, name="law")


def _jax_law_model(functionals=None):
    n = 256

    def init(rng, p, y, z, shape):
        return (jax.lax.broadcasted_iota(jnp.float32, shape, 1) / float(n),)

    def log_weight(p, state, y, z):
        (x,) = state
        return jnp.where(y[0] > 0.5, 3.0 * x, jnp.zeros_like(x))

    return jfm.KernelModel(num_params=1, init=init,
                           propagate=lambda rng, p, state, y, z: state,
                           log_weight=log_weight, functionals=functionals,
                           prop_mu=lambda p, state, y, z: state, name="law")


def test_vector_functionals_paths_match_pallas_interpret():
    """A ``functionals`` vector gets one filtered-mean path each: t = 0
    against the Pallas kernel in interpret mode to 1e-5 (deterministic
    cloud), the constant 42 exactly at every step, and t = 1 (after a
    resample whose offset differs between the PRNGs) within the
    systematic bound 2/n of the weighted mean."""
    n = 256
    fns = (lambda p, st: st[0], lambda p, st: st[0] * st[0],
           lambda p, st: torch.full_like(st[0], 42.0))
    jfns = (lambda p, st: st[0], lambda p, st: st[0] * st[0],
            lambda p, st: jnp.full_like(st[0], 42.0))
    _, _, fmeans = fm.filter_megakernel(_law_model(fns), 9,
                                        torch.zeros(8, 1),
                                        torch.tensor([1.0, 0.0]),
                                        num_particles=n)
    _, _, jfmeans = jfm.filter_megakernel(
        _jax_law_model(jfns), 9, jnp.zeros((8, 1)), jnp.array([1.0, 0.0]),
        num_particles=n, interpret=True)
    assert isinstance(fmeans, tuple) and len(fmeans) == 3
    assert all(f.shape == (8, 2) for f in fmeans)
    for got, want in zip(fmeans, jfmeans):
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want)[:, 0],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fmeans[2].numpy(), 42.0, rtol=1e-6)
    x = np.arange(n) / n
    w = np.exp(3.0 * x)
    w /= w.sum()
    assert np.all(np.abs(fmeans[0][:, 1].numpy() - (w * x).sum()) < 2.0 / n)


def test_vector_functionals_swarm_paths():
    km = fm.KernelModel(
        num_params=1, init=lambda rng, p, y, z, shape: (torch.zeros(shape),),
        propagate=lambda rng, p, state, y, z: state,
        log_weight=lambda p, state, y, z: torch.zeros_like(state[0]),
        functionals=(lambda p, st: torch.full_like(st[0], 7.0),
                     lambda p, st: torch.full_like(st[0], 42.0)),
        name="vecfn_swarm")
    ev = fm.megakernel_swarm_evidence(km, 3, torch.zeros(12, 1),
                                      torch.ones(6), num_particles=128)
    assert len(ev["functional_paths"]) == 2
    torch.testing.assert_close(ev["functional_paths"][0],
                               torch.full((6,), 7.0))
    torch.testing.assert_close(ev["functional_paths"][1],
                               torch.full((6,), 42.0))
    torch.testing.assert_close(ev["functional_path"], torch.full((6,), 7.0))


def test_apf_identity_lcl_matches_pallas_interpret():
    """APF with identity propagation and lookahead: the second-stage
    weights are flat, so every lcl is LSE(lw + log g) - LSE(lw), which
    the selection (and so the PRNG) cannot change: the plain APF against
    the Pallas kernel's APF in interpret mode, column by column."""
    ys = np.array([1.0, 1.0, 0.0], np.float32)
    _, lcl, _ = fm.filter_megakernel(_law_model(), 9, torch.zeros(8, 1),
                                     torch.from_numpy(ys),
                                     num_particles=256, mode="apf")
    _, jlcl, _ = jfm.filter_megakernel(_jax_law_model(), 9,
                                       jnp.zeros((8, 1)), jnp.asarray(ys),
                                       num_particles=256, interpret=True,
                                       mode="apf")
    np.testing.assert_allclose(lcl.numpy(), np.asarray(jlcl), rtol=1e-5,
                               atol=1e-5)
    # t = 2 weighs nothing: its lcl is exactly 0
    assert np.allclose(lcl[:, 2].numpy(), 0.0, atol=1e-6)


def test_large_n_bridge_is_the_generic_bank():
    """Above 1024 particles ``model=`` makes the hook the generic bank at
    the same particles, replicates and ESS gate: equal on one seed."""
    from ssme_tpu_torch.filters.bootstrap import replicated_log_like_fn
    from ssme_tpu_torch.models import svol_t
    model = svol_t.make_model()
    ys = torch.from_numpy(_simulate_leverage(20, seed=8))[:, None]
    params = torch.tensor([[1.0, 0.95, 0.05, 8.0], [0.9, 0.9, 0.1, 5.0]])
    ll = fm.megakernel_log_like(fm.svol_t_kernel_model(), 2048, 2,
                                constrain=fm.svol_t_param_rows, model=model)
    bank = replicated_log_like_fn(model, 2048, 2, ess_threshold=0.5)
    a = ll(torch.Generator().manual_seed(1), params, ys)
    b = bank(torch.Generator().manual_seed(1), params, ys)
    assert a.shape == (2,) and torch.equal(a, b)
    every = fm.megakernel_log_like(fm.svol_t_kernel_model(), 2048, 1,
                                   ess_threshold=1.0, model=model)
    c = every(torch.Generator().manual_seed(1), params, ys)
    d = replicated_log_like_fn(model, 2048, 1)(
        torch.Generator().manual_seed(1), params, ys)
    assert torch.equal(c, d)


def test_megakernel_log_like_is_chain_major_and_generator_seeded():
    ys = _simulate_leverage(60, seed=7)
    ll = fm.megakernel_log_like(fm.svol_leverage_kernel_model(), 64, 4,
                                ess_threshold=0.5, gate_stride=4)
    params = torch.tensor([THETA, THETA, (0.9, 0.0, 2.0, -0.3)])
    args = (params, torch.from_numpy(ys), torch.from_numpy(_lagged(ys)))
    a = ll(torch.Generator().manual_seed(0), *args)
    b = ll(torch.Generator().manual_seed(0), *args)
    c = ll(torch.Generator().manual_seed(1), *args)
    assert a.shape == (3,) and torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a[0] - a[1])) < 2.0 and float(a[2]) < float(a[0]) - 5
    # the svol instance with the ss -> sigma row map
    sll = fm.megakernel_log_like(fm.svol_kernel_model(), 64, 2,
                                 constrain=fm.svol_kernel_rows)
    out = sll(torch.Generator().manual_seed(0),
              torch.tensor([[1.0, 0.9, 0.05]]), torch.from_numpy(ys))
    assert out.shape == (1,) and torch.isfinite(out).all()


def test_instances_are_memoised_and_name_their_cuda_functor():
    for factory in (fm.svol_kernel_model, fm.svol_leverage_kernel_model,
                    fm.svol_t_kernel_model, fm.poisson_ar_kernel_model):
        km = factory()
        assert factory() is km
        assert km.cuda_instance == km.name
        assert fm._model_id(km) == fm.CUDA_MODEL_IDS[km.name]
    for na in fm.FACTOR_ASSET_COUNTS:
        km = fm.factor_svol_kernel_model(na)
        assert fm.factor_svol_kernel_model(na) is km
        assert (km.name, km.num_state, km.dim_obs, km.num_params) == (
            f"factor_svol_{na}x2", 2, na, 6 + 3 * na)
        assert fm._model_id(km) == fm.CUDA_MODEL_IDS[f"factor_svol_{na}"]


def test_model_id_table_matches_the_cuda_header():
    """The dispatch ids and each functor's traits are written once in
    csrc/kernel_models.cuh; the Python side must read the same, and its
    dispatch table, through which both selection families' instances
    launch, must send every id to its functor."""
    path = os.path.join(ROOT, "ssme_tpu_torch", "csrc", "kernel_models.cuh")
    with open(path) as f:
        src = f.read()
    ids = {name: int(num) for num, name in re.findall(
        r"constexpr int kModel\w+ = (\d+);\s*// \"(\w+)\"", src)}
    assert ids == fm.CUDA_MODEL_IDS
    structs = dict(re.findall(r"struct (\w+Model) \{(.*?)\n\};", src, re.S))

    def traits(struct, n_assets=None):
        body = structs[struct]
        out = {k: eval(v, {"kAssets": n_assets}) for k, v in re.findall(
            r"static constexpr int (k\w+) = ([^;]+);", body)}
        look = re.search(r"static constexpr bool kHasPropMu = (\w+);", body)
        out["kHasPropMu"] = look.group(1) == "true"
        return out

    cases = [(fm.svol_kernel_model(), "SvolModel", None),
             (fm.svol_leverage_kernel_model(), "SvolLeverageModel", None),
             (fm.svol_t_kernel_model(), "SvolTModel", None),
             (fm.poisson_ar_kernel_model(), "PoissonArModel", None)]
    cases += [(fm.factor_svol_kernel_model(na), "FactorSvolModel", na)
              for na in fm.FACTOR_ASSET_COUNTS]
    cases += [(fm.factor_svol_sv_kernel_model(10), "FactorSvolSvModel", 10)]
    for km, struct, na in cases:
        t = traits(struct, na)
        assert {k: t[k] for k in ("kNumParams", "kNumState", "kDimObs",
                                  "kDimCov")} == {
            "kNumParams": km.num_params, "kNumState": km.num_state,
            "kDimObs": km.dim_obs, "kDimCov": km.dim_cov}, struct
        assert t["kHasPropMu"] == (km.prop_mu is not None), struct
    # one table (ssme::with_model) dispatches both selection families,
    # which are one template's instances
    dispatch = re.findall(
        r"case (kModel\w+): return f\(Is<(\w+(?:<\d+>)?)>\{\}\);", src)
    with open(os.path.join(os.path.dirname(path),
                           "filter_megakernel_sys.cuh")) as f:
        family = f.read()
    assert "ssme::with_model(model_id," in family
    assert "launch_sys<Model, false, kPer, kRoll>(a)" in family
    consts = dict(re.findall(r"constexpr int (kModel\w+) = (\d+);", src))
    by_id = {int(consts[c]): functor for c, functor in dispatch}
    want = {0: "SvolModel", 1: "SvolLeverageModel", 2: "SvolTModel",
            3: "PoissonArModel"}
    want.update({fm.CUDA_MODEL_IDS[f"factor_svol_{na}"]:
                 f"FactorSvolModel<{na}>" for na in fm.FACTOR_ASSET_COUNTS})
    want[fm.CUDA_MODEL_IDS["factor_svol_sv_10"]] = "FactorSvolSvModel<10>"
    assert by_id == want


@pytest.mark.parametrize("resampler", ["metropolis", "rejection"])
@pytest.mark.parametrize("mode", ["bootstrap", "apf"])
def test_roll_resamplers_match_jax_filters_in_distribution(mode, resampler):
    """32 rows, N=256, T=64: the plain kernel under each roll resampler
    against the JAX package's generic filters on the same series within 4
    combined standard errors (Metropolis: plus its bias envelope at its
    32 sweeps) -- the leverage bootstrap at ESS 0.5 against the JAX bank
    at ESS 0.5, SVOL's APF against JAX's AuxiliaryParticleFilter."""
    from ssme_tpu.filters import AuxiliaryParticleFilter as JaxAPF
    from ssme_tpu.models import svol as jsvol
    from ssme_tpu_torch.ops._select import metropolis_bias_estimate
    rows, n, t_len, iters = 32, 256, 64, 32
    ys = _simulate_leverage(t_len, seed=12)
    keys = jax.random.split(jax.random.key(2), rows)
    if mode == "bootstrap":
        bank = jax_bank(jlev.make_model(), n, 1, ess_threshold=0.5)
        want = np.asarray(bank(keys[0], jnp.tile(jnp.asarray(THETA),
                                                 (rows, 1)),
                               jnp.asarray(ys)[:, None],
                               jnp.asarray(_lagged(ys))[:, None]))
        km, p, zs, ess = (fm.svol_leverage_kernel_model(), _rows(rows),
                          torch.from_numpy(_lagged(ys)), 0.5)
    else:
        theta = (1.0, 0.9, 0.05)
        japf = JaxAPF(jsvol.make_model(), n)
        want = np.asarray(jax.vmap(lambda k: japf.run(
            k, jnp.asarray(theta), jnp.asarray(ys)[:, None])
            .log_likelihood)(keys))
        km, zs, ess = fm.svol_kernel_model(), None, 1.0
        p = fm.svol_kernel_rows(torch.tensor([theta] * rows))
    got, _, _ = fm.filter_megakernel(km, 5, p, torch.from_numpy(ys), zs,
                                     num_particles=n, ess_threshold=ess,
                                     mode=mode, resampler=resampler,
                                     metropolis_iters=iters)
    got = got.double().numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    se = math.sqrt(got.var(ddof=1) / rows + want.var(ddof=1) / rows)
    slack = (metropolis_bias_estimate(iters, t_len, ess)
             if resampler == "metropolis" else 0.0)
    assert abs(got.mean() - want.mean()) <= 4 * se + slack


def test_megakernel_log_like_roll_caps_and_sweep_budget():
    """JAX's cap logic: up to 4096 particles a roll resampler stays in
    the kernel (here its plain version, one call per iteration), above it
    ``model=`` takes the bridge; metropolis_iters=None takes the budget's
    sweep count, and an explicit count over budget warns with JAX's
    numbers."""
    import warnings

    from ssme_tpu_torch.filters.bootstrap import replicated_log_like_fn
    from ssme_tpu_torch.models import svol
    from ssme_tpu_torch.ops import _select
    ys = torch.from_numpy(_simulate_leverage(12, seed=9))
    params = torch.tensor([[1.0, 0.9, 0.05]])
    km, model = fm.svol_kernel_model(), svol.make_model()

    def gen():
        return torch.Generator().manual_seed(3)

    def direct(n, resampler, iters):
        seed = torch.randint(0, 2 ** 32, (2,), generator=gen(),
                             dtype=torch.int64)
        return fm.filter_megakernel(
            km, seed, fm.svol_kernel_rows(params).contiguous(), ys,
            num_particles=n, ess_threshold=0.5, resampler=resampler,
            metropolis_iters=iters)[0]

    for n in (2048, 4096):
        ll = fm.megakernel_log_like(km, n, 1, constrain=fm.svol_kernel_rows,
                                    resampler="rejection", model=model)
        torch.testing.assert_close(ll(gen(), params, ys),
                                   direct(n, "rejection", 16), rtol=0,
                                   atol=1e-6)
    sweeps = _select.metropolis_sweeps_for(0.5, 12, 0.5)
    ll = fm.megakernel_log_like(km, 2048, 1, constrain=fm.svol_kernel_rows,
                                resampler="metropolis")
    torch.testing.assert_close(ll(gen(), params, ys),
                               direct(2048, "metropolis", sweeps), rtol=0,
                               atol=1e-6)
    bridge = fm.megakernel_log_like(km, 8192, 1, resampler="rejection",
                                    model=model)
    assert torch.equal(bridge(gen(), params, ys[:, None]),
                       replicated_log_like_fn(model, 8192, 1,
                                              ess_threshold=0.5)(
                           gen(), params, ys[:, None]))
    for kw in (dict(num_particles=8192, resampler="rejection"),
               dict(num_particles=2048),
               dict(num_particles=512, resampler="multinomial")):
        n = kw.pop("num_particles")
        with pytest.raises(ValueError):
            fm.megakernel_log_like(km, n, 1, **kw)
    est = _select.metropolis_bias_estimate(4, 12, 0.5)
    need = _select.metropolis_sweeps_for(0.01, 12, 0.5, max_sweeps=1 << 20)
    over = fm.megakernel_log_like(km, 64, 1, constrain=fm.svol_kernel_rows,
                                  resampler="metropolis", metropolis_iters=4,
                                  metropolis_bias_budget=0.01)
    with pytest.warns(UserWarning, match=re.escape(
            f"metropolis_iters=4 predicts ~{est:.2f} nats of theta-dependent"
            f" evidence bias at T=12 (budget 0.01)")) as rec:
        over(gen(), params, ys)
    assert f"metropolis_iters={need}" in str(rec[0].message)
    within = fm.megakernel_log_like(km, 64, 1, constrain=fm.svol_kernel_rows,
                                    resampler="metropolis",
                                    metropolis_iters=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.isfinite(within(gen(), params, ys)).all()
    impossible = fm.megakernel_log_like(km, 64, 1, resampler="metropolis",
                                        metropolis_bias_budget=1e-6)
    with pytest.raises(ValueError, match="rejection"):
        impossible(gen(), fm.svol_kernel_rows(params), ys)


def test_cpu_tensors_hand_the_resampler_to_the_plain_versions():
    """On a CPU tensor every wrapper passes ``resampler`` and
    ``metropolis_iters`` on to its plain version."""
    from ssme_tpu_torch.ops import liu_west_megakernel as lwm
    from ssme_tpu_torch.ops.svol_filter_kernel import svol_filter
    ys = torch.from_numpy(_simulate_leverage(24, seed=4))
    zs = torch.from_numpy(_lagged(ys.numpy()))
    p = _rows(4)
    km = fm.svol_leverage_kernel_model()
    svol_rows = fm.svol_kernel_rows(torch.tensor([[1.0, 0.9, 0.05]] * 4))
    lkm = lwm.svol_leverage_lw_kernel_model()
    for resampler in ("metropolis", "rejection"):
        roll = dict(resampler=resampler, metropolis_iters=6)
        cases = [
            (lambda **kw: fm.filter_megakernel(km, 1, p, ys, zs,
                                               num_particles=64, **kw)[0],
             lambda **kw: fm.filter_megakernel_reference(
                 km, 1, p, ys, zs, num_particles=64, **kw)[0]),
            (lambda **kw: fm.megakernel_swarm_evidence(
                km, 1, p, ys, zs, num_particles=64,
                **kw)["per_model_log_cond_likes"],
             lambda **kw: fm.filter_megakernel_reference(
                 km, 1, p, ys, zs, num_particles=64, **kw)[1]),
            (lambda **kw: svol_filter(1, svol_rows, ys, num_particles=64,
                                      **kw)[0],
             lambda **kw: svol_filter_reference(1, svol_rows, ys,
                                                num_particles=64, **kw)[0]),
            (lambda **kw: lwm.lw_megakernel(lkm, 1, ys, zs, num_filters=2,
                                            num_particles=64,
                                            **kw)["log_likelihood"],
             lambda **kw: lwm.lw_megakernel_reference(
                 lkm, 1, ys, zs, num_filters=2, num_particles=64,
                 **kw)["log_likelihood"])]
        for wrapper, plain in cases:
            got = wrapper(**roll)
            assert torch.equal(got, plain(**roll))
            assert not torch.equal(got, plain())


def test_log_like_hook_takes_keywords_after_ess_threshold():
    """F-P6: JAX's sixth positional parameter of ``megakernel_log_like`` is
    ``model``, the port's is keyword-only, so a JAX-style positional call
    raises TypeError; the keyword call computes what it computed before:
    one launch of every chain x replicate row on the generator's seed
    words, reduced by a per-chain log-mean-exp."""
    from ssme_tpu_torch.models import svol
    from ssme_tpu_torch.utils import logmeanexp
    km = fm.svol_kernel_model()
    with pytest.raises(TypeError):
        fm.megakernel_log_like(km, 64, 2, fm.svol_kernel_rows, 0.5,
                               svol.make_model())
    ys = torch.from_numpy(_simulate_leverage(30, seed=9))
    params = torch.tensor([[1.0, 0.9, 0.05], [0.9, 0.95, 0.02]])
    ll = fm.megakernel_log_like(km, 64, 2, fm.svol_kernel_rows, 0.5,
                                gate_stride=4)
    got = ll(torch.Generator().manual_seed(3), params, ys)
    seed = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(3))
    rows = fm.svol_kernel_rows(params).repeat_interleave(2, 0).contiguous()
    tot = fm.filter_megakernel(km, seed, rows, ys, num_particles=64,
                               ess_threshold=0.5, gate_stride=4)[0]
    assert torch.equal(got, logmeanexp(tot.reshape(2, 2), dim=-1))
