"""The port's generic filter bank (``ssme_tpu_torch/ops/filter_megakernel.py``)
against the JAX package.

On the CPU ``filter_megakernel`` runs its plain version, which calls the
model hooks step by step with the CUDA kernel's Philox bits;
``test_torch_kernels_cuda.py`` holds the kernel itself to that plain
version on a card.
"""

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
    rng = fm._PlainRng(seed, rows, 32, 3).at(2)
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
    for bad in [dict(params=torch.ones(8, 3)),
                dict(zs=None), dict(kmodel=sv, params=torch.ones(8, 3)),
                dict(zs=torch.ones(15)), dict(zs=torch.ones(16, 2)),
                dict(ys=torch.ones(16, 2)), dict(params=p.double()),
                dict(params=torch.ones(4, 8).T),
                dict(num_particles=100), dict(num_particles=2048),
                dict(seed=torch.zeros(3, dtype=torch.int64)),
                dict(gate_stride=4, ess_threshold=1.0),
                dict(gate_stride=0, ess_threshold=0.5),
                dict(mode="apf"), dict(resampler="metropolis"),
                dict(kmodel=fm.KernelModel(4, lev.init, lev.propagate,
                                           lev.log_weight, dim_cov=1,
                                           functionals=(None,)))]:
        kw = dict(base)
        kw.update(bad)
        with pytest.raises(ValueError):
            fm.filter_megakernel(**kw)
    with pytest.raises(ValueError, match="large-N bridge"):
        fm.megakernel_log_like(lev, 2048, 2)
    with pytest.raises(ValueError, match="no CUDA instance"):
        fm._model_id(_two_draw_model())
    for factory in (fm.factor_svol_kernel_model, fm.poisson_ar_kernel_model,
                    fm.svol_t_kernel_model):
        with pytest.raises(ValueError, match="K2 remainder"):
            factory()


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
    assert fm.svol_kernel_model() is fm.svol_kernel_model()
    assert fm.svol_leverage_kernel_model() is fm.svol_leverage_kernel_model()
    for km in (fm.svol_kernel_model(), fm.svol_leverage_kernel_model()):
        assert km.cuda_instance == km.name
        assert fm._model_id(km) == fm.CUDA_MODEL_IDS[km.name]


def test_model_id_table_matches_the_cuda_header():
    """The dispatch ids and each functor's traits are written once in
    csrc/kernel_models.cuh; the Python side must read the same."""
    path = os.path.join(ROOT, "ssme_tpu_torch", "csrc", "kernel_models.cuh")
    with open(path) as f:
        src = f.read()
    ids = {name: int(num) for num, name in re.findall(
        r"constexpr int kModel\w+ = (\d+);\s*// \"(\w+)\"", src)}
    assert ids == fm.CUDA_MODEL_IDS
    structs = dict(re.findall(r"struct (\w+Model) \{(.*?)\n\};", src, re.S))
    traits = {name: {k: int(v) for k, v in re.findall(
        r"static constexpr int (k\w+) = (\d+);", body)}
        for name, body in structs.items()}
    for km, struct in ((fm.svol_kernel_model(), "SvolModel"),
                       (fm.svol_leverage_kernel_model(),
                        "SvolLeverageModel")):
        assert traits[struct] == {
            "kNumParams": km.num_params, "kNumState": km.num_state,
            "kDimObs": km.dim_obs, "kDimCov": km.dim_cov}
    dispatch = re.findall(r"case ssme::(kModel\w+):\s*launch<ssme::(\w+)>",
                          src + open(os.path.join(
                              os.path.dirname(path),
                              "filter_megakernel.cu")).read())
    assert sorted(dispatch) == [("kModelSvol", "SvolModel"),
                                ("kModelSvolLeverage", "SvolLeverageModel")]
