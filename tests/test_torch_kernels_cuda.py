"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test decides inside itself whether a card exists
and skips without one.  The file imports no JAX, so it runs on a machine
with a card and no JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from ssme_tpu_torch.models import factor_svol
from ssme_tpu_torch.models.svol_leverage import lagged_covariates
from ssme_tpu_torch.ops import _prng, _select
from ssme_tpu_torch.ops import filter_megakernel as fm
from ssme_tpu_torch.ops import liu_west_megakernel as lwm
from ssme_tpu_torch.ops import svol_leverage_lw_kernel as k4
from ssme_tpu_torch.ops.svol_filter_kernel import (svol_filter,
                                                   svol_filter_reference)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ys(t_len, seed):
    rng = np.random.default_rng(seed)
    x, ys = 0.0, np.empty(t_len, np.float32)
    for t in range(t_len):
        x = 0.9 * x + math.sqrt(0.05) * rng.normal()
        ys[t] = math.exp(x / 2) * rng.normal()
    return torch.from_numpy(ys)


def test_philox_fill_matches_plain_bitwise(dev):
    seed = _prng.seed_words(12345, device=dev)
    got = _prng.philox_fill(seed, 16, 1024, 77)
    want = _prng.philox_fill_reference(seed, 16, 1024, 77)
    for key in ("bits", "u1", "u2", "offsets"):
        assert torch.equal(got[key], want[key]), key
    # accurate logf / sqrtf / sincosf against torch's: last-bit differences
    torch.testing.assert_close(got["normals"], want["normals"], rtol=1e-6,
                               atol=1e-7)


def test_systematic_select_matches_plain_away_from_boundaries(dev):
    rng = np.random.default_rng(1)
    w = torch.as_tensor(rng.gamma(1.0, 1.0, (32, 256)).astype(np.float32),
                        device=dev)
    leaves = torch.as_tensor(rng.normal(size=(2, 32, 256)).astype(
        np.float32), device=dev)
    u0 = torch.full((32,), 0.37, device=dev)
    picked, anc = _select.systematic_select(w, leaves, u0)
    _, anc_p = _select.systematic_select_reference(w, leaves, u0)
    # block scan vs torch.cumsum: a point may flip only at a boundary
    assert float((anc != anc_p).float().mean()) < 0.01
    assert torch.equal(picked, torch.gather(
        leaves, 2, anc.long()[None].expand_as(leaves)))


@pytest.mark.parametrize("gate_stride", [1, 8])
def test_filter_matches_plain_without_resampling(dev, gate_stride):
    """Identical Philox bits and a gate that never fires: only float32
    rounding (fused multiply-adds, reduction order) separates them."""
    ys = _ys(300, 7).to(dev)
    params = torch.tensor([[1.0, 0.9, math.sqrt(0.05)]] * 64, device=dev)
    kw = dict(num_particles=256, ess_threshold=1e-6,
              gate_stride=gate_stride)
    tot, lcl, _ = svol_filter(9, params, ys, **kw)
    tot_p, lcl_p, _ = svol_filter_reference(9, params, ys, **kw)
    torch.testing.assert_close(tot, tot_p, rtol=1e-4, atol=1e-3)
    assert torch.equal(lcl != 0, lcl_p != 0)


def test_filter_launch_counter_and_errors(dev):
    params = torch.tensor([[1.0, 0.9, 0.2]] * 8, device=dev)
    before = svol_filter.launches
    svol_filter(1, params, _ys(20, 2).to(dev), num_particles=64)
    assert svol_filter.launches == before + 1
    with pytest.raises(ValueError):      # ys on another device
        svol_filter(1, params, _ys(20, 2), num_particles=64)


def _instance(name, dev, ys):
    if name == "svol":
        return (fm.svol_kernel_model(),
                torch.tensor([[1.0, 0.9, math.sqrt(0.05)]] * 64, device=dev),
                None)
    return (fm.svol_leverage_kernel_model(),
            torch.tensor([[0.95, -0.1, 0.3, -0.7]] * 64, device=dev),
            lagged_covariates(ys))


@pytest.mark.parametrize("gate_stride", [1, 8])
@pytest.mark.parametrize("name", ["svol", "svol_leverage"])
def test_megakernel_matches_plain_without_resampling(dev, name, gate_stride):
    """The generic kernel against its plain version on the same bits with
    a gate that never fires, the final cloud included."""
    ys = _ys(300, 8).to(dev)
    km, params, zs = _instance(name, dev, ys)
    kw = dict(num_particles=256, ess_threshold=1e-6, gate_stride=gate_stride,
              return_cloud=True)
    tot, lcl, fmean, cloud, clw = fm.filter_megakernel(km, 9, params, ys, zs,
                                                       **kw)
    tot_p, lcl_p, fmean_p, cloud_p, clw_p = fm.filter_megakernel_reference(
        km, 9, params, ys, zs, **kw)
    torch.testing.assert_close(tot, tot_p, rtol=1e-4, atol=1e-3)
    assert torch.equal(lcl != 0, lcl_p != 0)
    torch.testing.assert_close(fmean, fmean_p, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(cloud[0], cloud_p[0], rtol=1e-3, atol=1e-3)
    # negligible particles carry log-weights far below -1e6: compare weights
    torch.testing.assert_close(torch.exp(clw), torch.exp(clw_p), rtol=1e-3,
                               atol=1e-3)


def test_megakernel_svol_instance_equals_the_svol_kernel(dev):
    ys = _ys(300, 9).to(dev)
    km, params, _ = _instance("svol", dev, ys)
    for ess in (1.0, 0.5):
        a = fm.filter_megakernel(km, 4, params, ys, num_particles=256,
                                 ess_threshold=ess)[0]
        b = svol_filter(4, params, ys, num_particles=256,
                        ess_threshold=ess)[0]
        assert float((a - b).abs().max()) <= 1e-3


def test_megakernel_launch_counter_and_errors(dev):
    ys = _ys(20, 2).to(dev)
    km, params, zs = _instance("svol_leverage", dev, ys)
    before = fm.filter_megakernel.launches
    fm.filter_megakernel(km, 1, params, ys, zs, num_particles=64)
    assert fm.filter_megakernel.launches == before + 1
    with pytest.raises(ValueError):      # covariates on another device
        fm.filter_megakernel(km, 1, params, ys, zs.cpu(), num_particles=64)
    custom = fm.KernelModel(num_params=4, init=km.init,
                            propagate=km.propagate, log_weight=km.log_weight,
                            dim_cov=1, name="custom")
    with pytest.raises(ValueError, match="no CUDA instance"):
        fm.filter_megakernel(custom, 1, params, ys, zs, num_particles=64)
    assert fm.filter_megakernel.launches == before + 1


def _family(name, dev, ys):
    """(kernel model, rows, observations) of the svol_t, poisson_ar and
    factor_svol instances."""
    if name == "svol_t":
        return (fm.svol_t_kernel_model(), fm.svol_t_param_rows(torch.tensor(
            [[0.9, 0.97, 0.06, 8.0]] * 64)).to(dev), ys)
    if name == "poisson_ar":
        counts = torch.poisson(torch.exp(ys.cpu()),
                               generator=torch.Generator().manual_seed(0))
        return (fm.poisson_ar_kernel_model(),
                torch.tensor([[0.9, 1.0, 0.3]] * 64, device=dev),
                fm.poisson_obs_rows(counts).to(dev))
    na = int(name[-1])
    gen = torch.Generator().manual_seed(na)
    params = factor_svol.make_model(na, 2).sample_prior(gen)
    _, fys = factor_svol.simulate(gen, params, ys.shape[0], na, 2)
    return (fm.factor_svol_kernel_model(na),
            params.expand(64, -1).contiguous().to(dev), fys.to(dev))


@pytest.mark.parametrize("gate_stride", [1, 8])
@pytest.mark.parametrize("name", ["svol_t", "poisson_ar", "factor_svol_4",
                                  "factor_svol_5"])
def test_new_instances_match_plain_without_resampling(dev, name,
                                                      gate_stride):
    ys = _ys(300, 12).to(dev)
    km, params, obs = _family(name, dev, ys)
    kw = dict(num_particles=256, ess_threshold=1e-6, gate_stride=gate_stride,
              return_cloud=True)
    tot, lcl, fmean, cloud, clw = fm.filter_megakernel(km, 9, params, obs,
                                                       **kw)
    tot_p, lcl_p, fmean_p, cloud_p, clw_p = fm.filter_megakernel_reference(
        km, 9, params, obs, **kw)
    torch.testing.assert_close(tot, tot_p, rtol=1e-4, atol=2e-3)
    assert torch.equal(lcl != 0, lcl_p != 0)
    torch.testing.assert_close(fmean, fmean_p, rtol=1e-3, atol=1e-3)
    for a, b in zip(cloud, cloud_p):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(torch.exp(clw), torch.exp(clw_p), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("name", ["svol", "svol_leverage", "svol_t",
                                  "poisson_ar"])
def test_apf_matches_plain_at_step_zero(dev, name):
    """APF on the same bits: step 0 (init and weights, no selection yet)
    to float tolerance; later steps may select another neighbour at a CDF
    boundary, so most (row, step) cells agree and the totals are
    finite."""
    ys = _ys(64, 13).to(dev)
    if name in ("svol", "svol_leverage"):
        km, params, zs = _instance(name, dev, ys)
        obs = ys
    else:
        (km, params, obs), zs = _family(name, dev, ys), None
    tot, lcl, _ = fm.filter_megakernel(km, 3, params, obs, zs,
                                       num_particles=256, mode="apf")
    tot_p, lcl_p, _ = fm.filter_megakernel_reference(
        km, 3, params, obs, zs, num_particles=256, mode="apf")
    torch.testing.assert_close(lcl[:, 0], lcl_p[:, 0], rtol=1e-5, atol=1e-4)
    assert bool(torch.isfinite(tot).all())
    # a row agrees until its first boundary flip, which is rare
    assert float(((lcl - lcl_p).abs() <= 1e-3).float().mean()) >= 0.5


def test_new_instances_refuse_what_the_card_cannot_run(dev):
    ys = _ys(20, 2).to(dev)
    km, params, obs = _family("factor_svol_4", dev, ys)
    before = fm.filter_megakernel.launches
    with pytest.raises(ValueError, match="prop_mu"):
        fm.filter_megakernel(km, 1, params, obs, num_particles=64, mode="apf")
    six = fm.factor_svol_kernel_model(6)
    with pytest.raises(ValueError, match="3, 4, 5 assets"):
        fm.filter_megakernel(six, 1, torch.ones(8, six.num_params,
                                                device=dev),
                             torch.zeros(20, 6, device=dev), num_particles=64)
    vec = dataclasses.replace(fm.svol_kernel_model(),
                              functionals=(lambda p, st: st[0],) * 2)
    with pytest.raises(ValueError, match="functor's own"):
        fm.filter_megakernel(vec, 1, torch.ones(8, 3, device=dev), ys,
                             num_particles=64)
    assert fm.filter_megakernel.launches == before


def _lw_instance(name, ys):
    if name == "svol_leverage_lw":
        return (lwm.svol_leverage_lw_kernel_model(),
                lagged_covariates(ys)[:, 0].contiguous())
    return lwm.svol_t_lw_kernel_model(), None


@pytest.mark.parametrize("name", ["svol_leverage_lw", "svol_t_lw"])
def test_lw_megakernel_matches_plain_without_resampling(dev, name):
    """The Liu-West kernel against its plain version on the same bits:
    SISR with a gate that never fires, so no selection runs and only
    float32 rounding separates them."""
    ys = _ys(300, 10).to(dev)
    km, zs = _lw_instance(name, ys)
    kw = dict(num_filters=16, num_particles=256, variant="sisr",
              ess_threshold=0.5 / 256)
    got = lwm.lw_megakernel(km, 9, ys, zs, **kw)
    want = lwm.lw_megakernel_reference(km, 9, ys, zs, **kw)
    torch.testing.assert_close(got["log_likelihood"],
                               want["log_likelihood"], rtol=0, atol=2e-3)
    s = km.num_state
    torch.testing.assert_close(got["cloud"][:, :s], want["cloud"][:, :s],
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(got["cloud"][:, s + 1:],
                               want["cloud"][:, s + 1:], rtol=0, atol=1e-3)
    torch.testing.assert_close(lwm.lw_cloud_weights(km, got["cloud"]),
                               lwm.lw_cloud_weights(km, want["cloud"]),
                               rtol=0, atol=1e-3)
    for a, b in zip(got.get("functional_paths", ()),
                    want.get("functional_paths", ())):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)


def test_svol_leverage_lw_is_the_k3_instance_bit_for_bit(dev):
    ys = _ys(300, 11).to(dev)
    km, zs = _lw_instance("svol_leverage_lw", ys)
    a = k4.svol_leverage_lw(5, ys, num_filters=8, num_particles=256)
    b = lwm.lw_megakernel(km, 5, ys, zs, num_filters=8, num_particles=256)
    assert torch.equal(a["log_cond_likes"], b["log_cond_likes"])
    assert torch.equal(a["cloud"], b["cloud"])


def test_lw_launch_counters_and_errors(dev):
    ys = _ys(20, 3).to(dev)
    km, zs = _lw_instance("svol_leverage_lw", ys)
    before = (lwm.lw_megakernel.launches, k4.svol_leverage_lw.launches)
    k4.svol_leverage_lw(1, ys, num_filters=2, num_particles=64)
    assert (lwm.lw_megakernel.launches, k4.svol_leverage_lw.launches) == (
        before[0] + 1, before[1] + 1)
    custom = lwm.LWKernelModel(
        num_params=4, transform_codes=km.transform_codes,
        sample_prior=km.sample_prior, init=km.init, propagate=km.propagate,
        log_weight=km.log_weight, prop_mu=km.prop_mu, dim_cov=1,
        name="custom")
    with pytest.raises(ValueError, match="no CUDA instance"):
        lwm.lw_megakernel(custom, 1, ys, zs, num_particles=64)
    with pytest.raises(ValueError, match="not ported"):
        lwm.lw_megakernel(km, 1, ys, zs, num_particles=64,
                          resampler="metropolis")
    with pytest.raises(ValueError):      # covariates on another device
        lwm.lw_megakernel(km, 1, ys, zs.cpu(), num_particles=64)
    assert lwm.lw_megakernel.launches == before[0] + 1
