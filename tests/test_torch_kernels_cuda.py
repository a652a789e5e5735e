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

from ssme_tpu_torch.filters import fixed_lag_smoother
from ssme_tpu_torch.models import factor_svol, lgssm, svol
from ssme_tpu_torch.models.svol_leverage import lagged_covariates
from ssme_tpu_torch.ops import _cuda, _prng, _select
from ssme_tpu_torch.ops import filter_megakernel as fm
from ssme_tpu_torch.ops import liu_west_megakernel as lwm
from ssme_tpu_torch.ops import svol_kernel as k5
from ssme_tpu_torch.ops import svol_leverage_lw_kernel as k4
from ssme_tpu_torch.ops import svol_filter_kernel as sfk
from ssme_tpu_torch.ops.svol_filter_kernel import (svol_filter,
                                                   svol_filter_reference)
from ssme_tpu_torch.transforms import ParamPack

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


@pytest.mark.parametrize("n,kper", [(256, 4), (256, 2), (32, 2), (96, 2),
                                    (1024, 4), (2048, 8), (4096, 8),
                                    (512, 4), (512, 8)])
def test_systematic_select_matches_plain_away_from_boundaries(dev, n, kper):
    """The standalone selection in each layout (kPer neighbouring slots,
    the systematic families'): ancestors bit for bit those of the plain
    model of its counts, marks and scan on the CDF it returns (which never
    falls), the leaves moved by them, and the plain law's but where a
    point lies within rounding of a CDF boundary (another scan order)."""
    rng = np.random.default_rng(n + kper)
    w = torch.as_tensor(rng.gamma(1.0, 1.0, (32, n)).astype(np.float32),
                        device=dev)
    w[::4, n // 3:n // 2] = 0.0
    w[1::4] *= 1e-12
    w[1::4, 7] = 1.0
    leaves = torch.as_tensor(rng.normal(size=(2, 32, n)).astype(
        np.float32), device=dev)
    u0 = torch.full((32,), 0.37, device=dev)
    picked, anc, cdf = _select.systematic_select(w, leaves, u0, kper=kper,
                                                 return_cdf=True)
    _, anc_p = _select.systematic_select_reference(w, leaves, u0)
    assert torch.equal(anc.long(), _select.systematic_ancestors_marks(
        cdf, u0, kper).ancestors)
    assert bool((cdf[:, 1:] >= cdf[:, :-1]).all())
    assert bool((anc[1::4] == 7).all())
    torch.testing.assert_close(cdf, torch.cumsum(w, -1), rtol=1e-5,
                               atol=1e-6 * n)
    # another scan order than torch.cumsum: a point may flip only at a
    # boundary
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
    before = _cuda.launches("ssme_svol_filter")
    svol_filter(1, params, _ys(20, 2).to(dev), num_particles=64)
    assert _cuda.launches("ssme_svol_filter") == before + 1
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


def _step_one_rule(lcl, lcl_p):
    """Phase 25's rule for two systematic runs on identical bits whose
    CDFs sum in another order: step 0 equal, and step 1 (one selection)
    within 2e-3 on at least 90% of the rows (a point within rounding of a
    CDF boundary picks the neighbour, and that row then parts)."""
    torch.testing.assert_close(lcl[:, 0], lcl_p[:, 0], rtol=1e-5, atol=1e-4)
    assert float(((lcl[:, 1] - lcl_p[:, 1]).abs() <= 2e-3).float().mean()) \
        >= 0.9


def test_megakernel_svol_instance_equals_the_svol_kernel(dev):
    """The generic kernel's svol instance draws the SVOL kernel's bits:
    with a gate that never fires the totals within 1e-3; while rows
    resample, phase 25's rule (the two kernels' CDFs sum in another
    order)."""
    ys = _ys(300, 9).to(dev)
    km, params, _ = _instance("svol", dev, ys)
    a = fm.filter_megakernel(km, 4, params, ys, num_particles=256,
                             ess_threshold=1e-6)[0]
    b = svol_filter(4, params, ys, num_particles=256, ess_threshold=1e-6)[0]
    assert float((a - b).abs().max()) <= 1e-3
    for ess in (1.0, 0.5):
        a = fm.filter_megakernel(km, 4, params, ys, num_particles=256,
                                 ess_threshold=ess)[1]
        b = svol_filter(4, params, ys, num_particles=256,
                        ess_threshold=ess)[1]
        assert torch.isfinite(b).all()
        _step_one_rule(a, b)


@pytest.mark.parametrize("gate_stride", [1, 8])
@pytest.mark.parametrize("n", [32, 96, 512, 2048, 4096])
def test_systematic_kernel_matches_plain(dev, n, gate_stride):
    """The systematic K1 (kPer neighbouring particles per thread, a
    partial last warp at N=32 and 96) on identical bits: with a gate that
    never fires the totals to phase 5's tolerance and equal zero
    patterns; every step (stride 1), phase 25's rule."""
    ys = _ys(64, 14).to(dev)
    params = torch.tensor([[1.0, 0.9, math.sqrt(0.05)]] * 16, device=dev)
    kw = dict(num_particles=n, gate_stride=gate_stride)
    tot, lcl, xm = svol_filter(5, params, ys, ess_threshold=1e-6, **kw)
    tot_p, lcl_p, xm_p = svol_filter_reference(5, params, ys,
                                               ess_threshold=1e-6, **kw)
    torch.testing.assert_close(tot, tot_p, rtol=1e-4, atol=1e-3)
    assert torch.equal(lcl != 0, lcl_p != 0)
    torch.testing.assert_close(xm, xm_p, rtol=1e-3, atol=1e-3)
    if gate_stride == 1:
        tot, lcl, _ = svol_filter(5, params, ys, ess_threshold=1.0, **kw)
        lcl_p = svol_filter_reference(5, params, ys, ess_threshold=1.0,
                                      **kw)[1]
        assert torch.isfinite(tot).all()
        _step_one_rule(lcl, lcl_p)


@pytest.mark.parametrize("n", [32, 96, 512, 1024, 2048, 4096])
def test_systematic_kernel_record_layout_and_barriers(dev, n):
    """The instrumented instance of each layout: the kPer and threads it
    ran, the barriers a step crossed (those the source note states), the
    checks and resamples of both schedules, and its outputs the plain
    kernel's bits."""
    ys = _ys(48, 15).to(dev)
    params = torch.tensor([[1.0, 0.9, math.sqrt(0.05)]] * 16, device=dev)
    kper = 2 if n <= 512 else 4 if n <= 1024 else 8
    for ess, g in ((1.0, 1), (0.5, 8)):
        rec = sfk.step_spans(6, params, ys, n, ess, g)
        assert (rec["kper"], rec["threads"]) == (kper,
                                                  -(-n // kper // 32) * 32)
        got = {k: v for k, v in rec["barriers_per_step"].items()
               if v is not None}
        assert got == {k: sfk.BARRIERS_PER_STEP[k] for k in got}
        assert rec["checks"] == (48 if g == 1 else 6)
        assert 0 < rec["resamples"] < rec["checks"] + (g == 1)
    seed = _prng.seed_words(6, device=dev)
    spans = torch.zeros((16, len(sfk.SPAN_RECORD)), dtype=torch.int64,
                        device=dev)
    plain = sfk._launch(seed, params, ys, n, 1.0, 1, "systematic", 16)
    inst = sfk._launch(seed, params, ys, n, 1.0, 1, "systematic", 16,
                       spans=spans)
    for a, b in zip(plain, inst):
        assert torch.equal(a, b)


def test_systematic_kernel_refuses_other_counts(dev):
    params = torch.tensor([[1.0, 0.9, 0.2]] * 4, device=dev)
    seed = _prng.seed_words(1, device=dev)
    ys = _ys(8, 2).to(dev)
    with pytest.raises(RuntimeError, match="CUDA error -3"):
        sfk._launch(seed, params, ys, 1056, 1.0, 1, "systematic", 16)


def test_megakernel_launch_counter_and_errors(dev):
    ys = _ys(20, 2).to(dev)
    km, params, zs = _instance("svol_leverage", dev, ys)
    before = _cuda.launches("ssme_filter_megakernel")
    fm.filter_megakernel(km, 1, params, ys, zs, num_particles=64)
    assert _cuda.launches("ssme_filter_megakernel") == before + 1
    with pytest.raises(ValueError):      # covariates on another device
        fm.filter_megakernel(km, 1, params, ys, zs.cpu(), num_particles=64)
    custom = fm.KernelModel(num_params=4, init=km.init,
                            propagate=km.propagate, log_weight=km.log_weight,
                            dim_cov=1, name="custom")
    with pytest.raises(ValueError, match="no CUDA instance"):
        fm.filter_megakernel(custom, 1, params, ys, zs, num_particles=64)
    assert _cuda.launches("ssme_filter_megakernel") == before + 1


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


@pytest.mark.parametrize("n", [32, 96, 512, 1024])
def test_megakernel_systematic_twins_record_layout_and_barriers(dev, n):
    """The systematic family's instrumented twins (svol_leverage, both
    modes) at each layout: the kPer and threads they ran, the barriers a
    step of each kind crossed (those the source note states: 3 / 2 / 0 in
    the bootstrap, 5 an APF step), the checks, and their outputs the plain
    instance's bits."""
    ys = _ys(48, 16).to(dev)
    km, params, zs = _instance("svol_leverage", dev, ys)
    kper = 2 if n <= 512 else 4
    for kw, checks in ((dict(ess_threshold=1.0), 48),
                       (dict(ess_threshold=0.5), 48),
                       (dict(ess_threshold=0.5, gate_stride=8), 6),
                       (dict(mode="apf"), 48)):
        rec = fm.step_spans(6, params, ys, zs, n, **kw)
        assert (rec["kper"], rec["threads"]) == (kper,
                                                  -(-n // kper // 32) * 32)
        got = {k: v for k, v in rec["barriers_per_step"].items()
               if v is not None}
        assert got == {k: fm.BARRIERS_PER_STEP[k] for k in got}
        assert rec["checks"] == checks
        assert rec["apf_steps"] == (47 if kw.get("mode") == "apf" else 0)
        plain = fm.filter_megakernel(km, 6, params, ys, zs, num_particles=n,
                                     **kw)
        for a, b in zip(plain, rec["outputs"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [256, 1024])
def test_factor_svol_two_leaf_resampling_matches_plain(dev, n):
    """Factor SVOL's two leaves resampled together every step through one
    gather buffer each (kPer 2 at N=256, 4 at 1024): kernel and plain mean
    log-likelihoods within 4 combined standard errors over 64 rows."""
    ys = _ys(200, 17).to(dev)
    km, params, obs = _family("factor_svol_4", dev, ys)
    tot = fm.filter_megakernel(km, 9, params, obs, num_particles=n)[0]
    tot_p = fm.filter_megakernel_reference(km, 10, params, obs,
                                           num_particles=n)[0]
    assert bool(torch.isfinite(tot).all())
    se = math.sqrt(float(tot.var()) / 64 + float(tot_p.var()) / 64)
    assert abs(float(tot.mean()) - float(tot_p.mean())) <= 4 * se


def test_factor_svol_5_hook_at_the_benchmark_cell_size(dev):
    """K2's factor_svol_5 hook at the benchmark cell's size: T=3084 steps
    of 5 columns, 64 chains x 4 replicates = 256 rows, N=1024, every-step
    resampling, at the panel's generating parameters.  Against its plain
    twin in distribution: the 64 chain log-likelihoods of each side, means
    within 4 combined standard errors.  The launch's span carries the
    instance's name as its key, and the instance's counts grow by one
    launch and B x N x T propagations."""
    from ssme_tpu_torch import profiling
    from ssme_tpu_torch.examples.estimate_factor_svol import DATA, START
    from ssme_tpu_torch.utils import logmeanexp

    ys = torch.as_tensor(np.loadtxt(DATA, delimiter=","),
                         dtype=torch.float32).contiguous().to(dev)
    assert tuple(ys.shape) == (3084, 5)
    km = fm.factor_svol_kernel_model(5)
    params = torch.tensor(START, device=dev).expand(64, -1).contiguous()
    hook = fm.megakernel_log_like(km, 1024, 4, ess_threshold=1.0)
    before = _cuda.launches("ssme_filter_megakernel", "factor_svol_5")
    profiling.reset()
    with profiling.record():
        got = hook(torch.Generator(device=dev).manual_seed(5), params, ys)
    torch.cuda.synchronize()
    keys = [r.key for r in profiling.spans()
            if r.name == "filter_megakernel.launch"]
    assert keys == ["factor_svol_5"]
    after = _cuda.launches("ssme_filter_megakernel", "factor_svol_5")
    assert after == before + 1      # 256 x 1024 x 3084 propagations
    rows = params.repeat_interleave(4, 0).contiguous()
    tot = fm.filter_megakernel_reference(km, 6, rows, ys,
                                         num_particles=1024,
                                         ess_threshold=1.0)[0]
    want = logmeanexp(tot.reshape(64, 4), dim=-1)
    assert bool(torch.isfinite(got).all())
    se = math.sqrt(float(got.var()) / 64 + float(want.var()) / 64)
    assert abs(float(got.mean()) - float(want.mean())) <= 4 * se, (
        float(got.mean()), float(want.mean()), se)


@pytest.mark.parametrize("n", [256, 1024])
def test_swarm_evidence_cloud_keeps_its_layout(dev, n):
    """The final cloud through megakernel_swarm_evidence, two leaves, with
    a gate that never fires: each thread stores its kPer neighbouring
    particles, and the cloud (leaf, draw, particle) and its weights are
    the plain version's on the same bits."""
    ys = _ys(100, 18).to(dev)
    km, params, obs = _family("factor_svol_4", dev, ys)
    kw = dict(num_particles=n, ess_threshold=1e-6, return_cloud=True)
    got = fm.megakernel_swarm_evidence(km, 5, params[:16], obs, **kw)
    want = fm.megakernel_swarm_evidence(km, 5, params[:16].cpu(), obs.cpu(),
                                        **kw)
    assert len(got["final_cloud"]) == 2
    for a, b in zip(got["final_cloud"], want["final_cloud"]):
        assert a.shape == (16, n)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(torch.exp(got["final_log_weights"].cpu()),
                               torch.exp(want["final_log_weights"]),
                               rtol=1e-3, atol=1e-3)


def test_new_instances_refuse_what_the_card_cannot_run(dev):
    ys = _ys(20, 2).to(dev)
    km, params, obs = _family("factor_svol_4", dev, ys)
    before = _cuda.launches("ssme_filter_megakernel")
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
    assert _cuda.launches("ssme_filter_megakernel") == before


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
    before = (_cuda.launches("ssme_lw_megakernel"),
              k4.svol_leverage_lw.launches)
    k4.svol_leverage_lw(1, ys, num_filters=2, num_particles=64)
    assert (_cuda.launches("ssme_lw_megakernel"),
            k4.svol_leverage_lw.launches) == (before[0] + 1, before[1] + 1)
    custom = lwm.LWKernelModel(
        num_params=4, transform_codes=km.transform_codes,
        sample_prior=km.sample_prior, init=km.init, propagate=km.propagate,
        log_weight=km.log_weight, prop_mu=km.prop_mu, dim_cov=1,
        name="custom")
    with pytest.raises(ValueError, match="no CUDA instance"):
        lwm.lw_megakernel(custom, 1, ys, zs, num_particles=64)
    with pytest.raises(ValueError, match="power of two"):
        lwm.lw_megakernel(km, 1, ys, zs, num_particles=96,
                          resampler="metropolis")
    with pytest.raises(ValueError, match="metropolis cap 4096"):
        lwm.lw_megakernel(km, 1, ys, zs, num_particles=8192,
                          resampler="rejection")
    with pytest.raises(ValueError, match="multiple of 32"):
        lwm.lw_megakernel(km, 1, ys, zs, num_particles=2048)
    with pytest.raises(ValueError):      # covariates on another device
        lwm.lw_megakernel(km, 1, ys, zs.cpu(), num_particles=64)
    assert _cuda.launches("ssme_lw_megakernel") == before[0] + 1


@pytest.mark.parametrize("n", [512, 2048, 4096])
@pytest.mark.parametrize("resampler", ["metropolis", "rejection"])
def test_roll_select_equals_plain(dev, resampler, n):
    """Identical Philox draws and weights: the roll laws compare one
    rounded product with a weight, so the ancestors are equal exactly;
    beside gamma rows, a row of zeros (rejection runs it to the 4096 cap
    and every slot keeps itself), one of a dominant particle and one of
    long zero runs."""
    rng = np.random.default_rng(n)
    w = rng.gamma(0.5, 1.0, (16, n)).astype(np.float32)
    w[0] = 0.0
    w[1] *= np.float32(1e-12)
    w[1, n // 3] = 1.0
    w[2, n // 8:n // 2] = 0.0
    w = torch.as_tensor(w, device=dev)
    leaves = torch.as_tensor(rng.normal(size=(2, 16, n)).astype(np.float32),
                             device=dev)
    before = _cuda.launches("ssme_roll_select")
    for tag in (_prng.TAG_ROLL_SWEEP, _prng.TAG_ROLL_SELECT):
        got = _select.roll_select(w, leaves, 4, step=9, resampler=resampler,
                                  metropolis_iters=24, tag=tag)
        want = _select.roll_select_reference(w, leaves, 4, step=9,
                                             resampler=resampler,
                                             metropolis_iters=24, tag=tag)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
        if resampler == "rejection":
            assert torch.equal(got[1][0].long(), torch.arange(n, device=dev))
    assert _cuda.launches("ssme_roll_select") == before + 2


ROLL_FUNCTORS = ("svol", "svol_leverage", "svol_t", "poisson_ar",
                 "factor_svol_3", "factor_svol_4", "factor_svol_5")


def _roll_instance(name, dev, ys, rows):
    if name in ("svol", "svol_leverage"):
        km, params, zs = _instance(name, dev, ys)
        return km, params[:rows].contiguous(), ys, zs
    km, params, obs = _family(name, dev, ys)
    return km, params[:rows].contiguous(), obs, None


@pytest.mark.parametrize("n", [32, 1024, 2048, 4096])
@pytest.mark.parametrize("resampler", ["metropolis", "rejection"])
def test_megakernel_roll_family_matches_plain(dev, resampler, n):
    """The generic kernel's roll family (filter_megakernel_sys.cuh at each
    kPer) for every functor, bootstrap and, with a lookahead, APF, against
    the plain version on identical bits: step 0 equal, most rows' totals
    within 2e-3 (an exp ulp can flip one accept decision)."""
    ys = _ys(24, 13).to(dev)
    roll = dict(resampler=resampler, metropolis_iters=16)
    for name in ROLL_FUNCTORS:
        km, params, obs, zs = _roll_instance(name, dev, ys, 8)
        for mode in ("bootstrap",) + (("apf",) if km.prop_mu else ()):
            kw = dict(num_particles=n, mode=mode, **roll)
            tot, lcl, _ = fm.filter_megakernel(km, 3, params, obs, zs, **kw)
            tot_p, lcl_p, _ = fm.filter_megakernel_reference(km, 3, params,
                                                             obs, zs, **kw)
            torch.testing.assert_close(lcl[:, 0], lcl_p[:, 0], rtol=1e-5,
                                       atol=1e-4, msg=f"{name} {mode}")
            assert torch.isfinite(tot).all(), (name, mode)
            close = float(((tot - tot_p).abs() <= 2e-3).float().mean())
            assert close >= 0.75, (name, mode, close)


@pytest.mark.parametrize("n", [32, 512, 1024, 2048, 4096])
def test_megakernel_roll_twins_record_layout_and_barriers(dev, n):
    """The roll family's instrumented twins (svol_leverage in both modes,
    svol's bootstrap) at each layout: the kPer and threads they ran, 2
    barriers a check and 4 an APF step besides the selections' votes and
    tail barriers (Metropolis has none), each selection's sweeps (the
    Metropolis count; under rejection 1 to 4096, one record per resample
    or first stage), and their outputs the plain instances' bits."""
    ys = _ys(48, 16).to(dev)
    kper = 2 if n <= 512 else {1024: 4, 2048: 8, 4096: 16}[n]
    for resampler in ("metropolis", "rejection"):
        for name, mode in fm.SPAN_TWINS["roll"]:
            km, params, zs = _instance(name, dev, ys)
            params = params[:8].contiguous()
            kw = dict(mode=mode, resampler=resampler, metropolis_iters=20,
                      ess_threshold=1.0 if mode == "apf" else 0.5)
            rec = fm.step_spans(6, params, ys, zs, n, kmodel=km, **kw)
            assert (rec["kper"], rec["threads"]) == (
                kper, -(-n // kper // 32) * 32)
            got = {k: v for k, v in rec["barriers_per_step"].items()
                   if v is not None}
            assert got == {k: fm.ROLL_BARRIERS_PER_STEP[k] for k in got}
            sweeps = rec["sweeps"]
            selections = int((sweeps > 0).sum())
            want = (rec["apf_steps"] if mode == "apf"
                    else rec["resamples"]) * params.shape[0]
            assert selections == want > 0
            if resampler == "metropolis":
                assert set(sweeps[sweeps > 0].tolist()) == {20}
                assert rec["votes"] == 0
            else:
                assert int(sweeps.max()) <= 4096
                assert rec["votes"] >= selections
            plain = fm.filter_megakernel(km, 6, params, ys, zs,
                                         num_particles=n, **kw)
            for a, b in zip(plain, rec["outputs"]):
                assert torch.equal(a, b)


def test_megakernel_rejection_at_2048_is_finite_and_deterministic(dev):
    ys = _ys(200, 4).to(dev)
    params = torch.tensor([[1.0, 0.9, math.sqrt(0.05)]] * 32, device=dev)
    kw = dict(num_particles=2048, ess_threshold=0.5, resampler="rejection")
    km = fm.svol_kernel_model()
    a = fm.filter_megakernel(km, 6, params, ys, **kw)
    b = fm.filter_megakernel(km, 6, params, ys, **kw)
    c = fm.filter_megakernel(km, 7, params, ys, **kw)
    assert torch.isfinite(a[0]).all() and torch.isfinite(a[1]).all()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    cloud = fm.filter_megakernel(km, 6, params, ys, return_cloud=True,
                                 **kw)
    assert torch.equal(cloud[0], a[0])
    assert cloud[3][0].shape == (32, 2048)
    with pytest.raises(ValueError, match="multiple of 32"):
        fm.filter_megakernel(km, 6, params, ys, num_particles=2048)


@pytest.mark.parametrize("resampler", ["metropolis", "rejection"])
def test_roll_filters_match_plain(dev, resampler):
    """K1, K2 (bootstrap, APF, N=512 and 2048) and K3 under a roll
    resampler against their plain versions on identical bits: step 0
    equal, most rows' totals within 2e-3 (an exp ulp can flip one accept
    decision)."""
    ys = _ys(48, 5).to(dev)
    params = torch.tensor([[1.0, 0.9, math.sqrt(0.05)]] * 16, device=dev)
    roll = dict(resampler=resampler, metropolis_iters=16)
    runs = []
    for n in (512, 2048):
        for mode in ("bootstrap", "apf"):
            kw = dict(num_particles=n, mode=mode, **roll)
            runs.append((fm.filter_megakernel(fm.svol_kernel_model(), 2,
                                              params, ys, **kw)[:2],
                         fm.filter_megakernel_reference(
                             fm.svol_kernel_model(), 2, params, ys,
                             **kw)[:2]))
    runs.append((svol_filter(2, params, ys, num_particles=512, **roll)[:2],
                 svol_filter_reference(2, params, ys, num_particles=512,
                                       **roll)[:2]))
    km, zs = _lw_instance("svol_leverage_lw", ys)
    for variant in ("apf", "sisr"):
        kw = dict(num_filters=16, num_particles=512, variant=variant, **roll)
        a = lwm.lw_megakernel(km, 2, ys, zs, **kw)
        b = lwm.lw_megakernel_reference(km, 2, ys, zs, **kw)
        runs.append(((a["log_likelihood"], a["log_cond_likes"]),
                     (b["log_likelihood"], b["log_cond_likes"])))
    for (tot, lcl), (tot_p, lcl_p) in runs:
        torch.testing.assert_close(lcl[:, 0], lcl_p[:, 0], rtol=1e-5,
                                   atol=1e-4)
        assert torch.isfinite(tot).all()
        assert float(((tot - tot_p).abs() <= 2e-3).float().mean()) >= 0.75


def test_svol_step_equals_plain(dev):
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(64, 512)).astype(np.float32),
                        device=dev)
    lw = torch.as_tensor(rng.normal(size=(64, 512)).astype(np.float32),
                         device=dev)
    params = torch.tensor([[1.3, 0.7, 0.2]] * 64, device=dev)
    before = _cuda.launches("ssme_svol_step")
    for y in (0.37, torch.full((1,), 0.37, device=dev)):
        got = k5.fused_svol_propagate_weight(5, y, params, x, lw)
        want = k5.fused_svol_propagate_weight_reference(5, y, params, x, lw)
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-5)
    assert _cuda.launches("ssme_svol_step") == before + 2
    with pytest.raises(ValueError):
        k5.fused_svol_propagate_weight(5, 0.0, params, x[:, :511], lw)


# ops/svol_kernel.py::digest of the outputs of the kernel before its
# loads and stores went through the non-coherent and streaming paths, on
# fixed_inputs with seed words (5, 0) and y 0.37 (scripts/k5_timing.py
# --bits): one and 65535 rows, an odd count of pairs, rows off 16 bytes
# (odd rows at N = 4m + 2)
K5_PARENT_DIGESTS = {
    (1, 2): "126bf0d768509143", (1, 6): "49299b55f11808c1",
    (1, 130): "885d6a0628570cb9", (1, 4098): "b12e8eb35a02ab68",
    (65535, 2): "22f741e8a7ca1100", (65535, 6): "a00de4a0fad66bbb",
    (65535, 130): "226ad2c92e656f13", (65535, 4098): "1ea52398ccbcb8c6",
    (3, 4098): "7e48262e43ac2194", (3, 516): "6e59cdd82022eab7",
}


@pytest.mark.parametrize("shape", sorted(K5_PARENT_DIGESTS))
def test_svol_step_bits_equal_the_parent_kernel(dev, shape):
    b, n = shape
    params, x, lw = k5.fixed_inputs(b, n, dev)
    seed = torch.tensor([5, 0], dtype=torch.int64, device=dev)
    got = k5.fused_svol_propagate_weight(seed, 0.37, params, x, lw)
    assert k5.digest(*got) == K5_PARENT_DIGESTS[shape]
    plain_x, _ = k5.fused_svol_propagate_weight_reference(seed, 0.37,
                                                          params, x, lw)
    assert torch.equal(got[0], plain_x)


def test_svol_step_inputs_off_16_bytes_keep_their_bits_off_8_raise(dev):
    b, n = 3, 516
    params, x, lw = k5.fixed_inputs(b, n, dev)
    seed = torch.tensor([5, 0], dtype=torch.int64, device=dev)
    buf = torch.zeros(2 * b * n + 8, device=dev)
    # 8 bytes past a 16-byte boundary
    xs = buf[2:2 + b * n].view(b, n)
    ls = buf[b * n + 6:2 * b * n + 6].view(b, n)
    xs.copy_(x)
    ls.copy_(lw)
    got = k5.fused_svol_propagate_weight(seed, 0.37, params, xs, ls)
    assert k5.digest(*got) == K5_PARENT_DIGESTS[(b, n)]
    with pytest.raises(ValueError, match="8-byte aligned"):
        k5.fused_svol_propagate_weight(seed, 0.37, params,
                                       buf[1:1 + b * n].view(b, n), lw)


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("resampler", ["systematic", "metropolis",
                                       "rejection"])
def test_svol_filter_kper_matches_plain(dev, resampler, n):
    """K1 at kPer 8 (systematic) and 8 / 16 (roll) on identical bits: with
    a gate that never fires
    the totals to float tolerance; every step, step 0 equal and most rows
    within 2e-3 (the systematic rows part at a boundary flip, so only
    their first selection's step is held)."""
    ys = _ys(48, 6).to(dev)
    params = torch.tensor([[1.0, 0.9, math.sqrt(0.05)]] * 16, device=dev)
    kw = dict(num_particles=n, resampler=resampler, metropolis_iters=16)
    a = svol_filter(3, params, ys, ess_threshold=1e-6, **kw)[0]
    b = svol_filter_reference(3, params, ys, ess_threshold=1e-6, **kw)[0]
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
    tot, lcl, _ = svol_filter(3, params, ys, ess_threshold=1.0, **kw)
    tot_p, lcl_p, _ = svol_filter_reference(3, params, ys, ess_threshold=1.0,
                                            **kw)
    torch.testing.assert_close(lcl[:, 0], lcl_p[:, 0], rtol=1e-5, atol=1e-4)
    assert torch.isfinite(tot).all()
    a, b = (lcl[:, 1], lcl_p[:, 1]) if resampler == "systematic" else (
        tot, tot_p)
    assert float(((a - b).abs() <= 2e-3).float().mean()) >= 0.9


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("resampler", ["metropolis", "rejection"])
def test_lw_megakernel_kper_matches_plain(dev, resampler, n):
    """K3's roll family at kPer 4 and 8: SISR with a gate that never fires
    equal to float tolerance; APF every step, step 0 equal and most
    filters' totals within 2e-3."""
    ys = _ys(40, 7).to(dev)
    km, zs = _lw_instance("svol_leverage_lw", ys)
    kw = dict(num_filters=8, num_particles=n, resampler=resampler,
              metropolis_iters=16)
    sis = dict(variant="sisr", ess_threshold=0.5 / n)
    got = lwm.lw_megakernel(km, 4, ys, zs, **kw, **sis)
    want = lwm.lw_megakernel_reference(km, 4, ys, zs, **kw, **sis)
    torch.testing.assert_close(got["log_likelihood"], want["log_likelihood"],
                               rtol=0, atol=2e-3)
    torch.testing.assert_close(got["cloud"][:, 2:], want["cloud"][:, 2:],
                               rtol=0, atol=1e-3)
    got = lwm.lw_megakernel(km, 4, ys, zs, **kw)
    want = lwm.lw_megakernel_reference(km, 4, ys, zs, **kw)
    torch.testing.assert_close(got["log_cond_likes"][:, 0],
                               want["log_cond_likes"][:, 0], rtol=1e-5,
                               atol=1e-4)
    assert torch.isfinite(got["log_likelihood"]).all()
    close = (got["log_likelihood"] - want["log_likelihood"]).abs() <= 2e-3
    assert float(close.float().mean()) >= 0.75


@pytest.mark.parametrize("n", [512, 2048])
def test_svol_leverage_lw_q_matches_plain(dev, n):
    """The custom SISR proposal on the card (kappa 1.5) against its plain
    version on identical bits, a gate that never fires; at kappa 1 the
    leverage instance's SISR bit for bit."""
    ys = _ys(200, 8).to(dev)
    _, zs = _lw_instance("svol_leverage_lw", ys)
    kq = lwm.svol_leverage_lw_q_kernel_model(1.5)
    resampler = "systematic" if n <= 1024 else "rejection"
    kw = dict(num_filters=8, num_particles=n, variant="sisr",
              ess_threshold=0.5 / n, resampler=resampler)
    got = lwm.lw_megakernel(kq, 9, ys, zs, **kw)
    want = lwm.lw_megakernel_reference(kq, 9, ys, zs, **kw)
    torch.testing.assert_close(got["log_likelihood"], want["log_likelihood"],
                               rtol=0, atol=2e-3)
    torch.testing.assert_close(got["cloud"][:, :1], want["cloud"][:, :1],
                               rtol=0, atol=1e-3)
    one = lwm.lw_megakernel(lwm.svol_leverage_lw_q_kernel_model(1.0), 9, ys,
                            zs, **kw)
    base = lwm.lw_megakernel(lwm.svol_leverage_lw_kernel_model(), 9, ys, zs,
                             **kw)
    assert torch.equal(one["log_cond_likes"], base["log_cond_likes"])
    assert torch.equal(one["cloud"], base["cloud"])


def test_ragged_tail_at_t131_on_the_card(dev):
    """H2: the SVOL and generic kernels at T=131 (131 mod 128 = 3 < 8) and
    gate_stride 8 against their own stride-1 runs, with a gate that never
    fires: equal totals, and the last check column is 130; the SVOL
    kernel's roll instances too."""
    ys = _ys(131, 4).to(dev)
    params = torch.tensor([[1.0, 0.9, math.sqrt(0.05)]] * 8, device=dev)
    kw = dict(num_particles=64, ess_threshold=1e-6)
    km = fm.svol_kernel_model()
    roll = [lambda g, r=r: svol_filter(5, params, ys, gate_stride=g,
                                       resampler=r, **kw)
            for r in ("metropolis", "rejection")]
    for run in [lambda g: svol_filter(5, params, ys, gate_stride=g, **kw),
                lambda g: fm.filter_megakernel(km, 5, params, ys,
                                               gate_stride=g, **kw)] + roll:
        tot1 = run(1)[0]
        tot8, lcl8, _ = run(8)
        torch.testing.assert_close(tot8, tot1, rtol=2e-4, atol=2e-4)
        cols = sorted(set(torch.nonzero(lcl8)[:, 1].tolist()))
        assert cols == list(range(7, 131, 8)) + [130]


K3_FUNCTORS = ("svol_leverage_lw", "svol_t_lw", "svol_leverage_lw_q")


def _k3_functor(name, ys):
    if name == "svol_leverage_lw_q":
        return (lwm.svol_leverage_lw_q_kernel_model(1.5),
                lagged_covariates(ys)[:, 0].contiguous())
    return _lw_instance(name, ys)


def _k3_pair(km, seed, ys, zs, f, n, **kw):
    """The systematic instance and the plain version, same bits."""
    got = lwm.lw_megakernel(km, seed, ys, zs, f, n, **kw)
    want = lwm.lw_megakernel_reference(km, seed, ys, zs, f, n, **kw)
    return got, want


@pytest.mark.parametrize("n", [32, 96, 512, 1024])
@pytest.mark.parametrize("name", K3_FUNCTORS)
def test_k3_systematic_matches_plain(dev, name, n):
    """K3's systematic family (2 neighbouring particles per thread, a
    partial last warp at N=32 and 96) against its plain version on the
    same bits: SISR with a gate that never fires within 2e-3 (the totals)
    and 1e-3 (the cloud); APF and SISR resampling every step by phase
    25's rule (step 0 equal, step 1 within 2e-3 on 90% of the filters; a
    point within rounding of a CDF boundary picks the neighbour) and the
    means within 4 combined standard errors."""
    ys = _ys(64, 17).to(dev)
    km, zs = _k3_functor(name, ys)
    f = 16
    got, want = _k3_pair(km, 12, ys, zs, f, n, variant="sisr",
                         ess_threshold=0.5 / n)
    torch.testing.assert_close(got["log_likelihood"], want["log_likelihood"],
                               rtol=0, atol=2e-3)
    s = km.num_state
    for rows in (slice(0, s), slice(s + 1, None)):
        torch.testing.assert_close(got["cloud"][:, rows],
                                   want["cloud"][:, rows], rtol=0, atol=1e-3)
    torch.testing.assert_close(lwm.lw_cloud_weights(km, got["cloud"]),
                               lwm.lw_cloud_weights(km, want["cloud"]),
                               rtol=0, atol=1e-3)
    for a, b in zip(got.get("functional_paths", ()),
                    want.get("functional_paths", ())):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    for variant in ("apf", "sisr"):
        got, want = _k3_pair(km, 13, ys, zs, f, n, variant=variant)
        tot, tot_p = got["log_likelihood"], want["log_likelihood"]
        assert torch.isfinite(tot).all()
        _step_one_rule(got["log_cond_likes"], want["log_cond_likes"])
        se = math.sqrt(float(tot.var()) / f + float(tot_p.var()) / f)
        assert abs(float(tot.mean()) - float(tot_p.mean())) <= 4 * se


@pytest.mark.parametrize("n", [32, 96, 512, 1024])
@pytest.mark.parametrize("name", K3_FUNCTORS)
def test_k3_systematic_twins_record_layout_and_barriers(dev, name, n):
    """Every functor's instrumented twin at each N: the kPer (2) and
    threads it ran, the barriers a step of each kind crossed (those the
    source note states: 8 / 7 an APF step that does / does not resample,
    5 / 4 in SISR, 3 / 2 at t = 0), and its outputs the plain instance's
    bits."""
    ys = _ys(48, 18).to(dev)
    km, zs = _k3_functor(name, ys)
    for kw in (dict(variant="apf"), dict(variant="apf", ess_threshold=0.5),
               dict(variant="sisr", ess_threshold=0.5 / n),
               dict(variant="sisr")):
        rec = lwm.step_spans(6, ys, zs, 8, n, kmodel=km, **kw)
        assert (rec["kper"], rec["threads"]) == (2, -(-n // 2 // 32) * 32)
        want = lwm.BARRIERS_PER_STEP[kw["variant"]]
        got = {k: v for k, v in rec["barriers_per_step"].items()
               if v is not None}
        assert got == {k: want[k] for k in got}
        if kw.get("ess_threshold", 0.0) == 0.0:
            assert rec["resamples"] == 47 and rec["first_resamples"] == 1
        plain = lwm.lw_megakernel(km, 6, ys, zs, 8, n, **kw)
        for key in ("log_cond_likes", "cloud"):
            assert torch.equal(plain[key], rec["outputs"][key]), key


K3_SCHEDULES = (dict(variant="apf"), dict(variant="apf", ess_threshold=0.5),
                dict(variant="sisr"), dict(variant="sisr", ess_threshold=0.5))


@pytest.mark.parametrize("n", [32, 96, 512, 1024])
@pytest.mark.parametrize("name", K3_FUNCTORS)
def test_k3_paired_layout_gives_the_single_layouts_bits(dev, name, n):
    """The systematic family's paired layout (F=8: a cluster of two CTAs a
    filter, one drawing the other's normals and offsets) gives the bits of
    the one-CTA layout (rows 0-7 of an F=128 launch, more clusters than
    the card holds at once; rows are keyed by their index): conditional
    likelihoods, cloud and functional paths, APF and SISR, every step and
    gated, each launch counted under its layout."""
    ys = _ys(40, 29).to(dev)
    km, zs = _k3_functor(name, ys)
    keys = [lwm.launch_key(name, k) for k in lwm.LAYOUTS]
    for kw in K3_SCHEDULES:
        before = [_cuda.launches("ssme_lw_megakernel", k) for k in keys]
        paired = lwm.lw_megakernel(km, 21, ys, zs, 8, n, **kw)
        single = lwm.lw_megakernel(km, 21, ys, zs, 128, n, **kw)
        assert [_cuda.launches("ssme_lw_megakernel", k)
                for k in keys] == [before[0] + 1, before[1] + 1]
        for key in ("log_cond_likes", "cloud"):
            assert torch.equal(paired[key], single[key][:8]), (kw, key)
        fp, fs = (paired.get("functional_paths", ()),
                  single.get("functional_paths", ()))
        assert len(fp) == len(fs) == len(km.functionals or ())
        for a, b in zip(fp, fs):
            assert torch.equal(a, b[:8]), kw


def test_k3_layout_counter_and_span_key(dev):
    """Each launch counts under its instance and the layout it took and
    keys its ``lw_megakernel.launch`` span by them: paired at F=8 and at
    the benchmark's F=64, single at F=128 and under a roll resampler."""
    from ssme_tpu_torch import profiling
    ys = _ys(20, 31).to(dev)
    km, zs = _k3_functor("svol_leverage_lw", ys)
    assert lwm._max_clusters(0, 512) >= 64
    runs = ((8, dict(), "svol_leverage_lw.paired"),
            (64, dict(), "svol_leverage_lw.paired"),
            (128, dict(), "svol_leverage_lw.single"),
            (8, dict(resampler="rejection"), "svol_leverage_lw.single"))
    keys = [lwm.launch_key("svol_leverage_lw", k) for k in lwm.LAYOUTS]
    before = [_cuda.launches("ssme_lw_megakernel", k) for k in keys]
    with profiling.record():
        for f, kw, _ in runs:
            if kw:
                lwm.lw_megakernel(km, 3, ys, zs, f, 512, **kw)
            else:
                k4.svol_leverage_lw(3, ys, num_filters=f, num_particles=512)
        got = [r.key for r in profiling.spans()
               if r.name == "lw_megakernel.launch"][-len(runs):]
    assert got == [want for _, _, want in runs]
    assert [_cuda.launches("ssme_lw_megakernel", k)
            for k in keys] == [before[0] + 2, before[1] + 2]


@pytest.mark.parametrize("n", [32, 512, 1024])
def test_k3_twins_report_the_ring_wait_and_cluster(dev, n):
    """The twin records the paired layout's waits on its ring and the
    CTAs a filter: 2 and a wait at F=8, 1 and no wait at F=128, the same
    barriers a step and the same bits in both; the register row has no
    fold of the moments (the wide row's part)."""
    ys = _ys(40, 33).to(dev)
    km, zs = _k3_functor("svol_leverage_lw", ys)
    paired = lwm.step_spans(4, ys, zs, 8, n, kmodel=km)
    single = lwm.step_spans(4, ys, zs, 128, n, kmodel=km)
    assert (paired["cluster"], single["cluster"]) == (2, 1)
    assert paired["cycles_per_step"]["ring_wait"] > 0
    assert single["cycles_per_step"]["ring_wait"] == 0
    assert (paired["cycles_per_step"]["moments_fold"]
            == single["cycles_per_step"]["moments_fold"] == 0)
    assert paired["barriers_per_step"] == single["barriers_per_step"]
    for key in ("log_cond_likes", "cloud"):
        assert torch.equal(paired["outputs"][key],
                           single["outputs"][key][:8]), key


@pytest.mark.parametrize("n", [32, 96, 512, 1024, 2048, 4096])
def test_systematic_twins_record_fixups_and_most_marks(dev, n):
    """Every systematic twin records its selections' fix-ups (counts whose
    first guess missed) and the most marks one thread wrote: K1 at each
    layout, and to N = 1024 K2's (svol_leverage, bootstrap and APF) and
    K3's (svol_leverage_lw, paired at F=8 and single at F=128), on SPY-like
    data and with every observation far in the tail (y = 1e4, no
    leverage).  A thread writes at most kPer + N / (32 kPer) - 1 marks.
    In K1's tail rows every step's weight sits on one particle, whose
    thread writes one mark a warp: at most 1 + N / (32 kPer).  (K2's and
    K3's tail rows may tie a few particles at the state's clamp.)"""
    ys = _ys(48, 41).to(dev)
    tail = torch.full((48,), 1e4, device=dev)

    def check(rec):
        warps = -(-n // (32 * rec["kper"]))
        assert rec["fixups"] >= 0
        assert 1 <= rec["most_marks"] <= rec["kper"] + warps - 1, rec
        return warps

    params = torch.tensor([[1.0, 0.9, math.sqrt(0.05)]] * 16, device=dev)
    check(sfk.step_spans(6, params, ys, n, 1.0, 1))
    rec = sfk.step_spans(6, params, tail, n, 1.0, 1)
    assert rec["most_marks"] == check(rec)
    assert rec["most_marks"] <= 1 + n / (32 * rec["kper"])
    if n > 1024:
        return
    _, lev, zs = _instance("svol_leverage", dev, ys)
    lev = lev[:16].contiguous()
    for data, z in ((ys, zs), (tail, torch.zeros_like(zs))):
        for mode in ("bootstrap", "apf"):
            check(fm.step_spans(6, lev, data, z, n, mode=mode))
    km, zk = _k3_functor("svol_leverage_lw", ys)
    for f in (8, 128):
        for data, z in ((ys, zk), (tail, torch.zeros_like(zk))):
            check(lwm.step_spans(6, data, z, f, n, kmodel=km))


# the roll families' kPer at each N (svol_filter_sys.cu kper_for,
# lw_megakernel_sys.cuh roll_kper_for)
K1_ROLL_KPER = {32: 2, 512: 2, 1024: 4, 2048: 8, 4096: 16}
K3_ROLL_KPER = {32: 2, 512: 2, 1024: 2, 2048: 4, 4096: 8}


@pytest.mark.parametrize("n", [32, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("resampler", ["metropolis", "rejection"])
def test_svol_filter_roll_twins_record_layout_and_barriers(dev, resampler,
                                                          n):
    """K1's roll instances at each N: the twin's kPer and threads, 2
    barriers at every check besides the selections' votes (none under
    Metropolis) and tail barriers, the selections' sweeps, both schedules,
    and its outputs the plain instance's bits; the plain instance against
    the plain version by phase 25's rule."""
    ys = _ys(48, 21).to(dev)
    params = torch.tensor([[1.0, 0.9, math.sqrt(0.05)]] * 16, device=dev)
    kper = K1_ROLL_KPER[n]
    roll = dict(resampler=resampler, metropolis_iters=16)
    for ess, g in ((1.0, 1), (0.5, 8)):
        rec = sfk.step_spans(6, params, ys, n, ess, g, **roll)
        assert (rec["kper"], rec["threads"]) == (kper,
                                                  -(-n // kper // 32) * 32)
        got = {k: v for k, v in rec["barriers_per_step"].items()
               if v is not None}
        assert got == {k: sfk.ROLL_BARRIERS_PER_STEP[k] for k in got}
        assert rec["checks"] == (48 if g == 1 else 6)
        selections = rec["resamples"] * 16
        assert 0 < selections and rec["sweeps"] >= selections
        assert (rec["votes"] == 0) == (resampler == "metropolis")
        plain = svol_filter(6, params, ys, n, ess, g, **roll)
        for a, b in zip(plain, rec["outputs"]):
            assert torch.equal(a, b)
    tot, lcl, _ = svol_filter(6, params, ys, n, 1.0, **roll)
    tot_p, lcl_p, _ = svol_filter_reference(6, params, ys, n, 1.0, **roll)
    torch.testing.assert_close(lcl[:, 0], lcl_p[:, 0], rtol=1e-5, atol=1e-4)
    assert float(((tot - tot_p).abs() <= 2e-3).float().mean()) >= 0.75


@pytest.mark.parametrize("n", [32, 512, 1024])
@pytest.mark.parametrize("resampler", ["metropolis", "rejection"])
@pytest.mark.parametrize("name", K3_FUNCTORS)
def test_k3_roll_family_matches_plain(dev, name, resampler, n):
    """K3's roll family for every functor (2 neighbouring particles a
    thread to N=1024, a partial warp at 32) against its plain version on
    the same bits: SISR with a gate that never fires within 2e-3 (the
    totals) and 1e-3 (the cloud); APF and SISR every step, step 0 equal
    and most filters' totals within 2e-3 (an expf against torch.exp ulp
    can flip one accept decision), the means within 4 combined standard
    errors."""
    ys = _ys(48, 22).to(dev)
    km, zs = _k3_functor(name, ys)
    f = 16
    roll = dict(resampler=resampler, metropolis_iters=16)
    got, want = _k3_pair(km, 12, ys, zs, f, n, variant="sisr",
                         ess_threshold=0.5 / n, **roll)
    torch.testing.assert_close(got["log_likelihood"], want["log_likelihood"],
                               rtol=0, atol=2e-3)
    s = km.num_state
    for rows in (slice(0, s), slice(s + 1, None)):
        torch.testing.assert_close(got["cloud"][:, rows],
                                   want["cloud"][:, rows], rtol=0, atol=1e-3)
    for variant in ("apf", "sisr"):
        got, want = _k3_pair(km, 13, ys, zs, f, n, variant=variant, **roll)
        tot, tot_p = got["log_likelihood"], want["log_likelihood"]
        assert torch.isfinite(tot).all()
        torch.testing.assert_close(got["log_cond_likes"][:, 0],
                                   want["log_cond_likes"][:, 0], rtol=1e-5,
                                   atol=1e-4)
        assert float(((tot - tot_p).abs() <= 2e-3).float().mean()) >= 0.75
        se = math.sqrt(float(tot.var()) / f + float(tot_p.var()) / f)
        assert abs(float(tot.mean()) - float(tot_p.mean())) <= 4 * se + 1e-3


@pytest.mark.parametrize("n", [32, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("name", K3_FUNCTORS)
def test_k3_roll_twins_record_layout_and_barriers(dev, name, n):
    """Every functor's roll twin at each N under both resamplers: the kPer
    and threads it ran, the barriers a step of each kind crossed besides
    the selections' (the systematic family's: 8 / 7 an APF step, 5 / 4 in
    SISR, 3 / 2 at t = 0), votes under rejection only, and its outputs the
    plain instance's bits."""
    ys = _ys(40, 23).to(dev)
    km, zs = _k3_functor(name, ys)
    kper = K3_ROLL_KPER[n]
    for resampler in ("metropolis", "rejection"):
        roll = dict(resampler=resampler, metropolis_iters=16)
        for kw in (dict(variant="apf"),
                   dict(variant="apf", ess_threshold=0.5),
                   dict(variant="sisr")):
            rec = lwm.step_spans(6, ys, zs, 8, n, kmodel=km, **kw, **roll)
            assert (rec["kper"], rec["threads"]) == (
                kper, -(-n // kper // 32) * 32)
            want = lwm.BARRIERS_PER_STEP[kw["variant"]]
            got = {k: v for k, v in rec["barriers_per_step"].items()
                   if v is not None}
            assert got == {k: want[k] for k in got}
            assert rec["sweeps"] > 0
            assert (rec["votes"] == 0) == (resampler == "metropolis")
            plain = lwm.lw_megakernel(km, 6, ys, zs, 8, n, **kw, **roll)
            for key in ("log_cond_likes", "cloud"):
                assert torch.equal(plain[key], rec["outputs"][key]), key


def test_param_pack_runs_on_cuda_tensors(dev):
    names = ("null", "log", "logit", "twice_fisher")
    vals = torch.tensor([1.0, -1.3, 9.5, 0.89])
    pp = ParamPack(vals.to(dev), names)
    cpu = ParamPack(vals, names)
    for got, want in ((pp.get_untrans_params(), cpu.get_untrans_params()),
                      (pp.get_untrans_params(1, 2),
                       cpu.get_untrans_params(1, 2)),
                      (pp.get_log_jacobian(), cpu.get_log_jacobian())):
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    inc = ParamPack.empty(2).add_param_and_transform(
        torch.tensor(0.5, device=dev), "log").add_param_and_transform(
        0.3, "logit", is_transformed=False)
    assert inc.get_trans_params().device.type == "cuda"
    torch.testing.assert_close(inc.get_untrans_params().cpu(),
                               torch.tensor([math.exp(0.5), 0.3]))


def test_fixed_lag_smoother_runs_on_cuda_tensors(dev):
    params = torch.tensor([0.8, 0.5, 0.7], device=dev)
    _, ys = lgssm.simulate(torch.Generator(device=dev).manual_seed(7),
                           params, 120)
    smooth = fixed_lag_smoother(lgssm.make_model(), num_particles=4096,
                                lag=8)
    sm, filt, ll = smooth(torch.Generator(device=dev).manual_seed(3),
                          params, ys)
    assert sm.device.type == filt.device.type == ll.device.type == "cuda"
    assert sm.shape == filt.shape == (120, 1)
    rts, _ = lgssm.kalman_smoother(params, ys)
    kf_lls, _, _ = lgssm.kalman_filter(params, ys)
    # the Monte-Carlo tolerances of tests/test_smoothing.py at N=4096
    assert float((sm[:112, 0] - rts[:112]).abs().mean()) < 0.05
    assert abs(float(ll) - float(kf_lls.sum())) < 1.5


# the parallel package at one rank over NCCL (chip_smoke phase 35 at a
# smaller width)

@pytest.fixture
def nccl_mesh(dev, tmp_path):
    import torch.distributed as dist

    from ssme_tpu_torch import parallel

    parallel.initialize_distributed("file://" + str(tmp_path / "store"), 1,
                                    0, "cuda", timeout=120)
    try:
        assert dist.get_backend() == "nccl"
        yield parallel.make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _svol_chain_params(dev, chains):
    from ssme_tpu_torch.models import svol

    trans = torch.tensor(svol.START_TRANS_THETA) + 0.05 * torch.as_tensor(
        np.random.default_rng(3).normal(size=(chains, 3)),
        dtype=torch.float32)
    return svol.make_model().transform.constrain(trans).to(dev)


def test_fold_generator_on_the_card_is_host_only_and_reproducible(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    twin = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = _prng.fold_generator(gen, 3)
        b = _prng.fold_generator(twin, 3)
        c = _prng.fold_generator(gen, 3)      # gen has moved on
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert a.device.type == "cuda"
    assert a.initial_seed() == b.initial_seed() != c.initial_seed()

    def offset(g):
        return int.from_bytes(bytes(g.get_state()[8:].tolist()), "little")

    # each fold moves its generator's Philox offset on by one call
    assert offset(gen) == offset(twin) + 4


@pytest.mark.parametrize("kernel", ["svol_filter", "filter_megakernel"])
def test_sharded_hook_is_its_inner_hook_on_the_folded_generator_nccl(
        dev, nccl_mesh, kernel):
    from ssme_tpu_torch import parallel

    ys = _ys(256, 4).to(dev)
    params = _svol_chain_params(dev, 8)
    if kernel == "svol_filter":
        inner = sfk.svol_batched_log_like(512, 2, ess_threshold=0.5,
                                          gate_stride=8)
        sharded = parallel.shard_batched_log_like(inner, nccl_mesh)
        counter = "ssme_svol_filter"
    else:
        kw = dict(constrain=svol.kernel_rows, ess_threshold=0.5,
                  gate_stride=8)
        inner = fm.megakernel_log_like(fm.svol_kernel_model(), 512, 2, **kw)
        sharded = parallel.sharded_megakernel_log_like(
            fm.svol_kernel_model(), 512, 2, nccl_mesh, **kw)
        counter = "ssme_filter_megakernel"
    gen = torch.Generator(device=dev).manual_seed(9)
    ref = torch.Generator(device=dev)
    ref.set_state(gen.get_state())
    before = _cuda.launches(counter)
    got = sharded(gen, params, ys)
    assert _cuda.launches(counter) == before + 1
    want = inner(_prng.fold_generator(ref, 0), params, ys)
    assert got.device.type == "cuda" and got.shape == (8,)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())


def test_sharded_pmmh_is_run_from_at_one_rank_nccl(dev, nccl_mesh):
    from ssme_tpu_torch import parallel
    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.models import svol

    ys = _ys(256, 5).to(dev)
    pmmh = AdaptivePMMH(svol.make_model(), num_particles=512,
                        num_replicates=2, t0=2, t1=50,
                        batched_log_like=sfk.svol_batched_log_like(512, 2))
    a = pmmh.init(0, svol.START_TRANS_THETA, ys, num_chains=8)
    b = pmmh.init(0, svol.START_TRANS_THETA, ys, num_chains=8)
    res = parallel.sharded_pmmh(pmmh, nccl_mesh, 5)(
        parallel.shard_chain_state(a, nccl_mesh), ys)
    ref = pmmh.run_from(b, 5, ys)
    for k in ("samples", "log_likes", "accepted", "accept_rate"):
        assert torch.equal(getattr(res, k), getattr(ref, k)), k


def test_initialize_distributed_on_cuda_raises_without_a_card(dev,
                                                              tmp_path):
    import os
    import sys

    from _bounded import run_bounded

    script = (
        "import sys; sys.path.insert(0, {root!r})\n"
        "import torch.distributed as dist\n"
        "from ssme_tpu_torch.parallel import initialize_distributed\n"
        "try:\n"
        "    initialize_distributed({init!r}, 1, 0, 'cuda')\n"
        "except RuntimeError as e:\n"
        "    print('raised', dist.is_initialized(), e)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = run_bounded(
        [sys.executable, "-c", script.format(
            root=root, init="file://" + str(tmp_path / "store"))],
        timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised False"), out.stdout


def _parity_pmmh(dev):
    """The parity cell's sampler: C=64 chains x R=4 replicates x N=512
    over the T=3084 SPY returns (x 100), K1's batched hook, resampling
    every step; and its data on the card."""
    import os

    from ssme_tpu_torch.inference import AdaptivePMMH
    from ssme_tpu_torch.models import svol

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ys = torch.as_tensor(np.loadtxt(os.path.join(root, "data",
                                                 "spy_returns.csv")),
                         dtype=torch.float32).to(dev)
    assert ys.shape == (3084,)
    pmmh = AdaptivePMMH(svol.make_model(), num_particles=512,
                        num_replicates=4, t0=150, t1=1000,
                        batched_log_like=sfk.svol_batched_log_like(
                            512, 4, ess_threshold=1.0))
    return pmmh, pmmh.init(7, svol.START_TRANS_THETA, ys, num_chains=64), ys


def test_pmmh_iteration_never_waits_for_the_device(dev):
    """Three draw + step iterations at the parity cell's shapes make no
    synchronising call (``inference/pmmh.py``'s claim), spans and all."""
    pmmh, state, ys = _parity_pmmh(dev)
    torch.cuda.synchronize()
    before = _cuda.launches("ssme_svol_filter")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            eps, log_u = pmmh.draw(state)
            state, _ = pmmh.step(state, ys, eps, log_u)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert state.iteration == 3
    assert _cuda.launches("ssme_svol_filter") - before == 3
    assert bool(torch.isfinite(state.log_like).all())


def test_k1_launches_lie_inside_their_program_spans(dev):
    """In a profiler window the host launch of every K1 kernel lies
    inside a ``svol_filter.launch`` span: the program's spans and the
    profiler's events share one clock on the card."""
    from torch.profiler import ProfilerActivity, profile

    from ssme_tpu_torch import profiling

    pmmh, state, ys = _parity_pmmh(dev)
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eps, log_u = pmmh.draw(state)
            state, _ = pmmh.step(state, ys, eps, log_u)
        torch.cuda.synchronize()
    spans = [r for r in profiling.spans() if r.name == sfk.HOST_SPANS[0]]
    assert len(spans) == 3
    events = prof.profiler.kineto_results.events()
    launches = {ev.correlation_id(): ev.start_ns() for ev in events
                if ev.device_type() == torch.autograd.DeviceType.CPU
                and ev.name().startswith("cu")}
    k1 = [ev for ev in events if "svol_filter_sys_kernel" in ev.name()
          and ev.device_type() != torch.autograd.DeviceType.CPU]
    assert len(k1) == 3
    for ev in k1:
        at = launches[ev.correlation_id()]
        assert any(r.start_ns <= at <= r.end_ns for r in spans), at


# -- K3's wide row: factor SVOL, 21 parameters a particle --------------------

def _factor_panel(t_len, dev):
    """The benchmark's 5-column panel's first t_len rows."""
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark", "data",
        "factor_svol_5_returns.csv")
    ys = np.loadtxt(path, delimiter=",", ndmin=2)[:t_len]
    return torch.as_tensor(ys, dtype=torch.float32, device=dev).contiguous()


def _k3_factor_close(km, ys, f, n):
    """The factor instance and its plain version, SISR with a gate that
    never fires, over ys: the totals within 2e-3 plus 2e-5 of the total,
    the cloud, the weights and the two functional paths within 1e-3."""
    got, want = _k3_pair(km, 12, ys, None, f, n, variant="sisr",
                         ess_threshold=0.5 / n)
    torch.testing.assert_close(got["log_likelihood"],
                               want["log_likelihood"], rtol=2e-5, atol=2e-3)
    s = km.num_state
    for rows in (slice(0, s), slice(s + 1, None)):
        torch.testing.assert_close(got["cloud"][:, rows],
                                   want["cloud"][:, rows], rtol=0, atol=1e-3)
    torch.testing.assert_close(lwm.lw_cloud_weights(km, got["cloud"]),
                               lwm.lw_cloud_weights(km, want["cloud"]),
                               rtol=0, atol=1e-3)
    for a, b in zip(got["functional_paths"], want["functional_paths"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)


def _k3_factor_statistical(km, ys, f, n, seed=13):
    """The factor instance and its plain version, APF and SISR resampling
    every step: phase 25's step-one rule and the means within 4 combined
    standard errors."""
    for variant in ("apf", "sisr"):
        got, want = _k3_pair(km, seed, ys, None, f, n, variant=variant)
        tot, tot_p = got["log_likelihood"], want["log_likelihood"]
        assert torch.isfinite(tot).all()
        _step_one_rule(got["log_cond_likes"], want["log_cond_likes"])
        se = math.sqrt(float(tot.var()) / f + float(tot_p.var()) / f)
        assert abs(float(tot.mean()) - float(tot_p.mean())) <= 4 * se


def _far_factor_model():
    """factor_svol_5_lw with mu2 (a null transform) drawn from a box 1e-2
    wide at -20: a cloud mean some 7000 times its spread, the case the
    wide row's moments take their shift for."""
    bounds = list(lwm.FACTOR_SVOL_5_PRIOR_BOUNDS)
    bounds[3] = (-20.005, -19.995)
    far = lwm.factor_svol_lw_kernel_model(5, tuple(bounds))
    assert far.cuda_instance == "factor_svol_5_lw"
    return far


@pytest.mark.parametrize("n", [32, 96, 512, 1024])
def test_k3_factor_matches_plain(dev, n):
    """The factor_svol_5_lw instance (the wide row: theta in shared
    memory, the moments on the FP64 tensor cores, the factor by one warp)
    against its plain version on the same bits, as K3's other functors:
    SISR with a gate that never fires within 2e-3 (the totals; plus 2e-5
    of the total, the same tolerance a nat: the 5-column densities sum to
    ~300 nats over these 48 steps where the one-column instances' sum to
    ~100) and 1e-3 (the cloud, the weights and the two functional paths;
    the moments sum in another order and the draws' products fused); APF
    and SISR resampling every step by phase 25's rule and the means
    within 4 combined standard errors.  The no-selection comparison runs
    at N = 512 and 1024: at N = 32 and 96 the weights of SISR without a
    resample settle on a few particles within these steps, Vt spans fewer
    than 21 directions, and whether a pivot falls under the Cholesky's
    rank rule (1e-4 of its diagonal) is a matter of rounding, so the two
    versions' kernel draws part by a few 1e-3 there (each step from one
    state: test_k3_factor_steps_match_plain_from_one_state).  At N = 1024
    both comparisons run again on _far_factor_model."""
    ys = _factor_panel(48, dev)
    km = lwm.factor_svol_lw_kernel_model()
    f = 16
    if n >= 512:
        _k3_factor_close(km, ys, f, n)
    _k3_factor_statistical(km, ys, f, n)
    if n == 1024:
        far = _far_factor_model()
        _k3_factor_close(far, ys, f, n)
        _k3_factor_statistical(far, ys, f, n, seed=14)


# each step of the factor instance from the kernel's own state: the
# largest gap a step may leave in the cloud, its weights and functional
# paths, and in its log-likelihood term (about ten times the largest
# read on the card: 1.9e-6, 5.5e-6 and 1.6e-5)
STEP_CLOUD_ATOL, STEP_LCL_ATOL = 2e-5, 1e-4


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("n", [32, 512, 1024])
def test_k3_factor_steps_match_plain_from_one_state(dev, n, far):
    """Every step t = 1 .. 47 of the factor instance, SISR with a gate
    that never fires, against the plain version's step t from the same
    state: the cloud the kernel returns over ys[:t] (the plain version's
    ``start``), so that no step inherits the steps before it and the rank
    rule cannot part the two versions through a cloud that rounding has
    already moved.  From one state both take the same moments and, the
    plain version's Cholesky and kernel draws taking the kernel's fused
    products and reciprocal square root, the same factor and theta'.
    The cloud, its weights and the two functional paths within
    STEP_CLOUD_ATOL, the step's log-likelihood term within STEP_LCL_ATOL,
    at every step, on the default box and on _far_factor_model."""
    ys = _factor_panel(48, dev)
    km = _far_factor_model() if far else lwm.factor_svol_lw_kernel_model()
    kw = dict(variant="sisr", ess_threshold=0.5 / n)
    f, s = 16, km.num_state
    rows = torch.cat([torch.arange(s),
                      torch.arange(s + 1, s + 1 + km.num_params)])
    before = lwm.lw_megakernel(km, 12, ys[:1], None, f, n, **kw)
    for t in range(1, ys.shape[0]):
        def at(m, t=t):
            return f"step {t}: {m}"

        got = lwm.lw_megakernel(km, 12, ys[:t + 1], None, f, n, **kw)
        want = lwm.lw_megakernel_reference(km, 12, ys[:t + 1], None, f, n,
                                           start=(t, before["cloud"]), **kw)
        torch.testing.assert_close(got["cloud"][:, rows],
                                   want["cloud"][:, rows], rtol=0,
                                   atol=STEP_CLOUD_ATOL, msg=at)
        torch.testing.assert_close(lwm.lw_cloud_weights(km, got["cloud"]),
                                   lwm.lw_cloud_weights(km, want["cloud"]),
                                   rtol=0, atol=STEP_CLOUD_ATOL,
                                   msg=at)
        for a, b in zip(got["functional_paths"], want["functional_paths"]):
            torch.testing.assert_close(a[:, t], b[:, t], rtol=0,
                                       atol=STEP_CLOUD_ATOL, msg=at)
        torch.testing.assert_close(got["log_cond_likes"][:, t],
                                   want["log_cond_likes"][:, t], rtol=0,
                                   atol=STEP_LCL_ATOL, msg=at)
        before = got


@pytest.mark.parametrize("n", [32, 96, 512, 1024])
def test_k3_factor_twin_records_parts_and_gives_the_instance_bits(dev, n):
    """The wide row's instrumented twin at each N and schedule, in both
    layouts (F=8 paired, F=128 one CTA a filter): kPer 2, its threads and
    CTAs a filter, the barriers the source note states (11 / 9 an APF step
    that does / does not resample, 9 / 7 in SISR, 4 / 2 at t = 0; the
    moments' 3 the cloud published, the tensor cores' partial tiles and
    the fold), the moments' pass, their fold and the Cholesky timed apart,
    a ring wait iff paired, and its outputs the plain instance's bits."""
    ys = _factor_panel(40, dev)
    km = lwm.factor_svol_lw_kernel_model()
    for f, cluster in ((8, 2), (128, 1)):
        for kw in K3_SCHEDULES:
            rec = lwm.step_spans(6, ys, None, f, n, kmodel=km, **kw)
            assert (rec["kper"], rec["threads"], rec["cluster"]) == (
                2, -(-n // 2 // 32) * 32, cluster)
            want = lwm.barriers_per_step(km, kw["variant"])
            got = {k: v for k, v in rec["barriers_per_step"].items()
                   if v is not None}
            assert got == {k: want[k] for k in got}, (f, kw)
            cycles = rec["cycles_per_step"]
            assert all(cycles[k] > 0 for k in ("moments", "moments_fold",
                                               "cholesky"))
            assert (cycles["ring_wait"] > 0) == (cluster == 2)
            plain = lwm.lw_megakernel(km, 6, ys, None, f, n, **kw)
            for key in ("log_cond_likes", "cloud"):
                assert torch.equal(plain[key], rec["outputs"][key]), (
                    f, kw, key)
            for a, b in zip(plain["functional_paths"],
                            rec["outputs"]["functional_paths"]):
                assert torch.equal(a, b), (f, kw)


@pytest.mark.parametrize("n", [32, 96, 512, 1024])
def test_k3_factor_layouts_agree_where_both_launch(dev, n):
    """The wide row's paired layout (F=8: a cluster of two CTAs a filter,
    its ring of one step after the cloud) gives the bits of the one-CTA
    layout (rows 0-7 of an F=128 launch), every schedule, each launch
    counted and its span keyed under factor_svol_5_lw and its layout; the
    card holds at least the benchmark's 64 clusters; a roll resampler
    raises."""
    from ssme_tpu_torch import profiling
    ys = _factor_panel(24, dev)
    km = lwm.factor_svol_lw_kernel_model()
    assert lwm._max_clusters(lwm.CUDA_LW_MODEL_IDS["factor_svol_5_lw"],
                             n) >= 64
    keys = [lwm.launch_key("factor_svol_5_lw", k) for k in lwm.LAYOUTS]
    for kw in K3_SCHEDULES:
        before = [_cuda.launches("ssme_lw_megakernel", k) for k in keys]
        with profiling.record():
            paired = lwm.lw_megakernel(km, 21, ys, None, 8, n, **kw)
            single = lwm.lw_megakernel(km, 21, ys, None, 128, n, **kw)
            spans = [r.key for r in profiling.spans()
                     if r.name == "lw_megakernel.launch"][-2:]
        assert spans == keys
        assert [_cuda.launches("ssme_lw_megakernel", k)
                for k in keys] == [before[0] + 1, before[1] + 1]
        for k in ("log_cond_likes", "cloud"):
            assert torch.equal(paired[k], single[k][:8]), (kw, k)
        for a, b in zip(paired["functional_paths"],
                        single["functional_paths"]):
            assert torch.equal(a, b[:8]), kw
    with pytest.raises(ValueError, match="systematic"):
        lwm.lw_megakernel(km, 1, ys, None, 8, 512, resampler="rejection")
