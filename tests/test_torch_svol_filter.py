"""The port's SVOL filter bank (``ssme_tpu_torch/ops/svol_filter_kernel.py``
and the generic ``filters/bootstrap.py``) against the JAX package.

On the CPU ``svol_filter`` runs its plain version, which consumes the
CUDA kernel's Philox bits step by step; ``test_torch_kernels_cuda.py``
holds the kernel itself to that plain version on a card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu.filters import replicated_log_like_fn as jax_bank
from ssme_tpu.models import svol as jsvol
from ssme_tpu.ops.svol_filter_kernel import svol_filter_pallas
from ssme_tpu_torch.filters import replicated_log_like_fn
from ssme_tpu_torch.models import svol
from ssme_tpu_torch.ops.svol_filter_kernel import (svol_batched_log_like,
                                                   svol_filter,
                                                   svol_filter_reference)

torch.set_num_threads(1)

THETA = (1.0, 0.9, 0.05)          # constrained (beta, phi, ss)


def _simulate_svol(t_len, seed=0):
    rng = np.random.default_rng(seed)
    beta, phi, ss = THETA
    x = rng.normal() * math.sqrt(ss / (1 - phi * phi))
    ys = np.empty(t_len, np.float32)
    for t in range(t_len):
        if t:
            x = phi * x + math.sqrt(ss) * rng.normal()
        ys[t] = beta * math.exp(x / 2) * rng.normal()
    return ys


def _kernel_rows(b):
    beta, phi, ss = THETA
    return torch.tensor([[beta, phi, math.sqrt(ss)]] * b)


@pytest.mark.parametrize("schedule", ["every_step", "ess_half", "generic"])
def test_matches_jax_bank_in_distribution(schedule):
    """64 rows, N=256, T=200 simulated SVOL: mean log-likelihoods within
    4 combined standard errors of the JAX generic bank at the same
    schedule (every step with every step; ESS 0.5 with ESS 0.5)."""
    rows, n = 64, 256
    ys = _simulate_svol(200)
    jax_ess = 0.5 if schedule == "ess_half" else None
    bank = jax_bank(jsvol.make_model(), n, 1, ess_threshold=jax_ess)
    want = np.asarray(bank(jax.random.key(1),
                           jnp.tile(jnp.asarray(THETA), (rows, 1)),
                           jnp.asarray(ys)[:, None]))
    if schedule == "generic":
        port = replicated_log_like_fn(svol.make_model(), n, 1)
        got = port(torch.Generator().manual_seed(2),
                   torch.tensor([THETA] * rows), torch.from_numpy(ys))
    else:
        ess = 1.0 if schedule == "every_step" else 0.5
        got, _, _ = svol_filter_reference(3, _kernel_rows(rows),
                                          torch.from_numpy(ys),
                                          num_particles=n,
                                          ess_threshold=ess)
    got = got.double().numpy()
    se = math.sqrt(got.var(ddof=1) / rows + want.var(ddof=1) / rows)
    assert np.isfinite(got).all()
    assert abs(got.mean() - want.mean()) < 4 * se, (got.mean(), want.mean())


def test_gate_stride_matches_pallas_check_columns():
    """A gate that never fires (ESS >= 1 > 128e-6): strides 1 and 4 run
    the same SIS filter on the same bits, so totals agree to rounding
    (2e-4), and the stride-4 check columns are the Pallas kernel's."""
    ys = 0.3 * torch.ones(19)
    params = torch.tensor([[1.0, 0.5, 0.1]] * 8)
    kw = dict(num_particles=128, ess_threshold=1e-6)
    tot1, lcl1, xm1 = svol_filter(3, params, ys, **kw)
    tot4, lcl4, xm4 = svol_filter(3, params, ys, gate_stride=4, **kw)
    torch.testing.assert_close(tot4, tot1, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(lcl4.sum(-1), tot4, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lcl4[:, 18], lcl1[:, 16:].sum(-1),
                               rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(xm4[:, 7], xm1[:, 7], rtol=2e-4, atol=2e-4)
    _, jl4, _ = svol_filter_pallas(
        3, jnp.tile(jnp.array([[1.0, 0.5, 0.1]]), (8, 1)), jnp.asarray(ys),
        num_particles=128, interpret=True, steps_per_cell=8,
        ess_threshold=1e-6, gate_stride=4)
    port_cols = sorted(set(np.nonzero(lcl4.numpy())[1].tolist()))
    jax_cols = sorted(set(np.nonzero(np.asarray(jl4))[1].tolist()))
    assert port_cols == jax_cols == [3, 7, 11, 15, 18]
    assert (lcl4[:, [c for c in range(19) if c not in port_cols]] == 0).all()


def test_ragged_tail_at_t131_keeps_every_step():
    """T=131, g=8: 131 mod 128 = 3 < 8 is the case the Pallas kernel's
    padded steps wipe; the port loops to T exactly, so with a gate that
    never fires its totals equal its own stride-1 totals, and the last
    check column is 130."""
    ys = torch.from_numpy(_simulate_svol(131, seed=4))
    params = _kernel_rows(8)
    kw = dict(num_particles=64, ess_threshold=1e-6)
    tot1, _, _ = svol_filter(5, params, ys, **kw)
    tot8, lcl8, _ = svol_filter(5, params, ys, gate_stride=8, **kw)
    torch.testing.assert_close(tot8, tot1, rtol=2e-4, atol=2e-4)
    cols = sorted(set(np.nonzero(lcl8.numpy())[1].tolist()))
    assert cols == list(range(7, 131, 8)) + [130]


def test_wrapper_validation():
    p, ys = _kernel_rows(8), torch.ones(16)
    for bad in [dict(params=torch.ones(8, 2)),
                dict(num_particles=100), dict(num_particles=8192),
                dict(num_particles=1100),
                dict(params=p.double()), dict(ys=torch.ones(16, 2)),
                dict(params=torch.ones(3, 8).T),
                dict(seed=torch.zeros(3, dtype=torch.int64)),
                dict(gate_stride=4, ess_threshold=1.0),
                dict(gate_stride=0, ess_threshold=0.5)]:
        kw = dict(seed=0, params=p, ys=ys, num_particles=64)
        kw.update(bad)
        with pytest.raises(ValueError):
            svol_filter(**kw)


def test_batched_hook_is_chain_major_and_seeded_by_the_generator():
    ys = torch.from_numpy(_simulate_svol(60, seed=6))
    ll = svol_batched_log_like(64, 4, ess_threshold=0.5, gate_stride=4)
    params = torch.tensor([THETA, THETA, (1.0, 0.9, 2.0)])
    a = ll(torch.Generator().manual_seed(0), params, ys)
    b = ll(torch.Generator().manual_seed(0), params, ys)
    assert a.shape == (3,) and torch.equal(a, b)
    assert abs(float(a[0] - a[1])) < 2.0 and float(a[2]) < float(a[0]) - 5


@pytest.mark.parametrize("resampler", ["metropolis", "rejection"])
def test_roll_resamplers_match_jax_bank_in_distribution(resampler):
    """32 rows, N=256, T=64 simulated SVOL at ESS 0.5: the plain K1 under
    each roll resampler within 4 combined standard errors of the JAX bank
    (Metropolis, 32 sweeps: plus its bias envelope); above 4096 particles
    the roll options raise and point to the generic bank."""
    from ssme_tpu_torch.ops._select import metropolis_bias_estimate
    rows, n, iters = 32, 256, 32
    ys = _simulate_svol(64, seed=3)
    bank = jax_bank(jsvol.make_model(), n, 1, ess_threshold=0.5)
    want = np.asarray(bank(jax.random.key(4),
                           jnp.tile(jnp.asarray(THETA), (rows, 1)),
                           jnp.asarray(ys)[:, None]))
    got, _, _ = svol_filter(6, _kernel_rows(rows), torch.from_numpy(ys),
                            num_particles=n, ess_threshold=0.5,
                            resampler=resampler, metropolis_iters=iters)
    got = got.double().numpy()
    assert np.isfinite(got).all()
    se = math.sqrt(got.var(ddof=1) / rows + want.var(ddof=1) / rows)
    slack = (metropolis_bias_estimate(iters, 64, 0.5)
             if resampler == "metropolis" else 0.0)
    assert abs(got.mean() - want.mean()) <= 4 * se + slack
    with pytest.raises(ValueError, match="replicated_log_like_fn"):
        svol_filter(6, _kernel_rows(8), torch.from_numpy(ys),
                    num_particles=8192, resampler=resampler)
    with pytest.raises(ValueError, match="power of two"):
        svol_filter(6, _kernel_rows(8), torch.from_numpy(ys),
                    num_particles=384, resampler=resampler)


@pytest.mark.parametrize("resampler", ["systematic", "rejection"])
def test_kper_counts_match_jax_bank_in_distribution(resampler):
    """16 rows, N=2048 (the kernel's two particles per thread), T=40
    simulated SVOL at ESS 0.5: the plain K1 within 4 combined standard
    errors of the JAX bank (``BootstrapFilter``, systematic)."""
    rows, n = 16, 2048
    ys = _simulate_svol(40, seed=7)
    bank = jax_bank(jsvol.make_model(), n, 1, ess_threshold=0.5)
    want = np.asarray(bank(jax.random.key(5),
                           jnp.tile(jnp.asarray(THETA), (rows, 1)),
                           jnp.asarray(ys)[:, None]))
    got, _, _ = svol_filter(8, _kernel_rows(rows), torch.from_numpy(ys),
                            num_particles=n, ess_threshold=0.5,
                            resampler=resampler)
    got = got.double().numpy()
    assert np.isfinite(got).all()
    se = math.sqrt(got.var(ddof=1) / rows + want.var(ddof=1) / rows)
    assert abs(got.mean() - want.mean()) <= 4 * se


def test_particle_caps_and_their_texts():
    """Up to 1024 a multiple of 32, above it a multiple of 128 to 4096 (a
    power of two under the roll resamplers); above 4096 the error points
    to the generic bank."""
    p, ys = _kernel_rows(2), torch.ones(4)
    for n, resampler in ((1152, "systematic"), (4096, "systematic"),
                         (4096, "metropolis")):
        tot, _, _ = svol_filter(0, p, ys, num_particles=n,
                                resampler=resampler)
        assert torch.isfinite(tot).all()
    for n, resampler, msg in (
            (1056, "systematic", "multiple of 128 up to 4096"),
            (4224, "systematic", "generic bank"),
            (3072, "rejection", "power of two in \\[32, 4096\\]"),
            (8192, "metropolis", "generic bank")):
        with pytest.raises(ValueError, match=msg):
            svol_filter(0, p, ys, num_particles=n, resampler=resampler)
