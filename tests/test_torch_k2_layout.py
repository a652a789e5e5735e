"""Plain models of the generic filter kernel's systematic family for Hopper
(``ssme_tpu_torch/csrc/filter_megakernel_sys.cuh`` on ``csrc/row_select.cuh``):
paired draws for a functor of any number of draws, the selection and the
gather of a multi-leaf state through one padded buffer per leaf, and the
APF first stage's LSE from the CDF's total; and the plain K2 under
systematic selection against the JAX package's filters.

The models use the kernel's arithmetic in float32, so they pin down what
the kernel must compute; ``test_torch_kernels_cuda.py`` holds the kernel
itself to the plain filter on a card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu.filters import AuxiliaryParticleFilter as JaxAPF
from ssme_tpu.filters import replicated_log_like_fn as jax_bank
from ssme_tpu.models import factor_svol as jfac
from ssme_tpu.models import svol as jsvol
from ssme_tpu.models import svol_leverage as jlev
from ssme_tpu_torch.models import factor_svol
from ssme_tpu_torch.ops import _prng
from ssme_tpu_torch.ops import filter_megakernel as fm
from ssme_tpu_torch.ops._select import (kernel_cdf, systematic_ancestors,
                                        systematic_ancestors_marks)

torch.set_num_threads(1)
KPERS = (2, 4)


class _PairRng:
    """``kernel_models.cuh`` PairRng for the pairs ``q`` of a row at a
    step: draw k of the first particles is one Philox call on counter
    (q, t, b, tag of draw k) and one Box-Muller, whose cosine it returns
    and whose sine it keeps."""

    def __init__(self, seed, q, t, b):
        self._key = (seed[0] & _prng.MASK32, seed[1] & _prng.MASK32)
        self._q, self._t, self._b = q, t, b
        self.sine = []

    def normal(self, shape):
        q = self._q
        w0, w1, _, _ = _prng.philox4x32_10(
            q, torch.full_like(q, self._t), torch.full_like(q, self._b),
            torch.full_like(q, _prng.normal_tag(len(self.sine))), *self._key)
        cos, sin = _prng.box_muller(w0, w1)
        self.sine.append(sin.reshape(shape))
        return cos.reshape(shape)


class _PairSines:
    """``kernel_models.cuh`` PairSines: the second particles' draws, the
    sines the first particles' draws kept, in their order."""

    def __init__(self, first):
        self._sine, self._draw = first.sine, 0

    def normal(self, shape):
        self._draw += 1
        return self._sine[self._draw - 1]


def _pairs(n, kper):
    """The pair indices thread by thread (thread i owns particles
    kper * i + p, so pairs (kper / 2) i + qq), and the particle each
    pair's first and second draw go to."""
    q = torch.arange(n // 2)
    i, qq = q // (kper // 2), q % (kper // 2)
    return q, kper * i + 2 * qq, kper * i + 2 * qq + 1


@pytest.mark.parametrize("kper", KPERS)
def test_pair_rng_gives_the_bits_of_normals_steps(kper):
    """Factor SVOL's two draws through the pair rng: draw k of particle
    2q and 2q + 1 (one Philox call and one Box-Muller) are
    normals_steps(..., draw=k)'s, for k = 0 and 1, every pair once, and
    the factor instance's propagate hook fed the pairs moves both leaves
    exactly as the plain version's rng makes it."""
    seed = _prng.seed_words(0x2545F4914F6CDD1D)
    n, rows, steps = 256, torch.tensor([0, 7]), torch.tensor([1, 63])
    want = [_prng.normals_steps(seed, rows, steps, n, draw=k) for k in (0, 1)]
    q, even, odd = _pairs(n, kper)
    assert sorted(torch.cat([even, odd]).tolist()) == list(range(n))
    assert bool((odd == even + 1).all()) and bool((even % 2 == 0).all())
    km = fm.factor_svol_kernel_model(4)
    gen = torch.Generator().manual_seed(4)
    p = factor_svol.make_model(4, 2).sample_prior(gen)[None]
    x = tuple(torch.randn(1, n, generator=gen) for _ in range(2))
    y = tuple(torch.randn(4, generator=gen).unbind())
    for si, t in enumerate(steps.tolist()):
        for ri, b in enumerate(rows.tolist()):
            first = _PairRng(seed, q, t, b)
            draws = [first.normal((n // 2,)) for _ in range(2)]
            second = _PairSines(first)
            for k in (0, 1):
                assert torch.equal(draws[k], want[k][si, ri, even])
                assert torch.equal(second.normal((n // 2,)),
                                   want[k][si, ri, odd])
            # the hook, pair by pair: the first particles, then the second
            first = _PairRng(seed, q, t, b)
            moved_even = km.propagate(first, p, tuple(v[:, even] for v in x),
                                      y, ())
            moved_odd = km.propagate(_PairSines(first), p,
                                     tuple(v[:, odd] for v in x), y, ())
            plain = _prng.StepBlocks(seed, torch.tensor([b]), n, t + 1)
            ref = km.propagate(plain.at(t), p, x, y, ())
            for leaf, (a, c) in enumerate(zip(moved_even, moved_odd)):
                assert torch.equal(a, ref[leaf][:, even]), leaf
                assert torch.equal(c, ref[leaf][:, odd]), leaf


def _padded(j):
    """row_select.cuh padded: one pad word after every 32 entries."""
    return j + j // 32


def _walk_and_gather(w, leaves, u0, kper):
    """The kernel's resample of a multi-leaf state: every leaf staged in
    padded shared arrays (leaf l at l * stride) beside the selection's
    marks, the count-and-mark selection on the CDF, and each leaf gathered
    by the same ancestors.  Returns (moved leaves (L, B, N), ancestors
    (B, N), the CDF)."""
    num_leaves, b, n = leaves.shape
    cdf, total = kernel_cdf(w, kper)
    assert torch.equal(cdf[:, -1], total)
    stride = _padded(n)
    buf = torch.full((b, num_leaves * stride), float("nan"))
    at = _padded(torch.arange(n))
    for leaf in range(num_leaves):
        buf[:, leaf * stride + at] = leaves[leaf]
    anc = systematic_ancestors_marks(cdf, u0, kper).ancestors
    moved = torch.stack([torch.gather(buf, 1, leaf * stride + _padded(anc))
                         for leaf in range(num_leaves)])
    return moved, anc, cdf


@pytest.mark.parametrize("kper", KPERS)
@pytest.mark.parametrize("n", [32, 96, 256])
def test_two_leaf_walk_and_gather_move_both_leaves_by_one_ancestry(n, kper):
    """Factor SVOL's two leaves through one padded buffer each: both move
    by the same ancestors, which are the binary search's on the kernel's
    CDF (which never falls); with integer weights every sum is exact, so
    they are ``systematic_ancestors``' on the same weights."""
    rng = np.random.default_rng(n + kper)
    rows = 8
    u0 = torch.from_numpy(rng.uniform(0.0, 1.0, rows).astype(np.float32))
    leaves = torch.stack([
        torch.arange(n, dtype=torch.float32).expand(rows, n),
        torch.from_numpy(rng.normal(size=(rows, n)).astype(np.float32))])
    for case in ("gamma", "integer"):
        if case == "gamma":
            w = torch.from_numpy(rng.gamma(1.0, 1.0, (rows, n))
                                 .astype(np.float32))
            w[:2, n // 4:n // 2] = 0.0
        else:
            w = torch.from_numpy(rng.integers(0, 5, (rows, n))
                                 .astype(np.float32))
        moved, anc, cdf = _walk_and_gather(w, leaves, u0, kper)
        assert bool((cdf[:, 1:] >= cdf[:, :-1]).all())
        total = cdf[:, -1:]
        u = torch.minimum((torch.arange(n)[None] + u0[:, None]) * (total / n),
                          total)
        search = torch.clamp(torch.searchsorted(cdf, u, side="left"),
                             max=n - 1)
        assert torch.equal(anc, search)
        assert torch.equal(moved[0], anc.to(torch.float32))
        assert torch.equal(moved[1], torch.gather(leaves[1], 1, anc))
        if case == "integer":
            assert torch.equal(cdf, torch.cumsum(w, dim=-1))
            assert torch.equal(anc, systematic_ancestors(w, u0))


# the APF first stage's LSE from the CDF's total against logsumexp: the
# kernel's float32 sum (kper serial adds, a 5-level lane scan, the warps
# chained) is within a few ulp of the total, so within 1e-5 nats
LSE_TOL = 1e-5


@pytest.mark.parametrize("kper", KPERS)
@pytest.mark.parametrize("n", [32, 96, 256])
def test_apf_first_stage_lse_from_the_cdf_total(n, kper):
    """LSE(fsw) = max + log(the CDF's chained total of exp(fsw - max)), as
    the APF step takes it from the first stage's sum exchange, equals
    ``torch.logsumexp`` (float32 and float64) within LSE_TOL."""
    rng = np.random.default_rng(3 * n + kper)
    fsw = torch.from_numpy((rng.normal(size=(8, n)) * 4.0 - 30.0)
                           .astype(np.float32))
    fsw[0, : n // 2] = -1e30        # negligible particles
    m = torch.amax(fsw, dim=-1, keepdim=True)
    _, total = kernel_cdf(torch.exp(fsw - m), kper)
    lse = m[:, 0] + torch.log(total)
    torch.testing.assert_close(lse, torch.logsumexp(fsw, dim=-1), rtol=0,
                               atol=LSE_TOL)
    torch.testing.assert_close(
        lse.double(), torch.logsumexp(fsw.double(), dim=-1), rtol=0,
        atol=LSE_TOL)


def _leverage_ys(t_len, seed):
    rng = np.random.default_rng(seed)
    phi, mu, sigma, rho = LEV
    x, y_prev, ys = 0.0, 0.0, np.empty(t_len, np.float32)
    for t in range(t_len):
        if t:
            x = (mu + phi * (x - mu) + y_prev * rho * sigma * math.exp(-x / 2)
                 + sigma * math.sqrt(1 - rho * rho) * rng.normal())
        ys[t] = math.exp(x / 2) * rng.normal()
        y_prev = ys[t]
    return ys


LEV = (0.9, 0.0, 0.15, -0.3)
ROWS, CALLS, N, T = 8, 4, 256, 64


def _jax_and_port(case):
    """(JAX totals, the plain K2's totals) over CALLS calls of ROWS rows,
    N=256, T=64, every-step selection (APF: every step)."""
    keys = jax.random.split(jax.random.key(5), CALLS)
    ys = _leverage_ys(T, 21)
    if case == "svol_leverage/bootstrap":
        zs = np.concatenate([[0.0], ys[:-1]]).astype(np.float32)
        bank = jax_bank(jlev.make_model(), N, 1)
        theta = jnp.tile(jnp.asarray(LEV), (ROWS, 1))
        want = [bank(k, theta, jnp.asarray(ys)[:, None],
                     jnp.asarray(zs)[:, None]) for k in keys]
        km, rows, obs = (fm.svol_leverage_kernel_model(),
                         torch.tensor([LEV] * ROWS), torch.from_numpy(ys))
        cov = torch.from_numpy(zs)
        mode = "bootstrap"
    elif case == "svol/apf":
        theta = (1.0, 0.9, 0.05)
        japf = JaxAPF(jsvol.make_model(), N)
        want = [jax.vmap(lambda k: japf.run(
            k, jnp.asarray(theta), jnp.asarray(ys)[:, None])
            .log_likelihood)(jax.random.split(k, ROWS)) for k in keys]
        km, obs, cov, mode = fm.svol_kernel_model(), torch.from_numpy(ys), \
            None, "apf"
        rows = fm.svol_kernel_rows(torch.tensor([theta] * ROWS))
    else:
        jp = jfac.make_model(4, 2).sample_prior(jax.random.key(11))
        gen = torch.Generator().manual_seed(11)
        p = torch.from_numpy(np.array(jp, np.float32))
        _, fys = factor_svol.simulate(gen, p, T, 4, 2)
        bank = jax_bank(jfac.make_model(4, 2), N, 1)
        want = [bank(k, jnp.tile(jp[None], (ROWS, 1)),
                     jnp.asarray(fys.numpy())) for k in keys]
        km, rows, obs, cov, mode = (fm.factor_svol_kernel_model(4),
                                    p.expand(ROWS, -1).contiguous(), fys,
                                    None, "bootstrap")
    got = [fm.filter_megakernel(km, seed, rows, obs, cov, num_particles=N,
                                ess_threshold=1.0, mode=mode)[0]
           for seed in range(CALLS)]
    return (np.concatenate([np.asarray(w, np.float64) for w in want]),
            torch.cat(got).double().numpy())


@pytest.mark.parametrize("case", ["svol_leverage/bootstrap", "svol/apf",
                                  "factor_svol_4/bootstrap"])
def test_plain_k2_systematic_matches_jax_in_distribution(case):
    """The plain K2 under systematic selection (every step), which the
    card's systematic family is held to, against the JAX package's
    filters (its generic bank; SVOL's APF against its
    AuxiliaryParticleFilter; factor SVOL's two-leaf state against the
    bank of its factor model): 32 totals a side, means within 4 combined
    standard errors."""
    want, got = _jax_and_port(case)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    se = math.sqrt(got.var(ddof=1) / got.size + want.var(ddof=1) / want.size)
    assert abs(got.mean() - want.mean()) <= 4 * se, (got.mean(), want.mean())
