"""The port's roll-based resamplers (``ssme_tpu_torch/ops/_select.py``, the
plain versions of ``csrc/roll_select.cuh``) against the JAX package's
``metropolis_select_leaves`` and ``rejection_select_leaves`` in an
interpret-mode ``pallas_call``, and the Metropolis sweep budget against
JAX's.

One tape of random words drives both sides.  JAX turns a signed word s
into the accept uniform ((f32(s) + 2^31) + 1) 2^-32, the port an unsigned
word w into ((w >> 8) + 1) 2^-24.  The tapes hold k in [2^16 - 1,
2^24 - 2] and give JAX s = (k + 1) 256 - 2^31 and the port w = k << 8:
then f32(s) is exact, f32(s) + 2^31 = (k + 1) 256 exactly, and the + 1 is
rounded away at and above 2^24, so both uniforms are (k + 1) 2^-24 and
every accept decision is the same compare.  Shift words are shared as
they are (JAX reads them as unsigned, the port masks to 32 bits).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ssme_tpu.ops import _select as jsel
from ssme_tpu_torch.ops import _prng
from ssme_tpu_torch.ops import _select as sel

torch.set_num_threads(1)
B = 8


def _uniform_words(rng, shape):
    """(JAX int32 words, port words) giving equal uniforms (docstring)."""
    k = rng.integers(2 ** 16 - 1, 2 ** 24 - 1, size=shape, dtype=np.int64)
    return ((k + 1) * 256 - 2 ** 31).astype(np.int32), k << 8


@functools.lru_cache(maxsize=None)
def _metropolis_runner(b, n, num_iters):
    def kernel(w_ref, bits_ref, ids_ref, out_ref):
        counter = [0]

        def draw_bits(shape):
            k = int(np.prod(shape))
            flat = bits_ref[0, counter[0]:counter[0] + k]
            counter[0] += k
            return flat.reshape(shape)

        (out_ref[:],) = jsel.metropolis_select_leaves(
            w_ref[:], [ids_ref[:]], draw_bits, num_iters=num_iters)

    call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(
        (b, n), jnp.float32), interpret=True)
    return jax.jit(call)


@functools.lru_cache(maxsize=None)
def _rejection_runner(b, n, max_iters):
    def kernel(w_ref, tape_ref, ids_ref, out_ref):
        def draw_bits_at(t, shape):
            if shape == (1, 1):
                return tape_ref[t, pl.dslice(0, 1)][None, :]
            k = int(np.prod(shape))
            return tape_ref[t, pl.dslice(1, k)].reshape(shape)

        (out_ref[:],) = jsel.rejection_select_leaves(
            w_ref[:], [ids_ref[:]], None, max_iters=max_iters,
            draw_bits_at=draw_bits_at)

    call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(
        (b, n), jnp.float32), interpret=True)
    return jax.jit(call)


def _ids(b, n):
    return np.tile(np.arange(n, dtype=np.float32), (b, 1))


def _tape_draw(shifts, uniforms):
    """The port's ``draw(s, k, sub)`` over a tape: shifts (S,) shared by
    every row, uniforms (S, B, N)."""
    def draw(s, k, sub):
        sh = torch.from_numpy(shifts[s:s + k] & 0xFFFFFFFF)
        u = _prng.uniform_open_zero(torch.from_numpy(uniforms[s:s + k]))
        if sub is not None:
            u = u[:, sub]
        rows = u.shape[1]
        return sh[:, None].expand(k, rows), u
    return draw


@pytest.mark.parametrize("weights", ["gamma", "peaked"])
def test_metropolis_ancestors_equal_jax_on_one_tape(weights):
    rng = np.random.default_rng(1 if weights == "gamma" else 2)
    n, iters = 256, 16
    w = rng.gamma(1.0 if weights == "gamma" else 0.2, 1.0,
                  (B, n)).astype(np.float32)
    shifts = rng.integers(-2 ** 31, 2 ** 31, size=iters, dtype=np.int64)
    u_jax, u_port = _uniform_words(rng, (iters, B, n))
    bits = np.concatenate([shifts.astype(np.int32),
                           u_jax.reshape(-1)])[None, :]
    got_jax = np.asarray(_metropolis_runner(B, n, iters)(
        jnp.asarray(w), jnp.asarray(bits), jnp.asarray(_ids(B, n))))
    ids = torch.from_numpy(_ids(B, n))[None]
    picked, anc = sel.metropolis_select(torch.from_numpy(w), ids,
                                        _tape_draw(shifts, u_port), iters)
    np.testing.assert_array_equal(picked[0].numpy(), got_jax)
    np.testing.assert_array_equal(anc.numpy(), got_jax.astype(np.int32))
    # the chains moved: most slots left their start
    assert (anc.numpy() != np.arange(n)).mean() > 0.5


@pytest.mark.parametrize("weights", ["gamma", "one_heavy"])
def test_rejection_ancestors_equal_jax_on_one_tape(weights):
    rng = np.random.default_rng(3 if weights == "gamma" else 4)
    n, max_iters = 128, 256
    if weights == "gamma":
        w = rng.gamma(1.0, 1.0, (B, n)).astype(np.float32)
    else:
        w = np.full((B, n), 0.1, np.float32)
        w[:, 37] = 5.0
    shifts = rng.integers(-2 ** 31, 2 ** 31, size=max_iters, dtype=np.int64)
    u_jax, u_port = _uniform_words(rng, (max_iters, B, n))
    tape = np.concatenate([shifts.astype(np.int32)[:, None],
                           u_jax.reshape(max_iters, -1)], axis=1)
    got_jax = np.asarray(_rejection_runner(B, n, max_iters)(
        jnp.asarray(w), jnp.asarray(tape), jnp.asarray(_ids(B, n))))
    ids = torch.from_numpy(_ids(B, n))[None]
    picked, anc = sel.rejection_select(torch.from_numpy(w), ids,
                                       _tape_draw(shifts, u_port), max_iters)
    np.testing.assert_array_equal(picked[0].numpy(), got_jax)
    np.testing.assert_array_equal(anc.numpy(), got_jax.astype(np.int32))
    if weights == "one_heavy":
        assert (anc[:, 37] == 37).all()


def test_uniform_words_convert_equally():
    rng = np.random.default_rng(5)
    u_jax, u_port = _uniform_words(rng, (4096,))
    k = np.array([2 ** 16 - 1, 2 ** 24 - 2])
    u_jax = np.concatenate([u_jax, ((k + 1) * 256 - 2 ** 31).astype(np.int32)])
    u_port = np.concatenate([u_port, k << 8])
    jx = np.asarray((jnp.asarray(u_jax).astype(jnp.float32) + 2147483648.0
                     + 1.0) * jnp.float32(2.0 ** -32))
    pt = _prng.uniform_open_zero(torch.from_numpy(u_port)).numpy()
    np.testing.assert_array_equal(jx, pt)


def test_rejection_offspring_counts_unbiased():
    """E[offspring of i] = N w_i / sum w: the Philox-driven plain law over
    many steps (independent draws) matches the weights."""
    n, trials = 128, 60
    w_row = np.linspace(0.5, 2.0, n).astype(np.float32)
    w = torch.from_numpy(np.tile(w_row, (B, 1)))
    seed = _prng.seed_words(11)
    counts = np.zeros(n)
    for step in range(trials):
        anc = sel.rejection_ancestors(
            w, sel.philox_draw(seed, torch.arange(B), step, n))
        counts += np.bincount(anc.numpy().ravel(), minlength=n)
    freqs = counts / counts.sum()
    # 61440 slots; se(freq) ~ sqrt(p / 61440) ~ 3.6e-4 at p ~ 1/128
    np.testing.assert_allclose(freqs, w_row / w_row.sum(), atol=1.4e-3)


def test_rejection_stops_at_max_iters():
    """All-zero weights never accept: the loop ends at max_iters and every
    slot keeps itself; one nonzero weight drains every slot to it."""
    n = 64
    seed = _prng.seed_words(3)
    draw = sel.philox_draw(seed, torch.arange(2), 0, n)
    anc = sel.rejection_ancestors(torch.zeros((2, n)), draw, max_iters=40)
    assert torch.equal(anc, torch.arange(n).expand(2, n))
    w = torch.zeros((2, n))
    w[:, 9] = 1.0
    anc = sel.rejection_ancestors(w, draw)
    assert (anc == 9).all()


def test_roll_select_moves_leaves_jointly_and_takes_the_kernels_draws():
    rng = np.random.default_rng(6)
    n = 256
    w = torch.from_numpy(rng.gamma(1.0, 1.0, (B, n)).astype(np.float32))
    vals = torch.from_numpy(rng.normal(size=(B, n)).astype(np.float32))
    leaves = torch.stack([torch.arange(n, dtype=torch.float32).expand(B, n),
                          vals]).contiguous()
    for resampler in ("metropolis", "rejection"):
        picked, anc = sel.roll_select(w, leaves, 5, step=3,
                                      resampler=resampler,
                                      metropolis_iters=12)
        assert anc.dtype == torch.int32
        assert torch.equal(picked[0].long(), anc.long())
        assert torch.equal(picked[1], torch.gather(vals, 1, anc.long()))
        draw = sel.philox_draw(_prng.seed_words(5), torch.arange(B), 3, n)
        assert torch.equal(anc.long(), sel.roll_ancestors(
            resampler, w, draw, metropolis_iters=12))
        other, _ = sel.roll_select(w, leaves, 5, step=3, resampler=resampler,
                                   metropolis_iters=12,
                                   tag=_prng.TAG_ROLL_SELECT)
        assert not torch.equal(other, picked)


def test_sweep_draws_follow_the_counter_mapping():
    """Slot j's uniform is word 0 of counter (j, t, b, tag + s); the row's
    shift is word 1 of counter (0, t, b, tag + s)."""
    seed = _prng.seed_words(21)
    shift, u = _prng.roll_sweep_draws(seed, torch.tensor([0, 5]), 7, 3, 64,
                                      tag=_prng.TAG_ROLL_SELECT, count=2)
    assert shift.shape == (2, 2) and u.shape == (2, 2, 64)
    for s in range(2):
        for r, b in enumerate((0, 5)):
            for j in (0, 1, 63):
                words = _prng.philox4x32_10(
                    torch.tensor(j), torch.tensor(7), torch.tensor(b),
                    torch.tensor(_prng.TAG_ROLL_SELECT + 3 + s), seed[0],
                    seed[1])
                assert float(u[s, r, j]) == float(
                    _prng.uniform_open_zero(words[0]))
                if j == 0:
                    assert int(shift[s, r]) == int(words[1])
    assert ((u > 0) & (u <= 1)).all()
    with pytest.raises(ValueError):
        _prng.roll_sweep_draws(seed, torch.arange(2), 0, 4095, 64, count=2)


def test_power_of_two_and_argument_checks():
    draw = sel.philox_draw(_prng.seed_words(1), torch.arange(2), 0, 384)
    for fn in (sel.metropolis_ancestors, sel.rejection_ancestors):
        with pytest.raises(ValueError, match="power-of-two"):
            fn(torch.ones((2, 384)), draw)
    leaves = torch.zeros((1, 2, 384))
    for kw in (dict(), dict(resampler="systematic"),
               dict(resampler="metropolis", metropolis_iters=0)):
        with pytest.raises(ValueError):
            sel.roll_select(torch.ones((2, 384)), leaves, 0, **kw)
    ok = torch.ones((2, 64)), torch.zeros((1, 2, 64))
    for kw in (dict(tag=1), dict(resampler="multinomial"), dict(step=-1)):
        with pytest.raises(ValueError):
            sel.roll_select(*ok, 0, **kw)
    with pytest.raises(ValueError, match="power of two"):
        sel.roll_select(torch.ones((1, 8192)), torch.zeros((1, 1, 8192)), 0)
    with pytest.raises(ValueError, match="multiple of 32"):
        sel.check_particles(2048)
    sel.check_particles(4096, "rejection")
    with pytest.raises(ValueError, match=r"\[32, 1024\].*the advice"):
        sel.check_particles(2048, "metropolis", roll_cap=1024,
                            beyond="the advice")
    # the SVOL kernel's systematic cap: multiples of 128 up to 4096
    sel.check_particles(1152, systematic_cap=4096)
    for n in (1100, 8192):
        with pytest.raises(ValueError, match="multiple of 128 up to 4096"):
            sel.check_particles(n, systematic_cap=4096)


@pytest.mark.parametrize("ess", [0.5, 0.9, 1.0])
def test_metropolis_budget_equals_jax(ess):
    for t_len in (64, 500, 3084, 10000):
        for iters in (4, 8, 16, 32, 102, 256):
            assert sel.metropolis_bias_estimate(iters, t_len, ess) == \
                jsel.metropolis_bias_estimate(iters, t_len, ess)
        for budget in (0.01, 0.1, 0.5, 1.0, 5.0):
            for max_sweeps in (256, 1 << 20):
                try:
                    want = jsel.metropolis_sweeps_for(budget, t_len, ess,
                                                      max_sweeps)
                except ValueError:
                    with pytest.raises(ValueError, match="rejection"):
                        sel.metropolis_sweeps_for(budget, t_len, ess,
                                                  max_sweeps)
                    continue
                assert sel.metropolis_sweeps_for(budget, t_len, ess,
                                                 max_sweeps) == want
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError):
            jsel.metropolis_sweeps_for(bad, 3084)
        with pytest.raises(ValueError, match="positive"):
            sel.metropolis_sweeps_for(bad, 3084)
    # the PMMH hook's default at SPY's length and ESS 0.5
    assert sel.metropolis_sweeps_for(0.5, 3084, 0.5) == 102
