"""Counter-based random numbers for the filter kernels: Philox4x32-10.

Replaces the TPU hardware PRNG helpers of ``ssme_tpu/ops/_prng.py``.  The
CUDA side is ``csrc/philox.cuh``; this module holds the plain PyTorch
version, which consumes exactly the same bits, and the wrapper of the
standalone ``philox_fill`` kernel.

The mapping (the only place it is written down):

- key: two 32-bit seed words (k0, k1), read from a device tensor of shape
  (2,), int64, each in [0, 2^32);
- counter: (c0, c1, c2, c3) = (particle-pair index i >> 1, step t,
  filter row b, stream tag).  Tags:
  - 0: normal draw 0 of a step, the init / propagate normals (the only
    draw of the SVOL kernel, so the generic kernel's svol instance
    consumes exactly its bits);
  - 1: the resampling offset (counter (0, t, b, 1)); in the generic
    filter kernel's APF mode, which has no other resample, the
    first-stage selection offset of step t;
  - 2: not drawn by the filters (``inference/pmmh.py::chain_generators``
    seeds chains with counter (c, 0, 0, 2) under the run's seed);
  - 2 + k: normal draw k >= 1 of a step, for model hooks that draw more
    than one normal per particle per step (``normal_tag``);
  - 2^31: the prior uniforms of the Liu-West kernel, drawn at t = 0 only:
    uniform k of particle i in row b is word k & 3 of counter
    (i, k >> 2, b, 2^31), so the step word holds the block k >> 2
    (``prior_uniforms``);
  - 2^31 + 1: the second offset of a Liu-West step, the auxiliary-PF
    first-stage selection (counter (0, t, b, 2^31 + 1)); the joint
    resample after the weights keeps tag 1;
  - 0xC0000000 + s, s < 4096: sweep s of a step's roll resample (the
    metropolis and rejection resamplers, ``csrc/roll_select.cuh``): slot
    j's accept uniform is ``uniform_open_zero`` of word 0 of counter
    (j, t, b, tag), the row's shift word is word 1 of counter
    (0, t, b, tag); the shift accumulates modulo 2^32 and slot j proposes
    particle (j - c) mod N (``roll_sweep_draws``);
  - 0xE0000000 + s, s < 4096: the same for an auxiliary-PF first-stage
    selection under a roll resampler (the generic and Liu-West kernels'
    APF modes);
  - 0xA0000000: the shard fold (:func:`fold_generator`, the counterpart
    of ``jax.random.fold_in(key, shard)``): counter (shard, c1, c2, tag)
    under key (k0, k1) taken from the generator's host-side state gives
    the 64-bit seed (w0 << 32) | w1 of the shard's generator;
- Philox4x32-10 (Salmon et al. 2011; the Random123 constants) gives four
  words (w0, w1, w2, w3);
- normals: u1 = ((w0 >> 8) + 1) 2^-24 in (0, 1],
  u2 = (w1 >> 8) 2^-24 in [0, 1), r = sqrt(-2 log u1), a = 2 pi u2 (all
  float32); particle 2j takes r cos a and particle 2j+1 takes r sin a;
- prior uniform: (w >> 8) 2^-24 in [0, 1), as the normals' u2;
- offset: ((w0 >> 9) + 0.5) 2^-23 in (0, 1), never 0 (a zero offset makes
  slot 0 select a zero-weight particle) and never 1.  It uses 23 bits
  where the normals use 24 because (w0 >> 9) + 0.5 is exact in float32,
  while (w0 >> 8) + 0.5 rounds to 2^24, an offset of exactly 1, at the
  top word;
- w2, w3 are drawn but unused, except by the prior uniforms.

Every conversion is an integer operation followed by one exact multiply,
so kernel and plain version agree bitwise up to the library's log, sqrt,
cos and sin.  The plain Philox runs in int64: a 32 x 32-bit product can
exceed the signed range and wraps modulo 2^64, so the high word is
``(p >> 32) & 0xFFFFFFFF`` with the mask after the shift.
"""

from __future__ import annotations

import torch

from ssme_tpu_torch.ops import _cuda

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
TAG_NORMAL = 0
TAG_OFFSET = 1
TAG_CHAIN = 2
TAG_PRIOR_UNIFORM = 1 << 31
TAG_SELECT_OFFSET = (1 << 31) + 1
TAG_ROLL_SWEEP = 0xC0000000
TAG_ROLL_SELECT = 0xE0000000
TAG_SHARD_FOLD = 0xA0000000
ROLL_MAX_ITERS = 4096
TWO_PI = 6.283185307179586
HALF_LOG_2PI = 0.9189385332046727
_INV_2_24 = 2.0 ** -24
_INV_2_23 = 2.0 ** -23


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit values (broadcast
    together); returns the four output words as int64 in [0, 2^32)."""
    for _ in range(10):
        p0 = c0 * PHILOX_M0
        p1 = c2 * PHILOX_M1
        hi0, lo0 = (p0 >> 32) & MASK32, p0 & MASK32
        hi1, lo1 = (p1 >> 32) & MASK32, p1 & MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & MASK32
        k1 = (k1 + PHILOX_W1) & MASK32
    return c0, c1, c2, c3


def seed_words(seed, device=None) -> torch.Tensor:
    """(2,) int64 key words from a Python int or an existing tensor."""
    if isinstance(seed, torch.Tensor):
        if seed.shape != (2,) or seed.dtype != torch.int64:
            raise ValueError("seed tensor must be (2,) int64 words")
        return seed
    seed = int(seed)
    return torch.tensor([seed & MASK32, (seed >> 32) & MASK32],
                        dtype=torch.int64, device=device)


def uniform_open_zero(w):
    """u in (0, 1] from a word."""
    return ((w >> 8) + 1).to(torch.float32) * _INV_2_24


def uniform_closed_zero(w):
    """u in [0, 1) from a word."""
    return (w >> 8).to(torch.float32) * _INV_2_24


def uniform_offset(w):
    """Systematic offset in (0, 1) from a word (never 0)."""
    return ((w >> 9).to(torch.float32) + 0.5) * _INV_2_23


def box_muller(w0, w1):
    """Paired Box-Muller: (r cos a, r sin a)."""
    u1 = uniform_open_zero(w0)
    u2 = uniform_closed_zero(w1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    a = TWO_PI * u2
    return r * torch.cos(a), r * torch.sin(a)


def _key(seed):
    return seed[0] & MASK32, seed[1] & MASK32


def normal_tag(draw: int) -> int:
    """Counter tag of normal draw ``draw`` of a step (the mapping above)."""
    if not 0 <= draw < TAG_PRIOR_UNIFORM - TAG_CHAIN:
        raise ValueError(f"draw must be in [0, 2^31 - 2), got {draw}")
    return TAG_NORMAL if draw == 0 else TAG_CHAIN + draw


def normals_steps(seed, rows, steps, num_particles, draw=0):
    """Standard normals (len(steps), len(rows), num_particles) of the
    given filter rows at the given steps, draw ``draw`` of each step, as
    the kernels draw them."""
    k0, k1 = _key(seed)
    pair = torch.arange(num_particles // 2, device=seed.device)[None, None]
    t = steps.to(torch.int64)[:, None, None]
    b = rows.to(torch.int64)[None, :, None]
    w0, w1, _, _ = philox4x32_10(pair, t, b, torch.full_like(
        pair, normal_tag(draw)), k0, k1)
    zc, zs = box_muller(w0, w1)
    return torch.stack([zc, zs], dim=-1).reshape(
        steps.shape[0], rows.shape[0], num_particles)


def offsets_steps(seed, rows, steps, tag=TAG_OFFSET):
    """Offsets (len(steps), len(rows)) of stream ``tag``: the resampling
    offsets, or with ``TAG_SELECT_OFFSET`` the Liu-West first-stage
    selection offsets."""
    k0, k1 = _key(seed)
    t = steps.to(torch.int64)[:, None]
    b = rows.to(torch.int64)[None, :]
    zero = torch.zeros_like(t)
    w0, _, _, _ = philox4x32_10(zero, t, b, zero + tag, k0, k1)
    return uniform_offset(w0)


def prior_uniforms(seed, rows, num_particles, num_uniforms):
    """Prior uniforms (num_uniforms, len(rows), num_particles) in [0, 1)
    of the Liu-West kernel's t = 0 draw."""
    k0, k1 = _key(seed)
    i = torch.arange(num_particles, device=seed.device)[None, None]
    blk = torch.arange((num_uniforms + 3) // 4, device=seed.device)[
        :, None, None]
    b = rows.to(torch.int64)[None, :, None]
    words = philox4x32_10(i, blk, b, torch.full_like(i, TAG_PRIOR_UNIFORM),
                          k0, k1)
    u = uniform_closed_zero(torch.stack(words, dim=1))   # (blk, 4, B, N)
    return u.reshape(-1, rows.shape[0], num_particles)[:num_uniforms]


def roll_sweep_draws(seed, rows, step, sweep, num_particles,
                     tag=TAG_ROLL_SWEEP, count=1):
    """(shift words (count, len(rows)) int64, accept uniforms (count,
    len(rows), num_particles) in (0, 1]) of sweeps ``sweep`` ..
    ``sweep + count - 1`` of a roll selection at step ``step``, stream
    ``tag`` (the mapping above)."""
    if not 0 <= sweep <= sweep + count <= ROLL_MAX_ITERS:
        raise ValueError(f"sweeps must lie in [0, {ROLL_MAX_ITERS}), got "
                         f"{sweep} + {count}")
    k0, k1 = _key(seed)
    j = torch.arange(num_particles, device=seed.device)[None, None, :]
    b = rows.to(torch.int64)[None, :, None]
    s = torch.arange(sweep, sweep + count, device=seed.device)[:, None, None]
    w0, w1, _, _ = philox4x32_10(j, torch.full_like(j, int(step)), b, tag + s,
                                 k0, k1)
    return w1[:, :, 0], uniform_open_zero(w0)


def fold_generator(gen: torch.Generator, index: int) -> torch.Generator:
    """A new generator on ``gen``'s device for shard ``index``: the
    counterpart of ``jax.random.fold_in(key, index)``.

    The key words come from ``gen``'s host-side state, so the fold never
    waits for the device.  A CPU generator draws them: (k0, k1) are two
    32-bit words of ``gen`` and (c1, c2) = (0, 0).  A CUDA generator's
    state is its (seed, Philox offset) pair: (k0, k1) are the seed's
    halves and (c1, c2) the offset's, and the offset then moves on by 4,
    one Philox call, as a draw would move it.  Either way ``gen``
    advances, so two folds of one generator differ, and generators in
    the same state fold to the same one on every rank.  Philox4x32-10 of
    counter (index, c1, c2, ``TAG_SHARD_FOLD``) under (k0, k1) gives the
    new generator's seed (w0 << 32) | w1.
    """
    if gen.device.type == "cpu":
        k0, k1 = torch.randint(0, 2 ** 32, (2,), generator=gen,
                               dtype=torch.int64).tolist()
        c1 = c2 = 0
    else:
        state = gen.get_state()
        if state.numel() != 16:
            raise RuntimeError(
                f"fold_generator: a {gen.device.type} generator's state has "
                f"{state.numel()} bytes, want 16 (seed, offset)")
        words = state.view(torch.int64)          # (seed, offset)
        seed, offset = int(words[0]) & (2 ** 64 - 1), int(words[1])
        k0, k1 = seed & MASK32, seed >> 32
        c1, c2 = offset & MASK32, offset >> 32
        ahead = words.clone()
        ahead[1] += 4
        gen.set_state(ahead.view(torch.uint8))
    w0, w1, _, _ = philox4x32_10(int(index), c1, c2, TAG_SHARD_FOLD, k0, k1)
    out = torch.Generator(device=gen.device)
    out.manual_seed((w0 << 32) | w1)
    return out


def offsets(seed, rows, step):
    """Resampling offsets (len(rows),) at one step."""
    steps = torch.tensor([step], device=seed.device)
    return offsets_steps(seed, rows, steps)[0]


def philox_fill_reference(seed, num_rows, num_particles, step):
    """Plain version of :func:`philox_fill` (same outputs)."""
    k0, k1 = _key(seed)
    pair = torch.arange(num_particles // 2, device=seed.device)[None, :]
    b = torch.arange(num_rows, device=seed.device)[:, None]
    words = philox4x32_10(pair, torch.full_like(pair, step), b,
                          torch.full_like(pair, TAG_NORMAL), k0, k1)
    zc, zs = box_muller(words[0], words[1])
    return {
        "bits": torch.stack(words, dim=-1),
        "u1": uniform_open_zero(words[0]),
        "u2": uniform_closed_zero(words[1]),
        "normals": torch.stack([zc, zs], dim=-1).reshape(num_rows,
                                                         num_particles),
        "offsets": offsets(seed, torch.arange(num_rows,
                                              device=seed.device), step),
    }


def philox_fill(seed, num_rows, num_particles, step):
    """Fill Philox words, uniforms, normals and offsets for rows
    b < num_rows, particles i < num_particles, at one step.

    ``bits``: (B, N/2, 4) int64 words of counter (i >> 1, step, b, 0);
    ``u1``, ``u2``: (B, N/2); ``normals``: (B, N); ``offsets``: (B,).
    Launches the CUDA kernel for a seed on the card and runs
    :func:`philox_fill_reference` for a seed on the CPU.
    """
    seed = seed_words(seed)
    if num_particles % 2 or num_particles < 2 or num_rows < 1:
        raise ValueError("philox_fill needs num_rows >= 1 and an even "
                         "num_particles >= 2")
    if step < 0 or step > MASK32:
        raise ValueError("step must be a 32-bit counter word")
    if seed.device.type == "cpu":
        return philox_fill_reference(seed, num_rows, num_particles, step)
    if seed.device.type != "cuda":
        raise ValueError(f"philox_fill: unsupported device {seed.device}")
    lib = _cuda.library()
    half = num_particles // 2
    dev = seed.device
    bits = torch.empty((num_rows, half, 4), dtype=torch.int32, device=dev)
    u1 = torch.empty((num_rows, half), dtype=torch.float32, device=dev)
    u2 = torch.empty_like(u1)
    nrm = torch.empty((num_rows, num_particles), dtype=torch.float32,
                      device=dev)
    offs = torch.empty((num_rows,), dtype=torch.float32, device=dev)
    err = lib.ssme_philox_fill(seed.data_ptr(), num_rows, half, int(step),
                               bits.data_ptr(), u1.data_ptr(),
                               u2.data_ptr(), nrm.data_ptr(),
                               offs.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(err, "ssme_philox_fill")
    philox_fill.launches += 1
    return {"bits": bits.to(torch.int64) & MASK32, "u1": u1, "u2": u2,
            "normals": nrm, "offsets": offs}


philox_fill.launches = 0

__all__ = ["philox4x32_10", "seed_words", "normals_steps", "normal_tag",
           "offsets", "offsets_steps", "prior_uniforms", "roll_sweep_draws",
           "TAG_ROLL_SWEEP", "TAG_ROLL_SELECT", "TAG_SHARD_FOLD",
           "ROLL_MAX_ITERS", "fold_generator",
           "philox_fill", "philox_fill_reference", "uniform_open_zero",
           "uniform_closed_zero", "uniform_offset", "box_muller",
           "TWO_PI", "HALF_LOG_2PI"]
