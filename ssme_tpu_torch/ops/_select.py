"""Ancestor selection that moves all leaves jointly: systematic, and the
roll-based Metropolis and rejection resamplers.

Replaces ``ssme_tpu/ops/_select.py``: ``select_leaves_dense``
(systematic), ``metropolis_select_leaves``, ``rejection_select_leaves``
and the Metropolis sweep budget (``metropolis_bias_estimate``,
``metropolis_sweeps_for``).  The CUDA sides are ``csrc/row_select.cuh``
and ``csrc/roll_select.cuh`` (inlined by the filter kernels; launched
alone by :func:`systematic_select` and :func:`roll_select`); this module
holds their plain PyTorch versions and those wrappers,
:func:`roll_schedule`, the plain model of the order in which the roll
kernels test their sweeps, the filter kernels' shared input checks and
:func:`resample_rows`, the plain filters' resample of their leaves.

Systematic law, per row: cdf = inclusive float32 cumulative sum of w,
total = cdf[-1], points u_j = min((j + u0) * (total / N), total) and
ancestor_j = the first i with cdf[i] >= u_j, which is the half-open test
cdf[i-1] < u_j <= cdf[i] on the same rounded array (cdf[-1] read as 0).
The kernels' block scans add in another order than ``torch.cumsum``, so
a point within rounding of a CDF boundary can pick the neighbour.  The
systematic families of the SVOL, generic and Liu-West kernels
(``csrc/row_select.cuh``) give each thread kPer neighbouring slots: they
build the CDF as :func:`kernel_cdf` models it and select without a
search: each particle counts the points at or below its entry, marks the
first of its offspring's slots, and each thread scans its slots' marks
(:func:`systematic_ancestors_marks`, their plain model, which equals the
search on a CDF that never falls).

Roll laws (Murray, Lee & Jacob's GPU resamplers, in the TPU's roll form),
per row of power-of-two N, sweep s drawing a shift word and one uniform
u in (0, 1] per slot (``draw(s)``; the kernels' draws are
``_prng.roll_sweep_draws``); the shift accumulates as c (mod 2^32) and
slot j proposes particle (j - c) mod N:

- metropolis: chain j starts at j; each of ``num_iters`` sweeps accepts
  the proposal when u * w_cur < w_cand.  Biased at a finite sweep count
  (:func:`metropolis_bias_estimate`);
- rejection: sweep 0 proposes j itself, later sweeps (j - c); accept
  when u * w_max < w_cand; an accepted slot keeps its ancestor; the row
  runs until every slot has accepted, at most ``max_iters`` sweeps, after
  which a pending slot keeps itself.  Unbiased: E[offspring of i] =
  N w_i / sum w.

Both return ancestor indices, and the leaves move once by them: the TPU
carries values through its rolls, which are exact, so the result is the
same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssme_tpu_torch.ops import _cuda, _prng

MAX_PARTICLES = 1024
# the roll resamplers' particle cap in the filter kernels: a power of two
# up to 4096, kPer particles per thread above 1024 (and the SVOL kernel's
# cap under every resampler: its systematic selection scans kPer weights
# per thread there)
MAX_ROLL_PARTICLES = 4096
# the resamplers and their codes in the C entry points (roll_select.cuh)
RESAMPLER_CODES = {"systematic": 0, "metropolis": 1, "rejection": 2}


def check_resampler(resampler, metropolis_iters=16) -> None:
    if resampler not in RESAMPLER_CODES:
        raise ValueError(f"unknown resampler {resampler!r}; valid: "
                         f"{tuple(RESAMPLER_CODES)}")
    if resampler == "metropolis" and (
            int(metropolis_iters) != metropolis_iters
            or not 1 <= metropolis_iters <= _prng.ROLL_MAX_ITERS):
        raise ValueError(f"metropolis_iters must be an integer in [1, "
                         f"{_prng.ROLL_MAX_ITERS}], got {metropolis_iters}")


def check_particles(n: int, resampler: str = "systematic",
                    roll_cap: int = MAX_ROLL_PARTICLES,
                    systematic_cap: int = MAX_PARTICLES,
                    beyond: str = "") -> None:
    """Systematic: a multiple of 32 in [32, 1024] (one CTA of N threads)
    and, up to ``systematic_cap`` above that, a multiple of 128 (the SVOL
    kernel, kPer particles per thread); a roll resampler: a power of two
    in [32, ``roll_cap``].  ``beyond``: the advice appended when ``n``
    exceeds the resampler's cap."""
    cap = systematic_cap if resampler == "systematic" else roll_cap
    tail = f"; {beyond}" if beyond and n > cap else ""
    if resampler == "systematic":
        if (32 <= n <= MAX_PARTICLES and n % 32 == 0) or (
                MAX_PARTICLES < n <= systematic_cap and n % 128 == 0):
            return
        above = (f", or a multiple of 128 up to {systematic_cap}"
                 if systematic_cap > MAX_PARTICLES else "")
        raise ValueError(f"num_particles={n} must be a multiple of 32 in "
                         f"[32, {MAX_PARTICLES}] (one CTA of N threads)"
                         f"{above}{tail}")
    if n & (n - 1) or not 32 <= n <= roll_cap:
        raise ValueError(f"num_particles={n}: resampler={resampler!r} needs "
                         f"a power of two in [32, {roll_cap}] (its roll "
                         f"decomposition masks the shift to [0, N)){tail}")


def as_rows(name, v, t_len, width, dev):
    """(T,) or (T, width) -> (T, width) view; raises on other shapes."""
    if not isinstance(v, torch.Tensor):
        raise ValueError(f"{name} must be a tensor")
    if v.ndim == 1 and width == 1:
        v = v[:, None]
    if v.ndim != 2 or v.shape[1] != width or v.shape[0] < 1 or (
            t_len is not None and v.shape[0] != t_len):
        want = f"({t_len or 'T'}, {width})"
        raise ValueError(f"{name} must be {want}, got {tuple(v.shape)}")
    if v.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {v.dtype}")
    if v.device != dev:
        raise ValueError(f"{name} is on {v.device}, params on {dev}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return v


def resample_rows(ancestors, wn, leaves, lw, carry, fire, log_n,
                  subset=False):
    """Resample every leaf (a tuple of (B, N)) of the rows where ``fire``
    (a (B, 1) bool tensor, or True for all rows) by ``ancestors(w, sub)``
    (:func:`plain_ancestor_fn`); lw resets to 0 and the carried log-sum
    (B, 1), if not None, to log N.  With ``subset`` only the firing rows
    select (the roll laws' sweep loops), else every row selects and
    ``torch.where`` keeps the others."""
    if fire is True or not subset:
        anc = ancestors(wn, None)
        picked = tuple(torch.gather(v, 1, anc) for v in leaves)
        if fire is True:
            return (picked, torch.zeros_like(lw),
                    None if carry is None else torch.full_like(carry, log_n))
        return (tuple(torch.where(fire, new, old)
                      for new, old in zip(picked, leaves)),
                torch.where(fire, torch.zeros_like(lw), lw),
                None if carry is None else
                torch.where(fire, torch.full_like(carry, log_n), carry))
    sub = fire[:, 0].nonzero()[:, 0]
    if sub.numel() == 0:
        return leaves, lw, carry
    anc = ancestors(wn[sub], sub)
    out = []
    for v in leaves:
        v = v.clone()
        v[sub] = torch.gather(v[sub], 1, anc)
        out.append(v)
    lw = lw.clone()
    lw[sub] = 0.0
    if carry is not None:
        carry = carry.clone()
        carry[sub] = log_n
    return tuple(out), lw, carry


def _points(cdf, u0):
    """Clamped systematic points (B, N) on an inclusive CDF (B, N)."""
    n = cdf.shape[-1]
    total = cdf[:, -1:]
    j = torch.arange(n, dtype=cdf.dtype, device=cdf.device)[None, :]
    return torch.minimum((j + u0[:, None]) * (total / n), total)


def systematic_points(w, u0):
    """Inclusive CDF (B, N) and clamped systematic points (B, N)."""
    cdf = torch.cumsum(w, dim=-1)
    return cdf, _points(cdf, u0)


def systematic_ancestors(w, u0):
    """Ancestor indices (B, N), int64, of the plain law above."""
    cdf, u = systematic_points(w, u0)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), side="left")
    return torch.clamp(idx, max=w.shape[-1] - 1)


class MarksSelection(NamedTuple):
    """What :func:`systematic_ancestors_marks` returns, per row."""
    ancestors: torch.Tensor   # (B, N) int64
    fixups: torch.Tensor      # (B,) int64: counts whose first guess missed
    most_marks: torch.Tensor  # (B,) int64: the most marks one thread wrote


def _point_counts(cdf, u0):
    """c(a) = #{j : u_j <= cdf[a]} (B, N) and the first guesses (B, N),
    as ``csrc/row_select.cuh`` SystematicPoints computes them in float32:
    the guess floor(cdf * (N / total) - u0) + 1 within [0, N], each
    operation rounded apart, then walked one point at a time while the
    point before it lies above the entry or its own at or below, each
    point ``min((j + u0) * (total / N), total)``."""
    n = cdf.shape[1]
    total = cdf[:, -1:]
    nf = torch.tensor(float(n), dtype=torch.float32, device=cdf.device)
    step, inv = total / nf, nf / total
    u0 = u0.to(torch.float32)[:, None]

    def at(j):
        return torch.fmin((j.to(torch.float32) + u0) * step, total)

    g = torch.floor(cdf * inv - u0) + 1.0
    guess = torch.fmin(torch.fmax(g, torch.zeros_like(g)), nf).long()
    return _walk_counts(cdf, guess, at, n), guess


def _walk_counts(cdf, c, at, n):
    """The guesses ``c`` walked to the exact counts, one point a turn."""
    while True:
        down = (c > 0) & ~(at(c - 1) <= cdf)
        if not bool(down.any()):
            break
        c = c - down.long()
    while True:
        up = (c < n) & (at(c) <= cdf)
        if not bool(up.any()):
            return c
        c = c + up.long()


def systematic_ancestors_marks(cdf, u0, kper):
    """Ancestors (B, N) int64 as the kernels select them
    (``csrc/row_select.cuh`` systematic_marks, then systematic_scan) on an
    inclusive CDF (B, N) float32 (:func:`kernel_cdf`'s) with offsets u0
    (B,), thread i holding slots kper * i .. kper * i + kper - 1:

    1. count: c(a) = #{j : u_j <= cdf[a]} (:func:`_point_counts`), so
       particle a's offspring are the slots [c(a - 1), c(a)), c(-1) = 0;
    2. mark: a particle with offspring writes its index at its first slot
       and at every warp's first slot (32 kper w) inside its range, the
       larger where two write one slot (0: empty);
    3. scan: each thread's running max over its marks, then the running
       max of the nearest lane below it in its warp that holds a mark.

    Points and total are :func:`systematic_ancestors`'; on a CDF that
    never falls the ancestors equal its.  Also returns, per row, the
    counts whose first guess missed and the most marks one thread wrote
    (the twins' ``fixups`` and ``most_marks``)."""
    b, n = cdf.shape
    if kper < 1 or n % kper:
        raise ValueError(f"kper={kper} must divide N={n}")
    cdf = cdf.to(torch.float32)
    c, guess = _point_counts(cdf, u0)
    prev = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)
    ids = torch.arange(n, device=cdf.device).expand(b, n)
    busy = c > prev
    marks = torch.zeros((b, n + 1), dtype=torch.int64, device=cdf.device)
    marks.scatter_reduce_(1, torch.where(busy, prev, n), ids, "amax")
    wrote = busy.long()
    warp_slots = 32 * kper
    warps = -(-n // warp_slots)
    for s in range(warp_slots, warps * warp_slots, warp_slots):
        inside = (prev < s) & (s < c)
        marks[:, s] = torch.maximum(
            marks[:, s], torch.where(inside, ids, 0).amax(dim=1))
        wrote += inside.long()
    most = wrote.reshape(b, n // kper, kper).sum(-1).amax(-1)
    lanes = warps * 32
    run = torch.zeros((b, lanes, kper), dtype=torch.int64, device=cdf.device)
    run[:, :n // kper] = torch.cummax(
        marks[:, :n].reshape(b, n // kper, kper), dim=-1).values
    run = run.reshape(b, warps, 32, kper)
    last = run[..., -1]
    lane = torch.arange(32, device=cdf.device)
    held = torch.cummax(torch.where(last > 0, lane, -1), dim=-1).values
    src = torch.cat([torch.full_like(held[..., :1], -1), held[..., :-1]],
                    dim=-1)
    carried = torch.where(src >= 0, torch.gather(last, -1, src.clamp(min=0)),
                          0)
    anc = torch.maximum(run, carried[..., None]).reshape(b, lanes * kper)
    return MarksSelection(anc[:, :n].contiguous(),
                          (c != guess).long().sum(1), most)


def kernel_cdf(w, kper):
    """The inclusive CDF (B, N) and its total (B,) as the kernels with kPer
    neighbouring particles per thread build it (``csrc/row_select.cuh``
    warp_cdf and row_sums), in float32: a serial prefix over each thread's
    kper weights, an inclusive lane scan of the thread totals (shuffle-up
    steps 1, 2, 4, 8, 16), each lane's entries raised to the running max
    of the earlier lanes' last entries, and the warps' offsets chained
    serially; the total is the chain's, which is the last entry bit for
    bit.  The plain model the layout tests hold the kernels' arithmetic
    to; the filters' plain versions use ``torch.cumsum``."""
    b, n = w.shape
    if kper < 1 or n % kper:
        raise ValueError(f"kper={kper} must divide N={n}")
    used = n // kper
    threads = -(-used // 32) * 32
    f32 = dict(dtype=torch.float32, device=w.device)
    per = torch.zeros((b, threads, kper), **f32)
    per[:, :used] = w.to(torch.float32).reshape(b, used, kper)
    for p in range(1, kper):
        per[..., p] = per[..., p - 1] + per[..., p]
    warps = threads // 32
    per = per.reshape(b, warps, 32, kper)
    act = (torch.arange(threads, device=w.device) < used).reshape(warps, 32)
    zero = torch.zeros((b, warps, 1), **f32)

    def lane_scan(v, op):
        for o in (1, 2, 4, 8, 16):
            v = torch.cat([v[..., :o], op(v[..., o:], v[..., :-o])], dim=-1)
        return v

    incl = lane_scan(torch.where(act, per[..., -1], 0.0), torch.add)
    run = torch.cat([zero, incl[..., :-1]], dim=-1)[..., None] + per
    top = lane_scan(torch.where(act, run[..., -1], 0.0), torch.maximum)
    below = torch.cat([zero, top[..., :-1]], dim=-1)
    run = torch.maximum(run, below[..., None])
    base = torch.zeros((b,), **f32)
    bases = []
    for k in range(warps):
        bases.append(base)
        base = base + top[:, k, -1]
    cdf = (torch.stack(bases, dim=1)[:, :, None, None] + run).reshape(
        b, threads * kper)
    return cdf[:, :n].contiguous(), base


def systematic_select_reference(w, leaves, u0):
    """Plain version of :func:`systematic_select`."""
    anc = systematic_ancestors(w, u0)
    picked = torch.gather(leaves, 2, anc[None].expand_as(leaves))
    return picked, anc.to(torch.int32)


def _validate(w, leaves, u0):
    if w.ndim != 2 or leaves.ndim != 3 or u0.ndim != 1:
        raise ValueError("expected w (B, N), leaves (L, B, N), u0 (B,)")
    b, n = w.shape
    if leaves.shape[1:] != (b, n) or u0.shape[0] != b or leaves.shape[0] < 1:
        raise ValueError(f"shape mismatch: w {tuple(w.shape)}, leaves "
                         f"{tuple(leaves.shape)}, u0 {tuple(u0.shape)}")
    check_particles(n, systematic_cap=MAX_ROLL_PARTICLES)
    for name, t in (("w", w), ("leaves", leaves), ("u0", u0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _select_kper(n, kper):
    """The layout the standalone kernel runs at ``n`` particles: 2, 4 or 8
    neighbouring slots per thread (at most 1024 threads); None: the SVOL
    kernel's, 2 up to 512, 4 up to 1024, 8 above."""
    if kper is None:
        return 2 if n <= 512 else 4 if n <= MAX_PARTICLES else 8
    # a CTA holds at most MAX_PARTICLES (1024) threads
    if kper not in (2, 4, 8) or -(-n // kper) > MAX_PARTICLES:
        raise ValueError(f"kper={kper} at N={n}: 2, 4 or 8 with at most "
                         f"{MAX_PARTICLES} threads")
    return kper


def systematic_select(w, leaves, u0, kper=None, return_cdf=False):
    """Systematic selection of every leaf row by per-row weights.

    ``w``: (B, N) nonnegative float32 weights, N a multiple of 32 up to
    1024 or of 128 up to 4096; ``leaves``: (L, B, N) float32, moved by the
    same ancestors; ``u0``: (B,) offsets in (0, 1).  ``kper``: the
    neighbouring slots per thread (2, 4 or 8) of the device code a CUDA
    call runs (``csrc/row_select.cuh``, the CDF, counts, marks and scan of
    every filter kernel's systematic family); None: 2 up to 512 particles,
    4 up to 1024, 8 above.
    Returns (picked (L, B, N), ancestors (B, N) int32) and, with
    ``return_cdf``, the inclusive CDF (B, N) they were found on.  Launches
    the CUDA kernel for CUDA tensors and runs the plain version (whose CDF
    is ``torch.cumsum``) for CPU tensors, at any ``kper``.
    """
    _validate(w, leaves, u0)
    kper = _select_kper(w.shape[1], kper)
    if w.device.type == "cpu":
        picked, anc = systematic_select_reference(w, leaves, u0)
        return (picked, anc, torch.cumsum(w, dim=-1)) if return_cdf \
            else (picked, anc)
    if w.device.type != "cuda":
        raise ValueError(f"systematic_select: unsupported device {w.device}")
    num_leaves, b, n = leaves.shape
    picked = torch.empty_like(leaves)
    anc = torch.empty((b, n), dtype=torch.int32, device=w.device)
    cdf = torch.empty_like(w) if return_cdf else None
    _cuda.launch("ssme_systematic_select", w.data_ptr(), leaves.data_ptr(),
                 u0.data_ptr(), num_leaves, b, n, kper, picked.data_ptr(),
                 anc.data_ptr(), None if cdf is None else cdf.data_ptr(),
                 device=w.device)
    return (picked, anc, cdf) if return_cdf else (picked, anc)


def _check_pow2(n):
    if n & (n - 1) or n < 1:
        raise ValueError(f"the roll resamplers need a power-of-two n, got {n}")


# sweeps drawn at once by the plain loops: one Philox call for a block of
# sweeps costs about what one sweep's call costs
_SWEEP_BLOCK = 16


def metropolis_ancestors(w, draw, num_iters=16):
    """Ancestors (B, N) int64 of the Metropolis law (module docstring);
    ``draw(s, k, sub)`` returns the shift words (k, B') and uniforms
    (k, B', N) of sweeps s .. s+k-1 for the rows ``sub`` (None: every
    row)."""
    b, n = w.shape
    _check_pow2(n)
    j = torch.arange(n, device=w.device)[None, :]
    cur = j.expand(b, n).clone()
    w_cur = w.clone()
    c = torch.zeros((b, 1), dtype=torch.int64, device=w.device)
    for s0 in range(0, int(num_iters), _SWEEP_BLOCK):
        k = min(_SWEEP_BLOCK, int(num_iters) - s0)
        shifts, us = draw(s0, k, None)
        for shift, u in zip(shifts, us):
            c = (c + shift[:, None]) & _prng.MASK32
            idx = (j - c) & (n - 1)
            w_cand = torch.gather(w, 1, idx)
            acc = u * w_cur < w_cand
            cur = torch.where(acc, idx, cur)
            w_cur = torch.where(acc, w_cand, w_cur)
    return cur


def rejection_accepts(w, draw, max_iters=_prng.ROLL_MAX_ITERS):
    """(ancestors (B, N) int64 of the rejection law (module docstring),
    accept sweeps (B, N) int64: the sweep at which each slot accepted, or
    ``max_iters`` for a slot that kept itself at the cap); ``draw`` as
    for :func:`metropolis_ancestors`.  Only the rows with a pending slot
    draw, checked once per block of sweeps (a row whose slots have all
    accepted no longer changes), and the loop stops at ``max_iters``
    sweeps."""
    b, n = w.shape
    _check_pow2(n)
    max_iters = int(max_iters)
    j = torch.arange(n, device=w.device)[None, :]
    cur = j.expand(b, n).clone()
    w_max = torch.amax(w, dim=-1, keepdim=True)
    _, u = draw(0, 1, None)
    acc = u[0] * w_max < w
    when = torch.where(acc, 0, max_iters)
    c = torch.zeros((b, 1), dtype=torch.int64, device=w.device)
    for s0 in range(1, max_iters, _SWEEP_BLOCK):
        sub = (~acc).any(-1).nonzero()[:, 0]
        if sub.numel() == 0:
            break
        k = min(_SWEEP_BLOCK, max_iters - s0)
        shifts, us = draw(s0, k, sub)
        c_s, cur_s, acc_s, when_s = c[sub], cur[sub], acc[sub], when[sub]
        w_s, w_max_s = w[sub], w_max[sub]
        for s, (shift, u) in enumerate(zip(shifts, us), start=s0):
            c_s = (c_s + shift[:, None]) & _prng.MASK32
            idx = (j - c_s) & (n - 1)
            take = ~acc_s & (u * w_max_s < torch.gather(w_s, 1, idx))
            cur_s = torch.where(take, idx, cur_s)
            when_s = torch.where(take, s, when_s)
            acc_s = acc_s | take
        c[sub], cur[sub], acc[sub], when[sub] = c_s, cur_s, acc_s, when_s
    return cur, when


def rejection_ancestors(w, draw, max_iters=_prng.ROLL_MAX_ITERS):
    """Ancestors (B, N) int64 of the rejection law: those of
    :func:`rejection_accepts`."""
    return rejection_accepts(w, draw, max_iters)[0]


# sweeps a warp's shift scan covers, and the threads holding a pending
# slot at or below which rejection turns to its sweep-parallel tail
# (csrc/roll_select.cuh kRollChunk, kRollTailThreads)
ROLL_CHUNK = 32
ROLL_TAIL_THREADS = 32


def roll_schedule(resampler, w, draw, metropolis_iters=16, kper=2,
                  tail_threads=ROLL_TAIL_THREADS,
                  max_iters=_prng.ROLL_MAX_ITERS):
    """The kernels' schedule of a roll selection (``csrc/roll_select.cuh``)
    on whole rows: (ancestors (B, N) int64, record), the ancestors those
    of :func:`metropolis_ancestors` / :func:`rejection_ancestors`.

    The shifts come by chunks of ``ROLL_CHUNK`` sweeps: sweep s0 + l's
    cumulative shift is the carry before the chunk plus an inclusive scan
    of the chunk's shift words, mod 2^32.  Metropolis runs each slot's
    chain over the chunks' sweeps in order.  Rejection takes sweep 0,
    then per chunk of a row still selecting: a vote, the threads holding
    a pending slot (slot j's thread is j // kper: kper neighbouring slots
    a thread, the kernels' layout); none, or the cap: the row
    is done; at most ``tail_threads``: the row enters its tail, which
    tests each pending slot's sweeps a chunk at a time side by side, with
    no more votes, up to the cap; else the bulk tests the chunk's sweeps
    in order, one slot at a time.  Either way a pending slot takes the
    chunk's first accepting sweep, so the two differ in the record only.

    record: {"sweeps": (B,) sweeps the selection ran (1 + the last accept
    sweep, ``max_iters`` at the cap; Metropolis: its sweeps), "votes":
    (B,) the rejection votes, "tail_slots": (B,) the slots each row's
    tail took}."""
    b, n = w.shape
    _check_pow2(n)
    if kper < 1 or n % kper:
        raise ValueError(f"kper={kper} must divide N={n}")
    dev = w.device
    zeros = torch.zeros(b, dtype=torch.int64, device=dev)
    j = torch.arange(n, device=dev)
    anc = j.expand(b, n).clone()
    c = torch.zeros((b, 1), dtype=torch.int64, device=dev)

    def chunk(s0, k, sub):
        """(cumulative shifts (k, B', 1), uniforms (k, B', N), the
        candidates (k, B', N)) of sweeps s0 .. s0 + k - 1."""
        shifts, us = draw(s0, k, sub)
        carry = c if sub is None else c[sub]
        cs = (carry[None, :, 0] + torch.cumsum(shifts, 0)) & _prng.MASK32
        return cs[..., None], us, (j - cs[..., None]) & (n - 1)

    if resampler == "metropolis":
        iters = int(metropolis_iters)
        w_cur = w.clone()
        for s0 in range(0, iters, ROLL_CHUNK):
            cs, us, idx = chunk(s0, min(ROLL_CHUNK, iters - s0), None)
            for u, cand in zip(us, idx):
                w_cand = torch.gather(w, 1, cand)
                take = u * w_cur < w_cand
                anc = torch.where(take, cand, anc)
                w_cur = torch.where(take, w_cand, w_cur)
            c = cs[-1]
        return anc, {"sweeps": zeros + iters, "votes": zeros.clone(),
                     "tail_slots": zeros.clone()}
    if resampler != "rejection":
        raise ValueError(f"not a roll resampler: {resampler!r}")
    max_iters = int(max_iters)
    w_max = torch.amax(w, dim=-1, keepdim=True)
    _, u = draw(0, 1, None)
    pend = ~(u[0] * w_max < w)
    thread = j // kper
    last = zeros.clone()              # the last accept sweep
    votes, tail = zeros.clone(), zeros.clone()
    in_tail = torch.zeros(b, dtype=torch.bool, device=dev)
    done = torch.zeros_like(in_tail)
    for s0 in range(1, max_iters + ROLL_CHUNK, ROLL_CHUNK):
        bulk = ~done & ~in_tail
        per_thread = torch.zeros((b, n // kper), dtype=torch.int64,
                                 device=dev).index_add_(1, thread, pend.long())
        busy = (per_thread > 0).sum(-1)
        votes += bulk.long()
        done |= bulk & ((busy == 0) | (s0 >= max_iters))
        enter = bulk & ~done & (busy <= tail_threads)
        tail = torch.where(enter, pend.sum(-1), tail)
        in_tail |= enter
        done |= in_tail & ~pend.any(-1)
        if s0 >= max_iters or bool(done.all()):
            break
        sub = (~done).nonzero()[:, 0]
        cs, us, idx = chunk(s0, min(ROLL_CHUNK, max_iters - s0), sub)
        ok = pend[sub] & (us * w_max[sub] < torch.gather(
            w[sub].expand(us.shape[0], -1, -1), 2, idx))
        hit = ok.any(0)
        first = torch.argmax(ok.to(torch.int8), dim=0)
        anc[sub] = torch.where(hit, torch.gather(idx, 0, first[None])[0],
                               anc[sub])
        last[sub] = torch.maximum(last[sub], torch.where(
            hit, s0 + first, 0).amax(-1))
        pend[sub] &= ~hit
        c[sub] = cs[-1]
    sweeps = torch.where(pend.any(-1), max_iters, last + 1)
    return anc, {"sweeps": sweeps, "votes": votes, "tail_slots": tail}


def philox_draw(seed, rows, step, num_particles, tag=_prng.TAG_ROLL_SWEEP):
    """The kernels' ``draw(s, k, sub)``: sweeps s .. s+k-1 of step
    ``step`` for the filter rows ``rows`` (their Philox row words), or
    their subset ``sub``."""
    def draw(s, k, sub):
        r = rows if sub is None else rows[sub]
        return _prng.roll_sweep_draws(seed, r, step, s, num_particles, tag,
                                      count=k)
    return draw


def plain_ancestor_fn(resampler, metropolis_iters, seed, rows, step, n,
                      u0=None, tag=_prng.TAG_ROLL_SWEEP):
    """``fn(w, sub) -> ancestors`` of the plain filters at one step: the
    systematic law with offsets ``u0`` (B,), or a roll law with the
    kernels' draws of ``step`` on stream ``tag``, for the rows ``sub`` of
    ``rows`` (None: every row) and their weights ``w``."""
    if resampler == "systematic":
        return lambda w, sub: systematic_ancestors(
            w, u0 if sub is None else u0[sub])

    def fn(w, sub):
        r = rows if sub is None else rows[sub]
        return roll_ancestors(resampler, w, philox_draw(seed, r, step, n, tag),
                              metropolis_iters)
    return fn


def roll_ancestors(resampler, w, draw, metropolis_iters=16):
    """Ancestors (B, N) int64 of ``resampler`` ("metropolis" or
    "rejection") on weights ``w`` (B, N)."""
    if resampler == "metropolis":
        return metropolis_ancestors(w, draw, metropolis_iters)
    if resampler == "rejection":
        return rejection_ancestors(w, draw)
    raise ValueError(f"not a roll resampler: {resampler!r}")


def _move(leaves, anc):
    return torch.gather(leaves, 2, anc[None].expand_as(leaves))


def metropolis_select(w, leaves, draw, num_iters=16):
    """Plain Metropolis selection of every leaf row of ``leaves`` (L, B, N)
    by weights ``w`` (B, N): (picked (L, B, N), ancestors (B, N) int32)."""
    anc = metropolis_ancestors(w, draw, num_iters)
    return _move(leaves, anc), anc.to(torch.int32)


def rejection_select(w, leaves, draw, max_iters=_prng.ROLL_MAX_ITERS):
    """Plain rejection selection, as :func:`metropolis_select`."""
    anc = rejection_ancestors(w, draw, max_iters)
    return _move(leaves, anc), anc.to(torch.int32)


def roll_select_reference(w, leaves, seed, step=0, resampler="rejection",
                          metropolis_iters=16, tag=_prng.TAG_ROLL_SWEEP):
    """Plain version of :func:`roll_select`."""
    seed = _prng.seed_words(seed, device=w.device)
    rows = torch.arange(w.shape[0], device=w.device)
    anc = roll_ancestors(resampler, w,
                         philox_draw(seed, rows, step, w.shape[1], tag),
                         metropolis_iters)
    return _move(leaves, anc), anc.to(torch.int32)


def roll_select(w, leaves, seed, step=0, resampler="rejection",
                metropolis_iters=16, tag=_prng.TAG_ROLL_SWEEP):
    """Roll-based selection of every leaf row by per-row weights, with the
    kernels' Philox draws of step ``step`` on stream ``tag``
    (``_prng.TAG_ROLL_SWEEP`` or ``TAG_ROLL_SELECT``).

    ``w``: (B, N) nonnegative float32 weights, N a power of two in [32,
    4096]; ``leaves``: (L, B, N) float32, moved by the same ancestors;
    ``seed``: (2,) int64 key words on the device of ``w``, or an int.
    Returns (picked (L, B, N), ancestors (B, N) int32).  Launches the CUDA
    kernel for CUDA tensors and runs the plain version for CPU tensors.
    """
    if resampler not in ("metropolis", "rejection"):
        raise ValueError(f"roll_select: resampler must be 'metropolis' or "
                         f"'rejection', got {resampler!r}")
    check_resampler(resampler, metropolis_iters)
    if w.ndim != 2 or leaves.ndim != 3 or leaves.shape[1:] != w.shape \
            or leaves.shape[0] < 1:
        raise ValueError(f"expected w (B, N) and leaves (L, B, N), got "
                         f"{tuple(w.shape)} and {tuple(leaves.shape)}")
    check_particles(w.shape[1], resampler)
    if tag not in (_prng.TAG_ROLL_SWEEP, _prng.TAG_ROLL_SELECT):
        raise ValueError("tag must be _prng.TAG_ROLL_SWEEP or "
                         "_prng.TAG_ROLL_SELECT")
    if not 0 <= int(step) <= _prng.MASK32:
        raise ValueError("step must be a 32-bit counter word")
    for name, t in (("w", w), ("leaves", leaves)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if leaves.device != w.device:
        raise ValueError(f"leaves are on {leaves.device}, w on {w.device}")
    seed = _prng.seed_words(seed, device=w.device)
    if seed.device != w.device:
        raise ValueError(f"seed is on {seed.device}, w on {w.device}")
    if w.device.type == "cpu":
        return roll_select_reference(w, leaves, seed, step, resampler,
                                     metropolis_iters, tag)
    if w.device.type != "cuda":
        raise ValueError(f"roll_select: unsupported device {w.device}")
    num_leaves, b, n = leaves.shape
    picked = torch.empty_like(leaves)
    anc = torch.empty((b, n), dtype=torch.int32, device=w.device)
    _cuda.launch("ssme_roll_select", w.data_ptr(), leaves.data_ptr(),
                 seed.data_ptr(), int(step), int(tag),
                 RESAMPLER_CODES[resampler], int(metropolis_iters),
                 num_leaves, b, n, picked.data_ptr(), anc.data_ptr(),
                 device=w.device)
    return picked, anc


# ---------------------------------------------------------------------------
# Metropolis sweep budget: the JAX package's fitted envelope
# (ssme_tpu/ops/_select.py:318-384), its constants unchanged
# ---------------------------------------------------------------------------

# |bias|(B) <= SAFETY * A_sched * (t_len / 3084) * (B / 8)^-P, fitted on the
# SPY workload at N=512 (univariate SVOL and SVOL-leverage, both
# schedules), measured insensitive to N from 512 to 4096
_METROPOLIS_BIAS_A = {"parity": 5.8, "adaptive": 1.6}
_METROPOLIS_BIAS_P = 0.73
_BIAS_FIT_T = 3084.0
_BIAS_SAFETY = 2.0


def metropolis_bias_estimate(num_iters, t_len, ess_threshold=0.5):
    """Conservative predicted |evidence bias| (nats) of the Metropolis
    resampler at ``num_iters`` sweeps on a series of ``t_len`` steps: the
    parity envelope when ``ess_threshold > 0.5``, else the adaptive one."""
    sched = "parity" if ess_threshold > 0.5 else "adaptive"
    a = _METROPOLIS_BIAS_A[sched] * _BIAS_SAFETY
    return (a * (float(t_len) / _BIAS_FIT_T)
            * (float(num_iters) / 8.0) ** (-_METROPOLIS_BIAS_P))


def metropolis_sweeps_for(bias_budget, t_len, ess_threshold=0.5,
                          max_sweeps=256):
    """Smallest even sweep count (at least 4) whose predicted evidence
    bias (:func:`metropolis_bias_estimate`) is within ``bias_budget``
    nats; raises when it exceeds ``max_sweeps``."""
    if bias_budget <= 0:
        raise ValueError("bias_budget must be positive (nats)")
    sched = "parity" if ess_threshold > 0.5 else "adaptive"
    a = _METROPOLIS_BIAS_A[sched] * _BIAS_SAFETY
    b = 8.0 * (a * (float(t_len) / _BIAS_FIT_T)
               / float(bias_budget)) ** (1.0 / _METROPOLIS_BIAS_P)
    sweeps = max(4, int(-(-b // 2) * 2))          # round up to even
    if sweeps > max_sweeps:
        raise ValueError(
            f"metropolis bias budget {bias_budget} nats needs ~{sweeps} "
            f"sweeps (> max_sweeps={max_sweeps}) at T={t_len}, "
            f"ess_threshold={ess_threshold}: use resampler='rejection' "
            "(unbiased, same memory profile) or the generic filter bank "
            "instead")
    return sweeps


__all__ = ["systematic_select", "systematic_select_reference",
           "systematic_ancestors", "systematic_ancestors_marks",
           "MarksSelection",
           "systematic_points", "check_particles", "as_rows",
           "resample_rows",
           "check_resampler", "roll_select", "roll_select_reference",
           "roll_ancestors", "plain_ancestor_fn", "metropolis_ancestors",
           "rejection_ancestors", "rejection_accepts", "roll_schedule",
           "metropolis_select", "rejection_select", "philox_draw",
           "metropolis_bias_estimate", "metropolis_sweeps_for",
           "MAX_PARTICLES", "MAX_ROLL_PARTICLES", "RESAMPLER_CODES",
           "ROLL_CHUNK", "ROLL_TAIL_THREADS"]
