"""Particle-axis-sharded bootstrap filter over ``torch.distributed``.

PyTorch counterpart of ``ssme_tpu/parallel/sharded_pf.py``.  One
filter's cloud is split over the ranks of a process group.  Propagation
and weighting are local; the two points where particles meet become
collectives:

- conditional-likelihood reductions: the global log-sum-exp is an
  all-reduce MAX (the shift) and an all-reduce SUM (the shifted exps);
- resampling: global systematic resampling by a ring exchange
  (``exchange="ring"``, the default), which never gathers the cloud on
  one rank:

  1. each rank's shard mass travels as one float (an all-gather of S
     floats), giving every rank the global partition positions
     ``bound_pos[r]`` of the systematic output grid;
  2. each rank computes, locally, the output-slot positions ``q_i`` of
     its own particles;
  3. the (q, leaves) buffers travel around the ring by
     ``batch_isend_irecv``; when source r's buffer passes destination d,
     d takes the ancestors of its slots that fall in r's mass interval
     (a searchsorted against the passing q), and skips sources whose
     interval misses its slots.  S - 1 exchanges visit every source (JAX's
     last ``ppermute`` only brings the buffers home); at S = 1 there is
     none.

Peak memory per rank is O(n_local), against the O(N) of
``exchange="allgather"``, kept as the reference.  Both give the same
ancestors bit for bit: they share :func:`_partition_positions`, and every
comparison against a slot uses the same floats.

Generators: every rank passes the same generator (same state).  Draws
that must agree across ranks (the resampling offsets) come from it;
particle draws come from a generator folded with the rank
(``ops/_prng.py::fold_generator``).  Every rank takes the same branch
around a collective: where JAX's branch predicate is a replicated device
value, here it is a host value read from an all-reduced result, which
every rank holds bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ssme_tpu_torch.models.base import StateSpaceModel
from ssme_tpu_torch.ops._prng import fold_generator
from ssme_tpu_torch.parallel.mesh import (PARTICLE_AXIS, all_gather_cat,
                                         all_reduce_max, all_reduce_sum)
from ssme_tpu_torch.resampling import searchsorted_cdf


def global_logsumexp(log_x_local, group=None):
    """LSE over the local axis and the group's ranks."""
    m = all_reduce_max(torch.amax(log_x_local), group)
    s = all_reduce_sum(torch.sum(torch.exp(log_x_local - m)), group)
    return m + torch.log(s)


def _global_weight_sums(log_w_local, group=None):
    """``(shift, [sum w, sum w^2])`` of the global weights ``w = exp(log_w
    - shift)`` in one MAX and one SUM all-reduce: the log-sum-exp is
    ``shift + log(sum w)``, the ESS ``(sum w)^2 / sum w^2``."""
    mx = all_reduce_max(torch.amax(log_w_local), group)
    w = torch.exp(log_w_local - mx)
    return mx, all_reduce_sum(torch.stack([w.sum(), (w * w).sum()]), group)


def global_ess(log_w_local, group=None):
    """Global effective sample size (sum w)^2 / sum w^2 over the ranks."""
    _, s = _global_weight_sums(log_w_local, group)
    return s[0] * s[0] / s[1]


def _partition_positions(log_w_local, u0, group=None):
    """Systematic-grid positions of this rank's particles.

    With global normalised weights w and inclusive CDF, particle i's
    offspring are the output slots j with ``q_{i-1} < j <= q_i``, where
    ``q_i = N cdf_i - u0`` (``u0`` in (0, 1], so slot 0 is claimed).
    Returns ``(q_local (n_local,), bound_pos (S + 1,))``: ``q_local``'s
    last entry is pinned to the shared boundary so the ranks' claim
    intervals ``(bound_pos[r], bound_pos[r+1]]`` partition the slots, and
    ``bound_pos[S]`` is pinned to ``N - u0``.  Prefix maxima (exact on
    floats) make both monotone, so the ring's bisection search and the
    dense count of the allgather reference agree.
    """
    n_local = log_w_local.shape[0]
    n_shards, me = dist.get_world_size(group), dist.get_rank(group)
    n_global = float(n_local * n_shards)
    mx = all_reduce_max(torch.amax(log_w_local), group)
    w = torch.exp(log_w_local - mx)
    w = w / all_reduce_sum(torch.sum(w), group)
    csum = torch.cumsum(w, 0)
    # the cumsum's own last element is the shard mass, so the boundaries
    # agree with the interior positions
    shard_sums = all_gather_cat(csum[-1:], group)
    bounds = torch.cat([torch.zeros_like(shard_sums[:1]),
                        torch.cumsum(shard_sums, 0)])
    bound_pos = n_global * bounds - u0
    bound_pos[-1] = n_global - u0
    bound_pos = torch.minimum(torch.cummax(bound_pos, 0).values,
                              bound_pos[-1])
    q = n_global * csum + bound_pos[me]
    q[-1] = bound_pos[me + 1]
    q = torch.minimum(torch.cummax(q, 0).values, q[-1])
    return q, bound_pos


def _slot_source_shard(slots_f, bound_pos):
    """The rank whose mass interval each output slot falls in:
    r(j) = #{k in 1..S-1 : bound_pos[k] < j}."""
    return (bound_pos[1:-1][None, :] < slots_f[:, None]).sum(-1)


def _offset(gen, like):
    """The shared systematic offset u0 in (0, 1]."""
    return 1.0 - torch.rand((), generator=gen, dtype=like.dtype,
                            device=like.device)


def _my_slots(n_local, me, like):
    return (me * n_local + torch.arange(n_local, device=like.device)).to(
        like.dtype)


def sharded_systematic_ancestors(gen, log_w_local, group=None):
    """Global ancestor indices (n_local,) of this rank's output slots
    ``[me n_local, (me + 1) n_local)``, by gathering every rank's
    positions (O(N) memory): the reference assignment that
    :func:`ring_resample` reproduces.  Every rank passes the same
    generator state."""
    n_local = log_w_local.shape[0]
    me = dist.get_rank(group)
    q, bound_pos = _partition_positions(log_w_local,
                                        _offset(gen, log_w_local), group)
    q_global = all_gather_cat(q[None], group)                 # (S, n_local)
    slots_f = _my_slots(n_local, me, q)
    src = _slot_source_shard(slots_f, bound_pos)
    local_idx = (q_global[src] < slots_f[:, None]).sum(-1)
    return src * n_local + torch.clamp(local_idx, 0, n_local - 1)


def _ring_shift(tensors, group):
    """Each rank's ``tensors`` to the next rank of the group; returns the
    previous rank's."""
    group = dist.group.WORLD if group is None else group
    n_shards, me = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (me + 1) % n_shards)
    frm = dist.get_global_rank(group, (me - 1) % n_shards)
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), to, group)
            for t in tensors]
           + [dist.P2POp(dist.irecv, r, frm, group) for r in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def ring_resample(gen, log_w_local, tree_local, group=None):
    """Systematic resampling of the leaves of ``tree_local`` (a tuple of
    (n_local, ...) tensors) with O(n_local) memory a rank: each rank's
    (q, leaves) buffer travels around the ring, and each destination
    takes its slots' ancestors from the buffers that pass.  The result
    is bit for bit the allgather reference's (shared positions)."""
    n_local = log_w_local.shape[0]
    n_shards, me = dist.get_world_size(group), dist.get_rank(group)
    q, bound_pos = _partition_positions(log_w_local,
                                        _offset(gen, log_w_local), group)
    slots_f = _my_slots(n_local, me, q)
    lo, hi = float(me * n_local), float((me + 1) * n_local - 1)
    bounds = bound_pos.tolist()           # the skip is a host decision
    out = [torch.zeros_like(leaf) for leaf in tree_local]
    q_buf, bufs = q, list(tree_local)
    for r in range(n_shards):
        src = (me - r) % n_shards
        if bounds[src] < hi + 1.0 and lo <= bounds[src + 1]:
            mask = (bound_pos[src] < slots_f) & (slots_f <= bound_pos[src + 1])
            idx = searchsorted_cdf(q_buf, slots_f)          # #{q_i < j}
            out = [torch.where(mask.reshape((-1,) + (1,) * (o.ndim - 1)),
                               b[idx], o) for o, b in zip(out, bufs)]
        if r < n_shards - 1:
            q_buf, *bufs = _ring_shift([q_buf] + bufs, group)
    return tuple(out)


def _allgather_resample(gen, log_w_local, tree_local, group):
    """The O(N) reference exchange: gather the cloud, take the ancestors
    of :func:`sharded_systematic_ancestors`."""
    anc = sharded_systematic_ancestors(gen, log_w_local, group)
    return tuple(all_gather_cat(leaf, group)[anc] for leaf in tree_local)


_EXCHANGES = {"ring": ring_resample, "allgather": _allgather_resample}


def sharded_log_likelihood_fn(model: StateSpaceModel, num_particles: int,
                              group=None, resample_every: int = 1,
                              ess_threshold: float = 0.0,
                              exchange: str = "ring"):
    """Bootstrap-filter log-likelihood with the particles split over the
    ranks of ``group`` (None: the default group).

    Returns ``ll(gen, params (P,), ys[, zs]) -> ()`` that every rank of
    the group calls with the same arguments and generator state; every
    rank gets the same global log-likelihood.  Semantics match
    ``filters.bootstrap.log_likelihood_fn``.  ``ess_threshold > 0``
    resamples when the global ESS falls below that fraction of
    ``num_particles``, else every ``resample_every`` steps.
    ``exchange``: ``"ring"`` or ``"allgather"``.
    """
    m = model
    m.require("sample_q1", "log_q1", "log_mu", "log_g", "sample_f")
    if exchange not in _EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}; "
                         "valid: 'ring', 'allgather'")
    resample = _EXCHANGES[exchange]
    n = float(num_particles)

    def lse_and_ess(log_w):
        mx, s = _global_weight_sums(log_w, group)
        return mx + torch.log(s[0]), s[0] * s[0] / s[1]

    def gate(t, ess):
        # a host decision on an all-reduced value, which every rank holds
        # bit for bit: all ranks take the same branch around the
        # collectives of the resample (one device read a step, the cost
        # of a filter that JAX runs in XLA without a kernel)
        if ess_threshold > 0.0:
            return bool(ess < ess_threshold * n)
        return t % resample_every == 0

    def ll(gen, params, ys, zs=None):
        n_shards, me = dist.get_world_size(group), dist.get_rank(group)
        if num_particles % n_shards:
            raise ValueError(f"num_particles={num_particles} must divide "
                             f"evenly over {n_shards} shards")
        n_local = num_particles // n_shards
        ys = torch.as_tensor(ys)
        if ys.ndim == 1:
            ys = ys[:, None]
        if m.has_covariates and zs is None:
            raise ValueError(f"model {m.name!r} requires covariates zs")
        z_at = (lambda t: zs[t]) if m.has_covariates else (lambda t: None)
        local = fold_generator(gen, me)

        particles = m.sample_q1(local, params, ys[0], n_local)
        log_w = (m.log_mu(params, particles)
                 + m.log_g(params, ys[0], particles, z_at(0))
                 - m.log_q1(params, particles, ys[0]))
        lse, ess = lse_and_ess(log_w)
        lcls = [lse - math.log(n)]

        # the weights' global log-sum-exp and ESS travel with them, so a
        # step costs two all-reduces; uniform weights have lse log N
        def maybe_resample(do_rs, particles, log_w, lse, ess):
            if not do_rs:
                return particles, log_w, lse, ess
            (particles,) = resample(gen, log_w, (particles,), group)
            return particles, torch.zeros_like(log_w), math.log(n), n

        particles, log_w, lse, ess = maybe_resample(
            gate(0, ess) if ess_threshold > 0.0 else resample_every == 1,
            particles, log_w, lse, ess)
        for t in range(1, ys.shape[0]):
            z = z_at(t)
            particles, log_w, lse, ess = maybe_resample(
                gate(t, ess), particles, log_w, lse, ess)
            particles = m.sample_f(local, params, particles, z)
            log_w = log_w + m.log_g(params, ys[t], particles, z)
            new_lse, ess = lse_and_ess(log_w)
            lcls.append(new_lse - lse)
            lse = new_lse
        return torch.stack(lcls).sum()

    return ll


def make_sharded_ll_callable(model, num_particles, mesh,
                             axis: str = PARTICLE_AXIS,
                             resample_every: int = 1,
                             ess_threshold: float = 0.0,
                             exchange: str = "ring"):
    """:func:`sharded_log_likelihood_fn` over the mesh's ``axis`` group:
    ``f(gen, params, ys[, zs]) -> ()`` on every rank."""
    return sharded_log_likelihood_fn(model, num_particles,
                                     mesh.get_group(axis), resample_every,
                                     ess_threshold, exchange)


__all__ = [
    "global_logsumexp", "global_ess", "sharded_systematic_ancestors",
    "ring_resample", "sharded_log_likelihood_fn", "make_sharded_ll_callable",
]
