"""The port's systematic selection (``ssme_tpu_torch/ops/_select.py``, the
plain version of ``csrc/row_select.cuh``) against the JAX
``select_leaves_dense`` (interpret mode) and a float64 oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ssme_tpu.ops._select import select_leaves_dense
from ssme_tpu_torch.ops._select import (systematic_select,
                                        systematic_select_reference)

torch.set_num_threads(1)
B, N = 8, 256


def _jax_select(w, leaves, u0):
    """JAX's in-kernel selector through a minimal interpret-mode
    ``pallas_call``."""
    n = w.shape[1]
    n_l = len(leaves)
    lt = np.tril(np.ones((n, n), np.float32)).T

    def kernel(w_ref, u0_ref, lt_ref, *refs):
        leaf_refs, out_refs = refs[:n_l], refs[n_l:]
        picked = select_leaves_dense(w_ref[:], [r[:] for r in leaf_refs],
                                     u0_ref[:], lt_ref[:])
        for o, p in zip(out_refs, picked):
            o[:] = p

    outs = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct(w.shape, jnp.float32)
                   for _ in range(n_l)],
        interpret=True,
    )(jnp.asarray(w), jnp.asarray(u0[:, None]), jnp.asarray(lt),
      *[jnp.asarray(x) for x in leaves])
    return [np.asarray(o) for o in outs]


def _port_select(w, leaves, u0):
    picked, anc = systematic_select(torch.from_numpy(w),
                                    torch.from_numpy(np.stack(leaves)),
                                    torch.from_numpy(u0))
    return picked.numpy(), anc.numpy()


def _oracle(w_row, u0):
    cdf = np.cumsum(w_row.astype(np.float64))
    u = (np.arange(w_row.shape[0]) + float(u0)) * cdf[-1] / w_row.shape[0]
    return np.searchsorted(cdf, u, side="left"), cdf, u


def _safe(cdf, u, frac=2e-4):
    """Points farther than ``frac`` of the total from every boundary: the
    f32 CDFs (and the JAX bf16-compensated one) cannot flip them."""
    return np.min(np.abs(cdf[None, :] - u[:, None]), axis=1) > frac * cdf[-1]


def test_matches_jax_and_f64_oracle_away_from_boundaries():
    rng = np.random.default_rng(0)
    w = rng.gamma(1.0, 1.0, (B, N)).astype(np.float32)
    ids = np.tile(np.arange(N, dtype=np.float32), (B, 1))
    u0 = rng.uniform(0.05, 0.95, B).astype(np.float32)
    (jax_ids,) = _jax_select(w, [ids], u0)
    picked, anc = _port_select(w, [ids], u0)
    np.testing.assert_array_equal(picked[0], anc)
    checked = 0
    for r in range(B):
        idx, cdf, u = _oracle(w[r], u0[r])
        safe = _safe(cdf, u)
        np.testing.assert_array_equal(anc[r, safe], idx[safe])
        np.testing.assert_array_equal(anc[r, safe], jax_ids[r, safe])
        checked += int(safe.sum())
    assert checked > B * N // 2


def test_systematic_count_invariant():
    # |count_i - N p_i| < 1 up to float32 rounding of the CDF
    rng = np.random.default_rng(1)
    w = rng.gamma(0.5, 1.0, (B, N)).astype(np.float32)
    _, anc = _port_select(w, [w], np.full(B, 0.37, np.float32))
    for r in range(B):
        counts = np.bincount(anc[r], minlength=N)
        expect = N * w[r].astype(np.float64) / w[r].astype(np.float64).sum()
        assert np.abs(counts - expect).max() < 1.0 + 1e-3


def test_joint_gather_moves_all_leaves_by_same_ancestors():
    rng = np.random.default_rng(2)
    w = rng.gamma(1.0, 1.0, (B, N)).astype(np.float32)
    ids = np.tile(np.arange(N, dtype=np.float32), (B, 1))
    vals = rng.normal(size=(B, N)).astype(np.float32)
    picked, anc = _port_select(w, [ids, vals],
                               rng.uniform(0.1, 0.9, B).astype(np.float32))
    np.testing.assert_array_equal(picked[0], anc)
    np.testing.assert_array_equal(picked[1],
                                  np.take_along_axis(vals, anc, axis=1))


def test_degenerate_weight_selects_only_the_heavy_particle():
    w = np.full((B, N), 1e-8, np.float32)
    w[:, 100] = 1e6
    _, anc = _port_select(w, [w], np.full(B, 0.5, np.float32))
    assert (anc == 100).all()


@pytest.mark.parametrize("u0", [2.0 ** -24, 0.5, 1.0 - 2.0 ** -24])
def test_extreme_u0_selects_real_particles(u0):
    """The clamp: rounding may push the last point past the total; every
    slot must still select a particle, and slot 0 never a zero weight."""
    rng = np.random.default_rng(3)
    w = rng.gamma(1.0, 1.0, (B, N)).astype(np.float32)
    w[:, 0] = 0.0
    x = rng.uniform(1.0, 2.0, (B, N)).astype(np.float32)
    picked, anc = _port_select(w, [x], np.full(B, u0, np.float32))
    assert (anc > 0).all() and (anc < N).all()
    np.testing.assert_array_equal(picked[0],
                                  np.take_along_axis(x, anc, axis=1))
    assert (w[np.arange(B)[:, None], anc] > 0).all()


def test_wrapper_validation():
    w = torch.ones(4, 64)
    with pytest.raises(ValueError):        # N not a multiple of 32
        systematic_select(torch.ones(4, 48), torch.ones(1, 4, 48),
                          torch.full((4,), 0.5))
    with pytest.raises(ValueError):        # leaves shape
        systematic_select(w, torch.ones(1, 3, 64), torch.full((4,), 0.5))
    with pytest.raises(ValueError):        # dtype
        systematic_select(w.double(), torch.ones(1, 4, 64, dtype=torch.float64),
                          torch.full((4,), 0.5, dtype=torch.float64))
    with pytest.raises(ValueError):        # contiguity
        systematic_select(torch.ones(64, 4).T, torch.ones(1, 4, 64),
                          torch.full((4,), 0.5))
    picked, anc = systematic_select_reference(w, torch.ones(1, 4, 64),
                                              torch.full((4,), 0.5))
    assert anc.dtype == torch.int32 and picked.shape == (1, 4, 64)


@pytest.mark.parametrize("n,kper", [(64, 2), (1024, 4), (2048, 8),
                                    (4096, 4), (96, 2), (32, 8)])
def test_layouts_the_kernel_takes_and_the_plain_cdf(n, kper):
    """Each layout the standalone kernel runs (kPer neighbouring slots
    with at most 1024 threads) gives the plain law on the CPU, and its CDF
    is the plain cumulative sum."""
    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.gamma(1.0, 1.0, (4, n)).astype(np.float32))
    leaves = torch.from_numpy(rng.normal(size=(1, 4, n)).astype(np.float32))
    u0 = torch.full((4,), 0.37)
    picked, anc, cdf = systematic_select(w, leaves, u0, kper=kper,
                                         return_cdf=True)
    want = systematic_select_reference(w, leaves, u0)
    assert torch.equal(picked, want[0]) and torch.equal(anc, want[1])
    assert torch.equal(cdf, torch.cumsum(w, -1))


@pytest.mark.parametrize("n,kper", [(2048, 1), (4096, 2), (512, 3),
                                    (512, 16)])
def test_layouts_the_kernel_refuses(n, kper):
    """One slot per thread (a layout no kernel runs), more than 1024
    threads, or a kPer other than 2, 4, 8."""
    w = torch.ones(2, n)
    with pytest.raises(ValueError, match="kper"):
        systematic_select(w, torch.ones(1, 2, n), torch.full((2,), 0.5),
                          kper=kper)
