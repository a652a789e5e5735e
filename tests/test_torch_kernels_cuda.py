"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test decides inside itself whether a card exists
and skips without one.  The file imports no JAX, so it runs on a machine
with a card and no JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest
"""

import math

import numpy as np
import pytest
import torch

from ssme_tpu_torch.ops import _prng, _select
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
