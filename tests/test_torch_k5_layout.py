"""The fused SVOL step kernel's layout (``csrc/svol_step.cu``), emulated
on the CPU: the source's thread -> pair map, every pair of every row
taken by exactly one thread at counts with an odd number of pairs and
partial blocks, and the pair's counter (k, 0, b, 0) giving particles 2k
and 2k + 1 the normals the plain version draws (``_prng.normals_steps``),
bit for bit; then the bound's counts and the bit checks' inputs and
digest (``ops/svol_kernel.py``)."""

import math
import os
import re

import numpy as np
import pytest
import torch

from ssme_tpu_torch.ops import _prng
from ssme_tpu_torch.ops import svol_kernel as k5

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ssme_tpu_torch", "csrc", "svol_step.cu")


def _source():
    with open(SRC) as f:
        return f.read()


THREADS = int(re.search(r"constexpr int kThreads = (\d+);",
                        _source()).group(1))


def thread_pairs(num_rows, num_particles):
    """The source's map: thread t of block (x, b) of the (ceil(N / 2 /
    kThreads), B) grid takes pair k = x kThreads + t of row b, and a
    thread past the row's N / 2 pairs returns.  (B, threads a row) pair
    indices, -1 for the idle threads."""
    pairs = num_particles // 2
    blocks = (pairs + THREADS - 1) // THREADS
    k = torch.arange(blocks * THREADS, dtype=torch.int64)
    k = torch.where(k < pairs, k, torch.full_like(k, -1))
    return k.expand(num_rows, -1)


def test_the_emulated_map_is_the_sources():
    src = _source()
    assert "dim3((num_particles / 2 + kThreads - 1) / kThreads, num_rows)" \
        in src
    assert "k = blockIdx.x * blockDim.x + threadIdx.x" in src
    assert "b = blockIdx.y" in src
    assert "if (k >= static_cast<uint32_t>(num_pairs)) return;" in src
    assert "make_uint4(k, 0u, b, ssme::kTagNormal)" in src
    assert "(static_cast<size_t>(b) * num_pairs + k) * 2" in src


@pytest.mark.parametrize("b, n", [(1, 2), (3, 6), (2, 130), (1, 512),
                                  (2, 514), (3, 1026), (1, 4098)])
def test_every_pair_once_tails_included(b, n):
    pairs = thread_pairs(b, n)
    assert pairs.shape[1] % THREADS == 0
    assert pairs.shape[1] - THREADS < n // 2 <= pairs.shape[1]
    for row in pairs:
        taken = row[row >= 0]
        assert torch.equal(taken, torch.arange(n // 2))
        # the particles the row's threads write: each once
        parts = torch.stack([2 * taken, 2 * taken + 1], dim=-1).reshape(-1)
        assert torch.equal(parts.sort().values, torch.arange(n))


@pytest.mark.parametrize("b, n", [(3, 6), (2, 130), (1, 4098)])
def test_pair_counters_give_the_plain_normals(b, n):
    seed = _prng.seed_words(0x5EED5)
    k0, k1 = seed[0], seed[1]
    pairs = thread_pairs(b, n)
    rows = torch.arange(b)[:, None].expand_as(pairs)
    live = pairs >= 0
    k, r = pairs[live], rows[live]
    zero = torch.zeros_like(k)
    w0, w1, _, _ = _prng.philox4x32_10(k, zero, r, zero + _prng.TAG_NORMAL,
                                       k0, k1)
    zc, zs = _prng.box_muller(w0, w1)
    got = torch.empty(b, n)
    got[r, 2 * k], got[r, 2 * k + 1] = zc, zs
    want = _prng.normals_steps(seed, torch.arange(b),
                               torch.zeros(1, dtype=torch.int64), n)[0]
    assert torch.equal(got, want)
    # and the plain step's x' takes exactly these normals
    params = torch.tensor([[1.1, 0.9, 0.25]] * b)
    x = torch.from_numpy(np.linspace(-1, 1, b * n, dtype=np.float32)
                         ).reshape(b, n)
    x_new, _ = k5.fused_svol_propagate_weight(seed, 0.3, params, x,
                                              torch.zeros_like(x))
    assert torch.equal(x_new, params[:, 1:2] * x + params[:, 2:3] * got)


def test_step_bounds_count_the_law():
    b = n = 4096
    pairs = b * n // 2
    sms, clock = 132, 1.98e9
    bnd, by, byte_ms, issue_ms = k5.step_bounds(b, n, sms, clock)
    assert byte_ms == pytest.approx((16 * b * n + 12 * b + 20) / 3.35e12
                                    * 1e3)
    # special functions: 4 a pair + 3 a particle at 16 a clock an SM,
    # over the multiplies' 20 a pair at 64
    assert issue_ms == pytest.approx(10 * pairs / 16 / (sms * clock) * 1e3)
    assert (bnd, by) == (byte_ms, "bytes")
    assert math.isclose(byte_ms, 0.0801, rel_tol=1e-3)


def test_fixed_inputs_and_digest():
    params, x, lw = k5.fixed_inputs(3, 6, "cpu")
    assert params.shape == (3, 3) and x.shape == lw.shape == (3, 6)
    assert float(x.min()) >= -2 and float(x.max()) < 2
    assert float(lw.max()) <= 0 and float(lw.min()) > -8
    again = k5.fixed_inputs(3, 6, "cpu")
    assert all(torch.equal(a, b) for a, b in zip((params, x, lw), again))
    d = k5.digest(x, lw)
    assert d == k5.digest(x.clone(), lw.clone()) and len(d) == 16
    assert d != k5.digest(lw, x)
    flipped = x.clone()
    flipped.view(torch.int32)[1, 2] ^= 1
    assert k5.digest(flipped, lw) != d
