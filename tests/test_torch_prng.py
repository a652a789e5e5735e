"""The port's Philox4x32-10 and its conversions (``ssme_tpu_torch/ops/
_prng.py``, the plain version of ``csrc/philox.cuh``)."""

import numpy as np
import pytest
import torch

from ssme_tpu_torch.ops import _prng

torch.set_num_threads(1)


def _words(*vals):
    return [torch.tensor(v, dtype=torch.int64) for v in vals]


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answer_vectors(ctr, key, want):
    """Random123's published Philox4x32-10 known-answer vectors."""
    got = _prng.philox4x32_10(*_words(*ctr), *_words(*key))
    assert tuple(int(g) for g in got) == want


def test_uniform_edge_rules():
    w = torch.tensor([0, 1, 255, 256, 511, 2 ** 31, 2 ** 32 - 256,
                      2 ** 32 - 1], dtype=torch.int64)
    u1 = _prng.uniform_open_zero(w)
    u2 = _prng.uniform_closed_zero(w)
    off = _prng.uniform_offset(w)
    assert (u1 > 0).all() and (u1 <= 1).all() and u1[-1] == 1.0
    assert (u2 >= 0).all() and (u2 < 1).all() and u2[0] == 0.0
    assert (off > 0).all() and (off < 1).all()
    assert off[0] == 2.0 ** -24 and off[-1] == 1.0 - 2.0 ** -24
    # every conversion is exact: an integer times a power of two
    np.testing.assert_array_equal(
        u1.double().numpy(), ((w >> 8) + 1).double().numpy() * 2.0 ** -24)


def test_box_muller_moments():
    seed = _prng.seed_words(20240917)
    z = _prng.normals_steps(seed, torch.arange(64), torch.tensor([5]),
                            4096).double().ravel()
    n = z.numel()                        # 262144 normals
    # 5-sigma bands on the sample moments of N(0, 1)
    assert abs(float(z.mean())) < 5 / np.sqrt(n)
    assert abs(float(z.var()) - 1.0) < 5 * np.sqrt(2.0 / n)
    assert abs(float((z ** 3).mean())) < 5 * np.sqrt(15.0 / n)
    assert abs(float((z ** 4).mean()) - 3.0) < 5 * np.sqrt(96.0 / n)


def test_normals_follow_the_documented_mapping():
    seed = _prng.seed_words(7)
    rows = torch.tensor([0, 3])
    z = _prng.normals_steps(seed, rows, torch.tensor([9]), 8)[0]
    fill = _prng.philox_fill_reference(seed, 4, 8, 9)
    torch.testing.assert_close(z, fill["normals"][rows], rtol=0, atol=0)
    w0, w1, _, _ = _prng.philox4x32_10(*_words(1, 9, 3, _prng.TAG_NORMAL),
                                       seed[0], seed[1])
    zc, zs = _prng.box_muller(w0, w1)
    assert z[1, 2] == zc and z[1, 3] == zs      # pair 1 of row 3
    w0, _, _, _ = _prng.philox4x32_10(*_words(0, 9, 3, _prng.TAG_OFFSET),
                                      seed[0], seed[1])
    assert fill["offsets"][3] == _prng.uniform_offset(w0)


def test_streams_are_distinct_across_steps_rows_and_tags():
    seed = _prng.seed_words(11)
    a, b = _prng.normals_steps(seed, torch.arange(4), torch.tensor([1, 2]),
                               64)
    assert not torch.equal(a, b)
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(_prng.offsets(seed, torch.arange(4), 1),
                           _prng.offsets(seed, torch.arange(4), 2))


def test_seed_words_and_fill_validation():
    s = _prng.seed_words((5 << 32) | 9)
    assert s.tolist() == [9, 5]
    with pytest.raises(ValueError):
        _prng.seed_words(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        _prng.philox_fill(1, 4, 7, 0)
    with pytest.raises(ValueError):
        _prng.philox_fill(1, 4, 8, -1)
    out = _prng.philox_fill(1, 4, 8, 0)      # CPU: the plain version
    assert out["bits"].shape == (4, 4, 4) and out["normals"].shape == (4, 8)
