"""The port's fused SVOL step (``ssme_tpu_torch/ops/svol_kernel.py``, the
plain version of ``csrc/svol_step.cu``) against the JAX package's
``fused_svol_propagate_weight`` in interpret mode.

With sigma = 0 the step is deterministic, so both sides are compared to
the tolerance of ``tests/test_ops.py``; with noise the port's plain
version is held to its own Philox normals and to the moments of
sigma eps (JAX's interpret-mode PRNG draws constant bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu import rv
from ssme_tpu.ops import fused_svol_propagate_weight as jax_step
from ssme_tpu_torch.ops import _prng
from ssme_tpu_torch.ops.svol_kernel import (
    fused_svol_propagate_weight, fused_svol_propagate_weight_reference)

torch.set_num_threads(1)
B, N = 8, 256
PARAMS = np.tile(np.array([[1.3, 0.7, 0.2]], dtype=np.float32), (B, 1))


@pytest.mark.parametrize("y", [0.37, -1.2])
def test_sigma_zero_step_matches_jax_interpret(y):
    params = PARAMS.copy()
    params[:, 2] = 0.0
    x = np.linspace(-1, 1, B * N).reshape(B, N).astype(np.float32)
    lw = np.linspace(-2, 0, B * N).reshape(B, N).astype(np.float32)
    want_x, want_lw = jax_step(7, y, jnp.asarray(params), jnp.asarray(x),
                               jnp.asarray(lw), interpret=True)
    got_x, got_lw = fused_svol_propagate_weight(
        7, y, torch.from_numpy(params), torch.from_numpy(x),
        torch.from_numpy(lw))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_lw.numpy(), np.asarray(want_lw),
                               rtol=1e-4, atol=1e-4)
    density = lw + np.asarray(rv.norm_logpdf(y, 0.0,
                                             1.3 * np.exp(0.5 * 0.7 * x)))
    np.testing.assert_allclose(got_lw.numpy(), density, rtol=1e-4, atol=1e-4)


def test_noise_is_the_philox_normal_stream():
    """eps of particle i in row b is normal i of counter (i >> 1, 0, b, 0):
    x' = phi x + sigma eps bit for bit; a one-element y tensor equals the
    float."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32))
    lw = torch.zeros((B, N))
    params = torch.from_numpy(PARAMS)
    got_x, got_lw = fused_svol_propagate_weight(11, 0.5, params, x, lw)
    eps = _prng.normals_steps(_prng.seed_words(11), torch.arange(B),
                              torch.zeros(1, dtype=torch.int64), N)[0]
    assert torch.equal(got_x, params[:, 1:2] * x + params[:, 2:3] * eps)
    tensor_y = fused_svol_propagate_weight(11, torch.tensor([0.5]), params,
                                           x, lw)
    assert torch.equal(tensor_y[0], got_x) and torch.equal(tensor_y[1],
                                                           got_lw)
    assert torch.equal(got_lw, fused_svol_propagate_weight_reference(
        11, 0.5, params, x, lw)[1])


def test_noise_moments():
    x = torch.zeros((B, N))
    xs = torch.stack([fused_svol_propagate_weight(
        seed, 0.0, torch.from_numpy(PARAMS), x, x)[0] for seed in range(8)])
    samples = xs.double().numpy().ravel()         # x' = 0.2 eps
    assert abs(samples.mean()) < 0.01
    np.testing.assert_allclose(samples.std(), 0.2, rtol=0.05)
    assert not np.allclose(xs[0].numpy(), xs[1].numpy())


def test_rejects_bad_shapes_types_and_devices():
    p, x = torch.from_numpy(PARAMS), torch.zeros((B, N))
    for args in ((0.0, p, torch.zeros((B, N - 1)), torch.zeros((B, N - 1))),
                 (0.0, p, x, torch.zeros((B, N - 2))),
                 (0.0, p[:4], x, x),
                 (0.0, torch.zeros((B, 4)), x, x),
                 (0.0, p, x.double(), x),
                 (0.0, p, torch.zeros((B, 2 * N))[:, ::2], x),
                 (0.0, p, torch.zeros(N), torch.zeros(N)),
                 (torch.zeros(2), p, x, x),
                 (torch.zeros(1, dtype=torch.float64), p, x, x),
                 ("0.1", p, x, x),
                 (0.0, p, torch.zeros((0, N)), torch.zeros((0, N)))):
        with pytest.raises(ValueError):
            fused_svol_propagate_weight(0, *args)
    with pytest.raises(ValueError):
        fused_svol_propagate_weight(torch.zeros(3, dtype=torch.int64), 0.0,
                                    p, x, x)
    with pytest.raises(ValueError):
        fused_svol_propagate_weight(0, 0.0, p.to("meta"), x.to("meta"),
                                    x.to("meta"))
