"""The port's ``transforms.ParamPack`` against the JAX package's on the
cases of ``tests/test_transforms.py`` (golden values of the reference's
``test/test_parameters.cpp:112-165``).

Both packs get the same numpy inputs; their outputs agree to float32
tolerance (rtol 1e-5: the two packages' log, log1p, sigmoid and softplus
are different float32 implementations, a few ulp apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssme_tpu import transforms as jtr
from ssme_tpu_torch import transforms as tr

torch.set_num_threads(1)

NAMES = ("null", "log", "logit", "twice_fisher")
TRANS_VALS = np.array([1.0, -1.3, 9.5, 0.89], dtype=np.float32)
GOLDEN_CONSTRAINED = np.array([1.0, 0.2725318, 0.9999252, 0.4177803])
GOLDEN_LOG_JAC = -11.6851
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def test_param_pack_subset_and_jacobian():
    pp = tr.ParamPack(torch.from_numpy(TRANS_VALS), NAMES,
                      from_transformed=True)
    jp = jtr.ParamPack(jnp.asarray(TRANS_VALS), NAMES, from_transformed=True)
    full = pp.get_untrans_params()
    _close(full, jp.get_untrans_params())
    _close(pp.get_untrans_params(1, 2), full[1:3])
    _close(pp.get_untrans_params(1, 2), jp.get_untrans_params(1, 2))
    _close(pp.get_trans_params(2), jp.get_trans_params(2))
    _close(pp.get_trans_params(0, 3), TRANS_VALS)
    _close(pp.get_log_jacobian(), jp.get_log_jacobian())
    assert abs(float(pp.get_log_jacobian()) - GOLDEN_LOG_JAC) < 1e-3
    _close(full, GOLDEN_CONSTRAINED, rtol=0, atol=1e-4)


def test_param_pack_from_untransformed():
    vals = np.array([1.0, 2.0, 0.5, 0.3], dtype=np.float32)
    pp = tr.ParamPack(torch.from_numpy(vals), NAMES, from_transformed=False)
    jp = jtr.ParamPack(jnp.asarray(vals), NAMES, from_transformed=False)
    _close(pp.get_trans_params(), jp.get_trans_params())
    _close(pp.get_untrans_params(), jp.get_untrans_params())
    np.testing.assert_allclose(pp.get_untrans_params().numpy(), vals,
                               rtol=5e-4, atol=1e-4)


def _incremental(pack_cls):
    pp = pack_cls.empty(4)
    pp.add_param_and_transform(TRANS_VALS[0], "null")
    pp.add_param_and_transform(TRANS_VALS[1], "log", is_transformed=True)
    # the remaining two in the CONSTRAINED space
    pp.add_param_and_transform(GOLDEN_CONSTRAINED[2], "logit",
                               is_transformed=False)
    pp.add_param_and_transform(GOLDEN_CONSTRAINED[3], "twice_fisher",
                               is_transformed=False)
    return pp


def test_param_pack_incremental_construction():
    pp, jp = _incremental(tr.ParamPack), _incremental(jtr.ParamPack)
    _close(pp.get_trans_params(), jp.get_trans_params())
    _close(pp.get_untrans_params(), jp.get_untrans_params())
    _close(pp.get_log_jacobian(), jp.get_log_jacobian(), rtol=1e-4)
    np.testing.assert_allclose(pp.get_untrans_params().numpy(),
                               GOLDEN_CONSTRAINED, atol=2e-4)
    np.testing.assert_allclose(pp.get_trans_params().numpy(), TRANS_VALS,
                               rtol=5e-3, atol=1e-4)
    assert abs(float(pp.get_log_jacobian()) - GOLDEN_LOG_JAC) < 2e-2
    assert pp.dim == jp.dim == 4
    assert pp.transform.names == jp.transform.names == NAMES
    assert pp.get_trans_params().dtype == torch.float32


@pytest.mark.parametrize("pack_cls", [tr.ParamPack, jtr.ParamPack],
                         ids=["torch", "jax"])
def test_param_pack_incremental_overflow_and_underfill(pack_cls):
    pp = pack_cls.empty(1)
    pp.add_param_and_transform(0.5, "log")
    # capacity exceeded raises, as std::length_error
    # ("can't add any more transformations", parameters.h:521)
    with pytest.raises(ValueError, match="can't add any more"):
        pp.add_param_and_transform(0.1, "null")
    half = pack_cls.empty(2).add_param_and_transform(0.5, "log")
    for get in (half.get_untrans_params, half.get_trans_params,
                half.get_log_jacobian):
        with pytest.raises(ValueError, match="not fully constructed"):
            get()
    with pytest.raises(ValueError, match="numelem"):
        pack_cls.empty(0)


def test_param_pack_rejects_wrong_size_and_unknown_transform():
    with pytest.raises(ValueError, match="right size"):
        tr.ParamPack(torch.zeros(3), NAMES)
    with pytest.raises(ValueError):
        tr.ParamPack(torch.zeros(2), ("null", "sqrt"))
    with pytest.raises(ValueError):
        tr.ParamPack.empty(2).add_param_and_transform(0.5, "sqrt")


def test_param_pack_batched_rows_match_jax():
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(6, 4)).astype(np.float32)
    pp = tr.ParamPack(torch.from_numpy(rows), NAMES)
    jp = jtr.ParamPack(jnp.asarray(rows), NAMES)
    _close(pp.get_untrans_params(), jp.get_untrans_params())
    _close(pp.get_untrans_params(2, 3), jp.get_untrans_params(2, 3))
    _close(pp.get_log_jacobian(), jp.get_log_jacobian(), rtol=1e-5,
           atol=1e-5)
