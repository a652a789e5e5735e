"""The Liu-West kernel model of two-factor SVOL
(``ops/liu_west_megakernel.py::factor_svol_lw_kernel_model``, K3's
``factor_svol_5_lw`` instance) on the CPU: its plain hooks against the
model (``models/factor_svol.py``), the plain version of the whole bank
against the benchmark's float64 reference, and the instance's place in
the CUDA header."""

import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from ssme_tpu_torch.models import factor_svol
from ssme_tpu_torch.ops import liu_west_megakernel as lwm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "ssme_tpu_torch", "csrc")
PANEL = os.path.join(ROOT, "benchmark", "data", "factor_svol_5_returns.csv")


def _params(rng, f, n):
    """(P, F, N) constrained float32 parameters at seeded random points of
    the default box."""
    lo = np.array([b[0] for b in lwm.FACTOR_SVOL_5_PRIOR_BOUNDS])
    hi = np.array([b[1] for b in lwm.FACTOR_SVOL_5_PRIOR_BOUNDS])
    u = rng.uniform(size=(len(lo), f, n))
    return torch.as_tensor(lo[:, None, None] + (hi - lo)[:, None, None] * u,
                           dtype=torch.float32)


class _Normals:
    """The hooks' rng: hands out given (F, N) normals in order."""

    def __init__(self, eps):
        self.eps = list(eps)

    def normal(self, shape):
        e = self.eps.pop(0)
        assert tuple(e.shape) == tuple(shape)
        return e


def test_plain_hooks_match_the_model():
    """At seeded random parameters (one per particle) and states, in
    float32: log_weight is the model's log_g (the explicit 2 x 2 Woodbury
    against its Cholesky form with a 1e-8 jitter: within 2e-5 relative and
    1e-4 nats), prop_mu its prop_mu and propagate its transition on the
    same normals (mu + phi (x - mu) + sigma e, to rounding)."""
    rng = np.random.default_rng(23)
    f, n = 3, 40
    km = lwm.factor_svol_lw_kernel_model()
    model = factor_svol.make_model(5, 2)
    cp = _params(rng, f, n)
    rows = cp.permute(1, 2, 0)                                # (F, N, P)
    x = torch.as_tensor(rng.normal(-1.0, 1.0, (f, n, 2)), dtype=torch.float32)
    state = (x[..., 0], x[..., 1])
    for _ in range(3):
        y = torch.as_tensor(rng.normal(0.0, 1.5, 5), dtype=torch.float32)
        got = km.log_weight(cp, state, tuple(y.unbind()), ())
        want = model.log_g(rows.reshape(f * n, -1), y,
                           x.reshape(f * n, 1, 2), None).reshape(f, n)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-4)
    got = torch.stack(km.prop_mu(cp, state, (), ()), -1)
    want = model.prop_mu(rows.reshape(f * n, -1), x.reshape(f * n, 1, 2),
                         None).reshape(f, n, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    eps = torch.as_tensor(rng.normal(size=(2, f, n)), dtype=torch.float32)
    got = torch.stack(km.propagate(_Normals(eps), cp, state, (), ()), -1)
    want = want + eps.permute(1, 2, 0) * rows[..., 4:6]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert km.transform_codes == factor_svol.transforms(5, 2)
    assert [h(cp, state) is state[k] for k, h in
            enumerate(km.functionals)] == [True, True]


def test_plain_bank_matches_the_float64_reference():
    """The plain version of K3's factor bank (float32, the kernel's
    Philox draws) against the benchmark's float64 Liu-West reference
    (draws of its own), F = 8 filters of N = 64 over the panel's first 60
    steps, APF, resampling every step: two estimators of the same
    evidence and parameter clouds.  The mean log-likelihoods within 4
    combined standard errors of the filters' spread; the 21 cloud-mean
    gaps within 6 standard errors of their gap over the filters (the
    cell's cloud_z limit); every filter finite."""
    sys.path.insert(0, ROOT)
    from benchmark.reference import liu_west_factor as ref

    torch.set_num_threads(2)
    ys = torch.as_tensor(np.loadtxt(PANEL, delimiter=",", ndmin=2)[:60],
                         dtype=torch.float32)
    f, n = 8, 64
    km = lwm.factor_svol_lw_kernel_model()
    out = lwm.lw_megakernel(km, 17, ys, None, num_filters=f,
                            num_particles=n)
    ll = out["log_likelihood"].double()
    assert torch.isfinite(ll).all()
    ref_ll, ref_cloud = ref.liu_west_apf(
        19, ys, f, n, 0.99, lwm.FACTOR_SVOL_5_PRIOR_BOUNDS, torch.float64,
        "cpu")
    se = math.sqrt(float(ll.var()) / f + float(ref_ll.var()) / f)
    assert abs(float(ll.mean() - ref_ll.mean())) <= 4 * se
    cloud = lwm.lw_cloud_params(km, out["cloud"]).double()     # (F, N, P)
    d = cloud.mean(1) - ref_cloud.mean(1)                      # (F, P)
    z = d.mean(0) / torch.clamp(d.std(0) / math.sqrt(f), min=1e-4)
    assert float(z.abs().max()) <= 6.0, z


def test_header_registers_the_instance_and_the_argument_block_holds_it():
    """csrc/lw_models.cuh's id table is CUDA_LW_MODEL_IDS (factor_svol_5_lw
    among them), the argument block's kMaxParams (csrc/lw_megakernel.cuh)
    is the wrapper's _MAX_PARAMS, at least the instance's 21 parameters,
    and its traits name the two-leaf state, the 5-column observation and
    two functionals."""
    src = open(os.path.join(CSRC, "lw_models.cuh")).read()
    ids = {name: int(num) for num, name in re.findall(
        r"constexpr int kLWModel\w+ = (\d+);\s*// \"(\w+)\"", src)}
    assert ids == lwm.CUDA_LW_MODEL_IDS
    assert ids["factor_svol_5_lw"] == 3
    cuh = open(os.path.join(CSRC, "lw_megakernel.cuh")).read()
    k_max = int(re.search(r"constexpr int kMaxParams = (\d+);", cuh).group(1))
    km = lwm.factor_svol_lw_kernel_model()
    assert k_max == lwm._MAX_PARAMS >= km.num_params == 21
    assert km.num_params > lwm.REG_PARAMS  # the wide row's
    body = re.search(r"struct FactorSvolLW \{(.*?)\n\};", src, re.S).group(1)
    traits = {k: int(v) for k, v in re.findall(
        r"static constexpr int (k\w+) = (\d+);", body)}
    assert traits == {"kNumParams": 21, "kNumState": 2, "kDimObs": 5,
                      "kDimCov": 0, "kNumFunctionals": 2}
    assert (km.num_state, km.dim_obs, len(km.functionals)) == (2, 5, 2)
    with pytest.raises(ValueError, match="prior_bounds"):
        lwm.factor_svol_lw_kernel_model(4)
    assert lwm.factor_svol_lw_kernel_model(
        4, ((0.8, 0.99),) * 18).cuda_instance is None
