#!/usr/bin/env python
"""The JAX package's yardsticks for the generic filter kernel's model
families, written to ``data/k2_families_jax.json``.

Runs the JAX package's generic filters (float32, N=512, systematic
resampling every step) once per key of ``jax.random.split(
jax.random.key(0), 64)`` under ``jax.vmap``, on the CPU:

    python scripts/k2_families_jax.py [--filters 64] [--out PATH]

Entries (each: the log-likelihood's mean and sd across filters):

- ``svol_t_bootstrap``: ``BootstrapFilter`` on Student-t SVOL over all of
  ``data/spy_returns.csv`` at (beta, phi, ss, nu) = (0.868, 0.975, 0.064,
  10), the SVOL posterior means of ``data/spy_posterior_summary.json``
  with nu at its prior mean;
- ``svol_apf``: ``AuxiliaryParticleFilter`` on SVOL over SPY at (0.868,
  0.975, 0.064);
- ``poisson_ar_bootstrap``, ``poisson_ar_apf``: both filters on Poisson
  AR(1) at (phi, mu, sigma) = (0.9, 1.0, 0.3), over a T=3084 count series
  simulated here with ``numpy.random.default_rng(0)`` and stored in the
  file (``poisson_ar_counts``);
- ``factor_svol_f32``, ``factor_svol_f64``: ``BootstrapFilter`` on
  factor SVOL with 4 assets and 2 factors at the parameters
  ``factor_svol.make_model(4, 2).sample_prior(jax.random.key(0))`` (as
  ``examples/validate_tpu.py`` check 4), over a T=500 series simulated
  here with ``numpy.random.default_rng(1)`` and stored in the file
  (``factor_svol_ys``); once in float32 and once with
  ``jax_enable_x64``, the float64 ground truth.

The APF entries come twice: as the package ships the filter, whose first
stage selects ancestors by multinomial sampling
(``ssme_tpu/filters/auxiliary.py:74``), and with that one selection made
systematic, as the Pallas filter kernel selects it; the script swaps the
selection function for the run, the package is not edited.

The port's ``chip_smoke.py`` reads the file; it imports no JAX itself.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ssme_tpu import resampling  # noqa: E402
from ssme_tpu.filters import AuxiliaryParticleFilter, BootstrapFilter  # noqa: E402,E501
from ssme_tpu.filters import auxiliary as jax_auxiliary  # noqa: E402
from ssme_tpu.io import read_data  # noqa: E402
from ssme_tpu.models import factor_svol, poisson_ar, svol, svol_t  # noqa: E402

SVOL_T_POINT = (0.868, 0.975, 0.064, 10.0)
SVOL_POINT = SVOL_T_POINT[:3]
POISSON_POINT = (0.9, 1.0, 0.3)
POISSON_T = 3084
FACTOR_ASSETS, FACTOR_T = 4, 500


class _FirstStage:
    """``ssme_tpu.resampling`` with ``multinomial_indices`` (the APF first
    stage's only use of it in the filter) bound to the chosen scheme."""

    def __init__(self, scheme):
        self._fn = getattr(resampling, f"{scheme}_indices")

    def __getattr__(self, name):
        if name == "multinomial_indices":
            return self._fn
        return getattr(resampling, name)


def simulate_poisson(rng, t_len, point):
    phi, mu, sigma = point
    x = mu + rng.normal() * sigma / math.sqrt(1.0 - phi * phi)
    counts = np.empty(t_len, np.int64)
    for t in range(t_len):
        if t:
            x = mu + phi * (x - mu) + sigma * rng.normal()
        counts[t] = rng.poisson(math.exp(x))
    return counts


def simulate_factor(rng, t_len, params, n_assets):
    """y_t = L f_t + D^{1/2} eta_t, f_t ~ N(0, diag(e^{x_t})), with the
    factor log-volatilities x of ``factor_svol``; float64."""
    p = np.asarray(params, np.float64)
    phi, mu, sigma = p[0:2], p[2:4], p[4:6]
    loadings = p[6:6 + 2 * n_assets].reshape(n_assets, 2)
    d = p[6 + 2 * n_assets:]
    x = mu + rng.normal(size=2) * sigma / np.sqrt(1.0 - phi * phi)
    ys = np.empty((t_len, n_assets))
    for t in range(t_len):
        if t:
            x = mu + phi * (x - mu) + sigma * rng.normal(size=2)
        f = rng.normal(size=2) * np.exp(0.5 * x)
        ys[t] = loadings @ f + rng.normal(size=n_assets) * np.sqrt(d)
    return ys


def run_bank(filt, keys, params, ys, dtype=jnp.float32):
    t0 = time.perf_counter()
    params = jnp.asarray(params, dtype)
    ys = jnp.asarray(ys, dtype)
    ll = jax.jit(jax.vmap(lambda k: filt.run(k, params, ys).log_likelihood))(
        keys)
    ll = np.asarray(ll, np.float64)
    return {"mean": float(ll.mean()), "sd": float(ll.std(ddof=1)),
            "min": float(ll.min()), "max": float(ll.max()),
            "cpu_secs": time.perf_counter() - t0}


def run_apf(model, keys, params, ys, n):
    out = {}
    for scheme in ("multinomial", "systematic"):
        jax_auxiliary.resampling = _FirstStage(scheme)
        out[scheme] = run_bank(AuxiliaryParticleFilter(model, n), keys,
                               params, ys)
    jax_auxiliary.resampling = resampling
    return {"first_stage": out}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--filters", type=int, default=64)
    p.add_argument("--particles", type=int, default=512)
    p.add_argument("--out", default=os.path.join(ROOT, "data",
                                                 "k2_families_jax.json"))
    args = p.parse_args(argv)
    n = args.particles
    t_start = time.perf_counter()
    keys = jax.random.split(jax.random.key(0), args.filters)
    spy = np.asarray(read_data(os.path.join(ROOT, "data", "spy_returns.csv"),
                               num_cols=1), np.float32)
    counts = simulate_poisson(np.random.default_rng(0), POISSON_T,
                              POISSON_POINT)
    fmodel = factor_svol.make_model(FACTOR_ASSETS, 2)
    fparams = np.asarray(fmodel.sample_prior(jax.random.key(0)), np.float64)
    # float32, as the kernel reads it; the float64 run widens these values
    fys = simulate_factor(np.random.default_rng(1), FACTOR_T, fparams,
                          FACTOR_ASSETS).astype(np.float32)
    count_ys = counts.astype(np.float32)[:, None]

    out = {
        "command": f"python scripts/k2_families_jax.py --filters "
                   f"{args.filters} --particles {n}",
        "keys": f"jax.random.split(jax.random.key(0), {args.filters})",
        "filters": args.filters,
        "particles": n,
        "resampling": "systematic, every step",
        "svol_t_point": SVOL_T_POINT,
        "svol_point": SVOL_POINT,
        "poisson_ar_point": POISSON_POINT,
        "factor_svol_params": fparams.tolist(),
        "factor_svol_assets": FACTOR_ASSETS,
        "spy_T": int(spy.shape[0]),
        "svol_t_bootstrap": run_bank(
            BootstrapFilter(svol_t.make_model(), n), keys, SVOL_T_POINT, spy),
        "svol_apf": run_apf(svol.make_model(), keys, SVOL_POINT, spy, n),
        "poisson_ar_bootstrap": run_bank(
            BootstrapFilter(poisson_ar.make_model(), n), keys, POISSON_POINT,
            count_ys),
        "poisson_ar_apf": run_apf(poisson_ar.make_model(), keys,
                                  POISSON_POINT, count_ys, n),
        "factor_svol_f32": run_bank(BootstrapFilter(fmodel, n), keys,
                                    fparams, fys),
    }
    # float64 last: the flag changes the default type of every later array
    jax.config.update("jax_enable_x64", True)
    out["factor_svol_f64"] = run_bank(
        BootstrapFilter(factor_svol.make_model(FACTOR_ASSETS, 2), n), keys,
        fparams, fys, dtype=jnp.float64)
    out["cpu_secs"] = time.perf_counter() - t_start
    out["poisson_ar_counts"] = counts.tolist()
    out["factor_svol_ys"] = fys.tolist()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("poisson_ar_counts", "factor_svol_ys")},
                     indent=1))


if __name__ == "__main__":
    main()
