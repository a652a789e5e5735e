#!/usr/bin/env python
"""The JAX package's yardstick for the generic filter kernel's roll
resamplers at large particle counts, written to
``data/roll_resamplers_jax.json``.

Runs the JAX package's generic XLA bootstrap bank
(``ssme_tpu/filters/bootstrap.py::BootstrapFilter``, float32, systematic
resampling under an ESS gate of 0.5 N) on univariate SVOL over all of
``data/spy_returns.csv`` at (beta, phi, ss) = (0.9, 0.98, 0.02), the
``posterior`` point of ``chip_smoke.py`` phase 6, once per key of
``jax.random.split(jax.random.key(0), F)`` under ``jax.vmap``, on the CPU:

    python scripts/roll_resamplers_jax.py [--out PATH]

Entries ``n2048`` (64 keys) and ``n4096`` (32 keys): the log-likelihood's
mean, sd, min and max across filters and the run's seconds on the CPU that
ran it.  The resampler is the JAX bank's systematic one: the kernel's
rejection resampler is unbiased, so its evidence has the same mean, and
its Metropolis resampler is held to it within the bias envelope of
``metropolis_bias_estimate``.

The port's ``chip_smoke.py`` reads the file; it imports no JAX itself.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ssme_tpu.filters import BootstrapFilter  # noqa: E402
from ssme_tpu.io import read_data  # noqa: E402
from ssme_tpu.models import svol  # noqa: E402

POINT = (0.9, 0.98, 0.02)
ESS_THRESHOLD = 0.5
RUNS = {"n2048": (2048, 64), "n4096": (4096, 32)}


def run_bank(n, filters, ys):
    t0 = time.perf_counter()
    filt = BootstrapFilter(svol.make_model(), n, ess_threshold=ESS_THRESHOLD)
    keys = jax.random.split(jax.random.key(0), filters)
    params = jnp.asarray(POINT, jnp.float32)
    ll = jax.jit(jax.vmap(lambda k: filt.run(k, params, ys).log_likelihood))(
        keys)
    ll = np.asarray(ll, np.float64)
    return {"particles": n, "filters": filters,
            "keys": f"jax.random.split(jax.random.key(0), {filters})",
            "mean": float(ll.mean()), "sd": float(ll.std(ddof=1)),
            "min": float(ll.min()), "max": float(ll.max()),
            "cpu_secs": time.perf_counter() - t0}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=os.path.join(ROOT, "data",
                                                 "roll_resamplers_jax.json"))
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    ys = jnp.asarray(np.asarray(read_data(
        os.path.join(ROOT, "data", "spy_returns.csv"), num_cols=1),
        np.float32))
    out = {
        "command": "python scripts/roll_resamplers_jax.py",
        "filter": "ssme_tpu.filters.BootstrapFilter(svol.make_model(), N, "
                  f"ess_threshold={ESS_THRESHOLD}), systematic, float32",
        "svol_point": POINT,
        "spy_T": int(ys.shape[0]),
    }
    for name, (n, filters) in RUNS.items():
        out[name] = run_bank(n, filters, ys)
        print(name, json.dumps(out[name]), flush=True)
    out["cpu_secs"] = time.perf_counter() - t_start
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
