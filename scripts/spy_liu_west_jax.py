#!/usr/bin/env python
"""The JAX package's Liu-West yardsticks on the full SPY series, written to
``data/spy_liu_west_jax.json``.

Runs the JAX generic ``LiuWestFilter`` (float32, APF, delta 0.99,
``resampler="systematic"``, the model's default prior box, N=512) on SVOL
with leverage over all of ``data/spy_returns.csv``, once per key of
``jax.random.split(jax.random.key(0), 64)`` under ``jax.vmap``, on the CPU:

    python scripts/spy_liu_west_jax.py [--filters 64] [--out PATH]

Two runs, one entry each:

- ``generic``: the filter as the package ships it, whose auxiliary-PF
  first stage selects ancestors by multinomial sampling
  (``ssme_tpu/filters/liu_west.py:191``);
- ``systematic_first_stage``: the same filter with that selection made
  systematic, as the Pallas Liu-West kernels make it
  (``ssme_tpu/ops/liu_west_megakernel.py:397``); the script swaps the
  selection function for the run, the package is not edited.

Each entry records the log-likelihood's mean and sd across filters and
the pooled (all filters' final particles) mean and sd of each parameter.
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

from ssme_tpu import resampling  # noqa: E402
from ssme_tpu.filters import LiuWestFilter  # noqa: E402
from ssme_tpu.filters import liu_west as jax_liu_west  # noqa: E402
from ssme_tpu.io import read_data  # noqa: E402
from ssme_tpu.models import svol_leverage  # noqa: E402

NAMES = ("phi", "mu", "sigma", "rho")


class _FirstStage:
    """``ssme_tpu.resampling`` with ``multinomial_indices`` (the APF first
    stage's only use of it in the filter) bound to the chosen scheme."""

    def __init__(self, scheme):
        self._fn = getattr(resampling, f"{scheme}_indices")

    def __getattr__(self, name):
        if name == "multinomial_indices":
            return self._fn
        return getattr(resampling, name)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--filters", type=int, default=64)
    p.add_argument("--particles", type=int, default=512)
    p.add_argument("--out", default=os.path.join(ROOT, "data",
                                                 "spy_liu_west_jax.json"))
    args = p.parse_args(argv)

    ys = jnp.asarray(read_data(os.path.join(ROOT, "data", "spy_returns.csv"),
                               num_cols=1), jnp.float32)
    zs = jnp.concatenate([jnp.zeros((1, 1), jnp.float32), ys[:-1]])
    keys = jax.random.split(jax.random.key(0), args.filters)

    def run(first_stage):
        # the first-stage selection is looked up on the module at trace time
        jax_liu_west.resampling = _FirstStage(first_stage)
        lw = LiuWestFilter(svol_leverage.make_model(),
                           num_particles=args.particles, delta=0.99,
                           variant="apf", resampler="systematic")
        t0 = time.perf_counter()
        res = jax.jit(jax.vmap(lambda k: lw.run(k, ys, zs)))(keys)
        ll = np.asarray(res.log_likelihood, np.float64)
        params = np.asarray(jax.vmap(lw.param_samples)(res),
                            np.float64).reshape(-1, len(NAMES))
        return {
            "first_stage": first_stage,
            "log_likelihood": {"mean": float(ll.mean()),
                               "sd": float(ll.std(ddof=1))},
            "params": {name: {"mean": float(params[:, i].mean()),
                              "sd": float(params[:, i].std(ddof=1))}
                       for i, name in enumerate(NAMES)},
            "cpu_secs": time.perf_counter() - t0,
        }

    out = {
        "command": "python scripts/spy_liu_west_jax.py --filters "
                   f"{args.filters} --particles {args.particles}",
        "filter": "ssme_tpu.filters.LiuWestFilter(svol_leverage.make_model(),"
                  f" num_particles={args.particles}, delta=0.99, "
                  "variant='apf', resampler='systematic'), float32, CPU",
        "keys": f"jax.random.split(jax.random.key(0), {args.filters})",
        "T": int(ys.shape[0]),
        "filters": args.filters,
        "generic": run("multinomial"),
        "systematic_first_stage": run("systematic"),
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
