"""The data of the ``factor_svol_5`` configuration, made with numpy alone.

    python3 benchmark/data/make_factor_svol_5.py
        writes factor_svol_5_returns.csv beside this file: T = 3084 steps
        of n = 5 returns (x 100, the scale of the SPY series), simulated
        once from GENERATING and the seed SEED;
    python3 benchmark/data/make_factor_svol_5.py --draws S.csv
        writes factor_svol_5_posterior_draws.npy beside this file: DRAWS
        rows taken at even spacing from S.csv, the kept samples of a pilot
        run of ``ssme_tpu_torch.examples.estimate_factor_svol``
        (``--samples-out``), as float32.

The model (Pitt & Shephard 1999, as ``ssme_tpu_torch/models/factor_svol.py``
states it): k = 2 AR(1) log-volatility factors x_{t,j} = mu_j + phi_j
(x_{t-1,j} - mu_j) + sigma_j e, x_0 from their stationary law, and
y_t ~ N(0, L diag(e^{x_t}) L' + diag(d)), one observation after each
transition.
"""

import argparse
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T_LEN = 3084
SEED = 20_251_019
DRAWS = 4096
GENERATING = {
    "phi": [0.98, 0.95],
    "mu": [-0.5, -1.5],
    "sigma": [0.15, 0.25],
    "loadings": [[0.9, 0.0], [0.8, 0.3], [0.7, 0.5], [0.6, -0.4],
                 [0.5, 0.6]],
    "d": [0.30, 0.25, 0.35, 0.40, 0.30],
}


def simulate(seed=SEED, t_len=T_LEN):
    """(T, 5) returns of the factor model at GENERATING."""
    rng = np.random.default_rng(seed)
    phi, mu, sigma = (np.asarray(GENERATING[k]) for k in ("phi", "mu",
                                                          "sigma"))
    loadings = np.asarray(GENERATING["loadings"])
    d = np.asarray(GENERATING["d"])
    x = mu + rng.standard_normal(2) * sigma / np.sqrt(1.0 - phi * phi)
    ys = np.empty((t_len, len(d)))
    for t in range(t_len):
        x = mu + phi * (x - mu) + sigma * rng.standard_normal(2)
        f = np.exp(0.5 * x) * rng.standard_normal(2)
        ys[t] = loadings @ f + np.sqrt(d) * rng.standard_normal(len(d))
    return ys


def thin_draws(samples_csv, count=DRAWS):
    """``count`` rows at even spacing of a pilot run's kept samples."""
    s = np.loadtxt(samples_csv, delimiter=",", ndmin=2)
    if len(s) < count:
        raise ValueError(f"{samples_csv} holds {len(s)} draws, want at "
                         f"least {count}")
    idx = np.linspace(0, len(s) - 1, count).round().astype(int)
    return s[idx].astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--draws", default=None,
                   help="a pilot run's samples CSV: write the start draws")
    args = p.parse_args(argv)
    if args.draws:
        np.save(os.path.join(HERE, "factor_svol_5_posterior_draws.npy"),
                thin_draws(args.draws))
    else:
        np.savetxt(os.path.join(HERE, "factor_svol_5_returns.csv"),
                   simulate(), delimiter=",", fmt="%.9g")


if __name__ == "__main__":
    main()
