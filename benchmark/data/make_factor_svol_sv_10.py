"""The data of the ``factor_svol_sv_10`` configuration, made with numpy
alone.

    python3 benchmark/data/make_factor_svol_sv_10.py
        writes factor_svol_sv_10_returns.csv beside this file: T = 3084
        steps of n = 10 returns (x 100, the scale of the SPY series),
        simulated once from GENERATING and the seed SEED;
    python3 benchmark/data/make_factor_svol_sv_10.py --draws S.csv
        writes factor_svol_sv_10_posterior_draws.npy beside this file:
        DRAWS rows taken at even spacing from S.csv, the kept samples of a
        pilot run of ``ssme_tpu_torch.examples.estimate_factor_svol
        --idio-sv`` (``--samples-out``), as float32.

The model (Pitt & Shephard 1999, as published; ``ssme_tpu_torch/models/
factor_svol.py::make_sv_model``): k = 2 factor log-variances f and n = 10
idiosyncratic ones u, each an AR(1) h_{t,j} = mu_j + phi_j (h_{t-1,j} -
mu_j) + sigma_j e from its stationary law, and y_t ~ N(0, L diag(e^{f_t})
L' + diag(e^{u_t})), one observation after each transition.  The first
five rows of L and the factors' parameters are ``factor_svol_5``'s; the
idiosyncratic levels e^{mu_u} are variances of 0.25-0.40, as its d.
"""

import argparse
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T_LEN = 3084
SEED = 20_261_018
DRAWS = 4096
GENERATING = {
    "phi": [0.98, 0.95, 0.97, 0.95, 0.96, 0.98, 0.94, 0.97, 0.95, 0.96,
            0.93, 0.97],
    "mu": [-0.5, -1.5, -1.2, -1.4, -1.05, -0.92, -1.2, -1.27, -1.11,
           -0.97, -1.31, -1.14],
    "sigma": [0.15, 0.25, 0.15, 0.20, 0.12, 0.10, 0.22, 0.18, 0.14, 0.16,
              0.20, 0.12],
    "loadings": [[0.9, 0.0], [0.8, 0.3], [0.7, 0.5], [0.6, -0.4],
                 [0.5, 0.6], [0.85, 0.2], [0.75, -0.3], [0.65, 0.45],
                 [0.55, -0.5], [0.4, 0.7]],
}


def generating_row():
    """GENERATING as a parameter row [phi, mu, sigma (12 each), vec L]."""
    g = GENERATING
    return np.concatenate([g["phi"], g["mu"], g["sigma"],
                           np.ravel(g["loadings"])])


def simulate(seed=SEED, t_len=T_LEN):
    """(T, 10) returns of the model at GENERATING."""
    rng = np.random.default_rng(seed)
    phi, mu, sigma = (np.asarray(GENERATING[k]) for k in ("phi", "mu",
                                                          "sigma"))
    loadings = np.asarray(GENERATING["loadings"])
    n, k = loadings.shape
    h = mu + rng.standard_normal(n + k) * sigma / np.sqrt(1.0 - phi * phi)
    ys = np.empty((t_len, n))
    for t in range(t_len):
        h = mu + phi * (h - mu) + sigma * rng.standard_normal(n + k)
        f = np.exp(0.5 * h[:k]) * rng.standard_normal(k)
        ys[t] = loadings @ f + np.exp(0.5 * h[k:]) * rng.standard_normal(n)
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
        np.save(os.path.join(HERE, "factor_svol_sv_10_posterior_draws.npy"),
                thin_draws(args.draws))
    else:
        np.savetxt(os.path.join(HERE, "factor_svol_sv_10_returns.csv"),
                   simulate(), delimiter=",", fmt="%.9g")


if __name__ == "__main__":
    main()
