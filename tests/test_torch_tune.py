"""The port's tuning CLIs (``ssme_tpu_torch/examples/tune_variance.py``,
``tune_pmmh.py``) on the CPU at a tiny size, and their variance by random
regrouping against the JAX script's on the same singles (equal to float64
rounding: both are the same numpy code on the same numbers and stream)."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from ssme_tpu_torch.examples import tune_pmmh, tune_variance
from ssme_tpu_torch.ops.svol_filter_kernel import svol_filter

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def test_var_of_r_average_equals_the_jax_scripts():
    jax_tv = _jax_script("tune_variance")
    singles = np.random.default_rng(3).normal(-4000.0, 1.3, size=96)
    for r in (1, 2, 4, 8, 48, 64):
        got = tune_variance.var_of_r_average(
            singles, r, n_boot=50, rng=np.random.default_rng(r))
        want = jax_tv.var_of_r_average(
            singles, r, n_boot=50, rng=np.random.default_rng(r))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.isnan(tune_variance.var_of_r_average(singles, 64)[0])


def test_tune_variance_main_on_cpu(tmp_path):
    out = str(tmp_path / "v.jsonl")
    before = svol_filter.launches
    tune_variance.main(["--device", "cpu", "--particles", "32", "64",
                        "--singles", "8", "--launch-rows", "4",
                        "--replicates", "1", "2", "4", "--t-len", "40",
                        "--out", out])
    assert svol_filter.launches == before   # the plain version on the CPU
    recs = _records(out)
    assert [(r["N"], r["R"]) for r in recs] == [
        (n, r) for n in (32, 64) for r in (1, 2, 4)]
    for rec in recs:
        assert rec["T"] == 40 and rec["device"] == "cpu"
        assert rec["cost_nr"] == rec["N"] * rec["R"]
        assert rec["sec_per_eval"] == pytest.approx(rec["sec_per_row"]
                                                    * rec["R"])
        assert rec["var_logl"] > 0 and np.isfinite(rec["mean_single"])
    singles = np.load(str(tmp_path / "v_singles_N64.npy"))
    assert singles.shape == (8,) and np.all(np.isfinite(singles))
    assert recs[3]["var_single"] == pytest.approx(singles.var(ddof=1),
                                                  rel=1e-6)


def test_tune_pmmh_main_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "p.jsonl")
    tune_pmmh.main(["--device", "cpu", "--iters", "16", "--chunk", "4",
                    "--configs", "a,2,32,2,1000", "b,3,32,1,1000000000",
                    "--t-len", "40", "--out", out])
    recs = _records(out)
    assert [r["label"] for r in recs] == ["a", "b"]
    a, b = recs
    assert (a["chains"], a["N"], a["R"], a["t1"]) == (2, 32, 2, 1000)
    assert b["t1"] is None and b["chains"] == 3
    for rec in recs:
        assert rec["iters"] == 16 and rec["T"] == 40
        assert 0.0 <= rec["accept_rate"] <= 1.0
        assert rec["sec_per_iter"] > 0
        assert len(rec["rhat"]) == len(rec["ess"]) == 3
        assert len(rec["posterior_mean"]) == len(rec["posterior_sd"]) == 3
        assert all(np.isfinite(rec["posterior_mean"]))
        assert rec["device"] == "cpu"
    assert "a chunk" in capsys.readouterr().err


def test_clis_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (tune_variance.main, tune_pmmh.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
