"""The port's SPY flagship CLI and its accuracy gate
(``ssme_tpu_torch/examples/{spy_flagship,accuracy_gate}.py``).

The gate's comparison is the JAX package's ``examples/accuracy_gate.py``:
on the committed chains and draws it must reproduce the committed
``data/accuracy_gate.json``.  The runs on the card are in README.md.
"""

import json
import os

import numpy as np
import pytest
import torch

from ssme_tpu_torch.examples import accuracy_gate, spy_flagship

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_flagship_on_cpu_writes_only_its_own_files(tmp_path, capsys):
    out = spy_flagship.main([
        "--device", "cpu", "--t-len", "60", "--iters", "8", "--chains", "2",
        "--particles", "64", "--burn", "4", "--chunk", "4", "--tag", "t",
        "--out-dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == [
        "torch_spy_posterior_samples_t.npy",
        "torch_spy_posterior_summary_t.json"]
    samples = np.load(tmp_path / "torch_spy_posterior_samples_t.npy")
    assert samples.shape == (8, 2, 3) and np.isfinite(samples).all()
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(tmp_path / "torch_spy_posterior_summary_t.json") as f:
        assert json.load(f) == printed
    assert printed["config"]["T"] == 60 and printed["config"]["burn"] == 4
    assert 0.0 <= out["accept_rate"] <= 1.0
    assert set(out["posterior"]) == {"beta", "phi", "ss"}


def test_flagship_restarts_adaptation_at_burn_in():
    """The warm restart at the end of burn-in zeroes the moments and the
    iteration count; the accept average then counts only later draws."""
    ys = spy_flagship.spy_returns("cpu", 40)
    _, state, _ = spy_flagship.run_flagship(ys, 6, chains=2, particles=64,
                                            burn=4, chunk=2)
    assert state.iteration == 2
    _, state, _ = spy_flagship.run_flagship(ys, 6, chains=2, particles=64,
                                            burn=5, chunk=2)
    assert state.iteration == 6             # 5 is no chunk boundary


def test_gate_reproduces_the_committed_gate():
    """The oracle chains, JAX's parity and adaptive draws: every mean and
    MC-SE of data/accuracy_gate.json to 1e-9 relative, the same verdicts."""
    out = accuracy_gate.main([
        "--device", "cpu", "--parity-npy",
        "data/spy_posterior_samples_parity.npy", "--adaptive-npy",
        "data/spy_posterior_samples_tuned.npy", "--out", os.devnull])
    with open(os.path.join(ROOT, "data", "accuracy_gate.json")) as f:
        ref = json.load(f)
    for run in ("oracle", "parity", "adaptive"):
        for key in ("mean", "mc_se"):
            np.testing.assert_allclose(out["results"][run][key],
                                       ref["results"][run][key], rtol=1e-9,
                                       atol=0)
        assert out["results"][run]["iters"] == ref["results"][run]["iters"]
    assert out["gate"]["pass"] == ref["gate"]["pass"]
    assert [c["ok"] for c in out["gate"]["comparisons"]] == [
        c["ok"] for c in ref["gate"]["comparisons"]]


def test_gate_engines_run_in_process_and_a_failed_pair_fails(tmp_path):
    out = accuracy_gate.main([
        "--device", "cpu", "--t-len", "40", "--chains", "2", "--particles",
        "64", "--parity-iters", "6", "--adaptive-iters", "6", "--ext-burn",
        "2", "--restart", "2", "--samples-dir", str(tmp_path), "--out",
        str(tmp_path / "gate.json")])
    assert sorted(os.listdir(tmp_path)) == [
        "gate.json", "gate_samples.npz", "torch_gate_adaptive.npy",
        "torch_gate_parity.npy"]
    assert out["results"]["parity"]["iters"] == 4
    assert len(out["gate"]["comparisons"]) == 9
    res = {k: {"mean": [0.8, 0.97, 0.06], "mc_se": [1e-4] * 3}
           for k in ("oracle", "parity", "adaptive")}
    assert accuracy_gate.gate(res)["pass"]
    res["adaptive"]["mean"][1] = 0.98                 # z = 70
    verdict = accuracy_gate.gate(res)
    assert not verdict["pass"]
    assert [c["ok"] for c in verdict["comparisons"]].count(False) == 2


def test_gate_runs_its_own_oracle_and_reuses_saved_draws(tmp_path):
    """``--oracle-npy`` with no file runs the port's oracle (seed 11, the
    mode start, t0 150, adapting throughout) on the gate's series and
    drops its first quarter; ``--skip-oracle`` / ``--reuse-engines`` take
    every draw back from the npz beside ``--out``."""
    from ssme_tpu_torch.oracle import oracle_pmmh

    argv = ["--device", "cpu", "--t-len", "30", "--chains", "2",
            "--particles", "32", "--replicates", "1", "--engine-iters", "6",
            "--ext-burn", "2", "--restart", "2", "--oracle-particles", "16",
            "--oracle-iters", "8", "--out", str(tmp_path / "gate.json")]
    out = accuracy_gate.main(["--oracle-npy"] + argv)
    assert sorted(os.listdir(tmp_path)) == ["gate.json", "gate_samples.npz"]
    saved = np.load(tmp_path / "gate_samples.npz")
    assert sorted(saved.files) == ["adaptive", "oracle", "oracle_secs",
                                   "parity"]
    assert saved["parity"].shape == saved["adaptive"].shape == (6, 2, 3)
    ys = spy_flagship.spy_returns("cpu", 30)
    chain = oracle_pmmh(11, ys.double(), accuracy_gate.MODE_START_Z, 8, 16,
                        1, t0=150, t1=10 ** 9, device="cpu")
    np.testing.assert_array_equal(saved["oracle"], chain[:, None, :])
    oracle = out["results"]["oracle"]
    assert (oracle["iters"], oracle["chains"], oracle["seed"]) == (8, 1, 11)
    np.testing.assert_allclose(oracle["mean"], chain[2:].mean(0), rtol=1e-12)
    assert oracle["secs"] == float(saved["oracle_secs"]) > 0
    assert out["results"]["parity"]["iters"] == 4
    assert out["gate"]["t_len"] == 30
    assert [(c["pair"], c["param"]) for c in out["gate"]["comparisons"]] == [
        (f"{a}-vs-{b}", p) for a, b in accuracy_gate.PAIRS
        for p in accuracy_gate.NAMES]
    with open(tmp_path / "gate.json") as f:     # NaN SEs at 4 draws
        assert json.dumps(json.load(f)["gate"]) == json.dumps(out["gate"])

    again = accuracy_gate.main(["--oracle-npy", "--skip-oracle",
                                "--reuse-engines"] + argv)
    for run in ("oracle", "parity", "adaptive"):
        assert again["results"][run]["mean"] == out["results"][run]["mean"]
    assert again["results"]["oracle"]["secs"] == oracle["secs"]
    assert again["results"]["parity"]["secs"] is None
    assert again["gate"]["t_len"] is None           # nothing ran here
    assert (json.dumps(again["gate"]["comparisons"])
            == json.dumps(out["gate"]["comparisons"]))


@pytest.mark.parametrize("main", [spy_flagship.main, accuracy_gate.main])
def test_clis_default_to_the_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [] if main is spy_flagship.main else ["--out", os.devnull]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
