"""BENCHMARK.json against the benchmark's contract, and every cell's
pieces found by name.  CPU only; run with ``python -m pytest
benchmark/tests``."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    MANIFEST = json.load(_f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    assert len(MANIFEST["command"]) <= 32
    assert all(_line(w) for w in MANIFEST["command"])
    for p in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    # the command names files under paths only
    files = [w for w in MANIFEST["command"] if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in
                             MANIFEST["paths"]) for f in files)


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_use_allowed_characters(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])


def test_names_are_unique():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in MANIFEST["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in {"host_clock", "device_trace"}
        assert 0 < metric["bound"] <= 0.25
        assert metric["bound"] >= 0.01
    else:
        allowed |= {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
        assert _line(metric["layer"])
    assert set(metric) <= allowed
    assert metric["better"] in {"lower", "higher"}
    assert metric["source"] in SOURCES
    for w in metric.get("workloads", []):
        assert w in CELLS
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_setup_bound():
    setup = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_pieces_are_found_by_name(cell):
    from benchmark.lib.cell import load_cell

    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    c = load_cell(cell["name"])
    assert os.path.isfile(c.driver_path)
    assert os.path.isfile(os.path.join(BENCH, "limits",
                                       cell["name"] + ".json"))
    for m in c.per_layer:
        assert os.path.isfile(c.metric_path(m["name"]))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    assert c.config["paths"]
    assert os.path.isfile(c.data_path(c.config["data"]))


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_entries(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert any(config["file"].startswith(p + "/") for p in MANIFEST["paths"])
    assert os.path.isfile(os.path.join(ROOT, config["file"]))
    with open(os.path.join(ROOT, config["file"])) as f:
        body = json.load(f)
    assert set(config["reduced"]) == set(body["reduced"])
    assert any(w["config"] == config["name"] for w in MANIFEST["workloads"])


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


# chip_smoke.py at commit 979befa: NORMAL_OPS = 56 and STEP_OPS
FROZEN_STEP_OPS = {
    "svol_filter_kernel": 56 + 2 + 6 + 8,
    "filter_megakernel": 56 + 12 + 6 + 8,
    "svol_leverage_lw_kernel": 5 * 56 + 36 + 8 + 28 + 12 + 18 + 20 + 20
                               + 14 + 8 + 15,
}


@pytest.mark.parametrize("layer", sorted(FROZEN_STEP_OPS))
def test_frozen_counts_match_chip_smoke_at_979befa(layer):
    counts = {}
    for config in MANIFEST["configs"]:
        with open(os.path.join(ROOT, config["file"])) as f:
            counts.update(json.load(f)["paths"])
    assert counts[layer]["ops_per_prop"] == FROZEN_STEP_OPS[layer]


def test_roofline_bounds_match_the_recorded_ones():
    """The bounds PERF.md records (chip_smoke's kernels line): 0.4344 ms
    for K1 at B=256, 0.2474 for K2 leverage at B=128, 0.6923 for K3 at
    F=64, all N=512, T=3084."""
    from benchmark.lib.roofline import launch_bound_s

    counts = {}
    for config in MANIFEST["configs"]:
        with open(os.path.join(ROOT, config["file"])) as f:
            counts.update(json.load(f)["paths"])
    for layer, b, want in (("svol_filter_kernel", 256, 0.4344),
                           ("filter_megakernel", 128, 0.2474),
                           ("svol_leverage_lw_kernel", 64, 0.6923)):
        got = 1e3 * launch_bound_s(counts[layer], dict(B=b, N=512, T=3084))
        assert abs(got - want) < 1e-4, (layer, got)
