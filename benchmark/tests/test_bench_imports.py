"""What a run imports: never JAX nor the JAX package (compared by whole
top-level module names), and the plain reference nothing of the program.
CPU only."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    MANIFEST = json.load(_f)


def _run_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_run", os.path.join(BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("names, want", [
    (["ssme_tpu_torch", "ssme_tpu_torch.ops", "torch"], []),
    (["ssme_tpu.ops"], ["ssme_tpu"]),
    (["jax._src.core", "numpy"], ["jax"]),
    (["jaxlib"], ["jaxlib"]),
    (["jaxtyping", "flaxen", "flax.linen"], ["flax"]),
])
def test_forbidden_names_are_whole_top_level_names(names, want):
    assert _run_module().forbidden_modules(names) == want


def _imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    BENCH, "reference", "*.py"))), ids=os.path.basename)
def test_reference_sources_import_nothing_of_the_program(path):
    assert not _imports(path) & {"ssme_tpu_torch", "ssme_tpu", "jax",
                                 "jaxlib", "flax"}


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_no_benchmark_source_imports_jax(path):
    assert not _imports(path) & {"ssme_tpu", "jax", "jaxlib", "flax"}


_SNIPPET = r"""
import sys, time, json
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from benchmark.reference import filters, liu_west, pmmh
assert "ssme_tpu_torch" not in sys.modules, "the reference imported the program"
from test_bench_faults import _small, _run
for name in ("svol.pmmh_parity", "svol_leverage.lw_apf"):
    run = _run(_small(name), torch.device("cpu"), seconds=0.2)
import importlib.util
spec = importlib.util.spec_from_file_location("bench_run", {run!r})
mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)
print(json.dumps(mod.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    """The drivers, the program they drive and the reference, in a fresh
    process (the check the harness makes after every window)."""
    code = _SNIPPET.format(root=ROOT, tests=os.path.join(BENCH, "tests"),
                           run=os.path.join(BENCH, "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_harness_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "svol.pmmh_parity", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


_STUBBED_RUN = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {stubs!r})
import importlib.util
import torch
spec = importlib.util.spec_from_file_location("bench_run", {run!r})
run_mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run_mod)
from benchmark.lib import cell as cell_lib
from benchmark.lib.trace import Trace
from benchmark.lib.window import Run

# past the look for a card: a driver and metric readers of the test's own
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.set_device = lambda device: None
torch.cuda.get_device_name = lambda index=0: "stub"


class Driver:
    @staticmethod
    def run(cell, seed, seconds, trace, t_process, device, limits):
        return Run(setup_s=1.0, window_s=1.0, iterations=4, props=4.0,
                   intervals_ms=[1.0] * 4, checks=[], attempted=4, failed=0,
                   memory_peak_bytes=0, layer_span="stub", layer={{}},
                   launch_shape={{}}, trace=Trace(window=(0, 10 ** 9)))


class Metric:
    @staticmethod
    def read(run):
        if {load_jax!r}:
            import jax  # noqa: F401  (the stub module beside the test)
        return 1.0


cell_lib.Cell.driver = lambda self: Driver
cell_lib.Cell.metric = lambda self, name: Metric
sys.exit(run_mod.main(["--workload", "svol.pmmh_parity", "--seed",
                       "3000000001", "--seconds", "1", "--trace", "1"]))
"""


@pytest.mark.parametrize("load_jax", [False, True])
def test_a_reader_that_loads_jax_leaves_no_result(tmp_path, load_jax):
    """A per-layer metric's reader runs after the window; a module named
    ``jax`` that it loads still keeps the harness from printing a
    result.  The reader that loads nothing gets its result printed."""
    (tmp_path / "jax.py").write_text("")
    code = _STUBBED_RUN.format(root=ROOT, stubs=str(tmp_path),
                               run=os.path.join(BENCH, "run.py"),
                               load_jax=load_jax)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    if load_jax:
        assert out.returncode == 3, out.stderr[-3000:]
        assert out.stdout.strip() == ""
        assert "jax" in out.stderr.splitlines()[-1]
    else:
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert set(result["metrics"]) == {
            m["name"] for m in MANIFEST["per_layer"]
            if "svol.pmmh_parity" in m.get("workloads", ["svol.pmmh_parity"])}
