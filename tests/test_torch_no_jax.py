"""The port imports without JAX: the machine with the card has none."""

import os
import pkgutil
import sys

import torch
from _bounded import run_bounded

import ssme_tpu_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import importlib, sys
sys.modules["jax"] = None          # any "import jax" now raises
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
import chip_smoke
import importlib.util
for path in {scripts!r}:
    spec = importlib.util.spec_from_file_location("script", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m == "ssme_tpu"
             or m.startswith("ssme_tpu.") or m.startswith("jax."))
assert not bad, bad
print("imported", len({modules!r}) + 1 + len({scripts!r}))
"""
# the port's own scripts (the JAX yardstick scripts import JAX by design),
# the rank programs that the parallel tests' spawned processes import, and
# the benchmark's factor-SVOL references, drivers and data scripts
SCRIPTS = [os.path.join(ROOT, "scripts", name)
           for name in ("k3_roll_fullsize.py", "kernel_timing.py",
                        "roll_sweeps.py", "k5_timing.py",
                        "torch_oracle_chains.py")] + [
    os.path.join(ROOT, "tests", "torch_parallel_ranks.py")] + [
    os.path.join(ROOT, "benchmark", *parts)
    for parts in (("reference", "factor_svol.py"),
                  ("drivers", "pmmh_k2.py"),
                  ("data", "make_factor_svol_5.py"),
                  ("reference", "factor_svol_sv.py"),
                  ("drivers", "pmmh_k2_sv.py"),
                  ("data", "make_factor_svol_sv_10.py"))]


def _port_modules():
    names = [ssme_tpu_torch.__name__]
    for info in pkgutil.walk_packages(ssme_tpu_torch.__path__,
                                      prefix="ssme_tpu_torch."):
        names.append(info.name)
    return names


def test_port_and_chip_smoke_import_without_jax():
    modules = _port_modules()
    assert {"ssme_tpu_torch.bench",
            "ssme_tpu_torch.examples.estimate_univ_svol",
            "ssme_tpu_torch.examples.estimate_svol_leverage",
            "ssme_tpu_torch.examples.estimate_factor_svol",
            "ssme_tpu_torch.examples.swarm_forecast",
            "ssme_tpu_torch.examples.liu_west_leverage",
            "ssme_tpu_torch.examples.spy_flagship",
            "ssme_tpu_torch.examples.accuracy_gate",
            "ssme_tpu_torch.examples.tune_variance",
            "ssme_tpu_torch.examples.tune_pmmh",
            "ssme_tpu_torch.profiling",
            "ssme_tpu_torch.oracle",
            "ssme_tpu_torch.filters.smoothing",
            "ssme_tpu_torch.filters.liu_west",
            "ssme_tpu_torch.ops.liu_west_megakernel",
            "ssme_tpu_torch.ops.svol_leverage_lw_kernel",
            "ssme_tpu_torch.ops.svol_filter_kernel",
            "ssme_tpu_torch.ops.svol_kernel",
            "ssme_tpu_torch.ops._select",
            "ssme_tpu_torch.ops._prng",
            "ssme_tpu_torch.ops.filter_megakernel",
            "ssme_tpu_torch.models.svol_leverage",
            "ssme_tpu_torch.models.svol_t",
            "ssme_tpu_torch.models.poisson_ar",
            "ssme_tpu_torch.models.factor_svol",
            "ssme_tpu_torch.models.lgssm",
            "ssme_tpu_torch.filters.auxiliary",
            "ssme_tpu_torch.inference.swarm",
            "ssme_tpu_torch.io.checkpoint",
            "ssme_tpu_torch.parallel",
            "ssme_tpu_torch.parallel.distributed",
            "ssme_tpu_torch.parallel.mesh",
            "ssme_tpu_torch.parallel.kernel_sharded",
            "ssme_tpu_torch.parallel.sharded_pf",
            "ssme_tpu_torch.parallel.sharded_lw",
            "ssme_tpu_torch.examples.dryrun_multichip",
            "ssme_tpu_torch.examples.dryrun_multihost"} <= set(modules)
    out = run_bounded(
        [sys.executable, "-c", _SCRIPT.format(root=ROOT, modules=modules,
                                               scripts=SCRIPTS)],
        timeout=30, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == \
        f"imported {len(modules) + 1 + len(SCRIPTS)}"


_PACKAGE_SCRIPT = """
import sys
sys.modules["jax"] = None          # any "import jax" now raises
sys.path.insert(0, {root!r})
import ssme_tpu_torch
from ssme_tpu_torch import native
from ssme_tpu_torch.ops import _cuda
names = {names!r}
assert all(n in ssme_tpu_torch.__all__ for n in names), ssme_tpu_torch.__all__
missing = [n for n in names if not hasattr(ssme_tpu_torch, n)]
assert not missing, missing
assert ssme_tpu_torch.transforms.ParamPack
assert ssme_tpu_torch.filters.fixed_lag_smoother
assert ssme_tpu_torch.profiling.PhaseTimer
assert ssme_tpu_torch.parallel.sharded_pmmh
# no process group formed by the import
import torch.distributed as dist
assert not dist.is_initialized()
# nothing built or loaded by the import
assert _cuda._lib is None and not _cuda.build_info, _cuda.build_info
assert native._lib is None and not native._build_attempted
assert not any(m == "jax" or m.startswith(("jax.", "ssme_tpu."))
               or m == "ssme_tpu" for m in sys.modules if sys.modules[m])
import torch
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
print("ok")
"""


def test_package_import_exposes_its_subpackages_and_builds_nothing():
    names = ["transforms", "rv", "resampling", "utils", "models", "filters",
             "inference", "io", "native", "diagnostics", "profiling",
             "parallel"]
    out = run_bounded(
        [sys.executable, "-c", _PACKAGE_SCRIPT.format(root=ROOT,
                                                      names=names)],
        timeout=30, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
