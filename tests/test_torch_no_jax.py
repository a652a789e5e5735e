"""The port imports without JAX: the machine with the card has none."""

import os
import pkgutil
import subprocess
import sys

import torch

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
bad = sorted(m for m in sys.modules if m == "ssme_tpu"
             or m.startswith("ssme_tpu.") or m.startswith("jax."))
assert not bad, bad
print("imported", len({modules!r}) + 1)
"""


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
            "ssme_tpu_torch.examples.swarm_forecast",
            "ssme_tpu_torch.examples.liu_west_leverage",
            "ssme_tpu_torch.filters.liu_west",
            "ssme_tpu_torch.ops.liu_west_megakernel",
            "ssme_tpu_torch.ops.svol_leverage_lw_kernel",
            "ssme_tpu_torch.ops.svol_filter_kernel",
            "ssme_tpu_torch.ops.filter_megakernel",
            "ssme_tpu_torch.models.svol_leverage",
            "ssme_tpu_torch.models.svol_t",
            "ssme_tpu_torch.models.poisson_ar",
            "ssme_tpu_torch.models.factor_svol",
            "ssme_tpu_torch.models.lgssm",
            "ssme_tpu_torch.filters.auxiliary",
            "ssme_tpu_torch.inference.swarm",
            "ssme_tpu_torch.io.checkpoint"} <= set(modules)
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(root=ROOT, modules=modules)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"imported {len(modules) + 1}"
