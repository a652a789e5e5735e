"""Find a cell's pieces by the names in ``BENCHMARK.json``.

A cell names a configuration (``benchmark/configs/<config>.json``) and a
traffic mix (``benchmark/traffic/<traffic>.json``); the traffic names its
driver (``benchmark/drivers/<driver>.py``); each per-layer metric is a
reader of its own (``benchmark/metrics/<metric>.py``).  Adding a cell is
adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """Import the Python file ``path`` as module ``name``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def driver_path(self):
        return os.path.join(BENCH_DIR, "drivers",
                            self.traffic["driver"] + ".py")

    def driver(self):
        return load_module(self.driver_path,
                           "bench_driver_" + self.traffic["driver"])

    def metric_path(self, name):
        return os.path.join(BENCH_DIR, "metrics", name + ".py")

    def metric(self, name):
        return load_module(self.metric_path(name),
                           "bench_metric_" + name.replace(".", "_"))

    def series(self, device):
        """The configuration's observations (T,), float32 on ``device``."""
        import numpy as np
        import torch

        ys = np.loadtxt(self.data_path(self.config["data"]),
                        dtype=np.float64)
        return torch.as_tensor(ys, dtype=torch.float32).to(device)

    def data_path(self, rel):
        """A data file named relative to the checkout's root."""
        return os.path.join(ROOT, rel)


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name, manifest_path=None) -> Cell:
    manifest = _load_json(manifest_path or os.path.join(ROOT,
                                                        "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    config = _load_json(os.path.join(BENCH_DIR, "configs",
                                     w["config"] + ".json"))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic",
                                      w["traffic"] + ".json"))
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)])
