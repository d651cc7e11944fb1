"""Where the harness finds a cell's pieces, by the names in
``BENCHMARK.json``: the configuration's file, ``traffic/<traffic>.json``
(whose ``driver`` names a module of ``drivers/``), ``limits/<cell>.json``
and each per-layer metric's reader ``metrics/<metric>.py``.  A later cell,
configuration, mix or metric is new files and new entries; no file here
changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, name: str, root: str = ROOT, bench_dir: str = BENCH_DIR):
        manifest = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = load_json(os.path.join(root, configs[self.entry["config"]]["file"]))
        self.traffic = load_json(os.path.join(bench_dir, "traffic",
                                              self.entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(bench_dir, "limits", name + ".json"))
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"] if name in m.get("workloads", [name])]
        self.bench_dir = bench_dir

    def driver_class(self):
        return importlib.import_module(f"port_bench.drivers.{self.traffic['driver']}").Driver

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``metrics/<metric>.py``."""
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


FORBIDDEN = ("jax", "jaxlib", "flax", "pointcloud_segmentation_attention_tpu")


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: the port's own name begins with the JAX
    package's and is not one of them."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})
