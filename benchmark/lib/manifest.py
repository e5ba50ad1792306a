"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric is a file of its own under the benchmark's folder:

* ``configs/<config>.json`` (the path the manifest's ``file`` gives);
* ``traffic/<traffic>.json``: the driver's name and its parameters;
* ``drivers/<driver>.py``: a ``Driver`` class, one per kind of entry the
  window drives;
* ``layer_metrics/<metric>.py``: ``read(summary)``, one per per-layer
  metric, returning a number or None where it finds nothing to read.

A later cell or metric is added by adding files and entries; no file here
names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = "benchmark"


class Manifest:
    """``BENCHMARK.json`` of the checkout rooted at ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = self.root / BENCH_DIR
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def driver(self, name: str):
        return _load(self.bench / "drivers" / f"{name}.py").Driver

    def metrics(self, kind: str, cell: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` metrics cell ``cell``
        reports."""
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable:
        return _load(self.bench / "layer_metrics" / f"{metric}.py").read


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
