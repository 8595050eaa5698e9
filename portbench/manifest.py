"""Find a cell's pieces by name: ``BENCHMARK.json`` at the root of the
checkout names the cells, and each cell's configuration, traffic mix and
metrics live in files of their own under this folder:

    portbench/configs/<config>.json    model and deployment
    portbench/traffic/<traffic>.json   parameters of the general generator
    portbench/metrics/<metric>.py      a reader: ``read(record) -> float | None``

A later change adds a model, a mix or a metric by adding such files and
entries in ``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    """``BENCHMARK.json`` and the files it names, read from ``root``."""

    def __init__(self, root: Path = ROOT, bench_dir: Optional[Path] = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir is not None else HERE
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, kind: str) -> List[dict]:
        """The ``kind`` ("end_to_end" or "per_layer") metrics that ``cell``
        reports: those that list it, and those with no list. A per-layer
        metric with no list is reported wherever the end-to-end metric it
        moves is."""
        e2e = {m["name"] for m in self.metrics_e2e(cell)}
        out = []
        for m in self.spec[kind]:
            cells = m.get("workloads")
            if cells is not None:
                if cell in cells:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def metrics_e2e(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if m.get("workloads") is None or cell in m["workloads"]]

    def reader(self, metric: str) -> ModuleType:
        """The module of one metric's reader, loaded from its file."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + re.sub(r"\W", "_", metric), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
