"""Everything of a cell is found by name from ``BENCHMARK.json``:

* ``benchmark/workloads/<cell>.json`` — the cell's streams and engine;
* the configuration's ``file`` (JSON) and its maker beside it (same path,
  ``.py``);
* ``benchmark/traffic/<mix>.json`` — the mix's parameters;
* ``benchmark/metrics/<metric>.py`` — one reader a metric, end-to-end and
  per-layer alike, each with ``read(ctx)`` returning a number or None.

A later cell, configuration, mix or metric is new files and new entries in
``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Any, Dict, List


def _load_module(path: str, prefix: str) -> Any:
    name = prefix + re.sub(r"[^0-9A-Za-z_]", "_", os.path.basename(path)[:-3])
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    def __init__(self, root: str) -> None:
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        self.dir = os.path.join(root, "benchmark")

    def _entry(self, key: str, name: str) -> dict:
        for e in self.bench[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        entry = self._entry("workloads", name)
        with open(os.path.join(self.dir, "workloads", name + ".json")) as f:
            spec = json.load(f)
        return {**spec, **entry}

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        with open(os.path.join(self.root, entry["file"])) as f:
            return json.load(f)

    def maker(self, name: str) -> Any:
        entry = self._entry("configs", name)
        return _load_module(os.path.join(self.root, entry["file"][:-5] + ".py"),
                            "benchmark_config_")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.dir, "traffic", name + ".json")) as f:
            return json.load(f)

    def metrics(self, cell: str, per_layer: bool) -> List[dict]:
        """The cell's metrics of one kind, in BENCHMARK.json's order."""
        entries = self.bench["per_layer" if per_layer else "end_to_end"]
        return [m for m in entries if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Any:
        return _load_module(os.path.join(self.dir, "metrics", metric + ".py"),
                            "benchmark_metric_")


def read_metrics(manifest: Manifest, cell: str, per_layer: bool,
                 ctx: Dict[str, Any]) -> Dict[str, dict]:
    """Each metric's reader on ``ctx``; a reader that finds nothing to read
    returns None and its metric is left out."""
    out: Dict[str, dict] = {}
    for m in manifest.metrics(cell, per_layer):
        value = manifest.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
