"""`BENCHMARK.json` and the files it names, found by name.

A configuration is `benchmark/configs/<name>.json` (the `file` of its
entry), a traffic mix `benchmark/traffic/<mix>.json`, a metric's reader
`benchmark/metrics/<metric>.py` and a cell's limits
`benchmark/limits/<cell>.json`. A new configuration, mix, metric or cell
is a new file and a new entry: no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    def __init__(self, root: str):
        self.root = root
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> Dict:
        return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> Dict:
        return load_json(os.path.join(BENCH_DIR, "limits", f"{cell}.json"))

    def metrics(self, cell: str, trace: bool) -> List[Dict]:
        """The cell's end-to-end metrics (trace off) or per-layer metrics
        (trace on): those that list the cell, and those with no list that
        move, or are, an end-to-end metric the cell reports."""
        e2e = [m for m in self.bench["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if ((cell in m["workloads"]) if "workloads" in m else (m["moves"] in names))]


def reader(metric: str):
    """The `read(ctx)` function of `benchmark/metrics/<metric>.py`."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
