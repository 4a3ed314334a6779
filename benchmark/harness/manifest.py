"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (`benchmark/configs/<config>.json`) and a
traffic mix (`benchmark/traffic/<traffic>.json`); the mix names its entry
(`benchmark/entries/<entry>.py`), the configuration its reference model
(`benchmark/reference/`); the cell's limits are
`benchmark/limits/<cell>.json`; a per-layer metric's reader is
`benchmark/layer_metrics/<metric>.py`. Adding a configuration, a mix, an
entry, a cell or a reader is adding files and entries; nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = root
        self.data = load_json(root / "BENCHMARK.json")
        self.bench = root / self.data["paths"][0]

    def cell(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: Dict) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == cell["config"]:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {cell['config']!r}")

    def traffic(self, cell: Dict) -> Dict:
        return load_json(self.bench / "traffic" / f"{cell['traffic']}.json")

    def limits(self, cell: Dict) -> Dict[str, float]:
        return load_json(self.bench / "limits" / f"{cell['name']}.json")

    def end_to_end(self, cell: Dict) -> List[Dict]:
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: Dict) -> List[Dict]:
        mine = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def entry(self, mix: Dict):
        return importlib.import_module(
            f"{__package__.rsplit('.', 1)[0]}.entries.{mix['entry']}")

    def reader(self, metric: str):
        path = self.bench / "layer_metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "layer_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
