"""`BENCHMARK.json` and the files it names, found by name under a checkout's
root: a configuration's file (its `file` entry), a traffic mix's parameters
(`seldbench/traffic/<traffic>.json`), a cell's correctness limits
(`seldbench/limits/<workload>.json`) and each per-layer metric's reader
(`seldbench/metrics/<metric>.py`, loaded from its path, a function `read(run)`).
A cell, a configuration, a mix or a metric is added by adding its files and its
entry; nothing here lists them."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _named(self, key: str, name: str) -> dict:
        for entry in self.bench[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json names no {key} entry '{name}'")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, cell: dict) -> dict:
        return json.loads((self.root / self._named("configs", cell["config"])["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.root / "seldbench" / "traffic" / f"{cell['traffic']}.json")
                          .read_text())

    def limits(self, cell: dict) -> dict:
        return json.loads((self.root / "seldbench" / "limits" / f"{cell['name']}.json")
                          .read_text())

    @staticmethod
    def _in(metric: dict, cell: dict) -> bool:
        return "workloads" not in metric or cell["name"] in metric["workloads"]

    def end_to_end(self, cell: dict) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"] if self._in(m, cell)]

    def per_layer(self, cell: dict) -> list[dict]:
        """The per-layer metrics read in this cell's traced run: those that list
        it, or that list no cells and move an end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, metric: str):
        """The metric's reader module: `read(run) -> float | None`, and where it
        reads a roofline, `NOTE`, the bound it uses."""
        path = self.root / "seldbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "seldbench_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
