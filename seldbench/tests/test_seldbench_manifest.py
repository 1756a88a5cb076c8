"""The harness finds every cell's configuration, mix, limits, driver and metric
readers by name, and a new configuration, mix, metric and cell come in as files
and entries alone."""
from __future__ import annotations

import importlib
import json
import shutil

import torch

from seldbench import run
from seldbench.manifest import Manifest
from seldbench.tests.conftest import REPO


def test_every_cell_finds_its_files():
    m = Manifest(REPO)
    assert m.bench["workloads"]
    for cell in m.bench["workloads"]:
        cfg, mix, limits = m.config(cell), m.traffic(cell), m.limits(cell)
        assert cfg["feature_type"] and limits
        assert hasattr(importlib.import_module(f"seldbench.drivers.{mix['kind']}"), "Cell")
        e2e = {x["name"] for x in m.end_to_end(cell)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell["name"]
        layers = m.per_layer(cell)
        assert layers, cell["name"]
        for metric in layers:
            assert callable(m.reader(metric["name"]).read)
            assert metric["moves"] in e2e


def test_a_new_config_mix_metric_and_cell_are_files_and_entries(tiny_root):
    seld = tiny_root / "seldbench"
    shutil.copy(seld / "configs" / "salsa_foa.json", seld / "configs" / "salsa_foa_b.json")
    mix = json.loads((seld / "traffic" / "serve.json").read_text())
    (seld / "traffic" / "serve_b.json").write_text(json.dumps({**mix, "pool": 1}))
    (seld / "metrics" / "requests.serve_b.py").write_text(
        "def read(run):\n    return float(len(run.units))\n")
    shutil.copy(seld / "limits" / "salsa_foa.serve.json",
                seld / "limits" / "salsa_foa_b.serve_b.json")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "salsa_foa_b",
                             "file": "seldbench/configs/salsa_foa_b.json"})
    bench["workloads"].append({"name": "salsa_foa_b.serve_b", "config": "salsa_foa_b",
                               "traffic": "serve_b", "chips": 1, "why": "a test"})
    for e in bench["end_to_end"]:
        if "workloads" in e and "salsa_foa.serve" in e["workloads"]:
            e["workloads"].append("salsa_foa_b.serve_b")
    bench["per_layer"].append({"name": "requests.serve_b", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "pipeline", "moves": "serve_audio_s_per_s",
                               "workloads": ["salsa_foa_b.serve_b"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    m = Manifest(tiny_root)
    cell = m.workload("salsa_foa_b.serve_b")
    assert m.traffic(cell)["pool"] == 1
    assert [x["name"] for x in m.per_layer(cell)][-1] == "requests.serve_b"
    assert m.reader("requests.serve_b").read(type("R", (), {"units": [1, 2]})) == 2.0
    result = run.run_cell(m, "salsa_foa_b.serve_b", 2**33 + 1, 0.1, False, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"serve_audio_s_per_s", "serve_p95_ms", "setup_s"}
    assert list(result)[-1] == "checks"
