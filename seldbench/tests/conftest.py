"""The benchmark's tests: `python -m pytest seldbench/tests`. Tests marked `card`
need an NVIDIA card and skip without one (decided inside each test).

`tiny_root` is a copy of the benchmark under a temporary root whose cells are
cut to sizes a CPU runs in seconds: serving 2 requests of 2 clips x 1 s, training
3 clips x 10 s in batches of 4 chunks of 1.6 s. Widths stay as published."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


def shrink(root: Path) -> Path:
    for path in (root / "seldbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["data"]["train_chunk_len_s"] = 1.6
        cfg["training"]["train_batch_size"] = 4
        path.write_text(json.dumps(cfg))
    for name, cut in (("serve", {"pool": 2, "clips": 2, "clip_seconds": 1.0}),
                      ("train", {"clips": 3, "clip_seconds": 10.0})):
        path = root / "seldbench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **cut}))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    shutil.copytree(REPO / "seldbench", tmp_path / "seldbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    return shrink(tmp_path)
