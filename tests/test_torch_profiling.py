"""salsa_tpu_torch.utils.profiling on the CPU: stage_timer's summary is
`salsa_tpu`'s text in its order, trace writes a Chrome trace of the block, and
device_timer gives the median seconds a call (perf_counter on the CPU; CUDA
events on a card, which chip_smoke.py runs)."""
import json
import time

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from salsa_tpu.utils import profiling as jprofiling  # noqa: E402
from salsa_tpu_torch.utils import profiling  # noqa: E402


def test_stage_timer_summary_equals_salsa_tpu():
    timers = {"jax": jprofiling.stage_timer(), "port": profiling.stage_timer()}
    for t in timers.values():
        for name, seconds, calls in (("stft", 0.5, 3), ("salsa", 2.25, 1), ("io", 0.125, 7)):
            t.totals[name], t.counts[name] = seconds, calls
    text = timers["port"].summary()
    assert text == timers["jax"].summary()
    assert [line.split()[0] for line in text.splitlines()] == ["salsa", "stft", "io"]
    t = profiling.stage_timer()
    for _ in range(2):
        with t.stage("nap"):
            time.sleep(0.01)
    assert t.counts["nap"] == 2 and 0.02 <= t.totals["nap"] < 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(r.key == "aten::mm" for r in prof.key_averages())


def test_device_timer_median_seconds():
    calls = []

    def nap(x):
        calls.append(1)
        time.sleep(0.02)
        return x * 2

    s = profiling.device_timer(nap, torch.ones(3), iters=3)
    assert len(calls) == 4  # a warm-up call, then 3 timed
    assert 0.015 <= s < 0.5
