"""salsa_tpu_torch.utils.profiling on the CPU: trace writes a Chrome trace of the
block, and device_timer gives the median seconds a call (perf_counter on the
CPU; CUDA events on a card, which chip_smoke.py runs). The spans are
`test_torch_spans.py`'s."""
import json
import logging
import time

import pytest

torch = pytest.importorskip("torch")

from salsa_tpu_torch.utils import profiling  # noqa: E402


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


class _Records(logging.Handler):
    """The records of the port's logger, which may not propagate to the root's
    (`configure_logging`, run by other tests in this process, sets its handlers)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_trace_warns_when_no_device_event_comes_back(tmp_path, monkeypatch):
    """A card reported on a build with none (`is_available` stubbed, and the
    profiler's closing synchronize with it): `trace` asks for CUDA activity and
    the profiler hands back no device event, as CUPTI can on a card. `trace` says
    so in the log and on the profiler (`device_events` 0), and still writes the
    host's rows; without a card, `device_events` is None and nothing is said."""
    records = _Records()
    logger = logging.getLogger("salsa_tpu_torch")
    logger.addHandler(records)
    try:
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: True)
            m.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
            with profiling.trace(str(tmp_path / "asked")) as prof:
                torch.ones(32, 32) @ torch.ones(32, 32)
        assert prof.device_events == 0
        assert any("no device event came back" in m for m in records.messages)
        with open(tmp_path / "asked" / "trace.json") as f:
            assert any(e.get("name") == "aten::mm" for e in json.load(f)["traceEvents"])
        records.messages.clear()
        with profiling.trace(str(tmp_path / "cpu")) as prof:
            torch.ones(4) * 2
        assert prof.device_events is None and not records.messages
    finally:
        logger.removeHandler(records)
