"""Profiling utilities (counterpart of `salsa_tpu.utils.profiling`).

* `stage_timer`: named wall-clock stages with a summary table, `salsa_tpu`'s
  text and order (largest total first).
* `trace`: a context manager around `torch.profiler` recording the CPU and,
  where there is a card, CUDA activity, written as a Chrome trace
  (`trace.json`, for chrome://tracing or Perfetto) into `log_dir`; it counts the
  device events that came back and warns where CUDA was asked for and none did.
* `device_timer`: median seconds per call of a function; on a card between CUDA
  events after a warm-up call, on the CPU by `time.perf_counter`.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict

import torch

from salsa_tpu_torch.utils.experiments import logger


class stage_timer:
    """Accumulates wall-clock seconds per named stage.

    with timers.stage('stft'): ...
    timers.summary()
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [
            f"{name:24s} {self.totals[name]:9.3f}s  ({self.counts[name]} calls)"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        text = "\n".join(lines)
        logger.info("stage timings:\n%s", text)
        return text


def device_event_count(prof) -> int:
    """The device (CUDA) events a finished `torch.profiler.profile` recorded."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU activity, and CUDA activity where
    a card is present) and write its Chrome trace to `<log_dir>/trace.json`; yields
    the profiler (its `key_averages()` give the table). After the block the
    profiler's `device_events` is the number of device events that came back (None
    without a card). CUPTI can hand a session no device activity at all; the trace
    then holds the host's rows only, and a warning says so."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield prof
    prof.device_events = device_event_count(prof) if cuda else None
    if cuda and not prof.device_events:
        logger.warning("profiling.trace: CUDA activity was asked for and no device event "
                       "came back; %s holds the host's rows only", path)
    prof.export_chrome_trace(path)


def _synchronize(device: torch.device | None) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _first_device(out) -> torch.device | None:
    """The device of the first tensor in `out` (a tensor or a nest of them)."""
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, (list, tuple)):
        for o in out:
            d = _first_device(o)
            if d is not None:
                return d
    if isinstance(out, dict):
        return _first_device(list(out.values()))
    return None


def device_timer(fn, *args, iters: int = 5) -> float:
    """Median seconds per call of fn(*args), after one warm-up call: on a card
    (fn's first output tensor on CUDA) each call timed between CUDA events on the
    current stream, on the CPU by perf_counter."""
    dev = _first_device(fn(*args))  # warm-up: builds and caches what fn needs
    _synchronize(dev)
    times = []
    for _ in range(iters):
        if dev is not None and dev.type == "cuda":
            with torch.cuda.device(dev):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return float(statistics.median(times))
