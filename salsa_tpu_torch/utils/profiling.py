"""Profiling utilities (counterpart of `salsa_tpu.utils.profiling`).

* `stage_timer`: named wall-clock stages with a summary table, `salsa_tpu`'s
  text and order (largest total first).
* `trace`: a context manager around `torch.profiler` recording the CPU and,
  where there is a card, CUDA activity, written as a Chrome trace
  (`trace.json`, for chrome://tracing or Perfetto) into `log_dir`.
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


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU activity, and CUDA activity where
    a card is present) and write its Chrome trace to `<log_dir>/trace.json`; yields
    the profiler (its `key_averages()` give the table)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
