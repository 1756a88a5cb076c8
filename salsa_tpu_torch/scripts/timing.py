"""Device timing and the card check shared by the probes and `chip_smoke.py`."""
from __future__ import annotations

import statistics

import torch


def require_cuda(what: str) -> torch.device:
    """The first CUDA device; raises where there is none (no CPU fallback)."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{what}: torch.cuda.is_available() is False; this needs an "
                         "NVIDIA GPU")
    return torch.device("cuda", 0)


def cuda_ms(fn, repeats: int = 7, warmup: int = 2, calls: int = 1) -> float:
    """Median CUDA-event time of fn() in ms, after warm-up. Each repeat times
    `calls` calls back to back between its two events and counts the mean: with
    one call, the card waits on the host's launch of fn() inside the events; with
    several, the host queues each call while the card runs the one before."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)
