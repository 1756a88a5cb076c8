"""Device timing, the card check and the variant specs shared by the probes, the
benches and `chip_smoke.py`."""
from __future__ import annotations

import statistics
import subprocess

import torch


def smi(query: str = "name,power.limit,clocks.sm") -> str:
    """What nvidia-smi says of the card: by default its name, power limit and SM
    clock."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def parse_variant(spec: str, prefix: str) -> tuple[str, list[str]]:
    """'NAME=MACRO=VALUE[,MACRO=VALUE]' -> (NAME, the -D defines of that build);
    every macro must start with `prefix`, the kernel's own."""
    name, _, macros = spec.partition("=")
    defines = [f"-D{m}" for m in macros.split(",") if m]
    if not name or not defines or any(not m.startswith(prefix) or "=" not in m
                                      for m in macros.split(",")):
        raise ValueError(f"--variant wants NAME={prefix}MACRO=VALUE[,...], got {spec!r}")
    return name, defines


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
