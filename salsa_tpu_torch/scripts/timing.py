"""Device timing, the card check and the variant specs shared by the probes, the
benches and `chip_smoke.py`."""
from __future__ import annotations

import statistics
import subprocess
import time

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


def script_device(what: str, cpu: bool) -> torch.device:
    """The device a measurement script runs on: the first CUDA card, or the CPU
    where the caller passes `--cpu` (a check of the script, never a device
    measurement)."""
    return torch.device("cpu") if cpu else require_cuda(what)


def device_ms(fn, dev: torch.device, calls: int = 10, repeats: int = 1,
              warmup: int = 1) -> tuple[float, str]:
    """Mean ms a call of fn() over `calls` calls back to back, the median of
    `repeats` such spans, after `warmup` calls; and the method's name. On a card
    between CUDA events (`cuda_ms`); on the CPU by perf_counter."""
    if dev.type == "cuda":
        return (cuda_ms(fn, repeats=repeats, warmup=warmup, calls=calls),
                f"CUDA events around {calls} calls back to back, median of {repeats}")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    return (statistics.median(times),
            f"host clock on the CPU around {calls} calls back to back, median of {repeats}")


def card_name(dev: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or 'cpu'."""
    return smi("name,power.limit") if dev.type == "cuda" else "cpu"
