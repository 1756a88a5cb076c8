"""SALSA-FOA extraction throughput of the port on one CUDA card: `bench.py`'s
workload through `features.salsa.extract_salsa`.

    python -m salsa_tpu_torch.scripts.bench_extract

64 clips x 60 s x 4 channels, seeded as `bench.py` seeds them (about 1.5 GB of
samples and 1.7 GB of features on the card), fs 24 kHz, n_fft 512, hop 300,
fmax_doa 9000, FOA. One warm-up call, then 5 timed calls, each ending in the
checksum `float(feats.sum())` after `torch.cuda.synchronize()`, on the host clock.
Prints one JSON line with `bench.py`'s keys (`metric`, `value`, `unit`,
`vs_baseline` against the reference CPU extractor's 6.45x realtime) and `card`,
the card's name and power limit. Needs a CUDA card: there is no CPU fallback.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from salsa_tpu_torch.features.salsa import SalsaParams, extract_salsa
from salsa_tpu_torch.scripts.timing import require_cuda, smi

BASELINE_XRT = 6.45  # reference SALSA extraction, 9.3 s per 60 s clip (CPU)
FS = 24000
PARAMS = SalsaParams(fs=FS, n_fft=512, hop_length=300, fmax_doa=9000.0, audio_format="foa")
BATCH, CLIP_SECONDS, ITERS = 64, 60.0, 5  # bench.py's workload


def make_waves(batch: int = BATCH, clip_seconds: float = CLIP_SECONDS) -> np.ndarray:
    """bench.py's input: seeded noise plus a 440 Hz tone, (batch, 4, n) float32."""
    n_samples = int(FS * clip_seconds)
    rng = np.random.default_rng(0)
    t = np.arange(n_samples) / FS
    waves = 0.05 * rng.standard_normal((batch, 4, n_samples)).astype(np.float32)
    waves += 0.3 * np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    return waves


def extract_checksum(waves: torch.Tensor) -> float:
    """The sum of the SALSA features of `waves`, fetched to the host."""
    feats = extract_salsa(waves, PARAMS)
    if feats.is_cuda:
        torch.cuda.synchronize()
    return float(feats.sum())


def main() -> dict:
    dev = require_cuda("bench_extract")
    x = torch.from_numpy(make_waves()).to(dev)
    checksum = extract_checksum(x)  # warm up
    if not np.isfinite(checksum):
        raise AssertionError(f"non-finite checksum {checksum}")
    t0 = time.perf_counter()
    for _ in range(ITERS):
        s = extract_checksum(x)
    dt = time.perf_counter() - t0
    if abs(s - checksum) > 1e-6 * abs(checksum):
        raise AssertionError(f"checksum moved between calls: {checksum} then {s}")
    xrt = CLIP_SECONDS * BATCH * ITERS / dt
    out = {
        "metric": "salsa_foa_extraction_throughput",
        "value": round(xrt, 1),
        "unit": "x_realtime_per_chip",
        "vs_baseline": round(xrt / BASELINE_XRT, 1),
        "card": smi("name,power.limit"),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
