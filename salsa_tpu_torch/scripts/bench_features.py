"""Extraction throughput of every feature type of the port on one CUDA card: the
counterpart of `scripts/bench_features.py`.

    python -m salsa_tpu_torch.scripts.bench_features [--batch 8] [--seconds 60] [--iters 5]

The same 9 cases (SALSA FOA and MIC through K1 and K2, and the frame-local types)
on the same input: seeded noise plus a 440 Hz tone, (batch, 4, seconds * 24 kHz)
float32 on the card, fs 24 kHz, n_fft 512, hop 300, each type's defaults. One
warm-up call, then `iters` calls, each ending in the checksum `float(feats.sum())`,
on the host clock. Prints one JSON line per case with `ms_per_clip`, `x_realtime`
and `card`, the card's name and power limit. Needs a CUDA card: there is no CPU
fallback.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from salsa_tpu_torch.features.registry import make_extractor
from salsa_tpu_torch.scripts.bench_extract import make_waves
from salsa_tpu_torch.scripts.timing import require_cuda, smi

FS = 24000
CASES = (
    ("salsa", "foa"),
    ("salsa", "mic"),
    ("salsa_lite", "mic"),
    ("salsa_ipd", "mic"),
    ("linspeciv", "foa"),
    ("melspeciv", "foa"),
    ("linspecgcc", "mic"),
    ("melspecgcc", "mic"),
    ("melspec", "foa"),
)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--only", default=None, help="one feature type")
    args = ap.parse_args(argv)
    dev = require_cuda("bench_features")
    card = smi("name,power.limit")
    x = torch.from_numpy(make_waves(args.batch, args.seconds)).to(dev)
    out = []
    for ft, fmt in CASES:
        if args.only and ft != args.only:
            continue
        ex = make_extractor(ft, fmt, fs=FS, n_fft=512, hop_length=300)

        def checksum() -> float:
            feats = ex(x)
            torch.cuda.synchronize()
            return float(feats.sum())

        first = checksum()  # warm up
        if not np.isfinite(first):
            raise AssertionError(f"{ft} {fmt}: non-finite checksum {first}")
        t0 = time.perf_counter()
        for _ in range(args.iters):
            checksum()
        dt = time.perf_counter() - t0
        row = {"feature": ft, "format": fmt,
               "ms_per_clip": round(dt / (args.iters * args.batch) * 1e3, 4),
               "x_realtime": round(args.seconds * args.batch * args.iters / dt, 1),
               "card": card}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
