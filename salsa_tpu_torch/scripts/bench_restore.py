"""Restore time of an `.orbax` checkpoint against flax msgpack of the same state,
on the host clock.

    python -m salsa_tpu_torch.scripts.bench_restore <checkpoint.orbax> [--repeats 5]

Reads the checkpoint once through the port's reader (OCDBT store, zarr arrays,
the C++ zstd decoder, built first if it is not), writes the same payload as flax
msgpack into a temporary directory, then times `train.checkpoint.restore_variables`
on the two in turns, `--repeats` times each, and the C++ decoder over the
checkpoint's zstd chunk frames. Prints one JSON line: the medians in ms, both
sizes in MB, the decoder's MB/s (decoded bytes over decode time) and `card`, the
card's name and power limit where nvidia-smi answers. It times host code only,
so it runs without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import tempfile
import time

from salsa_tpu_torch.scripts.timing import smi
from salsa_tpu_torch.train import checkpoint, ocdbt, orbax_checkpoint, zstd


def _mb(path: str) -> float:
    if os.path.isfile(path):
        return os.path.getsize(path) / 1e6
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
               for f in fs) / 1e6


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint", help="an .orbax checkpoint directory")
    p.add_argument("--repeats", type=int, default=5)
    a = p.parse_args(argv)
    payload = orbax_checkpoint.restore(a.checkpoint)  # builds the decoder if need be
    store = ocdbt.OcdbtStore(a.checkpoint)
    frames = [store.read(k) for k in store.keys() if not k.endswith(b"/.zarray")]
    t0 = time.perf_counter()
    decoded = sum(len(zstd.decompress(f)) for f in frames)
    decode_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        twin = os.path.join(tmp, "twin.msgpack")
        with open(twin, "wb") as f:
            f.write(checkpoint.packb(payload))
        times = {"orbax": [], "msgpack": []}
        for _ in range(a.repeats):
            for kind, path in (("orbax", a.checkpoint), ("msgpack", twin)):
                t0 = time.perf_counter()
                checkpoint.restore_variables(path)
                times[kind].append((time.perf_counter() - t0) * 1e3)
        msgpack_mb = _mb(twin)
    orbax_ms, msgpack_ms = (statistics.median(times[k]) for k in ("orbax", "msgpack"))
    out = {"orbax_ms": orbax_ms, "msgpack_ms": msgpack_ms, "ratio": orbax_ms / msgpack_ms,
           "orbax_mb": _mb(a.checkpoint), "msgpack_mb": msgpack_mb, "frames": len(frames),
           "decoded_mb": decoded / 1e6, "decoder_mb_s": decoded / 1e6 / decode_s,
           "repeats": a.repeats, "method": f"host clock, median of {a.repeats} in turns",
           "card": smi("name,power.limit") if shutil.which("nvidia-smi") else "no card"}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
