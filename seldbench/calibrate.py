"""The readings that a cell's correctness limits are set from, on the card at the
cell's own size, all seeds in one process:

    python3 -m seldbench.calibrate --workload <name>

For each of 12 fixed seeds (drawn from `BASE_SEED`): the cell's set-up and a
window of its timed calls of `SECONDS`, then the comparison with the plain
reference, exactly as a run makes them (the program's readings: the lower ones).
For the first `CONTROLS` of those seeds the same again with TF32 switched on
for the set-up and the window, the program's own lower-precision path (PyTorch's
default), compared with the float32 reference (the control's readings: the upper
ones). For a training cell also the fault "half of the batch left out, the mean
taken over the rest", planted in the trainer's `forward_backward`, on as many
seeds. Prints one JSON line a reading and a summary line: each number's largest
program reading and smallest control and fault readings.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time

import torch

from seldbench import signals, tracing
from seldbench.manifest import Manifest
from seldbench.run import ROOT, keep_caches_inside, pin_precision

BASE_SEED = 3_000_000_017
SEEDS, CONTROLS, SECONDS = 12, 3, 2.0


@contextlib.contextmanager
def tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def half_batch():
    """The trainer's forward and backward on the first half of each batch's rows:
    the loss is the mean over the rest."""
    from salsa_tpu_torch.train.trainer import SeldTrainer

    orig = SeldTrainer.forward_backward

    def halved(self, x, sed, doa):
        n = x.shape[0] // 2
        return orig(self, x[:n], sed[:n], doa[:n])

    SeldTrainer.forward_backward = halved
    try:
        yield
    finally:
        SeldTrainer.forward_backward = orig


def reading(manifest, cell, seed: int, seconds: float, device, context) -> dict:
    """One cell's set-up and a window of `seconds` under `context`, then the
    comparison with the float32 reference outside it; the precision is pinned
    first, as a run pins it."""
    pin_precision(manifest.config(cell))
    mix = manifest.traffic(cell)
    driver = importlib.import_module(f"seldbench.drivers.{mix['kind']}").Cell(
        manifest.config(cell), mix, seed, device, tracing.Spans(False))
    n = 0
    with context():
        driver.setup()
        t0 = time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < seconds:
            driver.timed()
            n += 1
        driver.close()
    driver.free()
    return {"units": n, **driver.check()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    args = ap.parse_args(argv)
    keep_caches_inside()
    if not torch.cuda.is_available():
        print("seldbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    manifest = Manifest(ROOT)
    cell = manifest.workload(args.workload)
    print(pin_precision(manifest.config(cell)), file=sys.stderr)
    device = torch.device("cuda", 0)
    seeds = [signals.sub_seed(BASE_SEED, k) % (2**32) for k in range(SEEDS)]
    kinds = [("program", s, contextlib.nullcontext) for s in seeds]
    kinds += [("control_tf32", s, lambda: tf32(True)) for s in seeds[:CONTROLS]]
    if manifest.traffic(cell)["kind"] == "train":
        kinds += [("fault_half_batch", s, half_batch) for s in seeds[:CONTROLS]]
    found: dict[str, list[dict]] = {}
    for kind, seed, context in kinds:
        t0 = time.perf_counter()
        r = reading(manifest, cell, seed, SECONDS, device, context)
        r.update(kind=kind, seed=seed, seconds=round(time.perf_counter() - t0, 1))
        print(json.dumps(r), flush=True)
        found.setdefault(kind, []).append(r)
        torch.cuda.empty_cache()
    numbers = [k for k in found["program"][0] if k not in ("units", "kind", "seed", "seconds")]
    summary = {"workload": args.workload, "lower": {
        k: max(r[k] for r in found["program"]) for k in numbers}}
    for kind in found:
        if kind != "program":
            summary[kind] = {k: min(r[k] for r in found[kind]) for k in numbers}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
