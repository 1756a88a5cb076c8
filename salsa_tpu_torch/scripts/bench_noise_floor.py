"""K2 builds side by side on one card: this tree's `csrc/noise_floor.cu` with other
settings of its NF_* macros (frame tile, producer warps), and any other
`noise_floor.cu` (an older commit's, unpacked with `git archive`) whose
`noise_floor_launch` takes this tree's arguments (the restart pointer and n_bins
among them).

    python -m salsa_tpu_torch.scripts.bench_noise_floor \
        [--variant NAME=MACRO=VALUE[,MACRO=VALUE] ...] [--source NAME=PATH ...]

e.g. `--variant t256=NF_TILE_FRAMES=256,NF_PRODUCER_WARPS=15`. Each build is
compiled by its own nvcc (the flags of `kernels/build.py`, plus a -D for each
macro of a variant) and held bit-equal (mask, floor, countdown) to the plain
tracker at (4, 191, 4807), at (64, 191, 4807) and at 33 rows for lengths around
frame tiles of 64, 128 and 256. Then each is timed at the two large shapes in
turns (sources, this tree, variants, then the reverse), 10 calls back to back
between CUDA events per timing, median of 20. Inputs are seeded standard-normal
planes; K2's work does not depend on their values. Prints each time with the
card's name, power limit and SM clock.
"""
from __future__ import annotations

import argparse
import ctypes
import time
from pathlib import Path

import numpy as np
import torch

from salsa_tpu_torch.features.salsa import (
    FLOOR_DOWN,
    FLOOR_UP,
    FLOOR_UP_SLOW,
    noise_floor_mask_plain,
)
from salsa_tpu_torch.kernels.build import CSRC_DIR, build_variants, ptxas_usage
from salsa_tpu_torch.scripts import timing
from salsa_tpu_torch.scripts.timing import cuda_ms, require_cuda, smi

N_HOP = 3
N_FRAMES = 4807
SHAPES = {"serving": (4, 191), "b64": (64, 191)}
CALLS = 10
RAGGED = sorted({5} | {t + d for t in (64, 128, 256) for d in (-1, 0, 1)}
                | {2 * t + 3 for t in (64, 128, 256)})


def parse_variant(spec: str) -> tuple[str, list[str]]:
    """'NAME=NF_MACRO=VALUE[,NF_MACRO=VALUE]' -> (NAME, the -D defines of that build)."""
    return timing.parse_variant(spec, "NF_")


def build(builds: dict[str, tuple[Path, list[str]]]) -> dict[str, ctypes.CDLL]:
    """Compile every (source, defines) into its own library, all nvcc at once."""
    t0 = time.perf_counter()
    libs = {}
    for name, (lib, log) in build_variants(builds, "bench_noise_floor",
                                           "noise_floor_launch").items():
        for kernel, (regs, st, ld) in ptxas_usage(log).items():
            print(f"[build] {name}: {regs} registers, spill stores {st} B, loads {ld} B: "
                  f"{kernel}", flush=True)
        libs[name] = lib
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


def launch(lib: ctypes.CDLL, xr0: torch.Tensor, xi0: torch.Tensor, n_frames: int):
    """One clip-start launch of a build's noise_floor_launch; (mask, floor, countdown)."""
    B, n_bins, _ = xr0.shape
    mask = torch.empty((B, n_bins, n_frames), dtype=torch.bool, device=xr0.device)
    floor = torch.empty((B, n_bins), dtype=torch.float32, device=xr0.device)
    countdown = torch.empty((B, n_bins), dtype=torch.int32, device=xr0.device)
    err = lib.noise_floor_launch(xr0.data_ptr(), xi0.data_ptr(), None, None, None,
                                 mask.data_ptr(), floor.data_ptr(), countdown.data_ptr(),
                                 B * n_bins, n_frames, n_bins, N_HOP, 1.5, FLOOR_UP,
                                 FLOOR_UP_SLOW, FLOOR_DOWN,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"noise_floor_launch: CUDA error {err}")
    return mask, floor, countdown


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=MACRO=VALUE[,MACRO=VALUE]")
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    args = ap.parse_args(argv)
    dev = require_cuda("bench_noise_floor")
    builds = {name: (Path(path), [])
              for name, _, path in (spec.partition("=") for spec in args.source)}
    builds["tree"] = (CSRC_DIR / "noise_floor.cu", [])
    for spec in args.variant:
        name, defines = parse_variant(spec)
        builds[name] = (CSRC_DIR / "noise_floor.cu", defines)
    print(f"[card] {smi()}", flush=True)
    libs = build(builds)

    rng = np.random.default_rng(0)

    def planes(B, n_bins, n_frames):
        return [torch.from_numpy(rng.standard_normal((B, n_bins, n_frames + 2 * N_HOP),
                                                     dtype=np.float32)).to(dev) for _ in "ri"]

    cases = [(key, planes(*shape, N_FRAMES), N_FRAMES) for key, shape in SHAPES.items()]
    cases += [(f"33 rows T={t}", planes(3, 11, t), t) for t in RAGGED]
    for key, (xr0, xi0), n_frames in cases:
        p_mask, (p_floor, p_cd) = noise_floor_mask_plain(xr0.cpu(), xi0.cpu(), n_hop=N_HOP,
                                                         n_frames=n_frames)
        for name, lib in libs.items():
            mask, floor, cd = (t.cpu() for t in launch(lib, xr0, xi0, n_frames))
            if not (torch.equal(mask, p_mask) and torch.equal(floor, p_floor)
                    and torch.equal(cd, p_cd)):
                raise AssertionError(f"{name} at {key}: not bit-equal to the plain tracker")
    print(f"[check] every build bit-equal to the plain tracker at {', '.join(SHAPES)} and "
          f"33 rows x T in {RAGGED}", flush=True)

    order = list(libs)
    times: dict[str, dict[str, list[float]]] = {}
    for key, (xr0, xi0), n_frames in cases[:len(SHAPES)]:
        print(f"[time] {key} {tuple(xr0.shape)}, {CALLS} calls back to back: {smi()}",
              flush=True)
        for name in order + order[::-1]:
            ms = cuda_ms(lambda: launch(libs[name], xr0, xi0, n_frames), repeats=20, warmup=3,
                         calls=CALLS)
            times.setdefault(key, {}).setdefault(name, []).append(ms)
            print(f"[time] {key} {name}: {ms:.4f} ms", flush=True)
        print(f"[time] {key} done: {smi()}", flush=True)
    for key, by_name in times.items():
        print(f"[summary] {key}: " + ", ".join(
            f"{name} {' / '.join(f'{ms:.4f}' for ms in runs)} ms" for name, runs in by_name.items())
            + f" [{smi('name,power.limit')}]", flush=True)
    return times


if __name__ == "__main__":
    main()
