"""K1 builds side by side on one card: this tree's `csrc/salsa_spatial.cu` with
other settings of its K1_* macros (threads per block, minimum resident blocks for
`__launch_bounds__`), and any other `salsa_spatial.cu` with the same C entry
point (an older commit's, unpacked with `git archive`).

    python -m salsa_tpu_torch.scripts.bench_salsa_spatial \
        [--variant NAME=K1_MACRO=VALUE[,K1_MACRO=VALUE] ...] [--source NAME=PATH ...]

e.g. `--variant b256m2=K1_BLOCK=256,K1_MIN_BLOCKS=2`. Each build is compiled by
its own nvcc (the flags of `kernels/build.py`, plus a -D for each macro of a
variant) and prints its ptxas registers and spills. Each is held against the
plain version (`salsa_spatial_plain`, K1's bound: < 0.5 % mask disagreement,
atol/rtol 5e-3) at the serving shape, and every variant of this tree bit-equal
to this tree's build (only the launch shape differs). Then each is timed at the
serving shape (4, 4, 191, 4807 + 6) and at bench.py's batch (64, ...) in turns
(sources, this tree, variants, then the reverse), 10 calls back to back between
CUDA events per timing, median of 20. Inputs are seeded standard-normal planes
with correlated channels and a seeded mask; K1 runs the same operations on every
cell whatever the values. Prints each time with the card's name, power limit
and SM clock.
"""
from __future__ import annotations

import argparse
import ctypes
import time
from pathlib import Path

import numpy as np
import torch

from salsa_tpu_torch.features.salsa_spatial import C, mic_delta, salsa_spatial_plain
from salsa_tpu_torch.kernels.build import CSRC_DIR, build_variants, ptxas_usage
from salsa_tpu_torch.scripts import timing
from salsa_tpu_torch.scripts.probe_salsa_kernel import check_variant
from salsa_tpu_torch.scripts.timing import cuda_ms, require_cuda, smi

N_HOP = 3
N_FRAMES = 4807
N_BINS = 191
SHAPES = {"serving": 4, "b64": 64}
CALLS = 10
KW = dict(n_hop=N_HOP, audio_format="foa", condition_number=5.0, lower_bin=1, fs=24000,
          n_fft=512)


def parse_variant(spec: str) -> tuple[str, list[str]]:
    """'NAME=K1_MACRO=VALUE[,K1_MACRO=VALUE]' -> (NAME, the -D defines of that build)."""
    return timing.parse_variant(spec, "K1_")


def launch(lib: ctypes.CDLL, xr: torch.Tensor, xi: torch.Tensor, mask: torch.Tensor):
    """One FOA launch of a build's salsa_spatial_launch; the (B, 3, bins, T) output."""
    B, _, n_bins, n_padded = xr.shape
    n_frames = n_padded - 2 * N_HOP
    out = torch.empty((B, C - 1, n_bins, n_frames), dtype=torch.float32, device=xr.device)
    err = lib.salsa_spatial_launch(xr.data_ptr(), xi.data_ptr(), mask.data_ptr(),
                                   out.data_ptr(), B, n_bins, n_frames, N_HOP, 0,
                                   KW["condition_number"], KW["lower_bin"],
                                   float(mic_delta(KW["fs"], KW["n_fft"])),
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"salsa_spatial_launch: CUDA error {err}")
    return out


def planes(rng: np.random.Generator, batch: int, dev):
    """Seeded (batch, 4, bins, T + 2h) re/im planes, every channel plus channel 0
    (a coherent share of cells), and a mask set on ~70 % of cells."""
    shape = (batch, C, N_BINS, N_FRAMES + 2 * N_HOP)
    xr, xi = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
              for _ in "ri")
    xr += xr[:, :1].clone()
    xi += xi[:, :1].clone()
    mask = torch.from_numpy(rng.random((batch, N_BINS, N_FRAMES)) < 0.7).to(dev)
    return xr, xi, mask


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=K1_MACRO=VALUE[,K1_MACRO=VALUE]")
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    args = ap.parse_args(argv)
    dev = require_cuda("bench_salsa_spatial")
    builds = {name: (Path(path), [])
              for name, _, path in (spec.partition("=") for spec in args.source)}
    builds["tree"] = (CSRC_DIR / "salsa_spatial.cu", [])
    for spec in args.variant:
        name, defines = parse_variant(spec)
        builds[name] = (CSRC_DIR / "salsa_spatial.cu", defines)
    print(f"[card] {smi()}", flush=True)
    t0 = time.perf_counter()
    libs = {}
    for name, (lib, log) in build_variants(builds, "bench_salsa_spatial",
                                           "salsa_spatial_launch").items():
        for kernel, (regs, st, ld) in ptxas_usage(log).items():
            print(f"[build] {name}: {regs} registers, spill stores {st} B, loads {ld} B: "
                  f"{kernel}", flush=True)
        libs[name] = lib
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(0)
    cases = {key: planes(rng, batch, dev) for key, batch in SHAPES.items()}
    xr, xi, mask = cases["serving"]
    want = salsa_spatial_plain(xr, xi, mask, **KW)
    tree = launch(libs["tree"], xr, xi, mask)
    for name, lib in libs.items():
        got = launch(lib, xr, xi, mask)
        torch.cuda.synchronize()
        _, line = check_variant(got, want, "full", f"{name} vs plain")
        print(f"[check] {line}", flush=True)
        if builds[name][0] == builds["tree"][0] and not torch.equal(got, tree):
            raise AssertionError(f"{name}: not bit-equal to this tree's build")
    del want, tree
    print("[check] every build within K1's bound of the plain version; every variant of "
          "this tree bit-equal to its build", flush=True)

    order = list(libs)
    times: dict[str, dict[str, list[float]]] = {}
    for key, (xr, xi, mask) in cases.items():
        print(f"[time] {key} {tuple(xr.shape)}, {CALLS} calls back to back: {smi()}",
              flush=True)
        for name in order + order[::-1]:
            ms = cuda_ms(lambda: launch(libs[name], xr, xi, mask), repeats=20, warmup=3,
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
