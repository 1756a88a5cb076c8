"""f32 K4 builds side by side on one card: this tree's `csrc/conv3x3_64.cu` with
other settings of its K4_* macros (the chunk loop's unroll depth), and any other
`conv3x3_64.cu` with the same `conv3x3_64_f32_launch` (an older commit's, unpacked
with `git archive`).

    python -m salsa_tpu_torch.scripts.bench_conv3x3 \
        [--variant NAME=K4_MACRO=VALUE[,K4_MACRO=VALUE] ...] [--source NAME=PATH ...]

e.g. `--variant u36=K4_F32_UNROLL=36`. Each build is compiled by its own nvcc (the
flags of `kernels/build.py`, plus a -D for each macro of a variant) and prints
its f32 kernel's ptxas registers and spills and its SASS size (instructions,
FFMA, LDS). Each is held within 1e-5 of the plain version (`conv3x3_64_plain`,
f32 cuDNN with TF32 off) at the stage-1 shape (32, 320, 100, 64), then timed
there in turns (sources, this tree, variants, then the reverse), 10 calls back
to back between CUDA events per timing, median of 20, with cuDNN f32 first and
last. Inputs are seeded standard-normal x and 0.05-scaled weights; the kernel
runs the same operations whatever the values. Prints each time with the card's
name, power limit and SM clock.
"""
from __future__ import annotations

import argparse
import ctypes
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from salsa_tpu_torch.kernels.build import (BUILD_DIR, CSRC_DIR, build_variants, library_sass,
                                           ptxas_usage, sass_opcode_counts)
from salsa_tpu_torch.scripts import timing
from salsa_tpu_torch.scripts.probe_pallas_conv import conv3x3_64_plain, f32_plan, rel_err
from salsa_tpu_torch.scripts.timing import cuda_ms, require_cuda, smi

SHAPE = (32, 320, 100, 64)
CALLS = 10
SUBDIR = "bench_conv3x3"


def launch(lib: ctypes.CDLL, x: torch.Tensor, w: torch.Tensor, plan, blocks: int) -> torch.Tensor:
    """One launch of a build's conv3x3_64_f32_launch with this tree's plan."""
    B, H, W, C = x.shape
    out = torch.empty((B, H, W, 64), dtype=torch.float32, device=x.device)
    err = lib.conv3x3_64_f32_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W, C,
                                    plan.slots, plan.box_px, plan.boxes, blocks,
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"conv3x3_64_f32_launch: CUDA error {err}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=K4_MACRO=VALUE[,K4_MACRO=VALUE]")
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    args = ap.parse_args(argv)
    dev = require_cuda("bench_conv3x3")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    builds = {name: (Path(path), [])
              for name, _, path in (spec.partition("=") for spec in args.source)}
    builds["tree"] = (CSRC_DIR / "conv3x3_64.cu", [])
    for spec in args.variant:
        name, defines = timing.parse_variant(spec, "K4_")
        builds[name] = (CSRC_DIR / "conv3x3_64.cu", defines)
    print(f"[card] {smi()}", flush=True)
    t0 = time.perf_counter()
    libs = {}
    for name, (lib, log) in build_variants(builds, SUBDIR, "conv3x3_64_f32_launch").items():
        ops = sass_opcode_counts(library_sass(BUILD_DIR / SUBDIR / f"{name}.so"))
        for kernel, (regs, st, ld) in ptxas_usage(log).items():
            if "f32_kernel" in kernel:
                op = ops[kernel]
                print(f"[build] {name}: {regs} registers, spill stores {st} B, loads {ld} B; "
                      f"{sum(op.values())} instructions, {op.get('FFMA', 0)} FFMA, "
                      f"{op.get('LDS', 0)} LDS: {kernel}", flush=True)
        libs[name] = lib
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(SHAPE, dtype=np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((3, 3, SHAPE[3], 64), dtype=np.float32)
                         * 0.05).to(dev)
    props = torch.cuda.get_device_properties(dev)
    plan = f32_plan(*SHAPE, props.shared_memory_per_block_optin)
    blocks = min(plan.tiles, props.multi_processor_count)
    want = conv3x3_64_plain(x, w)
    for name, lib in libs.items():
        err = rel_err(launch(lib, x, w, plan, blocks), want)
        print(f"[check] {name}: max|kernel - plain| / max|plain| {err:.3e} (bound 1e-05)",
              flush=True)
        if not err <= 1e-5:
            raise AssertionError(f"{name}: rel err {err} against the plain version")
    del want

    x_cl, w_cl = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    runs = {"cudnn": lambda: F.conv2d(x_cl, w_cl, padding=1),
            **{name: (lambda lib=lib: launch(lib, x, w, plan, blocks))
               for name, lib in libs.items()}}
    order = list(runs)
    times: dict[str, list[float]] = {}
    print(f"[time] {SHAPE} f32, {CALLS} calls back to back: {smi()}", flush=True)
    for name in order + order[::-1]:
        ms = cuda_ms(runs[name], repeats=20, warmup=3, calls=CALLS)
        times.setdefault(name, []).append(ms)
        print(f"[time] {name}: {ms:.4f} ms", flush=True)
    print(f"[time] done: {smi()}", flush=True)
    print(f"[summary] {SHAPE} f32: " + ", ".join(
        f"{name} {' / '.join(f'{ms:.4f}' for ms in each)} ms" for name, each in times.items())
        + f" [{smi('name,power.limit')}]", flush=True)
    return times


if __name__ == "__main__":
    main()
