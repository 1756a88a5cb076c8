"""One run of one cell of `BENCHMARK.json`, on the first CUDA card:

    python3 -m seldbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in `setup_s`, from the process's start to the first timed call)
pins the precision the configuration states (float32: TF32 off for matmuls and
cuDNN, printed on standard error), builds the cell from the seed and warms up
every shape its traffic uses. The window then makes timed calls for `--seconds`
and waits for the card once at its end. With `--trace 0` the result holds the
cell's end-to-end metrics; with `--trace 1` its per-layer metrics, read from CUDA
events around the program's layers and from the profiler over the window's first
`trace_seconds` (the mix's), with `device.busy_s`, `device.window_s` and the
`breakdown`. After the window the program's state is freed and what the window
produced is compared with the plain reference; each number compared is printed
beside its limit, last on standard error and last in the result's line.

The last line of standard output is the result, one JSON object. There is none,
and the exit code is not 0, where there is no card (or fewer than the cell asks
for), where the program's package is not beside the benchmark, or where a module
of JAX (`jax`, `jaxlib`, `flax`, `optax`, `orbax`) or the JAX package `salsa_tpu`
is loaded once the window has closed.

Build and kernel caches stay inside the checkout, under `build/`.
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "seldbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "salsa_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from /proc (10 ms steps); where /proc
    cannot say, since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules() -> list[str]:
    """The top-level names of loaded modules, compared whole, that are JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def keep_caches_inside() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = str(CACHE / sub)


def pin_precision(cfg: dict) -> str:
    """TF32 off for every float32 matmul and convolution, whatever the
    configuration's compute dtype (its float32 parts stay float32)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = cfg.get("model", {}).get("encoder", {}).get("compute_dtype") or "float32"
    return (f"precision: config {dtype}; torch.backends.cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32} torch.backends.cudnn.allow_tf32="
            f"{torch.backends.cudnn.allow_tf32}")


def card() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi did not answer"


def run_cell(manifest, name: str, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of the cell `name` on `device`; returns the result's fields."""
    import torch

    from seldbench import tracing, work

    cell = manifest.workload(name)
    cfg, mix, limits = manifest.config(cell), manifest.traffic(cell), manifest.limits(cell)
    spans = tracing.Spans(trace)
    driver = importlib.import_module(f"seldbench.drivers.{mix['kind']}").Cell(
        cfg, mix, seed, device, spans)
    driver.setup()
    driver.instrument()
    session = tracing.Session(mix["trace_seconds"] if trace else None)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age_s()
    attempted = failed = 0
    session.start()
    t0 = time.perf_counter()
    while True:
        attempted += 1
        try:
            driver.timed()
        except Exception:  # a failed call counts against the attempts; the loop serves on
            failed += 1
            print(traceback.format_exc(), file=sys.stderr)
        session.tick()
        if time.perf_counter() - t0 >= seconds:
            break
    driver.close()
    session.stop()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    if trace:
        reading = session.reading
        if reading is None or not reading.measured:
            raise RuntimeError("the profiler recorded no device activity in the traced window")
        units = driver.units()
        run = SimpleNamespace(cell=cell, cfg=cfg, mix=mix, spans=spans.totals(), units=units,
                              traced_units=units[:session.units],
                              rest_units=units[session.units:],
                              rest_s=t0 + window_s - session.stopped_at, reading=reading,
                              peaks=work.PEAKS)
        metrics, notes = {}, {}
        for m in manifest.per_layer(cell):
            reader = manifest.reader(m["name"])
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
                if hasattr(reader, "NOTE"):
                    notes[m["name"]] = reader.NOTE
    else:
        values = {**driver.end_to_end(window_s), "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(cell)}
    driver.free()
    numbers = driver.check()
    checks = {k: {"value": numbers[k], "limit": v["limit"]} for k, v in limits.items()
              if isinstance(v, dict)}
    result = {"correct": failed == 0 and all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"].update(busy_s=reading.busy_s, window_s=reading.window_s)
        result["breakdown"] = {"device_ops": reading.top_ops(), "idle_gaps": reading.idle_gaps()}
        result["notes"] = notes
    result["checks"] = checks
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    keep_caches_inside()
    if not (ROOT / "salsa_tpu_torch" / "__init__.py").is_file():
        print("seldbench: the program's package salsa_tpu_torch is not beside the benchmark; "
              "no result", file=sys.stderr)
        return 2

    import torch

    from seldbench.manifest import Manifest

    manifest = Manifest(ROOT)
    cell = manifest.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"seldbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}; no result", file=sys.stderr)
        return 2
    print(pin_precision(manifest.config(cell)), file=sys.stderr)
    limit = card()
    print(f"card: {limit}", file=sys.stderr, flush=True)
    result = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    checks = result.pop("checks")
    result["card"] = limit  # name and power.limit, beside every number of the run
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"seldbench: modules of JAX or of the JAX package are loaded: {found}; no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
