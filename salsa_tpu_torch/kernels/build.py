"""nvcc build of `salsa_tpu_torch/csrc/*.cu` into one shared library with a plain
C interface, bound with ctypes.

The library is built at first use into `build/salsa_tpu_torch/` beside the
package and reused while a hash of the sources and flags matches. Nothing is built
when this module is imported, and nothing falls back: a missing nvcc or a failed
compile raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "salsa_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (argtypes) of every C entry point; each returns cudaGetLastError() as int
_SIGNATURES = {
    "salsa_spatial_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F, _P),
    "noise_floor_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P),
}


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"nvcc not found (looked in {cuda_home}/bin and on PATH): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsalsa_tpu_torch_{h.hexdigest()[:16]}.so"


def build_library() -> tuple[Path, float]:
    """Compile the sources unless a library for them exists. Returns the library
    path and the seconds spent compiling (0.0 when it was reused). The compiler's
    output (ptxas registers and spills) is kept beside it as `<lib>.log`."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path, seconds


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built library with every entry point's argtypes/restype declared."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
