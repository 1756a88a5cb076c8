"""nvcc build of `salsa_tpu_torch/csrc/*.cu` into one shared library with a plain
C interface, bound with ctypes; and the host C++ build of `csrc/*.cpp` (the zstd
decoder of `.orbax` checkpoints, the serving upload's pooled copy), one library a
source, by the host compiler.

Every source is compiled to an object by its own nvcc, all started together, and
the objects are linked into one library. The library is built at first use into
`build/salsa_tpu_torch/` beside the package and reused while a hash of the
sources, headers and flags matches. Nothing is built when this module is
imported, and nothing falls back: a missing nvcc or a failed compile raises.
`ptxas_usage`, `wgmma_serialized` and `sass_opcode_counts` read what the
compiler and `cuobjdump` say about the built kernels (registers, spills, a
broken wgmma pipeline, machine instructions). `load_host_library` builds a host
source with `CXX`, else `c++` or `g++` on PATH, the same way: at first use, keyed
by a hash of source, compiler and flags, and raising where the build fails.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "salsa_tpu_torch"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (argtypes) of every C entry point; each launcher returns its CUDA error code
_SIGNATURES = {
    "salsa_spatial_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F, _P),
    "noise_floor_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P),
    "noise_floor_states_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                                  _F, _F, _P),
    "salsa_spatial_probe_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "conv3x3_64_f32_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "conv3x3_64_bf16_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "noise_floor_tile_frames": (),
}
HOST_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-pthread", "-shared")
# {host source stem: {C entry point: (restype, argtypes)}}
_HOST_SIGNATURES = {
    "zstd_decode": {
        "zstd_decompress": (ctypes.c_long, (_P, ctypes.c_size_t, _P, ctypes.c_size_t)),
        "zstd_xxh64": (ctypes.c_uint64, (_P, ctypes.c_size_t)),
    },
    "host_copy": {
        "host_copy": (None, (_P, _P, ctypes.c_size_t)),
        "host_copy_threads": (_I, ()),
    },
}


def _find_tool(name: str) -> str:
    """A CUDA toolkit program (nvcc, cuobjdump) from CUDA_HOME/CUDA_PATH or PATH."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", name), shutil.which(name)):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"{name} not found (looked in {cuda_home}/bin and on PATH): "
                       "the CUDA kernels cannot be built or inspected")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsalsa_tpu_torch_{h.hexdigest()[:16]}.so"


def build_library() -> tuple[Path, float]:
    """Compile the sources unless a library for them exists. Returns the library
    path and the wall seconds spent building (0.0 when it was reused). The
    compilers' output (ptxas registers and spills) is kept beside it as
    `<lib>.log`."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_tool("nvcc")
    tag = f"{path.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = path.with_name(f"{tag}.so.tmp")
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    path.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path, seconds


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(log: str) -> dict[str, tuple[int, int, int]]:
    """{mangled kernel name: (registers, spill store bytes, spill load bytes)} from
    the `-Xptxas -v` output of a build."""
    usage, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            name, spills = m.group(1), (0, 0)
        elif (m := _SPILL.search(line)) and name:
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := _REGS.search(line)) and name:
            usage[name] = (int(m.group(1)), *spills)
            name = None
    return usage


_SERIALIZED = re.compile(r"wgmma\.mma_async instructions are serialized")
_QUOTED = re.compile(r"'(\w+)'")


def wgmma_serialized(log: str) -> dict[str, str]:
    """{mangled kernel name: ptxas's message} for every kernel whose wgmma
    instructions ptxas serialized (its "Potential Performance Loss: wgmma.mma_async
    instructions are serialized due to ..." note: the asynchronous pipeline is
    broken, e.g. by an accumulator touched between fence and wait). A message
    that names no kernel is keyed by the kernel whose compilation it follows."""
    found, name = {}, "?"
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            name = m.group(1)
        elif _SERIALIZED.search(line):
            quoted = _QUOTED.findall(line)
            found[quoted[-1] if quoted else name] = line.strip()
    return found


_FUNCTION = re.compile(r"\bFunction\s*:\s*(\S+)")
# an instruction line: /*0a30*/ [@P0 | @!UP1 ] OPCODE.MODIFIERS operands ;
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)[.\s;]")


def sass_opcode_counts(sass: str) -> dict[str, dict[str, int]]:
    """{mangled kernel name: {opcode: count}} from `cuobjdump -sass` output; an
    opcode is the instruction's name without its modifiers (`HMMA` for
    `HMMA.16816.F32.BF16`)."""
    counts, name = {}, None
    for line in sass.splitlines():
        if m := _FUNCTION.search(line):
            name = m.group(1)
            counts[name] = Counter()
        elif name and (m := _INSTR.search(line)):
            counts[name][m.group(1)] += 1
    return counts


def library_sass(path: Path) -> str:
    """`cuobjdump -sass` of a built library: the machine code of every kernel."""
    cmd = [_find_tool("cuobjdump"), "-sass", str(path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def _bind(lib: ctypes.CDLL, names) -> ctypes.CDLL:
    """Declare argtypes/restype of the entry points `names` of `lib`."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built library with every entry point's argtypes/restype declared."""
    path, _ = build_library()
    return _bind(ctypes.CDLL(str(path)), _SIGNATURES)


def build_variants(builds: dict[str, tuple[Path, list[str]]], subdir: str,
                   entry: str) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile each build, a source and its extra nvcc flags (-D macros), into a
    library of its own under BUILD_DIR/subdir, one nvcc each, all started
    together, with the flags of `build_library`. Returns {name: (library with
    the entry point `entry` bound, the compiler's output)}; a failed compile
    raises."""
    nvcc, procs = _find_tool("nvcc"), {}
    out_dir = BUILD_DIR / subdir
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, (src, flags) in builds.items():
        cmd = [nvcc, *COMPILE_FLAGS, *LINK_FLAGS, *flags, "-o", str(out_dir / f"{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = (_bind(ctypes.CDLL(str(out_dir / f"{name}.so")), [entry]), log)
    return libs


def _find_cxx() -> str:
    """The host C++ compiler: `CXX`, else `c++` or `g++` on PATH."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and (path := shutil.which(cand)):
            return path
    raise RuntimeError("no host C++ compiler (set CXX, or put c++ or g++ on PATH): the "
                       "host libraries of salsa_tpu_torch/csrc/*.cpp cannot be built")


@functools.lru_cache(maxsize=None)
def load_host_library(stem: str) -> ctypes.CDLL:
    """`csrc/<stem>.cpp` built by the host compiler into BUILD_DIR (reused while a
    hash of source, compiler and flags matches), its entry points declared."""
    src = CSRC_DIR / f"{stem}.cpp"
    cxx = _find_cxx()
    h = hashlib.sha256(" ".join((cxx, *HOST_FLAGS)).encode())
    h.update(src.read_bytes())
    path = BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.so.tmp")
        cmd = [cxx, *HOST_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{os.path.basename(cxx)} failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic, as in build_library
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _HOST_SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
