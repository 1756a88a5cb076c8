"""`salsa_tpu` checkpoints without flax (counterpart of the msgpack half of
`salsa_tpu.train.checkpoint`).

`salsa_tpu` saves `{"step", "params", "batch_stats", "opt_state"}` with
`flax.serialization.to_bytes` as `<name>.msgpack`, beside a `<name>.json` sidecar
of step, epoch and validation metrics. The GPU host has neither flax nor msgpack,
so this module carries a msgpack reader and writer for flax's format:
ext type 1 is an ndarray packed as (shape, dtype name, C-order bytes), 2 a Python
complex packed as (real, imag), 3 a numpy scalar packed as a 0-d ndarray; an array
of more than MAX_CHUNK_SIZE bytes is a `__msgpack_chunked_array__` dict of
flattened chunks, which the reader reassembles. The writer packs every value as
msgpack-python does, so its bytes are `flax.serialization.to_bytes`'s for the
same tree; it refuses a leaf that flax would chunk (no model here has one).

`.orbax` checkpoint directories are refused: reading them needs orbax.
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# msgpack
# ---------------------------------------------------------------------------

class _Unpacker:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (b - 0xC7))
            return self.ext(n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return int.from_bytes(self.take(1 << (b - 0xD0)), "big", signed=True)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 << (b - 0xDC)))
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 << (b - 0xDE)))
        raise ValueError(f"byte 0x{b:02x} at offset {self.pos - 1} is not msgpack")

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = int.from_bytes(self.take(1), "big", signed=True)
        data = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray_from_bytes(data)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            re, im = unpackb(data)
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not one of flax's")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise ValueError("a bfloat16 leaf: numpy has no bfloat16, and salsa_tpu keeps "
                         "parameters in float32")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def unpackb(data: bytes):
    """One msgpack object from `data`, with flax's ext types decoded."""
    u = _Unpacker(data)
    out = u.value()
    if u.pos != len(u.buf):
        raise ValueError(f"{len(u.buf) - u.pos} bytes after the msgpack object")
    return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """`flax.serialization.msgpack_restore`: the tree of dicts and arrays in `data`,
    chunked arrays reassembled."""
    return _unchunk(unpackb(data))


def _pack_uint(out: list, head: tuple[int, ...], n: int) -> None:
    """A length or positive int in the smallest of 1/2/4/8 bytes after its head byte."""
    for head_byte, width in zip(head, (1, 2, 4, 8)):
        if n < 1 << (8 * width):
            out.append(bytes([head_byte]) + n.to_bytes(width, "big"))
            return
    raise ValueError(f"{n} is too large for msgpack")


def _pack(obj, out: list) -> None:
    # numpy first: np.float64 is a float, and flax packs numpy scalars as ext 3
    if isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    elif obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -32 <= obj < 0:
            out.append((obj & 0xFF).to_bytes(1, "big"))
        elif obj >= 0:
            _pack_uint(out, (0xCC, 0xCD, 0xCE, 0xCF), obj)
        else:
            for head, width in zip((0xD0, 0xD1, 0xD2, 0xD3), (1, 2, 4, 8)):
                if obj >= -(1 << (8 * width - 1)):
                    out.append(bytes([head]) + obj.to_bytes(width, "big", signed=True))
                    return
            raise ValueError(f"{obj} is too small for msgpack")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        if len(raw) < 32:
            out.append(bytes([0xA0 | len(raw)]))
        else:
            _pack_uint(out, (0xD9, 0xDA, 0xDB), len(raw))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_uint(out, (0xC4, 0xC5, 0xC6), len(obj))
        out.append(bytes(obj))
    elif isinstance(obj, dict):
        _pack_len(out, 0x80, (0xDE, 0xDF), len(obj))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, 0x90, (0xDC, 0xDD), len(obj))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, complex):
        _pack_ext(out, _EXT_COMPLEX, packb((obj.real, obj.imag)))
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def _pack_len(out: list, fix: int, heads: tuple[int, int], n: int) -> None:
    if n < 16:
        out.append(bytes([fix | n]))
    elif n < 1 << 16:
        out.append(bytes([heads[0]]) + n.to_bytes(2, "big"))
    else:
        out.append(bytes([heads[1]]) + n.to_bytes(4, "big"))


def _pack_ext(out: list, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(bytes([fixed[len(data)]]))
    else:
        _pack_uint(out, (0xC7, 0xC8, 0xC9), len(data))
    out.append(code.to_bytes(1, "big") + data)


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {arr.nbytes} bytes: flax writes arrays above "
                         f"{MAX_CHUNK_SIZE} bytes in chunks, which this writer does not")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def packb(obj) -> bytes:
    """msgpack bytes of `obj` (dicts, lists, tuples, scalars, numpy arrays), with
    flax's ext types."""
    out: list[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {str(k): _numpy_tree(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):  # a torch tensor
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(ckpt_dir: str, name: str, params: dict, batch_stats: dict, step: int,
                    metadata: dict | None = None) -> str:
    """Write `<ckpt_dir>/<name>.msgpack` as `salsa_tpu.train.checkpoint` does (an
    empty `opt_state`: the port does not train) and the `.json` sidecar; returns
    the .msgpack path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, name)
    payload = {"step": int(step), "params": _numpy_tree(params),
               "batch_stats": _numpy_tree(batch_stats), "opt_state": {}}
    with open(path + ".msgpack", "wb") as f:
        f.write(packb(payload))
    meta = dict(metadata or {})
    meta["step"] = int(step)
    with open(path + ".json", "w") as f:
        json.dump(_jsonable(meta), f, indent=2)
    return path + ".msgpack"


def restore_variables(path: str) -> tuple[dict, dict, int]:
    """(params, batch_stats, step) of a `.msgpack` checkpoint, as nested dicts of
    numpy arrays; `opt_state` is read past and dropped."""
    if path.endswith(".orbax"):
        raise ValueError(f"{path}: an orbax checkpoint directory; this package reads "
                         "flax .msgpack checkpoints only (save with backend='msgpack')")
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    missing = {"step", "params", "batch_stats"} - set(payload)
    if missing:
        raise ValueError(f"{path}: not a salsa_tpu checkpoint (no {sorted(missing)})")
    return payload["params"], payload["batch_stats"], int(payload["step"])


def load_metadata(path: str) -> dict:
    meta_path = os.path.splitext(path)[0] + ".json"
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def _candidates(ckpt_dir: str) -> list[str]:
    return [f for f in os.listdir(ckpt_dir)
            if f.endswith(".msgpack") or f.endswith(".orbax")]


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    cands = _candidates(ckpt_dir)
    if not cands:
        return None

    def key(fn):
        meta = load_metadata(os.path.join(ckpt_dir, fn))
        return meta.get("step", -1)
    return os.path.join(ckpt_dir, max(cands, key=key))


def best_checkpoint(ckpt_dir: str, metric: str = "valSeld", mode: str = "min") -> str | None:
    """The checkpoint whose sidecar has the best `metric`; the latest where no
    sidecar has it."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = _candidates(ckpt_dir)
    scored = []
    for fn in cands:
        meta = load_metadata(os.path.join(ckpt_dir, fn))
        if metric in meta:
            scored.append((meta[metric], fn))
    if not scored:
        return latest_checkpoint(ckpt_dir)
    best = min(scored) if mode == "min" else max(scored)
    return os.path.join(ckpt_dir, best[1])


def _jsonable(tree):
    if isinstance(tree, dict):
        return {k: _jsonable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jsonable(v) for v in tree]
    if isinstance(tree, (np.floating, np.integer)):
        return tree.item()
    return tree
