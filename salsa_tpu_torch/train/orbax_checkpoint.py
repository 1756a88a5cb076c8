"""`salsa_tpu`'s `.orbax` checkpoints without orbax, tensorstore or jax.

`salsa_tpu` saves `{"step", "params", "batch_stats", "opt_state"}` with orbax's
`StandardCheckpointer` as a directory `<name>.orbax`:

- `_CHECKPOINT_METADATA`: JSON, the handler's name and timestamps;
- `_METADATA`: JSON; `tree_metadata` maps each leaf's path, as the repr of a
  tuple of keys, to its `key_metadata` (`key_type` 2 a dict or namedtuple field,
  1 a sequence index) and `value_metadata.value_type`: `np.ndarray`, or `Dict` /
  `None` / `Tuple` / `List` for an empty node (an empty dict, optax's
  EmptyState, an empty sequence), which carries no data;
- an OCDBT store (`manifest.ocdbt`, `d/`, `ocdbt.process_0/`, read by
  `train.ocdbt`) holding one zarr v2 array per leaf under its dotted path:
  `<path>/.zarray` (JSON: shape, chunks, dtype, `"compressor": {"id": "zstd"}`,
  fill_value, order C) and its chunks `<path>/0.0...`, zstd frames.

`restore` gives the payload `checkpoint.msgpack_restore` gives for the same state
(sequence indices as the string keys '0', '1', ..., empty nodes as {}, `step` an
int, every other leaf an ndarray). `save` lays a payload out as salsa_tpu's
writer does, its chunks as raw zstd blocks, into a temporary sibling directory
that replaces `<name>.orbax` at once.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import time
import uuid

import numpy as np

from salsa_tpu_torch.train import ocdbt, zstd

HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
PROCESS_DIR = "ocdbt.process_0"
SEQUENCE, FIELD = 1, 2  # key_metadata key_type
EMPTY_TYPES = ("Dict", "None", "Tuple", "List")
_KINDS = "biuf"  # bool, int, unsigned, float: what a checkpoint of this package holds


def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):  # zarr v2 writes the special floats as strings
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return value


def read_array(store, name: str, what: str) -> np.ndarray:
    """The zarr v2 array `name` of the OcdbtStore `store`."""
    meta_key = f"{name}/.zarray".encode()
    if meta_key not in store:
        raise ValueError(f"{what}: no array {name!r} (no {meta_key.decode()})")
    z = json.loads(store.read(meta_key))
    if z.get("zarr_format") != 2 or z.get("order", "C") != "C" or z.get("filters"):
        raise ValueError(f"{what}: {name}: only zarr v2 arrays in C order without filters "
                         f"are read ({z})")
    compressor = z.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{what}: {name}: compressor {compressor.get('id')!r}; only zstd "
                         "(or none) is read")
    dtype = np.dtype(z["dtype"])
    if dtype.kind not in _KINDS or dtype.fields is not None:
        raise ValueError(f"{what}: {name}: dtype {z['dtype']!r} is not read")
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    sep = z.get("dimension_separator", ".")
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    out = None
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
        if key not in store:
            continue
        raw = store.read(key)
        data = (zstd.decompress(raw, chunk_bytes, what=f"{what}: {key.decode()}")
                if compressor is not None else bytearray(raw))
        if len(data) != chunk_bytes:
            raise ValueError(f"{what}: {key.decode()} holds {len(data)} bytes, its chunk "
                             f"{chunks} of {dtype} {chunk_bytes}")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        if chunks == shape:
            out = chunk
            continue
        if out is None:
            out = np.full(shape, _fill(z.get("fill_value")), dtype)
        where = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[where] = chunk[tuple(slice(0, w.stop - w.start) for w in where)]
    if out is None:
        out = np.full(shape, _fill(z.get("fill_value")), dtype)
    return out.astype(dtype.newbyteorder("="), copy=False)


def restore(path: str) -> dict:
    """The payload of the `.orbax` directory `path`, as `msgpack_restore` gives it."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path}: not an orbax checkpoint (no _METADATA)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3") or not meta.get("use_ocdbt", True):
        raise ValueError(f"{path}: only zarr v2 arrays in an OCDBT store are read (use_ocdbt "
                         f"{meta.get('use_ocdbt')}, use_zarr3 {meta.get('use_zarr3')})")
    store = ocdbt.OcdbtStore(path)
    payload: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        node = payload
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if value["value_type"] in EMPTY_TYPES:
            if not value.get("skip_deserialize"):
                raise ValueError(f"{path}: {keys}: a {value['value_type']} leaf that holds data")
            node[keys[-1]] = {}
        else:
            node[keys[-1]] = read_array(store, ".".join(keys), path)
    if "step" not in payload:
        raise ValueError(f"{path}: not a salsa_tpu checkpoint (no step)")
    payload["step"] = int(payload["step"])
    return payload


def _is_sequence(tree: dict) -> bool:
    """A flax state dict of a list or tuple: keys '0' .. 'n-1'."""
    return bool(tree) and set(tree) == {str(i) for i in range(len(tree))}


def _flatten(tree: dict, path: tuple, in_sequence: bool, out: list) -> None:
    """(key path, key types, value) of every leaf and empty node, in jax's order."""
    keys = sorted(tree, key=int) if in_sequence else sorted(tree)
    for k in keys:
        v = tree[k]
        key = (*path, (str(k), SEQUENCE if in_sequence else FIELD))
        if isinstance(v, dict) and v:
            _flatten(v, key, _is_sequence(v), out)
        elif isinstance(v, dict):
            # an empty element of a sequence is optax's EmptyState, which orbax
            # records as None; any other empty node is an empty dict
            out.append((key, "None" if in_sequence else "Dict"))
        else:
            out.append((key, np.asarray(v)))


def _zarray(arr: np.ndarray) -> bytes:
    shape = list(arr.shape)
    return json.dumps({"chunks": [max(s, 1) for s in shape],
                       "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".",
                       "dtype": arr.dtype.str, "fill_value": None, "filters": None,
                       "order": "C", "shape": shape, "zarr_format": 2},
                      sort_keys=True, separators=(",", ":")).encode()


def save(path: str, payload: dict) -> str:
    """Write `payload` (`step` and the trees of numpy arrays) as the `.orbax`
    directory `path`, replacing what is there; returns `path`."""
    init = time.time_ns()
    leaves: list = []
    tree = {**payload, "step": np.asarray(int(payload["step"]))}  # an int64 array, as orbax
    _flatten(tree, (), False, leaves)
    tree_meta, items = {}, {}
    for key, value in leaves:
        names = [k for k, _ in key]
        if isinstance(value, str):
            value_meta = {"value_type": value, "skip_deserialize": True}
        else:
            if value.dtype.kind not in _KINDS:
                raise ValueError(f"{'.'.join(names)}: dtype {value.dtype} is not written")
            arr = value.astype(value.dtype.newbyteorder("<"), order="C", copy=False)
            name = ".".join(names)
            items[f"{name}/.zarray".encode()] = _zarray(arr)
            items[f"{name}/{'.'.join('0' * arr.ndim) or '0'}".encode()] = zstd.compress_raw(
                arr.tobytes())
            value_meta = {"value_type": "np.ndarray", "skip_deserialize": False}
        tree_meta[repr(tuple(names))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in key],
            "value_metadata": value_meta}
    parent, base = os.path.split(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{base}.tmp-{uuid.uuid4().hex}")
    os.makedirs(os.path.join(tmp, PROCESS_DIR))
    try:
        refs = ocdbt.write_values(os.path.join(tmp, PROCESS_DIR), items)
        ocdbt.write_version(os.path.join(tmp, PROCESS_DIR), refs)
        ocdbt.write_version(tmp, refs, base=f"{PROCESS_DIR}/")
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": init, "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        if os.path.exists(path):  # replaced, as orbax's force=True does
            old = os.path.join(parent, f".{base}.old-{uuid.uuid4().hex}")
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path
