"""salsa_tpu_torch's `.orbax` checkpoints against orbax and tensorstore: the zstd
decoder (C++, built from csrc/zstd_decode.cpp by the host compiler, and its Python
plain version) on frames that tensorstore's zarr driver and zstandard write; the
OCDBT reader on stores that tensorstore's ocdbt driver writes, and its writer read
back by tensorstore; checkpoints saved by salsa_tpu's orbax backend restored in
the port, the port's restored by salsa_tpu through orbax, checkpoint selection,
the committed fixture, and training that saves and resumes from `.orbax`. Every
comparison is exact: bytes equal, arrays `array_equal` with equal dtypes."""
import importlib.util
import json
import os
import pathlib
import shutil
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
ts = pytest.importorskip("tensorstore")
zstandard = pytest.importorskip("zstandard")

import jax.numpy as jnp  # noqa: E402

from salsa_tpu.train import checkpoint as jckpt  # noqa: E402
from salsa_tpu_torch.cli import infer as cli_infer  # noqa: E402
from salsa_tpu_torch.cli import predict as cli_predict  # noqa: E402
from salsa_tpu_torch.cli import train as cli_train  # noqa: E402
from salsa_tpu_torch.cli.export_ckpt import export_checkpoint  # noqa: E402
from salsa_tpu_torch.kernels.build import load_host_library  # noqa: E402
from salsa_tpu_torch.scripts import bench_restore  # noqa: E402
from salsa_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from salsa_tpu_torch.train import ocdbt, orbax_checkpoint, zstd  # noqa: E402
from tests.test_torch_checkpoint import jax_state  # noqa: E402,F401 (a fixture)
from tests.test_torch_resume import _weights, _write, corpus  # noqa: E402,F401

GOLDEN = pathlib.Path(__file__).parent / "golden"
FIXTURE = GOLDEN / "orbax_small" / "orbax_small"


def _load_golden_script():
    spec = importlib.util.spec_from_file_location("make_orbax_small",
                                                  GOLDEN / "make_orbax_small.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this file, beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def scratch():
    """A temporary directory removed after the test (full-width checkpoints are
    135 MB each)."""
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


def _payload_equal(got, want, path=""):
    """Same tree, same leaf types and dtypes, arrays equal bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(sorted(got)) == list(sorted(want)), path
        for k in want:
            _payload_equal(got[k], want[k], f"{path}/{k}")
        return
    assert type(got) is type(want), (path, type(got), type(want))
    assert getattr(got, "dtype", None) == getattr(want, "dtype", None), path
    assert np.shape(got) == np.shape(want) and np.array_equal(got, want), path


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(20261018)
    pattern = rng.standard_normal(97).astype(np.float32)
    repeats = np.tile(pattern, 3000)
    repeats[::1009] = rng.standard_normal(repeats[::1009].size)  # breaks between matches
    return {
        "normal_4mib": rng.standard_normal(1_100_000).astype(np.float32),
        "normal_conv": rng.standard_normal((3, 3, 7, 16)).astype(np.float32),
        "int32_scalar": np.asarray(7, np.int32),
        "int64_scalar": np.asarray(123456789012, np.int64),
        "zeros": np.zeros((256, 512), np.float32),
        "repeats": repeats,
    }


INPUTS = _inputs()


def _tensorstore_chunk(arr: np.ndarray, level: int) -> bytes:
    """The single chunk that tensorstore's zarr driver writes for `arr` at `level`."""
    store = ts.open({"driver": "zarr", "kvstore": {"driver": "memory"},
                     "metadata": {"compressor": {"id": "zstd", "level": level},
                                  "dtype": arr.dtype.str, "shape": list(arr.shape),
                                  "chunks": list(arr.shape)}}, create=True).result()
    store.write(arr).result()
    keys = [k for k in store.kvstore.list().result() if k != b".zarray"]
    assert len(keys) == 1, keys
    return bytes(store.kvstore.read(keys[0]).result().value)


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", list(INPUTS))
def test_zstd_decodes_tensorstore_zarr_chunks(name, level):
    """Exact: the C++ decoder, the plain decoder and the original bytes are equal."""
    arr = INPUTS[name]
    frame = _tensorstore_chunk(arr, level)
    assert frame[:4] == b"\x28\xb5\x2f\xfd"
    want = arr.tobytes()
    got = zstd.decompress(frame, len(want))
    assert bytes(got) == want
    assert zstd.decompress_plain(frame) == want
    assert bytes(zstd.decompress(frame)) == want  # without the size: the buffer grows
    if name == "normal_4mib":  # many blocks; below level 19 a window under the content
        fhd, wd = frame[4], frame[5]
        assert not fhd & 0x20 and len(want) > 8 * zstd.BLOCK_MAX
        window = (1 << (10 + (wd >> 3))) * (8 + (wd & 7)) // 8
        assert window < len(want) or level == 19


def test_zstd_checksums_and_several_frames():
    """zstandard's frames with content checksums and sizes, back to back with a
    skippable frame between them, decode to the concatenated inputs (exact)."""
    parts = [INPUTS["normal_conv"].tobytes(), INPUTS["repeats"].tobytes()[:200_000], b"",
             b"abc" * 1000]
    frames = [zstandard.ZstdCompressor(level=lvl, write_checksum=True).compress(p)
              for lvl, p in zip((1, 9, 3, -5), parts)]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    data = frames[0] + skippable + b"".join(frames[1:])
    want = b"".join(parts)
    assert bytes(zstd.decompress(data)) == want == zstd.decompress_plain(data)


def test_zstd_xxh64_as_the_reference():
    xxhash = pytest.importorskip("xxhash")
    lib = load_host_library("zstd_decode")
    data = INPUTS["normal_conv"].tobytes()
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 100, len(data)):
        want = xxhash.xxh64_intdigest(data[:n])
        assert zstd.xxh64_plain(data[:n]) == want == lib.zstd_xxh64(data[:n], n), n


@pytest.mark.parametrize("n", [0, 1, 255, 256, 65791, 65792, 131072, 131073, 3 * 131072 + 7])
def test_compress_raw_round_trips(n):
    """Raw-block frames read back through both decoders and through zstandard's
    (exact)."""
    data = np.random.default_rng(n).bytes(n)
    frame = zstd.compress_raw(data)
    assert bytes(zstd.decompress(frame)) == data == zstd.decompress_plain(frame)
    assert zstandard.ZstdDecompressor().decompress(frame) == data


def _both_raise(frame: bytes, match: str) -> None:
    with pytest.raises(ValueError, match=match):
        zstd.decompress(frame)
    with pytest.raises(ValueError, match=match):
        zstd.decompress_plain(frame)


def test_corrupt_zstd_frames_raise():
    frame = _tensorstore_chunk(INPUTS["normal_conv"], 3)
    for cut in (1, 4, 5, 6, 9, len(frame) // 2, len(frame) - 1):
        _both_raise(frame[:cut], "truncated|corrupt")
    _both_raise(b"\x29" + frame[1:], "bad magic")
    checked = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        INPUTS["normal_conv"].tobytes())
    _both_raise(checked[:-1] + bytes([checked[-1] ^ 1]), "checksum")
    # a frame that names dictionary 5 (single segment, 1-byte dictionary id and size)
    _both_raise(b"\x28\xb5\x2f\xfd\x21\x05\x03\x19\x00\x00abc", "dictionary")
    # a frame whose content size says 4 where its raw block holds 3 bytes
    _both_raise(b"\x28\xb5\x2f\xfd\x20\x04\x19\x00\x00abc", "content size")
    with pytest.raises(ValueError, match="expected 10"):
        zstd.decompress(zstd.compress_raw(b"abc"), 10)


def test_mutated_frames_decode_alike():
    """400 frames with a flipped byte or a cut (level 1 and 19 chunks, a zstandard
    frame with a checksum): the C++ and plain decoders both raise ValueError or
    both return the same bytes, and a frame whose header claims more than its
    blocks can hold raises instead of allocating it."""
    rng = np.random.default_rng(7)
    seeds = [_tensorstore_chunk(INPUTS["normal_conv"], 1),
             _tensorstore_chunk(INPUTS["repeats"][:3000], 19),
             zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
                 INPUTS["repeats"][:2000].tobytes() + INPUTS["normal_conv"].tobytes())]
    outcomes = set()
    for i in range(400):
        frame = bytearray(seeds[i % len(seeds)])
        if i % 4 == 3:
            frame = frame[:int(rng.integers(1, len(frame)))]
        else:
            frame[int(rng.integers(4, len(frame)))] ^= 1 << int(rng.integers(0, 8))
        results = []
        for fn in (zstd.decompress, zstd.decompress_plain):
            try:
                results.append(bytes(fn(bytes(frame))))
            except ValueError as e:
                results.append(type(e))
        assert results[0] == results[1], i
        outcomes.add(results[0] is zstd.ZstdError)
    assert outcomes == {True, False}
    huge = b"\x28\xb5\x2f\xfd\xe0" + (1 << 60).to_bytes(8, "little") + b"\x19\x00\x00abc"
    _both_raise(huge, "larger|content size")


def test_a_failed_build_raises(monkeypatch):
    """No fallback: a compiler that fails makes the decoder raise."""
    monkeypatch.setenv("CXX", "false")
    load_host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed"):
            zstd.decompress(zstd.compress_raw(b"abc"))
    finally:
        monkeypatch.undo()
        load_host_library.cache_clear()
    assert bytes(zstd.decompress(zstd.compress_raw(b"abc"))) == b"abc"


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------

def _kv(path) -> "ts.KvStore":
    base = f"file://{os.path.abspath(path)}"
    return ts.KvStore.open({"driver": "ocdbt", "base": base}).result()


def _tensorstore_items(path) -> dict:
    kv = _kv(path)
    return {k: bytes(kv.read(k).result().value) for k in kv.list().result()}


def _items(n: int = 80) -> dict:
    rng = np.random.default_rng(n)
    return {f"params.layer_{i % 7}.w{i:03d}/{'.zarray' if i % 2 else '0.0'}".encode():
            rng.bytes(int(rng.integers(0, 3000)) if i % 5 else 0) for i in range(n)}


OCDBT_CONFIGS = {
    "interior_nodes": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 8,
                       "compression": None},
    "all_indirect": {"max_inline_value_bytes": 0},
    "all_inline": {"max_inline_value_bytes": 1 << 20, "compression": None},
    "zstd_level_5": {"compression": {"id": "zstd", "level": 5}},
    "default": {},
}


@pytest.mark.parametrize("name", list(OCDBT_CONFIGS))
def test_ocdbt_reads_what_tensorstore_writes(tmp_path, name):
    """keys() and read() equal tensorstore's list() and read() (exact)."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": OCDBT_CONFIGS[name]}).result()
    items = _items()
    txn = ts.Transaction()
    for k, v in items.items():
        kv.with_transaction(txn).write(k, v).result()
    txn.commit_async().result()
    store = ocdbt.OcdbtStore(str(tmp_path))
    assert store.keys() == sorted(items) == sorted(kv.list().result())
    for k in items:
        assert store.read(k) == items[k] == bytes(kv.read(k).result().value)
    if name == "interior_nodes":
        assert store.height >= 2


@pytest.mark.parametrize("arity_log2", [1, 4])
def test_ocdbt_takes_the_newest_of_several_commits(tmp_path, arity_log2):
    """40 commits, each its own version, overwriting and deleting keys: the store
    reads the newest (older versions in version-tree nodes at arity 2)."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": {"version_tree_arity_log2": arity_log2}}).result()
    for i in range(40):
        kv.write(b"k%d" % (i % 7), b"v%d" % i).result()
    del kv[b"k3"]
    store = ocdbt.OcdbtStore(str(tmp_path))
    assert store.generation == 42
    want = _tensorstore_items(tmp_path)
    assert b"k3" not in want and want[b"k4"] == b"v39"
    assert store.keys() == sorted(want) and {k: store.read(k) for k in store.keys()} == want


def test_ocdbt_writer_is_read_by_tensorstore(tmp_path):
    items = _items(120)
    items[b"big"] = np.random.default_rng(1).bytes(300_000)
    ocdbt.write(str(tmp_path), items)
    assert _tensorstore_items(tmp_path) == items
    store = ocdbt.OcdbtStore(str(tmp_path))
    assert {k: store.read(k) for k in store.keys()} == items


def _rewrite(path: pathlib.Path, edit) -> None:
    """Apply `edit` to the encoded file's bytes, then give it a valid CRC again."""
    blob = bytearray(path.read_bytes())
    edit(blob)
    blob[-4:] = ocdbt.crc32c(bytes(blob[:-4])).to_bytes(4, "little")
    path.write_bytes(bytes(blob))


def test_corrupt_ocdbt_stores_raise(tmp_path):
    """A flipped CRC byte, a bad magic or length, an unknown format version or
    manifest kind: ValueError naming the file."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path / 'ok'}",
                          "config": {"compression": None,
                                     "max_inline_value_bytes": 1 << 20}}).result()
    for k, v in _items(20).items():
        kv.write(k, v).result()
    cases = {
        "manifest_crc": (lambda b: b.__setitem__(-1, b[-1] ^ 1), "CRC-32C", False),
        "manifest_body": (lambda b: b.__setitem__(20, b[20] ^ 0x40), "CRC-32C", False),
        "magic": (lambda b: b.__setitem__(0, 0x0D), "magic", True),
        "length": (lambda b: b.__setitem__(4, (b[4] + 1) % 256), "length", True),
        "version": (lambda b: b.__setitem__(12, 1), "format version 1", True),
        "kind": (lambda b: b.__setitem__(14 + 16, 1), "manifest kind 1", True),
    }
    for name, (edit, match, fix_crc) in cases.items():
        root = tmp_path / name
        shutil.copytree(tmp_path / "ok", root)
        manifest = root / "manifest.ocdbt"
        if fix_crc:
            _rewrite(manifest, edit)
        else:
            blob = bytearray(manifest.read_bytes())
            edit(blob)
            manifest.write_bytes(bytes(blob))
        with pytest.raises(ValueError, match=match) as err:
            ocdbt.OcdbtStore(str(root))
        assert "manifest.ocdbt" in str(err.value)
    # a flipped byte inside the B+tree node (all values inline: the data files
    # hold nodes only)
    root = tmp_path / "node"
    shutil.copytree(tmp_path / "ok", root)
    newest = max((root / "d").iterdir(), key=lambda p: p.stat().st_mtime_ns)
    blob = bytearray(newest.read_bytes())
    blob[len(blob) // 2] ^= 1
    newest.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="CRC-32C") as err:
        ocdbt.OcdbtStore(str(root))
    assert newest.name in str(err.value)


@pytest.mark.parametrize("dtype,compressor,fill", [
    ("<f4", {"id": "zstd", "level": 3}, 1.5), ("<i8", None, 7), ("|b1", {"id": "zstd"}, None),
    ("<f8", {"id": "zstd", "level": 1}, "NaN")])
def test_zarr_arrays_over_a_chunk_grid(tmp_path, dtype, compressor, fill):
    """A zarr v2 array in an OCDBT store over a grid of edge-cropped chunks, some
    never written (the fill value), as tensorstore reads it (exact)."""
    rng = np.random.default_rng(3)
    data = (rng.standard_normal((5, 7)) * 100).astype(np.dtype(dtype))
    store = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                                    "base": f"file://{tmp_path}"},
                     "path": "params.w", "metadata": {
                         "dtype": dtype, "shape": [5, 7], "chunks": [2, 3],
                         "compressor": compressor, "fill_value": fill}},
                    create=True).result()
    store[0:4, 0:3].write(data[0:4, 0:3]).result()
    store[4:5, 3:7].write(data[4:5, 3:7]).result()
    want = store.read().result()
    got = orbax_checkpoint.read_array(ocdbt.OcdbtStore(str(tmp_path)), "params.w", "t")
    assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=dtype == "<f8")
    assert np.array_equal(got[0:4, 0:3], data[0:4, 0:3])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_salsa_tpu_orbax_restores_as_its_msgpack(tmp_path, jax_state):
    """salsa_tpu's `.orbax` of a bigru TrainState with Adam's state at step 7: the
    port's payload equals its msgpack payload of the same state (structure, types,
    dtypes, bits), and the restore entry points agree."""
    orbax = jckpt.save_checkpoint(str(tmp_path), "epoch007", jax_state, {"valSeld": 0.5},
                                  backend="orbax")
    msgpack = jckpt.save_checkpoint(str(tmp_path), "m", jax_state, {"valSeld": 0.5})
    got = orbax_checkpoint.restore(orbax)
    with open(msgpack, "rb") as f:
        want = tckpt.msgpack_restore(f.read())
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    _payload_equal(got, want)
    assert got["step"] == 7 and got["opt_state"]["inner_state"]["1"] == {}
    for a, b in zip(tckpt.restore_variables(orbax), tckpt.restore_variables(msgpack)):
        _payload_equal(a, b)
    for a, b in zip(tckpt.restore_train_state(orbax), tckpt.restore_train_state(msgpack)):
        _payload_equal(a, b)


def test_port_orbax_restores_in_salsa_tpu(tmp_path, jax_state):
    """The port's `.orbax` of the same payload restores through orbax into a
    TrainState equal to the original, leaf for leaf; its `_METADATA`, OCDBT keys
    and `.zarray` documents are salsa_tpu's."""
    want_path = jckpt.save_checkpoint(str(tmp_path / "j"), "x", jax_state, {}, backend="orbax")
    payload = orbax_checkpoint.restore(want_path)
    path = tckpt.save_checkpoint(str(tmp_path / "t"), "x", payload["params"],
                                 payload["batch_stats"], payload["step"], {"valSeld": 0.1},
                                 opt_state=payload["opt_state"], backend="orbax")
    assert path == str(tmp_path / "t" / "x.orbax")
    template = jax.tree_util.tree_map(jnp.zeros_like, jax_state).replace(step=0)
    back = jckpt.restore_checkpoint(path, template)
    assert back.step == 7
    for name in ("params", "batch_stats", "opt_state"):
        got, want = getattr(back, name), getattr(jax_state, name)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert np.asarray(g).dtype == np.asarray(w).dtype and np.array_equal(g, w)
    for doc in ("_METADATA",):
        assert (json.loads((tmp_path / "t" / "x.orbax" / doc).read_text())
                == json.loads(pathlib.Path(want_path, doc).read_text()))
    ours, theirs = ocdbt.OcdbtStore(path), ocdbt.OcdbtStore(want_path)
    assert ours.keys() == theirs.keys()
    for k in ours.keys():
        if k.endswith(b"/.zarray"):
            assert ours.read(k) == theirs.read(k), k
    assert tckpt.load_metadata(path) == {"valSeld": 0.1, "step": 7}


def test_orbax_save_replaces_in_one_step(tmp_path):
    """A second save of the same name replaces the first, and no temporary
    directory stays beside it."""
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    for step in (1, 2):
        tckpt.save_checkpoint(str(tmp_path), "ck", params, {}, step, backend="orbax")
    assert sorted(os.listdir(tmp_path)) == ["ck.json", "ck.orbax"]
    p, stats, step = tckpt.restore_variables(str(tmp_path / "ck.orbax"))
    assert step == 2 and stats == {} and np.array_equal(p["w"], params["w"])
    assert p["w"].dtype == np.float32
    with pytest.raises(ValueError, match="unknown checkpoint backend 'zarr'"):
        tckpt.save_checkpoint(str(tmp_path), "z", params, {}, 1, backend="zarr")
    assert not (tmp_path / "z.json").exists()


def test_selection_agrees_with_salsa_tpu_across_backends(tmp_path, jax_state):
    """latest_checkpoint and best_checkpoint on a directory of both backends."""
    d = str(tmp_path)
    jckpt.save_checkpoint(d, "epoch003", jax_state.replace(step=3), {"valSeld": 0.2},
                          backend="orbax")
    jckpt.save_checkpoint(d, "epoch005", jax_state.replace(step=5), {"valSeld": 0.4})
    params = jax.device_get(jax_state.params)
    tckpt.save_checkpoint(d, "epoch009", params, {}, 9, {"valSeld": 0.3}, backend="orbax")
    tckpt.save_checkpoint(d, "epoch004", params, {}, 4, {"valSeld": 0.1})
    for mode in ("min", "max"):
        assert tckpt.best_checkpoint(d, mode=mode) == jckpt.best_checkpoint(d, mode=mode)
    assert tckpt.latest_checkpoint(d) == jckpt.latest_checkpoint(d) == str(
        tmp_path / "epoch009.orbax")
    assert tckpt.best_checkpoint(d) == str(tmp_path / "epoch004.msgpack")
    assert tckpt.best_checkpoint(d, mode="max") == str(tmp_path / "epoch005.msgpack")


def test_fixture_against_a_fresh_write(tmp_path):
    """tests/golden/orbax_small: a fresh write by its script restores to the
    committed payload (exact), its msgpack is byte-identical, and the C++ and
    plain decoders agree on every frame of the committed store."""
    fresh = _load_golden_script().write(str(tmp_path))
    committed = orbax_checkpoint.restore(str(FIXTURE) + ".orbax")
    _payload_equal(orbax_checkpoint.restore(fresh["orbax"]), committed)
    msgpack = pathlib.Path(str(FIXTURE) + ".msgpack").read_bytes()
    assert pathlib.Path(fresh["msgpack"]).read_bytes() == msgpack
    _payload_equal(committed, tckpt.msgpack_restore(msgpack))
    assert (json.loads(pathlib.Path(fresh["orbax"], "_METADATA").read_text())
            == json.loads(pathlib.Path(str(FIXTURE) + ".orbax", "_METADATA").read_text()))
    store = ocdbt.OcdbtStore(str(FIXTURE) + ".orbax")
    frames = [store.read(k) for k in store.keys() if not k.endswith(b"/.zarray")]
    assert len(frames) == 42 and any(f[4] & 0x20 == 0 for f in frames)
    for f in frames:
        assert bytes(zstd.decompress(f)) == zstd.decompress_plain(f)


def test_bench_restore_on_the_fixture(capsys):
    """scripts/bench_restore on the committed fixture: one JSON line, both readers
    timed, every chunk frame decoded (the CPU's times, never read as a card's)."""
    out = bench_restore.main([str(FIXTURE) + ".orbax", "--repeats", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    payload = orbax_checkpoint.restore(str(FIXTURE) + ".orbax")
    leaves = jax.tree_util.tree_leaves({k: v for k, v in payload.items() if k != "step"})
    want_mb = (sum(np.asarray(v).nbytes for v in leaves) + 8) / 1e6  # step: one int64
    assert out["frames"] == 42 and abs(out["decoded_mb"] - want_mb) < 1e-12
    assert out["orbax_ms"] > 0 and out["msgpack_ms"] > 0 and out["decoder_mb_s"] > 0
    assert abs(out["msgpack_mb"] - os.path.getsize(str(FIXTURE) + ".msgpack") / 1e6) < 1e-9


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_training_saves_and_resumes_from_orbax(corpus, scratch):
    """cli.train with training.checkpoint_backend orbax writes `.orbax` checkpoints
    whose payload equals the msgpack run's; `--resume` from them continues bit for
    bit as `--resume` from msgpack does (losses, weights, the next checkpoint);
    cli.predict and cli.infer serve the `.orbax` experiment with CSVs
    byte-identical to the msgpack one's, and cli.export_ckpt exports equal
    tensors."""
    runs, served = {}, {}
    for backend in ("msgpack", "orbax"):
        config = _write(corpus, f"ck_{backend}.yml", max_epochs=1, checkpoint_backend=backend)
        group = str(scratch / backend)
        first = cli_train.train(config, group, device="cpu")
        assert first.checkpoint_backend == backend
        resumed = cli_train.train(config, group, device="cpu", resume=True,
                                  overrides=["training.max_epochs=2"])
        ck = resumed.cfg.dir.model.checkpoint
        assert sorted(os.listdir(ck)) == [f"epoch00{e}.{x}" for e in range(2)
                                          for x in ("json", backend)]
        runs[backend] = (first, resumed, ck)
        preds = cli_predict.predict(config, os.path.join(corpus, "foa_dev"),
                                    str(scratch / f"preds_{backend}"), group, device="cpu")
        cli_infer.inference(config, group, splits=["val"], device="cpu")
        exp = pathlib.Path(resumed.cfg.dir.model.best).parents[1]
        exported = export_checkpoint(config, str(scratch / f"{backend}.ckpt"), group)
        served[backend] = (preds, exp / "outputs" / "submissions" / "val",
                           torch.load(exported, weights_only=False)["state_dict"])
    (preds_m, val_m, sd_m), (preds_o, val_o, sd_o) = served["msgpack"], served["orbax"]
    for got, want in ((preds_o, preds_m), (val_o, val_m)):
        names = sorted(os.listdir(want))
        assert names and sorted(os.listdir(got)) == names
        for n in names:
            assert pathlib.Path(got, n).read_bytes() == pathlib.Path(want, n).read_bytes(), n
    assert sd_o.keys() == sd_m.keys()
    for k in sd_m:
        assert torch.equal(sd_o[k], sd_m[k]), k
    (first_m, res_m, ck_m), (first_o, res_o, ck_o) = runs["msgpack"], runs["orbax"]
    assert first_o.step_losses == first_m.step_losses
    assert res_o.step_losses == res_m.step_losses and res_o.optimizer.count == 4
    for name in ("epoch000", "epoch001"):
        with open(os.path.join(ck_m, f"{name}.msgpack"), "rb") as f:
            want = tckpt.msgpack_restore(f.read())
        _payload_equal(orbax_checkpoint.restore(os.path.join(ck_o, f"{name}.orbax")), want)
    want = _weights(res_m)
    for k, v in _weights(res_o).items():
        assert torch.equal(v, want[k]), k
    best = tckpt.best_checkpoint(res_o.cfg.dir.model.best)
    assert best.endswith("best.orbax")
    assert tckpt.restore_variables(best)[2] == tckpt.restore_variables(
        tckpt.best_checkpoint(res_m.cfg.dir.model.best))[2]
