"""salsa_tpu_torch.train.checkpoint and interop.torch_state_dict_to_flax against
salsa_tpu and flax: a checkpoint that salsa_tpu saved (Adam opt_state included)
decodes leaf for leaf, checkpoint selection picks salsa_tpu's file, the port's
writer gives flax's bytes, and the converter inverts flax_to_torch_state_dict."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

torch = pytest.importorskip("torch")

from salsa_tpu.interop.torch_ckpt import (  # noqa: E402
    torch_state_dict_to_flax as j_torch_state_dict_to_flax,
)
from salsa_tpu.models import seld as jseld  # noqa: E402
from salsa_tpu.train import checkpoint as jckpt  # noqa: E402
from salsa_tpu.train.state import create_train_state, make_optimizer  # noqa: E402
from salsa_tpu_torch.interop import (  # noqa: E402
    flax_to_torch_state_dict,
    torch_state_dict_to_flax,
)
from salsa_tpu_torch.models import seld as tseld  # noqa: E402
from salsa_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from salsa_tpu_torch.train.threshold import load_tuned_threshold  # noqa: E402
from tests.test_torch_models import flax_init  # noqa: E402

ENC = {"name": "PannResNet22", "n_input_channels": 7}


def _dec(decoder_type="gru", size=16):
    return {"name": "SeldDecoder", "decoder_type": decoder_type, "decoder_size": size,
            "freq_pool": "avg"}


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) > 20
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.fixture(scope="module")
def jax_state():
    """A salsa_tpu TrainState with non-trivial weights, step 7 and Adam state."""
    rng = np.random.default_rng(5)
    model = jseld.build_model(encoder=ENC, decoder=_dec("bigru"), n_classes=3)
    x = jnp.zeros((1, 7, 64, 32), jnp.float32)
    params, stats = flax_init(rng, model, np.zeros((1, 7, 64, 32), np.float32))
    state = create_train_state(model, x, make_optimizer(10))
    return state.replace(step=7, params=params, batch_stats=stats)


def test_decodes_a_salsa_tpu_checkpoint_leaf_for_leaf(tmp_path, jax_state):
    path = jckpt.save_checkpoint(str(tmp_path), "epoch007", jax_state, {"valSeld": 0.5})
    params, stats, step = tckpt.restore_variables(path)
    assert step == 7
    _assert_trees_equal(params, jax.device_get(jax_state.params))
    _assert_trees_equal(stats, jax.device_get(jax_state.batch_stats))
    # the whole payload, opt_state (Adam's count, mu, nu, hyperparameters) included,
    # decodes as flax decodes it
    with open(path, "rb") as f:
        data = f.read()
    got, want = tckpt.msgpack_restore(data), serialization.msgpack_restore(data)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert type(g) is type(w) and np.array_equal(g, w)
    assert tckpt.load_metadata(path) == jckpt.load_metadata(path) == {"valSeld": 0.5, "step": 7}


def test_writer_gives_flax_bytes_and_salsa_tpu_reads_them(tmp_path, jax_state):
    params, stats = jax.device_get(jax_state.params), jax.device_get(jax_state.batch_stats)
    path = tckpt.save_checkpoint(str(tmp_path), "port", params, stats, 11,
                                 {"valSeld": np.float32(0.25), "epoch": np.int64(3)})
    with open(path, "rb") as f:
        data = f.read()
    payload = {"step": 11, "params": params, "batch_stats": stats, "opt_state": {}}
    assert data == serialization.to_bytes(payload)
    back = serialization.msgpack_restore(data)
    assert back["step"] == 11 and back["opt_state"] == {}
    _assert_trees_equal(back["params"], params)
    _assert_trees_equal(back["batch_stats"], stats)
    # salsa_tpu restores it against its own templates (an empty opt_state here)
    template = {"step": 0, "params": params, "batch_stats": stats, "opt_state": {}}
    _assert_trees_equal(serialization.from_bytes(template, data)["params"], params)
    assert jckpt.load_metadata(path) == {"valSeld": 0.25, "epoch": 3, "step": 11}


def test_msgpack_values_as_flax_packs_them():
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "i": np.arange(5, dtype=np.int32), "s": np.float64(2.5), "b": np.bool_(True),
                  "h": np.float16(1.5), "u": np.arange(3, dtype=np.uint8)},
            "ints": {str(i): v for i, v in enumerate(
                [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**40, -1, -32, -33, -128,
                 -129, -32768, -32769, -2**31 - 1, -2**40])},
            "other": {"f": 3.5, "s": "x" * 40, "t": "y", "n": None, "T": True, "F": False,
                      "b": b"abc", "c": complex(1, -2), "long": "z" * 300},
            "empty": {}, "wide": {str(i): i for i in range(20)},
            "scalar0": np.zeros(()), "none0": np.zeros((0, 3))}
    data = serialization.to_bytes(tree)
    assert tckpt.packb(tree) == data
    got = tckpt.msgpack_restore(data)
    want = serialization.msgpack_restore(data)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert type(g) is type(w) and np.array_equal(g, w)
        assert getattr(g, "dtype", None) == getattr(w, "dtype", None)


def test_chunked_arrays_are_reassembled(monkeypatch):
    """flax writes arrays above MAX_CHUNK_SIZE bytes as `__msgpack_chunked_array__`
    dicts of flattened chunks; with a small limit, the reader reassembles them and
    the writer refuses such an array rather than write what flax would not."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tckpt, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(70, dtype=np.float32).reshape(7, 10)
    data = serialization.to_bytes({"params": {"big": arr, "small": np.ones(3, np.float32)}})
    assert b"__msgpack_chunked_array__" in data
    got = tckpt.msgpack_restore(data)
    np.testing.assert_array_equal(got["params"]["big"], arr)
    assert got["params"]["big"].shape == (7, 10) and got["params"]["small"].shape == (3,)
    with pytest.raises(ValueError, match="chunks"):
        tckpt.packb({"big": arr})


@pytest.mark.parametrize("data", [b"\xc1", b"\x92\x01", b"\xd4\x09\x00", b"\x01\x02"],
                         ids=["never-used", "truncated", "unknown-ext", "trailing"])
def test_decoder_refuses_what_is_not_flax_msgpack(data):
    with pytest.raises(ValueError):
        tckpt.msgpack_restore(data)


def _touch(d, name, meta):
    (d / f"{name}.msgpack").write_bytes(b"\x80")
    if meta is not None:
        (d / f"{name}.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("layout", [
    {"a": {"step": 10, "valSeld": 0.5}, "b": {"step": 30}, "c": {"step": 20, "valSeld": 0.3}},
    {"a": {"step": 10}, "b": {"step": 30}, "c": None},
    {"a": {"step": 10, "valSeld": 0.4}, "b": {"step": 5, "valSeld": 0.4},
     "c": {"step": 7, "valSeld": 0.9}},
], ids=["one-without-valSeld", "none-with-valSeld", "tied-valSeld"])
def test_checkpoint_selection_equals_salsa_tpu(tmp_path, layout):
    for name, meta in layout.items():
        _touch(tmp_path, name, meta)
    d = str(tmp_path)
    assert tckpt.best_checkpoint(d) == jckpt.best_checkpoint(d)
    assert tckpt.best_checkpoint(d, mode="max") == jckpt.best_checkpoint(d, mode="max")
    assert tckpt.latest_checkpoint(d) == jckpt.latest_checkpoint(d)
    assert tckpt.best_checkpoint(d, metric="valF1") == jckpt.best_checkpoint(d, metric="valF1")
    missing = str(tmp_path / "missing")
    assert tckpt.best_checkpoint(missing) is None and tckpt.latest_checkpoint(missing) is None


def test_orbax_checkpoints_are_refused(tmp_path, jax_state):
    """Once refused, `.orbax` checkpoints are now read: salsa_tpu's orbax
    checkpoint, picked as best over a msgpack one, restores to the state it saved
    (exact)."""
    jckpt.save_checkpoint(str(tmp_path), "epoch1", jax_state.replace(step=1),
                          {"valSeld": 0.1}, backend="orbax")
    _touch(tmp_path, "epoch0", {"step": 0, "valSeld": 0.2})
    best = tckpt.best_checkpoint(str(tmp_path))
    assert best == jckpt.best_checkpoint(str(tmp_path)) and best.endswith(".orbax")
    params, stats, step = tckpt.restore_variables(best)
    assert step == 1
    _assert_trees_equal(params, jax.device_get(jax_state.params))
    _assert_trees_equal(stats, jax.device_get(jax_state.batch_stats))


def test_checkpoint_backend_as_salsa_tpu_takes_it(tmp_path, jax_state):
    """`training.checkpoint_backend`: 'msgpack' and 'orbax' are what the port
    writes, as salsa_tpu does; any other value raises salsa_tpu's own ValueError,
    word for word."""
    tckpt.check_backend("msgpack")
    tckpt.check_backend("orbax")
    with pytest.raises(ValueError) as want:
        jckpt.save_checkpoint(str(tmp_path), "x", jax_state, {}, backend="zarr")
    with pytest.raises(ValueError) as got:
        tckpt.check_backend("zarr")
    assert str(got.value) == str(want.value) == "unknown checkpoint backend 'zarr'"


def test_tuned_threshold_sidecar(tmp_path):
    best = tmp_path / "models" / "best"
    best.mkdir(parents=True)
    assert load_tuned_threshold(str(best)) is None
    (tmp_path / "models" / "tuned_threshold.json").write_text(
        json.dumps({"sed_threshold": 0.45, "tuned_on": "val"}))
    assert load_tuned_threshold(str(best)) == 0.45


@pytest.mark.parametrize("decoder_type", ["gru", "bigru"])
def test_torch_state_dict_to_flax_equals_salsa_tpu(decoder_type):
    """The port model's weights (perturbed BatchNorm) as a flax tree equal
    salsa_tpu's import against a flax init's tree, leaf for leaf; carried back
    with flax_to_torch_state_dict they are the state_dict again, exactly."""
    model = tseld.init_random_(
        tseld.build_model(encoder=ENC, decoder=_dec(decoder_type, 32), n_classes=3),
        torch.Generator().manual_seed(3))
    sd = model.state_dict()
    params, stats = torch_state_dict_to_flax(sd)
    j_model = jseld.build_model(encoder=ENC, decoder=_dec(decoder_type, 32), n_classes=3)
    init = j_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 7, 64, 32)), train=False)
    want_params, want_stats = j_torch_state_dict_to_flax({k: v.numpy() for k, v in sd.items()},
                                                         init)
    _assert_trees_equal(params, jax.device_get(want_params))
    _assert_trees_equal(stats, jax.device_get(want_stats))
    back = flax_to_torch_state_dict(params, stats)
    assert list(back) == list(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k].numpy(), err_msg=k)


def test_torch_state_dict_to_flax_refuses_what_it_cannot_place():
    model = tseld.build_model(encoder=ENC, decoder=_dec("gru"), n_classes=3)
    sd = dict(model.state_dict())
    with pytest.raises(ValueError, match="decoder.gru and decoder.lstm"):
        torch_state_dict_to_flax({**sd, "decoder.lstm.weight_ih_l0": np.zeros((4, 4))})
    with pytest.raises(ValueError, match="cannot place"):
        torch_state_dict_to_flax({**sd, "decoder.extra.weight": np.zeros(2)})
    del sd["decoder.event_fc_1.bias"]
    with pytest.raises(ValueError, match="lacks"):
        torch_state_dict_to_flax(sd)


def test_checkpoint_of_a_port_model_serves_the_same_weights(tmp_path):
    """Port model -> torch_state_dict_to_flax -> save_checkpoint -> restore_variables
    -> load into a fresh port model: every tensor equal."""
    model = tseld.init_random_(tseld.build_model(encoder=ENC, decoder=_dec("bigru"),
                                                 n_classes=3), torch.Generator().manual_seed(9))
    path = tckpt.save_checkpoint(str(tmp_path), "m", *torch_state_dict_to_flax(model.state_dict()),
                                 step=4)
    params, stats, step = tckpt.restore_variables(path)
    assert step == 4 and os.path.isfile(str(tmp_path / "m.json"))
    fresh = tseld.build_model(encoder=ENC, decoder=_dec("bigru"), n_classes=3)
    fresh.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in flax_to_torch_state_dict(params, stats).items()})
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
