"""The port's checkpoint interop CLIs against `salsa_tpu`'s: `cli.export_ckpt` of
an experiment whose best checkpoint is a flax init writes the keys and values
of `salsa_tpu`'s `flax_to_torch_state_dict` + `save_torch_checkpoint` bit for
bit, loadable with `weights_only=True`; `cli.import_ckpt` of that `.ckpt` writes
the parameters and statistics `salsa_tpu`'s `import_checkpoint` writes, with a
fresh optimizer state; a raw state_dict imports as a Lightning one does; a file
that needs full unpickling is refused unless trusted, and a tree that does not
map onto the config's model is refused naming its keys."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from salsa_tpu.cli import import_ckpt as j_import_ckpt  # noqa: E402
from salsa_tpu.interop import flax_to_torch_state_dict as j_flax_to_torch  # noqa: E402
from salsa_tpu.interop import save_torch_checkpoint as j_save_torch  # noqa: E402
from salsa_tpu.models.seld import build_model as j_build_model  # noqa: E402
from salsa_tpu.train import checkpoint as jckpt  # noqa: E402
from salsa_tpu.train.state import create_train_state  # noqa: E402
from salsa_tpu.train.state import make_optimizer as j_make_optimizer  # noqa: E402
from salsa_tpu_torch.cli import export_ckpt, import_ckpt  # noqa: E402
from salsa_tpu_torch.interop import load_torch_state_dict  # noqa: E402
from salsa_tpu_torch.train.checkpoint import restore_train_state, restore_variables  # noqa: E402

ENC = {"name": "PannResNet22", "n_input_channels": 7}
DEC = {"name": "SeldDecoder", "decoder_type": "bigru", "decoder_size": 16, "freq_pool": "avg"}


class Opaque:
    """An object `torch.load(weights_only=True)` refuses to unpickle."""


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """An experiment config (3 classes, a bigru of 16) and a group whose best
    checkpoint is salsa_tpu's flax init, written by salsa_tpu."""
    root = str(tmp_path_factory.mktemp("interop_cli"))
    cfg = {"name": "exp", "mode": "crossval", "feature_type": "salsa",
           "data": {"audio_format": "foa", "n_classes": 3, "output_format": "reg_xyz"},
           "model": {"encoder": ENC, "decoder": DEC}}
    config = os.path.join(root, "interop.yml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    model = j_build_model(encoder=ENC, decoder=DEC, n_classes=3)
    state = create_train_state(model, jnp.zeros((1, 7, 64, 16), jnp.float32), j_make_optimizer(1),
                               seed=4)
    group = os.path.join(root, "outputs")
    best = os.path.join(group, "crossval", "foa", "salsa", "interop", "models", "best")
    jckpt.save_checkpoint(best, "best", state, {"epoch": 3, "valSeld": 0.5})
    return {"root": root, "config": config, "group": group,
            "state": jax.device_get((state.params, state.batch_stats))}


def test_export_equals_salsa_tpu(experiment, tmp_path):
    out = export_ckpt.main(["--exp-config", experiment["config"], "--exp-group-dir",
                            experiment["group"], "--out", str(tmp_path / "port.ckpt")])
    want_path = j_save_torch(str(tmp_path / "jax.ckpt"), j_flax_to_torch(*experiment["state"]))
    got = torch.load(out, map_location="cpu", weights_only=True)
    want = torch.load(want_path, map_location="cpu", weights_only=True)
    assert list(got["state_dict"]) == list(want["state_dict"])
    assert all(k.startswith("model.") for k in got["state_dict"])
    for k, v in want["state_dict"].items():
        g = got["state_dict"][k]
        assert g.dtype == v.dtype and torch.equal(g, v), k
    assert got["salsa_tpu_export"]["exported_from"].endswith("best.msgpack")


def test_import_equals_salsa_tpu(experiment, tmp_path):
    """The export imported by both packages: the same params and statistics,
    step 0, and a fresh optimizer state that salsa_tpu's layout restores."""
    ckpt = export_ckpt.export_checkpoint(experiment["config"], str(tmp_path / "e.ckpt"),
                                         experiment["group"])
    got_path = import_ckpt.main(["--exp-config", experiment["config"], "--torch-ckpt", ckpt,
                                 "--exp-group-dir", str(tmp_path / "port")])
    want_path = j_import_ckpt.import_checkpoint(experiment["config"], ckpt,
                                                str(tmp_path / "jax"))
    assert got_path.endswith(os.path.join("models", "best", "best.msgpack"))
    gp, gs, gstep = restore_variables(got_path)
    wp, ws, wstep = restore_variables(want_path)
    assert gstep == wstep == 0
    for got, want in ((gp, wp), (gs, ws)):
        g, w = _leaves(got), _leaves(want)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))
    flax_init = _leaves(experiment["state"][0])
    for k, v in _leaves(gp).items():
        np.testing.assert_array_equal(v, flax_init[k], err_msg=str(k))
    _, _, opt = restore_train_state(got_path)
    assert int(opt["count"]) == 0 and all(
        not v.any() for v in _leaves(opt["inner_state"]["0"]["mu"]).values())


def test_raw_state_dict_and_refusals(experiment, tmp_path):
    ckpt = export_ckpt.export_checkpoint(experiment["config"], str(tmp_path / "e.ckpt"),
                                         experiment["group"])
    lightning = load_torch_state_dict(ckpt)
    sd = {k: torch.from_numpy(v) for k, v in lightning.items()}
    raw = str(tmp_path / "raw.pt")
    torch.save(sd, raw)  # no Lightning wrapper, no model. prefix
    assert set(load_torch_state_dict(raw)) == set(lightning)
    a = import_ckpt.import_checkpoint(experiment["config"], raw, str(tmp_path / "raw"))
    b = import_ckpt.import_checkpoint(experiment["config"], ckpt, str(tmp_path / "lit"))
    for x, y in zip(restore_variables(a)[:2], restore_variables(b)[:2]):
        gx, gy = _leaves(x), _leaves(y)
        assert all(np.array_equal(gx[k], gy[k]) for k in gy)

    opaque = str(tmp_path / "opaque.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}, "extra": Opaque()},
               opaque)
    with pytest.raises(ValueError, match="--trust-checkpoint"):
        load_torch_state_dict(opaque)
    with pytest.raises(SystemExit):  # the CLI's one-line refusal
        import_ckpt.main(["--exp-config", experiment["config"], "--torch-ckpt", opaque,
                          "--exp-group-dir", str(tmp_path / "refused")])
    assert set(load_torch_state_dict(opaque, trust_checkpoint=True)) == set(lightning)

    broken = dict(sd)
    broken["decoder.event_fc_9.weight"] = broken.pop("decoder.event_fc_1.weight")
    bad = str(tmp_path / "bad.ckpt")
    torch.save({"state_dict": broken}, bad)
    with pytest.raises(ValueError, match=r"missing \['decoder.event_fc_1.weight'\], "
                                         r"unexpected \['decoder.event_fc_9.weight'\]"):
        import_ckpt.import_checkpoint(experiment["config"], bad, str(tmp_path / "bad"))
    wide = dict(sd, **{"decoder.event_fc_1.weight": torch.zeros(5, 5)})
    torch.save(wide, bad)
    with pytest.raises(ValueError, match="misshapen"):
        import_ckpt.import_checkpoint(experiment["config"], bad, str(tmp_path / "bad"))
