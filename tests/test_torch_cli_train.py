"""`salsa_tpu_torch.cli.train` end to end on the CPU: a from-wav experiment
trained by the port (plain K1 and K2 in every step, the scaler fit and the val
split on the device it is given) is served by `salsa_tpu_torch.cli.predict` and
by `salsa_tpu.cli.predict` with the same CSV rows; and every refusal raises.

salsa_tpu serves on the CPU through its XLA power iteration unless told
otherwise; here its extractor takes eig_method='pallas' (interpret mode), the
arithmetic of the port's K1, so the two packages serve the same features."""
import functools
import glob
import json
import os
import shutil

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import salsa_tpu.cli.predict as jpredict_mod  # noqa: E402
import salsa_tpu_torch.cli.predict as tpredict_mod  # noqa: E402
from salsa_tpu.cli.evaluate import evaluate_seld as j_evaluate_seld  # noqa: E402
from salsa_tpu.features.registry import make_extractor as j_make_extractor  # noqa: E402
from salsa_tpu.utils.audio_io import write_wav  # noqa: E402
from salsa_tpu_torch.cli import train as cli_train  # noqa: E402
from salsa_tpu_torch.cli.evaluate import evaluate_seld  # noqa: E402
from salsa_tpu_torch.train.trainer import SeldTrainer  # noqa: E402
from salsa_tpu_torch.utils.config import AttrDict, load_config  # noqa: E402
from tests.test_from_wav import _synth_wave_8k  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


FS, N_CLASSES = 8000, 3
TRAIN, VAL = ("tr_a", "tr_b", "tr_c"), ("va_a", "va_b")


def _config(root, **training):
    return {
        "name": "exp", "feature_root_dir": None, "feature_type": "salsa",
        "gt_meta_root_dir": root, "split_meta_dir": os.path.join(root, "meta"), "seed": 5,
        "mode": "crossval",
        "data": {"fs": FS, "n_fft": 256, "hop_len": 100, "audio_format": "foa",
                 "label_rate": 10, "train_chunk_len_s": 0.8, "train_chunk_hop_len_s": 0.8,
                 "test_chunk_len_s": 2.0, "test_chunk_hop_len_s": 2.1, "n_classes": N_CLASSES,
                 "fmax_doa": 3000.0, "max_file_len_s": 2.0, "output_format": "reg_xyz"},
        "model": {"encoder": {"name": "PannResNet22", "n_input_channels": 7},
                  "decoder": {"name": "SeldDecoder", "decoder_type": "bigru",
                              "decoder_size": 8}},
        "training": {"from_wav": True, "train_batch_size": 2, "max_epochs": 2,
                     "val_interval": 1, "optimizer": "adam",
                     "lr_scheduler": {"milestones": [0.0, 1.0], "lrs": [1.0e-3, 1.0e-3],
                                      "moms": [0.9, 0.9]}, **training},
        "sed_threshold": 0.5, "doa_threshold": 20, "eval_version": "2021",
    }


def _write_config(root, name="exp.yml", **training):
    path = os.path.join(root, name)
    with open(path, "w") as f:
        yaml.safe_dump(_config(root, **training), f, sort_keys=False)
    return path


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """The corpus (2 s clips at 8 kHz with DCASE metadata) and a port-trained
    experiment from it."""
    root = str(tmp_path_factory.mktemp("torch_cli_train"))
    rng = np.random.default_rng(20261020)
    for sub in ("foa_dev", "metadata_dev", "meta"):
        os.makedirs(os.path.join(root, sub))
    for i, name in enumerate(TRAIN + VAL):
        write_wav(os.path.join(root, "foa_dev", name + ".wav"), _synth_wave_8k(rng, 2.0), FS,
                  bits=16)
        rows = [f"{f},{(f + i) % N_CLASSES},0,{(f * 11) % 360 - 180},{(f * 5) % 60 - 30}"
                for f in range(4, 16)]
        with open(os.path.join(root, "metadata_dev", name + ".csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    for split, names in (("train", TRAIN), ("val", VAL)):
        with open(os.path.join(root, "meta", f"{split}.csv"), "w") as f:
            f.write("filename\n" + "\n".join(names))
    config = _write_config(root)
    group = os.path.join(root, "outputs")
    trainer = cli_train.train(config, group, device="cpu")
    exp = os.path.join(group, "crossval", "foa", "salsa", "exp")
    yield {"root": root, "config": config, "group": group, "exp": exp, "trainer": trainer}
    shutil.rmtree(root)  # full-width checkpoints: pytest keeps its last temp trees


def test_train_writes_the_experiment(experiment):
    exp, tr = experiment["exp"], experiment["trainer"]
    for path in ("models/feature_scaler.npz", "models/best/best.msgpack",
                 "models/best/best.json", "models/checkpoint/epoch000.msgpack",
                 "models/checkpoint/epoch001.json", "logs/log.txt"):
        assert os.path.isfile(os.path.join(exp, path)), path
    meta = json.load(open(os.path.join(exp, "models/checkpoint/epoch001.json")))
    assert meta["epoch"] == 1 and meta["step"] == 2 * tr.steps_per_epoch
    for key in ("loss", "sed_loss", "doa_loss", "lr", "momentum", "valSeld", "valER"):
        assert np.isfinite(meta[key]), key
    scaler = np.load(os.path.join(exp, "models/feature_scaler.npz"))
    assert scaler["mean"].shape == scaler["std"].shape == (4, 1, 100)
    # the stamped config reads back equal through both readers, dir included
    (saved,) = glob.glob(os.path.join(exp, "configs", "config_*.yml"))
    cfg = load_config(saved).to_dict()
    assert cfg == yaml.safe_load(open(saved))
    assert cfg["dir"]["model"]["best"] == os.path.join(exp, "models", "best")
    assert cfg["training"] == _config(experiment["root"])["training"]
    log = open(os.path.join(exp, "logs", "log.txt")).read()
    assert "tracker checkpoints" in log and "Epoch 1/1" in log
    assert set(tr.setup_seconds) == {"read", "scaler_fit", "tracker_checkpoints", "val_extract"}
    assert len(tr.step_losses) == tr.steps_per_epoch and np.isfinite(tr.step_losses).all()


def _recording(module, calls):
    base = module.SeldInferencePipeline

    class Recording(base):
        def __call__(self, waves):
            out = super().__call__(waves)
            calls.append(out)
            return out

    return Recording


def _csv_rows(path):
    rows = {}
    for line in open(path).read().splitlines():
        f, c, _, a, e = map(int, line.split(","))
        rows[(f, c)] = (a, e)
    return rows


def test_trained_experiment_served_by_both_packages(experiment, tmp_path):
    """Both predict CLIs restore `best` and write the same rows: every (frame,
    class) row in both, angles within a degree (the rounding of two frameworks'
    floats). The served threshold is set in a gap of the port's probabilities,
    so that no probability lies near it."""
    root, group = experiment["root"], experiment["group"]
    wav_dir = str(tmp_path / "val_wavs")
    os.makedirs(wav_dir)
    for name in VAL:
        os.link(os.path.join(root, "foa_dev", name + ".wav"), os.path.join(wav_dir, name + ".wav"))
    calls = {"port": [], "jax": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpredict_mod, "SeldInferencePipeline", _recording(tpredict_mod, calls["port"]))
        tpredict_mod.predict(experiment["config"], wav_dir, str(tmp_path / "probe"), group,
                             device="cpu")
    probs = np.sort(np.concatenate([ev.ravel() for ev, _ in calls["port"]]))
    k = len(probs) // 4 + int(np.argmax(np.diff(probs[len(probs) // 4:3 * len(probs) // 4])))
    cfg = yaml.safe_load(open(experiment["config"]))
    cfg["sed_threshold"] = float((probs[k] + probs[k + 1]) / 2)
    served = str(tmp_path / "exp.yml")  # the same experiment name, another threshold
    yaml.safe_dump(cfg, open(served, "w"), sort_keys=False)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpredict_mod, "make_extractor",
                   functools.partial(j_make_extractor, eig_method="pallas"))
        mp.setattr(jpredict_mod, "SeldInferencePipeline", _recording(jpredict_mod, calls["jax"]))
        out["jax"] = jpredict_mod.predict(served, wav_dir, str(tmp_path / "jax"), group)
    out["port"] = tpredict_mod.predict(served, wav_dir, str(tmp_path / "port"), group,
                                       device="cpu")
    for (ev_j, doa_j), (ev_t, doa_t) in zip(calls["jax"], calls["port"][1:]):
        np.testing.assert_allclose(ev_t, ev_j, atol=1e-4)
        np.testing.assert_allclose(doa_t, doa_j, atol=1e-4)
    names = sorted(os.listdir(out["port"]))
    assert names == sorted(os.listdir(out["jax"])) == [f"{n}.csv" for n in VAL]
    n_rows = 0
    for name in names:
        got, want = (_csv_rows(os.path.join(out[s], name)) for s in ("port", "jax"))
        assert set(got) == set(want), name
        for key in got:
            (ga, ge), (wa, we) = got[key], want[key]
            assert min(abs(ga - wa), 360 - abs(ga - wa)) <= 1 and abs(ge - we) <= 1, key
        n_rows += len(got)
    assert 0 < n_rows < probs.size, n_rows
    gt_root = root
    assert evaluate_seld(out["port"], gt_root, n_classes=N_CLASSES) == j_evaluate_seld(
        out["port"], gt_root, n_classes=N_CLASSES)


def test_train_refusals(experiment, monkeypatch):
    root = experiment["root"]
    group = str(os.path.join(root, "refused"))
    # neither a feature store nor wavs (training.from_wav) to train from
    with pytest.raises(ValueError, match="feature_root_dir"):
        cli_train.train(_write_config(root, "no_wav.yml", from_wav=False), group, device="cpu")
    with pytest.raises(ValueError, match="fewer than a batch"):
        cli_train.train(_write_config(root, "big.yml", train_batch_size=100), group, device="cpu")
    # device_data_shard with one process is the plain from-wav trainer, as in salsa_tpu
    tr = cli_train.build_trainer(_write_config(root, "dd.yml", device_data_shard=True), group,
                                 device="cpu")
    assert tr.from_wav and not tr.device_data_shard and tr.n_ranks == 1
    with pytest.raises(ValueError, match="'full' or 'feature'"):
        cli_train.train(_write_config(root, "aug_mode.yml", device_augment="swap"), group,
                        device="cpu")
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        cli_train.train(experiment["config"], group, device="cpu",
                        overrides=["model.decoder.compute_dtype=float8"])
    # a backend salsa_tpu does not know is refused before any data is read or a
    # step runs; orbax, as salsa_tpu's, trains and writes .orbax checkpoints
    with pytest.raises(ValueError, match="unknown checkpoint backend 'zarr'"):
        cli_train.train(_write_config(root, "zarr.yml", checkpoint_backend="zarr"), group,
                        device="cpu")
    assert not glob.glob(os.path.join(group, "zarr*", "models", "checkpoint", "*"))
    tr = cli_train.train(_write_config(root, "orbax.yml", checkpoint_backend="orbax",
                                       max_epochs=1), group, device="cpu")
    assert sorted(os.listdir(tr.cfg.dir.model.checkpoint)) == ["epoch000.json", "epoch000.orbax"]
    assert tr.checkpoint_backend == "orbax"
    tr = cli_train.build_trainer(_write_config(root, "msgpack.yml",
                                               checkpoint_backend="msgpack"), group, device="cpu")
    with pytest.raises(ValueError, match="unknown checkpoint backend 'zarr'"):
        SeldTrainer(model=tr.model, cfg=AttrDict(dict(tr.cfg.to_dict(), training=dict(
            tr.cfg.training.to_dict(), checkpoint_backend="zarr"))),
            train_data=tr.train_data, val_data=None, gt_meta_dir=None, submission_dir=group,
            device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli_train.train(experiment["config"], group)


def test_train_passes_the_spectral_keys(experiment, monkeypatch):
    """cli.train on a melspeciv experiment (n_mels 32, fmin 0, fmax 3.5 kHz, eig_method
    'power'): the keys reach the full-clip extractor (scaler fit, validation) and
    the chunk extractor of every step, as salsa_tpu's cli.train passes them; the
    classic type's scaler covers all 7 channels and no tracker checkpoint is made."""
    import salsa_tpu_torch.train.trainer as trainer_mod

    root = experiment["root"]
    cfg = _config(root, max_epochs=1, eig_method="power")
    cfg["feature_type"] = "melspeciv"
    cfg["data"].update(n_mels=32, fmin=0.0, fmax=3500.0)
    path = os.path.join(root, "melspeciv.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    calls = {"make_extractor": [], "make_chunk_extractor": []}
    for module, name in ((cli_train, "make_extractor"), (trainer_mod, "make_chunk_extractor")):
        target = getattr(module, name)
        monkeypatch.setattr(module, name, functools.partial(
            lambda target, name, *a, **kw: calls[name].append(kw) or target(*a, **kw),
            target, name))
    tr = cli_train.train(path, os.path.join(root, "mel_outputs"), device="cpu")
    want = {"n_mels": 32, "fmin": 0.0, "fmax": 3500.0}
    for name, (kw,) in calls.items():
        assert {k: kw[k] for k in want} == want, (name, kw)
        assert kw["eig_method"] == "power", name
    exp = os.path.join(root, "mel_outputs", "crossval", "foa", "melspeciv", "melspeciv")
    scaler = np.load(os.path.join(exp, "models", "feature_scaler.npz"))
    assert scaler["mean"].shape == (7, 1, 32)
    assert tr._floor_ck is None and "tracker_checkpoints" not in tr.setup_seconds
    assert np.isfinite(tr.step_losses).all()
    assert os.path.isfile(os.path.join(exp, "models", "best", "best.msgpack"))
