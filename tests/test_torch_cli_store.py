"""The feature-store workflow through both packages' CLIs on the CPU: extract ->
train -> infer -> evaluate -> predict.

`salsa_tpu.cli.extract` writes an `.h5` store of a synthetic 8 kHz FOA corpus and
`salsa_tpu.cli.train` trains an experiment from it (1 epoch); both packages'
`cli.infer` read that store (the port extracts nothing) and predict with the same
weights, so their prediction dumps agree within atol 5e-4 / rtol 1e-3 (the bound
of `tests/test_torch_cli_infer.py` on identical features) and, served at a
threshold away from every probability, their CSV rows are the same and their
scores within 0.02; each package's
`cli.evaluate` prints its infer's scores; both `cli.predict`s serve the wavs with
the store's `.h5` scaler and write the same rows, as
`tests/test_torch_cli_train.py` compares them. Then the port alone runs the chain on its own
`.npy` store."""
import functools
import os
import shutil

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

import salsa_tpu.cli.infer as jinfer  # noqa: E402
import salsa_tpu.cli.predict as jpredict  # noqa: E402
import salsa_tpu_torch.cli.infer as tinfer  # noqa: E402
import salsa_tpu_torch.cli.predict as tpredict  # noqa: E402
from salsa_tpu.cli import extract as jextract  # noqa: E402
from salsa_tpu.cli.evaluate import evaluate_seld as j_evaluate_seld  # noqa: E402
from salsa_tpu.cli.train import train as j_train  # noqa: E402
from salsa_tpu.features.registry import make_extractor as j_make_extractor  # noqa: E402
from salsa_tpu.utils.audio_io import write_wav  # noqa: E402
from salsa_tpu_torch.cli import evaluate as tevaluate  # noqa: E402
from salsa_tpu_torch.cli import extract as textract  # noqa: E402
from salsa_tpu_torch.cli import train as ttrain  # noqa: E402
from salsa_tpu_torch.data.feature_store import FeatureStore  # noqa: E402
from tests.test_torch_cli_infer import _csv_rows, _dumps  # noqa: E402
from tests.test_torch_cli_train import _recording  # noqa: E402
from tests.test_torch_features import scene  # noqa: E402

FS, N_CLASSES = 8000, 3
TRAIN, VAL = ("tr_a", "tr_b", "tr_c", "tr_d"), {"va_a": 2.0, "va_b": 1.5}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(root: str, name: str, feature_root_dir: str, config_dir: str | None = None) -> str:
    """The experiment `name` on the corpus at `root` and the store at
    feature_root_dir, written to <config_dir (default root)>/<name>.yml."""
    cfg = {
        "name": name, "feature_root_dir": feature_root_dir, "feature_type": "salsa",
        "gt_meta_root_dir": root, "split_meta_dir": os.path.join(root, "meta"), "seed": 5,
        "mode": "crossval",
        "data": {"fs": FS, "n_fft": 256, "hop_len": 100, "audio_format": "foa",
                 "label_rate": 10, "train_chunk_len_s": 0.8, "train_chunk_hop_len_s": 0.4,
                 "test_chunk_len_s": 1.0, "test_chunk_hop_len_s": 0.5, "n_classes": N_CLASSES,
                 "fmax_doa": 3000.0, "max_file_len_s": 2.0, "output_format": "reg_xyz"},
        "model": {"encoder": {"name": "PannResNet22", "n_input_channels": 7},
                  "decoder": {"name": "SeldDecoder", "decoder_type": "bigru",
                              "decoder_size": 16}},
        "training": {"train_batch_size": 4, "max_epochs": 1, "val_interval": 1,
                     "optimizer": "adam",
                     "lr_scheduler": {"milestones": [0.0, 1.0], "lrs": [3.0e-3, 3.0e-3],
                                      "moms": [0.9, 0.9]}},
        "sed_threshold": 0.5, "doa_threshold": 20, "eval_version": "2021",
    }
    path = os.path.join(config_dir or root, name + ".yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """The corpus, salsa_tpu's .h5 store and the experiment salsa_tpu's cli.train
    trains from it."""
    root = str(tmp_path_factory.mktemp("torch_cli_store"))
    rng = np.random.default_rng(20261021)
    for sub in ("foa_dev", "metadata_dev", "meta", "val_wavs"):
        os.makedirs(os.path.join(root, sub))
    clips = {**{n: 2.0 for n in TRAIN}, **VAL}
    for i, (name, seconds) in enumerate(clips.items()):
        path = os.path.join(root, "foa_dev", name + ".wav")
        write_wav(path, scene(rng, seconds, "foa", fs=FS), FS, bits=16)
        if name in VAL:
            shutil.copyfile(path, os.path.join(root, "val_wavs", name + ".wav"))
        rows = [f"{f},{(f + i) % N_CLASSES},0,{(f * 11) % 360 - 180},{(f * 5) % 60 - 30}"
                for f in range(2, int(seconds * 10) - 2)]
        with open(os.path.join(root, "metadata_dev", name + ".csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    for split, names in (("train", TRAIN), ("val", tuple(VAL))):
        with open(os.path.join(root, "meta", f"{split}.csv"), "w") as f:
            f.write("filename\n" + "\n".join(names))
    data = os.path.join(root, "data.yml")
    with open(data, "w") as f:
        yaml.safe_dump({"data_dir": root, "feature_dir": os.path.join(root, "jax_features"),
                        "data": {"format": "foa", "fs": FS, "n_fft": 256, "hop_len": 100,
                                 "fmax_doa": 3000}}, f)
    store = jextract.extract_features(data, "salsa", splits=["foa_dev"])
    config = _config(root, "exp", store)
    group = os.path.join(root, "outputs")
    j_train(config, group)
    yield {"root": root, "data": data, "store": store, "config": config, "group": group,
           "exp": os.path.join(group, "crossval", "foa", "salsa", "exp")}
    shutil.rmtree(root)  # full-width checkpoints: pytest keeps its temp trees


def _infer(experiment, side, out, config):
    """One package's inference of val, its CSVs and dumps moved to `out`."""
    if side == "jax":
        res = jinfer.inference(config, experiment["group"], splits=["val"])
    else:
        res = tinfer.inference(config, experiment["group"], splits=["val"], device="cpu")
    outputs = os.path.join(experiment["exp"], "outputs")
    for what, sub in (("csv", "submissions"), ("pred", "predictions")):
        shutil.move(os.path.join(outputs, sub, "val"), os.path.join(out, what))
    return res, str(out)


def _served_at(config: str, probs: np.ndarray, path: str) -> str:
    """The experiment's config (the same name: the same experiment) served at a
    threshold in the widest gap of the middle half of `probs`, so that no
    probability lies near it."""
    probs = np.sort(probs.ravel())
    k = len(probs) // 4 + int(np.argmax(np.diff(probs[len(probs) // 4:3 * len(probs) // 4])))
    with open(config) as f:
        cfg = yaml.safe_load(f)
    cfg["sed_threshold"] = float((probs[k] + probs[k + 1]) / 2)
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


def test_infer_and_evaluate_from_the_store_match_salsa_tpu(experiment, tmp_path, capsys):
    """Both infers read salsa_tpu's store; the port's extracts nothing. Dumps within
    5e-4 / 1e-3; at a threshold away from every probability, the same CSV rows
    (angles within a degree) and scores within 0.02 (LE within 1 degree); each
    package's evaluate gives its infer's scores, and the port's CLI prints them."""
    _, probe = _infer(experiment, "port", tmp_path / "probe", experiment["config"])
    served = _served_at(experiment["config"], np.concatenate(
        [d["event_frame_pred"] for d in _dumps(os.path.join(probe, "pred")).values()],
        axis=None), str(tmp_path / "served" / "exp.yml"))
    j_res, j_dir = _infer(experiment, "jax", tmp_path / "jax", served)
    with pytest.MonkeyPatch.context() as mp:
        def refuse(*a, **kw):
            raise AssertionError("a store-fed infer extracts nothing")

        mp.setattr(tinfer, "extract_split_to_store", refuse)
        mp.setattr(tinfer, "make_extractor", refuse)
        t_res, t_dir = _infer(experiment, "port", tmp_path / "port", served)
    want, got = _dumps(os.path.join(j_dir, "pred")), _dumps(os.path.join(t_dir, "pred"))
    assert list(got) == list(want) == sorted(VAL)
    compared = 0
    for name in sorted(VAL):
        for k in ("event_frame_gt", "doa_frame_gt"):
            np.testing.assert_array_equal(got[name][k], want[name][k])
        for k in ("event_frame_pred", "doa_frame_pred"):
            np.testing.assert_allclose(got[name][k], want[name][k], atol=5e-4, rtol=1e-3,
                                       err_msg=f"{name} {k}")
        g_rows = _csv_rows(os.path.join(t_dir, "csv", name + ".csv"))
        w_rows = _csv_rows(os.path.join(j_dir, "csv", name + ".csv"))
        assert set(g_rows) == set(w_rows), name
        for key, (ga, ge) in g_rows.items():
            wa, we = w_rows[key]
            assert min(abs(ga - wa), 360 - abs(ga - wa)) <= 1 and abs(ge - we) <= 1, key
        compared += len(g_rows)
    assert compared > 0
    for k in ("ER", "F1", "LE", "LR", "seld_error"):
        assert abs(t_res["val"][k] - j_res["val"][k]) <= (1.0 if k == "LE" else 0.02), k
    gt = experiment["root"]
    capsys.readouterr()
    tevaluate.main(["--output-dir", os.path.join(t_dir, "csv"), "--gt-meta-root-dir", gt,
                    "--n-classes", str(N_CLASSES)])
    printed = "".join(capsys.readouterr())
    assert f"SELD error: {t_res['val']['seld_error']:.4f}" in printed, printed
    for res, scores in ((t_res, tevaluate.evaluate_seld(os.path.join(t_dir, "csv"), gt,
                                                        n_classes=N_CLASSES)),
                        (j_res, j_evaluate_seld(os.path.join(j_dir, "csv"), gt,
                                                n_classes=N_CLASSES))):
        for k in ("ER", "F1", "LE", "LR", "seld_error"):
            assert scores[k] == pytest.approx(res["val"][k], abs=1e-12), k


def test_predict_serves_with_the_store_scaler(experiment, tmp_path):
    """Both predicts serve the val wavs with the store's .h5 scaler (the experiment
    has no feature_scaler.npz) and write the same rows, angles within a degree:
    salsa_tpu's extractor on its Pallas eigensolver (K1's arithmetic), the served
    threshold in a gap of the port's probabilities (as
    tests/test_torch_cli_train.py serves), so that no probability lies near it;
    the probabilities within 1e-4."""
    cfg = tpredict.manage_experiments(experiment["config"], experiment["group"], "")
    assert not os.path.exists(os.path.join(experiment["exp"], "models", "feature_scaler.npz"))
    for got, want in zip(tpredict._load_scaler(cfg, "foa"),
                         FeatureStore(experiment["store"], "foa").read_scaler()):
        np.testing.assert_array_equal(got, want)
    wavs, group = os.path.join(experiment["root"], "val_wavs"), experiment["group"]
    calls = {"port": [], "jax": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpredict, "SeldInferencePipeline", _recording(tpredict, calls["port"]))
        tpredict.predict(experiment["config"], wavs, str(tmp_path / "probe"), group,
                         device="cpu")
    probs = np.sort(np.concatenate([ev.ravel() for ev, _ in calls["port"]]))
    k = len(probs) // 4 + int(np.argmax(np.diff(probs[len(probs) // 4:3 * len(probs) // 4])))
    with open(experiment["config"]) as f:
        served_cfg = yaml.safe_load(f)
    served_cfg["sed_threshold"] = float((probs[k] + probs[k + 1]) / 2)
    served = str(tmp_path / "exp.yml")  # the same experiment name, another threshold
    with open(served, "w") as f:
        yaml.safe_dump(served_cfg, f, sort_keys=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpredict, "make_extractor",
                   functools.partial(j_make_extractor, eig_method="pallas"))
        mp.setattr(jpredict, "SeldInferencePipeline", _recording(jpredict, calls["jax"]))
        j_out = jpredict.predict(served, wavs, str(tmp_path / "jax"), group)
    t_out = tpredict.predict(served, wavs, str(tmp_path / "port"), group, device="cpu")
    for (ev_j, doa_j), (ev_t, doa_t) in zip(calls["jax"], calls["port"]):
        np.testing.assert_allclose(ev_t, ev_j, atol=1e-4)
        np.testing.assert_allclose(doa_t, doa_j, atol=1e-4)
    names = sorted(os.listdir(t_out))
    assert names == sorted(os.listdir(j_out)) == sorted(f"{n}.csv" for n in VAL)
    shared = 0
    for fn in names:
        g, w = _csv_rows(os.path.join(t_out, fn)), _csv_rows(os.path.join(j_out, fn))
        assert set(g) == set(w), fn
        for key, (ga, ge) in g.items():
            wa, we = w[key]
            assert min(abs(ga - wa), 360 - abs(ga - wa)) <= 1 and abs(ge - we) <= 1, key
        shared += len(g)
    assert shared > 0


def test_port_chain_on_its_own_store(experiment, tmp_path):
    """The port's extract -> train -> infer -> evaluate -> predict on its own .npy
    store: every artifact written, infer's scores equal evaluate's, one CSV a wav."""
    root = experiment["root"]
    data = os.path.join(str(tmp_path), "data.yml")
    with open(experiment["data"]) as f:
        d = yaml.safe_load(f)
    d["feature_dir"] = str(tmp_path / "features")
    with open(data, "w") as f:
        yaml.safe_dump(d, f)
    store = textract.extract_features(data, "salsa", splits=["foa_dev"], device="cpu")
    assert os.path.relpath(store, str(tmp_path / "features")) == os.path.relpath(
        experiment["store"], os.path.join(root, "jax_features"))
    config = _config(root, "port_exp", store, str(tmp_path))
    group = str(tmp_path / "outputs")
    tr = ttrain.train(config, group, device="cpu")
    exp = os.path.join(group, "crossval", "foa", "salsa", "port_exp")
    for path in ("models/best/best.msgpack", "models/checkpoint/epoch000.msgpack"):
        assert os.path.isfile(os.path.join(exp, path)), path
    assert not os.path.exists(os.path.join(exp, "models", "feature_scaler.npz"))
    assert tr.train_dataset.transform is not None and np.isfinite(tr.step_losses).all()
    res = tinfer.inference(config, group, splits=["val"], device="cpu")
    sub = os.path.join(exp, "outputs", "submissions", "val")
    scores = tevaluate.evaluate_seld(sub, root, n_classes=N_CLASSES)
    assert scores == pytest.approx(res["val"], abs=1e-12)
    out = tpredict.predict(config, os.path.join(root, "val_wavs"), str(tmp_path / "preds"),
                           group, device="cpu")
    assert sorted(os.listdir(out)) == sorted(f"{n}.csv" for n in VAL)
    shutil.rmtree(str(tmp_path))
