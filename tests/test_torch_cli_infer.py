"""`salsa_tpu_torch.cli.infer` against `salsa_tpu.cli.infer` on the CPU: one
from-wav experiment trained by `salsa_tpu`'s `cli.train`, inferred by both
packages, plain and with `--tta`, for reg_xyz and accdoa (one set of weights: the
output format only reads the heads differently). The prediction dumps (`.h5` and
`.npz`), the CSVs and the scores agree at the bounds of
`test_torch_cli.py::test_predict_matches_salsa_tpu`; on identical features the TTA'd
predictions agree within atol 5e-4 / rtol 1e-3 and `--tune-threshold` picks
`salsa_tpu`'s threshold; fused TTA equals sequential TTA within 1e-6; every refusal
holds.

salsa_tpu extracts through its XLA power iteration (4 squarings) and the port
through K1's plain version (3), so a spatial cell may flip its coherence test:
hence the first bound. Val holds a 1.5 s clip of 2 chunks, a 2 s clip of 3 and a
0.7 s clip padded to one chunk, so the chunk recombination and the padded label
rows of the dumps' ground truth are both on the path."""
import functools
import os
import re
import shutil

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import salsa_tpu.cli.infer as jinfer  # noqa: E402
import salsa_tpu.data.wav_database as jwav  # noqa: E402
import salsa_tpu.features.registry as jregistry  # noqa: E402
import salsa_tpu_torch.cli.infer as tinfer  # noqa: E402
from salsa_tpu.cli.train import train as j_train  # noqa: E402
from salsa_tpu.utils.audio_io import write_wav  # noqa: E402
from salsa_tpu_torch.data import wav_database as twav  # noqa: E402
from salsa_tpu_torch.train.trainer import SeldPredictor  # noqa: E402
from tests.test_from_wav import _synth_wave_8k  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this file, beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


FS, N_CLASSES = 8000, 3
TRAIN = ("tr_a", "tr_b", "tr_c")
VAL = {"va_a": 1.5, "va_b": 2.0, "va_c": 0.7}  # seconds: 2, 3 and 1 (padded) chunks
# near the median event probability of each head, so CSV rows fall on both sides
SED_THRESHOLD = {"reg_xyz": 0.47, "accdoa": 0.3}
NEAR = 2e-2  # rows whose salsa_tpu probability lies this close to the threshold may flip


def _config(root, output_format="reg_xyz", **training):
    return {
        "name": "exp", "feature_root_dir": None, "feature_type": "salsa",
        "gt_meta_root_dir": root, "split_meta_dir": os.path.join(root, "meta"), "seed": 5,
        "mode": "crossval",
        "data": {"fs": FS, "n_fft": 256, "hop_len": 100, "audio_format": "foa",
                 "label_rate": 10, "train_chunk_len_s": 0.8, "train_chunk_hop_len_s": 0.8,
                 "test_chunk_len_s": 1.0, "test_chunk_hop_len_s": 0.5, "n_classes": N_CLASSES,
                 "fmax_doa": 3000.0, "max_file_len_s": 2.0, "output_format": output_format},
        "model": {"encoder": {"name": "PannResNet22", "n_input_channels": 7},
                  "decoder": {"name": "SeldDecoder", "decoder_type": "bigru",
                              "decoder_size": 32}},
        "training": {"from_wav": True, "train_batch_size": 2, "max_epochs": 1,
                     "val_interval": 1, "optimizer": "adam",
                     "lr_scheduler": {"milestones": [0.0, 1.0], "lrs": [3.0e-3, 3.0e-3],
                                      "moms": [0.9, 0.9]}, **training},
        "sed_threshold": SED_THRESHOLD[output_format], "doa_threshold": 20,
        "eval_version": "2021",
    }


def _write_config(root, sub, output_format="reg_xyz", edit=None, **training):
    """<root>/<sub>/exp.yml: every config named exp.yml is the same experiment."""
    cfg = _config(root, output_format, **training)
    if edit:
        edit(cfg)
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    path = os.path.join(root, sub, "exp.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """The corpus (8 kHz FOA wavs with DCASE metadata) and the experiment
    salsa_tpu's cli.train leaves (1 epoch, from wav)."""
    root = str(tmp_path_factory.mktemp("torch_cli_infer"))
    rng = np.random.default_rng(20261017)
    for sub in ("foa_dev", "metadata_dev", "meta"):
        os.makedirs(os.path.join(root, sub))
    clips = {**{n: 2.0 for n in TRAIN}, **VAL}
    for i, (name, seconds) in enumerate(clips.items()):
        write_wav(os.path.join(root, "foa_dev", name + ".wav"), _synth_wave_8k(rng, seconds),
                  FS, bits=16)
        rows = [f"{f},{(f + i) % N_CLASSES},0,{(f * 11) % 360 - 180},{(f * 5) % 60 - 30}"
                for f in range(2, int(seconds * 10) - 2)]
        with open(os.path.join(root, "metadata_dev", name + ".csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    for split, names in (("train", TRAIN), ("val", tuple(VAL))):
        with open(os.path.join(root, "meta", f"{split}.csv"), "w") as f:
            f.write("filename\n" + "\n".join(names))
    config = _write_config(root, "reg_xyz")
    group = os.path.join(root, "outputs")
    j_train(config, group)
    exp = os.path.join(group, "crossval", "foa", "salsa", "exp")
    yield {"root": root, "group": group, "exp": exp,
           "config": {fmt: _write_config(root, fmt, fmt) for fmt in SED_THRESHOLD}}
    shutil.rmtree(root)  # full-width checkpoints: pytest keeps its last temp trees


def _infer(experiment, side, config, out, **kw):
    """One package's inference of val; its CSVs, dumps and tuned sidecar moved to
    `out` (both packages write into the same experiment tree). Returns (results,
    out)."""
    if side == "jax":
        res = jinfer.inference(config, experiment["group"], splits=["val"], **kw)
    else:
        res = tinfer.inference(config, experiment["group"], splits=["val"], device="cpu", **kw)
    outputs = os.path.join(experiment["exp"], "outputs")
    for what, sub in (("csv", "submissions"), ("pred", "predictions")):
        shutil.move(os.path.join(outputs, sub, "val"), os.path.join(out, what))
    sidecar = os.path.join(experiment["exp"], "models", "tuned_threshold.json")
    if os.path.isfile(sidecar):
        shutil.move(sidecar, os.path.join(out, "tuned_threshold.json"))
    return res, str(out)


def _dumps(pred_dir):
    """{clip: {array name: array}} of a dump directory, .h5 or .npz."""
    out = {}
    for fn in sorted(os.listdir(pred_dir)):
        name, ext = os.path.splitext(fn)
        if ext == ".npz":
            with np.load(os.path.join(pred_dir, fn)) as blob:
                out[name] = dict(blob)
        else:
            with h5py.File(os.path.join(pred_dir, fn), "r") as hf:
                out[name] = {k: np.asarray(hf[k]) for k in hf}
    return out


def _fold_sizes(mp, sizes):
    """Record the batch size of every SeldPredictor.eval_step call."""
    step = SeldPredictor.eval_step

    def recording(self, x):
        sizes.append(x.shape[0])
        return step(self, x)

    mp.setattr(SeldPredictor, "eval_step", recording)


@pytest.fixture(scope="module")
def runs(experiment, tmp_path_factory):
    """{(fmt, tta): {"jax"|"port": (results, out_dir)}}, and under "sizes" the batch
    size of every eval dispatch of the port's runs."""
    tmp = tmp_path_factory.mktemp("infer_runs")
    out = {"sizes": {}}
    for fmt in SED_THRESHOLD:
        for tta in (False, True):
            out[fmt, tta] = {"jax": _infer(experiment, "jax", experiment["config"][fmt],
                                           tmp / f"{fmt}_{tta}_jax", use_tta=tta)}
            sizes = out["sizes"][fmt, tta] = []
            with pytest.MonkeyPatch.context() as mp:
                _fold_sizes(mp, sizes)
                out[fmt, tta]["port"] = _infer(experiment, "port", experiment["config"][fmt],
                                               tmp / f"{fmt}_{tta}_port", use_tta=tta)
    return out


def _csv_rows(path):
    rows = {}
    for line in open(path).read().splitlines():
        f, c, _, a, e = map(int, line.split(","))
        rows[(f, c)] = (a, e)
    return rows


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("fmt", ["reg_xyz", "accdoa"])
def test_infer_matches_salsa_tpu(runs, fmt, tta):
    (j_res, j_dir), (t_res, t_dir) = runs[fmt, tta]["jax"], runs[fmt, tta]["port"]
    assert sorted(os.listdir(os.path.join(t_dir, "pred"))) == [f"{n}.npz" for n in sorted(VAL)]
    want, got = _dumps(os.path.join(j_dir, "pred")), _dumps(os.path.join(t_dir, "pred"))
    assert list(got) == list(want) == sorted(VAL)
    for name, seconds in VAL.items():
        g, w = got[name], want[name]
        assert {k: v.shape for k, v in g.items()} == {k: v.shape for k, v in w.items()}
        assert g["event_frame_pred"].shape == (1, round(seconds * 10), N_CLASSES)
        assert all(v.dtype == np.float32 for v in g.values())
        # the ground-truth slices: the same label rows, the padded clip's included
        for k in ("event_frame_gt", "doa_frame_gt"):
            np.testing.assert_array_equal(g[k], w[k])
        assert g["event_frame_gt"].any()
        for k in ("event_frame_pred", "doa_frame_pred"):
            err = np.abs(g[k] - w[k])
            assert np.mean(err <= 2e-3) >= 0.999 and err.max() <= 2e-2, (name, k, err.max())
    compared = total = 0
    for name in sorted(VAL):
        fn = f"{name}.csv"
        g_rows = _csv_rows(os.path.join(t_dir, "csv", fn))
        w_rows = _csv_rows(os.path.join(j_dir, "csv", fn))
        prob = want[name]["event_frame_pred"][0]
        for key in set(g_rows) ^ set(w_rows):  # a row in one CSV only
            assert abs(prob[key] - SED_THRESHOLD[fmt]) <= NEAR, (name, key, prob[key])
        for key in set(g_rows) & set(w_rows):
            (ga, ge), (wa, we) = g_rows[key], w_rows[key]
            assert min(abs(ga - wa), 360 - abs(ga - wa)) <= 1 and abs(ge - we) <= 1, key
            compared += 1
        total += prob.size
    assert 0 < compared < total, compared
    for k in ("ER", "F1", "LE", "LR", "seld_error"):
        assert np.isfinite(t_res["val"][k])
        assert abs(t_res["val"][k] - j_res["val"][k]) <= (5.0 if k == "LE" else 0.1), k


def test_tta_changes_the_predictions(runs):
    for fmt in SED_THRESHOLD:
        plain = _dumps(os.path.join(runs[fmt, False]["port"][1], "pred"))
        tta = _dumps(os.path.join(runs[fmt, True]["port"][1], "pred"))
        assert any(not np.allclose(plain[n]["doa_frame_pred"], tta[n]["doa_frame_pred"],
                                   atol=1e-3) for n in VAL), fmt


def _port_features_to_salsa_tpu(experiment):
    """salsa_tpu's extract_split_to_store, extracting with the port's extractor of
    the same experiment: both packages then predict from identical features."""
    from salsa_tpu_torch.cli.predict import feature_kwargs
    from salsa_tpu_torch.features.registry import make_extractor
    from salsa_tpu_torch.utils.config import load_config

    cfg = load_config(experiment["config"]["reg_xyz"])
    ex = make_extractor("salsa", "foa", **feature_kwargs(cfg))

    def extract(extractor, names, audio_dir, fs, scaler, batch_size=8):
        store = twav.extract_split_to_store(ex, names, audio_dir, fs, scaler, device="cpu")
        return jwav.MemoryFeatureStore(store._clips, scaler)

    return extract


@pytest.fixture(scope="module")
def same_features(experiment, tmp_path_factory):
    """{fmt: {"jax"|"port": (results, out_dir)}}: --tta --tune-threshold, salsa_tpu
    on the port's features."""
    tmp = tmp_path_factory.mktemp("infer_same")
    out = {}
    for fmt in SED_THRESHOLD:
        out[fmt] = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jwav, "extract_split_to_store", _port_features_to_salsa_tpu(experiment))
            out[fmt]["jax"] = _infer(experiment, "jax", experiment["config"][fmt],
                                     tmp / f"{fmt}_jax", use_tta=True, tune_threshold=True)
        out[fmt]["port"] = _infer(experiment, "port", experiment["config"][fmt],
                                  tmp / f"{fmt}_port", use_tta=True, tune_threshold=True)
    return out


@pytest.mark.parametrize("fmt", ["reg_xyz", "accdoa"])
def test_tta_on_identical_features_within_model_bound(same_features, fmt):
    """test_torch_models.py's bound for the CRNN of two frameworks, through every
    variant, the inverse maps and the mean."""
    want = _dumps(os.path.join(same_features[fmt]["jax"][1], "pred"))
    got = _dumps(os.path.join(same_features[fmt]["port"][1], "pred"))
    for name in VAL:
        for k in want[name]:
            np.testing.assert_allclose(got[name][k], want[name][k], atol=5e-4, rtol=1e-3,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("fmt", ["reg_xyz", "accdoa"])
def test_tune_threshold_picks_salsa_tpus(same_features, fmt):
    """The sidecar's threshold equals salsa_tpu's, the sweep's rows agree, both
    packages read it, and val's CSVs are the dumps thresholded at it."""
    from salsa_tpu.train.threshold import load_tuned_threshold as j_load
    from salsa_tpu_torch.train.ensemble import ensemble_predictions, write_ensemble
    from salsa_tpu_torch.train.threshold import load_tuned_threshold as t_load

    (j_res, j_dir), (t_res, t_dir) = same_features[fmt]["jax"], same_features[fmt]["port"]
    assert t_res["tuned_threshold"] == j_res["tuned_threshold"]
    assert [r["threshold"] for r in t_res["threshold_sweep"]["rows"]] == [
        r["threshold"] for r in j_res["threshold_sweep"]["rows"]]
    for g, w in zip(t_res["threshold_sweep"]["rows"], j_res["threshold_sweep"]["rows"]):
        assert abs(g["seld"] - w["seld"]) <= 0.05, (g, w)
    fake_best = os.path.join(t_dir, "best")  # the sidecar sits beside models/best
    assert t_load(fake_best) == j_load(fake_best) == t_res["tuned_threshold"]
    rewritten = os.path.join(t_dir, "rewritten")
    write_ensemble(ensemble_predictions([os.path.join(t_dir, "pred")]), rewritten, N_CLASSES,
                   sed_threshold=t_res["tuned_threshold"])
    for fn in os.listdir(rewritten):
        assert open(os.path.join(rewritten, fn)).read() == open(
            os.path.join(t_dir, "csv", fn)).read()


@pytest.mark.parametrize("fmt", ["reg_xyz", "accdoa"])
def test_fused_tta_equals_sequential(experiment, runs, tmp_path, fmt):
    """All 16 variants in one dispatch (the default budget) against one variant a
    dispatch (training.tta_elements_per_dispatch: 1): within 1e-6."""
    config = _write_config(experiment["root"], f"fold1_{fmt}", fmt,
                           tta_elements_per_dispatch=1)
    sizes = []
    with pytest.MonkeyPatch.context() as mp:
        _fold_sizes(mp, sizes)
        _, seq_dir = _infer(experiment, "port", config, tmp_path / "seq", use_tta=True)
    assert sizes == [6] * 16  # one batch of the split's 6 chunks a variant
    assert runs["sizes"][fmt, True] == [96] and runs["sizes"][fmt, False] == [6]
    fused = _dumps(os.path.join(runs[fmt, True]["port"][1], "pred"))
    seq = _dumps(os.path.join(seq_dir, "pred"))
    for name in VAL:
        for k in ("event_frame_pred", "doa_frame_pred"):
            np.testing.assert_allclose(seq[name][k], fused[name][k], atol=1e-6, rtol=0)


def test_checkpoint_last_and_use_tuned_threshold(experiment, runs, tmp_path, capsys):
    """--checkpoint last restores the epoch checkpoint (one epoch: best's weights,
    so the same CSVs); --use-tuned-threshold applies the sidecar, and fails
    without one."""
    res, out = _infer(experiment, "port", experiment["config"]["reg_xyz"], tmp_path / "last",
                      checkpoint_kind="last")
    restored = re.findall(r"restored (\S+)", capsys.readouterr().out)
    assert restored == [os.path.join(experiment["exp"], "models", "checkpoint",
                                     "epoch000.msgpack")]
    plain = runs["reg_xyz", False]["port"][1]
    for fn in os.listdir(os.path.join(plain, "csv")):
        assert open(os.path.join(out, "csv", fn)).read() == open(
            os.path.join(plain, "csv", fn)).read()
    assert res["val"] == runs["reg_xyz", False]["port"][0]["val"]

    with pytest.raises(FileNotFoundError, match="tune-threshold"):
        tinfer.inference(experiment["config"]["reg_xyz"], experiment["group"], splits=["val"],
                         use_tuned_threshold=True, device="cpu")
    sidecar = os.path.join(experiment["exp"], "models", "tuned_threshold.json")
    with open(sidecar, "w") as f:
        f.write('{"sed_threshold": 0.45, "tuned_on": "val"}')
    try:
        _, tuned = _infer(experiment, "port", experiment["config"]["reg_xyz"],
                          tmp_path / "tuned", use_tuned_threshold=True)
    finally:
        if os.path.isfile(sidecar):
            os.remove(sidecar)
    fixed = _write_config(experiment["root"], "fixed", edit=lambda c: c.update(
        sed_threshold=0.45))
    _, fixed_out = _infer(experiment, "port", fixed, tmp_path / "fixed")
    for fn in os.listdir(os.path.join(fixed_out, "csv")):
        assert open(os.path.join(tuned, "csv", fn)).read() == open(
            os.path.join(fixed_out, "csv", fn)).read()


def test_infer_refusals(experiment):
    root, group = experiment["root"], experiment["group"]

    def port(config, **kw):
        return tinfer.inference(config, group, splits=["val"], **{"device": "cpu", **kw})

    # an experiment that trained from a store infers from it: without one, there
    # is no scaler to read
    with pytest.raises(FileNotFoundError, match="feature_scaler"):
        port(_write_config(root, "no_wav", edit=lambda c: c.update(
            feature_root_dir=os.path.join(root, "no_store")), from_wav=False))
    with pytest.raises(FileNotFoundError, match="train first"):
        tinfer.inference(experiment["config"]["reg_xyz"], group, "_untrained", splits=["val"],
                         device="cpu")
    with pytest.raises(ValueError, match="7-channel"):
        port(_write_config(root, "four_ch", edit=lambda c: c["model"]["encoder"].update(
            n_input_channels=4)), use_tta=True)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tinfer.inference(experiment["config"]["reg_xyz"], group, splits=["val"])


class _Dropped(Exception):
    pass


def test_infer_passes_the_eig_method(experiment, tmp_path):
    """A model trained on `training.eig_method: eigh` features is inferred on eigh
    features: the port's infer passes the key (cli.predict.feature_kwargs), as
    cli.train passes it. salsa_tpu's infer (salsa_tpu/cli/infer.py:80) drops it
    and extracts with K1's arithmetic (ROADMAP queue 3)."""
    config = _write_config(experiment["root"], "eigh", eig_method="eigh")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinfer, "make_extractor", functools.partial(
            lambda make, *a, **kw: calls.append(kw) or make(*a, **kw), tinfer.make_extractor))
        res, _ = _infer(experiment, "port", config, tmp_path / "eigh")
    ((kwargs,),) = (calls,)
    assert kwargs["eig_method"] == "eigh" and np.isfinite(res["val"]["seld_error"])

    def stop(*args, **kwargs):
        j_calls.append(kwargs)
        raise _Dropped

    j_calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jregistry, "make_extractor", stop)
        with pytest.raises(_Dropped):
            jinfer.inference(config, experiment["group"], splits=["val"])
    assert "eig_method" not in j_calls[0]


def test_main_maps_the_flags(monkeypatch):
    calls = []
    monkeypatch.setattr(tinfer, "inference", lambda *a, **kw: calls.append((a, kw)))
    tinfer.main(["--exp-config", "e.yml", "--exp-group-dir", "g", "--exp-suffix", "_s",
                 "--splits", "val", "eval", "--checkpoint", "last", "--tta",
                 "--tune-threshold"])
    assert calls == [(("e.yml", "g", "_s", ["val", "eval"], "last"),
                      {"use_tta": True, "tune_threshold": True,
                       "use_tuned_threshold": False})]
