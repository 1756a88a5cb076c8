"""The port's serving and scoring CLIs against salsa_tpu's on one trained-format
experiment: a salsa_tpu experiment directory (YAML config, msgpack checkpoint
with its sidecar, feature_scaler.npz) made without training, served over the same
wavs by `salsa_tpu.cli.predict.predict` and `salsa_tpu_torch.cli.predict.predict
(device="cpu")` for reg_xyz and accdoa, then scored by both packages' evaluate.
Also the CLI's refusals, and the extraction bench's checksum against salsa_tpu's
extractor."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import salsa_tpu.cli.predict as jpredict_mod  # noqa: E402
import salsa_tpu_torch.cli.predict as tpredict_mod  # noqa: E402
from salsa_tpu.cli.evaluate import evaluate_seld as j_evaluate_seld  # noqa: E402
from salsa_tpu.features.salsa import SalsaParams as JSalsaParams  # noqa: E402
from salsa_tpu.features.salsa import extract_salsa as j_extract_salsa  # noqa: E402
from salsa_tpu.models.seld import build_model as j_build_model  # noqa: E402
from salsa_tpu.train import checkpoint as jckpt  # noqa: E402
from salsa_tpu.train.state import create_train_state, make_optimizer  # noqa: E402
from salsa_tpu.utils.audio_io import write_wav  # noqa: E402
from salsa_tpu_torch.cli.evaluate import evaluate_seld  # noqa: E402
from salsa_tpu_torch.scripts import bench_extract  # noqa: E402
from tests.test_torch_models import flax_init  # noqa: E402

FS = 24000
N_CLASSES = 3
ENC = {"name": "PannResNet22", "n_input_channels": 7}
DEC = {"name": "SeldDecoder", "decoder_type": "gru", "decoder_size": 32, "freq_pool": "avg"}
# near the median event probability of each head, so CSV rows fall on both sides
SED_THRESHOLD = {"reg_xyz": 0.48, "accdoa": 0.5}
NEAR = 2e-2  # rows whose salsa_tpu probability lies this close to the threshold may flip
# (name, seconds, sample rate): the 48 kHz clip resamples to 1.6 s and joins that
# group, so each package serves a group of 3 clips and one of 1
SCENES = (("clip_a", 1.6, FS), ("clip_b", 1.6, FS), ("clip_c", 2.0, FS), ("clip_d", 1.6, 48000))


def _config(tmp, output_format, **extra):
    cfg = {"name": "exp", "feature_root_dir": None, "feature_type": "salsa",
           "gt_meta_root_dir": str(tmp / "task3"), "split_meta_dir": None, "seed": 1,
           "mode": "crossval",
           "data": {"fs": FS, "n_fft": 512, "hop_len": 300, "audio_format": "foa",
                    "label_rate": 10, "n_classes": N_CLASSES, "output_format": output_format},
           "model": {"encoder": dict(ENC), "decoder": dict(DEC)},
           "training": {"optimizer": "adam",
                        "lr_scheduler": {"milestones": [0.0, 0.1, 1.0],
                                         "lrs": [3.0e-4, 3.0e-4, 1.0e-4]}},
           "sed_threshold": SED_THRESHOLD[output_format], "doa_threshold": 20,
           "eval_version": "2021"}
    for key, value in extra.items():
        node = cfg
        *path, last = key.split(".")
        for p in path:
            node = node[p]
        node[last] = value
    return yaml.safe_dump(cfg, sort_keys=False)


def _write_config(tmp, sub, output_format="reg_xyz", **extra):
    """<tmp>/<sub>/exp.yml: every config named exp.yml is the same experiment."""
    d = tmp / sub
    d.mkdir(exist_ok=True)
    (d / "exp.yml").write_text(_config(tmp, output_format, **extra))
    return str(d / "exp.yml")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The experiment as salsa_tpu training leaves it, made without training: a
    perturbed flax init saved by salsa_tpu's save_checkpoint from a TrainState
    (Adam included), the scaler, the wavs and their ground truth."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(20261017)
    wav_dir, gt_dir = tmp / "wavs", tmp / "task3" / "metadata_dev"
    wav_dir.mkdir()
    gt_dir.mkdir(parents=True)
    for i, (name, seconds, fs) in enumerate(SCENES):
        n = int(round(seconds * fs))
        t = np.arange(n) / fs
        azi, ele = rng.uniform(-np.pi, np.pi), rng.uniform(-0.5, 0.5)
        gains = np.array([1.0, np.sin(azi) * np.cos(ele), np.sin(ele), np.cos(azi) * np.cos(ele)])
        burst = (t > 0.2 * seconds) & (t < 0.8 * seconds)
        audio = 0.05 * rng.standard_normal((4, n)) + 0.5 * gains[:, None] * (
            np.sin(2 * np.pi * rng.uniform(300, 3000) * t) * burst)[None]
        write_wav(str(wav_dir / f"{name}.wav"), audio.astype(np.float32), fs, bits=16)
        rows = [f"{f},{i % N_CLASSES},0,{round(np.degrees(azi))},{round(np.degrees(ele))}"
                for f in range(int(seconds * 10)) if 0.2 * seconds < f / 10 < 0.8 * seconds]
        (gt_dir / f"{name}.csv").write_text("\n".join(rows) + "\n")

    model = j_build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES)
    x = np.zeros((1, 7, 129, 200), np.float32)
    params, stats = flax_init(rng, model, x, seed=7)
    state = create_train_state(model, jnp.asarray(x), make_optimizer(1))
    state = state.replace(step=3, params=params, batch_stats=stats)
    models = tmp / "outputs" / "crossval" / "foa" / "salsa" / "exp" / "models"
    jckpt.save_checkpoint(str(models / "best"), "epoch003", state, {"valSeld": 0.5})
    np.savez(str(models / "feature_scaler.npz"),
             mean=rng.normal(-5.0, 1.0, (4, 1, 200)).astype(np.float32),
             std=rng.uniform(5.0, 8.0, (4, 1, 200)).astype(np.float32))
    return tmp


def _recording(module, calls):
    """`module.SeldInferencePipeline` with every call's (event_prob, doa) recorded."""
    base = module.SeldInferencePipeline

    class Recording(base):
        def __call__(self, waves):
            out = super().__call__(waves)
            calls.append(out)
            return out

    return Recording


@pytest.fixture(scope="module")
def runs(workspace):
    """{output_format: {"jax"|"port": (out_dir, [(event_prob, doa) per group])}}."""
    out = {}
    for fmt in ("reg_xyz", "accdoa"):
        config = _write_config(workspace, fmt, fmt)
        out[fmt] = {}
        for side, module, kw in (("jax", jpredict_mod, {}), ("port", tpredict_mod,
                                                             {"device": "cpu"})):
            calls = []
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(module, "SeldInferencePipeline", _recording(module, calls))
                out_dir = module.predict(config, str(workspace / "wavs"),
                                         str(workspace / f"preds_{fmt}_{side}"),
                                         exp_group_dir=str(workspace / "outputs"), **kw)
            out[fmt][side] = (out_dir, calls)
    return out


def _csv_rows(path):
    rows = {}
    for line in open(path).read().splitlines():
        f, c, _, a, e = map(int, line.split(","))
        rows[(f, c)] = (a, e)
    return rows


@pytest.mark.parametrize("fmt", ["reg_xyz", "accdoa"])
def test_predict_matches_salsa_tpu(runs, fmt):
    (j_dir, j_calls), (t_dir, t_calls) = runs[fmt]["jax"], runs[fmt]["port"]
    names = sorted(os.listdir(j_dir))
    assert names == sorted(os.listdir(t_dir)) == sorted(f"{n}.csv" for n, _, _ in SCENES)
    # both grouped the clips the same way: 3 clips of 1.6 s, then the 2.0 s clip
    assert [ev.shape for ev, _ in j_calls] == [ev.shape for ev, _ in t_calls] == [
        (3, 16, N_CLASSES), (1, 20, N_CLASSES)]
    for (ev_j, doa_j), (ev_t, doa_t) in zip(j_calls, t_calls):
        # salsa_tpu serves on the CPU through its XLA power iteration (4 squarings),
        # the port through K1's plain version (3, as the Pallas kernel), so a spatial
        # cell may flip its coherence test: test_slice_matches_jax_pipeline's bound
        # (measured here: CHANGES.md)
        for got, want in ((ev_t, ev_j), (doa_t, doa_j)):
            err = np.abs(got - want)
            assert np.mean(err <= 2e-3) >= 0.999 and err.max() <= 2e-2, err.max()
    j_prob = {n[:-4]: ev for n, ev in zip(
        ["clip_a.csv", "clip_b.csv", "clip_d.csv", "clip_c.csv"],
        [e for ev, _ in j_calls for e in ev])}
    compared = 0
    for name in names:
        got, want = _csv_rows(os.path.join(t_dir, name)), _csv_rows(os.path.join(j_dir, name))
        prob = j_prob[name[:-4]]
        for key in set(got) ^ set(want):  # a row in one CSV only
            assert abs(prob[key] - SED_THRESHOLD[fmt]) <= NEAR, (name, key, prob[key])
        for key in set(got) & set(want):
            (ga, ge), (wa, we) = got[key], want[key]
            da = min(abs(ga - wa), 360 - abs(ga - wa))  # azimuth wraps at +-180
            assert da <= 1 and abs(ge - we) <= 1, (name, key, got[key], want[key])
            compared += 1
    assert compared >= 100 and compared < sum(e.size for e, _ in j_calls), compared


@pytest.mark.parametrize("fmt", ["reg_xyz", "accdoa"])
def test_scores_equal_across_packages(runs, workspace, fmt):
    root = str(workspace / "task3")
    for side in ("jax", "port"):
        out_dir = runs[fmt][side][0]
        want = j_evaluate_seld(out_dir, root, n_classes=N_CLASSES)
        assert evaluate_seld(out_dir, root, n_classes=N_CLASSES) == want
        assert all(np.isfinite(v) for v in want.values())


def test_use_tuned_threshold(workspace, tmp_path):
    """--use-tuned-threshold serves at the sidecar's threshold: the CSVs equal those
    of a config that names it; without the sidecar it fails, naming the fix."""
    config = _write_config(workspace, "reg_xyz")
    wavs, group = str(workspace / "wavs"), str(workspace / "outputs")
    with pytest.raises(FileNotFoundError, match="tune-threshold"):
        tpredict_mod.predict(config, wavs, str(tmp_path / "nope"), group,
                             exp_suffix="_untuned", use_tuned_threshold=True, device="cpu")
    sidecar = workspace / "outputs" / "crossval" / "foa" / "salsa" / "exp" / "models" / \
        "tuned_threshold.json"
    sidecar.write_text(json.dumps({"sed_threshold": 0.45, "tuned_on": "val"}))
    try:
        tuned = tpredict_mod.predict(config, wavs, str(tmp_path / "tuned"), group,
                                     use_tuned_threshold=True, device="cpu")
    finally:
        sidecar.unlink()
    fixed = tpredict_mod.predict(_write_config(tmp_path, "fixed", sed_threshold=0.45), wavs,
                                 str(tmp_path / "fixed_out"), group, device="cpu")
    for name in os.listdir(tuned):
        with open(os.path.join(tuned, name)) as a, open(os.path.join(fixed, name)) as b:
            assert a.read() == b.read(), name


def test_refusals(workspace, tmp_path):
    wavs, group = str(workspace / "wavs"), str(workspace / "outputs")
    out = str(tmp_path / "out")
    # same tree, another network: never served as PannResNet22
    tpu = _write_config(tmp_path, "tpu", **{"model.encoder.name": "PannResNet22TPU"})
    with pytest.raises(NotImplementedError, match="PannResNet22TPU"):
        tpredict_mod.predict(tpu, wavs, out, group, device="cpu")
    # salsa_tpu would serve the feature store's h5 scaler ahead of the npz
    features = tmp_path / "features"
    features.mkdir()
    (features / "foa_feature_scaler.h5").write_bytes(b"\x89HDF\r\n\x1a\n")
    h5 = _write_config(tmp_path, "h5", feature_root_dir=str(features))
    with pytest.raises(ValueError, match="feature_scaler.npz"):
        tpredict_mod.predict(h5, wavs, out, group, device="cpu")
    config = _write_config(workspace, "reg_xyz")
    for flags in (["--streaming"], ["--pool"], ["--pcm16"], ["--max-lag-ms", "400"]):
        with pytest.raises(NotImplementedError, match="item 9"):
            tpredict_mod.main(["--exp-config", config, "--wav-dir", wavs, "--out-dir", out,
                               "--exp-group-dir", group, *flags])
    with pytest.raises(FileNotFoundError, match="train first"):
        tpredict_mod.predict(config, wavs, out, group, exp_suffix="_empty", device="cpu")
    with pytest.raises(FileNotFoundError, match="train first"):  # no checkpoint/ files
        tpredict_mod.predict(config, wavs, out, group, checkpoint_kind="last", device="cpu")
    empty = tmp_path / "no_wavs"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no wavs"):
        tpredict_mod.predict(config, str(empty), out, group, device="cpu")
    with pytest.raises(SystemExit):  # the CLI reports user errors in one line, exit 2
        tpredict_mod.main(["--exp-config", config, "--wav-dir", str(empty), "--out-dir", out,
                           "--exp-group-dir", group])


def test_predict_defaults_to_the_card(workspace, tmp_path):
    """Without `device` the CLI serves on the first CUDA card; on a host without one
    it raises (which error is torch's own) instead of serving on the CPU."""
    config = _write_config(workspace, "reg_xyz")
    args = (config, str(workspace / "wavs"), str(tmp_path / "out"), str(workspace / "outputs"))
    if torch.cuda.is_available():
        out = tpredict_mod.predict(*args)
        assert len(os.listdir(out)) == len(SCENES)
    else:
        with pytest.raises(Exception) as err:
            tpredict_mod.predict(*args)
        assert "cuda" in str(err.value).lower() or "nvidia" in str(err.value).lower()
        assert not os.path.exists(tmp_path / "out")


def test_bench_extract_checksum_matches_salsa_tpu():
    """bench.py's workload at 2 clips x 2 s: the port's checksum against
    salsa_tpu's extractor on its Pallas path (interpret mode on the CPU); the two
    sums over 2 x 7 x 161 x 200 features differ by 3.9e-7 of their size."""
    waves = bench_extract.make_waves(2, 2.0)
    assert waves.shape == (2, 4, 48000) and waves.dtype == np.float32
    got = bench_extract.extract_checksum(torch.from_numpy(waves))
    p = JSalsaParams(fs=FS, n_fft=512, hop_length=300, fmax_doa=9000.0, audio_format="foa",
                     eig_method="pallas")
    want = float(jnp.sum(jax.vmap(lambda w: j_extract_salsa(w, p))(jnp.asarray(waves))))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_bench_extract_needs_the_card():
    if torch.cuda.is_available():
        out = bench_extract.main()
        assert out["metric"] == "salsa_foa_extraction_throughput" and out["value"] > 0
    else:
        with pytest.raises(SystemExit, match="CUDA|cuda"):
            bench_extract.main()


def test_experiment_config_is_read_as_salsa_tpu_reads_it(workspace):
    from salsa_tpu.utils.config import load_config as j_load_config
    from salsa_tpu_torch.utils.config import load_config

    config = _write_config(workspace, "reg_xyz")
    assert load_config(config).to_dict() == j_load_config(config).to_dict()
