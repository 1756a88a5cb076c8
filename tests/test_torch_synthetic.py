"""The port's synthetic corpus (`salsa_tpu_torch.scripts.synthetic_sanity`) against
`scripts/synthetic_sanity.py`'s: from one seed the same wav bytes and DCASE CSVs,
FOA and MIC, 3 clips each; and the experiment config it writes reads back
through the port's YAML reader (and PyYAML) as written."""
import importlib.util
import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from salsa_tpu.utils.audio_io import write_wav as j_write_wav  # noqa: E402
from salsa_tpu_torch.scripts import aug_ablation, synthetic_sanity  # noqa: E402
from salsa_tpu_torch.utils.config import load_config, save_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _original():
    spec = importlib.util.spec_from_file_location(
        "original_synthetic_sanity", os.path.join(REPO, "scripts", "synthetic_sanity.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fmt", ["foa", "mic"])
def test_corpus_equals_the_original_script(tmp_path, fmt):
    orig = _original()
    seed, n = 11, 3
    data_dir, meta_dir = synthetic_sanity.write_corpus(str(tmp_path / "port"), n, seed, fmt)
    rng = np.random.default_rng(seed)
    for i in range(n):
        name = f"synth{i:03d}"
        audio, gt = orig.synth_clip(rng, audio_format=fmt)
        want = str(tmp_path / f"{name}.wav")
        j_write_wav(want, audio, orig.FS, bits=16)
        with open(want, "rb") as f, open(os.path.join(data_dir, f"{fmt}_dev", name + ".wav"),
                                         "rb") as g:
            assert f.read() == g.read(), name
        with open(os.path.join(data_dir, "metadata_dev", name + ".csv")) as f:
            assert f.read() == gt, name
        assert gt.count("\n") > 10  # events with frames
    with open(os.path.join(meta_dir, "val.csv")) as f:
        assert f.read() == "filename\nsynth001\nsynth002"  # the last max(2, n // 6)
    assert synthetic_sanity.CLASS_CARRIERS == orig.CLASS_CARRIERS
    np.testing.assert_array_equal(synthetic_sanity.MIC_DIRS, orig.MIC_DIRS)


@pytest.mark.parametrize("aug", ["full", "feature", "off"])
def test_experiment_config_reads_back(tmp_path, aug):
    """The experiment the port trains: the original's, from wav, bf16 compute on
    the encoder and the decoder, with the arm's device_augment; written by the
    port's writer, read back equal by its reader and by PyYAML."""
    cfg = synthetic_sanity.experiment_config("/d/task3", "/d/meta", "salsa", "foa", 11, 96, aug)
    path = str(tmp_path / "exp.yml")
    save_config(cfg, path)
    assert load_config(path) == cfg
    with open(path) as f:
        assert yaml.safe_load(f) == cfg
    assert cfg["training"]["device_augment"] == {"full": True, "feature": "feature",
                                                 "off": False}[aug]
    assert cfg["training"]["from_wav"]
    assert cfg["model"]["encoder"]["compute_dtype"] == "bfloat16"
    assert cfg["model"]["decoder"]["compute_dtype"] == "bfloat16"
    assert cfg["training"]["val_interval"] == 24 and cfg["data"]["fmax_doa"] == 9000


def test_ablation_arms_run_the_sanity_script(tmp_path, monkeypatch, capsys):
    """aug_ablation runs one synthetic_sanity per arm and seed, in its own work
    directory with the arm's --aug, and prints the original's rows."""
    calls = []
    scores = {"ER": 0.5, "F1": 0.5, "LE": 10.0, "LR": 0.5, "seld_error": 0.3}

    def fake_run(args, device="cuda"):
        calls.append((args.aug, args.seed, args.clips, args.epochs, args.workdir, device))
        return scores

    monkeypatch.setattr(synthetic_sanity, "run", fake_run)
    out = aug_ablation.main(["--clips", "6", "--epochs", "2", "--seeds", "1", "2",
                             "--workroot", str(tmp_path)], device="cpu")
    assert [c[:4] for c in calls] == [(a, s, 6, 2) for s in (1, 2)
                                      for a in ("off", "feature", "full")]
    assert len({c[4] for c in calls}) == 6 and all(c[5] == "cpu" for c in calls)
    assert out["summary"]["full"] == {"seld_mean": 0.3, "seld_sd": 0.0, "le_mean": 10.0, "n": 2}
    assert capsys.readouterr().out.count('"aug_ablation_row"') == 6
