"""The port's feature store path on the CPU against `salsa_tpu`'s.

`salsa_tpu_torch.cli.extract` and `salsa_tpu.cli.extract` extract the same 8 kHz
wavs (FOA; the same wavs as MIC for the GCC type) into their stores; the port's
stored features are held to `salsa_tpu`'s at the bounds of
`tests/test_torch_features.py` (SALSA's spatial channels at K1's gate: validity
masks disagreeing on < 0.5 % of cells, atol 5e-3 where both are valid; `salsa_tpu`
on its Pallas eigensolver, K1's arithmetic, in interpret mode). A `salsa_tpu` `.h5`
store reads back through the port bit for bit (tolerance 0), and so does its
scaler refit by the port on those features; lazy windows equal the preloaded
split's bit for bit, a clip shorter than a chunk included; `--keep-existing`
extracts only the missing clips; and the store refuses what it cannot read."""
import logging
import os
import shutil
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from salsa_tpu.cli import extract as jextract  # noqa: E402
from salsa_tpu.data.database import SeldDatabase as JDatabase  # noqa: E402
from salsa_tpu.utils.audio_io import write_wav  # noqa: E402
from salsa_tpu_torch.cli import extract as textract  # noqa: E402
from salsa_tpu_torch.data import feature_store  # noqa: E402
from salsa_tpu_torch.data.database import LazySplitData, SeldDatabase, truncate_clips  # noqa: E402
from salsa_tpu_torch.data.dataset import SeldChunkDataset, batch_iterator  # noqa: E402
from salsa_tpu_torch.data.feature_store import FeatureStore, StreamingScaler  # noqa: E402
from salsa_tpu_torch.features.registry import make_extractor  # noqa: E402
import chip_smoke  # noqa: E402
from tests.test_torch_features import (  # noqa: E402
    array_scene,
    assert_bank_close,
    assert_matches_salsa_tpu,
    assert_spatial_close,
    scene,
)

FS, N_FFT, HOP, N_CLASSES = 8000, 256, 100, 3
# sorted: a and b batch together, c and d (mixed lengths) go clip by clip, then short
CLIPS = {"a": 2.0, "b": 2.0, "c": 2.0, "d": 1.5, "short": 0.5}
GEOMETRY = dict(n_classes=N_CLASSES, fs=FS, hop_len=HOP, label_rate=10,
                train_chunk_len_s=0.8, train_chunk_hop_len_s=0.3, test_chunk_len_s=2.0,
                test_chunk_hop_len_s=2.1, max_file_len_s=2.0)
TYPES = {"salsa": ("foa", {"eig_method": "pallas"}), "salsa_lite": ("foa", {}),
         "linspecgcc": ("mic", {})}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data_config(root: str, fmt: str, feature_dir: str) -> str:
    path = os.path.join(root, f"data_{fmt}_{os.path.basename(feature_dir)}.yml")
    with open(path, "w") as f:
        yaml.safe_dump({"data_dir": root, "feature_dir": feature_dir,
                        "data": {"format": fmt, "fs": FS, "n_fft": N_FFT, "win_len": N_FFT,
                                 "hop_len": HOP, "fmin_doa": 50, "fmax_doa": 3000}}, f)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five FOA scenes (three 2 s, one 1.5 s, one 0.5 s; the same files as MIC),
    DCASE metadata, train/val split files, and each package's extraction of each
    type."""
    root = str(tmp_path_factory.mktemp("torch_store"))
    rng = np.random.default_rng(20261017)
    for sub in ("foa_dev", "mic_dev", "metadata_dev", "meta"):
        os.makedirs(os.path.join(root, sub))
    for i, (name, seconds) in enumerate(CLIPS.items()):
        wave = scene(rng, seconds, "foa", fs=FS)
        for fmt in ("foa", "mic"):
            write_wav(os.path.join(root, f"{fmt}_dev", name + ".wav"), wave, FS, bits=16)
        rows = [f"{f},{(f + i) % N_CLASSES},0,{(f * 13) % 360 - 180},{(f * 7) % 60 - 30}"
                for f in range(1, int(seconds * 10) - 1)]
        with open(os.path.join(root, "metadata_dev", name + ".csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    for split, names in (("train", ["a", "b", "c", "short"]), ("val", ["d"])):
        with open(os.path.join(root, "meta", f"{split}.csv"), "w") as f:
            f.write("filename\n" + "\n".join(names))
    dirs = {}
    for ft, (fmt, kw) in TYPES.items():
        dirs[ft, "port"] = textract.extract_features(
            _data_config(root, fmt, os.path.join(root, "port")), feature_type=ft,
            splits=[f"{fmt}_dev"], batch_size=2, device="cpu")
        dirs[ft, "jax"] = jextract.extract_features(
            _data_config(root, fmt, os.path.join(root, "jax")), feature_type=ft,
            splits=[f"{fmt}_dev"], batch_size=2, **kw)
    yield {"root": root, "dirs": dirs}
    shutil.rmtree(root)


@pytest.mark.parametrize("ft", sorted(TYPES))
def test_extract_matches_salsa_tpu(corpus, ft):
    """The same directory name under each feature_dir, one `.npy` per clip beside
    `salsa_tpu`'s `.h5`, each clip's features at the bounds of the feature tests,
    and the port's scaler the StreamingScaler of its own stored clips."""
    fmt = TYPES[ft][0]
    port, jax_dir = corpus["dirs"][ft, "port"], corpus["dirs"][ft, "jax"]
    assert os.path.relpath(port, os.path.join(corpus["root"], "port")) == os.path.relpath(
        jax_dir, os.path.join(corpus["root"], "jax"))
    assert sorted(os.listdir(port)) == [f"{fmt}_dev", f"{fmt}_feature_scaler.npz"]
    assert sorted(os.listdir(os.path.join(port, f"{fmt}_dev"))) == sorted(
        f"{n}.npy" for n in CLIPS)
    tstore, jstore = FeatureStore(port, fmt), FeatureStore(jax_dir, fmt)
    ex = make_extractor(ft, fmt, fs=FS, n_fft=N_FFT, hop_length=HOP, win_length=N_FFT,
                        fmin_doa=50, fmax_doa=3000)
    scaler = StreamingScaler(ex.n_spec_channels)
    for name in CLIPS:
        got, want = tstore.read_clip("dev", name), jstore.read_clip("dev", name)
        assert got.dtype == np.float32
        assert_matches_salsa_tpu(got, want, ft, ex)
        scaler.update(got)
    for got, want in zip(tstore.read_scaler(), scaler.finalize()):
        np.testing.assert_array_equal(got, want)


def test_batches_do_not_change_a_clip(corpus, tmp_path):
    """A clip's stored features do not depend on the clips batched with it: clip a
    batched with c equals clip a batched with b, bit for bit, and the tail batch is
    not padded (the 0.5 s clip alone at batch 2 equals its solo run)."""
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "foa_dev"))
    for name in ("a", "c", "short"):
        shutil.copyfile(os.path.join(corpus["root"], "foa_dev", name + ".wav"),
                        os.path.join(root, "foa_dev", name + ".wav"))
    out = textract.extract_features(_data_config(root, "foa", os.path.join(root, "features")),
                                    "salsa_lite", batch_size=2, splits=["foa_dev"],
                                    device="cpu")
    partner_c, partner_b = FeatureStore(out, "foa"), FeatureStore(
        corpus["dirs"]["salsa_lite", "port"], "foa")
    for name in ("a", "short"):
        np.testing.assert_array_equal(partner_c.read_clip("dev", name),
                                      partner_b.read_clip("dev", name), err_msg=name)


def test_salsa_tpu_h5_store_reads_bit_equal(corpus, tmp_path):
    """salsa_tpu's .h5 store through the port: every clip and the scaler equal to
    h5py's read, a split loaded by the port's database equal to salsa_tpu's
    (features, targets and tables), and the scaler the port refits from those
    features (`--task scaler`) equal to salsa_tpu's own."""
    jdir = corpus["dirs"]["salsa", "jax"]
    store = FeatureStore(jdir, "foa")
    for name in CLIPS:
        assert store.clip_path("dev", name).endswith(".h5")
        with h5py.File(store.clip_path("dev", name), "r") as hf:
            np.testing.assert_array_equal(store.read_clip("dev", name), hf["feature"][:])
        assert store.clip_shape("dev", name) == store.read_clip("dev", name).shape
    with h5py.File(os.path.join(jdir, "foa_feature_scaler.h5"), "r") as hf:
        j_mean, j_std = hf["mean"][:], hf["std"][:]
    for got, want in zip(store.read_scaler(), (j_mean, j_std)):
        np.testing.assert_array_equal(got, want)
    meta = os.path.join(corpus["root"], "meta")
    for stage in ("fit", "inference"):
        t = SeldDatabase(feature_root_dir=jdir, gt_meta_root_dir=corpus["root"],
                         audio_format="foa", **GEOMETRY).load_split("train", meta, stage)
        j = JDatabase(feature_root_dir=jdir, gt_meta_root_dir=corpus["root"],
                      audio_format="foa", **GEOMETRY).load_split("train", meta, stage)
        for key in ("features", "sed_targets", "doa_targets", "feature_chunk_starts",
                    "label_chunk_starts", "clip_chunk_counts", "clip_label_frames"):
            np.testing.assert_array_equal(getattr(t, key), getattr(j, key), err_msg=key)
        assert t.clip_names == j.clip_names
    # the port refits the scaler over salsa_tpu's stored features
    copy = str(tmp_path / "copy")
    shutil.copytree(jdir, copy)
    cfg = _data_config(corpus["root"], "foa", str(tmp_path / "features"))
    os.makedirs(str(tmp_path / "features" / "salsa" / "foa"))
    shutil.move(copy, str(tmp_path / "features" / "salsa" / "foa" / os.path.basename(jdir)))
    out = textract.extract_features(cfg, "salsa", task="scaler", device="cpu")
    assert sorted(os.listdir(out)) == ["foa_dev", "foa_feature_scaler.npz"]  # h5 replaced
    for got, want in zip(FeatureStore(out, "foa").read_scaler(), (j_mean, j_std)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_lazy_windows_equal_preloaded(corpus, source):
    """Every chunk window of a lazy split (memory-mapped .npy, or .h5) equals the
    preloaded split's bit for bit, the 0.5 s clip's zero-padded window included;
    the tables are equal, a clip-truncated view keeps its windows, and batches read
    on 2 threads equal batches read in order."""
    root = corpus["root"]
    db = SeldDatabase(feature_root_dir=corpus["dirs"]["salsa", source], gt_meta_root_dir=root,
                      audio_format="foa", **GEOMETRY)
    meta = os.path.join(root, "meta")
    for stage in ("fit", "inference"):
        pre = db.load_split("train", meta, stage)
        lazy = db.load_split("train", meta, stage, preload=False)
        assert isinstance(lazy, LazySplitData)
        assert lazy.features.shape == (7, 0, pre.features.shape[2])
        for key in ("sed_targets", "doa_targets", "feature_chunk_starts", "label_chunk_starts",
                    "clip_chunk_counts", "clip_label_frames"):
            np.testing.assert_array_equal(getattr(lazy, key), getattr(pre, key), err_msg=key)
        for i in range(len(pre)):
            np.testing.assert_array_equal(lazy.get_feature_chunk(i), pre.get_feature_chunk(i))
        short = lazy.clip_names.index("short")
        n_short = int(lazy.clip_feature_frames[lazy.unique_clip_names.index("short")])
        window = lazy.get_feature_chunk(short)
        assert n_short < lazy.feature_chunk_len == window.shape[1]
        assert not window[:, n_short:].any() and window[:4, :n_short].all()
        view = truncate_clips(lazy, 2)
        assert len(view) == int(np.sum(pre.clip_chunk_counts[:2]))
        np.testing.assert_array_equal(view.get_feature_chunk(len(view) - 1),
                                      pre.get_feature_chunk(len(view) - 1))
    one = list(batch_iterator(SeldChunkDataset(lazy), 3, shuffle=True,
                              rng=np.random.default_rng(1), num_workers=2))
    two = list(batch_iterator(SeldChunkDataset(pre), 3, shuffle=True,
                              rng=np.random.default_rng(1)))
    for a, b in zip(one, two):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)


class _Records(logging.Handler):
    """The messages of the port's logger, whatever handlers an earlier test's
    CLI call left on it (the CLIs' logging setup stops propagation to the root)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list[str] = []
        self.logger = logging.getLogger("salsa_tpu_torch")

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.level_before = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level_before)


def test_keep_existing_extracts_only_missing_clips(corpus, tmp_path):
    """A --keep-existing rerun on a full store extracts nothing ("0 clips left")
    and keeps every file; with one clip removed it extracts that clip alone, and
    the plain rerun empties the folder first."""
    cfg = _data_config(corpus["root"], "foa", str(tmp_path / "features"))
    out = textract.extract_features(cfg, "salsa_lite", splits=["foa_dev"], device="cpu")
    store = FeatureStore(out, "foa")
    stamps = {n: os.stat(store.clip_path("dev", n)).st_mtime_ns for n in CLIPS}
    calls = []
    real = textract.make_extractor

    def counting(*a, **kw):
        ex = real(*a, **kw)
        fn = ex.fn
        ex.fn = lambda w: calls.append(w.shape[0]) or fn(w)
        return ex

    with pytest.MonkeyPatch.context() as mp, _Records() as records:
        mp.setattr(textract, "make_extractor", counting)
        textract.extract_features(cfg, "salsa_lite", splits=["foa_dev"], keep_existing=True,
                                  device="cpu")
        assert calls == [] and "[foa_dev] resume: 0 clips left to extract" in records.messages
        assert {n: os.stat(store.clip_path("dev", n)).st_mtime_ns for n in CLIPS} == stamps
        want = store.read_clip("dev", "c")
        os.remove(store.clip_path("dev", "c"))
        textract.extract_features(cfg, "salsa_lite", splits=["foa_dev"], keep_existing=True,
                                  device="cpu")
        assert calls == [1] and "[foa_dev] resume: 1 clips left to extract" in records.messages
        np.testing.assert_array_equal(store.read_clip("dev", "c"), want)
    stray = os.path.join(store.split_dir("dev"), "stray.npy")
    np.save(stray, np.zeros(1, np.float32))
    textract.extract_features(cfg, "salsa_lite", splits=["foa_dev"], task="feature",
                              device="cpu")
    assert not os.path.exists(stray)


def test_store_refusals(tmp_path, monkeypatch):
    """A clip or scaler in both formats is refused (ValueError); an .h5 without
    h5py raises ImportError naming it; writing a clip or the scaler replaces an
    .h5 of it; SALSA of a one-channel wav is refused (ValueError), and of a
    17-channel wav equals salsa_tpu's store at the feature tests' SALSA bounds,
    its scaler over 17 spectrograms; without a card and without device='cpu'
    extraction raises."""
    store = FeatureStore(str(tmp_path), "foa")
    store.write_clip("dev", "x", np.ones((7, 4, 3), np.float32))
    with h5py.File(os.path.join(store.split_dir("dev"), "x.h5"), "w") as hf:
        hf.create_dataset("feature", data=np.zeros((7, 4, 3), np.float32))
    with pytest.raises(ValueError, match="two formats"):
        store.read_clip("dev", "x")
    store.write_clip("dev", "x", np.ones((7, 4, 3), np.float32))  # replaces the .h5
    assert os.listdir(store.split_dir("dev")) == ["x.npy"] and store.clip_names("dev") == ["x"]
    with h5py.File(os.path.join(str(tmp_path), "foa_feature_scaler.h5"), "w") as hf:
        hf.create_dataset("mean", data=np.zeros((4, 1, 3), np.float32))
        hf.create_dataset("std", data=np.ones((4, 1, 3), np.float32))
    assert store.has_scaler() and store.scaler_path.endswith(".h5")
    np.savez(os.path.join(str(tmp_path), "foa_feature_scaler.npz"), mean=0, std=1)
    with pytest.raises(ValueError, match="two formats"):
        store.read_scaler()
    store.write_scaler(np.zeros((4, 1, 3)), np.ones((4, 1, 3)))
    assert store.scaler_path.endswith(".npz") and store.read_scaler()[1].dtype == np.float32
    with h5py.File(os.path.join(store.split_dir("dev"), "y.h5"), "w") as hf:
        hf.create_dataset("feature", data=np.zeros((7, 4, 3), np.float32))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        store.read_clip("dev", "y")
    with pytest.raises(ImportError, match="h5py"):
        feature_store.open_clip(store.clip_path("dev", "y"))
    monkeypatch.undo()
    cfg = _data_config(str(tmp_path), "mic", str(tmp_path / "features"))
    os.makedirs(str(tmp_path / "mic_dev"))
    write_wav(str(tmp_path / "mic_dev" / "one.wav"), np.zeros((1, 800), np.float32), FS)
    with pytest.raises(ValueError, match="at least 2 channels"):
        textract.extract_features(cfg, "salsa", splits=["mic_dev"], device="cpu")
    wave = array_scene(np.random.default_rng(17), 1.0, 17, fs=FS)
    write_wav(str(tmp_path / "mic_dev" / "one.wav"), wave, FS, bits=16)
    port = textract.extract_features(cfg, "salsa", splits=["mic_dev"], device="cpu")
    jax_dir = jextract.extract_features(_data_config(str(tmp_path), "mic", str(tmp_path / "jax")),
                                        feature_type="salsa", splits=["mic_dev"],
                                        eig_method="power")
    got = FeatureStore(port, "mic").read_clip("dev", "one")
    want = FeatureStore(jax_dir, "mic").read_clip("dev", "one")
    assert got.shape == want.shape and got.shape[0] == 33 and np.isfinite(got).all()
    assert FeatureStore(port, "mic").read_scaler()[0].shape == (17, 1, got.shape[-1])
    assert_bank_close(got[:17], want[:17], "spec")
    p = make_extractor("salsa", "mic", fs=FS, n_fft=N_FFT, hop_length=HOP, win_length=N_FFT,
                       fmin_doa=50, fmax_doa=3000, n_mics=17).fn.keywords["params"]
    nb = p.upper_bin - p.lower_bin
    assert_spatial_close(got[17:, :, :nb], want[17:, :, :nb], chip_smoke.mic_period(p, nb), "C=17")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            textract.extract_features(cfg, "salsa", splits=["mic_dev"])


def test_main_maps_the_flags(monkeypatch):
    calls = []
    monkeypatch.setattr(textract, "extract_features", lambda *a, **kw: calls.append((a, kw)))
    textract.main(["--data-config", "d.yml", "--feature-type", "melspeciv", "--task", "feature",
                   "--cond-num", "4", "--no-tracking", "--eig-method", "eigh", "--batch-size",
                   "3", "--keep-existing"])
    assert calls == [(("d.yml",), {"feature_type": "melspeciv", "task": "feature",
                                   "cond_num": 4.0, "n_hopframes": 3, "is_tracking": False,
                                   "is_compress_high_freq": True, "eig_method": "eigh",
                                   "batch_size": 3, "keep_existing": True})]
