"""salsa_tpu_torch.data (split metadata, targets, chunk tables, the raw-wav split,
the scaler fit and the val-split extraction on the device, batching) against
salsa_tpu.data on one synthetic corpus (8 kHz FOA wavs with DCASE metadata). The
port extracts with its plain K1 and K2 here, salsa_tpu with eig_method='pallas'
(interpret mode), K1's arithmetic."""
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from salsa_tpu.data import dataset as jdataset  # noqa: E402
from salsa_tpu.data import database as jdatabase  # noqa: E402
from salsa_tpu.data import meta as jmeta  # noqa: E402
from salsa_tpu.data import wav_database as jwav  # noqa: E402
from salsa_tpu.data.feature_store import StreamingScaler as JScaler  # noqa: E402
from salsa_tpu.features.registry import make_extractor as j_make_extractor  # noqa: E402
from salsa_tpu_torch.data import dataset, database, meta  # noqa: E402
from salsa_tpu_torch.data import wav_database as twav  # noqa: E402
from salsa_tpu_torch.data.feature_store import FeatureStore, StreamingScaler  # noqa: E402
from salsa_tpu_torch.features.registry import make_extractor  # noqa: E402
from tests.test_from_wav import E2E_FS, E2E_HOP, E2E_NFFT, _write_synth_corpus  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


GEOMETRY = dict(audio_format="foa", n_classes=3, fs=E2E_FS, hop_len=E2E_HOP,
                train_chunk_len_s=1.6, train_chunk_hop_len_s=0.8, test_chunk_len_s=4.0,
                test_chunk_hop_len_s=4.1, scaler_channels=4, max_file_len_s=4.0)
EX = dict(fs=E2E_FS, n_fft=E2E_NFFT, hop_length=E2E_HOP, fmax_doa=3000.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three 4 s clips and a 1.2 s one (shorter than a chunk), with metadata."""
    root = str(tmp_path_factory.mktemp("torch_data"))
    rng = np.random.default_rng(20261019)
    names, meta_dir = _write_synth_corpus(root, rng, n_clips=3, seconds=4.0)
    short, _ = _write_synth_corpus(os.path.join(root, "short"), rng, n_clips=1, seconds=1.2)
    os.replace(os.path.join(root, "short", "foa_dev", short[0] + ".wav"),
               os.path.join(root, "foa_dev", "short00.wav"))
    names = names + ["short00"]
    with open(os.path.join(meta_dir, "train.csv"), "w") as f:
        f.write("filename\n" + "\n".join(names))
    jdb = jdatabase.SeldDatabase(feature_root_dir=os.path.join(root, "f"),
                                 gt_meta_root_dir=root, **GEOMETRY)
    tdb = database.SeldDatabase(store=twav.MemoryFeatureStore({}, None), gt_meta_root_dir=root,
                                **GEOMETRY)
    jdb.n_fft = tdb.n_fft = E2E_NFFT
    return {"root": root, "names": names, "meta_dir": meta_dir, "jdb": jdb, "tdb": tdb,
            "audio_dir": os.path.join(root, "foa_dev")}


@pytest.mark.parametrize("wav_dtype", ["float32", "int16"])
def test_load_wav_split_tables_equal_salsa_tpu(corpus, wav_dtype):
    c = corpus
    kw = dict(split_meta_dir=c["meta_dir"], wav_dtype=wav_dtype, n_channels=7, n_features=100)
    want = jwav.load_wav_split(c["jdb"], "train", c["audio_dir"], **kw)
    got = twav.load_wav_split(c["tdb"], "train", c["audio_dir"], **kw)
    for key in ("features", "sed_targets", "doa_targets", "feature_chunk_starts",
                "label_chunk_starts", "clip_chunk_counts", "clip_label_frames", "waves",
                "clip_of_chunk", "within_clip_start", "clip_full_frames", "clip_trimmed_frames"):
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    for key in ("clip_names", "unique_clip_names", "feature_chunk_len", "feature_chunk_hop",
                "label_chunk_len", "label_chunk_hop", "chunks_per_clip", "wav_scale", "wav_pad"):
        assert getattr(got, key) == getattr(want, key), key
    for a, b in zip(got.clip_wavs, want.clip_wavs, strict=True):
        np.testing.assert_array_equal(a, b)
    assert got.sed_targets.any() and len(got) == len(want) > 4


def test_scaler_and_val_store_match_salsa_tpu(corpus):
    """The scaler fit from the waves (rtol 1e-5) and the full-clip features of
    extract_split_to_store (spectrograms at the golden bound, spatial channels at
    K1's) against salsa_tpu's, and the SplitData built over the store."""
    c = corpus
    split = twav.load_wav_split(c["tdb"], "train", c["audio_dir"], split_meta_dir=c["meta_dir"])
    j_ex = j_make_extractor("salsa", "foa", eig_method="pallas", **EX)
    t_ex = make_extractor("salsa", "foa", **EX)
    want = jwav.fit_scaler_from_waves(j_ex, split.clip_wavs, 4)
    got = twav.fit_scaler_from_waves(t_ex, split.clip_wavs, 4, device="cpu")
    for a, b in zip(got, want):
        assert a.shape == b.shape == (4, 1, 100) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    names = c["names"][2:]  # a 4 s clip and the short one: two length groups
    j_store = jwav.extract_split_to_store(j_ex, names, c["audio_dir"], E2E_FS, want)
    t_store = twav.extract_split_to_store(t_ex, names, c["audio_dir"], E2E_FS, want,
                                          device="cpu")
    for name in names:
        a, b = t_store.read_clip("dev", name), j_store.read_clip("dev", name)
        assert a.shape == b.shape
        np.testing.assert_allclose(a[:4], b[:4], atol=2e-2, rtol=1e-3)
        m_a, m_b = np.any(a[4:] != 0, axis=0), np.any(b[4:] != 0, axis=0)
        assert np.mean(m_a != m_b) < 0.005
        both = m_a & m_b
        np.testing.assert_allclose(a[4:][:, both], b[4:][:, both], atol=5e-3, rtol=5e-3)
    assert t_store.read_scaler() is want

    with open(os.path.join(c["meta_dir"], "val.csv"), "w") as f:
        f.write("filename\n" + "\n".join(names))
    geo = {k: v for k, v in GEOMETRY.items()}
    jv = jdatabase.SeldDatabase(feature_root_dir=None, gt_meta_root_dir=c["root"], store=j_store,
                                **geo).load_split("val", c["meta_dir"], stage="inference")
    tv = database.SeldDatabase(store=t_store, gt_meta_root_dir=c["root"],
                               **geo).load_split("val", c["meta_dir"], stage="inference")
    for key in ("sed_targets", "doa_targets", "feature_chunk_starts", "label_chunk_starts",
                "clip_chunk_counts", "clip_label_frames"):
        np.testing.assert_array_equal(getattr(tv, key), getattr(jv, key), err_msg=key)
    assert tv.features.shape == jv.features.shape
    np.testing.assert_allclose(tv.features[:4], jv.features[:4], atol=2e-2, rtol=1e-3)

    # batching in clip order with the tail padded, and a clip-truncated view
    jb = list(jdataset.batch_iterator(jdataset.SeldChunkDataset(jv), 3, pad_to_batch=True))
    tb = list(dataset.batch_iterator(dataset.SeldChunkDataset(tv), 3, pad_to_batch=True))
    assert len(tb) == len(jb)
    for (x, sed, doa, nm, n), (jx, jsed, jdoa, jnm, jn) in zip(tb, jb):
        assert x.shape == jx.shape and nm == jnm and n == jn
        np.testing.assert_array_equal(sed, jsed)
        np.testing.assert_array_equal(doa, jdoa)
    t1, j1 = database.truncate_clips(tv, 1), jdatabase.truncate_clips(jv, 1)
    assert t1.unique_clip_names == j1.unique_clip_names and len(t1) == len(j1)
    np.testing.assert_array_equal(t1.clip_chunk_counts, j1.clip_chunk_counts)


@pytest.mark.parametrize("batch_size", [2, 5])
def test_batches_run_in_order_with_the_tail_padded(corpus, batch_size):
    """salsa_tpu's in-order batches with pad_to_batch: the same names, arrays and
    real counts; the tail repeats its last chunk."""
    c = corpus
    tv = twav.load_wav_split(c["tdb"], "train", c["audio_dir"], split_meta_dir=c["meta_dir"])
    jv = jwav.load_wav_split(c["jdb"], "train", c["audio_dir"], split_meta_dir=c["meta_dir"])
    tb = list(dataset.batch_iterator(dataset.SeldChunkDataset(tv), batch_size,
                                     pad_to_batch=True))
    jb = list(jdataset.batch_iterator(jdataset.SeldChunkDataset(jv), batch_size,
                                      pad_to_batch=True))
    assert len(tb) == len(jb) == -(-len(tv) // batch_size)
    for got, want in zip(tb, jb):
        assert got[3] == want[3] and got[4] == want[4]
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
    *_, names, n_real = tb[-1]
    assert len(names) == batch_size and names[n_real:] == [names[n_real - 1]] * (
        batch_size - n_real)
    assert sum(b[4] for b in tb) == len(tv)


def test_targets_meta_and_scaler_helpers_equal_salsa_tpu(corpus, rng):
    c = corpus
    path = os.path.join(c["root"], "metadata_dev", c["names"][0] + ".csv")
    rows = database.parse_gt_csv(path)
    np.testing.assert_array_equal(rows, jdatabase.parse_gt_csv(path))
    # overlapping tracks of one class: the longer track wins in both
    rows = np.concatenate([rows, [[1, rows[0, 1], 7, 10.0, -5.0], [2, 0, 7, 20.0, 5.0]]])
    for n_frames in (5, 40):
        for a, b in zip(database.classwise_targets(rows, n_frames, 3),
                        jdatabase.classwise_targets(rows, n_frames, 3)):
            np.testing.assert_array_equal(a, b)
    for args in ((40, 16, 8, 0), (33, 16, 8, 100), (16, 16, 8, 3)):
        assert database.chunk_starts(*args) == jdatabase.chunk_starts(*args)
    for split in ("train", "val", "test", "dev", "eval"):
        assert meta.split_filenames(split) == jmeta.split_filenames(split)
    assert meta.split_filenames("train", c["meta_dir"]) == c["names"]
    with pytest.raises(ValueError):
        meta.split_filenames("nope")
    a, b = StreamingScaler(4), JScaler(4)
    for _ in range(3):
        x = rng.standard_normal((7, 50, 10)).astype(np.float32) * 5 - 20
        a.update(x)
        b.update(x)
    for u, v in zip(a.finalize(), b.finalize()):
        np.testing.assert_array_equal(u, v)


def test_database_needs_a_store():
    """Without an injected store the database reads the FeatureStore at
    feature_root_dir; with neither it raises."""
    db = database.SeldDatabase(feature_root_dir="/data/features", **GEOMETRY)
    assert isinstance(db.store, FeatureStore) and db.store.root_dir == "/data/features"
    with pytest.raises(ValueError, match="feature_root_dir or a store"):
        database.SeldDatabase(feature_root_dir=None, **GEOMETRY)
    with pytest.raises(ValueError, match="wav_dtype"):
        twav.load_wav_split(None, "train", "/nowhere", wav_dtype="bfloat16")
