"""The port's host transforms (`salsa_tpu_torch.data.transforms`) and host batching
(`salsa_tpu_torch.data.dataset`) against `salsa_tpu`'s: on generators of the same
seed and the same input, every transform and every wiring of
`build_train_transforms` draws and returns the same arrays, bit for bit
(tolerance 0), and `batch_iterator` yields the same shuffled batches with the
transforms on, with 0 and with 2 worker threads."""
import numpy as np
import pytest

from salsa_tpu.data import dataset as jdataset
from salsa_tpu.data import transforms as jt
from salsa_tpu.data.database import SplitData as JSplitData
from salsa_tpu_torch.data import dataset as tdataset
from salsa_tpu_torch.data import transforms as tt
from salsa_tpu_torch.data.database import SplitData

N_CLASSES, T, F = 3, 40, 24
SEEDS = (0, 1, 2, 3, 4, 5)


def _input(seed: int, n_channels: int = 7):
    rng = np.random.default_rng(1000 + seed)
    x = rng.standard_normal((n_channels, T, F)).astype(np.float32)
    sed = (rng.random((T // 8, N_CLASSES)) > 0.5).astype(np.float32)
    doa = rng.standard_normal((T // 8, 3 * N_CLASSES)).astype(np.float32)
    return x, sed, doa


FEATURE = {
    "cutout": lambda m, rng: m.RandomCutout(always_apply=True, image_aspect_ratio=T / F,
                                            n_zero_channels=3, rng=rng),
    "cutout_value": lambda m, rng: m.RandomCutout(always_apply=True, random_value=0.5, rng=rng),
    "cutout_narrow": lambda m, rng: m.RandomCutout(always_apply=True, image_aspect_ratio=0.5,
                                                   rng=rng),
    "spec_augment": lambda m, rng: m.SpecAugment(always_apply=True, n_time_stripes=2,
                                                 n_freq_stripes=2, n_zero_channels=3,
                                                 rng=rng),
    "spec_augment_keep_last": lambda m, rng: m.SpecAugment(
        always_apply=True, n_zero_channels=3, is_filled_last_channels=False, rng=rng),
    "cutout_hole": lambda m, rng: m.RandomCutoutHole(always_apply=True, n_zero_channels=3,
                                                     rng=rng),
    "composite": lambda m, rng: m.CompositeCutout(p=0.7, image_aspect_ratio=T / F,
                                                  n_zero_channels=3, rng=rng),
    "shift": lambda m, rng: m.RandomShiftUpDown(p=0.6, freq_shift_range=5, rng=rng),
    "shift_down_last": lambda m, rng: m.RandomShiftUpDown(always_apply=True, direction="down",
                                                          freq_shift_range=4,
                                                          n_last_channels=3, rng=rng),
    "shift_up": lambda m, rng: m.RandomShiftUpDown(always_apply=True, direction="up",
                                                   freq_shift_range=7, rng=rng),
}
JOINT = {
    "foa": (lambda m, rng: m.SwapChannelFoa(p=0.8, n_classes=N_CLASSES, rng=rng), 7),
    "mic": (lambda m, rng: m.SwapChannelMic(p=0.8, n_classes=N_CLASSES, rng=rng), 7),
    "gcc": (lambda m, rng: m.SwapChannelGccMic(p=0.8, n_classes=N_CLASSES, rng=rng), 10),
}


@pytest.mark.parametrize("name", sorted(FEATURE))
def test_feature_transforms_bit_equal(name):
    for seed in SEEDS:
        j = FEATURE[name](jt, np.random.default_rng(seed))
        t = FEATURE[name](tt, np.random.default_rng(seed))
        x = _input(seed)[0]
        for _ in range(3):  # the same generator drawn from again
            want, got = j(x), t(x)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"{name} seed {seed}")
            x = want


@pytest.mark.parametrize("kind", sorted(JOINT))
def test_channel_swaps_bit_equal(kind):
    make, n_ch = JOINT[kind]
    for seed in SEEDS:
        j = make(jt, np.random.default_rng(seed))
        t = make(tt, np.random.default_rng(seed))
        for _ in range(4):
            x, sed, doa = _input(seed, n_ch)
            for got, want in zip(t(x, sed, doa), j(x, sed, doa)):
                np.testing.assert_array_equal(got, want, err_msg=f"{kind} seed {seed}")


@pytest.mark.parametrize("fn", ["swap_channel_foa", "swap_channel_mic", "swap_channel_gcc"])
def test_swap_label_algebra_bit_equal_for_every_mask(fn):
    """Every mask of the deterministic swaps: features and labels equal."""
    n_ch = 10 if fn == "swap_channel_gcc" else 7
    n_bits = 4 if fn == "swap_channel_foa" else 3
    x, sed, doa = _input(9, n_ch)
    for bits in range(2 ** n_bits):
        m = [(bits >> i) & 1 for i in range(n_bits)]
        for got, want in zip(getattr(tt, fn)(x, sed, doa, m, N_CLASSES),
                             getattr(jt, fn)(x, sed, doa, m, N_CLASSES)):
            np.testing.assert_array_equal(got, want, err_msg=f"{fn} mask {m}")


WIRINGS = [("salsa", "foa", 7), ("linspeciv", "foa", 7), ("melspeciv", "foa", 7),
           ("salsa", "mic", 7), ("salsa_lite", "mic", 7), ("salsa_ipd", "mic", 7),
           ("linspecgcc", "mic", 10), ("melspecgcc", "mic", 10)]


@pytest.mark.parametrize("feature_type,fmt,n_ch", WIRINGS)
def test_build_train_transforms_bit_equal(feature_type, fmt, n_ch):
    """Each (feature type, format) wiring: the same transform classes in the same
    order, and 12 chunks through both on one seed give the same arrays."""
    j_joint, j_feat = jt.build_train_transforms(feature_type, fmt, N_CLASSES, T, F,
                                                rng=np.random.default_rng(11))
    t_joint, t_feat = tt.build_train_transforms(feature_type, fmt, N_CLASSES, T, F,
                                                rng=np.random.default_rng(11))
    names = lambda c: [type(t).__name__ for t in c.transforms]  # noqa: E731
    assert names(t_joint) == names(j_joint) and names(t_feat) == names(j_feat)
    for i in range(12):
        x, sed, doa = _input(i, n_ch)
        got = t_joint(x, sed, doa)
        want = j_joint(x, sed, doa)
        got, want = (t_feat(got[0]), *got[1:]), (j_feat(want[0]), *want[1:])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{feature_type}/{fmt} chunk {i}")


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="unknown audio format"):
        tt.build_train_transforms("salsa", "stereo", N_CLASSES, T, F)


def _split(module_split, rng):
    n_chunks, chunk_len, label_len = 11, 16, 2
    feats = rng.standard_normal((7, n_chunks * chunk_len, F)).astype(np.float32)
    sed = (rng.random((n_chunks * label_len, N_CLASSES)) > 0.5).astype(np.float32)
    doa = rng.standard_normal((n_chunks * label_len, 3 * N_CLASSES)).astype(np.float32)
    return module_split(
        features=feats, sed_targets=sed, doa_targets=doa,
        feature_chunk_starts=np.arange(n_chunks) * chunk_len,
        label_chunk_starts=np.arange(n_chunks) * label_len,
        clip_names=[f"c{i // 3}" for i in range(n_chunks)], feature_chunk_len=chunk_len,
        feature_chunk_hop=chunk_len, label_chunk_len=label_len, label_chunk_hop=label_len,
        chunks_per_clip=3)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_iterator_bit_equal(workers, drop_last):
    """Shuffled batches of 4 over 11 chunks with salsa_tpu's FOA SALSA transforms:
    the same order, arrays, names and real counts as salsa_tpu's iterator, and the
    same with 0 workers as with 2 (the draws run in order in the caller's
    thread)."""
    rng = np.random.default_rng(3)
    tsplit = _split(SplitData, rng)
    jsplit = JSplitData(**{k: getattr(tsplit, k) for k in (
        "features", "sed_targets", "doa_targets", "feature_chunk_starts", "label_chunk_starts",
        "clip_names", "feature_chunk_len", "feature_chunk_hop", "label_chunk_len",
        "label_chunk_hop", "chunks_per_clip")})

    def batches(data_mod, transforms_mod, split, n_workers):
        joint, feat = transforms_mod.build_train_transforms(
            "salsa", "foa", N_CLASSES, 16, F, rng=np.random.default_rng(5))
        ds = data_mod.SeldChunkDataset(split, joint, feat)
        return list(data_mod.batch_iterator(ds, 4, shuffle=True, rng=np.random.default_rng(8),
                                            drop_last=drop_last, pad_to_batch=True,
                                            num_workers=n_workers))

    want = batches(jdataset, jt, jsplit, workers)
    for got in (batches(tdataset, tt, tsplit, workers), batches(tdataset, tt, tsplit, 0)):
        assert len(got) == len(want) == (2 if drop_last else 3)
        for g, w in zip(got, want):
            assert g[3] == w[3] and g[4] == w[4]
            for a, b in zip(g[:3], w[:3]):
                np.testing.assert_array_equal(a, b)


def test_prefetch_reraises_and_closes_early():
    """prefetch: items in order, the producer's exception raised at the consumer,
    and an early close stops the producer and closes the inner iterator."""
    assert list(tdataset.prefetch(iter(range(5)), depth=2)) == list(range(5))

    def failing():
        yield 1
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(tdataset.prefetch(failing()))
    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.append(True)

    gen = tdataset.prefetch(endless(), depth=1)
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()
    import time

    for _ in range(100):
        if closed:
            break
        time.sleep(0.02)
    assert closed == [True]
