"""`salsa_tpu_torch.train.tta` against `salsa_tpu.train.tta` (the six tests of
tests/test_tta.py, parametrised over kind and mask): the label matrices, the
feature transform and the inverse DOA map equal `salsa_tpu`'s to the bit for every
variant of every kind; each variant round-trips; the kind mapping, the fold and the
channel refusal match."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from salsa_tpu.train.tta import ChannelSwapTTA as JTTA  # noqa: E402
from salsa_tpu.train.tta import tta_kind as j_tta_kind  # noqa: E402
from salsa_tpu_torch.train.device_augment import swap_channel_mic  # noqa: E402
from salsa_tpu_torch.train.tta import ChannelSwapTTA, tta_fold, tta_kind  # noqa: E402

N_CLASSES = 3
KINDS = {"foa": (16, 7), "mic": (8, 7), "gcc": (4, 10)}
CASES = [(kind, i) for kind, (n, _) in KINDS.items() for i in range(n)]


@pytest.fixture(scope="module")
def ttas():
    return {kind: (JTTA(kind, N_CLASSES), ChannelSwapTTA(kind, N_CLASSES)) for kind in KINDS}


@pytest.mark.parametrize("kind,idx", CASES)
def test_label_matrix_equals_salsa_tpu(ttas, kind, idx):
    j, t = ttas[kind]
    assert len(t) == len(j) == KINDS[kind][0]
    np.testing.assert_array_equal(t.masks[idx], j.masks[idx])
    np.testing.assert_array_equal(t._label_mats[idx], j._label_mats[idx])
    L = t._label_mats[idx]  # a signed permutation
    np.testing.assert_array_equal(L @ L.T, np.eye(3))


@pytest.mark.parametrize("kind,idx", CASES)
def test_transform_features_bit_equal_to_salsa_tpu(ttas, kind, idx):
    """Bit for bit, the sign of zero included (the MIC generators' subtractions in
    salsa_tpu's order), alone and inside a folded group of every variant."""
    j, t = ttas[kind]
    rng = np.random.default_rng(100 + idx)
    x = rng.standard_normal((3, KINDS[kind][1], 6, 5)).astype(np.float32)
    x[0, :, 0, 0] = 0.0
    want = j.transform_features(x, idx)
    got = t.transform_features(torch.from_numpy(x), idx).numpy()
    assert got.tobytes() == want.tobytes()
    group = t.transform_group(torch.from_numpy(x), range(len(t))).numpy()
    assert group[idx * 3:(idx + 1) * 3].tobytes() == want.tobytes()


@pytest.mark.parametrize("kind,idx", CASES)
def test_inverse_doa_equals_salsa_tpu(ttas, kind, idx):
    """salsa_tpu maps through a float64 einsum; the port moves and negates blocks
    in float32: the same values."""
    j, t = ttas[kind]
    doa = np.random.default_rng(idx).standard_normal((2, 4, 3 * N_CLASSES)).astype(np.float32)
    got = t.inverse_doa(torch.from_numpy(doa), idx)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), j.inverse_doa(doa, idx))


def _equivariant_model(x, kind, n_classes):
    """Per-class DOA read off the spatial channels' means (FOA: IVx, IVy, IVz =
    channels 6, 4, 5), so the model transforms as the labels do."""
    iv = x[:, [6, 4, 5]].mean(dim=(2, 3))  # (B, 3)
    return iv.repeat_interleave(n_classes, 1)[:, None].expand(-1, 4, -1)


@pytest.mark.parametrize("kind,idx", CASES)
def test_each_variant_round_trips(ttas, kind, idx):
    """FOA: an exactly equivariant model's prediction on every variant maps back to
    its identity-frame prediction; MIC and GCC: the labels pushed through the
    swap function come back."""
    _, t = ttas[kind]
    rng = np.random.default_rng(7 + idx)
    if kind == "foa":
        x = torch.from_numpy(rng.standard_normal((2, 7, 6, 5)).astype(np.float32))
        base = _equivariant_model(x, kind, N_CLASSES)
        back = t.inverse_doa(_equivariant_model(t.transform_features(x, idx), kind, N_CLASSES),
                             idx)
        torch.testing.assert_close(back, base, atol=1e-6, rtol=0)
    else:
        doa = torch.from_numpy(rng.standard_normal((5, 1, 3 * N_CLASSES)).astype(np.float32))
        x = torch.zeros((5, KINDS[kind][1], 2, 2))
        m = torch.from_numpy(np.tile(t.masks[idx], (5, 1)).astype(np.float32))
        _, doa_t = t.fn(x, doa, m, N_CLASSES)
        if kind == "mic":
            assert t.fn is swap_channel_mic
        torch.testing.assert_close(t.inverse_doa(doa_t, idx), doa, atol=1e-6, rtol=0)


@pytest.mark.parametrize("feature_type,fmt", [("salsa", "foa"), ("salsa", "mic"),
                                              ("salsa_lite", "mic"), ("linspecgcc", "mic"),
                                              ("melspecgcc", "mic"), ("linspeciv", "foa")])
def test_tta_kind_maps_as_salsa_tpu(feature_type, fmt):
    assert tta_kind(feature_type, fmt) == j_tta_kind(feature_type, fmt)


@pytest.mark.parametrize("kind,channels,ok", [("foa", 4, False), ("gcc", 7, False),
                                              ("mic", 10, False), ("foa", 7, True),
                                              ("gcc", 10, True), ("mic", 7, True)])
def test_channel_mismatch_refused_as_salsa_tpu(kind, channels, ok):
    if ok:
        ChannelSwapTTA(kind, 12, n_input_channels=channels)
        JTTA(kind, 12, n_input_channels=channels)
        return
    with pytest.raises(ValueError) as want:
        JTTA(kind, 12, n_input_channels=channels)
    with pytest.raises(ValueError) as got:
        ChannelSwapTTA(kind, 12, n_input_channels=channels)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not supported"):
        ChannelSwapTTA("stereo", 12)


@pytest.mark.parametrize("shape,budget,want", [((8, 7, 4800, 200), 2e8, 2),
                                               ((8, 7, 640, 200), 2e8, 16),
                                               ((8, 7, 4800, 200), 1.0, 1),
                                               ((1, 7, 160, 200), 2e8, 16)])
def test_fold_is_salsa_tpus(shape, budget, want):
    """`tta_fold` is `salsa_tpu`'s `_tta_fold`: the largest power-of-two divisor of
    16 whose folded batch fits the budget (fold 2 at 8 x 60 s chunks)."""
    from types import SimpleNamespace

    from salsa_tpu.train.trainer import SeldTrainer as JTrainer

    stub = SimpleNamespace(cfg=SimpleNamespace(training={"tta_elements_per_dispatch": budget}))
    assert tta_fold(16, shape, budget) == JTrainer._tta_fold(stub, 16, shape) == want
