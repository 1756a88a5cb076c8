"""The port's feature bank against salsa_tpu's on the same seeded waves: every
feature type of `salsa_tpu_torch.features.registry.make_extractor`, and SALSA
without tracking and on salsa_tpu's XLA eigensolvers ('power', 'eigh'), held
against `salsa_tpu.features.registry.make_extractor(..., jit=False)` and against
the reference golden (tests/golden/reference_features.npz). Also GCC-PHAT on
silence, the metadata, SALSA at other channel counts (the start-vector table and
3, 6 and 8 mics against salsa_tpu's power path), and the refusals that remain.

Bounds against salsa_tpu: spectrogram, IV, GCC and IPD channels within atol
2e-4, rtol 1e-4 on 99.99 % of cells and within the golden bounds on all (phases
on their circle; `assert_bank_close`); SALSA's spatial channels on the XLA
branch with validity masks disagreeing on < 0.5 % of cells and within atol 5e-3
where both are valid."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from salsa_tpu.features.registry import feature_n_channels as j_n_channels  # noqa: E402
from salsa_tpu.features.registry import feature_n_spec_channels as j_n_spec  # noqa: E402
from salsa_tpu.features.registry import make_extractor as j_make_extractor  # noqa: E402
from salsa_tpu_torch.features import registry  # noqa: E402
from salsa_tpu_torch.features.registry import make_extractor  # noqa: E402
from salsa_tpu_torch.features.salsa_lite import SalsaLiteParams, phase_scale  # noqa: E402
from salsa_tpu_torch.features.salsa_spatial import mic_delta  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_features.npz")
FS, N_FFT, HOP = 24000, 512, 300
ATOL, RTOL = 2e-4, 1e-4  # spectral, IV, GCC and IPD channels against salsa_tpu

# (feature_type, audio_format, kwargs): the 7 frame-local types, SALSA without
# tracking and on the XLA eigensolvers (SALSA through K1 is test_torch_salsa's)
CASES = [
    ("salsa_lite", "mic", {}),
    ("salsa_lite", "mic", {"fmin_doa": 0.0}),
    ("salsa_ipd", "mic", {}),
    ("linspeciv", "foa", {}),
    ("melspeciv", "foa", {"n_mels": 64}),
    ("linspecgcc", "mic", {}),
    ("melspecgcc", "mic", {"n_mels": 64}),
    ("melspec", "foa", {"n_mels": 64, "fmin": 0.0, "fmax": 20000.0}),
    ("salsa", "foa", {"is_tracking": False}),
    ("salsa", "mic", {"is_tracking": False}),
    ("salsa", "foa", {"eig_method": "power"}),
    ("salsa", "mic", {"eig_method": "power"}),
    ("salsa", "mic", {"eig_method": "eigh"}),
]


def case_id(case):
    ft, fmt, kw = case
    return "-".join([ft, fmt] + [f"{k}={v}" for k, v in kw.items()])


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def scene(rng, seconds: float, fmt: str, fs: int = FS) -> np.ndarray:
    """(4, n) float32: diffuse noise and one source that is on for the middle of
    the clip, a noise burst plus a tone; FOA first-order gains, or a MIC array
    whose mics hear it 0-4 samples apart. The last 0.2 s are digital silence."""
    n = int(round(seconds * fs))
    t = np.arange(n) / fs
    src = (0.3 * rng.standard_normal(n) + np.sin(2 * np.pi * rng.uniform(300, 3000) * t))
    src *= (t > 0.15 * seconds) & (t < 0.75 * seconds)
    out = 0.02 * rng.standard_normal((4, n))
    if fmt == "foa":
        azi, ele = rng.uniform(-np.pi, np.pi), rng.uniform(-0.6, 0.6)
        gains = np.array([1.0, np.sin(azi) * np.cos(ele), np.sin(ele), np.cos(azi) * np.cos(ele)])
        out += gains[:, None] * src[None]
    else:
        for m, d in enumerate(rng.integers(0, 5, 4)):
            out[m, d:] += src[:n - d]
    out[:, n - int(0.2 * fs):] = 0.0
    return out.astype(np.float32)


def lite_period(p: SalsaLiteParams) -> np.ndarray:
    """The period of each kept bin's normalised phase: 2 pi / its divisor."""
    return (2 * np.pi / phase_scale(p).astype(np.float64))[p.lower_bin:p.cutoff_bin]


def on_circle(got: np.ndarray, want: np.ndarray, period: np.ndarray) -> np.ndarray:
    """`got` moved by whole periods (per bin, the last axis) to lie nearest `want`:
    a phase at the branch cut reads +pi in one version and -pi in the other."""
    turns = np.round((got - want) / period)
    return got - turns * period


def assert_spatial_close(got: np.ndarray, want: np.ndarray, period=None, what=""):
    """SALSA's spatial channels (3, T, F): validity masks disagree on < 0.5 % of
    cells, features within atol 5e-3 on the cells valid in both (MIC phases on
    their circle)."""
    m_got, m_want = np.any(got != 0, axis=0), np.any(want != 0, axis=0)
    assert np.mean(m_got != m_want) < 0.005, (what, np.mean(m_got != m_want))
    both = m_got & m_want
    assert both.mean() > 0.01, what  # not vacuous
    g, w = got, want
    if period is not None:
        g = on_circle(got, want, np.broadcast_to(period, got.shape))
    np.testing.assert_allclose(g[:, both], w[:, both], atol=5e-3, rtol=0, err_msg=what)


# every cell's bound, channel group by group: tests/test_golden_features.py's for
# the spectrograms, IVs and GCCs, tests/test_salsa_pallas.py's spatial one for IPDs
ALL_CELLS = {"spec": (2e-2, 1e-3), "iv": (1e-3, 1e-2), "gcc": (2e-3, 1e-2), "ipd": (5e-3, 1e-2)}


def assert_bank_close(got: np.ndarray, want: np.ndarray, group: str):
    """At least 99.99 % of cells within ATOL/RTOL and every cell within
    ALL_CELLS[group]. The two frameworks' DFT matmuls sum in different orders; in
    a bin near a spectral null the power (or a cross spectrum) is a small
    difference of large terms, and dB or the phase turns their float32 rounding
    into more: measured up to 2.3e-2 dB, 1.7e-3 on an IV and 3.2e-3 on an IPD,
    on fewer than 1 cell in 10^4."""
    close = np.isclose(got, want, atol=ATOL, rtol=RTOL)
    assert close.mean() >= 0.9999, (group, 1 - close.mean())
    atol, rtol = ALL_CELLS[group]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=group)


def assert_matches_salsa_tpu(got: np.ndarray, want: np.ndarray, ft: str, ex):
    """The bounds of the feature bank's CPU tests (module docstring)."""
    assert got.shape == want.shape and np.isfinite(got).all(), (got.shape, want.shape)
    assert_bank_close(got[:4], want[:4], "spec")
    if ft in ("salsa_lite", "salsa_ipd"):
        p = ex.fn.params
        assert_bank_close(on_circle(got[4:], want[4:], lite_period(p)), want[4:], "ipd")
        above = np.arange(p.lower_bin, p.cutoff_bin) >= p.upper_bin
        assert not got[4:][..., above].any() and got[4:][..., ~above].any()
    elif ft == "salsa":
        p = ex.fn.keywords["params"]
        nb = p.upper_bin - p.lower_bin
        assert not got[4:, :, nb:].any()
        period = None
        if p.audio_format == "mic":
            period = 2 * np.pi / (mic_delta(p.fs, p.n_fft) * np.arange(p.lower_bin, p.upper_bin))
        assert_spatial_close(got[4:, :, :nb], want[4:, :, :nb], period, ft)
    elif got.shape[0] > 4:
        assert_bank_close(got[4:], want[4:], "gcc" if ft.endswith("gcc") else "iv")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_feature_type_matches_salsa_tpu(rng, case):
    ft, fmt, kw = case
    wave = scene(rng, 3.0, fmt)
    j = j_make_extractor(ft, fmt, fs=FS, n_fft=N_FFT, hop_length=HOP, jit=False, **kw)
    ex = make_extractor(ft, fmt, fs=FS, n_fft=N_FFT, hop_length=HOP, **kw)
    for k in ("name", "audio_format", "n_channels", "n_features", "n_spec_channels",
              "description"):
        assert getattr(ex, k) == getattr(j, k), k
    got = ex(torch.from_numpy(wave)[None])
    assert got.dtype == torch.float32 and got.shape[0] == 1
    assert_matches_salsa_tpu(got[0].numpy(), np.asarray(j(wave)), ft, ex)


def test_batch_equals_solo_runs(rng):
    """A batch of clips gives each clip's solo features, for a type of each family."""
    waves = np.stack([scene(rng, 1.0, "mic") for _ in range(3)])
    for ft in ("salsa_lite", "melspecgcc", "linspeciv"):
        ex = make_extractor(ft, "mic")
        batch = ex(torch.from_numpy(waves))
        for b in range(3):
            np.testing.assert_allclose(batch[b].numpy(),
                                       ex(torch.from_numpy(waves[b:b + 1]))[0].numpy(),
                                       atol=1e-5, rtol=1e-6, err_msg=ft)


GOLDEN_CASES = [
    # (key, feature_type, audio_format, kwargs, spec_atol, rest_atol):
    # tests/test_golden_features.py's cases and bounds
    ("melspec", "melspec", "foa", {"n_mels": 128}, 2e-2, None),
    ("melspeciv", "melspeciv", "foa", {"n_mels": 128}, 2e-2, 1e-3),
    ("melspecgcc", "melspecgcc", "mic", {"n_mels": 128}, 2e-2, 2e-3),
    ("linspeciv", "linspeciv", "foa", {}, 2e-2, 1e-3),
    ("linspecgcc", "linspecgcc", "mic", {}, 2e-2, 2e-3),
]


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("key,ft,fmt,kwargs,spec_atol,rest_atol", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_feature_type_matches_golden(golden, key, ft, fmt, kwargs, spec_atol, rest_atol):
    ex = make_extractor(ft, fmt, fs=int(golden["fs"]), n_fft=int(golden["n_fft"]),
                        hop_length=int(golden["hop"]), **kwargs)
    got = ex(torch.from_numpy(golden["audio"])[None])[0].numpy()
    want = golden[key]
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:4], want[:4], atol=spec_atol, rtol=1e-3)
    if rest_atol is not None:
        np.testing.assert_allclose(got[4:], want[4:], atol=rest_atol, rtol=1e-2)


@pytest.mark.parametrize("fmt", ["foa", "mic"])
@pytest.mark.parametrize("eig_method", ["eigh", "power"])
def test_salsa_xla_branch_matches_golden(golden, fmt, eig_method):
    """SALSA on salsa_tpu's XLA eigensolvers against the golden, at
    tests/test_golden_features.py's SALSA bounds."""
    ex = make_extractor("salsa", fmt, fs=int(golden["fs"]), n_fft=int(golden["n_fft"]),
                        hop_length=int(golden["hop"]), eig_method=eig_method)
    got = ex(torch.from_numpy(golden["audio"])[None])[0].numpy()
    want = golden[f"salsa_{fmt}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:4], want[:4], atol=2e-2, rtol=1e-3)
    ref_mask, got_mask = np.any(want[4:] != 0, axis=0), np.any(got[4:] != 0, axis=0)
    assert np.mean(ref_mask != got_mask) < 0.01
    both = ref_mask & got_mask
    np.testing.assert_allclose(got[4:][:, both], want[4:][:, both], atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("ft", ["linspecgcc", "melspecgcc"])
def test_gcc_phat_on_silence(ft):
    """All-zero input: every cross spectrum is 0, so every cell takes the flat
    phase spectrum 1 and the GCC is a unit impulse at lag 0, as salsa_tpu's
    where(|R| > 0, R / |R|, 1) gives; the melspecgcc notch scales the spectrum,
    not the flat fill."""
    zeros = np.zeros((4, 4800), np.float32)
    ex = make_extractor(ft, "mic", n_mels=64)
    got = ex(torch.from_numpy(zeros)[None])[0].numpy()
    want = np.asarray(j_make_extractor(ft, "mic", n_mels=64, jit=False)(zeros))
    np.testing.assert_array_equal(got[:4], want[:4])
    np.testing.assert_allclose(got[4:], want[4:], atol=1e-6)
    n_out = got.shape[-1]
    impulse = np.zeros(n_out, np.float32)
    impulse[n_out // 2] = 1.0
    np.testing.assert_allclose(got[4:], np.broadcast_to(impulse, got[4:].shape), atol=1e-5)


def test_metadata_equals_salsa_tpu():
    for ft in registry.FEATURE_REGISTRY:
        assert registry.feature_n_channels(ft) == j_n_channels(ft)
        assert registry.feature_n_spec_channels(ft) == j_n_spec(ft)
        for kw in ({}, {"n_mels": 64, "compress_high_freq": False, "fmax_doa": 3000.0}):
            fmt = "mic" if ft in ("salsa_lite", "salsa_ipd") else "foa"
            ex = make_extractor(ft, fmt, **kw)
            j = j_make_extractor(ft, fmt, jit=False, **kw)
            for k in ("name", "audio_format", "n_channels", "n_features", "n_spec_channels",
                      "description"):
                assert getattr(ex, k) == getattr(j, k), (ft, kw, k)
            assert ex.n_channels == registry.feature_n_channels(ft) and ex.hop_length == HOP
    ex = make_extractor("salsa", "mic", is_tracking=False, fmax_doa=None)
    assert ex.description == "24000fs_512nfft_300nhop_5cond_4000fmaxdoa_notracking"


def test_refusals_that_remain(rng):
    """An unknown type or eig_method raises ValueError; SALSA at one channel raises
    ValueError on K1's path (which hands other counts to the power iteration) and
    on the XLA power branch alike. SALSA at 17 channels runs on each of them and
    equals salsa_tpu's same branch on the same clip (untracked: every cell valid,
    so within the bank's bounds with phases on their circle); the exact
    eigensolver takes any count."""
    with pytest.raises(ValueError, match="unknown feature type"):
        make_extractor("logmel", "foa")
    with pytest.raises(ValueError, match="eig_method"):
        make_extractor("salsa", "foa", eig_method="jacobi")
    one = torch.zeros((1, 1, 4800))
    for kw in ({"eig_method": "power"}, {"is_tracking": False}, {}):
        with pytest.raises(ValueError, match="at least 2 channels"):
            make_extractor("salsa", "mic", n_mics=1, **kw)(one)
    wave = array_scene(rng, 0.5, 17)
    for kw in ({"eig_method": "power"}, {"is_tracking": False}, {}):
        ex = make_extractor("salsa", "mic", fs=FS, n_fft=N_FFT, hop_length=HOP, n_mics=17, **kw)
        got = ex(torch.from_numpy(wave)[None])[0].numpy()
        want = np.asarray(j_make_extractor("salsa", "mic", fs=FS, n_fft=N_FFT, hop_length=HOP,
                                           jit=False, **{"eig_method": "power", **kw})(wave))
        assert got.shape == want.shape == (33,) + want.shape[1:] and np.isfinite(got).all()
        assert_bank_close(got[:17], want[:17], "spec")
        p = ex.fn.keywords["params"]
        nb = p.upper_bin - p.lower_bin
        period = 2 * np.pi / (mic_delta(p.fs, p.n_fft) * np.arange(p.lower_bin, p.upper_bin))
        assert_spatial_close(got[17:, :, :nb], want[17:, :, :nb], period, f"C=17 {kw}")
    out = make_extractor("salsa", "mic", eig_method="eigh", n_mics=3)(torch.zeros((1, 3, 4800)))
    assert out.shape[1] == 5 and torch.isfinite(out).all()


def test_start_vector_table_equals_jax_random():
    """The port's start vectors for C = 2-16 (the literal table they replaced) and
    17, 24, 32 are salsa_tpu's draws, jax.random.normal(PRNGKey(20211021), (2, 2,
    C)), bit for bit; C = 4 is K1's; one channel is refused.
    tests/test_torch_threefry.py holds the generator at every C up to 64."""
    from salsa_tpu_torch.features import salsa_spatial as tspatial

    for C in [*range(2, 17), 17, 24, 32]:
        v = np.asarray(jax.random.normal(jax.random.PRNGKey(20211021), (2, 2, C)))
        s0, s1 = tspatial.start_vectors(C)
        assert s0.dtype == s1.dtype == np.complex64 and s0.shape == (C,)
        np.testing.assert_array_equal(s0, (v[0, 0] + 1j * v[0, 1]).astype(np.complex64))
        np.testing.assert_array_equal(s1, (v[1, 0] + 1j * v[1, 1]).astype(np.complex64))
    np.testing.assert_array_equal(tspatial.start_vectors(4)[0], tspatial.START_S0)
    np.testing.assert_array_equal(tspatial.start_vectors(4)[1], tspatial.START_S1)
    with pytest.raises(ValueError, match="at least 2 channels"):
        tspatial.start_vectors(1)


def array_scene(rng, seconds: float, n_mics: int, fs: int = FS) -> np.ndarray:
    """(n_mics, n) float32: `scene`'s MIC array with n_mics mics, each hearing the
    source 0-4 samples late."""
    n = int(round(seconds * fs))
    t = np.arange(n) / fs
    src = (0.3 * rng.standard_normal(n) + np.sin(2 * np.pi * rng.uniform(300, 3000) * t))
    src *= (t > 0.15 * seconds) & (t < 0.75 * seconds)
    out = 0.02 * rng.standard_normal((n_mics, n))
    for m, d in enumerate(rng.integers(0, 5, n_mics)):
        out[m, d:] += src[:n - d]
    out[:, n - int(0.2 * fs):] = 0.0
    return out.astype(np.float32)


@pytest.mark.parametrize("n_mics", [3, 6, 8, 17, 24, 32])
def test_salsa_other_channel_counts_match_salsa_tpu(rng, n_mics):
    """SALSA of a MIC array of 3, 6, 8, 17, 24 and 32 mics, the port's default (K2, then the
    power iteration, no K1) against salsa_tpu's power path: 2C - 1 channels, the
    spectrograms at the bank's bounds and the spatial channels at the SALSA mask
    bound (masks disagree on < 0.5 % of cells, atol 5e-3 where both are valid,
    phases on their circle). The port's metadata says 2C - 1 and C; salsa_tpu's
    says 7 and 4 at every C (ROADMAP queue 3)."""
    wave = array_scene(rng, 3.0, n_mics)
    j = j_make_extractor("salsa", "mic", fs=FS, n_fft=N_FFT, hop_length=HOP,
                         eig_method="power", jit=False)
    ex = make_extractor("salsa", "mic", fs=FS, n_fft=N_FFT, hop_length=HOP, n_mics=n_mics)
    assert (ex.n_channels, ex.n_spec_channels) == (2 * n_mics - 1, n_mics)
    want = np.asarray(j(wave))
    assert want.shape[0] == 2 * n_mics - 1 and (j.n_channels, j.n_spec_channels) == (7, 4)
    got = ex(torch.from_numpy(wave)[None])[0].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert_bank_close(got[:n_mics], want[:n_mics], "spec")
    p = ex.fn.keywords["params"]
    nb = p.upper_bin - p.lower_bin
    assert not got[n_mics:, :, nb:].any()
    period = 2 * np.pi / (mic_delta(p.fs, p.n_fft) * np.arange(p.lower_bin, p.upper_bin))
    assert_spatial_close(got[n_mics:, :, :nb], want[n_mics:, :, :nb], period, f"C={n_mics}")
