"""salsa_tpu_torch.features.chunked (per-chunk SALSA extraction for raw-wav
training) against the port's own full-clip extractor and against
salsa_tpu.features.chunked on the same seeded waves. The port runs its plain K1
and K2 here; salsa_tpu's chunk function runs eig_method='pallas' (its Pallas
kernel in interpret mode, K1's arithmetic)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

from salsa_tpu.features import chunked as jchunked  # noqa: E402
from salsa_tpu.features.salsa import SalsaParams as JSalsaParams  # noqa: E402
from salsa_tpu_torch.dsp.stft import stft_planes  # noqa: E402
from salsa_tpu_torch.features import chunked  # noqa: E402
from salsa_tpu_torch.features.registry import make_extractor  # noqa: E402
from salsa_tpu_torch.features.salsa import (  # noqa: E402
    SalsaParams,
    band_planes,
    extract_salsa,
    noise_floor_mask,
    tracker_init_state,
    tracking_magspec_planes,
)
from tests.test_from_wav import synth_wave  # noqa: E402
from tests.test_torch_features import (  # noqa: E402
    array_scene,
    assert_bank_close,
    assert_spatial_close,
    lite_period,
    on_circle,
)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


FS, N_FFT, HOP = 24000, 512, 300
CHUNK = 160


def _params(fmt):
    return dict(fs=FS, n_fft=N_FFT, hop_length=HOP, audio_format=fmt,
                fmax_doa=9000.0 if fmt == "foa" else 4000.0)


def _chunks(wave, p, starts, chunk_len=CHUNK, state=None):
    """The port's chunks at `starts` of one clip, tracker resumed from `state`
    (default: the port's own checkpoints)."""
    wp = torch.from_numpy(chunked.pad_waveform(wave, N_FFT))
    if state is None:
        state = chunked.salsa_tracker_checkpoints(wp, starts, p)
    n = len(starts)
    return chunked.make_salsa_chunk_fn(p, chunk_len)(
        wp[None], torch.zeros(n, dtype=torch.long), torch.as_tensor(starts, dtype=torch.long),
        torch.full((n,), chunked.n_full_frames(wave.shape[1], HOP)), *state).numpy()


def _starts(n_samples):
    n_full = chunked.n_full_frames(n_samples, HOP)
    return np.array([0, 120, n_full - n_full % 8 - CHUNK])  # first, middle, last


@pytest.mark.parametrize("fmt", ["foa", "mic"])
def test_chunk_equals_full_clip_slice(rng, fmt):
    """First chunk (wrap context from the clip's end, fresh tracker), a middle one
    (checkpointed tracker) and the last (wrap context from the start): each equals
    the full-clip feature slice at salsa_tpu's own bound (tests/test_from_wav.py)."""
    wave = synth_wave(rng, 6.0)
    p = SalsaParams(**_params(fmt))
    full = extract_salsa(torch.from_numpy(wave)[None], p)[0].numpy()
    starts = _starts(wave.shape[1])
    feats = _chunks(wave, p, starts)
    assert feats.shape == (3, 7, CHUNK, p.freq_dim)
    for i, f0 in enumerate(starts):
        np.testing.assert_allclose(feats[i], full[:, f0:f0 + CHUNK], atol=2e-4, rtol=1e-4,
                                   err_msg=f"{fmt} chunk at {f0}")
    assert np.any(feats[:, 4:] != 0) and np.any(feats[:, 4:] == 0)


def _k1_close(got, want, what):
    """K1's bound: validity masks disagree on < 0.5% of cells, features within
    atol/rtol 5e-3 where both are valid."""
    m_got, m_want = np.any(got != 0, axis=0), np.any(want != 0, axis=0)
    assert np.mean(m_got != m_want) < 0.005, what
    both = m_got & m_want
    assert both.mean() > 0.01, what
    np.testing.assert_allclose(got[:, both], want[:, both], atol=5e-3, rtol=5e-3, err_msg=what)


@pytest.mark.parametrize("fmt", ["foa", "mic"])
def test_chunk_matches_salsa_tpu_chunk_fn(rng, fmt):
    """The port's chunk against salsa_tpu's make_salsa_chunk_fn (eig_method
    'pallas') from salsa_tpu's tracker checkpoints: spectrogram channels at the
    port's extractor-vs-salsa_tpu bound (the golden one,
    tests/test_golden_features.py: two frameworks' DFT matmuls round a small
    power differently, and dB magnifies it), spatial channels at K1's."""
    wave = synth_wave(rng, 4.0)
    starts = _starts(wave.shape[1])
    jp = JSalsaParams(eig_method="pallas", **_params(fmt))
    wp = chunked.pad_waveform(wave, N_FFT)
    fl, cd = jchunked.salsa_tracker_checkpoints(wp, starts, jp)
    jfn = jax.jit(jchunked.make_salsa_chunk_fn(jp, CHUNK))
    n_full = chunked.n_full_frames(wave.shape[1], HOP)
    got = _chunks(wave, SalsaParams(**_params(fmt)), starts,
                  state=(torch.from_numpy(np.array(fl)), torch.from_numpy(np.array(cd))))
    for i, f0 in enumerate(starts):
        want = np.asarray(jfn(jnp.asarray(wp), jnp.int32(n_full), jnp.int32(f0),
                              jnp.asarray(fl[i]), jnp.asarray(cd[i])))
        np.testing.assert_allclose(got[i, :4], want[:4], atol=2e-2, rtol=1e-3)
        _k1_close(got[i, 4:], want[4:], f"{fmt} chunk at {f0}")


def test_tracker_checkpoints_match_full_clip_and_salsa_tpu(rng):
    """K2 with collect_states (plain here) gives the state entering each chunk
    start: equal to the port's own scan run up to that frame, and to salsa_tpu's
    checkpoints up to the 1-ulp clip-start floor (jnp.mean's order, ROADMAP
    queue 3)."""
    wave = synth_wave(rng, 4.0)
    p = SalsaParams(**_params("foa"))
    jp = JSalsaParams(eig_method="pallas", **_params("foa"))
    starts = np.array([0, 1, 37, 200, 320])
    wp = chunked.pad_waveform(wave, N_FFT)
    floor, cd = chunked.salsa_tracker_checkpoints(torch.from_numpy(wp), starts, p)
    assert floor.dtype == torch.float32 and cd.dtype == torch.int32
    assert floor.shape == (len(starts), p.upper_bin - p.lower_bin)
    floors, cds = chunked.tracker_states_all(torch.from_numpy(wp)[None], p)
    assert floors.shape[1] == chunked.n_full_frames(wave.shape[1], HOP)
    # the state entering frame s is the clip-start state (from the clip's first 5
    # frames) run over frames 0 .. s-1 of the extractor's own band planes
    xr, xi = band_planes(*stft_planes(torch.from_numpy(wave)[None], n_fft=N_FFT,
                                      hop_length=HOP), p)
    xr0, xi0 = xr[:, 0].contiguous(), xi[:, 0].contiguous()
    state0 = tracker_init_state(tracking_magspec_planes(xr0, xi0, 3, floors.shape[1]))
    assert torch.equal(floor[0], state0[0][0]) and torch.equal(cd[0], state0[1][0])
    for k, s in enumerate(starts[1:], start=1):
        _, (f_s, c_s) = noise_floor_mask(xr0[..., :s + 6].contiguous(),
                                         xi0[..., :s + 6].contiguous(), n_hop=3, n_frames=s,
                                         state0=state0)
        assert torch.equal(floor[k], f_s[0]) and torch.equal(cd[k], c_s[0])
    j_fl, j_cd = jchunked.salsa_tracker_checkpoints(wp, starts, jp)
    np.testing.assert_allclose(floor.numpy(), j_fl, rtol=1e-5)
    assert np.mean(cd.numpy() == j_cd) > 0.999


def test_int16_resident_waves_equal_their_dequantized_floats(rng):
    """An int16 resident tensor with wav_scale 1/32768 gives the chunks of the
    float32 tensor holding the same samples."""
    wave = synth_wave(rng, 3.0)
    p = SalsaParams(**_params("foa"))
    wp = chunked.pad_waveform(wave, N_FFT)
    q = np.clip(np.round(wp * 32768.0), -32768, 32767).astype(np.int16)
    deq = torch.from_numpy(q.astype(np.float32) / 32768.0)
    starts = np.array([0, 40])
    state = chunked.salsa_tracker_checkpoints(deq, starts, p)
    fn = chunked.make_salsa_chunk_fn(p, CHUNK)
    args = (torch.zeros(2, dtype=torch.long), torch.from_numpy(starts),
            torch.full((2,), chunked.n_full_frames(wave.shape[1], HOP)), *state)
    a = fn(torch.from_numpy(q)[None], *args, wav_scale=1.0 / 32768.0)
    b = fn(deq[None], *args)
    assert torch.equal(a, b)


def test_short_clip_chunk_matches_salsa_tpu(rng):
    """A clip shorter than the chunk, resident beside a longer clip (zero tail):
    its one chunk reads the zero-padded tail as salsa_tpu's does (the module
    docstring's bounded deviation from the full-clip map)."""
    short, long_ = synth_wave(rng, 1.0), synth_wave(rng, 3.0)
    p = SalsaParams(**_params("foa"))
    jp = JSalsaParams(eig_method="pallas", **_params("foa"))
    wp = chunked.pad_waveform(short, N_FFT)
    lp = chunked.pad_waveform(long_, N_FFT)
    resident = np.zeros((2,) + lp.shape, np.float32)
    resident[0], resident[1, :, :wp.shape[1]] = lp, wp
    fl, cd = jchunked.salsa_tracker_checkpoints(wp, np.array([0]), jp)
    n_full = chunked.n_full_frames(short.shape[1], HOP)
    want = np.asarray(jchunked.make_salsa_chunk_fn(jp, CHUNK)(
        jnp.asarray(resident[1]), jnp.int32(n_full), jnp.int32(0), jnp.asarray(fl[0]),
        jnp.asarray(cd[0])))
    got = chunked.make_salsa_chunk_fn(p, CHUNK)(
        torch.from_numpy(resident), torch.ones(1, dtype=torch.long),
        torch.zeros(1, dtype=torch.long), torch.full((1,), n_full),
        torch.from_numpy(np.array(fl)), torch.from_numpy(np.array(cd)))[0].numpy()
    np.testing.assert_allclose(got[:4], want[:4], atol=2e-2, rtol=1e-3)
    _k1_close(got[4:], want[4:], "short clip")
    # resident alone, the clip is padded to the window (salsa_tpu raises there)
    alone = chunked.make_salsa_chunk_fn(p, CHUNK)(
        torch.from_numpy(wp)[None], torch.zeros(1, dtype=torch.long),
        torch.zeros(1, dtype=torch.long), torch.full((1,), n_full),
        torch.from_numpy(np.array(fl)), torch.from_numpy(np.array(cd)))[0].numpy()
    np.testing.assert_array_equal(alone, got)
    with pytest.raises(TypeError, match="slice_sizes"):
        jchunked.make_salsa_chunk_fn(jp, CHUNK)(jnp.asarray(wp), jnp.int32(n_full), jnp.int32(0),
                                                jnp.asarray(fl[0]), jnp.asarray(cd[0]))


# the fused types besides SALSA through K1, and SALSA off K1 (no tracking; the
# XLA power branch with tracking, resumed from a checkpoint)
OTHER_TYPES = [("salsa_lite", "mic", {}), ("salsa_ipd", "mic", {}), ("linspeciv", "foa", {}),
               ("melspeciv", "foa", {"n_mels": 64}), ("linspecgcc", "mic", {}),
               ("melspecgcc", "mic", {"n_mels": 64}), ("melspec", "foa", {"n_mels": 64}),
               ("salsa", "mic", {"is_tracking": False}), ("salsa", "foa", {"eig_method": "power"})]


@pytest.mark.parametrize("ft,fmt,opts", OTHER_TYPES,
                         ids=[f"{c[0]}-{c[1]}-{'-'.join(c[2])}" for c in OTHER_TYPES])
def test_other_types_chunk_equals_full_clip_and_salsa_tpu(rng, ft, fmt, opts):
    """Each fused type's chunks at the first, a middle and the last start (the
    tests/test_from_wav.py pattern): equal to the port's full-clip slice within
    atol 2e-4, rtol 1e-4, from a resident wave carrying required_pad (the GCC
    types' big_n_fft // 2, their n_fft frames read at a pad offset); and each
    against salsa_tpu's chunk function at tests/test_torch_features.py's bounds."""
    wave = synth_wave(rng, 4.0)
    kw = dict(fs=FS, n_fft=N_FFT, hop_length=HOP, fmax_doa=None, **opts)
    fn, p = chunked.make_chunk_extractor(ft, fmt, CHUNK, **kw)
    jfn, jp = jchunked.make_chunk_extractor(ft, fmt, CHUNK, **kw)
    full = make_extractor(ft, fmt, **kw)(torch.from_numpy(wave)[None])[0].numpy()
    pad = chunked.required_pad(ft, N_FFT)
    wp = chunked.pad_waveform(wave, N_FFT, pad)
    starts = _starts(wave.shape[1])
    n_full = chunked.n_full_frames(wave.shape[1], HOP)
    tracking = ft == "salsa" and p.is_tracking
    state = (chunked.salsa_tracker_checkpoints(torch.from_numpy(wp), starts, p) if tracking
             else (None, None))
    got = fn(torch.from_numpy(wp)[None], torch.zeros(3, dtype=torch.long),
             torch.from_numpy(starts), torch.full((3,), n_full), *state).numpy()
    assert got.shape == (3, full.shape[0], CHUNK, full.shape[-1])
    jstate = jchunked.salsa_tracker_checkpoints(wp, starts, jp) if tracking else None
    jfn = jax.jit(jfn)
    for i, f0 in enumerate(starts):
        np.testing.assert_allclose(got[i], full[:, f0:f0 + CHUNK], atol=2e-4, rtol=1e-4,
                                   err_msg=f"{ft} chunk at {f0}")
        if ft == "salsa":
            nb = jp.upper_bin - jp.lower_bin
            fl, cd = ((jnp.asarray(jstate[0][i]), jnp.asarray(jstate[1][i])) if tracking
                      else (jnp.zeros(nb), jnp.zeros(nb, jnp.int32)))
        else:
            fl, cd = jnp.zeros(1), jnp.zeros(1, jnp.int32)
        want = np.asarray(jfn(jnp.asarray(wp), jnp.int32(n_full), jnp.int32(f0), fl, cd))
        assert_bank_close(got[i, :4], want[:4], "spec")
        rest = got[i, 4:]
        if ft == "salsa":
            period = (chip_smoke.mic_period(p, nb) if fmt == "mic" else None)
            assert_spatial_close(rest[..., :nb], want[4:, :, :nb], period, f"{ft} at {f0}")
        elif ft in ("salsa_lite", "salsa_ipd"):
            assert_bank_close(on_circle(rest, want[4:], lite_period(p.params)), want[4:], "ipd")
        elif rest.shape[0]:
            assert_bank_close(rest, want[4:], "gcc" if ft.endswith("gcc") else "iv")


def test_helpers_equal_salsa_tpu(rng):
    wave = rng.standard_normal((4, 2345)).astype(np.float32)
    for pad in (None, 300):
        np.testing.assert_array_equal(chunked.pad_waveform(wave, N_FFT, pad),
                                      jchunked.pad_waveform(wave, N_FFT, pad))
    for ft in chunked.FUSED_FEATURE_TYPES:
        assert chunked.required_pad(ft, N_FFT) == jchunked.required_pad(ft, N_FFT)
    for n in (0, 299, 300, 1_440_000):
        assert chunked.n_full_frames(n, HOP) == jchunked.n_full_frames(n, HOP)
    assert chunked.FUSED_FEATURE_TYPES == jchunked.FUSED_FEATURE_TYPES


def test_chunk_extractor_refusals(rng):
    """Every fused type and SALSA option is taken; what remains refused: an unknown
    type or eig_method (ValueError) and SALSA at one channel (ValueError), on K1's
    path and on the XLA branch. SALSA at 17 channels runs on each of them (K1's
    path hands it to the power iteration, as salsa_tpu routes it off its Pallas
    kernel) and equals salsa_tpu's chunk function at tests/test_torch_features.py's
    bounds."""
    kw = dict(fs=FS, n_fft=N_FFT, hop_length=HOP)
    fn, p = chunked.make_chunk_extractor("salsa", "mic", CHUNK, **kw)
    assert callable(fn) and p.fmax_doa == 4000.0 and p.audio_format == "mic"
    with pytest.raises(ValueError, match="from_wav supports"):
        chunked.make_chunk_extractor("notafeature", "foa", CHUNK, **kw)
    with pytest.raises(ValueError, match="eig_method"):
        chunked.make_chunk_extractor("salsa", "foa", CHUNK, eig_method="jacobi", **kw)
    for ft in ("salsa_lite", "melspecgcc"):
        fn, ff = chunked.make_chunk_extractor(ft, "mic", CHUNK, **kw)
        assert callable(fn) and ff.n_channels == (7 if ft == "salsa_lite" else 10)
    zero = torch.zeros(1, dtype=torch.long)
    wave = array_scene(rng, (CHUNK + 8) * HOP / FS, 17)
    wp = chunked.pad_waveform(wave, N_FFT)
    n_full = chunked.n_full_frames(wave.shape[1], HOP)
    for opts in ({"is_tracking": False}, {"eig_method": "power"}, {}):
        fn, p = chunked.make_chunk_extractor("salsa", "mic", CHUNK, **opts, **kw)
        jfn, jp = jchunked.make_chunk_extractor("salsa", "mic", CHUNK, **opts, **kw)
        assert p.uses_k1 == (opts == {})
        nb = p.upper_bin - p.lower_bin
        state = ((torch.zeros((1, nb)), torch.full((1, nb), 3, dtype=torch.int32))
                 if p.is_tracking else (None, None))
        with pytest.raises(ValueError, match="at least 2 channels"):
            fn(torch.from_numpy(wp[:1])[None], zero, zero, zero + n_full, *state)
        got = fn(torch.from_numpy(wp)[None], zero, zero, zero + n_full, *state)[0].numpy()
        assert got.shape == (33, CHUNK, p.freq_dim) and np.isfinite(got).all()
        fl, cd = ((jnp.zeros(nb), jnp.full(nb, 3, jnp.int32)) if p.is_tracking
                  else (jnp.zeros(nb), jnp.zeros(nb, jnp.int32)))
        want = np.asarray(jfn(jnp.asarray(wp), jnp.int32(n_full), jnp.int32(0), fl, cd))
        assert_bank_close(got[:17], want[:17], "spec")
        assert_spatial_close(got[17:, :, :nb], want[17:, :, :nb], chip_smoke.mic_period(p, nb),
                             f"C=17 {opts}")
        three = fn(torch.from_numpy(wp[:3])[None], zero, zero, zero + n_full, *state)
        assert three.shape[1] == 5 and torch.isfinite(three).all()
