"""salsa_tpu_torch.streaming against salsa_tpu.streaming on the same seeded
samples: the streaming extractor (FOA and MIC, ragged packets, int16 and float,
one and three streams, a stream shorter than the reflect pad) with the tracker
state after every block, and the streaming pipeline (reg_xyz and accdoa) on one
flax init. The port runs its plain K1 and K2 here; salsa_tpu's extractor runs
eig_method='pallas' (its Pallas kernel in interpret mode, K1's arithmetic)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from salsa_tpu.models.seld import build_model as j_build_model  # noqa: E402
from salsa_tpu.streaming import StreamingExtractor as JExtractor  # noqa: E402
from salsa_tpu.streaming import StreamingSeldPipeline as JPipeline  # noqa: E402
from salsa_tpu_torch.features import chunked  # noqa: E402
from salsa_tpu_torch.features.salsa import noise_floor_mask  # noqa: E402
from salsa_tpu_torch.models.seld import build_model  # noqa: E402
from salsa_tpu_torch.streaming import StreamingExtractor, StreamingSeldPipeline  # noqa: E402
from tests.test_torch_models import flax_init  # noqa: E402

FS, N_FFT, HOP, L = 8000, 256, 150, 32
PUSH_SIZES = (777, 1531, 4096, 50, 9000)
ENC = {"name": "PannResNet22", "n_input_channels": 7}
DEC = {"name": "SeldDecoder", "decoder_type": "bigru", "decoder_size": 32, "freq_pool": "avg"}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_wave(rng, seconds, n_streams=None):
    """Noise plus a tone on every channel (a coherent source, so the spatial mask
    is neither empty nor full); (4, n), or (N, 4, n) with a tone each."""
    n = int(seconds * FS)
    t = np.arange(n) / FS
    shape = (4, n) if n_streams is None else (n_streams, 4, n)
    wave = 0.1 * rng.standard_normal(shape)
    f0 = rng.uniform(300, 1500, () if n_streams is None else (n_streams, 1, 1))
    return (wave + 0.4 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


def kw(fmt):
    # the DOA band must fit the compressed spectrogram's 100 bins at n_fft 256
    return dict(fs=FS, n_fft=N_FFT, hop_length=HOP, block_frames=L, fmax_doa=3000.0)


def record_states(se):
    """Record the tracker state after every block `se` commits, as numpy."""
    states, commit = [], se._commit

    def recording(*args):
        commit(*args)
        states.append(tuple(np.asarray(x) for x in se._tracker))

    se._commit = recording
    return states


def stream_all(se, wave, sizes=PUSH_SIZES):
    """Push `wave` in irregular packets, flush, concatenate the frames."""
    blocks, i, k = [], 0, 0
    while i < wave.shape[-1]:
        m = sizes[k % len(sizes)]
        k += 1
        blocks += se.push(wave[..., i:i + m])
        i += m
    tail = se.flush()
    if tail.size:
        blocks.append(tail)
    return np.concatenate(blocks, axis=-2)


def assert_features_close(got, want, p, what):
    """Spectrogram channels at the port's extractor-vs-salsa_tpu bound (the golden
    one: two frameworks' DFT matmuls round a small power differently and dB
    magnifies it); spatial channels at K1's bound, MIC phases on their circle
    (chip_smoke.compare_spatial); nothing above the DOA band."""
    assert got.shape == want.shape, (got.shape, want.shape)
    got, want = got.reshape((-1,) + got.shape[-3:]), want.reshape((-1,) + want.shape[-3:])
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=2e-2, rtol=1e-3, err_msg=what)
    nb = p.upper_bin - p.lower_bin
    assert not got[:, 4:, :, nb:].any() and not want[:, 4:, :, nb:].any()
    g, w = (torch.from_numpy(np.ascontiguousarray(x[:, 4:, :, :nb].transpose(0, 1, 3, 2)))
            for x in (got, want))
    period = chip_smoke.mic_period(p, nb) if p.audio_format == "mic" else None
    chip_smoke.compare_spatial(g, w, what, phase="test", period=period)
    valid = np.any(want[:, 4:, :, :nb] != 0, axis=1).mean()
    assert 0.01 < valid < 0.99, valid  # the comparison is not vacuous


def assert_states_close(got, want, what):
    """Tracker states after each block: the floors within rtol 1e-5 and the
    countdowns equal on > 99.9 % of rows. Not bit for bit: the two frameworks'
    DFT matmuls round the tracking magnitudes differently, and salsa_tpu's
    clip-start floor is jnp.mean's sum, which may miss the port's frame-order sum
    (K2's) by an ulp (ROADMAP queue 3)."""
    assert len(got) == len(want) > 1, (len(got), len(want))
    for k, ((gf, gc), (wf, wc)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gf, wf, rtol=1e-5, err_msg=f"{what} floor after block {k}")
        assert np.mean(gc == wc) > 0.999, f"{what} countdown after block {k}"


@pytest.mark.parametrize("fmt", ["foa", "mic"])
def test_extractor_matches_salsa_tpu(rng, fmt):
    """One float stream in ragged packets, then a stream shorter than the reflect
    pad through the same extractors after reset()."""
    wave = make_wave(rng, 3.0)
    je = JExtractor("salsa", fmt, eig_method="pallas", **kw(fmt))
    te = StreamingExtractor("salsa", fmt, device="cpu", **kw(fmt))
    j_states, t_states = record_states(je), record_states(te)
    want, got = stream_all(je, wave), stream_all(te, wave)
    assert got.shape == (7, te.total_frames(wave.shape[1]), te.params.freq_dim)
    assert_features_close(got, want, te.params, f"{fmt} stream")
    assert_states_close(t_states, j_states, fmt)
    assert te.latency_frames == je.latency_frames == 3

    short = make_wave(rng, 0.0125)  # 100 samples < required_pad + 1
    je.reset()
    te.reset()
    assert je.push(short) == [] and te.push(short) == []
    got, want = te.flush(), je.flush()
    assert got.shape == want.shape == (7, te.total_frames(100), te.params.freq_dim)
    np.testing.assert_allclose(got[:4], want[:4], atol=2e-2, rtol=1e-3)
    np.testing.assert_allclose(got[4:], want[4:], atol=5e-3, rtol=5e-3)


def test_multistream_int16_matches_salsa_tpu_and_single_streams(rng):
    """Three int16 PCM streams in one extractor against salsa_tpu's, against the
    port's three single-stream runs, and bit-equal to pushing the decoded floats."""
    waves = make_wave(rng, 2.5, n_streams=3)
    pcm = np.clip(np.round(waves * 32768.0), -32768, 32767).astype(np.int16)
    je = JExtractor("salsa", "foa", n_streams=3, eig_method="pallas", **kw("foa"))
    te = StreamingExtractor("salsa", "foa", n_streams=3, device="cpu", **kw("foa"))
    j_states, t_states = record_states(je), record_states(te)
    want, got = stream_all(je, pcm), stream_all(te, pcm)
    assert got.shape[0] == 3
    assert_features_close(got, want, te.params, "3 int16 streams")
    assert_states_close(t_states, j_states, "3 int16 streams")

    te_float = StreamingExtractor("salsa", "foa", n_streams=3, device="cpu", **kw("foa"))
    float_states = record_states(te_float)
    np.testing.assert_array_equal(stream_all(te_float, pcm.astype(np.float32) / 32768.0), got)
    for (a, b), (c, d) in zip(float_states, t_states):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for i in range(3):
        solo = stream_all(StreamingExtractor("salsa", "foa", device="cpu", **kw("foa")), pcm[i])
        np.testing.assert_allclose(got[i], solo, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="dtype changed"):
        te.reset()
        te.push(pcm[:, :, :1000])
        te.push(waves[:, :, :1000])


def block_windows(se):
    """Wrap `se`'s block function to record every window it is given."""
    windows, fn = [], se._block_fn

    def recording(window, *args):
        windows.append(window.clone())
        return fn(window, *args)

    se._block_fn = recording
    return windows


def test_chained_tracker_equals_collect_states_over_the_whole_stream(rng):
    """The state leaving every block, chained through K2 (plain here), equals K2
    collect_states over the whole zero-led stream (the blocks' planes end to end)
    at those frames, bit for bit; and a slot's re-init equals K2's own start."""
    wave = make_wave(rng, 2.5, n_streams=2)
    te = StreamingExtractor("salsa", "foa", n_streams=2, device="cpu", **kw("foa"))
    states, windows = record_states(te), block_windows(te)
    stream_all(te, wave)
    floors, countdowns = chip_smoke.stream_tracker_states(windows, te.params, L)
    assert len(states) == len(windows) > 2
    for k, (fl, cd) in enumerate(states[:-1]):
        np.testing.assert_array_equal(fl, floors[:, (k + 1) * L].numpy())
        np.testing.assert_array_equal(cd, countdowns[:, (k + 1) * L].numpy())
    # a re-init row: K2's clip-start state from that window, the other row carried
    p, h = te.params, te.params.n_hopframes
    re, im = chunked.block_spectra(windows[1], p)

    def band(x):
        return x[:, 0, :, p.lower_bin:p.upper_bin].transpose(-1, -2).contiguous()

    fn = chunked.make_salsa_block_fn(p, L)
    _, (fl, cd) = fn(windows[1], tuple(torch.from_numpy(s) for s in states[0]), [1])
    _, (fl0, cd0) = noise_floor_mask(band(re), band(im), n_hop=h, n_frames=L)
    assert torch.equal(fl[1], fl0[1]) and torch.equal(cd[1], cd0[1])
    np.testing.assert_array_equal(fl[0].numpy(), states[1][0][0])


def test_tracker_restart_starts_flagged_clips_and_resumes_the_others(rng):
    """K2's restart flags (plain here): a flagged clip's mask and state are those of
    a clip-start launch on its planes, an unflagged clip's those of a launch
    resumed from its state, in one call; restart needs state0."""
    xr0, xi0 = (torch.from_numpy(rng.standard_normal((3, 7, 26), dtype=np.float32))
                for _ in range(2))
    state0 = (torch.from_numpy(rng.uniform(0.1, 2.0, (3, 7)).astype(np.float32)),
              torch.from_numpy(rng.integers(-2, 4, (3, 7)).astype(np.int32)))
    restart = torch.tensor([False, True, False])
    mask, (fl, cd) = noise_floor_mask(xr0, xi0, n_hop=3, n_frames=20, state0=state0,
                                      restart=restart)
    start_mask, (start_fl, start_cd) = noise_floor_mask(xr0, xi0, n_hop=3, n_frames=20)
    res_mask, (res_fl, res_cd) = noise_floor_mask(xr0, xi0, n_hop=3, n_frames=20, state0=state0)
    for got, start, resumed in ((mask, start_mask, res_mask), (fl, start_fl, res_fl),
                                (cd, start_cd, res_cd)):
        assert torch.equal(got[1], start[1]) and torch.equal(got[[0, 2]], resumed[[0, 2]])
    assert not torch.equal(start_fl[1], res_fl[1])  # the flag changed something
    with pytest.raises(ValueError, match="restart goes with state0"):
        noise_floor_mask(xr0, xi0, n_hop=3, n_frames=20, restart=restart)
    with pytest.raises(ValueError, match=r"\(3,\) bool"):
        noise_floor_mask(xr0, xi0, n_hop=3, n_frames=20, state0=state0, restart=restart[:2])


@pytest.fixture(scope="module")
def pipelines():
    """One flax init with perturbed BatchNorm served by both packages' streaming
    pipelines at fs 8 kHz, hop 400, blocks of 32 frames, contexts 48 / 64."""
    rng = np.random.default_rng(20261019)
    hop = 400
    geo = dict(fs=FS, n_fft=N_FFT, hop_length=hop, block_frames=L, fmax_doa=3000.0)
    scaler = (rng.normal(-5.0, 1.0, (4, 1, 100)).astype(np.float32),
              rng.uniform(5.0, 8.0, (4, 1, 100)).astype(np.float32))
    interp = 16 * 10 / (FS / hop)
    je = JExtractor("salsa", "foa", eig_method="pallas", **geo)
    out = {}
    for fmt in ("reg_xyz", "accdoa"):
        j_model = j_build_model(encoder=ENC, decoder=DEC, n_classes=3, output_format=fmt)
        if fmt == "reg_xyz":
            params, stats = flax_init(rng, j_model, np.zeros((1, 7, 64, 100), np.float32))
        variables = {"params": params, "batch_stats": stats}
        out[fmt] = (
            JPipeline(je, j_model, variables, scaler, interp, 3, fmt, left_context=48,
                      right_context=64),
            StreamingSeldPipeline(
                StreamingExtractor("salsa", "foa", device="cpu", **geo),
                build_model(encoder=ENC, decoder=DEC, n_classes=3, output_format=fmt),
                variables, scaler, interp, 3, fmt, left_context=48, right_context=64))
    return out, make_wave(rng, 8.3)


def run(pipe, wave, push=2500):
    pipe.reset()
    outs = []
    for i in range(0, wave.shape[-1], push):
        outs += pipe.push(wave[..., i:i + push])
    n_push = len(outs)
    outs += pipe.flush()
    return outs, n_push


@pytest.mark.parametrize("fmt", ["reg_xyz", "accdoa"])
def test_pipeline_matches_salsa_tpu(pipelines, fmt):
    """Push and flush outputs block for block at test_seldnet_matches_flax's
    tolerance, with the label-frame accounting and the last block's trim."""
    (j_pipe, t_pipe), wave = pipelines[0][fmt], pipelines[1]
    want, j_push = run(j_pipe, wave)
    got, t_push = run(t_pipe, wave)
    assert t_push == j_push > 0 and len(got) == len(want) > t_push
    assert [g[0].shape for g in got] == [w[0].shape for w in want]
    assert got[-1][0].shape[0] < t_pipe.label_frames_per_block  # the trimmed last block
    for (ev_t, doa_t), (ev_j, doa_j) in zip(got, want):
        np.testing.assert_allclose(ev_t, ev_j, atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(doa_t, doa_j, atol=5e-4, rtol=1e-3)
    ev = np.concatenate([g[0] for g in got])
    doa = np.concatenate([g[1] for g in got])
    assert ev.std() > 0.01 and doa.std() > 0.01  # the comparison is not vacuous
    assert t_pipe.latency_frames == j_pipe.latency_frames == 32 + 64 + 3


def test_pipeline_int16_equals_float_and_counts_dispatches(pipelines):
    (_, t_pipe), wave = pipelines[0]["reg_xyz"], pipelines[1]
    pcm = np.clip(np.round(wave * 32768.0), -32768, 32767).astype(np.int16)
    before = StreamingSeldPipeline.dispatches
    got, _ = run(t_pipe, pcm)
    n = StreamingSeldPipeline.dispatches - before
    want, _ = run(t_pipe, pcm.astype(np.float32) / 32768.0)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    # one dispatch per block of the stream; the flush's lookahead blocks are pad
    # blocks, extracted from nothing
    n_blocks = -(-t_pipe.extractor.total_frames(wave.shape[1]) // L)
    assert n == n_blocks and len(got) == n_blocks


def test_streaming_refuses_what_is_not_ported():
    geo = kw("foa")
    with pytest.raises(ValueError, match="streaming supports"):
        StreamingExtractor("logmel", "foa", device="cpu", **geo)
    # every fused type and SALSA option streams (test_frame_local_streams_equal_offline)
    assert StreamingExtractor("salsa_lite", "mic", device="cpu", **geo).halo == 0
    assert not StreamingExtractor("salsa", "foa", is_tracking=False, device="cpu",
                                  **geo)._tracking
    with pytest.raises(ValueError, match="eig_method"):
        StreamingExtractor("salsa", "foa", eig_method="jacobi", device="cpu", **geo)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamingExtractor("salsa", "foa", **geo)


@pytest.mark.parametrize("ft,fmt,opts,tol", [
    ("salsa_lite", "mic", {}, dict(atol=1e-5, rtol=0)),
    ("melspeciv", "foa", {"n_mels": 64}, dict(atol=2e-4, rtol=1e-4)),
    ("linspecgcc", "mic", {}, dict(atol=2e-4, rtol=1e-4)),
])
def test_frame_local_streams_equal_offline(rng, ft, fmt, opts, tol):
    """The frame-local types stream with no halo and no tracker: ragged packets
    (tests/test_streaming.py:55-91) give the offline extractor's features, the GCC
    type through its deeper reflect pad and double-length frames at both ends; two
    synchronized streams give each one's; and salsa_tpu's streaming extractor
    gives the same at tests/test_torch_features.py's bounds."""
    from salsa_tpu_torch.features.registry import make_extractor
    from tests.test_torch_features import assert_bank_close, lite_period, on_circle

    geo = dict(fs=FS, n_fft=N_FFT, hop_length=HOP, **opts)
    waves = make_wave(rng, 2.5, n_streams=2)
    full = make_extractor(ft, fmt, **geo)(torch.from_numpy(waves)).numpy()
    te = StreamingExtractor(ft, fmt, block_frames=L, device="cpu", **geo)
    assert te.halo == 0 and te._pad == chunked.required_pad(ft, N_FFT)
    got = stream_all(te, waves[0])
    assert got.shape == full[0].shape == (te.n_feat_channels, te.total_frames(waves.shape[-1]),
                                          te.n_features)
    np.testing.assert_allclose(got, full[0], err_msg=ft, **tol)
    two = StreamingExtractor(ft, fmt, block_frames=L, n_streams=2, device="cpu", **geo)
    np.testing.assert_allclose(stream_all(two, waves, sizes=(333, 2048)), full,
                               err_msg=f"{ft} x2", **tol)
    want = stream_all(JExtractor(ft, fmt, block_frames=L, **geo), waves[0])
    assert_bank_close(got[:4], want[:4], "spec")
    if ft == "salsa_lite":
        assert_bank_close(on_circle(got[4:], want[4:], lite_period(te.params.params)),
                          want[4:], "ipd")
    else:
        assert_bank_close(got[4:], want[4:], "gcc" if ft.endswith("gcc") else "iv")
