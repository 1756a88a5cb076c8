"""salsa_tpu_torch.stream_pool against salsa_tpu.stream_pool on the scripted
schedules of tests/test_stream_pool.py (SALSA with its noise tracker, so every
join re-initializes a slot's tracker): both pools get the same pushes, attaches,
detaches, polls and ticks, and must give the same outputs and the same
fill_report()s; the port's pool must also equal the port's solo streaming runs.
The port runs its plain K1 and K2; salsa_tpu's extractor runs eig_method='pallas'
(its Pallas kernel in interpret mode, K1's arithmetic). Also the promoted short
clip behind a silent peer, where the port does not copy salsa_tpu's stall."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from salsa_tpu.models.seld import build_model as j_build_model  # noqa: E402
from salsa_tpu.stream_pool import SeldStreamPool as JPool  # noqa: E402
from salsa_tpu.streaming import StreamingExtractor as JExtractor  # noqa: E402
from salsa_tpu.streaming import StreamingSeldPipeline as JPipeline  # noqa: E402
from salsa_tpu_torch.models.seld import build_model  # noqa: E402
from salsa_tpu_torch.stream_pool import SeldStreamPool  # noqa: E402
from salsa_tpu_torch.streaming import StreamingExtractor, StreamingSeldPipeline  # noqa: E402
from tests.test_torch_models import flax_init  # noqa: E402

FS, N_FFT, HOP, L = 8000, 256, 400, 32
LEFT, RIGHT = 48, 64
TICK = L * HOP
PUSH = 2500
ENC = {"name": "PannResNet22", "n_input_channels": 7}
DEC = {"name": "SeldDecoder", "decoder_type": "bigru", "decoder_size": 32, "freq_pool": "avg"}
GEO = dict(fs=FS, n_fft=N_FFT, hop_length=HOP, block_frames=L, fmax_doa=3000.0)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """One flax init with perturbed BatchNorm; each package's pipelines at
    capacity 1 and 2 and the port's solo pipeline, built once and reset per
    schedule."""
    rng = np.random.default_rng(20261020)
    j_model = j_build_model(encoder=ENC, decoder=DEC, n_classes=3)
    params, stats = flax_init(rng, j_model, np.zeros((1, 7, 64, 100), np.float32))
    variables = {"params": params, "batch_stats": stats}
    scaler = (rng.normal(-5.0, 1.0, (4, 1, 100)).astype(np.float32),
              rng.uniform(5.0, 8.0, (4, 1, 100)).astype(np.float32))
    interp = 16 * 10 / (FS / HOP)
    ctx = dict(left_context=LEFT, right_context=RIGHT)

    def port(n):
        return StreamingSeldPipeline(
            StreamingExtractor("salsa", "foa", n_streams=n, device="cpu", **GEO),
            build_model(encoder=ENC, decoder=DEC, n_classes=3), variables, scaler, interp, 3,
            **ctx)

    def jax_pipe(n):
        return JPipeline(JExtractor("salsa", "foa", n_streams=n, eig_method="pallas", **GEO),
                         j_model, variables, scaler, interp, 3, **ctx)

    return {"port": {1: port(1), 2: port(2)}, "jax": {1: jax_pipe(1), 2: jax_pipe(2)}}


def pools(setup, capacity, max_lag=None):
    """(the port's pool, salsa_tpu's pool) on freshly reset pipelines."""
    out = []
    for side, cls in (("port", SeldStreamPool), ("jax", JPool)):
        pipe = setup[side][capacity]
        pipe.reset()
        out.append(cls(pipe, max_lag=max_lag))
    return out


def solo(setup, wave, push=PUSH):
    pipe = setup["port"][1]
    pipe.reset()
    outs = []
    for i in range(0, wave.shape[1], push):
        outs += pipe.push(wave[:, i:i + push])
    return outs + pipe.flush()


def cat(outs):
    return (np.concatenate([o[0] for o in outs], axis=0),
            np.concatenate([o[1] for o in outs], axis=0))


def assert_outputs(got, want, atol, rtol):
    (ge, gd), (we, wd) = cat(got), cat(want)
    assert ge.shape == we.shape and gd.shape == wd.shape, (ge.shape, we.shape)
    np.testing.assert_allclose(ge, we, atol=atol, rtol=rtol)
    np.testing.assert_allclose(gd, wd, atol=atol, rtol=rtol)


def assert_matches(setup, runs, waves):
    """runs: {stream: (port outputs, salsa_tpu outputs)}. The port's pool against
    salsa_tpu's at test_seldnet_matches_flax's tolerance; each stream that was
    never zero-filled against the port's solo run at the batch == solo bound of
    tests/test_torch_pipeline.py."""
    for name, (got, want) in runs.items():
        assert_outputs(got, want, 5e-4, 1e-3)
        ev = cat(got)[0]
        assert ev.std() > 0.01  # the comparison is not vacuous
        if name in waves:
            assert_outputs(got, solo(setup, waves[name]), 1e-5, 0)


def wave(seed, seconds):
    n = int(seconds * FS)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    return (0.1 * rng.standard_normal((4, n))
            + 0.3 * np.sin(2 * np.pi * (250.0 + 60 * seed) * t)).astype(np.float32)


def test_attach_early_detach_and_tracker_reinit(setup):
    """A runs from the pool's start; B attaches two blocks in (its slot's tracker
    starts afresh there) and detaches early while A plays on."""
    wa, wb = wave(1, 6.5), wave(2, 3.3)
    out = []
    for pool in pools(setup, 2):
        ha, hb, got_a, got_b, pos_a, pos_b = pool.attach(), None, [], [], 0, 0
        while pos_a < wa.shape[1]:
            got_a += pool.push(ha, wa[:, pos_a:pos_a + PUSH])
            pos_a += PUSH
            if hb is None and pos_a >= 2 * TICK:
                hb = pool.attach()
            if hb is not None and pos_b < wb.shape[1]:
                got_b += pool.push(hb, wb[:, pos_b:pos_b + PUSH])
                pos_b += PUSH
                if pos_b >= wb.shape[1]:
                    got_b += pool.detach(hb)
        got_a += pool.detach(ha)
        got_b += pool.poll(hb)
        assert pool.n_live == 0
        out.append((got_a, got_b))
    assert_matches(setup, {"a": (out[0][0], out[1][0]), "b": (out[0][1], out[1][1])},
                   {"a": wa, "b": wb})


def test_slot_reuse_capacity_one(setup):
    wa, wc = wave(5, 3.1), wave(6, 2.6)
    out = []
    for pool in pools(setup, 1):
        ha = pool.attach()
        assert pool.attach() is None
        got_a = []
        for i in range(0, wa.shape[1], 2000):
            got_a += pool.push(ha, wa[:, i:i + 2000])
        got_a += pool.detach(ha)
        hc = pool.attach()
        got_c = []
        for i in range(0, wc.shape[1], 2000):
            got_c += pool.push(hc, wc[:, i:i + 2000])
        got_c += pool.detach(hc)
        out.append((got_a, got_c))
    for name, i, w in (("a", 0, wa), ("c", 1, wc)):
        assert_outputs(out[0][i], out[1][i], 5e-4, 1e-3)
        assert_outputs(out[0][i], solo(setup, w, push=2000), 1e-5, 0)


def test_pending_detach_promotes_to_solo(setup):
    """A clip shorter than a block, pushed whole between boundaries and detached
    while pending, is promoted: it goes live at the next boundary and drains."""
    wa, wb = wave(8, 4.2), wave(9, 1.1)
    out = []
    for pool in pools(setup, 2):
        ha, pos_a = pool.attach(), 0
        while pos_a < TICK + PUSH:
            pool.push(ha, wa[:, pos_a:pos_a + PUSH])
            pos_a += PUSH
        hb = pool.attach()
        got_b = pool.push(hb, wb)
        got_b += pool.detach(hb)
        while pos_a < wa.shape[1]:
            pool.push(ha, wa[:, pos_a:pos_a + PUSH])
            pos_a += PUSH
            got_b += pool.poll(hb)
        pool.detach(ha)
        got_b += pool.poll(hb)
        assert pool.finished(hb) and pool.n_live == 0
        out.append(got_b)
    assert_matches(setup, {"b": tuple(out)}, {"b": wb})


def test_no_fill_for_healthy_paced_streams_with_joiner_backlog(setup):
    """max_lag under a block, B missing boundary 0 by push order: no stream is
    zero-filled and both equal their solo runs."""
    wa, wb = wave(20, 4.0), wave(21, 4.0)
    out = []
    for pool in pools(setup, 2, max_lag=TICK // 4):
        ha, hb = pool.attach(), pool.attach()
        got_a, got_b, ended_a, ended_b, pos = [], [], False, False, 0
        while not (ended_a and ended_b):
            if not ended_a:
                got_a += pool.push(ha, wa[:, pos:pos + PUSH])
                if pos + PUSH >= wa.shape[1]:
                    got_a += pool.detach(ha)
                    ended_a = True
            if not ended_b:
                got_b += pool.push(hb, wb[:, pos:pos + PUSH])
                if pos + PUSH >= wb.shape[1]:
                    got_b += pool.detach(hb)
                    ended_b = True
            pos += PUSH
        got_a += pool.poll(ha)
        got_b += pool.poll(hb)
        assert pool.fill_report(ha) == [] and pool.fill_report(hb) == []
        out.append((got_a, got_b))
    assert_matches(setup, {"a": (out[0][0], out[1][0]), "b": (out[0][1], out[1][1])},
                   {"a": wa, "b": wb})


def test_stall_policy_zero_fills_the_laggard(setup):
    """B goes live then falls silent; with max_lag one block, A's predictions flow
    (its solo run's), B's slot is zero-filled, and both pools report the same
    fills in samples and label frames."""
    wa, wb = wave(10, 10.0), wave(11, 0.5)
    out = []
    for pool in pools(setup, 2, max_lag=TICK):
        ha, hb = pool.attach(), pool.attach()
        got_a = pool.push(ha, wa[:, :PUSH])
        got_b = pool.push(hb, wb)
        for i in range(PUSH, wa.shape[1], PUSH):
            got_a += pool.push(ha, wa[:, i:i + PUSH])
            got_b += pool.poll(hb)
        assert len(got_a) >= 2
        fills = (pool.fill_report(hb), pool.fill_label_ranges(hb))
        assert fills[0] and all(a >= wb.shape[1] for a, _ in fills[0])
        got_b += pool.detach(hb)
        got_a += pool.detach(ha)
        got_b += pool.poll(hb)
        out.append((got_a, got_b, fills))
    assert out[0][2] == out[1][2]
    assert_matches(setup, {"a": (out[0][0], out[1][0]), "b": (out[0][1], out[1][1])},
                   {"a": wa})


def test_tick_finishes_drains_behind_a_silent_live_stream(setup):
    wa, wb = wave(12, 2.0), wave(13, 2.4)
    out = []
    for pool in pools(setup, 2):
        ha, hb = pool.attach(), pool.attach()
        pool.push(ha, wa)
        got_b = pool.push(hb, wb)
        got_b += pool.detach(hb)
        n_before, ticks = len(got_b), 0
        while not pool.finished(hb):
            assert ticks < 64, "tick() failed to complete the drain"
            pool.tick()
            ticks += 1
            got_b += pool.poll(hb)
        assert len(got_b) > n_before and pool.fill_report(ha)
        out.append((got_b, ticks, pool.fill_report(ha)))
    assert out[0][1:] == out[1][1:]
    assert_matches(setup, {"b": (out[0][0], out[1][0])}, {"b": wb})


def test_promoted_short_clip_activates_behind_a_silent_peer(setup):
    """salsa_tpu/stream_pool.py:335: a clip detached while pending, shorter than a
    block, counts queued - tick as clock demand, never positive, so behind a
    silent live peer it never activates unless the caller drives tick(). The port
    counts its whole queue: with max_lag below it, the pool forces the boundary,
    zero-filling the silent peer, and the clip goes live and starts draining;
    salsa_tpu's stays pending and its peer unfilled."""
    wa, wb = wave(14, 2.0), wave(15, 0.8)  # B: 6400 samples, half a block
    port, jax_pool = pools(setup, 2, max_lag=TICK // 4)
    states = []
    for pool in (port, jax_pool):
        ha = pool.attach()
        pool.push(ha, wa[:, :TICK + PUSH])  # A live, the clock parked mid-block; then silent
        hb = pool.attach()
        pool.push(hb, wb)
        pool.detach(hb)  # still pending: promoted
        states.append((pool._streams[hb].state, pool.fill_report(ha)))
    assert states[1] == ("pending", [])
    assert states[0][0] == "draining" and states[0][1]
    # the port's clip needs the peer (or tick()) only for its last max_lag samples
    # and the lookahead; ticks finish it, and it is its solo run
    got_b = port.poll(hb)
    while not port.finished(hb):
        port.tick()
        got_b += port.poll(hb)
    assert_outputs(got_b, solo(setup, wb), 1e-5, 0)


def test_pool_api_guards(setup):
    pool = pools(setup, 2)[0]
    h = pool.attach()
    pool.push(h, wave(7, 0.5))
    with pytest.raises(KeyError):
        pool.push(99, wave(7, 0.1))
    with pytest.raises(ValueError):
        pool.push(h, np.zeros((3, 100), np.float32))
    pool.detach(h)
    with pytest.raises((RuntimeError, KeyError)):
        pool.detach(h)
    pool = pools(setup, 2)[0]
    h = pool.attach()
    pool.push(h, np.zeros((4, 100), np.int16))
    with pytest.raises(ValueError, match="homogeneous"):
        pool.push(h, wave(7, 0.1))


def test_salsa_lite_pool_equals_solo_runs():
    """A salsa_lite pool (MIC, frame-local: no halo, no tracker): A from the start,
    B attached two blocks in and detached early, each equal to its solo streaming
    run, and no restart flag is scheduled for the joiner (no K2 runs)."""
    rng = np.random.default_rng(20261021)
    geo = dict(fs=FS, n_fft=N_FFT, hop_length=HOP, block_frames=L)
    j_model = j_build_model(encoder=ENC, decoder=DEC, n_classes=3)
    n_feat = StreamingExtractor("salsa_lite", "mic", device="cpu", **geo).n_features
    params, stats = flax_init(rng, j_model, np.zeros((1, 7, 64, n_feat), np.float32))
    scaler = (rng.normal(-5.0, 1.0, (4, 1, n_feat)).astype(np.float32),
              rng.uniform(5.0, 8.0, (4, 1, n_feat)).astype(np.float32))

    def pipe(n):
        return StreamingSeldPipeline(
            StreamingExtractor("salsa_lite", "mic", n_streams=n, device="cpu", **geo),
            build_model(encoder=ENC, decoder=DEC, n_classes=3),
            {"params": params, "batch_stats": stats}, scaler, 16 * 10 / (FS / HOP), 3,
            left_context=LEFT, right_context=RIGHT)

    wa, wb = wave(30, 6.0), wave(31, 2.0)
    pool = SeldStreamPool(pipe(2))
    ha, hb, got_a, got_b, pos_a, pos_b = pool.attach(), None, [], [], 0, 0
    while pos_a < wa.shape[1]:
        got_a += pool.push(ha, wa[:, pos_a:pos_a + PUSH])
        pos_a += PUSH
        if hb is None and pos_a >= 2 * TICK:
            hb = pool.attach()
        if hb is not None and pos_b < wb.shape[1]:
            got_b += pool.push(hb, wb[:, pos_b:pos_b + PUSH])
            pos_b += PUSH
            assert pool.ext._reinit == {}
            if pos_b >= wb.shape[1]:
                got_b += pool.detach(hb)
    got_a += pool.detach(ha)
    got_b += pool.poll(hb)
    assert pool.n_live == 0
    one = pipe(1)
    for got, w in ((got_a, wa), (got_b, wb)):
        one.reset()
        want = []
        for i in range(0, w.shape[1], PUSH):
            want += one.push(w[:, i:i + PUSH])
        want += one.flush()
        assert_outputs(got, want, 1e-5, 0)
        assert cat(got)[0].std() > 0.01  # the comparison is not vacuous
