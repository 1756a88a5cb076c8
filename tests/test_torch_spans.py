"""The port's spans (`salsa_tpu_torch.utils.profiling.span`) on the CPU: off a
profiler session only aggregates, inside one `record_function` ranges and records
that nest and sit on the profiler's clock; the serving and training spans where
the layers meet, with outputs bit-equal with spans on and off; and the benchmark's
readers of them (`seldbench/metrics/`) on made-up records and profiles."""
import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from salsa_tpu_torch.data import wav_database as twav  # noqa: E402
from salsa_tpu_torch.data.database import SeldDatabase  # noqa: E402
from salsa_tpu_torch.features.registry import make_extractor  # noqa: E402
from salsa_tpu_torch.models.seld import build_model, init_random_  # noqa: E402
from salsa_tpu_torch.pipeline import SeldInferencePipeline  # noqa: E402
from salsa_tpu_torch.train.trainer import SeldTrainer  # noqa: E402
from salsa_tpu_torch.utils import profiling  # noqa: E402
from salsa_tpu_torch.utils.config import AttrDict  # noqa: E402
from seldbench import tracing  # noqa: E402
from seldbench.manifest import Manifest  # noqa: E402
from tests.test_from_wav import E2E_NFFT, _write_synth_corpus  # noqa: E402
from tests.test_torch_pipeline import DEC, ENC, FS, INTERP, N_CLASSES, foa_clips  # noqa: E402
from tests.test_torch_trainer import GEOMETRY, trainer_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_READERS = ("decoder_ms.serve", "program_idle_ms.serve", "program_idle_ms.train",
               "backward_ms.train", "optimizer_ms.train", "trainer_setup_s.train")


@pytest.fixture(autouse=True)
def _fresh_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def host_ranges(prof) -> dict[str, list[tuple[int, int]]]:
    """The host rows of a finished session by name: (start, end) ns, in order."""
    out: dict[str, list[tuple[int, int]]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def tree(records) -> dict[str, set[str]]:
    """{name: the names of its parents}."""
    by_id = {r.id: r for r in records}
    out: dict[str, set[str]] = {}
    for r in records:
        out.setdefault(r.name, set()).add(by_id[r.parent].name if r.parent else None)
    return out


# ----------------------------------------------------------------------------------
def test_spans_off_a_session_keep_only_aggregates(monkeypatch):
    """No session: no record, no `record_function`, no CUDA event; the aggregates
    count every span, as a context manager and as a decorator."""
    def refuse(*a, **k):
        raise AssertionError("called with no profiler session open")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)

    @profiling.span("outer")
    def outer():
        with profiling.span("inner"):
            pass

    for _ in range(3):
        outer()
    with pytest.raises(ValueError), profiling.span("inner"):
        raise ValueError("a span closes on an exception")
    assert profiling.span_records() == []
    totals = profiling.span_totals()
    assert {k: n for k, (n, _) in totals.items()} == {"outer": 3, "inner": 4}
    assert totals["outer"][1] >= 0.0
    profiling.reset_spans()
    assert profiling.span_totals() == {} and profiling.span_records() == []


def test_aggregates_lose_no_count_across_threads():
    """16 threads, each 2,000 spans, the interpreter switching threads every
    microsecond: every span is counted."""
    n_threads, n_spans = 16, 2000
    interval = sys.getswitchinterval()

    def work():
        for _ in range(n_spans):
            with profiling.span("busy"):
                pass

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.span_totals()["busy"][0] == n_threads * n_spans


def test_spans_in_a_session_nest_and_sit_on_the_profilers_clock():
    """In a CPU session: records carry parent and root, the profiler holds a range
    of each span's name, and each record's host start lies within 1 ms of its
    range's start (the profiler's clock is the epoch's)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with profiling.span("a"):
                with profiling.span("b"):
                    with profiling.span("c"):
                        torch.ones(8) * 2
                with profiling.span("b"):
                    pass
    with profiling.span("after"):  # the session is closed: aggregated only
        pass
    records = profiling.span_records()
    assert [r.name for r in records] == ["a", "b", "c", "b"] * 2
    for a, b, c, b2 in (records[:4], records[4:]):
        assert a.parent is None and a.root == a.id
        assert b.parent == a.id and b2.parent == a.id and c.parent == b.id
        assert {b.root, c.root, b2.root} == {a.id}
        assert all(r.device_ms is None for r in (a, b, c, b2))  # no card
    assert records[0].id != records[4].id
    ranges = host_ranges(prof)
    for name in "abc":
        mine = [r for r in records if r.name == name]
        assert len(ranges[name]) == len(mine)
        for rec, (start, end) in zip(mine, ranges[name]):
            assert abs(rec.host_start_ns - start) < 1_000_000
            assert rec.host_start_ns <= rec.host_end_ns and abs(rec.host_end_ns - end) < 1_000_000
    assert "after" not in ranges
    assert {k: n for k, (n, _) in profiling.span_totals().items()} == {
        "a": 2, "b": 4, "c": 2, "after": 1}


# ----------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pipe():
    rng = np.random.default_rng(20261018)
    model = init_random_(build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES),
                         torch.Generator().manual_seed(3))
    scaler = (rng.normal(-5.0, 1.0, (4, 1, 200)).astype(np.float32),
              rng.uniform(5.0, 8.0, (4, 1, 200)).astype(np.float32))
    return (SeldInferencePipeline(make_extractor("salsa", "foa", fs=FS), model, None, scaler,
                                  INTERP, N_CLASSES, device="cpu"),
            foa_clips(rng, 2, 1.6))


def test_serving_spans_nest_and_leave_the_answers_bit_equal(pipe):
    """`serve.request` holds `serve.h2d`, `serve.features` and `serve.model`, which
    holds `model.decoder`; the answers with spans on (a session) and off are the
    same bits."""
    p, waves = pipe
    off = p(waves)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = p(waves)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    records = profiling.span_records()
    assert tree(records) == {"serve.request": {None}, "serve.h2d": {"serve.request"},
                             "serve.features": {"serve.request"},
                             "serve.model": {"serve.request"},
                             "model.decoder": {"serve.model"}}
    assert len({r.root for r in records}) == 1
    assert set(tree(records)) <= set(host_ranges(prof))
    assert profiling.span_totals()["serve.request"][0] == 2


def test_training_spans_nest(tmp_path):
    """A from-wav `train_step`: `train.step` holds `train.batch`,
    `train.forward_backward` (which holds `train.backward`) and `train.optimizer`;
    the trainer's set-up is one `setup.trainer` span."""
    torch.manual_seed(0)
    rng = np.random.default_rng(20261018)
    root = str(tmp_path)
    _, meta_dir = _write_synth_corpus(root, rng, n_clips=2, seconds=4.0)
    kw = dict(fs=GEOMETRY["fs"], n_fft=E2E_NFFT, hop_length=GEOMETRY["hop_len"], fmax_doa=3000.0)
    ex = make_extractor("salsa", "foa", **kw)
    db = SeldDatabase(store=twav.MemoryFeatureStore({}, None), gt_meta_root_dir=root,
                      **GEOMETRY)
    db.n_fft = E2E_NFFT
    split = twav.load_wav_split(db, "train", os.path.join(root, "foa_dev"),
                                split_meta_dir=meta_dir, n_channels=7, n_features=ex.n_features)
    scaler = (np.zeros((4, 1, ex.n_features), np.float32),
              np.ones((4, 1, ex.n_features), np.float32))
    dec = dict(DEC, decoder_type="bigru")
    tr = SeldTrainer(build_model(encoder=ENC, decoder=dec, n_classes=3),
                     AttrDict(trainer_config()), split, None, None, "", seed=7, scaler=scaler,
                     device="cpu")
    assert profiling.span_totals()["setup.trainer"][0] == 1
    with profile(activities=[ProfilerActivity.CPU]):
        loss = tr.train_step(np.arange(2))["loss"]
    assert np.isfinite(float(loss))
    records = profiling.span_records()
    assert tree(records) == {"train.step": {None}, "train.batch": {"train.step"},
                             "train.forward_backward": {"train.step"},
                             "train.backward": {"train.forward_backward"},
                             "model.decoder": {"train.forward_backward"},
                             "train.optimizer": {"train.step"}}
    assert len({r.root for r in records}) == 1


# ----------------------------------------------------------------------------------
def reader(name):
    return Manifest(REPO).reader(name)


def rec(name, rid, parent, root, ms):
    return profiling.SpanRecord(name, rid, parent, root, 0, 1, ms)


@pytest.mark.parametrize("metric,root,name", [
    ("decoder_ms.serve", "serve.request", "model.decoder"),
    ("backward_ms.train", "train.step", "train.backward"),
    ("optimizer_ms.train", "train.step", "train.optimizer")])
def test_span_readers_sum_under_roots_over_roots(monkeypatch, metric, root, name):
    """Device ms of the spans under the cell's roots over the number of roots;
    spans under another root are left out; no root reads None."""
    records = [rec(root, 1, None, 1, 50.0), rec("mid", 2, 1, 1, 40.0), rec(name, 3, 2, 1, 3.0),
               rec(name, 4, 2, 1, 2.0), rec(root, 5, None, 5, 50.0), rec(name, 6, 5, 5, 7.0),
               rec("other", 7, None, 7, 9.0), rec(name, 8, 7, 7, 100.0)]
    monkeypatch.setattr(profiling, "span_records", lambda: records)
    assert reader(metric).read(None) == pytest.approx(6.0)
    monkeypatch.setattr(profiling, "span_records", lambda: records[6:])
    assert reader(metric).read(None) is None


class Row:
    """A profiler row as `tracing.Reading` reads it."""

    def __init__(self, name, start, end, device=DeviceType.CUDA, kind="kernel", note=False):
        self._v = (name, start, end, device, kind, note)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]

    def activity_type(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def host(name, a, b):
    return Row(name, a, b, DeviceType.CPU, "user_annotation", True)


@pytest.mark.parametrize("metric,root", [("program_idle_ms.serve", "serve.request"),
                                          ("program_idle_ms.train", "train.step")])
def test_idle_readers_count_idle_inside_roots(metric, root):
    """Window 0-10 ms, kernels 1-3 and 6-8 ms: idle 0-1, 3-6 and 8-10 ms. Roots
    0.5-4 and 5-9 ms cover 0.5 + 1 + 1 + 1 ms of it (the gap at 3-6 ms half
    inside each), 3.5 ms over 2 roots; the roots' device-side shadows and other
    ranges count for nothing. A window with no root reads None."""
    ms = 1_000_000
    rows = [host(tracing.WINDOW_MARK, 0, 10 * ms),
            Row("k1", 1 * ms, 3 * ms), Row("k2", 6 * ms, 8 * ms),
            host("other", 0, 10 * ms)]
    roots = [host(root, ms // 2, 4 * ms), host(root, 5 * ms, 9 * ms),
             Row(root, ms // 2, 4 * ms, kind="gpu_user_annotation")]
    run = SimpleNamespace(reading=tracing.Reading(rows + roots))
    assert reader(metric).read(run) == pytest.approx(1.75)
    assert tracing.Reading(rows + roots).idle_share() == pytest.approx(0.6)
    assert reader(metric).read(SimpleNamespace(reading=tracing.Reading(rows))) is None


def test_trainer_setup_reader_reads_the_span_aggregate():
    assert reader("trainer_setup_s.train").read(None) is None
    with profiling.span("setup.trainer"):
        pass
    seconds = reader("trainer_setup_s.train").read(None)
    assert seconds == profiling.span_totals()["setup.trainer"][1] and 0.0 <= seconds < 1.0


@pytest.mark.parametrize("metric", [m for m in NEW_READERS if "idle" not in m])
def test_readers_read_nothing_from_a_program_without_spans(monkeypatch, metric):
    """A program without the recorder (an older checkout of the port) reads None and
    raises nothing."""
    monkeypatch.delattr(profiling, "span_records")
    monkeypatch.delattr(profiling, "span_totals")
    assert reader(metric).read(None) is None


def test_new_metrics_are_in_the_benchmark_with_their_cells():
    per_layer = {m["name"]: m for m in Manifest(REPO).bench["per_layer"]}
    for name in NEW_READERS:
        cell = "serve" if name.endswith(".serve") else "train"
        assert all(w.endswith("." + cell) for w in per_layer[name]["workloads"])
        assert callable(reader(name).read)
