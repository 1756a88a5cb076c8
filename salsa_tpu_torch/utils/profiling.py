"""Profiling utilities (counterpart of `salsa_tpu.utils.profiling`).

* `span(name)`: the port's spans at its layer boundaries (`serve.*` in
  `pipeline.py`, `model.decoder` in `models/seld.py`, `train.*` and
  `setup.trainer` in `train/trainer.py`). Off a profiler session a span costs a
  state check and an aggregate update (`span_totals`); inside one it is also a
  `record_function` range and a record with its parent, root, host times on the
  profiler's clock and, on a card, its device time (`span_records`).
* `trace`: a context manager around `torch.profiler` recording the CPU and,
  where there is a card, CUDA activity, written as a Chrome trace
  (`trace.json`, for chrome://tracing or Perfetto) into `log_dir`; it counts the
  device events that came back and warns where CUDA was asked for and none did.
* `device_timer`: median seconds per call of a function; on a card between CUDA
  events after a warm-up call, on the CPU by `time.perf_counter`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os
import statistics
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

from salsa_tpu_torch.utils.experiments import logger

_now_ns = time.perf_counter_ns
# Each thread adds to aggregates of its own (no lock on the way), registered once
# under _lock; span_totals sums them.
_lock = threading.Lock()  # guards _thread_totals and _records
_thread_totals: list[dict[str, list[int]]] = []  # a thread's {name: [count, host ns]}
_records: list[SpanRecord] = []
_local = threading.local()  # .totals; .stack: the thread's open traced spans, innermost last
_ids = itertools.count(1)

# A process's first `record_function` spends up to a millisecond after the profiler
# stamps its start (Python-side set-up); one call here, with no session open, keeps
# a traced span's host start within microseconds of its range's.
with torch.autograd.profiler.record_function("salsa_tpu_torch.spans"):
    pass


@dataclasses.dataclass
class SpanRecord:
    """One span taken while a profiler session was open. `root` is the id of the
    outermost open span of its thread when it began (its own id where there was
    none): the request or step it belongs to. Host times are ns on the
    profiler's clock (the epoch's, `time.time_ns`), taken just inside its
    `record_function` range; `device_ms` is the time
    between the CUDA events recorded on the current stream at its ends (None
    where CUDA was not in use), filled in by `span_records`."""

    name: str
    id: int
    parent: int | None
    root: int
    host_start_ns: int
    host_end_ns: int | None = None
    device_ms: float | None = None
    _events: tuple | None = dataclasses.field(default=None, repr=False, compare=False)
    _range: object = dataclasses.field(default=None, repr=False, compare=False)


class span:
    """A named span of the port's work: a context manager, or a decorator that
    puts one around each call of a function.

    With no profiler session open it only adds its host time to its name's
    aggregate (`span_totals`: count and host seconds), so a long run holds one
    entry a name. Where a session of `torch.profiler.profile` (or
    `torch.autograd.profiler.profile`) is open it also opens a
    `record_function` range of its name (a row of the profiler and of `trace`'s
    Chrome trace), records CUDA events at its ends where CUDA is in use, and
    keeps a `SpanRecord` (`span_records`) with its parent and root spans."""

    __slots__ = ("name", "_t0", "_record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> span:
        # the flag `torch.profiler.profile` sets: a quarter of the C state check's cost
        self._record = _open_record(self.name) if _autograd_profiler._is_profiler_enabled else None
        self._t0 = _now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        ns = _now_ns() - self._t0
        try:
            totals = _local.totals
        except AttributeError:
            totals = _local.totals = _new_thread_totals()
        total = totals.get(self.name)
        if total is None:
            totals[self.name] = [1, ns]
        else:
            total[0] += 1
            total[1] += ns
        if self._record is not None:
            _close_record(self._record)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


def _new_thread_totals() -> dict[str, list[int]]:
    totals: dict[str, list[int]] = {}
    with _lock:
        _thread_totals.append(totals)
    return totals


def _open_record(name: str) -> SpanRecord:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    rid = next(_ids)
    parent = stack[-1] if stack else None
    rng = torch.autograd.profiler.record_function(name)
    rng.__enter__()
    rec = SpanRecord(name, rid, parent.id if parent else None, parent.root if parent else rid,
                     time.time_ns(), _range=rng)
    if torch.cuda.is_initialized():
        rec._events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        rec._events[0].record()
    stack.append(rec)
    with _lock:
        _records.append(rec)
    return rec


def _close_record(rec: SpanRecord) -> None:
    if rec._events is not None:
        rec._events[1].record()
    rec.host_end_ns = time.time_ns()
    rec._range.__exit__(None, None, None)
    rec._range = None
    _local.stack.remove(rec)


def span_records() -> list[SpanRecord]:
    """The records of the spans taken under a profiler session since the last
    `reset_spans`, in the order they began; waits for the card once and turns
    each finished span's CUDA events into `device_ms`."""
    with _lock:
        records = list(_records)
    pending = [r for r in records if r._events is not None and r.host_end_ns is not None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r.device_ms = r._events[0].elapsed_time(r._events[1])
            r._events = None
    return records


def span_totals() -> dict[str, tuple[int, float]]:
    """{name: (count, host seconds)} of every span since the last `reset_spans`,
    traced or not, over every thread."""
    out: dict[str, list[int]] = {}
    with _lock:
        for totals in _thread_totals:
            for name, (n, ns) in list(totals.items()):
                acc = out.setdefault(name, [0, 0])
                acc[0] += n
                acc[1] += ns
    return {name: (n, ns / 1e9) for name, (n, ns) in out.items()}


def reset_spans() -> None:
    """Forget the aggregates and the records (spans still open stay open)."""
    with _lock:
        for totals in _thread_totals:
            totals.clear()
        _records.clear()


def device_event_count(prof) -> int:
    """The device (CUDA) events a finished `torch.profiler.profile` recorded."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU activity, and CUDA activity where
    a card is present) and write its Chrome trace to `<log_dir>/trace.json`; yields
    the profiler (its `key_averages()` give the table). After the block the
    profiler's `device_events` is the number of device events that came back (None
    without a card). CUPTI can hand a session no device activity at all; the trace
    then holds the host's rows only, and a warning says so."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield prof
    prof.device_events = device_event_count(prof) if cuda else None
    if cuda and not prof.device_events:
        logger.warning("profiling.trace: CUDA activity was asked for and no device event "
                       "came back; %s holds the host's rows only", path)
    prof.export_chrome_trace(path)


def _synchronize(device: torch.device | None) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _first_device(out) -> torch.device | None:
    """The device of the first tensor in `out` (a tensor or a nest of them)."""
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, (list, tuple)):
        for o in out:
            d = _first_device(o)
            if d is not None:
                return d
    if isinstance(out, dict):
        return _first_device(list(out.values()))
    return None


def device_timer(fn, *args, iters: int = 5) -> float:
    """Median seconds per call of fn(*args), after one warm-up call: on a card
    (fn's first output tensor on CUDA) each call timed between CUDA events on the
    current stream, on the CPU by perf_counter."""
    dev = _first_device(fn(*args))  # warm-up: builds and caches what fn needs
    _synchronize(dev)
    times = []
    for _ in range(iters):
        if dev is not None and dev.type == "cuda":
            with torch.cuda.device(dev):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return float(statistics.median(times))
