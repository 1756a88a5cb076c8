"""What the traced run (`--trace 1`) records and how it is read.

* `Spans`: CUDA events around calls into the program's layers, named by layer,
  set up from the benchmark's side (wrappers and forward hooks) and only in the
  traced run; `totals()` gives each span's summed milliseconds and its count.
* `Session`: `torch.profiler` over the first `seconds` of the window (CPU and CUDA
  activity), marked by a `record_function` range so that the window's ends sit on
  the profiler's own clock. Stopping it and reading its rows takes seconds of the
  host, so what is timed on the host clock in a traced run is taken over the
  window's untraced rest, after the reading is made. Like the program's
  `utils.profiling.trace`, it counts the device events that came back, and a
  session with none is reported as not measured, never read as an idle card. It
  keeps no Chrome trace.
* `Reading`: the session's device rows reduced to what the per-layer metrics
  read: the union of kernel and copy intervals (a copy that overlaps a kernel is
  counted once), the idle gaps between them named by the host op running at the
  time, device time by row name, and the host-to-device copy with its guard: rows
  that add up to less than the link's least time for the bytes the window copied
  mean the profiler dropped the copy's row, and the copy is then not measured.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

WINDOW_MARK = "seldbench.traced_window"


class Spans:
    """Per-layer CUDA-event spans; inert where `enabled` is False."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._pairs: dict[str, list] = defaultdict(list)
        self._open: dict[str, list] = defaultdict(list)

    def begin(self, name: str) -> None:
        if self.enabled:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._open[name].append(ev)

    def end(self, name: str) -> None:
        if self.enabled:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._pairs[name].append((self._open[name].pop(), ev))

    def wrap(self, name: str, fn):
        """`fn` with a span around each call (as it is where spans are off)."""
        if not self.enabled:
            return fn

        def spanned(*args, **kwargs):
            self.begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self.end(name)

        return spanned

    def hook(self, name: str, module: torch.nn.Module) -> None:
        """A span around each forward call of `module`, by forward hooks."""
        if self.enabled:
            module.register_forward_pre_hook(lambda *_: self.begin(name))
            module.register_forward_hook(lambda *_: self.end(name))

    def totals(self) -> dict[str, tuple[float, int]]:
        """{name: (summed ms, count)}; waits for the card."""
        if not self.enabled:
            return {}
        torch.cuda.synchronize()
        return {name: (sum(a.elapsed_time(b) for a, b in pairs), len(pairs))
                for name, pairs in self._pairs.items()}


class Session:
    """The profiler over the traced part of the window; inert where `seconds` is
    None. `units` counts the timed calls inside it."""

    def __init__(self, seconds: float | None):
        self.seconds = seconds
        self.units = 0
        self.prof = None
        self._mark = None
        self._t0 = None
        self.reading: Reading | None = None
        self.stopped_at: float | None = None   # perf_counter once the reading is made

    @property
    def active(self) -> bool:
        return self.prof is not None and self.reading is None

    def start(self) -> None:
        if self.seconds is None:
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark = torch.profiler.record_function(WINDOW_MARK)
        self._mark.__enter__()
        self._t0 = time.perf_counter()

    def tick(self) -> None:
        """After each timed call: count it, and close the session once its
        seconds are up."""
        if not self.active:
            return
        self.units += 1
        if time.perf_counter() - self._t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.reading = Reading(self.prof.profiler.kineto_results.events())
        self.stopped_at = time.perf_counter()


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _dur_ns(e) -> int:
    return e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Reading:
    """A finished session's device rows within its window (ns on the profiler's
    clock)."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        self.window = None
        self.device_rows: list[tuple[str, int, int]] = []   # (name, start, end)
        self.host_ops: list[tuple[str, int, int]] = []
        annotations = {WINDOW_MARK}
        for e in events:
            name, a = e.name(), _start_ns(e)
            b = a + _dur_ns(e)
            if e.device_type() == DeviceType.CUDA:
                # kernels, copies and sets; a range's device-side shadow is no work
                kind = e.activity_type() if hasattr(e, "activity_type") else "kernel"
                if "annotation" not in str(kind) and not name.startswith("Activity Buffer"):
                    self.device_rows.append((name, a, b))
            elif name == WINDOW_MARK:
                self.window = (a, b)
            elif e.device_type() == DeviceType.CPU:
                self.host_ops.append((name, a, b))
                if e.is_user_annotation():
                    annotations.add(name)
        self.device_rows = [r for r in self.device_rows if r[0] not in annotations]
        if self.window is None:
            raise RuntimeError("the traced window's mark is missing from the profile")
        lo, hi = self.window
        self.device_rows = [(n, max(a, lo), min(b, hi)) for n, a, b in self.device_rows
                            if b > lo and a < hi]
        self.intervals = _merge([(a, b) for _, a, b in self.device_rows])

    @property
    def measured(self) -> bool:
        """Whether any device row came back (CUPTI may hand a session none)."""
        return bool(self.device_rows)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals) / 1e9

    def idle_share(self) -> float | None:
        return 1.0 - self.busy_s / self.window_s if self.measured else None

    def device_ms(self, contains: str) -> tuple[float, int]:
        """Summed ms and count of the device rows whose name holds `contains`."""
        rows = [(a, b) for n, a, b in self.device_rows if contains in n]
        return sum(b - a for a, b in rows) / 1e6, len(rows)

    def copy_ms(self, expected_bytes: int, link_bytes_per_s: float) -> float | None:
        """The host-to-device copy rows' ms; None where they add up to less than
        the link's least time for `expected_bytes` (a dropped row)."""
        ms, _ = self.device_ms("Memcpy HtoD")
        return None if ms < expected_bytes / link_bytes_per_s * 1e3 else ms

    def top_ops(self, n: int = 10) -> list[list]:
        by_name: dict[str, int] = defaultdict(int)
        for name, a, b in self.device_rows:
            by_name[name] += b - a
        top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:n]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The n longest idle stretches of the window, each named by the innermost
        host op running at its middle."""
        lo, hi = self.window
        edges = [lo] + [x for ab in self.intervals for x in ab] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        out = []
        for length, start in gaps:
            mid = start + length // 2
            covering = [(b - a, name) for name, a, b in self.host_ops if a <= mid < b]
            out.append([f"host: {min(covering)[1][:100]}" if covering else "host: python",
                        length / 1e9])
        return out


def idle_percent(run) -> float | None:
    """The card's idle share of the traced window, %: one minus the union of the
    kernel and copy intervals (a copy that overlaps a kernel is counted once)
    over the window."""
    idle = run.reading.idle_share()
    return None if idle is None else 100.0 * idle
