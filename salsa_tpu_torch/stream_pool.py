"""Dynamic multi-stream SELD serving (counterpart of `salsa_tpu.stream_pool`):
attach and detach live streams on a fixed pool of slots, all served by one block
dispatch of `StreamingSeldPipeline` per pool block.

* A joining stream is aligned to the next pool block boundary, where its slot is
  seeded with a solo stream's start prefix (pre-stream zeros and the reflect pad,
  `StreamingExtractor.write_slot_seed`), its noise tracker starts afresh from its
  own first window (`schedule_tracker_reinit`: K2's clip-start init for that row
  while the other slots carry theirs; a frame-local feature type has no tracker,
  so no restart flag is raised), and the blocks before it are pad blocks
  through the per-slot validity vectors; so every prediction it emits is a solo
  run's on the same samples.
* A detaching stream drains as a solo flush: its trailing reflect pad rides the
  packet path, its slot's `hi` masks frames past its end, and its last block's
  label frames are trimmed, while the other streams play on.
* A freed slot takes a new stream, whose seed and tracker init erase the previous
  occupant.

Clock policy. By default the pool clock advances in lock-step with the slowest
live stream: exact, but a stalled client holds every other stream. With `max_lag`
(samples), when a stream's backlog grows more than `max_lag` above its own low
watermark, the laggard's slot is zero-filled up to the allowed lag; the late
stream's filled label frames are reported by `fill_report()` /
`fill_label_ranges()`. A pending joiner may queue one block while it waits for its
boundary before its backlog counts. A clip that detached while pending (promoted,
shorter than a block) counts all its queued samples, so a silent live peer holds
its activation back by at most `max_lag` samples (`salsa_tpu` counts its queue
less a block there, which for such a clip is never positive, and activates it only
through `tick()`). `tick()` is the wall-clock hook for the case no backlog can
show: every live client silent while detached streams drain. With no live stream
left, the pool fast-forwards on zeros so the drains complete.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from salsa_tpu_torch.streaming import StreamingExtractor, StreamingSeldPipeline


@dataclass
class _Stream:
    slot: int
    state: str  # 'pending' | 'live' | 'draining' | 'done'
    queue: list[np.ndarray] = field(default_factory=list)
    queued: int = 0
    first_block: int | None = None
    samples: int = 0             # true stream samples pushed (pre-tail)
    zfill: int = 0               # concealment zeros inserted by the stall policy
    fills: list = field(default_factory=list)  # [start, end) stream-local samples
    lag_floor: int | None = None  # low watermark of queued (stall-policy base)
    cache: np.ndarray | None = None  # rolling last pad+1 samples (tail source)
    eof: bool = False            # detach() arrived while still pending
    last_block: int | None = None
    trim: int | None = None      # final-block label frames (None: full block)
    out: list = field(default_factory=list)


class SeldStreamPool:
    """A fixed-capacity pool of live SELD streams over one fused pipeline.

    handle = pool.attach()              # reserve a slot (None if full)
    preds  = pool.push(handle, samples) # (C, n) samples -> [(ev, doa), ...]
    preds += pool.detach(handle)        # end of stream: the tail predictions
    pool.poll(handle)                   # collect without pushing

    Predictions surface per handle as the shared pool clock completes blocks;
    each stream's outputs are exactly a solo StreamingSeldPipeline's for the
    same samples (including the flush tail), label-rate, in stream order.

    max_lag (samples, optional) bounds head-of-line blocking: a live stream
    whose client stops pushing only holds the other streams back by max_lag
    samples of the healthy streams' backlog GROWTH (measured above each
    stream's own low watermark — a joiner's permanent activation backlog
    doesn't count), after which its slot is zero-filled (see module
    docstring). Clients may burst up to max_lag samples per push without
    ever triggering concealment; a natural setting is one block
    (`pipeline.extractor.block_frames * pipeline.extractor.hop`). None
    (default) keeps the exact lock-step clock.
    """

    def __init__(self, pipeline: StreamingSeldPipeline,
                 max_lag: int | None = None):
        ext = pipeline.extractor
        self.pipe = pipeline
        self.ext: StreamingExtractor = ext
        self.capacity = ext.n_streams
        self.max_lag = None if max_lag is None else int(max_lag)
        self._L = ext.block_frames
        self._hop = ext.hop
        self._tick = self._L * self._hop
        self._pad = ext._pad
        self._total = 0        # pool global samples ingested
        self._dtype: np.dtype | None = None  # fixed by the first push
        self._force = 0        # tick(): zero-fill advance budget (samples)
        self._n_out = 0        # pool block index of the next emitted prediction
        self._next_handle = 0
        self._streams: dict[int, _Stream] = {}
        self._free = list(range(self.capacity))

    # -- public API -----------------------------------------------------------

    def attach(self) -> int | None:
        """Reserve a slot for a new stream; returns its handle, or None when
        the pool is full. The stream goes live at the next pool block boundary
        once at least required_pad+1 of its samples have been pushed."""
        if not self._free:
            return None
        slot = self._free.pop(0)
        h = self._next_handle
        self._next_handle += 1
        self._streams[h] = _Stream(slot=slot, state="pending")
        return h

    def push(self, handle: int, samples: np.ndarray) -> list:
        """Feed (n_channels, n) samples for one stream; returns every
        completed (event_prob, doa_xyz) label-rate block of THAT stream
        (other streams' completed blocks buffer until their own push/poll)."""
        s = self._stream(handle)
        if s.state not in ("pending", "live"):
            raise RuntimeError(f"stream {handle} is {s.state}")
        samples = np.asarray(samples)
        if samples.dtype != np.int16:
            samples = samples.astype(np.float32, copy=False)
        if self._dtype is None:
            self._dtype = samples.dtype
        elif samples.dtype != self._dtype:
            if self._dtype == np.float32 and samples.dtype == np.int16:
                # a float32 pool accepts int16 clients: decode host-side
                # (exact — int16/2^15 is representable in float32); only an
                # all-int16 pool keeps int16 on the wire (the bandwidth win)
                samples = samples.astype(np.float32) * (1.0 / 32768.0)
            else:
                raise ValueError(
                    f"pool dtype is {self._dtype} (fixed by the first push) "
                    f"and an int16 pool is homogeneous, got {samples.dtype}")
        if samples.ndim != 2 or samples.shape[0] != self.ext.n_channels:
            raise ValueError(f"expected ({self.ext.n_channels}, n) samples, "
                             f"got {samples.shape}")
        if samples.shape[1]:
            s.queue.append(samples)
            s.queued += samples.shape[1]
            s.samples += samples.shape[1]
            tail = (samples if s.cache is None
                    else np.concatenate([s.cache, samples], axis=1))
            s.cache = tail[:, -(self._pad + 1):]
        self._drain()
        return self.poll(handle)

    def poll(self, handle: int) -> list:
        """Collect a stream's buffered predictions without pushing samples.
        A fully-collected finished handle returns [] (it is forgotten once
        drained, so polling after the end is always safe)."""
        s = self._streams.get(handle)
        if s is None:
            return []
        out, s.out = s.out, []
        if s.state == "done" and not out:
            del self._streams[handle]
        return out

    def detach(self, handle: int) -> list:
        """End a stream: enqueue its solo-flush tail (trailing reflect pad),
        mask everything past its true end, and free the slot once its last
        prediction emits. Returns the predictions available immediately —
        when no other live stream gates the pool clock, that is ALL of them
        (the pool fast-forwards on zeros); otherwise the rest surface via
        poll() as the remaining streams advance the clock.

        A still-pending stream with at least required_pad+1 queued samples is
        PROMOTED rather than discarded: it goes live at the next boundary and
        immediately drains, so even a clip shorter than one pool block (fully
        pushed between boundaries) gets its complete solo predictions. Only a
        pending stream too short to ever seed a slot (< required_pad+1
        samples, ~n_fft/2) is dropped."""
        s = self._stream(handle)
        if s.state == "pending":
            if s.queued < self._pad + 1:
                self._free.append(s.slot)
                del self._streams[handle]
                return []
            s.eof = True  # promote at the next boundary, then drain
            self._drain()
            return self.poll(handle)
        if s.state != "live":
            raise RuntimeError(f"stream {handle} is {s.state}")
        self._begin_drain(s)
        self._drain()
        return self.poll(handle)

    def tick(self, n_samples: int | None = None) -> None:
        """Wall-clock hook: real time passed without samples — advance the
        pool clock by up to `n_samples` (default one block), zero-filling
        every live stream's shortfall, so draining streams finish and healthy
        streams are not held hostage when EVERY live client goes silent (the
        case `max_lag`'s relative trigger cannot see). No-op while nothing is
        live or draining. Exactness caveat as for max_lag: filled streams'
        affected frames are concealment output (see fill_report)."""
        if not any(s.state in ("live", "draining")
                   for s in self._streams.values()):
            return
        self._force = self._tick if n_samples is None else int(n_samples)
        try:
            self._drain()
        finally:
            self._force = 0

    def finished(self, handle: int) -> bool:
        """True once a detached stream's every prediction has been collected
        (poll() forgets the handle at that point); unknown handles are
        finished by definition, so callers can loop `until finished`."""
        s = self._streams.get(handle)
        if s is None:
            return True
        if s.state == "done" and not s.out:
            del self._streams[handle]  # same forget-once-drained as poll()
            return True
        return False

    def fill_report(self, handle: int) -> list[tuple[int, int]]:
        """The [start, end) stream-local SAMPLE ranges the stall policy
        zero-filled so far (empty under the default exact clock). Predictions
        over these ranges are concealment output; the stream's later samples
        land after the gap, delayed by the accumulated fill."""
        s = self._streams.get(handle)
        return [] if s is None else [tuple(r) for r in s.fills]

    def fill_label_ranges(self, handle: int) -> list[tuple[int, int]]:
        """fill_report converted to label-frame ranges [start, end) on the
        stream's prediction timeline (the unit push()/detach() outputs are
        in), conservatively widened to whole label frames."""
        ds, ir = self.pipe.ds, self.pipe.interp_ratio
        out = []
        for a, b in self.fill_report(handle):
            lo = int(np.floor(a / self._hop / ds) * ir)
            hi = int(np.ceil((b / self._hop + 1) / ds) * ir)
            if out and lo <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], hi))
            else:
                out.append((lo, hi))
        return out

    @property
    def n_live(self) -> int:
        return sum(s.state in ("live", "draining")
                   for s in self._streams.values())

    # -- pool clock -----------------------------------------------------------

    def _stream(self, handle: int) -> _Stream:
        try:
            return self._streams[handle]
        except KeyError:
            raise KeyError(f"unknown stream handle {handle}") from None

    def _begin_drain(self, s: _Stream) -> None:
        """Transition a live stream into draining: enqueue its solo-flush tail
        and pin its final block + label trim from its effective length
        (pushed samples + any concealment fill)."""
        eff = s.samples + s.zfill
        total = self.ext.total_frames(eff)  # solo frame count
        tail = s.cache[:, -(self._pad + 1) : -1][:, ::-1]  # librosa right refl
        s.queue.append(tail)
        s.queued += tail.shape[1]
        s.state = "draining"
        n_blocks = -(-total // self._L)
        s.last_block = s.first_block + n_blocks - 1
        rem = total - (n_blocks - 1) * self._L
        if rem < self._L:  # partial final block: trim its label frames
            s.trim = int(round(np.floor(rem / self.pipe.ds)
                               * self.pipe.interp_ratio))

    def _advance_m(self, to_boundary: int) -> int:
        """Samples to advance the pool clock this round: the exact lock-step
        amount, raised by the stall policy (max_lag) and tick() force."""
        feeders = [s for s in self._streams.values() if s.state == "live"]
        draining = any(s.state == "draining" for s in self._streams.values())
        if feeders:
            m = min(min(s.queued for s in feeders), to_boundary)
        elif draining:
            m = to_boundary  # zeros fast-forward to finish the drains
        elif any(s.eof and s.queued >= self._pad + 1
                 for s in self._streams.values() if s.state == "pending"):
            m = to_boundary  # reach the boundary so promotion can activate
        else:
            return 0
        if feeders:
            if self._force > 0:
                m = max(m, min(self._force, to_boundary))
            elif self.max_lag is not None:
                # Clock demand = backlog GROWTH, not absolute backlog. A live
                # feeder's demand is its queued samples above its own low
                # watermark (lag_floor): a mid-block joiner activates with up
                # to one block of accumulated backlog that is PERMANENT (its
                # predictions are simply delayed by it) and must not read as
                # "the other streams are stalled" — only backlog a stream
                # accrues beyond its floor means the clock is being gated.
                # A pending joiner legitimately queues up to one block while
                # waiting for its activation boundary, so its demand is the
                # excess beyond one block (a silent live stream must not gate
                # a joiner forever, but a healthy paced pool must never fill
                # on account of a normal join).
                demand = []
                for s in feeders:
                    if s.lag_floor is None:
                        s.lag_floor = s.queued
                    else:
                        s.lag_floor = min(s.lag_floor, s.queued)
                    demand.append(s.queued - s.lag_floor)
                # a clip that detached while pending will queue no more: its whole
                # queue is demand (salsa_tpu takes queued - tick here too, never
                # positive for a clip shorter than a block)
                demand += [s.queued if s.eof else s.queued - self._tick
                           for s in self._streams.values()
                           if s.state == "pending"
                           and s.queued >= self._pad + 1]
                m = max(m, min(max(demand) - self.max_lag, to_boundary))
        return m

    def _drain(self) -> None:
        """Advance the pool clock as far as the streams (and the stall
        policy) allow; see _advance_m for the clock rules."""
        ext = self.ext
        guard = 0
        while True:
            guard += 1
            if guard > 100_000:  # a bug, not a workload: fail loudly
                raise RuntimeError("pool clock failed to converge")
            if self._total % self._tick == 0:
                self._activate_ready()
            to_boundary = self._tick - self._total % self._tick
            m = self._advance_m(to_boundary)
            if m <= 0:
                return
            if self._force:
                self._force = max(0, self._force - m)
            packet = np.zeros((self.capacity, self.ext.n_channels, m),
                              self._dtype or np.float32)
            for s in self._streams.values():
                if s.state not in ("live", "draining"):
                    continue
                n = min(m, s.queued)
                if n:
                    packet[s.slot, :, :n] = self._pop(s, m)
                if n < m and s.state == "live":
                    self._record_fill(s, n, m)
            # n_streams=1 extractors keep the plain (C, n) API
            ext.ingest(packet[0] if self.capacity == 1 else packet)
            self._total += m
            self._pump()

    def _record_fill(self, s: _Stream, n: int, m: int) -> None:
        """Bookkeeping for concealment zeros fed to a live laggard: extend its
        effective timeline (zfill + the rolling tail cache, so a later detach
        reflects the timeline's true end) and log the filled range."""
        pos0 = self._total - s.first_block * self._tick  # stream-local clock
        a, b = pos0 + n, pos0 + m
        if s.fills and s.fills[-1][1] == a:
            s.fills[-1][1] = b
        else:
            s.fills.append([a, b])
        s.zfill += m - n
        zeros = np.zeros((self.ext.n_channels, m - n),
                         s.cache.dtype if s.cache is not None else np.float32)
        tail = (zeros if s.cache is None
                else np.concatenate([s.cache, zeros], axis=1))
        s.cache = tail[:, -(self._pad + 1):]

    def _activate_ready(self) -> None:
        """Go-live for pending streams at this exact block boundary: seed the
        slot's padded timeline, schedule its tracker re-init, record its block
        offset. Needs required_pad+1 queued samples (the reflect source).
        A stream whose detach() arrived while pending (eof) immediately
        transitions to draining — the promotion path."""
        k = self._total // self._tick
        for s in self._streams.values():
            if s.state != "pending" or s.queued < self._pad + 1:
                continue
            if self._total:
                first = s.queue[0]
                while first.shape[1] < self._pad + 1:  # coalesce tiny pushes
                    s.queue = [np.concatenate(s.queue[:2], axis=1)] + s.queue[2:]
                    first = s.queue[0]
                self.ext.write_slot_seed(
                    s.slot, first[:, : self._pad + 1], k * self._L)
                self.ext.schedule_tracker_reinit(s.slot, k * self._L)
            s.state = "live"
            s.first_block = k
            if s.eof:
                self._begin_drain(s)

    def _pop(self, s: _Stream, m: int) -> np.ndarray:
        take, got = [], 0
        while got < m and s.queue:
            a = s.queue[0]
            n = min(a.shape[1], m - got)
            take.append(a[:, :n])
            got += n
            if n == a.shape[1]:
                s.queue.pop(0)
            else:
                s.queue[0] = a[:, n:]
        s.queued -= got
        return np.concatenate(take, axis=1) if len(take) > 1 else take[0]

    def _pump(self) -> None:
        """Extract+predict every block the ingested samples completed, with
        per-slot validity windows, and distribute the emitted predictions."""
        ext = self.ext
        while (inp := ext._next_input()) is not None:
            res, state_out = self.pipe._run_step(*inp, self._hi(ext._next_frame // self._L))
            ext._commit(state_out)
            if res is not None:
                self._distribute(res)

    def _hi(self, blk: int) -> np.ndarray:
        """Each slot's live frames [0, hi) of pool block blk."""
        hi = np.zeros((self.capacity,), np.int32)
        for s in self._streams.values():
            if s.first_block is None or blk < s.first_block:
                continue
            if s.state == "live":
                hi[s.slot] = self._L
            elif s.state == "draining":
                # frames of this block before the stream's true end
                end = (s.first_block - blk) * self._L + self.ext.total_frames(
                    s.samples + s.zfill)
                hi[s.slot] = np.clip(end, 0, self._L)
        return hi

    def _distribute(self, res) -> None:
        ev, doa = res
        if self.capacity == 1:  # _run_step squeezes the stream axis at N=1
            ev, doa = ev[None], doa[None]
        k = self._n_out
        self._n_out += 1
        for s in self._streams.values():
            if (s.first_block is None or s.state not in ("live", "draining")
                    or k < s.first_block):
                continue
            if s.last_block is not None and k > s.last_block:
                continue
            e, d = ev[s.slot], doa[s.slot]
            if s.last_block is not None and k == s.last_block:
                if s.trim is not None:
                    e, d = e[: s.trim], d[: s.trim]
                s.state = "done"
                self._free.append(s.slot)
            s.out.append((e, d))
