"""Streaming (online) SELD (counterpart of `salsa_tpu.streaming`): push raw
multichannel samples, pull feature blocks and label-rate predictions block by
block.

Each block of `block_frames` feature frames is extracted from a contiguous sample
window holding its frames and, for SALSA, `n_hopframes` covariance-context frames
a side (`features/chunked.py::make_block_fn`). A SALSA block is one DFT matmul,
one K2 launch resumed from the tracker state the block before left (state in,
state out) and one K1 launch for all N streams. The first block starts every
stream's tracker with K2's own clip-start init; a pool slot that starts a stream
at a later block gets that init from its own window while the other slots carry
theirs. The frame-local types (every other type) have no halo and no tracker: a
block is their DFT matmuls alone, and the GCC types' window holds the double-length
FFT of every frame.

Semantics, as in `salsa_tpu`: the stream starts with `n_hopframes` frames of
pre-stream zeros before librosa's reflect pad (a live stream cannot wrap its edges
as the offline extractor does), so the first and last `n_hopframes` frames use zero
context; every interior frame is the offline frame, and the tracker's init reads
the pre-stream zeros in its first two magnitudes. `flush()` lays down the offline
extractor's trailing reflect pad.

Latency: feature stage `n_hopframes` frames of lookahead; prediction stage
`right_context` frames plus the block itself. At the flagship geometry (fs 24 kHz,
hop 300, block 160, context 256) that is 160 + 256 + 3 frames = 5.2 s.

Samples are float32 or int16 PCM; int16 stays int16 up to the device, where
`chunked.block_spectra` decodes it as x / 32768 (exact: every int16 / 2^15 is a
float32), so an int16 stream gives the features of pushing those floats, bit for
bit, at half the upload. The host buffer holds the N streams as N * C rows,
mirrored on the device as samples arrive, through pinned staging buffers; each
block's window is sliced from the mirror, which slides by copying into a second
buffer.
Entry points run on the first CUDA card unless built with device="cpu", where the
kernels' plain versions run.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from salsa_tpu_torch.features.chunked import (
    FUSED_FEATURE_TYPES,
    block_window_len,
    make_block_fn,
    make_chunk_extractor,
    required_pad,
)
from salsa_tpu_torch.features.salsa import SalsaParams
from salsa_tpu_torch.pipeline import OUTPUT_FORMATS, heads, load_weights, normalize


def _require_device(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("streaming runs on a CUDA card and torch sees none; pass "
                           "device='cpu' to run the kernels' plain versions on the CPU")
    return device


class StreamingExtractor:
    """Push-based feature extraction: feed (n_ch, n) sample arrays of any size,
    receive completed (n_feat_ch, block_frames, F) feature blocks.

    Keeps a rolling sample buffer on the offline extractor's padded timeline
    (frame t starts at padded sample t * hop; the stream start is seeded with the
    reflect pad once enough samples arrive) and, for SALSA with tracking, the
    noise-floor tracker state entering the next block.
    """

    def __init__(self, feature_type: str = "salsa", audio_format: str = "foa",
                 fs: int = 24000, n_fft: int = 512, hop_length: int = 300,
                 block_frames: int = 160, n_channels: int = 4, n_streams: int = 1,
                 device: torch.device | str = "cuda", **kwargs):
        if feature_type not in FUSED_FEATURE_TYPES:
            raise ValueError(f"streaming supports feature types {FUSED_FEATURE_TYPES}; "
                             f"got '{feature_type}'")
        self.device = _require_device(device)
        self.feature_type = feature_type
        self.audio_format = audio_format
        self.fs = fs
        self.n_fft = n_fft
        self.hop = hop_length
        self.block_frames = int(block_frames)
        self.n_channels = n_channels
        # N synchronized streams share one block clock: push (N, C, n) packets;
        # N = 1 keeps the plain (C, n) API
        self.n_streams = int(n_streams)
        # make_chunk_extractor checks the feature type and options and sets its
        # parameters; a block is the contiguous form of its chunk
        _, params = make_chunk_extractor(feature_type, audio_format, self.block_frames, fs,
                                         n_fft, hop_length, **kwargs)
        self._block_fn = make_block_fn(params, self.block_frames)
        self.params = params
        salsa = isinstance(params, SalsaParams)
        # only SALSA with tracking carries a tracker state from block to block
        self._tracking = salsa and params.is_tracking
        self.n_feat_channels = 7 if salsa else params.n_channels
        self.n_features = params.freq_dim if salsa else params.n_features
        self.halo = params.n_hopframes if salsa else 0  # covariance context frames a side
        self._pad = required_pad(feature_type, n_fft)
        # the window's span: the longest FFT of a frame, 2 * required_pad
        self._win_len = block_window_len(self.block_frames, self.halo, 2 * self._pad,
                                         hop_length)
        # the device mirror: buckets of _dev_B samples, _dev_R samples long
        self._dev_B = max(2048, self.block_frames * hop_length // 4)
        self._dev_R = self._win_len + 4 * self._dev_B
        self.reset()

    def reset(self):
        """Clear stream state for a new stream."""
        self._reinit: dict[int, list[int]] = {}  # frame -> slots to re-init
        self._pending: list[np.ndarray] = []
        self._pending_len = 0
        self._buf: np.ndarray | None = None  # (rows, n) from padded sample _pos
        self._pos = 0
        self._next_frame = 0
        self._tracker: tuple[torch.Tensor, torch.Tensor] | None = None
        self._samples_seen = 0
        self._flushed = False
        self._in_dtype: np.dtype | None = None
        self._dev: torch.Tensor | None = None  # (rows, R) mirror of _buf's head
        self._dev_alt: torch.Tensor | None = None  # the mirror's slide target
        self._dev_len = 0                   # mirrored prefix length of _buf

    # -- feature geometry ---------------------------------------------------

    @property
    def latency_frames(self) -> int:
        """Feature frames of lookahead before a frame's features can be emitted
        (the sub-frame STFT window tail excluded)."""
        return self.halo

    @property
    def in_dtype(self) -> np.dtype:
        """The stream's sample dtype (int16 PCM or float32), float32 until the
        first ingest fixes it."""
        return self._in_dtype if self._in_dtype is not None else np.dtype(np.float32)

    def total_frames(self, n_samples: int) -> int:
        """Offline (center=True) frame count of an n_samples stream."""
        return 1 + n_samples // self.hop

    # -- dynamic slot attachment (stream_pool.py) ------------------------------

    def write_slot_seed(self, slot: int, first_samples: np.ndarray,
                        boundary_frame: int) -> None:
        """Lay down a joining stream's start prefix (`halo` frames of pre-stream
        zeros, then the reflect pad) into one slot's rows of the shared buffer, so
        that from `boundary_frame` on the slot's padded timeline is a solo
        stream's. The slot's sample 0 must be the pool's sample boundary_frame *
        hop; `first_samples` are the stream's first required_pad + 1 samples (the
        reflect source). The device mirror is rewound past the touched region."""
        C = self.n_channels
        first = np.asarray(first_samples)
        if first.dtype != self.in_dtype:
            raise ValueError(f"seed dtype {first.dtype} != stream dtype {self.in_dtype}")
        if first.shape[0] != C or first.shape[1] < self._pad + 1:
            raise ValueError(f"need ({C}, >={self._pad + 1}) seed samples, got {first.shape}")
        refl = first[:, 1:self._pad + 1][:, ::-1]
        i0 = (boundary_frame - self.halo) * self.hop - self._pos
        i1 = boundary_frame * self.hop - self._pos
        if self._buf is None or i0 < 0 or i1 + self._pad > self._buf.shape[1]:
            raise RuntimeError(f"slot seed region [{i0}, {i1 + self._pad}) not resident "
                               "(attach must happen exactly at the ingest boundary)")
        rows = slice(slot * C, (slot + 1) * C)
        self._buf[rows, i0:i1] = 0
        self._buf[rows, i1:i1 + self._pad] = refl
        if self._dev is not None and self._dev_len > i0:
            self._dev_len = max(0, i0) // self._dev_B * self._dev_B

    def schedule_tracker_reinit(self, slot: int, frame: int) -> None:
        """Start `slot`'s noise tracker afresh at the block starting at feature
        frame `frame`, from that block's window: the init a solo stream computes
        from its first window. Nothing to do for a type without a tracker."""
        if self._tracking:
            self._reinit.setdefault(frame, []).append(slot)

    def _take_reinit(self) -> list[int] | None:
        """The slots whose tracker starts at the current block, if any."""
        return self._reinit.pop(self._next_frame, None)

    # -- device-resident ingestion -------------------------------------------

    def _dev_sync(self, upto: int) -> None:
        """Mirror _buf[:, :upto] on the device (invariant: _dev[:, :_dev_len] ==
        _buf[:, :_dev_len]). Bucket-granular; a trailing partial bucket is written
        only when a window needs it. On a card each bucket goes through a pinned
        host buffer and an asynchronous copy (the caching host allocator holds the
        buffer until its copy is done)."""
        dtype = torch.int16 if self.in_dtype == np.int16 else torch.float32
        if self._dev is None:
            shape = (self._buf.shape[0], self._dev_R)
            self._dev = torch.zeros(shape, dtype=dtype, device=self.device)
            self._dev_alt = torch.zeros(shape, dtype=dtype, device=self.device)
        B = self._dev_B
        upto = min(upto, self._dev_R - B)
        pinned = self.device.type == "cuda"
        while self._dev_len < upto:
            n = min(B, self._buf.shape[1] - self._dev_len)
            stage = torch.empty((self._buf.shape[0], n), dtype=dtype, pin_memory=pinned)
            stage.numpy()[:] = self._buf[:, self._dev_len:self._dev_len + n]
            self._dev[:, self._dev_len:self._dev_len + n].copy_(stage, non_blocking=pinned)
            self._dev_len += n

    def _window_start(self) -> int | None:
        """The next block's window start in the host buffer, or None until the
        buffer holds the whole window."""
        rel = (self._next_frame - self.halo) * self.hop - self._pos
        if self._buf is None or rel + self._win_len > self._buf.shape[1]:
            return None
        return rel

    def _next_input(self):
        """The next complete block's inputs (window, a view of the device mirror;
        tracker state; re-init slots), or None. The caller runs the block and must
        then call `_commit(state_out)` to advance the stream."""
        if (rel := self._window_start()) is None:
            return None
        self._dev_sync(rel + self._win_len)
        window = self._dev[:, rel:rel + self._win_len].reshape(self.n_streams, self.n_channels,
                                                               self._win_len)
        return window, self._tracker, self._take_reinit()

    # -- internals ----------------------------------------------------------

    def _seed_buffer(self) -> bool:
        """Once required_pad + 1 samples have arrived, lay down the stream-start
        prefix: `halo` frames of pre-stream zeros, the reflect pad, then the audio;
        from then on a buffer index maps linearly to padded samples."""
        if self._pending_len < self._pad + 1:
            return False
        audio = np.concatenate(self._pending, axis=-1)
        self._pending = []
        self._pending_len = 0
        refl = audio[:, 1:self._pad + 1][:, ::-1]
        zeros = np.zeros((audio.shape[0], self.halo * self.hop), audio.dtype)
        self._buf = np.concatenate([zeros, refl, audio], axis=-1)
        self._pos = -self.halo * self.hop
        return True

    def _commit(self, state_out) -> None:
        """Advance past the block whose inputs `_next_input` returned, keeping the
        tracker state it left and dropping dead samples."""
        self._tracker = state_out
        self._next_frame += self.block_frames
        keep_from = (self._next_frame - self.halo) * self.hop
        drop = keep_from - self._pos
        if drop > 0:
            self._buf = self._buf[:, drop:]
            self._pos = keep_from
            if self._dev is not None:
                # torch refuses a copy between overlapping views of one buffer:
                # slide into the second buffer and swap
                R = self._dev_R
                if drop < R:
                    self._dev_alt[:, :R - drop].copy_(self._dev[:, drop:])
                self._dev, self._dev_alt = self._dev_alt, self._dev
                self._dev_len = max(0, self._dev_len - drop)

    @torch.inference_mode()
    def _emit_ready(self) -> list[np.ndarray]:
        out = []
        while (inp := self._next_input()) is not None:
            feats, state = self._block_fn(*inp)
            self._commit(state)
            feats = feats.cpu().numpy()  # (N, C, L, F)
            out.append(feats[0] if self.n_streams == 1 else feats)
        return out

    # -- public API ----------------------------------------------------------

    def ingest(self, samples: np.ndarray) -> None:
        """Buffer samples without emitting. Shape (n_channels, n) for one stream,
        (n_streams, n_channels, n) for N synchronized streams. Samples are float
        (already normalized) or int16 PCM, decoded on the device; a stream keeps
        one dtype throughout."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        samples = np.asarray(samples)
        if samples.dtype != np.int16:
            samples = samples.astype(np.float32, copy=False)
        if self._in_dtype is None:
            self._in_dtype = samples.dtype
        elif samples.dtype != self._in_dtype:
            raise ValueError(f"stream dtype changed mid-stream: started {self._in_dtype}, "
                             f"got {samples.dtype}")
        if self.n_streams == 1:
            if samples.ndim != 2 or samples.shape[0] != self.n_channels:
                raise ValueError(f"expected ({self.n_channels}, n) samples, got "
                                 f"{samples.shape}")
        else:
            if samples.ndim != 3 or samples.shape[:2] != (self.n_streams, self.n_channels):
                raise ValueError(f"expected ({self.n_streams}, {self.n_channels}, n) "
                                 f"samples, got {samples.shape}")
            samples = samples.reshape(-1, samples.shape[-1])
        self._samples_seen += samples.shape[1]
        if self._buf is None:
            self._pending.append(samples)
            self._pending_len += samples.shape[1]
            self._seed_buffer()
        else:
            self._buf = np.concatenate([self._buf, samples], axis=-1)
        if self._buf is not None:
            n = self._buf.shape[1]
            self._dev_sync(n - n % self._dev_B)

    def push(self, samples: np.ndarray) -> list[np.ndarray]:
        """Feed samples; returns every feature block this push completed."""
        self.ingest(samples)
        return self._emit_ready()

    def _flush_pad(self) -> int:
        """End of stream: lay down the offline extractor's trailing reflect pad and
        zero filler so every remaining frame's block window is complete. Returns
        the number of true frames remaining (the last block's frames beyond them
        are filler)."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        self._flushed = True
        total = self.total_frames(self._samples_seen)
        if self._buf is None:
            if not self._pending:
                return 0
            # a stream shorter than the reflect pad: reflect what exists
            audio = np.concatenate(self._pending, axis=-1)
            self._pending = []
            w = min(self._pad, audio.shape[1] - 1)
            refl = audio[:, 1:w + 1][:, ::-1]
            zeros = np.zeros((audio.shape[0], self.halo * self.hop), audio.dtype)
            lead = np.zeros((audio.shape[0], self._pad - w), audio.dtype)
            self._buf = np.concatenate([zeros, lead, refl, audio], axis=-1)
            self._pos = -self.halo * self.hop
        remaining = total - self._next_frame
        if remaining <= 0:
            return 0
        tail = self._buf[:, -(self._pad + 1):-1][:, ::-1]
        L, h = self.block_frames, self.halo
        n_blocks = -(-remaining // L)
        last_start = (self._next_frame + (n_blocks - 1) * L - h) * self.hop
        need = last_start + self._win_len - self._pos
        filler_len = max(0, need - self._buf.shape[1] - tail.shape[1])
        filler = np.zeros((self._buf.shape[0], filler_len), self._buf.dtype)
        self._buf = np.concatenate([self._buf, tail, filler], axis=-1)
        return remaining

    def flush(self) -> np.ndarray:
        """End of stream: emit the remaining frames, (n_feat_ch, n_remaining, F),
        with a leading n_streams axis for N streams; possibly zero-length."""
        empty = np.zeros((0, 0, 0) if self.n_streams == 1 else (self.n_streams, 0, 0, 0),
                         np.float32)
        remaining = self._flush_pad()
        if remaining <= 0:
            return empty
        blocks = self._emit_ready()
        if not blocks:
            return empty
        return np.concatenate(blocks, axis=-2)[..., :remaining, :]


class StreamingSeldPipeline:
    """Online SELD predictions from a live sample feed.

    Each block is predicted from a fixed window [left_context | block |
    right_context] of feature frames, and only the block's label frames are
    emitted. The feature blocks the window spans stay on the device in a deque;
    frames outside the stream (or past a pool slot's stream, per-stream hi) are
    pad blocks holding the scaler mean in the spectral channels, which
    normalization maps to exactly 0. A dispatch extracts one block of every
    stream (for SALSA one K2 and one K1 launch; a block in which no stream is live
    is the pad block, with no dispatch) and, once a block's window is complete,
    assembles and normalizes it and runs the CRNN on the N streams as its batch;
    only the label-rate outputs come back to the host. flush() predicts the
    blocks still inside the lookahead with pad right context and trims the last
    block to the stream's true label frames.

    push() takes (C, n), or (N, C, n) for n_streams = N, and returns
    [(event_prob, doa_xyz)] per completed block (with a leading stream axis for
    N > 1). The model runs on the extractor's device.
    """

    dispatches = 0  # block dispatches of every pipeline (SALSA: one K2 and one K1 launch each)

    def __init__(self, extractor: StreamingExtractor, model: nn.Module,
                 state_dict: Mapping | None, scaler, interp_ratio: float, n_classes: int,
                 output_format: str = "reg_xyz", left_context: int = 128,
                 right_context: int | None = None):
        if output_format not in OUTPUT_FORMATS:
            raise ValueError(f"unknown output format '{output_format}'")
        if output_format == "tracks":
            raise ValueError("output format 'tracks' (EINV2's track stacks attend over a "
                             "whole clip) is not served by streaming; serve it whole-clip "
                             "through SeldInferencePipeline")
        self.extractor = extractor
        self.device = extractor.device
        self.model = load_weights(model, state_dict).to(self.device).eval()
        mean, std = scaler
        self._mean = torch.as_tensor(np.asarray(mean, np.float32), device=self.device)
        self._std = torch.as_tensor(np.asarray(std, np.float32), device=self.device)
        self.interp_ratio = float(interp_ratio)
        self.n_classes = n_classes
        self.output_format = output_format
        ds = model.time_downsample_ratio
        self.ds = ds
        L = extractor.block_frames
        right_context = left_context if right_context is None else right_context
        for name, v in (("block_frames", L), ("left_context", left_context),
                        ("right_context", right_context)):
            if v % ds != 0:
                raise ValueError(f"{name}={v} must be a multiple of the encoder's time "
                                 f"downsample ratio {ds}")
        self.left, self.right = left_context, right_context
        self._W = left_context + L + right_context
        self._label_per_block = int(round(L / ds * self.interp_ratio))
        # block k's window [kL - left, kL + L + right) spans blocks [k - lb, k + d
        # - 1] at a fixed offset in the concatenated deque
        self._d = -(-(L + self.right) // L)   # lookahead blocks, its own included
        self._lb = -(-self.left // L)         # history blocks
        self._nb = self._d + self._lb
        self._off = self._lb * L - self.left
        N = extractor.n_streams
        self.n_streams = N
        pad = torch.zeros((N, extractor.n_feat_channels, L, extractor.n_features),
                          device=self.device)
        pad[:, :self._mean.shape[0]] = self._mean  # normalizes to exactly 0
        self._pad_block = pad
        self.reset(reset_extractor=False)

    def reset(self, reset_extractor: bool = True):
        """Clear stream state for a new stream."""
        if reset_extractor:
            self.extractor.reset()
        self._blocks = [self._pad_block] * (self._nb - 1)
        self._m = 0       # feature blocks extracted
        self._next_k = 0  # next prediction block to emit

    @property
    def latency_frames(self) -> int:
        """Feature frames from a frame's arrival to its prediction, worst case: a
        block, the right context and the feature lookahead."""
        return self.extractor.block_frames + self.right + self.extractor.latency_frames

    @property
    def label_frames_per_block(self) -> int:
        return self._label_per_block

    @torch.inference_mode()
    def _run_step(self, window, state, reinit, hi: np.ndarray):
        """One block: frames [0, hi[s]) of stream s are live. A block with a live
        frame is a dispatch: every stream's block extracted from its window (one
        K2 and one K1 launch) and the frames past each stream's hi replaced by the
        pad block; a block with none is the pad block, extracted from nothing, and
        the tracker state passes through. The block deque rotates; once the window
        of block _next_k is complete, it is predicted, the N streams as the model's
        batch. Returns (the prediction as host arrays, or None, and the tracker
        state the block left)."""
        L = self.extractor.block_frames
        hi = np.asarray(hi)
        if not hi.any():
            feats, state_out = self._pad_block, state
        else:
            feats, state_out = self.extractor._block_fn(window, state, reinit)
            StreamingSeldPipeline.dispatches += 1
            if (hi < L).any():
                live = np.arange(L) < hi[:, None]
                keep = torch.from_numpy(live).to(self.device)[:, None, :, None]
                feats = torch.where(keep, feats, self._pad_block)
        prev = self._blocks
        self._blocks = prev[1:] + [feats]
        self._m += 1
        if self._m - self._d < self._next_k:  # no block's window is complete yet
            return None, state_out
        stacked = torch.cat(prev + [feats], dim=2)
        out = self.model(normalize(stacked[:, :, self._off:self._off + self._W], self._mean,
                                   self._std))
        e0, en = self.left // self.ds, L // self.ds
        event_prob, doa = heads(out["event_frame_logit"][:, e0:e0 + en],
                                out["doa_frame_output"][:, e0:e0 + en], self.interp_ratio,
                                self.n_classes, self.output_format)
        packed = torch.cat([event_prob, doa], dim=-1).cpu().numpy()  # (N, T, 4n)
        if self.n_streams == 1:
            packed = packed[0]
        self._next_k += 1
        return (packed[..., :self.n_classes], packed[..., self.n_classes:]), state_out

    def push(self, samples: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
        """Feed samples and get [(event_prob, doa_xyz)] label-rate arrays of
        label_frames_per_block frames for each block completed."""
        ext = self.extractor
        results = []
        # ingest at most a block at a time, running the blocks it completes, so
        # the mirror's bounded length is never outrun even by a whole-clip push
        step = ext.block_frames * ext.hop
        samples = np.asarray(samples)
        for j in range(0, samples.shape[-1], step):
            ext.ingest(samples[..., j:j + step])
            while (inp := ext._next_input()) is not None:
                res, state_out = self._run_step(*inp, np.full(self.n_streams, ext.block_frames))
                ext._commit(state_out)
                if res is not None:
                    results.append(res)
        return results

    def flush(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """End of stream: extract the tail frames (the last block's filler masked
        to the pad value) and predict every remaining block with pad right
        context; the last block is trimmed to the stream's true label frames."""
        ext = self.extractor
        L = ext.block_frames
        remaining = ext._flush_pad()
        total = self._m * L + remaining
        results = []
        while (inp := ext._next_input()) is not None:
            valid = min(L, max(0, total - self._m * L))
            res, state_out = self._run_step(*inp, np.full(self.n_streams, valid))
            ext._commit(state_out)
            if res is not None:
                results.append(res)
        # the blocks still inside the lookahead are pad blocks
        n_total_blocks = -(-total // L)
        while self._next_k < n_total_blocks:
            res, _ = self._run_step(None, None, None, np.zeros(self.n_streams, np.int64))
            if res is not None:
                results.append(res)
        if results and total % L:
            b0 = (n_total_blocks - 1) * L
            n_valid = int(round(np.floor((total - b0) / self.ds) * self.interp_ratio))
            ev, doa = results[-1]
            results[-1] = (ev[..., :n_valid, :], doa[..., :n_valid, :])
        return results
