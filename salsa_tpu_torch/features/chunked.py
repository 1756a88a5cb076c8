"""Per-chunk feature extraction for raw-waveform training and its block form for
streaming (counterpart of `salsa_tpu.features.chunked`).

The train step extracts each 8 s chunk's features from the resident waveforms, and
they must equal the slice of the full-clip feature map. Two clip-global
dependencies make that non-trivial:

  1. the covariance context: each frame's spatial covariance spans +-n_hopframes
     neighbour frames, and the full-clip map wrap-pads the whole clip over frames,
     so a chunk at a clip edge borrows frames from the other end. The chunk's
     frames are framed contiguously and its 2 * n_hopframes context frames fetched
     one by one at offsets taken modulo the untrimmed STFT frame count.
  2. the noise-floor tracker, a recurrence from clip frame 0: K2 runs once per
     clip at setup with `collect_states` (`salsa_tracker_checkpoints`), and each
     step resumes it at the chunk's first frame from that checkpoint.

A batch of chunks is one STFT matmul, one K2 launch (resumed) and one K1 launch.
Start offsets that would read past the resident tensor are clamped into it, as
`lax.dynamic_slice` clamps them in `salsa_tpu`. A resident tensor shorter than
one chunk's window (every clip shorter than a chunk) is zero-padded to it first;
`salsa_tpu` raises there (ROADMAP queue 3).

Known bounded deviation (as in `salsa_tpu`): for clips SHORTER than the chunk
window, the last <= n_hopframes valid frames' covariance context can include
frames past the clip's final STFT frame; the full-clip map wraps those to the clip
start while a chunk reads the zero-padded tail. Clips at least a chunk long are
exact.

The other feature types are frame-local (`registry.FrameFeature`): a chunk is the
STFT of its own frames and nothing else, one matmul for each FFT length. The GCC
types frame a double-length FFT as well, so their resident waveforms carry
big_n_fft // 2 of center pad (`required_pad`) and the n_fft frames are read at a
pad offset. `make_frame_chunk_fn` is `salsa_tpu`'s make_salsa_lite_chunk_fn,
make_projected_chunk_fn and make_gcc_chunk_fn in one.

Streaming serving (`salsa_tpu_torch.streaming`) uses the block form,
`make_block_fn`: a contiguous (N, C, win_len) sample window per stream whose
frames need no wrap (the modulus is the window's own frame count). For SALSA the
tracker state is carried in and out, with one DFT matmul, one K2 launch and one
K1 launch a block; the frame-local types carry no state and launch neither.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from salsa_tpu_torch.dsp.stft import _windowed_dft_matrices, power_to_db
from salsa_tpu_torch.features.registry import FrameFeature, frame_feature, salsa_params
from salsa_tpu_torch.features.salsa import (
    SalsaParams,
    _compression_matrix,
    eig_features_from_planes,
    noise_floor_mask,
    tracker_mask,
)
from salsa_tpu_torch.features.specs import big_fft_len

FUSED_FEATURE_TYPES = ("salsa", "salsa_lite", "salsa_ipd", "melspec",
                       "melspeciv", "linspeciv", "linspecgcc", "melspecgcc")


def pad_waveform(wave: np.ndarray, n_fft: int, pad: int | None = None) -> np.ndarray:
    """librosa-style center padding (reflect n_fft//2 per side, or `pad`), so that
    frame t is padded[t*hop : t*hop + n_fft]."""
    pad = n_fft // 2 if pad is None else pad
    return np.pad(wave, ((0, 0), (pad, pad)), mode="reflect")


def required_pad(feature_type: str, n_fft: int) -> int:
    """Center pad the resident waveform must carry for this feature type: n_fft //
    2, or big_n_fft // 2 for the GCC types, which frame a double-length FFT."""
    if feature_type.endswith("gcc"):
        return big_fft_len(n_fft) // 2
    return n_fft // 2


def n_full_frames(n_samples: int, hop_length: int) -> int:
    """STFT frame count of the UNTRIMMED clip (center=True): 1 + n_samples//hop.
    The full-clip map wrap-pads at this length, not at the label-trimmed one."""
    return 1 + n_samples // hop_length


def _gather_samples(waves: torch.Tensor, clips: torch.Tensor, starts: torch.Tensor,
                    size: int) -> torch.Tensor:
    """waves (n_clips, C, S); clips (B,), starts (B, K) sample offsets -> (B, C, K,
    size) windows, each start clamped into [0, S - size]."""
    n_ch, total = waves.shape[1], waves.shape[2]
    starts = starts.clamp(0, total - size)
    idx = starts[:, None, :, None] + torch.arange(size, device=waves.device)
    ch = torch.arange(n_ch, device=waves.device)[None, :, None, None]
    return waves[clips[:, None, None, None], ch, idx]


def chunk_spectra(waves: torch.Tensor, clips: torch.Tensor, f0: torch.Tensor,
                  n_full: torch.Tensor, chunk_len: int, n_ctx: int, n_fft: int, hop: int,
                  win_length: int, wav_scale: float = 1.0, pad_off: int = 0):
    """STFT of chunk frames f0 .. f0 + chunk_len - 1 and n_ctx context frames a side.

    waves: (n_clips, C, S) center-padded resident waveforms (float32, or int16
    dequantized by wav_scale); clips, f0, n_full: (B,) int64 tensors on its device
    (clip index, chunk start frame, untrimmed frame count, the wrap modulus).
    pad_off: center pad the waves carry beyond this FFT's n_fft // 2 (frame t then
    starts at pad_off + t * hop).
    Returns (re_main, im_main) (B, C, chunk_len, bins) and (re_pad, im_pad) (B, C,
    chunk_len + 2 n_ctx, bins), the latter with the wrap-corrected context frames.
    """
    main_sz = (chunk_len - 1) * hop + n_fft
    if waves.shape[-1] < pad_off + main_sz:  # the zero tail every clip would have
        waves = F.pad(waves, (0, pad_off + main_sz - waves.shape[-1]))
    main = _gather_samples(waves, clips, (pad_off + f0 * hop)[:, None], main_sz)[:, :, 0]
    cos_mat, sin_mat = _windowed_dft_matrices(n_fft, win_length, waves.device)
    frames = (main.float() * wav_scale).unfold(-1, n_fft, hop)  # (B, C, L, n_fft)
    re, im = frames @ cos_mat, frames @ sin_mat
    if n_ctx == 0:
        return (re, im), (re, im)
    offs = torch.cat([torch.arange(-n_ctx, 0), chunk_len + torch.arange(n_ctx)]).to(f0.device)
    ctx_idx = torch.remainder(f0[:, None] + offs, n_full[:, None])  # wrap as the clip map
    ctx = _gather_samples(waves, clips, pad_off + ctx_idx * hop, n_fft).float() * wav_scale
    re_c, im_c = ctx @ cos_mat, ctx @ sin_mat                    # (B, C, 2 n_ctx, bins)
    pad = lambda c, m: torch.cat([c[:, :, :n_ctx], m, c[:, :, n_ctx:]], dim=2)  # noqa: E731
    return (re, im), (pad(re_c, re), pad(im_c, im))


def _salsa_from_spectra(re, im, re_pad, im_pad, p: SalsaParams, n_frames: int, state0,
                        restart=None):
    """SALSA features of n_frames frames from their spectra (B, C, n_frames, bins)
    and the spectra with n_hopframes context frames a side (B, C, n_frames + 2h,
    bins): log-linear spectrogram, then K2 from `state0` (None: the clip-start
    state; `restart` (B,) bool: these clips start here) and the spatial stage (K1,
    or `salsa_tpu`'s XLA branch). Without tracking K2 does not run and `state0`
    passes through. Returns (features (B, 2C - 1, n_frames, freq_dim), 7 channels
    at C = 4, the tracker state after the last frame)."""
    n_band = p.upper_bin - p.lower_bin
    W = _compression_matrix(p.n_fft, p.compress_high_freq, re.device)
    log_spec = power_to_db((re * re + im * im) @ W.T)        # (B, C, L, F)
    xr = re_pad[..., p.lower_bin:p.upper_bin].transpose(-1, -2).contiguous()
    xi = im_pad[..., p.lower_bin:p.upper_bin].transpose(-1, -2).contiguous()
    mask, state = tracker_mask(xr, xi, n_frames, p, state0, restart)
    eig = eig_features_from_planes(xr, xi, mask, p).transpose(-1, -2)  # (B, C - 1, L, nb)
    return torch.cat([log_spec, F.pad(eig, (0, p.freq_dim - n_band))], dim=1), state


def make_salsa_chunk_fn(p: SalsaParams, chunk_len: int):
    """Chunk extractor for SALSA (FOA and MIC, C channels: K1 at 4, the power
    iteration at the table's other counts).

    Returns fn(waves, clips, f0, n_full, floor0, countdown0, wav_scale=1.0) ->
    (B, 2C - 1, chunk_len, freq_dim) float32 features, equal to extract_salsa(clip)[:,
    :, f0:f0 + chunk_len] for each chunk: waves (n_clips, C, S) center-padded
    resident waveforms; clips, f0, n_full (B,) int64; floor0/countdown0 (B,
    bins_band) the tracker state entering frame f0 (`salsa_tracker_checkpoints`;
    None without tracking). One K2 launch resumed from that state and one K1 launch
    for the batch.
    """
    h = p.n_hopframes
    win_length = p.win_length or p.n_fft

    def fn(waves, clips, f0, n_full, floor0=None, countdown0=None, wav_scale: float = 1.0):
        (re, im), (re_pad, im_pad) = chunk_spectra(
            waves, clips, f0, n_full, chunk_len, h, p.n_fft, p.hop_length, win_length,
            wav_scale)
        state0 = (floor0, countdown0) if p.is_tracking else None
        return _salsa_from_spectra(re, im, re_pad, im_pad, p, chunk_len, state0)[0]

    return fn


def make_frame_chunk_fn(ff: FrameFeature, chunk_len: int):
    """Chunk extractor for a frame-local feature type.

    Returns fn(waves, clips, f0, n_full, floor0=None, countdown0=None,
    wav_scale=1.0) -> (B, C', chunk_len, F), equal to ff(clip)[:, :, f0:f0 +
    chunk_len] for each chunk: the arguments are `make_salsa_chunk_fn`'s, the
    tracker state is not read, and waves carry max(ff.n_ffts) // 2 of center pad.
    One DFT matmul for each FFT length and no kernel launch.
    """
    pad_total = max(ff.n_ffts) // 2

    def fn(waves, clips, f0, n_full, floor0=None, countdown0=None, wav_scale: float = 1.0):
        return ff.from_spectra(*(
            chunk_spectra(waves, clips, f0, n_full, chunk_len, 0, n, ff.hop_length,
                          ff.win_length, wav_scale, pad_total - n // 2)[0]
            for n in ff.n_ffts))

    return fn


def block_window_len(block_len: int, n_hop: int, n_fft: int, hop: int) -> int:
    """Samples of a block's window: block_len frames and n_hop context frames a
    side, each n_fft long (the longest FFT's), hop apart."""
    return (block_len + 2 * n_hop - 1) * hop + n_fft


def window_spectra(window: torch.Tensor, n_fft: int, hop: int, win_length: int,
                   offset: int = 0):
    """STFT of the frames of sample windows (N, C, win_len), float32 or int16 PCM
    (decoded on its device as x / 32768, exact): (re, im), each (N, C, n_frames,
    bins), frame j starting at sample offset + j * hop."""
    if window.dtype == torch.int16:
        window = window.float() * (1.0 / 32768.0)
    cos_mat, sin_mat = _windowed_dft_matrices(n_fft, win_length, window.device)
    frames = window[..., offset:].unfold(-1, n_fft, hop)     # (N, C, n_frames, n_fft)
    return frames @ cos_mat, frames @ sin_mat


def block_spectra(window: torch.Tensor, p: SalsaParams):
    """`window_spectra` of SALSA block windows, frame j at sample j * hop."""
    return window_spectra(window, p.n_fft, p.hop_length, p.win_length or p.n_fft)


def make_salsa_block_fn(p: SalsaParams, block_len: int):
    """Block extractor for streaming: the contiguous form of the chunk function.

    Returns fn(window, state0=None, reinit=None) -> (features (N, 7, block_len,
    freq_dim), (floor, countdown) (N, bins_band)). window: (N, 4, win_len) samples
    of N streams (`block_spectra`'s dtypes), win_len = block_window_len(...):
    frames -h .. block_len + h - 1 of the block, so the context frames are the
    window's own and the wrap modulus block_len + 2h is the identity. state0: the
    tracker state entering the block (None: every row starts its clip here, K2's
    own init); the state returned leaves its last frame. reinit: rows that start
    their clip at this block while the others carry their state; K2 gives them the
    clip-start state of this window in the same launch (its `restart` flags), the
    state it computes for a stream that starts here. One DFT matmul, one K2 launch
    and one K1 launch (without tracking no K2: the state passes through).
    """
    h = p.n_hopframes
    win_len = block_window_len(block_len, h, p.n_fft, p.hop_length)
    main = slice(h, h + block_len)

    def fn(window: torch.Tensor, state0=None, reinit=None):
        if window.dim() != 3 or window.shape[-1] != win_len:
            raise ValueError(f"block window must be (N, C, {win_len}), got {tuple(window.shape)}")
        re_pad, im_pad = block_spectra(window, p)
        restart = None
        if reinit and state0 is not None:
            flags = np.zeros(window.shape[0], bool)
            flags[list(reinit)] = True
            restart = torch.from_numpy(flags).to(window.device)
        return _salsa_from_spectra(re_pad[:, :, main], im_pad[:, :, main], re_pad, im_pad, p,
                                   block_len, state0, restart)

    return fn


def make_frame_block_fn(ff: FrameFeature, block_len: int):
    """Block extractor of a frame-local type for streaming: fn(window, state0=None,
    reinit=None) -> (features (N, C', block_len, F), state0). window: (N, C,
    win_len) samples, win_len = block_window_len(block_len, 0, max(ff.n_ffts),
    hop), frame j's longest FFT starting at sample j * hop; the shorter FFTs read
    at the pad offset. The state passes through and reinit is not read: nothing
    is carried from block to block."""
    span = max(ff.n_ffts)
    win_len = block_window_len(block_len, 0, span, ff.hop_length)

    def fn(window: torch.Tensor, state0=None, reinit=None):
        if window.dim() != 3 or window.shape[-1] != win_len:
            raise ValueError(f"block window must be (N, C, {win_len}), got {tuple(window.shape)}")
        return ff.from_spectra(*(
            window_spectra(window, n, ff.hop_length, ff.win_length, (span - n) // 2)
            for n in ff.n_ffts)), state0

    return fn


def make_block_fn(params: SalsaParams | FrameFeature, block_len: int):
    """The block extractor of `make_chunk_extractor`'s params: SALSA's or a
    frame-local type's."""
    if isinstance(params, SalsaParams):
        return make_salsa_block_fn(params, block_len)
    return make_frame_block_fn(params, block_len)


def make_chunk_extractor(feature_type: str, audio_format: str, chunk_len: int,
                         fs: int, n_fft: int, hop_length: int,
                         win_length: int | None = None,
                         fmin_doa: float = 50.0, fmax_doa: float | None = None,
                         n_mels: int = 128, fmin: float = 50.0, fmax: float | None = None,
                         condition_number: float = 5.0, n_hopframes: int = 3,
                         is_tracking: bool = True, compress_high_freq: bool = True,
                         eig_method: str = "auto"):
    """Chunk extractor factory with `salsa_tpu`'s parameters and defaults, for every
    type of FUSED_FEATURE_TYPES. Returns (fn, params): for salsa
    `make_salsa_chunk_fn` and its SalsaParams (eig_method 'auto' is K1, 'power' and
    'eigh' `salsa_tpu`'s XLA branch), for the others `make_frame_chunk_fn` and the
    type's FrameFeature."""
    if feature_type not in FUSED_FEATURE_TYPES:
        raise ValueError(
            f"training.from_wav supports feature types {FUSED_FEATURE_TYPES}; "
            f"'{feature_type}' needs the offline extract CLI")
    if feature_type == "salsa":
        p = salsa_params(audio_format, fs, n_fft, hop_length, win_length, fmin_doa, fmax_doa,
                         condition_number, n_hopframes, is_tracking, compress_high_freq,
                         eig_method)
        return make_salsa_chunk_fn(p, chunk_len), p
    ff = frame_feature(feature_type, audio_format, fs, n_fft, hop_length, win_length, n_mels,
                       fmin, fmax, fmin_doa, fmax_doa, compress_high_freq)
    return make_frame_chunk_fn(ff, chunk_len), ff


def tracker_states_all(waves_padded: torch.Tensor, p: SalsaParams):
    """The tracker state entering every frame of whole clips: waves_padded (B, C,
    S_pad) center-padded float32 (true length, no zero tail) -> (floor f32,
    countdown int32), each (B, n_frames, bins_band). One K2 launch with
    collect_states, from the clip-start state."""
    h, win_length = p.n_hopframes, p.win_length or p.n_fft
    n_full = 1 + (waves_padded.shape[-1] - p.n_fft) // p.hop_length
    # the tracker reads channel 0 only: frame and transform just that channel
    frames = waves_padded[:, 0].unfold(-1, p.n_fft, p.hop_length)  # (B, T, n_fft)
    cos_mat, sin_mat = _windowed_dft_matrices(p.n_fft, win_length, waves_padded.device)

    def band(x):
        x = x[..., p.lower_bin:p.upper_bin].transpose(-1, -2)
        return torch.cat([x[..., -h:], x, x[..., :h]], dim=-1).contiguous()

    xr0, xi0 = band(frames @ cos_mat), band(frames @ sin_mat)
    _, _, states = noise_floor_mask(xr0, xi0, n_hop=h, n_frames=n_full, collect_states=True)
    return states


def salsa_tracker_checkpoints_batch(
    waves_padded: torch.Tensor, starts_per_clip: list[np.ndarray], p: SalsaParams,
    batch_size: int = 8,
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Tracker checkpoints of equal-length clips: waves_padded (n, C, S_pad) float32
    on the device that runs K2; starts_per_clip[i] the chunk-start frames of clip
    i. Returns [(floor (k_i, bins), countdown (k_i, bins))] on that device, batch_size
    clips a launch."""
    out = []
    for b0 in range(0, len(starts_per_clip), batch_size):
        floors, countdowns = tracker_states_all(waves_padded[b0:b0 + batch_size], p)
        for j, starts in enumerate(starts_per_clip[b0:b0 + batch_size]):
            idx = torch.as_tensor(np.asarray(starts, np.int64), device=floors.device)
            out.append((floors[j, idx], countdowns[j, idx]))
    return out


def salsa_tracker_checkpoints(wave_padded: torch.Tensor, starts, p: SalsaParams):
    """Tracker state entering each chunk-start frame of one clip: wave_padded (4,
    S_pad) center-padded float32 (true length); starts (n_chunks,) clip-local
    start frames. Returns (floor, countdown) of shape (n_chunks, bins_band)."""
    return salsa_tracker_checkpoints_batch(wave_padded[None], [starts], p)[0]
