"""Per-chunk SALSA extraction for raw-waveform training (counterpart of the SALSA
part of `salsa_tpu.features.chunked`).

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

Streaming serving (`salsa_tpu_torch.streaming`) uses the block form,
`make_salsa_block_fn`: a contiguous (N, C, win_len) sample window per stream whose
frames need no wrap (the modulus is the window's own frame count), the tracker
state carried in and out, one DFT matmul, one K2 launch and one K1 launch a block.

Only `salsa` is ported; the other fused feature types of `salsa_tpu` raise
NotImplementedError (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from salsa_tpu_torch.dsp.stft import _windowed_dft_matrices, power_to_db
from salsa_tpu_torch.features.salsa import (
    SalsaParams,
    _compression_matrix,
    eig_features_from_planes,
    noise_floor_mask,
)

FUSED_FEATURE_TYPES = ("salsa", "salsa_lite", "salsa_ipd", "melspec",
                       "melspeciv", "linspeciv", "linspecgcc", "melspecgcc")


def pad_waveform(wave: np.ndarray, n_fft: int, pad: int | None = None) -> np.ndarray:
    """librosa-style center padding (reflect n_fft//2 per side, or `pad`), so that
    frame t is padded[t*hop : t*hop + n_fft]."""
    pad = n_fft // 2 if pad is None else pad
    return np.pad(wave, ((0, 0), (pad, pad)), mode="reflect")


def required_pad(n_fft: int) -> int:
    """Center pad the resident waveform must carry for SALSA: n_fft // 2 (the GCC
    feature types' wider pad comes with their extractors, ROADMAP queue 1, item 7)."""
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
                  win_length: int, wav_scale: float = 1.0):
    """STFT of chunk frames f0 .. f0 + chunk_len - 1 and n_ctx context frames a side.

    waves: (n_clips, C, S) center-padded resident waveforms (float32, or int16
    dequantized by wav_scale); clips, f0, n_full: (B,) int64 tensors on its device
    (clip index, chunk start frame, untrimmed frame count, the wrap modulus).
    Returns (re_main, im_main) (B, C, chunk_len, bins) and (re_pad, im_pad) (B, C,
    chunk_len + 2 n_ctx, bins), the latter with the wrap-corrected context frames.
    """
    main_sz = (chunk_len - 1) * hop + n_fft
    if waves.shape[-1] < main_sz:  # the zero tail every clip would have
        waves = F.pad(waves, (0, main_sz - waves.shape[-1]))
    main = _gather_samples(waves, clips, (f0 * hop)[:, None], main_sz)[:, :, 0]
    cos_mat, sin_mat = _windowed_dft_matrices(n_fft, win_length, waves.device)
    frames = (main.float() * wav_scale).unfold(-1, n_fft, hop)  # (B, C, L, n_fft)
    re, im = frames @ cos_mat, frames @ sin_mat
    if n_ctx == 0:
        return (re, im), (re, im)
    offs = torch.cat([torch.arange(-n_ctx, 0), chunk_len + torch.arange(n_ctx)]).to(f0.device)
    ctx_idx = torch.remainder(f0[:, None] + offs, n_full[:, None])  # wrap as the clip map
    ctx = _gather_samples(waves, clips, ctx_idx * hop, n_fft).float() * wav_scale
    re_c, im_c = ctx @ cos_mat, ctx @ sin_mat                    # (B, C, 2 n_ctx, bins)
    pad = lambda c, m: torch.cat([c[:, :, :n_ctx], m, c[:, :, n_ctx:]], dim=2)  # noqa: E731
    return (re, im), (pad(re_c, re), pad(im_c, im))


def _salsa_from_spectra(re, im, re_pad, im_pad, p: SalsaParams, n_frames: int, state0,
                        restart=None):
    """SALSA features of n_frames frames from their spectra (B, C, n_frames, bins)
    and the spectra with n_hopframes context frames a side (B, C, n_frames + 2h,
    bins): log-linear spectrogram, then K2 from `state0` (None: the clip-start
    state; `restart` (B,) bool: these clips start here) and K1. Returns (features
    (B, 7, n_frames, freq_dim), the tracker state after the last frame)."""
    h, n_band = p.n_hopframes, p.upper_bin - p.lower_bin
    W = _compression_matrix(p.n_fft, p.compress_high_freq, re.device)
    log_spec = power_to_db((re * re + im * im) @ W.T)        # (B, 4, L, F)
    xr = re_pad[..., p.lower_bin:p.upper_bin].transpose(-1, -2).contiguous()
    xi = im_pad[..., p.lower_bin:p.upper_bin].transpose(-1, -2).contiguous()
    mask, state = noise_floor_mask(xr[:, 0].contiguous(), xi[:, 0].contiguous(), n_hop=h,
                                   n_frames=n_frames, state0=state0, restart=restart)
    eig = eig_features_from_planes(xr, xi, mask, p).transpose(-1, -2)  # (B, 3, L, nb)
    return torch.cat([log_spec, F.pad(eig, (0, p.freq_dim - n_band))], dim=1), state


def make_salsa_chunk_fn(p: SalsaParams, chunk_len: int):
    """Chunk extractor for SALSA (FOA and MIC).

    Returns fn(waves, clips, f0, n_full, floor0, countdown0, wav_scale=1.0) ->
    (B, 7, chunk_len, freq_dim) float32 features, equal to extract_salsa(clip)[:,
    :, f0:f0 + chunk_len] for each chunk: waves (n_clips, 4, S) center-padded
    resident waveforms; clips, f0, n_full (B,) int64; floor0/countdown0 (B,
    bins_band) the tracker state entering frame f0 (`salsa_tracker_checkpoints`).
    One K2 launch resumed from that state and one K1 launch for the batch.
    """
    h = p.n_hopframes
    win_length = p.win_length or p.n_fft

    def fn(waves, clips, f0, n_full, floor0, countdown0, wav_scale: float = 1.0):
        (re, im), (re_pad, im_pad) = chunk_spectra(
            waves, clips, f0, n_full, chunk_len, h, p.n_fft, p.hop_length, win_length,
            wav_scale)
        return _salsa_from_spectra(re, im, re_pad, im_pad, p, chunk_len, (floor0, countdown0))[0]

    return fn


def block_window_len(block_len: int, n_hop: int, n_fft: int, hop: int) -> int:
    """Samples of a block's window: block_len frames and n_hop context frames a
    side, each n_fft long, hop apart."""
    return (block_len + 2 * n_hop - 1) * hop + n_fft


def block_spectra(window: torch.Tensor, p: SalsaParams):
    """STFT of every frame of block windows (N, C, win_len), float32 or int16 PCM
    (decoded on its device as x / 32768, exact): (re, im), each (N, C, n_frames,
    bins), frame j starting at sample j * hop."""
    if window.dtype == torch.int16:
        window = window.float() * (1.0 / 32768.0)
    cos_mat, sin_mat = _windowed_dft_matrices(p.n_fft, p.win_length or p.n_fft, window.device)
    frames = window.unfold(-1, p.n_fft, p.hop_length)          # (N, C, n_frames, n_fft)
    return frames @ cos_mat, frames @ sin_mat


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
    and one K1 launch.
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


def make_chunk_extractor(feature_type: str, audio_format: str, chunk_len: int,
                         fs: int, n_fft: int, hop_length: int,
                         win_length: int | None = None,
                         fmin_doa: float = 50.0, fmax_doa: float | None = None,
                         condition_number: float = 5.0, n_hopframes: int = 3,
                         is_tracking: bool = True, compress_high_freq: bool = True,
                         eig_method: str = "auto"):
    """Chunk extractor factory with `salsa_tpu`'s SALSA parameters and defaults.
    Returns (fn, params): see `make_salsa_chunk_fn`. The spatial stage is always
    K1, the arithmetic of `salsa_tpu`'s Pallas kernel: eig_method 'auto' and
    'pallas' are taken, salsa_tpu's XLA eigensolvers ('power', 'eigh') are not
    ported."""
    if feature_type not in FUSED_FEATURE_TYPES:
        raise ValueError(
            f"training.from_wav supports feature types {FUSED_FEATURE_TYPES}; "
            f"'{feature_type}' needs the offline extract CLI")
    if feature_type != "salsa":
        raise NotImplementedError(
            f"fused chunk extraction of '{feature_type}' is not ported yet: ROADMAP "
            "queue 1, item 7 (the other feature types)")
    if not is_tracking:
        raise NotImplementedError(
            "is_tracking=False (no coherence test) is not ported yet: ROADMAP queue 1, "
            "item 7")
    if eig_method not in ("auto", "pallas"):
        raise NotImplementedError(
            f"eig_method '{eig_method}': the port's spatial stage is K1, the Pallas "
            "kernel's arithmetic ('auto' or 'pallas'); salsa_tpu's XLA eigensolvers "
            "are not ported")
    if fmax_doa is None:
        fmax_doa = 9000.0 if audio_format == "foa" else 4000.0
    p = SalsaParams(
        fs=fs, n_fft=n_fft, hop_length=hop_length, win_length=win_length or n_fft,
        fmin_doa=fmin_doa, fmax_doa=fmax_doa, audio_format=audio_format,
        condition_number=condition_number, n_hopframes=n_hopframes,
        compress_high_freq=compress_high_freq)
    return make_salsa_chunk_fn(p, chunk_len), p


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
