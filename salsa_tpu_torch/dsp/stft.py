"""Multichannel STFT and log-power utilities (counterpart of `salsa_tpu.dsp.stft`).

Same semantics as the JAX module: center=True with reflect padding, periodic Hann
window, and the STFT as a product of the framed signal with a windowed-DFT basis.
Layout: channels lead, time before frequency, (..., n_frames, n_bins).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, identical to scipy/librosa default."""
    n = win_length if periodic else win_length - 1
    k = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(dtype)


def n_stft_frames(n_samples: int, hop_length: int, n_fft: int, center: bool = True) -> int:
    """Number of STFT frames produced for a signal of given length."""
    if center:
        return 1 + n_samples // hop_length
    return 1 + (n_samples - n_fft) // hop_length


def frame_signal(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """(..., n_samples) -> overlapping frames (..., n_frames, frame_length), a view."""
    return x.unfold(-1, frame_length, hop_length)


@functools.lru_cache(maxsize=8)
def _windowed_dft_matrices(n_fft: int, win_length: int,
                           device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Real/imag DFT bases with the analysis window folded in: (n_fft, n_bins) each,
    float32 on `device`, made once per (n_fft, win_length, device).
    rfft(frame * window) == frame @ cos_mat  +  1j * (frame @ sin_mat)."""
    window = hann_window(win_length, dtype=np.float64)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.concatenate(
            [np.zeros(lpad), window, np.zeros(n_fft - win_length - lpad)]
        )
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = -2.0 * np.pi * t * k / n_fft
    cos_mat = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_mat = (np.sin(angle) * window[:, None]).astype(np.float32)
    return torch.from_numpy(cos_mat).to(device), torch.from_numpy(sin_mat).to(device)


def stft_planes(
    x: torch.Tensor,
    n_fft: int = 512,
    hop_length: int = 300,
    win_length: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT as separate real and imaginary float32 planes, (..., n_frames, n_fft//2+1)
    each, with center=True reflect padding. x: (..., n_samples) float32 signal."""
    if win_length is None:
        win_length = n_fft
    lead, n = x.shape[:-1], x.shape[-1]
    # F.pad's reflect mode takes (N, C, L) input
    x = F.pad(x.reshape(-1, 1, n), (n_fft // 2, n_fft // 2), mode="reflect")
    frames = frame_signal(x.reshape(*lead, x.shape[-1]), n_fft, hop_length)
    cos_mat, sin_mat = _windowed_dft_matrices(n_fft, win_length, x.device)
    return frames @ cos_mat, frames @ sin_mat


def stft(
    x: torch.Tensor,
    n_fft: int = 512,
    hop_length: int = 300,
    win_length: int | None = None,
) -> torch.Tensor:
    """Multichannel STFT: (..., n_samples) -> complex64 (..., n_frames, n_fft//2+1)."""
    return torch.complex(*stft_planes(x, n_fft, hop_length, win_length))


@functools.lru_cache(maxsize=8)
def _irfft_selected_bases(n_fft: int, out_idx: tuple,
                          device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Real/imag inverse-DFT bases evaluating irfft only at the `out_idx` samples,
    (n_fft//2 + 1, len(out_idx)) float32 on `device`:
    irfft(X, n)[t] = X_re @ C[:, t] + X_im @ S[:, t]."""
    n_bins = n_fft // 2 + 1
    t = np.asarray(out_idx, dtype=np.float64)[None, :]
    k = np.arange(n_bins, dtype=np.float64)[:, None]
    angle = 2.0 * np.pi * k * t / n_fft
    w = np.full((n_bins, 1), 2.0 / n_fft)
    w[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        w[-1] = 1.0 / n_fft
    C = (np.cos(angle) * w).astype(np.float32)
    S = (-np.sin(angle) * w).astype(np.float32)
    return torch.from_numpy(C).to(device), torch.from_numpy(S).to(device)


def irfft_selected(re: torch.Tensor, im: torch.Tensor, n_fft: int,
                   out_idx: tuple) -> torch.Tensor:
    """Inverse rFFT of the spectrum re + i im, (..., n_fft//2 + 1), evaluated only at
    the output samples `out_idx`: two matmuls, (..., len(out_idx))."""
    C, S = _irfft_selected_bases(n_fft, tuple(int(i) for i in out_idx), re.device)
    return re @ C + im @ S


def cabs2(z: torch.Tensor) -> torch.Tensor:
    """|z|^2 as re^2 + im^2."""
    return torch.square(z.real) + torch.square(z.imag)


def power_to_db(
    power: torch.Tensor,
    ref: float = 1.0,
    amin: float = 1e-10,
    top_db: float | None = None,
) -> torch.Tensor:
    """10*log10 with clamping, matching librosa.power_to_db semantics."""
    log_spec = 10.0 * torch.log10(torch.clamp(power, min=amin))
    log_spec = log_spec - 10.0 * np.log10(max(amin, ref))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec
