"""Spectral feature primitives (counterpart of `salsa_tpu.features.specs`):
log-(mel|linear) spectrograms, FOA intensity vectors and GCC-PHAT.

Spectra are re/im float32 planes (..., C, T, bins), channels third from last, as
`dsp.stft.stft_planes` returns them; features are (..., C', T, F).

  * log projected spec: |X|^2 projected by a filterbank matrix, then
    power_to_db(ref=1, amin=1e-10, top_db=None).
  * FOA intensity vector: Re(conj(W) X_m) for the stored channel order (W, Y, Z,
    X), L2-normalised across its 3 components in each bin, then projected.
  * GCC-PHAT: a double-length FFT, the optional 4 kHz cosine notch (mel variant),
    the phase transform of each pair's cross spectrum and its inverse DFT at the
    n_out lags around zero, as two matmuls (`dsp.stft.irfft_selected`).
"""
from __future__ import annotations

import numpy as np
import torch

from salsa_tpu_torch.dsp.stft import irfft_selected, power_to_db, stft_planes

Planes = tuple[torch.Tensor, torch.Tensor]


def big_fft_len(n_fft: int) -> int:
    """GCC's FFT length: the power of two that holds the full cross-correlation,
    2 ** ceil(log2(2 n_fft - 1))."""
    return int(2 ** np.ceil(np.log2(2 * n_fft - 1)))


def multichannel_spectra(waves: torch.Tensor, n_fft: int, hop_length: int,
                         win_length: int | None = None) -> Planes:
    """(..., n_ch, n_samples) -> STFT re/im planes (..., n_ch, n_frames, n_bins)."""
    return stft_planes(waves, n_fft=n_fft, hop_length=hop_length, win_length=win_length)


def log_projected_spec(re: torch.Tensor, im: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """|X|^2 @ proj.T -> dB. proj: (F, bins). Returns (..., C, T, F)."""
    return power_to_db((re * re + im * im) @ proj.T)


def foa_intensity_vectors(re: torch.Tensor, im: torch.Tensor, proj: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """FOA active intensity vector from (..., 4, T, bins) planes in the stored order
    (W, Y, Z, X): Re(conj(X[0]) X[1:4]) normalised per bin, then projected.
    Returns (..., 3, T, F) in the order IV_Y, IV_Z, IV_X."""
    iv = re[..., 0:1, :, :] * re[..., 1:4, :, :] + im[..., 0:1, :, :] * im[..., 1:4, :, :]
    norm = torch.sqrt(torch.sum(iv * iv, dim=-3, keepdim=True)) + eps
    return (iv / norm) @ proj.T


def gcc_phat_lowpass_filter(fs: int, big_n_fft: int) -> np.ndarray:
    """Cosine roll-off around 4 kHz of the mel GCC variant, (big_n_fft//2 + 1,).
    The gain returns to 1 above the transition band, as the reference's does."""
    n_bins = big_n_fft // 2 + 1
    filt = np.ones(n_bins, dtype=np.float32)
    k_cutoff = int(4000 / fs * big_n_fft)
    k_buffer = int(400 / fs * big_n_fft)
    ramp = np.cos(np.arange(2 * k_buffer) * (np.pi / 2) / (2 * k_buffer - 1))
    lo = k_cutoff - k_buffer
    hi = min(k_cutoff + k_buffer, n_bins)
    filt[lo:hi] = ramp[: hi - lo]
    return filt


def gcc_lags(big_n_fft: int, n_out: int) -> tuple:
    """The center-cropped lags [-n_out/2, n_out/2) as irfft output indices."""
    return tuple(range(big_n_fft - n_out // 2, big_n_fft)) + tuple(range(n_out // 2))


def gcc_phat_from_spectra(re: torch.Tensor, im: torch.Tensor, big_n_fft: int, n_out: int,
                          freq_filter: np.ndarray | None = None) -> torch.Tensor:
    """GCC-PHAT of every channel pair from big_n_fft-point spectra (..., C, T, bins).

    Pairs in the reference's loop order (n, m > n): (0,1), (0,2), (0,3), (1,2),
    (1,3), (2,3), each R = P[m] conj(P[n]). A cell whose |R| (torch.hypot, exact
    to the last bit at any scale) is 0 takes the flat spectrum 1, as
    `where(|R| > 0, R / max(|R|, 1e-30), 1)` does. Returns (..., n_pairs, T, n_out).
    """
    if freq_filter is not None:
        filt = torch.from_numpy(np.asarray(freq_filter, np.float32)).to(re.device)
        re, im = re * filt, im * filt
    n_ch = re.shape[-3]
    sig = [m for n in range(n_ch) for m in range(n + 1, n_ch)]
    ref = [n for n in range(n_ch) for m in range(n + 1, n_ch)]
    rs, is_, rr, ir = re[..., sig, :, :], im[..., sig, :, :], re[..., ref, :, :], im[..., ref, :, :]
    r_re = rs * rr + is_ * ir
    r_im = is_ * rr - rs * ir
    mag = torch.hypot(r_re, r_im)
    nz = mag > 0
    den = torch.clamp(mag, min=1e-30)
    phase_re = torch.where(nz, r_re / den, torch.ones_like(r_re))
    phase_im = torch.where(nz, r_im / den, torch.zeros_like(r_im))
    return irfft_selected(phase_re, phase_im, big_n_fft, gcc_lags(big_n_fft, n_out))


def gcc_phat_all_pairs(waves: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                       n_out: int, freq_filter: np.ndarray | None = None) -> torch.Tensor:
    """GCC-PHAT of all channel pairs of (..., C, n_samples) waves, framed at the
    double length big_fft_len(n_fft): (..., C(C-1)/2, n_frames, n_out)."""
    big = big_fft_len(n_fft)
    re, im = stft_planes(waves, n_fft=big, hop_length=hop_length, win_length=win_length)
    return gcc_phat_from_spectra(re, im, big, n_out, freq_filter)


def projected_features(re: torch.Tensor, im: torch.Tensor, proj: torch.Tensor,
                       with_iv: bool) -> torch.Tensor:
    """melspec / melspeciv / linspeciv from n_fft spectra: the log projected spec,
    and with_iv the FOA intensity vectors after it."""
    spec = log_projected_spec(re, im, proj)
    if not with_iv:
        return spec
    return torch.cat([spec, foa_intensity_vectors(re, im, proj)], dim=-3)


def gcc_features(spec: Planes, big: Planes, proj: torch.Tensor, n_out: int,
                 freq_filter: np.ndarray | None) -> torch.Tensor:
    """linspecgcc / melspecgcc: the log projected spec of the n_fft spectra `spec`,
    then GCC-PHAT of the big_n_fft spectra `big` (the same frames)."""
    big_n_fft = 2 * (big[0].shape[-1] - 1)
    return torch.cat([log_projected_spec(*spec, proj),
                      gcc_phat_from_spectra(*big, big_n_fft, n_out, freq_filter)], dim=-3)
