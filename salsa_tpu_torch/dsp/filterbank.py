"""Frequency-axis projection matrices (counterpart of `salsa_tpu.dsp.filterbank`):
the Slaney mel filterbank (librosa-compatible) and the SALSA high-frequency
compression matrix.

Numpy copies rather than imports: importing `salsa_tpu.dsp` pulls in jax, which
the GPU host does not have.
"""
from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_mel = _MIN_LOG_MEL + np.log(np.maximum(f, 1e-12) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(f >= _MIN_LOG_HZ, log_mel, mel)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    hz = m * _F_SP
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), hz)


def mel_filterbank(fs: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, dtype=np.float32) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular mel filterbank, (n_mels, n_fft//2 + 1):
    librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax) with htk=False, norm='slaney'."""
    if fmax is None:
        fmax = fs / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, fs / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, n_bins), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]  # slaney norm
    return weights.astype(dtype)


def high_freq_compression_matrix(n_fft: int, compress: bool = True, dtype=np.float32) -> np.ndarray:
    """SALSA's frequency-compression projection, (n_out, n_fft//2 + 1).

    Keeps bins 1..k as-is (dropping the DC bin) and averages the bins above the 9 kHz
    cutoff in groups of 8 so the feature dim lands on 200 (n_fft=512) / 100 (n_fft=256),
    including the last row averaging only 7 bins while still dividing by 8.
    """
    n_bins = n_fft // 2 + 1
    if not compress:
        W = np.zeros((n_fft // 2, n_bins), dtype=dtype)
        W[np.arange(n_fft // 2), np.arange(1, n_fft // 2 + 1)] = 1.0
        return W
    if n_fft == 512:
        n_out, n_keep = 200, 192
    elif n_fft == 256:
        n_out, n_keep = 100, 96
    else:
        raise ValueError("high-freq compression defined for n_fft in (256, 512)")
    W = np.zeros((n_out, n_bins), dtype=dtype)
    W[np.arange(n_keep), np.arange(1, n_keep + 1)] = 1.0
    for row in range(n_keep, n_out):
        start = n_keep + 1 + (row - n_keep) * 8
        stop = min(start + 8, n_bins - 1)  # Nyquist bin excluded (last row sums 7 bins / 8)
        W[row, start:stop] = 1.0 / 8.0
    return W
