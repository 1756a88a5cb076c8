"""SALSA high-frequency compression matrix (counterpart of
`salsa_tpu.dsp.filterbank.high_freq_compression_matrix`).

A numpy copy rather than an import: importing `salsa_tpu.dsp` pulls in jax, which
the GPU host does not have.
"""
from __future__ import annotations

import numpy as np


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
